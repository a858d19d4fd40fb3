"""The port's input and tooling modules against the JAX package on the
CPU: a directory of the reference's per-track .h5 files (`data.h5io` and
`-d <dir>` on the CLI), stage timing and the `torch.profiler` trace
(`utils.profiling`, `--stage-times`, `--profile`), the logger and
`ErrorFile` (`utils.logging`), and the configuration tree."""

import dataclasses
import json
import logging as _logging
import os

import numpy as np
import pytest
import torch

from acoss_tpu import config as jax_config
from acoss_tpu.data.h5io import feature_set_from_h5_dir as jax_from_h5
from acoss_tpu_torch import cli, config
from acoss_tpu_torch.data import make_synthetic_dataset
from acoss_tpu_torch.data.h5io import feature_set_from_h5_dir
from acoss_tpu_torch.utils import ErrorFile, get_logger, profiling, timeit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small CPU tensors: in a
    loaded parallel test run more threads only spin (a sweep here took 3 s
    on its own and 400 s beside five busy workers at the default count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def h5_dir(tmp_path):
    """Three reference-format track files: frames-last MFCCs, madmom
    features in a group, label and track id as string datasets."""
    import h5py

    rng = np.random.default_rng(0)
    d = tmp_path / "h5"
    d.mkdir()
    for i in range(3):
        n = 1600 + 40 * i
        with h5py.File(d / f"t{i}.h5", "w") as f:
            f["hpcp"] = rng.random((n, 12)).astype(np.float32)
            f["crema"] = rng.random((n, 12)).astype(np.float32)
            f["mfcc_htk"] = rng.random((13, n)).astype(np.float32)
            g = f.create_group("madmom_features")
            g["onsets"] = np.arange(0, n, 20)
            g["novfn"] = rng.random(n).astype(np.float32)
            g["snovfn"] = rng.random(n).astype(np.float32)
            f["label"] = f"W_{i // 2}"
            f["track_id"] = f"P_{i}"
    return d


def test_h5_dir_matches_jax(h5_dir):
    got, want = feature_set_from_h5_dir(str(h5_dir)), jax_from_h5(str(h5_dir))
    assert got.n_songs == want.n_songs == 3
    assert list(got.labels) == list(want.labels) == ["W_0", "W_0", "W_1"]
    assert list(got.track_ids) == list(want.track_ids)
    assert sorted(got.features) == sorted(want.features)
    for k in want.features:
        np.testing.assert_array_equal(got.features[k], want.features[k])
        np.testing.assert_array_equal(got.lengths[k], want.lengths[k])
    assert got.feature("mfcc_htk").shape[2] == 13   # transposed
    with pytest.raises(FileNotFoundError):
        feature_set_from_h5_dir(str(h5_dir / "none"))


def test_cli_reads_h5_dir(h5_dir, tmp_path, monkeypatch, capsys):
    """-d takes a directory of .h5 files for every command."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["benchmark", "-a", "Serra09", "-d", str(h5_dir),
                     "-s", "h5", "--device", "cpu", "--no-checkpoint"]) == 0
    assert "results appended to results_h5.csv" in capsys.readouterr().out
    assert cli.main(["coverstats", "-d", str(h5_dir), "-o", "cs",
                     "--studies", "stdev", "--no-figures",
                     "--device", "cpu"]) == 0
    assert cli.main(["query", "-a", "Serra09", "-d", str(h5_dir),
                     "-q", str(h5_dir), "--top", "1", "--device",
                     "cpu"]) == 0
    hits = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"query"')]
    # each song retrieves itself first
    assert [h["top"][0]["index"] for h in hits] == [0, 1, 2]


def test_stage_times_on_and_off():
    st = profiling.StageTimes()
    with st.stage("x"):
        pass
    assert not st.total and not st.count
    t = torch.ones(3)
    assert st.block(t) is t
    st.enabled = True
    with st.stage("a"):
        st.block({"t": [t * 2, np.ones(2)]})
    with st.stage("a"):
        pass
    with st.stage("b"):
        pass
    assert st.count["a"] == 2 and st.count["b"] == 1
    rep = st.report()
    assert "a" in rep and "per_call_ms" in rep
    st.reset()
    assert not st.total


def test_device_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    profiling.stages.enabled = True
    try:
        with profiling.device_trace(logdir):
            with profiling.stages.stage("sweep:tile", ti=0, tj=1):
                torch.ones(8, 8) @ torch.ones(8, 8)
    finally:
        profiling.stages.enabled = False
        profiling.stages.reset()
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        trace = json.load(f)
    assert any(e.get("name") == "sweep:tile"
               and e["args"].get("span") == "ti=0 tj=1"
               for e in trace["traceEvents"])
    with profiling.device_trace(None):   # no-op path
        pass


def test_cli_profile_and_stage_times(tmp_path, monkeypatch, capsys):
    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=2,
                                base_duration=30.0)
    fs.save(str(tmp_path / "fs.npz"))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["benchmark", "-a", "Serra09", "-d", "fs.npz", "-s",
                     "p", "--device", "cpu", "--no-checkpoint",
                     "--stage-times", "--profile", "prof"]) == 0
    out = capsys.readouterr().out
    for stage in ("extract", "sweep", "sweep:tile", "sweep:flush", "eval",
                  "score:tile", "sweep:row", "store:upcast"):
        assert any(ln.split()[:1] == [stage] for ln in out.splitlines()), \
            stage
    trace = tmp_path / "prof" / profiling.TRACE_FILE
    assert f"device trace written to {os.path.join('prof', 'trace.json')}" \
        in out
    with open(trace) as f:
        tiles = {e["args"].get("span") for e in json.load(f)["traceEvents"]
                 if e.get("name") == "sweep:tile"}
    assert "ti=0 tj=0" in tiles
    # the flags leave the process-global collector off
    assert not profiling.stages.enabled


def test_utils(tmp_path):
    log = get_logger("t_torch", str(tmp_path / "log.txt"))
    log.info("hello")
    ef = ErrorFile(str(tmp_path / "errors.txt"))
    ef.add("song1.mp3", "boom")
    ef.add("song2.mp3")
    assert ef.tracks() == ["song1.mp3", "song2.mp3"]

    @timeit
    def f(x):
        return x + 1
    assert f(1) == 2
    assert ErrorFile(str(tmp_path / "none.txt")).tracks() == []


def test_errorfile_multiline_errors(tmp_path):
    """A traceback payload stays ONE ledger row; tracks() never returns
    traceback fragments as track names."""
    ef = ErrorFile(str(tmp_path / "err.txt"))
    ef.add("song_a.mp3", "Traceback (most recent call last):\n"
           "  File \"x.py\", line 1\nValueError: boom")
    ef.add("song\tb.mp3", "short\twith tab")
    assert ef.tracks() == ["song_a.mp3", "song b.mp3"]
    assert len(open(tmp_path / "err.txt").read().splitlines()) == 2


def test_get_logger_late_logfile(tmp_path):
    """A logfile request after the logger already exists (console-only)
    still attaches the file handler -- once."""
    name = "acoss_tpu_torch_test_late"
    get_logger(name)
    lf = str(tmp_path / "run.log")
    lg = get_logger(name, logfile=lf)
    lg.info("hello")
    get_logger(name, logfile=lf)
    assert sum(isinstance(h, _logging.FileHandler)
               for h in lg.handlers) == 1
    for h in lg.handlers:
        h.flush()
    assert "hello" in open(lf).read()


def test_config_matches_jax():
    assert dataclasses.asdict(config.BenchmarkConfig()) == \
        dataclasses.asdict(jax_config.BenchmarkConfig())
    for name in ("PathsConfig", "FeatureProfile", "AlgorithmConfig",
                 "MeshConfig", "BenchmarkConfig"):
        assert [f.name for f in dataclasses.fields(getattr(config, name))] \
            == [f.name for f in dataclasses.fields(getattr(jax_config,
                                                           name))]
