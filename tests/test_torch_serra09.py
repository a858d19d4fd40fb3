"""The port's Serra09 slice end to end against the JAX package on the CPU:
descriptor extraction, the tile sweep, the kernel path's composition (with
every kernel's plain version) and the retrieval metrics, on a planted-clique
corpus whose songs are long enough (30 s base duration) that the CRPs are
not vacuous."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import Serra09 as JaxSerra09
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.benchmarking.harness import run_pairwise as jax_run_pairwise
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import alignment as jax_alignment
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import Serra09
from acoss_tpu_torch.benchmarking.evaluation import eval_statistics
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet

SIM_TYPES = ("chroma_qmax", "chroma_dmax", "mfcc_qmax", "mfcc_dmax")


@pytest.fixture(scope="module")
def corpus():
    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=1,
                                base_duration=30.0)
    desc = JaxSerra09().extract_descriptors(fs)
    return fs, desc, jax_run_pairwise(JaxSerra09(), desc, fs.n_songs)


def _assert_same_scores(got, want):
    assert sorted(got) == sorted(want) == sorted(SIM_TYPES)
    for k in SIM_TYPES:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _stats(Ds, labels):
    return {k: dataclasses.asdict(eval_statistics(D, labels))
            for k, D in Ds.items()}


def test_descriptors_match_jax(corpus):
    fs, desc, _ = corpus
    got = Serra09().extract_descriptors(
        FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids),
        device="cpu")
    assert sorted(got) == sorted(desc)
    for k in desc:
        assert got[k].dtype == desc[k].dtype, k
    for k in ("chroma", "gchroma", "length"):
        np.testing.assert_array_equal(got[k], desc[k])
    # mfcc means: float32 sums in another order than XLA's
    np.testing.assert_allclose(got["mfcc"], desc["mfcc"], rtol=1e-6,
                               atol=1e-6)
    assert int(desc["length"].min()) > 20     # not the vacuous regime


@pytest.mark.parametrize("source", ["own_extraction", "jax_descriptors"])
def test_run_pairwise_matches_jax(corpus, source):
    fs, desc, want = corpus
    algo = Serra09()
    if source == "own_extraction":
        d = algo.extract_descriptors(fs, device="cpu")
    else:
        d = descriptors_from_numpy(desc, "cpu")
        assert {k: v.dtype for k, v in d.items()} == {
            "chroma": torch.float32, "mfcc": torch.float32,
            "gchroma": torch.float32, "length": torch.int32}
    got = run_pairwise(algo, d, fs.n_songs, device="cpu")
    _assert_same_scores(got, want)
    assert _stats(got, fs.labels) == _stats(want, fs.labels)
    assert all(s["map"] > 0.9 for s in _stats(got, fs.labels).values())


def test_kernel_path_composition_matches_jax_pallas_interpret(corpus):
    """tile_scores(plain=True) composes the CUDA path's CRPs (OTI per
    pair, centred MFCC, the fused CRP) and aligners with each kernel's
    plain version; the JAX package's Pallas path, interpreted, must give
    the same tile."""
    fs, desc, _ = corpus
    rows, cols = slice(0, 4), slice(6, 10)
    # a large leading MFCC term, like the energy coefficient of real HTK
    # MFCCs: without the per-pair centring the fp32 Gram trick loses the
    # distances and the CRPs change
    desc = dict(desc)
    valid = np.arange(desc["mfcc"].shape[1]) < desc["length"][:, None]
    desc["mfcc"] = desc["mfcc"].copy()
    desc["mfcc"][..., 0] += np.where(valid, 3000.0, 0.0).astype(np.float32)
    prev = jax_alignment.set_alignment_impl("pallas_interpret")
    try:
        want = JaxSerra09().tile_scores(
            jax.device_put({k: v[rows] for k, v in desc.items()}),
            jax.device_put({k: v[cols] for k, v in desc.items()}))
        want = {k: np.asarray(v) for k, v in want.items()}
    finally:
        jax_alignment.set_alignment_impl(prev)
    d = descriptors_from_numpy(desc, "cpu")
    got = Serra09().tile_scores({k: v[rows] for k, v in d.items()},
                                {k: v[cols] for k, v in d.items()},
                                plain=True)
    _assert_same_scores({k: v.numpy() for k, v in got.items()}, want)


def test_benchmark_matches_jax(corpus, tmp_path):
    fs, _, _ = corpus
    times = {}
    got = benchmark(Serra09(), fs, results_csv=str(tmp_path / "port.csv"),
                    device="cpu", times=times)
    want = jax_benchmark(JaxSerra09(), fs,
                         results_csv=str(tmp_path / "jax.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert sorted(times) == ["eval", "extract", "sweep"]


def test_checkpoint_ledger_resumes_across_packages(corpus, tmp_path):
    """A finished ledger written by the port resumes in the JAX package
    with nothing left to score, and a ledger written by the JAX package
    resumes in the port without calling tile_scores."""
    fs, desc, want = corpus
    ckpt = str(tmp_path / "port_ckpt.npz")
    run_pairwise(Serra09(), desc, fs.n_songs, checkpoint_path=ckpt,
                 checkpoint_every=1, device="cpu")

    class Refuses(JaxSerra09):
        def tile_scores(self, row, col):
            raise AssertionError("a finished ledger must not rescore")

    _assert_same_scores(jax_run_pairwise(Refuses(), desc, fs.n_songs,
                                         checkpoint_path=ckpt), want)

    ckpt = str(tmp_path / "jax_ckpt.npz")
    jax_run_pairwise(JaxSerra09(), desc, fs.n_songs, checkpoint_path=ckpt)

    class RefusesToo(Serra09):
        def tile_scores(self, row, col, plain=False):
            raise AssertionError("a finished ledger must not rescore")

    _assert_same_scores(run_pairwise(RefusesToo(), desc, fs.n_songs,
                                     checkpoint_path=ckpt, device="cpu"),
                        want)


def test_ssms_channel_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Serra09(do_ssms=True)


def test_cli_benchmark_on_cpu(corpus, tmp_path, monkeypatch, capsys):
    fs, _, _ = corpus
    fs.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "Serra09", "-d", "synth.npz",
                   "-s", "vrun", "--device", "cpu", "--cachedir", "ck"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "results appended to results_vrun.csv" in out
    rows = (tmp_path / "results_vrun.csv").read_text().splitlines()
    assert rows[0].startswith("name, MR, MRR, MDR, MAP")
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"Serra09_{k}" for k in SIM_TYPES]
    assert (tmp_path / "ck" / "Serra09_vrun_ckpt.npz").exists()
