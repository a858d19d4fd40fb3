"""The port's FTM2D and its five ablations against the JAX package on the
CPU: the numpy copies it carries (`sync_agg`, `fix_frames`, `chrompwr_np`,
`fft2_mag_patches`, the shingles), `chrompwr`, the one-Gram
`full_scores`, `benchmark(FTM2D)` and the CLI, on the JAX package's e2e
corpus (20 songs, 8 cliques of 2 + 4 distractors)."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import FTM2D as JaxFTM2D
from acoss_tpu.benchmarking.algorithms import ftm2d as jax_ftm2d
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import crp as jax_crp
from acoss_tpu.ops import segment as jax_segment
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS, FTM2D
from acoss_tpu_torch.benchmarking.algorithms import ftm2d
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.ops import crp, segment

# the default and the reference's five ablation files
VARIANTS = {
    "FTM2D": {},
    "noLog": {"do_log": False},
    "noNorm": {"do_norm": False},
    "noNormNoLog": {"do_log": False, "do_norm": False},
    "zeroPad": {"mode": "zeropad", "PAD_LEN": 256, "do_log": False},
    "zeroPadLog": {"mode": "zeropad", "PAD_LEN": 256, "do_log": True},
}


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_dataset(n_cliques=8, clique_size=2,
                                  n_distractors=4, seed=1)


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


@pytest.mark.parametrize("aggregate", ["median", "mean"])
def test_sync_agg_and_fix_frames_bit_equal(aggregate):
    rng = np.random.default_rng(3)
    X = rng.random((97, 12)).astype(np.float32)
    for bounds in (np.array([5, 17, 17, 40, 96, 120]), np.arange(0, 97, 9),
                   np.array([], np.int64)):
        np.testing.assert_array_equal(segment.fix_frames(bounds, 97),
                                      jax_segment.fix_frames(bounds, 97))
        got = segment.sync_agg(X, bounds, aggregate)
        want = jax_segment.sync_agg(X, bounds, aggregate)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_chrompwr_np_bit_equal_and_torch_close():
    rng = np.random.default_rng(4)
    X = rng.random((12, 50)).astype(np.float32) - 0.3
    X[:, 7] = 0.0                                  # a zero column stays 0
    for P, axis in ((1.96, 0), (0.5, -1)):
        want = jax_crp.chrompwr_np(X, P, axis)
        np.testing.assert_array_equal(crp.chrompwr_np(X, P, axis), want)
        # fp32 on both sides, elementwise ops and a 12-term reduction
        got = crp.chrompwr(torch.from_numpy(X), P, axis).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_crp.chrompwr(jnp.asarray(X), P, axis)),
            rtol=1e-6, atol=1e-7)
        assert np.all(got[:, 7] == 0) or axis == -1


@pytest.mark.parametrize("nbeats,win", [(40, 20), (75, 75), (10, 20)])
def test_fft2_mag_patches_bit_equal(nbeats, win):
    bt = np.random.default_rng(nbeats).random((12, nbeats))
    got = ftm2d.fft2_mag_patches(bt, win)
    want = jax_ftm2d.fft2_mag_patches(bt, win)
    assert got.shape == want.shape == (max(nbeats - win + 1, 0), 12 * win)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_descriptors_bit_equal(corpus, variant):
    kw = VARIANTS[variant]
    got = FTM2D(**kw).extract_descriptors(_port_fs(corpus), device="cpu")
    want = JaxFTM2D(**kw).extract_descriptors(corpus)
    assert list(got) == ["shingle"] and got["shingle"].dtype == np.float32
    np.testing.assert_array_equal(got["shingle"], want["shingle"])
    assert np.abs(want["shingle"]).sum(axis=1).min() > 0   # none vacuous


def test_fewer_beats_than_win_is_an_all_zero_shingle():
    rng = np.random.default_rng(5)
    chroma = rng.random((300, 12)).astype(np.float32)
    onsets = np.arange(0, 300, 10)                       # 30 beats
    for kw in (VARIANTS["FTM2D"], VARIANTS["zeroPadLog"]):
        got = FTM2D(WIN=30, **kw).shingle(chroma, onsets)
        want = JaxFTM2D(WIN=30, **kw).shingle(chroma, onsets)
        assert not got.any() and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert FTM2D(WIN=29, **kw).shingle(chroma, onsets).any()


@pytest.mark.parametrize("variant", ["FTM2D", "zeroPadLog"])
def test_full_scores_match_jax(corpus, variant):
    """One fp32 Gram against XLA's on the same (JAX-made) shingles, with
    one shingle zeroed (a song with too few beats): rtol 1e-5."""
    kw = VARIANTS[variant]
    desc = JaxFTM2D(**kw).extract_descriptors(corpus)
    desc["shingle"][3] = 0.0
    want = np.array(jax_ftm2d._gram_exp(jnp.asarray(desc["shingle"])))
    got = FTM2D(**kw).full_scores(
        {"shingle": torch.from_numpy(desc["shingle"])})["main"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    # through the harness: the diagonal is zeroed, as in the JAX package
    D = run_pairwise(FTM2D(**kw), desc, corpus.n_songs, device="cpu")
    np.fill_diagonal(want, 0.0)
    np.testing.assert_allclose(D["main"], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_benchmark_matches_jax(corpus, variant, tmp_path):
    kw = VARIANTS[variant]
    times = {}
    got = benchmark(FTM2D(**kw), _port_fs(corpus), device="cpu",
                    results_csv=str(tmp_path / "p.csv"), times=times)
    want = jax_benchmark(JaxFTM2D(**kw), corpus,
                         results_csv=str(tmp_path / "j.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["main"].map > 0.4
    assert sorted(times) == ["eval", "extract", "sweep"]


def test_cli_ftm2d_on_cpu(corpus, tmp_path, monkeypatch, capsys):
    """A family that takes `chroma_type`: the CLI passes `-c` through."""
    assert ALL_ALGORITHMS["FTM2D"] is FTM2D
    corpus.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "FTM2D", "-d", "synth.npz", "-s",
                   "ft", "-c", "crema", "--device", "cpu",
                   "--no-checkpoint"])
    assert rc == 0
    assert "results appended to results_ft.csv" in capsys.readouterr().out
    rows = (tmp_path / "results_ft.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["FTM2D_main"]
    want = jax_benchmark(JaxFTM2D(chroma_type="crema"), corpus)["main"]
    assert float(rows[1].split(",")[4]) == pytest.approx(want.map, abs=1e-4)
