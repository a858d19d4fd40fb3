"""The port's Simple (SiMPle, the first asymmetric family of the port)
against the JAX package on the CPU: the host descriptor copy, the masked
median, the tile scores, the asymmetric full-grid sweep (plain and
bucketed) and `benchmark(Simple)`, on the JAX package's e2e corpus at its
settings (WIN=20, SKIP=10)."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import Simple as JaxSimple
from acoss_tpu.benchmarking.algorithms import simple as jax_simple
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.benchmarking.harness import run_pairwise as jax_run_pairwise
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS, Simple
from acoss_tpu_torch.benchmarking.algorithms import simple
from acoss_tpu_torch.benchmarking.harness import (benchmark, run_pairwise,
                                                  run_pairwise_bucketed)
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet

KW = dict(WIN=20, SKIP=10)


@pytest.fixture(scope="module")
def corpus():
    fs = make_synthetic_dataset(n_cliques=8, clique_size=2,
                                n_distractors=4, seed=1)
    return fs, JaxSimple(**KW).extract_descriptors(fs)


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


def test_descriptors_bit_equal(corpus):
    fs, want = corpus
    got = Simple(**KW).extract_descriptors(_port_fs(fs), device="cpu")
    assert sorted(got) == sorted(want) == ["feat", "length", "profile"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["length"].min()) > 2 * KW["WIN"] // 2   # not vacuous
    # the default windows (WIN=200, SKIP=100) on one song
    ch = fs.feature("hpcp")[0, :fs.length("hpcp")[0]]
    np.testing.assert_array_equal(Simple()._song_descriptor(ch),
                                  JaxSimple()._song_descriptor(ch))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 0])
def test_masked_median_matches_jax(n):
    x = np.random.default_rng(n).random(8).astype(np.float32)
    x[max(n, 1):] = np.inf
    want = np.asarray(jax_simple.masked_median(jnp.asarray(x), n))
    got = simple.masked_median(torch.from_numpy(x)[None],
                               torch.tensor([n]))[0]
    assert float(got) == float(want)


def test_tile_scores_match_jax(corpus):
    """The batched tile against the JAX package's vmapped pair function on
    the same descriptors, an off-diagonal tile and a diagonal one (the
    fp32 CSMs come from other matmuls): rtol 1e-5. A song against itself
    (never kept by the sweep) scores the Gram's cancellation floor, a few
    1e-7 for SSLEN = 10 unit-norm frames: atol 2e-6 there. Asymmetric: the
    (i, j) and (j, i) scores differ."""
    fs, desc = corpus
    d = descriptors_from_numpy(desc, "cpu")
    for rows, cols in ((slice(0, 8), slice(8, 16)),
                       (slice(8, 16), slice(8, 16))):
        want = np.asarray(JaxSimple(**KW).tile_scores(
            jax.device_put({k: v[rows] for k, v in desc.items()}),
            jax.device_put({k: v[cols] for k, v in desc.items()}))["main"])
        got = Simple(**KW).tile_scores({k: v[rows] for k, v in d.items()},
                                       {k: v[cols] for k, v in d.items()})
        assert list(got) == ["main"] and got["main"].shape == (8, 8)
        got = got["main"].numpy()
        off = ~np.eye(8, dtype=bool) if rows == cols else np.ones((8, 8),
                                                                  bool)
        np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[~off], want[~off], rtol=0, atol=2e-6)
        assert np.isfinite(want).all() and (want <= 0).all()
    assert not np.allclose(want, want.T)


def test_run_pairwise_asymmetric_full_grid_matches_jax(corpus):
    """The asymmetric sweep scores the full row of tiles (3 x 3 tiles of 7
    songs, the last padded), and the matrix is the JAX package's."""
    fs, desc = corpus
    want = jax_run_pairwise(JaxSimple(**KW), desc, fs.n_songs, tile=7)
    got = run_pairwise(Simple(**KW), desc, fs.n_songs, tile=7, device="cpu")
    np.testing.assert_allclose(got["main"], want["main"], rtol=1e-5, atol=0)
    off = ~np.eye(fs.n_songs, dtype=bool)
    assert (got["main"][off] < 0).all() and (np.diag(got["main"]) == 0).all()
    upper = np.triu_indices(fs.n_songs, 1)
    assert not np.allclose(got["main"][upper], got["main"].T[upper])


def test_bucketed_sweep_matches_plain(corpus):
    """The length-bucketed sweep (3 buckets, each padded to its own width)
    equals the plain sweep on the length-sorted songs, as the JAX
    package's own test holds its two sweeps (atol 2e-4)."""
    fs, _ = corpus
    algo = Simple(pad_to_multiple=8, **KW)
    order = np.argsort(algo.bucket_lengths(fs), kind="stable")
    ds = _port_fs(fs.subset(order))
    desc = algo.extract_descriptors(ds, device="cpu")
    D_ref = run_pairwise(algo, desc, ds.n_songs, device="cpu")
    D_b = run_pairwise_bucketed(algo, ds, n_buckets=3, device="cpu")
    np.testing.assert_allclose(D_b["main"], D_ref["main"], atol=2e-4)
    upper = np.triu_indices(ds.n_songs, 1)
    assert (D_b["main"][upper] < 0).all()


def test_benchmark_matches_jax(corpus, tmp_path):
    fs, _ = corpus
    assert ALL_ALGORITHMS["Simple"] is Simple
    got = benchmark(Simple(**KW), _port_fs(fs), device="cpu",
                    results_csv=str(tmp_path / "p.csv"))
    want = jax_benchmark(JaxSimple(**KW), fs,
                         results_csv=str(tmp_path / "j.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["main"].map > 0.5
