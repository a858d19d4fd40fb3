"""The port's numpy copies of the data and evaluation modules against the
JAX package's originals: identical synthetic corpora, `.npz` files that
load in either package, and identical retrieval statistics and CSV rows;
and its copies of `ops.curvature` and `sparse_gram.compact_shingles`."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import numpy as np
import pytest

from acoss_tpu.benchmarking import evaluation as jax_evaluation
from acoss_tpu.data import make_synthetic_dataset as jax_make
from acoss_tpu.data.store import FeatureSet as JaxFeatureSet
from acoss_tpu.data.store import pad_stack as jax_pad_stack
from acoss_tpu_torch.benchmarking import evaluation
from acoss_tpu_torch.data import FeatureSet, make_synthetic_dataset, \
    pad_stack


def _assert_same_featureset(a, b):
    assert sorted(a.features) == sorted(b.features)
    assert sorted(a.lengths) == sorted(b.lengths)
    for k in a.features:
        assert a.features[k].dtype == b.features[k].dtype, k
        np.testing.assert_array_equal(a.features[k], b.features[k])
    for k in a.lengths:
        np.testing.assert_array_equal(a.lengths[k], b.lengths[k])
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.track_ids, b.track_ids)


@pytest.mark.parametrize("kw", [
    {"n_cliques": 3, "clique_size": 2, "seed": 1},
    {"n_cliques": 2, "clique_size": 3, "n_distractors": 2, "seed": 4,
     "base_duration": 12.0, "cover_tempo_range": (1.0, 1.0)},
])
def test_synthetic_dataset_identical(kw):
    _assert_same_featureset(make_synthetic_dataset(**kw), jax_make(**kw))


def test_pad_stack_identical():
    rng = np.random.default_rng(0)
    arrays = [rng.random((n, 3)).astype(np.float32) for n in (4, 9, 1)]
    for pad_to in (None, 6, 12):
        got, want = pad_stack(arrays, pad_to), jax_pad_stack(arrays, pad_to)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_npz_round_trip_between_packages(tmp_path):
    fs = jax_make(n_cliques=2, clique_size=2, seed=3)
    fs.save(str(tmp_path / "jax.npz"))
    loaded = FeatureSet.load(str(tmp_path / "jax.npz"))
    _assert_same_featureset(loaded, fs)
    assert loaded.n_songs == 4
    np.testing.assert_array_equal(loaded.length("hpcp"), fs.length("hpcp"))
    sub = loaded.subset([3, 0])
    np.testing.assert_array_equal(sub.labels, fs.labels[[3, 0]])
    loaded.save(str(tmp_path / "port.npz"))
    _assert_same_featureset(JaxFeatureSet.load(str(tmp_path / "port.npz")),
                            fs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_statistics_identical(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n = 23
    # cliques of sizes 1..4, shuffled, with tied scores
    sizes = [4, 3, 3, 2, 2, 2, 3, 3, 1]
    labels = np.array([f"W_{i}" for i in
                       rng.permutation(np.repeat(np.arange(9), sizes))])
    D = np.round(rng.random((n, n)), 1).astype(np.float32)
    got = evaluation.eval_statistics(D, labels, topsidx=(1, 5, 10))
    want = jax_evaluation.eval_statistics(D, labels, topsidx=(1, 5, 10))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    evaluation.write_results_csv(str(tmp_path / "port.csv"), "A", "t", got)
    jax_evaluation.write_results_csv(str(tmp_path / "jax.csv"), "A", "t",
                                     want)
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()


@pytest.mark.parametrize("max_order,sigma,loop", [(3, 2, False), (2, 1.5, True),
                                                  (1, 3, False)])
def test_curvature_copy_identical(max_order, sigma, loop):
    from acoss_tpu.ops import curvature as jax_curvature
    from acoss_tpu_torch.ops import curvature

    rng = np.random.default_rng(max_order)
    X = np.cumsum(rng.normal(size=(60, 10)), axis=0)
    X[20:25] = X[19]                     # a flat stretch: zero velocity
    for g, w in zip(curvature.get_curv_vectors(X, max_order, sigma, loop),
                    jax_curvature.get_curv_vectors(X, max_order, sigma, loop),
                    strict=True):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(curvature.get_zero_crossings([X[:, :3], X[:, 3:]]),
                    jax_curvature.get_zero_crossings([X[:, :3], X[:, 3:]])):
        np.testing.assert_array_equal(g, w)
    sig = np.array([1.0, 2.5])
    for fn in ("get_scale_space_images", "get_multires_curvature_images"):
        for g, w in zip(getattr(curvature, fn)(X, max_order, sig),
                        getattr(jax_curvature, fn)(X, max_order, sig),
                        strict=True):
            np.testing.assert_array_equal(g, w)


def test_compact_shingles_copy_identical():
    from acoss_tpu.ops.sparse_gram import compact_shingles as jax_compact
    from acoss_tpu_torch.ops.sparse_gram import compact_shingles

    idx = [np.array([3, 7], np.int64), np.array([7], np.int64),
           np.array([], np.int64), np.array([1, 3, 9, 11], np.int64)]
    val = [np.array([1.0, 2.0], np.float32), np.array([3.0], np.float32),
           np.array([], np.float32),
           np.array([0.5, -1.0, 2.0, 4.0], np.float32)]
    got, want = compact_shingles(idx, val), jax_compact(idx, val)
    assert got[0] == want[0] == 5
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1][1], [2, 5, 5, 5])   # 5 = drop slot
