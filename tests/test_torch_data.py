"""The port's numpy copies of the data and evaluation modules against the
JAX package's originals: identical synthetic corpora, `.npz` files that
load in either package, and identical retrieval statistics and CSV rows."""

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
