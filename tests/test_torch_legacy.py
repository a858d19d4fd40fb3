"""The port's legacy similarity API (`ops/similarity_legacy.py`) against
the JAX package's: the numpy CRP math must be identical (the same numpy
code), and the cover distances, which go through each package's
single-pair qmax / dmax, equal for equal and unequal gaps."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import numpy as np
import pytest

from acoss_tpu.ops import similarity_legacy as jax_legacy
from acoss_tpu_torch.ops import similarity_legacy as legacy


def _chromas(seed, n_a=70, n_b=64):
    rng = np.random.default_rng(seed)
    base = rng.random((n_a, 12)).astype(np.float32)
    # B is A transposed by 5 semitones, cut and noisy: a cover
    b = np.roll(base[:n_b], 5, axis=1) + 0.1 * rng.random((n_b, 12))
    return base, b.astype(np.float32)


def test_global_hpcp_and_oti_match_jax():
    a, b = _chromas(0)
    np.testing.assert_array_equal(legacy.global_hpcp(a),
                                  jax_legacy.global_hpcp(a))
    oti = legacy.optimal_transposition_index(a, b)
    assert oti == jax_legacy.optimal_transposition_index(a, b) == 7
    assert legacy.global_hpcp(np.zeros((3, 12))).max() == 0


@pytest.mark.parametrize("flat_roll", [False, True])
@pytest.mark.parametrize("oti", [0, 3, 11])
def test_transpose_by_oti_matches_jax(flat_roll, oti):
    _, b = _chromas(1)
    got = legacy.transpose_by_oti(b, oti, flat_roll=flat_roll)
    np.testing.assert_array_equal(
        got, jax_legacy.transpose_by_oti(b, oti, flat_roll=flat_roll))
    if flat_roll and oti:
        # the reference's literal roll of the flattened buffer
        assert got[1, 0] == b[0, 12 - oti]


@pytest.mark.parametrize("tau,m", [(1, 9), (2, 3), (1, 1)])
def test_to_embedding_matches_jax(tau, m):
    a, _ = _chromas(2)
    got = legacy.to_embedding(a, tau, m)
    np.testing.assert_array_equal(got, jax_legacy.to_embedding(a, tau, m))
    assert got.shape == (len(range(0, a.shape[0] - m * tau, tau)), 12 * m)


@pytest.mark.parametrize("transpose", [True, False])
def test_cross_recurrent_plot_matches_jax(transpose):
    a, b = _chromas(3)
    got = legacy.cross_recurrent_plot(a, b, transpose=transpose)
    want = jax_legacy.cross_recurrent_plot(a, b, transpose=transpose)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("sim_type", ["qmax", "dmax"])
@pytest.mark.parametrize("gaps", [(0.5, 0.5), (0.3, 0.8), (0.8, 0.3),
                                  (-0.2, 0.4)])
def test_serra_cover_similarity_measures_match_jax(sim_type, gaps):
    """Equal gaps, the unequal gaps of the legacy surface and a negative
    gap, outside the JAX package's kernel guards (on the card all of these
    launch a kernel but dmax with unequal gaps)."""
    a, b = _chromas(4)
    crp = legacy.cross_recurrent_plot(a, b)
    go, ge = gaps
    got = legacy.serra_cover_similarity_measures(
        crp, dis_onset=go, dis_extension=ge, sim_type=sim_type,
        device="cpu")
    want = jax_legacy.serra_cover_similarity_measures(
        crp, dis_onset=go, dis_extension=ge, sim_type=sim_type)
    assert isinstance(got, float)
    assert got == want and np.isfinite(got)


def test_serra_cover_similarity_measures_rejects_unknown_type():
    with pytest.raises(ValueError, match="smith"):
        legacy.serra_cover_similarity_measures(np.zeros((5, 5)),
                                               sim_type="smith",
                                               device="cpu")
