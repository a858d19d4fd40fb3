"""The port's CRP ops, fused-CRP plain version and corpus downsampling
against the JAX package (the fused Pallas kernel in interpret mode, the
XLA ops of `crp.py` and `segment.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.ops import crp as jax_crp
from acoss_tpu.ops import segment as jax_segment
from acoss_tpu.ops.crp_pallas import fused_binary_crp_batch as jax_fused
from acoss_tpu_torch.ops import crp, crp_cuda, segment


def _features(seed, B, L, d, l1=None, l2=None):
    rng = np.random.default_rng(seed)
    l1 = rng.integers(10, L + 1, B).astype(np.int32) if l1 is None else l1
    l2 = rng.integers(10, L + 1, B).astype(np.int32) if l2 is None else l2
    X = rng.standard_normal((B, L, d)).astype(np.float32)
    Y = rng.standard_normal((B, L, d)).astype(np.float32)
    for b in range(B):
        X[b, l1[b]:] = 0
        Y[b, l2[b]:] = 0
    return X, Y, np.asarray(l1, np.int32), np.asarray(l2, np.int32)


def _port_fused(fn, X, Y, l1, l2, kappa, m):
    S, l1e, l2e = fn(*(torch.from_numpy(a) for a in (X, Y, l1, l2)),
                     kappa, m)
    return S.numpy(), l1e.numpy(), l2e.numpy()


# the m-window sums and kNN thresholds use only fp32 adds and multiplies
# in index order on both sides; the interpret-mode JAX kernel's dot
# product reduces in the same order at these shapes, so the CRPs are
# compared bit for bit
@pytest.mark.parametrize("m,d,B", [(9, 12, 5), (9, 13, 8), (1, 12, 3),
                                   (1, 13, 4)])
def test_fused_ref_matches_pallas_interpret(m, d, B):
    X, Y, l1, l2 = _features(10 * m + d, B, 64, d)
    want = [np.asarray(a) for a in jax_fused(
        X, Y, l1, l2, kappa=0.095, m=m, interpret=True)]
    got = _port_fused(crp_cuda.fused_binary_crp_ref, X, Y, l1, l2, 0.095, m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() > 0


def _ties_at_kth(X, Y, l1, l2, kappa, m):
    """Rows of the pairs' windowed CSMs (exact in float64 for features on
    an integer grid) whose k-th smallest value occurs more than once."""
    n = 0
    for b in range(X.shape[0]):
        l1e, l2e = max(l1[b] - m + 1, 0), max(l2[b] - m + 1, 0)
        k = int(np.round(kappa * l2e))
        if l1e == 0 or k == 0:
            continue
        x, y = X[b].astype(np.float64), Y[b].astype(np.float64)
        D = ((x[:, None] - y[None]) ** 2).sum(-1)
        W = sum(D[q:q + l1e, q:q + l2e] for q in range(m))
        kth = np.sort(W, axis=1)[:, k - 1]
        n += int(((W == kth[:, None]).sum(1) > 1).sum())
    return n


# at L = 72 a kernel lane holds three keys of a line and a band or strip
# is cut short; the tie-heavy input puts the features on an integer grid,
# so that many windowed sums tie at the k-th value (ties are all kept)
@pytest.mark.parametrize("d", [12, 13])
@pytest.mark.parametrize("ties", [False, True])
def test_fused_ref_matches_pallas_interpret_l72(d, ties):
    X, Y, l1, l2 = _features(20 + d + 2 * ties, 6, 72, d)
    l1[:3], l2[:3] = [72, 41, 67], [72, 72, 37]
    if ties:
        X, Y = np.round(X), np.round(Y)
        assert _ties_at_kth(X, Y, l1, l2, 0.095, 9) > 0
    want = [np.asarray(a) for a in jax_fused(
        X, Y, l1, l2, kappa=0.095, m=9, interpret=True)]
    got = _port_fused(crp_cuda.fused_binary_crp_ref, X, Y, l1, l2, 0.095, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() > 0


def test_fused_ref_degenerate_pairs():
    """An odd batch with a zero-length pair and pairs whose rounded k is 0
    (l2e = 5 -> round(0.095 * 5) = 0): all-zero CRPs, as in the JAX
    kernel."""
    l1 = np.array([0, 40, 13, 64, 30], np.int32)
    l2 = np.array([50, 13, 64, 64, 9], np.int32)
    X, Y, l1, l2 = _features(7, 5, 64, 12, l1, l2)
    want = [np.asarray(a) for a in jax_fused(
        X, Y, l1, l2, kappa=0.095, m=9, interpret=True)]
    got = _port_fused(crp_cuda.fused_binary_crp_ref, X, Y, l1, l2, 0.095, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][[0, 1, 2, 4]].sum() == 0 and got[0][3].sum() > 0


def test_fused_wrapper_on_cpu_is_the_plain_version():
    X, Y, l1, l2 = _features(3, 4, 32, 13)
    fn = crp_cuda.fused_binary_crp_batch
    before = (fn.launches, fn.cluster_launches)
    got = _port_fused(fn, X, Y, l1, l2, 0.2, 3)
    want = _port_fused(crp_cuda.fused_binary_crp_ref, X, Y, l1, l2, 0.2, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (fn.launches, fn.cluster_launches) == before


@pytest.mark.parametrize("kappa", [0.0, 1.0, 3.0])
def test_fused_rejects_integer_kappa_conventions(kappa):
    X, Y, l1, l2 = _features(4, 2, 16, 12)
    with pytest.raises(ValueError, match="0 < kappa < 1"):
        _port_fused(crp_cuda.fused_binary_crp_batch, X, Y, l1, l2, kappa, 9)


def _windowed_csm(seed, L=48, d=12, m=9):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((L, d)).astype(np.float32)
    Y = rng.standard_normal((L, d)).astype(np.float32)
    return np.array(jax_crp.sliding_csm_padded(
        jax_crp.get_csm(jnp.asarray(X), jnp.asarray(Y)), m))


@pytest.mark.parametrize("kappa", [0.0, 0.095, 3.0])
@pytest.mark.parametrize("mutual", [False, True])
def test_csm_to_binary_matches_jax(kappa, mutual):
    """One windowed CSM binarized by both packages, with and without
    lengths (incl. a negative effective length and a zero-k pair)."""
    D = _windowed_csm(int(kappa * 10) + mutual)
    jfn = jax_crp.csm_to_binary_mutual if mutual else jax_crp.csm_to_binary
    tfn = crp.csm_to_binary_mutual if mutual else crp.csm_to_binary
    for lens in [(None, None), (40, 31), (-3, 20), (30, 5)]:
        want = np.asarray(jfn(jnp.asarray(D), kappa, *lens))
        got = tfn(torch.from_numpy(D), kappa, *lens).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(lens))
    # batched: per-pair lengths over a (2, 2) batch of the same matrix
    Db = np.broadcast_to(D, (2, 2) + D.shape).copy()
    l1 = np.array([[40, 12], [0, 48]], np.int32)
    l2 = np.array([[31, 48], [20, 7]], np.int32)
    got = tfn(torch.from_numpy(Db), kappa, torch.from_numpy(l1),
              torch.from_numpy(l2)).numpy()
    for i in range(2):
        for j in range(2):
            want = np.asarray(jfn(jnp.asarray(D), kappa, l1[i, j], l2[i, j]))
            np.testing.assert_array_equal(got[i, j], want)


def test_csm_and_window_match_jax():
    """The float CSMs agree to fp32 rounding (matmuls reduce in another
    order than XLA's)."""
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((40, 13)) * 3 + 20).astype(np.float32)
    Y = (rng.standard_normal((33, 13)) * 3 + 20).astype(np.float32)
    for jfn, tfn in [(jax_crp.get_csm, crp.get_csm),
                     (jax_crp.get_csm_centered, crp.get_csm_centered)]:
        want = np.asarray(jfn(jnp.asarray(X), jnp.asarray(Y)))
        got = tfn(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    D = np.abs(rng.standard_normal((40, 33))).astype(np.float32)
    want = np.asarray(jax_crp.sliding_csm_padded(jnp.asarray(D), 9))
    got = crp.sliding_csm_padded(torch.from_numpy(D), 9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("offset", [0.0, 50.0])
def test_ssm_centered_and_sliding_csm_match_jax(offset):
    """`get_ssm_centered` (large-norm rows: the centring case) and the
    valid-cells `sliding_csm` within 1e-5 of the JAX package's; the port's
    also take a batch of matrices."""
    rng = np.random.default_rng(8)
    X = (rng.standard_normal((2, 30, 13)) + offset).astype(np.float32)
    got = crp.get_ssm_centered(torch.from_numpy(X)).numpy()
    for b in range(2):
        want = np.asarray(jax_crp.get_ssm_centered(jnp.asarray(X[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)
    D = np.abs(rng.standard_normal((2, 25, 18))).astype(np.float32)
    for win in (1, 9):
        got = crp.sliding_csm(torch.from_numpy(D), win).numpy()
        assert got.shape == (2, 26 - win, 19 - win)
        for b in range(2):
            want = np.asarray(jax_crp.sliding_csm(jnp.asarray(D[b]), win))
            np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)


def test_oti_and_transpose_chroma_match_jax():
    rng = np.random.default_rng(6)
    C1 = rng.random((6, 12)).astype(np.float32)
    C2 = rng.random((6, 12)).astype(np.float32)
    want = np.asarray(jax.vmap(jax_crp.get_oti)(C1, C2))
    got = crp.get_oti(torch.from_numpy(C1), torch.from_numpy(C2)).numpy()
    np.testing.assert_array_equal(got, want)
    # ties: a flat chroma scores every shift the same -> the first max
    flat = np.ones(12, np.float32)
    assert int(crp.get_oti(torch.from_numpy(flat),
                           torch.from_numpy(C2[0]))) == \
        int(jax_crp.get_oti(flat, C2[0])) == 0
    X = rng.random((6, 20, 12)).astype(np.float32)
    want = np.stack([np.asarray(jax_crp.transpose_chroma(X[b], int(o)))
                     for b, o in enumerate(got)])
    np.testing.assert_array_equal(
        crp.transpose_chroma(torch.from_numpy(X),
                             torch.from_numpy(got)).numpy(), want)


@pytest.mark.parametrize("aggregate", ["median", "mean"])
def test_uniform_downsample_batch_matches_jax(aggregate):
    """Remainder windows (lengths not a multiple of fac), even window
    counts (fac = 40 and remainders of 2 and 10 frames) and odd ones,
    a song shorter than one window, and NaNs zeroed. Medians are exact;
    means are float32 sums taken in another order than XLA's."""
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal((n, 13)).astype(np.float32) * 4
              for n in (400, 402, 417, 10, 1283)]
    arrays[2][5, 3] = np.nan
    want = jax_segment.uniform_downsample_batch(arrays, 40, aggregate,
                                                bucket=512, batch_size=2)
    got = segment.uniform_downsample_batch(arrays, 40, aggregate,
                                           device="cpu", bucket=512,
                                           batch_size=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        if aggregate == "median":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
