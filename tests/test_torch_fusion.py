"""The port's SNF ops (`ops.fusion`) and the plain versions of its three
selection kernels (`ops.crp_cuda`) against the JAX package on the CPU:
the XLA ops of `acoss_tpu.ops.fusion`, and the Pallas kernels of
`acoss_tpu.ops.crp_pallas` in interpret mode."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.ops import fusion as jax_fusion
from acoss_tpu.ops.crp_pallas import binarize_matrix_batch as jax_binarize
from acoss_tpu.ops.crp_pallas import knn_mask_matrix_batch as jax_knn_mask
from acoss_tpu.ops.crp_pallas import wcsmssm_batch as jax_wcsmssm
from acoss_tpu_torch.ops import crp_cuda, fusion

# Float tolerances. The affinities are exp() of quotients of means of
# sorted values: torch and XLA sum the means (cumsum) and evaluate exp
# with their own rounding, a few ulps apart, so rtol 1e-5 (atol 1e-7 for
# the values exp sends towards 0). The diffusion adds three rounds of
# 2L-long fp32 dot products summed in another order: rtol 1e-4, atol 1e-6.
W_TOL = dict(rtol=1e-5, atol=1e-7)
SNF_TOL = dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ssm(rng, B, L):
    X = rng.random((B, L, L)).astype(np.float32)
    X = 0.5 * (X + X.transpose(0, 2, 1))
    X[:, np.arange(L), np.arange(L)] = 0
    return X


# per-pair lengths and neighbour budgets like EarlySNF's, with a tiny K
L1 = np.array([40, 33, 12, 40], np.int32)
L2 = np.array([40, 21, 15, 3], np.int32)
KS = np.array([8, 5, 1, 0], np.int32)


def test_get_w_matches_jax():
    rng = np.random.default_rng(0)
    D = _ssm(rng, 4, 40)
    got = fusion.get_W(_t(D), _t(KS), length=_t(L1)).numpy()
    for b in range(4):
        want = np.asarray(jax_fusion.get_W(jnp.asarray(D[b]), int(KS[b]),
                                           length=int(L1[b])))
        np.testing.assert_allclose(got[b], want, **W_TOL)
        assert (got[b, L1[b]:] == 0).all() and (got[b, :, L1[b]:] == 0).all()
    # unpadded, with a host-int K (the bounded top-k selection)
    got = fusion.get_W(_t(D[0]), 5).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_fusion.get_W(jnp.asarray(D[0]), 5)), **W_TOL)


def test_get_wcsm_matches_jax_incl_zero_block():
    rng = np.random.default_rng(1)
    C = rng.random((4, 40, 40)).astype(np.float32) + 0.05
    C[3] = 0.0                       # the zero-denominator guard: W = 1
    k1, k2 = np.array([4, 2, 0, 3]), np.array([3, 6, 1, 2])
    got = fusion.get_WCSM(_t(C), _t(k1), _t(k2), row_length=_t(L1),
                          col_length=_t(L2)).numpy()
    for b in range(4):
        want = np.asarray(jax_fusion.get_WCSM(
            jnp.asarray(C[b]), int(k1[b]), int(k2[b]),
            row_length=int(L1[b]), col_length=int(L2[b])))
        np.testing.assert_allclose(got[b], want, **W_TOL)
    assert np.isfinite(got).all()
    assert (got[3, :L1[3], :L2[3]] == 1).all()


def test_get_wcsmssm_matches_jax_with_per_pair_k():
    """Per-pair K (traced in the JAX package) split as K m // (m + n),
    incl. K = 0 and 1; the bounded selection (k_static_max) gives the
    same values as the full sort."""
    rng = np.random.default_rng(2)
    A, Bm = _ssm(rng, 4, 40), _ssm(rng, 4, 40)
    C = rng.random((4, 40, 40)).astype(np.float32)
    for kmax in (None, 9):
        got = fusion.get_WCSMSSM(_t(A), _t(Bm), _t(C), _t(KS),
                                 m_len=_t(L1), n_len=_t(L2),
                                 k_static_max=kmax).numpy()
        for b in range(4):
            want = np.asarray(jax_fusion.get_WCSMSSM(
                jnp.asarray(A[b]), jnp.asarray(Bm[b]), jnp.asarray(C[b]),
                jnp.asarray(KS[b]), m_len=jnp.asarray(L1[b]),
                n_len=jnp.asarray(L2[b]), k_static_max=9))
            np.testing.assert_allclose(got[b], want, **W_TOL)


@pytest.mark.parametrize("reg_diag", [False, True])
def test_get_p_and_get_s_match_jax(reg_diag):
    rng = np.random.default_rng(3)
    W = rng.random((3, 30, 30)).astype(np.float32)
    W[rng.random(W.shape) < 0.2] = 0.25            # ties at the threshold
    W[2, 20:] = 0.0                                # zero rows: norm 1
    got = fusion.get_P(_t(W), reg_diag).numpy()
    for b in range(3):
        want = np.asarray(jax_fusion.get_P(jnp.asarray(W[b]), reg_diag))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-8)
    k = np.array([4, 30, 7])
    got = fusion.get_S(_t(W), _t(k)).numpy()
    for b in range(3):
        want = np.asarray(jax_fusion.get_S(jnp.asarray(W[b]), int(k[b])))
        np.testing.assert_array_equal(got[b] != 0, want != 0)
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-8)
    assert (got[2, 20:] == 0).all()


def _padded_ws(seed, P=3, F=2, n=48, lens=(48, 40, 30)):
    rng = np.random.default_rng(seed)
    Ws = np.zeros((P, F, n, n), np.float32)
    for p in range(P):
        for f in range(F):
            D = _ssm(rng, 1, lens[p])[0] + 0.05
            Ws[p, f, :lens[p], :lens[p]] = np.asarray(
                jax_fusion.get_W(jnp.asarray(D), 6))
    return Ws


@pytest.mark.parametrize("sequential", [False, True])
def test_snf_ws_matches_jax_both_update_orders(sequential):
    """Per-pair K; F = 2 as in EarlySNF, where the in-place order gives
    other (plausible) numbers than Jacobi; padded rows and columns stay
    exact zeros off the diagonal."""
    Ws = _padded_ws(4)
    K = np.array([9, 4, 1], np.int32)
    got = fusion.snf_ws(_t(Ws), _t(K), niters=3, sequential=sequential)
    got = got.numpy()
    for p in range(3):
        want = np.asarray(jax_fusion.snf_ws(
            jnp.asarray(Ws[p]), int(K[p]), niters=3, sequential=sequential))
        np.testing.assert_allclose(got[p], want, **SNF_TOL)
    off = ~np.eye(48, dtype=bool)
    assert (got[2][30:][off[30:]] == 0).all()
    other = fusion.snf_ws(_t(Ws), _t(K), niters=3,
                          sequential=not sequential).numpy()
    assert np.abs(other - got).max() > 1e-6


def test_snf_ws_three_affinities_matches_jax():
    Ws = _padded_ws(5, P=1, F=3)[0]
    for sequential in (False, True):
        got = fusion.snf_ws(_t(Ws), 5, niters=4,
                            sequential=sequential).numpy()
        want = np.asarray(jax_fusion.snf_ws(jnp.asarray(Ws), 5, niters=4,
                                            sequential=sequential))
        np.testing.assert_allclose(got, want, **SNF_TOL)


def test_snf_and_snf_padded_match_jax():
    rng = np.random.default_rng(6)
    Ds = _ssm(rng, 2, 36) + 0.1
    Ws, fused = fusion.snf(_t(Ds), K=5, niters=4)
    jWs, jfused = jax_fusion.snf(jnp.asarray(Ds), K=5, niters=4)
    np.testing.assert_allclose(Ws.numpy(), np.asarray(jWs), **W_TOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), **SNF_TOL)
    Dp = np.zeros((2, 48, 48), np.float32)
    Dp[:, :36, :36] = Ds
    got = fusion.snf_padded(_t(Dp), 5, niters=4, length=36).numpy()
    want = np.asarray(jax_fusion.snf_padded(jnp.asarray(Dp), 5, niters=4,
                                            length=36))
    np.testing.assert_allclose(got, want, **SNF_TOL)
    np.testing.assert_allclose(got[:36, :36], fused.numpy(), **SNF_TOL)


def test_snf_ws_throughput_mode_rounds_operands_to_bf16():
    """precision='default': each diffusion product takes bf16-rounded
    operands (the TPU's DEFAULT product), so it differs from the parity
    mode by bf16 rounding and no more."""
    Ws = _padded_ws(7)
    K = np.array([9, 4, 6], np.int32)
    hi = fusion.snf_ws(_t(Ws), _t(K), niters=3, sequential=True)
    lo = fusion.snf_ws(_t(Ws), _t(K), niters=3, sequential=True,
                       precision="default")
    assert not torch.equal(hi, lo)
    np.testing.assert_allclose(lo.numpy(), hi.numpy(), rtol=3e-2, atol=1e-4)
    with pytest.raises(ValueError, match="precision"):
        fusion.snf_ws(_t(Ws), _t(K), niters=1, precision="fast")


# ----------------------------------------------------- kernels' plain ----

def test_binarize_ref_matches_pallas_interpret_bit_for_bit():
    """Negative values, the negated SNF cross block (-0.0 next to +0.0,
    ties), pairs whose rounded k is 0, a zero and a negative length."""
    rng = np.random.default_rng(8)
    B, L, kappa = 6, 48, 0.095
    D = rng.standard_normal((B, L, L)).astype(np.float32)
    fused = rng.random((2, L, L)).astype(np.float32)
    fused[rng.random(fused.shape) < 0.3] = 0.0
    D[:2] = -fused                       # full of -0.0
    D[1, :, ::5] = np.abs(D[1, :, ::5])  # mixed-sign zeros in one row
    D[2] = np.round(D[2] * 2) / 2        # many ties
    l1 = np.array([48, 40, 48, 5, 0, 30], np.int32)
    l2 = np.array([48, 44, 33, 48, 20, -2], np.int32)
    want = np.asarray(jax_binarize(D, l1, l2, kappa=kappa, interpret=True))
    got = crp_cuda.binarize_matrix_ref(_t(D), _t(l1), _t(l2), kappa).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:3].sum() > 0 and got[3:].sum() == 0


@pytest.mark.parametrize("largest", [True, False])
def test_knn_mask_ref_matches_pallas_interpret_bit_for_bit(largest):
    """k = 1, k = n, k clamped from 0 and from above n, rows of ties and
    of zeros."""
    rng = np.random.default_rng(9)
    B, n = 5, 64
    W = rng.random((B, n, n)).astype(np.float32)
    W[rng.random(W.shape) < 0.2] = 0.25
    W[1, 3] = 0.5
    W[2, :10] = 0.0
    k = np.array([1, 64, 17, 0, 99], np.int32)
    want = np.asarray(jax_knn_mask(W, k, largest=largest, interpret=True))
    got = crp_cuda.knn_mask_matrix_ref(_t(W), _t(k), largest).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_binarize_ref_matches_pallas_interpret_near_full_lengths():
    """Bit for bit at L = 96 with l1 != l2 near L: rows and columns keep
    different counts (rint(0.095 * 93) = 9, rint(0.095 * 96) = 9,
    rint(0.095 * 89) = 8), on negative values with ties."""
    rng = np.random.default_rng(13)
    B, L, kappa = 4, 96, 0.095
    D = -np.round(rng.random((B, L, L)) * 8).astype(np.float32) / 8
    l1 = np.array([96, 89, 95, 96], np.int32)
    l2 = np.array([93, 96, 94, 89], np.int32)
    want = np.asarray(jax_binarize(D, l1, l2, kappa=kappa, interpret=True))
    got = crp_cuda.binarize_matrix_ref(_t(D), _t(l1), _t(l2), kappa).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.reshape(B, -1).sum(1) > 0).all()


def test_knn_mask_ref_matches_pallas_interpret_past_64():
    """Bit for bit at n = 256 with k from 65 to 128, past the two smallest
    keys a lane of a warp's search: ties at the threshold, -0.0 next to
    +0.0."""
    rng = np.random.default_rng(14)
    B, n = 4, 256
    W = rng.random((B, n, n)).astype(np.float32)
    W[rng.random(W.shape) < 0.2] = 0.25
    W[3, :, ::4] = -0.0
    k = np.array([65, 96, 128, 100], np.int32)
    for largest in (True, False):
        want = np.asarray(jax_knn_mask(W, k, largest=largest, interpret=True))
        got = crp_cuda.knn_mask_matrix_ref(_t(W), _t(k), largest).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        # at least k cells a row kept (matrix 3's zeros are not counted)
        assert ((got[:3] != 0).sum(-1) >= k[:3, None]).all()


def test_wcsmssm_ref_matches_pallas_interpret():
    """Value-equal at the JAX package's own bound (rtol 2e-5, atol 2e-6):
    the kernel sums the neighbourhood means in another order."""
    rng = np.random.default_rng(10)
    B, L = 4, 64
    A, Bm = rng.random((2, B, L, L)).astype(np.float32)
    C = rng.random((B, L, L)).astype(np.float32)
    l1 = np.array([64, 40, 12, 64], np.int32)
    l2 = np.array([64, 56, 15, 2], np.int32)
    K = (np.float32(0.095) * (l1 + l2).astype(np.float32)).astype(np.int32)
    assert K.min() <= 2
    want = np.asarray(jax_wcsmssm(A, Bm, C, l1, l2, K, interpret=True))
    got = crp_cuda.wcsmssm_ref(*(_t(a) for a in (A, Bm, C, l1, l2, K)))
    assert got.shape == (B, 2 * L, 2 * L)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("L", [24, 40])
def test_wcsmssm_ref_symmetries_and_pallas_interpret(L):
    """The exact symmetries the kernel's tiled output writes once and
    mirrors: W_SSMA and W_SSMB equal their transposes and the lower-left
    quadrant the transpose of the upper-right one, bit for bit; and the
    JAX bound (rtol 2e-5, atol 2e-6) on ragged lengths, K = 0 and 1."""
    rng = np.random.default_rng(12 + L)
    B = 5
    A, Bm, C = rng.random((3, B, L, L)).astype(np.float32)
    l1 = np.array([L, L - 5, 7, 1, 0], np.int32)
    l2 = np.array([L - 3, L, 2, L // 2, L], np.int32)
    K = (np.float32(0.095) * (l1 + l2).astype(np.float32)).astype(np.int32)
    K[0], K[1] = 1, 0
    got = crp_cuda.wcsmssm_ref(*(_t(a) for a in (A, Bm, C, l1, l2, K)))
    WA, WB = got[:, :L, :L], got[:, L:, L:]
    assert torch.equal(WA, WA.transpose(1, 2))
    assert torch.equal(WB, WB.transpose(1, 2))
    assert torch.equal(got[:, L:, :L], got[:, :L, L:].transpose(1, 2))
    want = np.asarray(jax_wcsmssm(A, Bm, C, l1, l2, K, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    assert got[:4].sum() > 0 and (got[4, :L] == 0).all()


def test_wrappers_on_cpu_are_the_plain_versions():
    """A CPU tensor takes the plain version and counts no launch."""
    rng = np.random.default_rng(11)
    D = _t(rng.standard_normal((3, 32, 32)).astype(np.float32))
    ln = _t(np.array([32, 20, 9], np.int32))
    K = _t(np.array([5, 3, 1], np.int32))
    before = [f.launches for f in (crp_cuda.binarize_matrix_batch,
                                   crp_cuda.knn_mask_matrix_batch,
                                   crp_cuda.wcsmssm_batch)]
    assert torch.equal(crp_cuda.binarize_matrix_batch(D, ln, ln),
                       crp_cuda.binarize_matrix_ref(D, ln, ln))
    assert torch.equal(crp_cuda.knn_mask_matrix_batch(D, K),
                       crp_cuda.knn_mask_matrix_ref(D, K))
    A = D.abs()
    assert torch.equal(crp_cuda.wcsmssm_batch(A, A, A, ln, ln, K),
                       crp_cuda.wcsmssm_ref(A, A, A, ln, ln, K))
    assert before == [f.launches for f in (crp_cuda.binarize_matrix_batch,
                                           crp_cuda.knn_mask_matrix_batch,
                                           crp_cuda.wcsmssm_batch)]


@pytest.mark.parametrize("kappa", [0.0, 1.0, 3.0])
def test_binarizer_rejects_integer_kappa_conventions(kappa):
    D = torch.zeros((1, 8, 8))
    ln = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="0 < kappa < 1"):
        crp_cuda.binarize_matrix_batch(D, ln, ln, kappa)
