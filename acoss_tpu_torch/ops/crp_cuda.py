"""Wrappers of the hand-written CRP and selection CUDA kernels, the
counterparts of the TPU kernels of `acoss_tpu/ops/crp_pallas.py`:

- `fused_binary_crp_batch` (`csrc/crp.cu`, replaces `_fused_kernel`) for
  the surface Serra09 uses: squared-Euclidean CSM -> m-frame diagonal
  window -> exact mutual-kNN;
- `binarize_matrix_batch` (`csrc/knn.cu`, replaces `_binarize_kernel`):
  exact mutual-kNN of built (B, L, L) matrices, which may be negative;
- `knn_mask_matrix_batch` (`csrc/knn.cu`, replaces `_knn_mask_kernel`):
  `fusion.get_S`'s per-row rank threshold;
- `wcsmssm_batch` (`csrc/knn.cu`, replaces `_wcsmssm_kernel`): the SNF
  parent affinity of `fusion.get_WCSMSSM`.

Each wrapper given CPU tensors returns its plain version (`*_ref`);
given CUDA tensors it launches its kernel or raises. `launches` on each
wrapper counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from acoss_tpu_torch.ops import _build, crp
from acoss_tpu_torch.utils.profiling import stages

_INF_BITS = 0x7F800000
_MAX_FINITE_BITS = 0x7F7FFFFF


def _k(kappa: float, length: torch.Tensor) -> torch.Tensor:
    """round(kappa * length) in float32, half to even (as the kernel's
    rintf and the JAX kernel's jnp.round)."""
    return torch.round(length.to(torch.float32)
                       * torch.tensor(kappa, dtype=torch.float32,
                                      device=length.device))


def _check_kappa(kappa: float) -> None:
    if not 0.0 < kappa < 1.0:
        # kappa == 0 (all ones) and kappa >= 1 (a fixed neighbour count)
        # take crp.csm_to_binary[_mutual], as in the JAX package
        raise ValueError(f"the CRP kernels need 0 < kappa < 1 (got {kappa})"
                         f"; use crp.csm_to_binary_mutual otherwise")


def fused_binary_crp_ref(X: torch.Tensor, Y: torch.Tensor, l1: torch.Tensor,
                         l2: torch.Tensor, kappa: float = 0.095, m: int = 9):
    """Plain PyTorch version of the fused kernel, on X's device.

    Per pair b: the squared-Euclidean CSM of X[b] (L, d) against Y[b],
    summed over the m-frame diagonal window; each valid row keeps the
    values <= its k-th smallest with k = round(kappa * l2e) and each valid
    column those <= its k-th smallest with k = round(kappa * l1e) (ties
    kept); S is the AND of both. The dot products, norms and window sums
    are explicit loops in index order, the order the kernel adds in, so
    both give the same bits.

    Returns (S (B, L, L) uint8 zero outside (l1e, l2e) and all zero when
    a rounded k is 0, l1e, l2e) with l1e = max(l1 - m + 1, 0).
    """
    _check_kappa(kappa)
    B, L, d = X.shape
    dev = X.device
    l1e = torch.clamp_min(l1 - m + 1, 0)
    l2e = torch.clamp_min(l2 - m + 1, 0)
    sx = X[..., 0] * X[..., 0]
    sy = Y[..., 0] * Y[..., 0]
    xy = X[:, :, None, 0] * Y[:, None, :, 0]
    for k in range(1, d):
        sx = sx + X[..., k] * X[..., k]
        sy = sy + Y[..., k] * Y[..., k]
        xy = xy + X[:, :, None, k] * Y[:, None, :, k]
    csm = torch.clamp_min((sx[:, :, None] + sy[:, None, :]) - 2.0 * xy, 0.0)
    acc = csm.clone()
    for k in range(1, m):
        acc[:, :L - k, :L - k] = acc[:, :L - k, :L - k] + csm[:, k:, k:]
    ar = torch.arange(L, device=dev)
    valid = ((ar[None, :, None] < l1e[:, None, None])
             & (ar[None, None, :] < l2e[:, None, None]))
    bits = torch.where(valid, acc.view(torch.int32), _INF_BITS)
    kr = torch.clamp_min(_k(kappa, l2e), 1).to(torch.int64)
    kc = torch.clamp_min(_k(kappa, l1e), 1).to(torch.int64)
    # the smallest threshold <= the largest finite float that keeps >= k
    # values: the k-th smallest, or the largest finite float when that is
    # +inf (lines outside the valid block)
    t_row = torch.gather(torch.sort(bits, dim=2).values, 2,
                         (kr - 1)[:, None, None].expand(B, L, 1))
    t_col = torch.gather(torch.sort(bits, dim=1).values, 1,
                         (kc - 1)[:, None, None].expand(B, 1, L))
    t_row = torch.clamp_max(t_row, _MAX_FINITE_BITS)
    t_col = torch.clamp_max(t_col, _MAX_FINITE_BITS)
    S = (bits <= t_row) & (bits <= t_col)
    nonzero = (_k(kappa, l2e) > 0) & (_k(kappa, l1e) > 0)
    S = S & nonzero[:, None, None]
    return S.to(torch.uint8), l1e, l2e


def _check_lengths(like: torch.Tensor, **lengths) -> None:
    B = like.shape[0]
    for name, t in lengths.items():
        if (t.device != like.device or t.dtype != torch.int32
                or tuple(t.shape) != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {like.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_args(X, Y, l1, l2, m: int) -> None:
    if X.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {X.device}")
    for name, t in (("X", X), ("Y", Y)):
        if (t.dtype != torch.float32 or t.ndim != 3 or t.device != X.device
                or not t.is_contiguous() or t.shape != X.shape):
            raise ValueError(f"{name} must be a contiguous (B, L, d) "
                             f"float32 tensor on {X.device} shaped like X, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    _check_lengths(X, l1=l1, l2=l2)
    B, L, d = X.shape
    if m < 1 or B > 65535:
        raise ValueError(f"need m >= 1 and B <= 65535 (got m={m}, B={B})")
    # 0: no band of rows or strip of columns fits a block's shared memory,
    # or a line is longer than the kernels' keys in registers cover
    smem = _build.library().acoss_fused_crp_smem(L, d, m)
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"the fused CRP kernels cannot take L={L}, d={d}, "
                         f"m={m} (shared memory per block max "
                         f"{_build.MAX_SMEM} bytes, lines up to 6144)")


@functools.cache
def fused_crp_cluster(L: int, d: int, m: int) -> int:
    """The size of the thread-block cluster that builds a pair's CRP in one
    launch with the windowed matrix on chip (1 to 8: lines of up to 512,
    d up to 16), or 0 when the shape takes the two launches with the
    windowed matrix in device memory. `csrc/crp.cu` decides."""
    return _build.library().acoss_fused_crp_cluster(L, d, m)


def fused_binary_crp_batch(X: torch.Tensor, Y: torch.Tensor,
                           l1: torch.Tensor, l2: torch.Tensor,
                           kappa: float = 0.095, m: int = 9):
    """Batched binary CRPs (mutual kNN of the m-window squared-Euclidean
    CSM); the contract of `fused_binary_crp_ref`.

    X, Y: (B, L, d) float32; l1, l2: (B,) int32 true frame counts. The
    kernels write l1e and l2e too, so a call is its launches alone.
    `cluster_launches` (and the counter `crp:cluster_calls`) counts the
    calls that took the one-launch cluster kernel.
    """
    if X.device.type == "cpu":
        return fused_binary_crp_ref(X, Y, l1, l2, kappa, m)
    _check_kappa(kappa)
    _check_args(X, Y, l1, l2, m)
    B, L, d = X.shape
    dev = X.device
    cluster = fused_crp_cluster(L, d, m) > 0
    W = t_row = None
    if not cluster:
        # the two launches' scratch: the windowed matrix (only its valid
        # cells are written) and the row thresholds
        W = torch.empty((B, L, L), dtype=torch.float32, device=dev)
        t_row = torch.empty((B, L), dtype=torch.int32, device=dev)
    S = torch.empty((B, L, L), dtype=torch.uint8, device=dev)
    lens = torch.empty((2, B), dtype=torch.int32, device=dev)
    rc = _build.library().acoss_fused_crp(
        X.data_ptr(), Y.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, L, d,
        m, kappa, None if cluster else W.data_ptr(),
        None if cluster else t_row.data_ptr(), S.data_ptr(),
        lens.data_ptr(), lens.data_ptr() + 4 * B, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "acoss_fused_crp")
    fused_binary_crp_batch.launches += 1
    if cluster:
        fused_binary_crp_batch.cluster_launches += 1
        stages.add("crp:cluster_calls", 1)
    l1e, l2e = lens
    return S, l1e, l2e


fused_binary_crp_batch.launches = 0
fused_binary_crp_batch.cluster_launches = 0


def _check_square(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {t.device}")
    if (t.dtype != torch.float32 or t.ndim != 3 or t.shape[1] != t.shape[2]
            or not t.is_contiguous() or t.device != like.device
            or t.shape != like.shape):
        raise ValueError(f"{name} must be a contiguous (B, L, L) float32 "
                         f"tensor on {like.device} shaped like "
                         f"{tuple(like.shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


#: The longest lines the binarizer and the kNN mask search with a warp a
#: line, keys in registers (at most 192 a lane); longer lines, up to
#: `_build.MAX_SMEM / 4`, take a block a line with the keys in shared
#: memory. The C entry points dispatch on the shape.
SELECT_REGISTER_MAX_L = 32 * 192


def _check_line_smem(L: int, bytes_per_elem: int) -> None:
    if L * bytes_per_elem > _build.MAX_SMEM:
        raise ValueError(f"lines of {L} need {L * bytes_per_elem} bytes of "
                         f"shared memory per block (max {_build.MAX_SMEM})")


def binarize_matrix_ref(D: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                        kappa: float = 0.095) -> torch.Tensor:
    """Plain PyTorch version of the matrix binarizer: the mutual-kNN
    `crp.csm_to_binary_mutual` of every matrix of D (B, L, L), rows
    keeping round(kappa * l2[b]) neighbours and columns round(kappa *
    l1[b]) (ties kept), zero outside (l1[b], l2[b]) and all zero when a
    rounded count is 0. l1, l2 are the valid row / column counts. Returns
    (B, L, L) uint8."""
    _check_kappa(kappa)
    return crp.csm_to_binary_mutual(D, kappa, l1, l2)


def binarize_matrix_batch(D: torch.Tensor, l1: torch.Tensor,
                          l2: torch.Tensor,
                          kappa: float = 0.095) -> torch.Tensor:
    """Batched exact mutual-kNN binarization of (B, L, L) float32
    matrices, which may be negative (signed monotone keys, -0.0 made +0.0);
    the contract of `binarize_matrix_ref`, bit for bit. Requires
    0 < kappa < 1. l1, l2: (B,) int32."""
    if D.device.type == "cpu":
        return binarize_matrix_ref(D, l1, l2, kappa)
    _check_kappa(kappa)
    _check_square("D", D, D)
    _check_lengths(D, l1=l1, l2=l2)
    B, L, _ = D.shape
    if B > 65535:
        raise ValueError(f"need B <= 65535 (got {B})")
    _check_line_smem(L, 4)
    thr = torch.empty((B, 2, L), dtype=torch.int32, device=D.device)
    S = torch.empty((B, L, L), dtype=torch.uint8, device=D.device)
    rc = _build.library().acoss_binarize(
        D.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, L, kappa,
        thr.data_ptr(), S.data_ptr(), D.device.index,
        torch.cuda.current_stream(D.device).cuda_stream)
    _build.check(rc, "acoss_binarize")
    binarize_matrix_batch.launches += 1
    return S


binarize_matrix_batch.launches = 0


def knn_mask_matrix_ref(W: torch.Tensor, k: torch.Tensor,
                        largest: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kNN row mask: `fusion.get_S`'s
    selection without the normalisation. Per matrix b and row, t is the
    k[b]-th largest value (k-th smallest with largest=False), k clamped to
    [1, n]; returns where(W >= t, W, 0) (W <= t), ties kept."""
    from acoss_tpu_torch.ops import fusion

    if largest:
        return torch.where(W >= -fusion._kth_smallest(-W, k), W, 0.0)
    return torch.where(W <= fusion._kth_smallest(W, k), W, 0.0)


def knn_mask_matrix_batch(W: torch.Tensor, k: torch.Tensor,
                          largest: bool = True) -> torch.Tensor:
    """Per-row rank-threshold mask of a (B, n, n) float32 batch; the
    contract of `knn_mask_matrix_ref`, bit for bit. k: (B,) int32."""
    if W.device.type == "cpu":
        return knn_mask_matrix_ref(W, k, largest)
    _check_square("W", W, W)
    _check_lengths(W, k=k)
    B, n, _ = W.shape
    if B > 65535:
        raise ValueError(f"need B <= 65535 (got {B})")
    _check_line_smem(n, 4)
    V = torch.empty_like(W)
    rc = _build.library().acoss_knn_mask(
        W.data_ptr(), k.data_ptr(), B, n, int(largest), V.data_ptr(),
        W.device.index, torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(rc, "acoss_knn_mask")
    knn_mask_matrix_batch.launches += 1
    return V


knn_mask_matrix_batch.launches = 0


def wcsmssm_ref(SSMA: torch.Tensor, SSMB: torch.Tensor, CSM: torch.Tensor,
                l1: torch.Tensor, l2: torch.Tensor, K: torch.Tensor,
                Mu: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version of the fused WCSMSSM build:
    `fusion.get_WCSMSSM` of every pair, with l1/l2 the valid lengths of
    the A and B songs and K the neighbour budget. (B, 2L, 2L)."""
    from acoss_tpu_torch.ops import fusion

    return fusion.get_WCSMSSM(SSMA, SSMB, CSM, K, Mu, m_len=l1, n_len=l2)


#: The longest lines the WCSMSSM kernel takes: a warp holds a line's keys
#: in registers, at most 192 a lane.
WCSMSSM_MAX_L = 32 * 192


def wcsmssm_batch(SSMA: torch.Tensor, SSMB: torch.Tensor, CSM: torch.Tensor,
                  l1: torch.Tensor, l2: torch.Tensor, K: torch.Tensor,
                  Mu: float = 0.5) -> torch.Tensor:
    """Batched SNF parent affinities [[W_SSMA, W_CSM], [W_CSM^T, W_SSMB]]
    (B, 2L, 2L) from (B, L, L) float32 SSMA, SSMB, CSM and (B,) int32
    l1, l2, K. Value-equal to `wcsmssm_ref` within rtol 2e-5, atol 2e-6:
    the neighbourhood means are summed in another order (a throughput
    mode, not for bit-parity runs)."""
    if SSMA.device.type == "cpu":
        return wcsmssm_ref(SSMA, SSMB, CSM, l1, l2, K, Mu)
    for name, t in (("SSMA", SSMA), ("SSMB", SSMB), ("CSM", CSM)):
        _check_square(name, t, SSMA)
    _check_lengths(SSMA, l1=l1, l2=l2, K=K)
    B, L, _ = SSMA.shape
    if B > 65535 or L > WCSMSSM_MAX_L:
        raise ValueError(f"need B <= 65535 and L <= {WCSMSSM_MAX_L} (got "
                         f"B={B}, L={L})")
    stats =torch.empty((B, 4, L), dtype=torch.float32, device=SSMA.device)
    W = torch.empty((B, 2 * L, 2 * L), dtype=torch.float32,
                    device=SSMA.device)
    rc = _build.library().acoss_wcsmssm(
        SSMA.data_ptr(), SSMB.data_ptr(), CSM.data_ptr(), l1.data_ptr(),
        l2.data_ptr(), K.data_ptr(), B, L, Mu, stats.data_ptr(),
        W.data_ptr(), SSMA.device.index,
        torch.cuda.current_stream(SSMA.device).cuda_stream)
    _build.check(rc, "acoss_wcsmssm")
    wcsmssm_batch.launches += 1
    return W


wcsmssm_batch.launches = 0
