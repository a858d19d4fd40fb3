"""Wrapper of the hand-written fused binary-CRP CUDA kernel
(`csrc/crp.cu`), which replaces the TPU kernel
`acoss_tpu/ops/crp_pallas.py::_fused_kernel` for the surface Serra09 uses:
squared-Euclidean CSM -> m-frame diagonal window -> exact mutual-kNN.

`fused_binary_crp_batch` given CPU tensors returns its plain version
`fused_binary_crp_ref`; given CUDA tensors it launches the kernel or
raises. `fused_binary_crp_batch.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from acoss_tpu_torch.ops import _build

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
        raise ValueError(f"the fused CRP needs 0 < kappa < 1 (got {kappa});"
                         f" use crp.csm_to_binary_mutual otherwise")


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


def _check_args(X, Y, l1, l2, m: int) -> None:
    if X.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {X.device}")
    for name, t in (("X", X), ("Y", Y)):
        if (t.dtype != torch.float32 or t.ndim != 3 or t.device != X.device
                or not t.is_contiguous() or t.shape != X.shape):
            raise ValueError(f"{name} must be a contiguous (B, L, d) "
                             f"float32 tensor on {X.device} shaped like X, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    B, L, d = X.shape
    for name, t in (("l1", l1), ("l2", l2)):
        if (t.device != X.device or t.dtype != torch.int32
                or tuple(t.shape) != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {X.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if m < 1 or B > 65535:
        raise ValueError(f"need m >= 1 and B <= 65535 (got m={m}, B={B})")
    smem = _build.library().acoss_fused_crp_smem(L, d, m)
    if smem > _build.MAX_SMEM or L * 4 > 48 * 1024:
        raise ValueError(f"L={L}, d={d}, m={m} needs {smem} bytes of "
                         f"shared memory per block (max {_build.MAX_SMEM})")


def fused_binary_crp_batch(X: torch.Tensor, Y: torch.Tensor,
                           l1: torch.Tensor, l2: torch.Tensor,
                           kappa: float = 0.095, m: int = 9):
    """Batched binary CRPs (mutual kNN of the m-window squared-Euclidean
    CSM); the contract of `fused_binary_crp_ref`.

    X, Y: (B, L, d) float32; l1, l2: (B,) int32 true frame counts.
    """
    if X.device.type == "cpu":
        return fused_binary_crp_ref(X, Y, l1, l2, kappa, m)
    _check_kappa(kappa)
    _check_args(X, Y, l1, l2, m)
    B, L, d = X.shape
    dev = X.device
    W = torch.empty((B, L, L), dtype=torch.float32, device=dev)
    thr = torch.empty((B, 2, L), dtype=torch.int32, device=dev)
    S = torch.empty((B, L, L), dtype=torch.uint8, device=dev)
    rc = _build.library().acoss_fused_crp(
        X.data_ptr(), Y.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, L, d,
        m, kappa, W.data_ptr(), thr.data_ptr(), S.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "acoss_fused_crp")
    fused_binary_crp_batch.launches += 1
    return S, torch.clamp_min(l1 - m + 1, 0), torch.clamp_min(l2 - m + 1, 0)


fused_binary_crp_batch.launches = 0
