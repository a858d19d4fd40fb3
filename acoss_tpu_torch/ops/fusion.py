"""Similarity Network Fusion in PyTorch (port of `acoss_tpu.ops.fusion`,
after Wang et al. 2012/2014 and Tralie et al. ICASSP 2019).

Every matrix stays dense, so the cross-diffusion iterations
`P_i <- S_i . mean(P_k, k != i) . S_i^T` are batched matmuls. Functions
take leading batch dimensions where the JAX package vmaps (one batch
entry per song pair), and a neighbour count `K` is either a host int or
a tensor of the batch shape (EarlySNF's K = kappa * (M + N) depends on
each pair's lengths).

kNN selections are rank thresholds (the k-th order statistic per row,
ties kept). `get_S`'s selection and the WCSMSSM build have hand-written
CUDA kernels (`ops.crp_cuda`): `_get_S_stack` and `get_WCSMSSM_fast` go
through their wrappers, which run the plain versions on a CPU tensor.

Padding convention: a `length` argument marks the valid prefix; padded
rows/cols are excluded from neighbour statistics and forced to W = 0,
which propagates as exact zeros through get_P / get_S / diffusion (zero
rows are row-normalized by 1).
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.ops import crp_cuda
from acoss_tpu_torch.ops.crp import _lengths as _per_matrix
from acoss_tpu_torch.ops.crp import cuda_tf32

_BIG = 1e30


def _host_int(x) -> int | None:
    """x as a Python int when it is a host scalar, else None (a tensor)."""
    return int(x) if isinstance(x, (int, np.integer)) else None


def _per_stack(x, Ds: torch.Tensor) -> torch.Tensor:
    """One value per stack (host int or tensor of Ds.shape[:-3]) repeated
    for each of the stack's F matrices: (..., F)."""
    return _per_matrix(x, Ds.shape[:-3], Ds.device)[..., None] \
        .expand(Ds.shape[:-2])


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _smallest_sorted(D: torch.Tensor,
                     k_static_max: int | None) -> torch.Tensor:
    """Ascending per-row smallest values of D (..., M, N): with a bound
    k < N only the k smallest (the same values in the same order as the
    row sort's prefix), else the whole sorted row."""
    N = D.shape[-1]
    if k_static_max is None or k_static_max >= N:
        return torch.sort(D, dim=-1).values
    return torch.topk(D, max(int(k_static_max), 1), dim=-1, largest=False,
                      sorted=True).values


def _kth_smallest(D: torch.Tensor, k,
                  k_static_max: int | None = None) -> torch.Tensor:
    """Per-row k-th smallest value (1-indexed) of D (..., M, N), with one
    k per matrix clamped to [1, width]: (..., M, 1)."""
    srt = _smallest_sorted(D, k_static_max)
    kk = torch.clamp(_per_matrix(k, D.shape[:-2], D.device), 1,
                     srt.shape[-1])
    idx = (kk - 1)[..., None, None].expand(D.shape[:-1] + (1,))
    return torch.gather(srt, -1, idx)


def _mean_k_smallest(D: torch.Tensor, k,
                     k_static_max: int | None = None) -> torch.Tensor:
    """Per-row mean of the k smallest values of D (..., M, N), one k per
    matrix: the ascending cumulative sum at k, over k. (..., M)."""
    srt = _smallest_sorted(D, k_static_max)
    kk = torch.clamp(_per_matrix(k, D.shape[:-2], D.device), 1,
                     srt.shape[-1])
    if D.device.type == "cpu":
        csum = torch.cumsum(srt, dim=-1)
        idx = (kk - 1)[..., None, None].expand(D.shape[:-1] + (1,))
        tot = torch.gather(csum, -1, idx)[..., 0]
    else:
        # a masked sum: torch.cumsum of floats on a CUDA tensor is not
        # order-fixed, so two runs could differ
        first = torch.arange(srt.shape[-1], device=D.device) \
            < kk[..., None, None]
        tot = torch.sum(torch.where(first, srt, 0.0), dim=-1)
    return tot / kk.to(D.dtype)[..., None]


def get_W(D: torch.Tensor, K, Mu: float = 0.5, length=None,
          k_static_max: int | None = None) -> torch.Tensor:
    """Adaptive-bandwidth Gaussian affinity from self-dissimilarity
    matrices D (..., n, n) (`SimilarityFusion.py:50-71`, Eq. 1 of the SNF
    paper): symmetrize, zero the diagonal, radius = mean of the K+1
    smallest row entries scaled by (K+1)/K (the diagonal zero excluded),
    W = exp(-D^2 / (2 (Mu (r_i + r_j + D_ij) / 3)^2)). With `length` (one
    per matrix), neighbour statistics skip padded columns and W is zero
    outside the valid block."""
    if k_static_max is None:
        k_static_max = _host_int(K)
    n = D.shape[-1]
    batch = D.shape[:-2]
    DSym = 0.5 * (D + D.transpose(-1, -2))
    DSym = DSym * (1.0 - _eye(n, D))
    K = _per_matrix(K, batch, D.device)
    if length is not None:
        valid = torch.arange(n, device=D.device) \
            < _per_matrix(length, batch, D.device)[..., None]
        Dknn = torch.where(valid[..., None, :], DSym, _BIG)
    else:
        valid = None
        Dknn = DSym
    mean_dist = _mean_k_smallest(
        Dknn, K + 1,
        None if k_static_max is None else k_static_max + 1,
    ) * (K + 1)[..., None] / torch.clamp_min(K, 1)[..., None]
    eps = (mean_dist[..., :, None] + mean_dist[..., None, :] + DSym) / 3.0
    denom = 2.0 * (Mu * eps) ** 2
    denom = torch.where(denom == 0, 1.0, denom)
    W = torch.exp(-DSym ** 2 / denom)
    if valid is not None:
        W = W * (valid[..., :, None] & valid[..., None, :])
    return W


def get_WCSM(CSMAB: torch.Tensor, k1, k2, Mu: float = 0.5,
             row_length=None, col_length=None,
             k_static_max: int | None = None) -> torch.Tensor:
    """Exponential affinity of cross-dissimilarity matrices (..., M, N)
    (`SimilarityFusion.py:74-89`): row radius = mean of the k2 smallest in
    the row, column radius = mean of the k1 smallest in the column. An
    exactly zero denominator gives affinity 1 (the JAX package's guard;
    the reference would give NaN there)."""
    if k_static_max is None:
        b1, b2 = _host_int(k1), _host_int(k2)
        if b1 is not None and b2 is not None:
            k_static_max = max(b1, b2)
    M, N = CSMAB.shape[-2:]
    batch = CSMAB.shape[:-2]
    dev = CSMAB.device
    C = CSMAB
    if col_length is not None:
        cl = _per_matrix(col_length, batch, dev)[..., None, None]
        col_ok = torch.arange(N, device=dev)[None, :] < cl
        C = torch.where(col_ok, C, _BIG)
    if row_length is not None:
        rl = _per_matrix(row_length, batch, dev)[..., None, None]
        row_ok = torch.arange(M, device=dev)[:, None] < rl
        C = torch.where(row_ok, C, _BIG)
    m1 = _mean_k_smallest(C, k2, k_static_max)                    # rows
    m2 = _mean_k_smallest(C.transpose(-1, -2), k1, k_static_max)  # cols
    eps = (m1[..., :, None] + m2[..., None, :] + CSMAB) / 3.0
    denom = 2.0 * (Mu * eps) ** 2
    denom = torch.where(denom == 0, 1.0, denom)
    W = torch.exp(-CSMAB ** 2 / denom)
    if row_length is not None:
        W = W * row_ok
    if col_length is not None:
        W = W * col_ok
    return W


def setup_WCSMSSM(WSSMA, WSSMB, WCSMAB) -> torch.Tensor:
    """Assemble [[WSSMA, WCSMAB], [WCSMAB^T, WSSMB]]
    (`SimilarityFusion.py:91-108`)."""
    top = torch.cat([WSSMA, WCSMAB], dim=-1)
    bot = torch.cat([WCSMAB.transpose(-1, -2), WSSMB], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _split_k(K, m, n):
    """The neighbour budget split of `SimilarityFusion.py:110-132`:
    k1 = K m // max(m + n, 1), k2 = K - k1 (integer floor division)."""
    k1 = torch.div(K * m, torch.clamp_min(m + n, 1), rounding_mode="floor")
    return k1, K - k1


def get_WCSMSSM(SSMA, SSMB, CSMAB, K, Mu: float = 0.5, m_len=None,
                n_len=None, k_static_max: int | None = None):
    """Cross-affinity parent matrices (..., 2L, 2L) with the neighbour
    budget split between the SSM and CSM parts of each row
    (`SimilarityFusion.py:110-132`). Padded layout: A occupies [0:L), B
    occupies [L:2L) (real prefix of each), so the fused cross block is
    always at [0:L, L:2L)."""
    if k_static_max is None:
        k_static_max = _host_int(K)
    batch = SSMA.shape[:-2]
    dev = SSMA.device
    m = _per_matrix(SSMA.shape[-1] if m_len is None else m_len, batch, dev)
    n = _per_matrix(SSMB.shape[-1] if n_len is None else n_len, batch, dev)
    k1, k2 = _split_k(_per_matrix(K, batch, dev), m, n)
    WSSMA = get_W(SSMA, k1, Mu, length=None if m_len is None else m,
                  k_static_max=k_static_max)
    WSSMB = get_W(SSMB, k2, Mu, length=None if n_len is None else n,
                  k_static_max=k_static_max)
    WCSMAB = get_WCSM(CSMAB, k1, k2, Mu,
                      None if m_len is None else m,
                      None if n_len is None else n,
                      k_static_max=k_static_max)
    return setup_WCSMSSM(WSSMA, WSSMB, WCSMAB)


def get_WCSMSSM_fast(SSMA, SSMB, CSMAB, K, Mu: float = 0.5, m_len=None,
                     n_len=None, plain: bool = False):
    """`get_WCSMSSM` through the fused WCSMSSM kernel's wrapper
    (`crp_cuda.wcsmssm_batch`; its plain version with `plain=True`): the
    six neighbourhood means come from bit-pattern searches instead of row
    sorts. THROUGHPUT MODE: value-equal to `get_WCSMSSM` up to the fp32
    summation order of the means (rtol 2e-5, atol 2e-6), not
    bit-identical, so only `EarlySNF(snf_precision="default")` takes it."""
    batch = SSMA.shape[:-2]
    L = SSMA.shape[-1]
    dev = SSMA.device

    def flat(x):
        return _per_matrix(x, batch, dev).to(torch.int32).reshape(-1) \
            .contiguous()

    fn = crp_cuda.wcsmssm_ref if plain else crp_cuda.wcsmssm_batch
    W = fn(SSMA.reshape(-1, L, L).contiguous(),
           SSMB.reshape(-1, L, L).contiguous(),
           CSMAB.reshape(-1, L, L).contiguous(),
           flat(L if m_len is None else m_len),
           flat(L if n_len is None else n_len), flat(K), Mu=Mu)
    return W.reshape(batch + W.shape[1:])


def get_P(W: torch.Tensor, reg_diag: bool = False) -> torch.Tensor:
    """Row-stochastic matrices; optional 0.5 I + 0.5 P(off-diag) diagonal
    regularization (`SimilarityFusion.py:134-155`)."""
    n = W.shape[-1]
    if reg_diag:
        eye = _eye(n, W)
        WNoDiag = W * (1.0 - eye)
        row = torch.sum(WNoDiag, dim=-1)
        row = torch.where(row == 0, 1.0, row)
        return 0.5 * eye + 0.5 * WNoDiag / row[..., None]
    row = torch.sum(W, dim=-1)
    row = torch.where(row == 0, 1.0, row)
    return W / row[..., None]


def get_S(W: torch.Tensor, K, k_static_max: int | None = None):
    """Row-kNN-truncated, L1-row-normalized version of W (..., n, n),
    kept dense (`SimilarityFusion.py:157-177`; neighbours include the
    element itself; a rank threshold, so ties keep a few extra entries)."""
    if k_static_max is None:
        k_static_max = _host_int(K)
    thresh = -_kth_smallest(-W, K, k_static_max)    # k-th LARGEST per row
    V = torch.where(W >= thresh, W, 0.0)
    norm = torch.sum(V, dim=-1)
    norm = torch.where(norm == 0, 1.0, norm)
    return V / norm[..., None]


def _get_S_stack(Ws: torch.Tensor, K, plain: bool = False) -> torch.Tensor:
    """`get_S` of every matrix of Ws (..., n, n), with the rank-threshold
    selection from the kNN row-mask kernel's wrapper
    (`crp_cuda.knn_mask_matrix_batch`; its plain version with
    `plain=True`). The mask is bit-identical to `get_S`'s selection, so
    both SNF precision modes keep their numbers."""
    n = Ws.shape[-1]
    k = _per_matrix(K, Ws.shape[:-2], Ws.device).to(torch.int32) \
        .reshape(-1).contiguous()
    fn = crp_cuda.knn_mask_matrix_ref if plain \
        else crp_cuda.knn_mask_matrix_batch
    V = fn(Ws.reshape(-1, n, n).contiguous(), k, largest=True) \
        .reshape(Ws.shape)
    norm = torch.sum(V, dim=-1)
    norm = torch.where(norm == 0, 1.0, norm)
    return V / norm[..., None]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even), kept in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def snf_ws(Ws: torch.Tensor, K, niters: int = 20, reg_diag: bool = True,
           sequential: bool = False, precision: str = "highest",
           plain: bool = False) -> torch.Tensor:
    """Cross-diffusion of stacks of affinity matrices
    (`SimilarityFusion.py:202-277`):
      P_i <- S_i . mean(P_k, k != i) . S_i^T  for `niters` iterations,
    then average; with reg_diag each iterate is re-regularized as
    0.5 I + 0.5 rownorm(offdiag).

    Update order: the default is a Jacobi sweep (every P_i advances from
    the previous iterate, the rule the SNF paper states). The reference
    rebinds `Pts = nextPts` after iteration 1 (`SimilarityFusion.py:272`),
    so its later iterations update IN PLACE in index order: P_i sees the
    already-updated P_j, j < i. `sequential=True` reproduces that
    (iteration 1 Jacobi, the later ones in place).

    Args:
      Ws: (..., F, n, n) stacks of affinity matrices, one stack per batch
        entry (song pair).
      K: neighbours for the S truncation: a host int or one per stack.
      precision: "highest" (parity): the diffusion matmuls in full fp32,
        TF32 off. "default" (throughput): the TPU's DEFAULT product --
        both operands of each diffusion matmul rounded to bf16, products
        exact and summed in fp32. On a CUDA device those matmuls run with
        TF32 on: a bf16 value is exact in TF32, so the tensor cores then
        compute exactly that product.
      plain: take the kNN mask's plain version instead of its wrapper.
    Returns: fused (..., n, n) similarity matrices.
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown SNF precision {precision!r}")
    F = Ws.shape[-3]
    Ps = get_P(Ws, reg_diag)
    Ss = _get_S_stack(Ws, _per_stack(K, Ws), plain)
    fast = precision == "default"

    def mm(a, b):
        return torch.matmul(_bf16(a), _bf16(b)) if fast \
            else torch.matmul(a, b)

    def diffuse(S_i, mean_others):
        nxt = mm(mm(S_i, mean_others), S_i.transpose(-1, -2))
        return get_P(nxt, True) if reg_diag else nxt

    def jacobi(Ps):
        mean_others = (torch.sum(Ps, dim=-3, keepdim=True) - Ps) \
            / max(F - 1, 1)
        return diffuse(Ss, mean_others)

    with cuda_tf32(fast):
        if sequential and niters > 0:
            Ps = jacobi(Ps)
            for _ in range(niters - 1):
                for i in range(F):
                    mean_others = (torch.sum(Ps, dim=-3) - Ps[..., i, :, :]) \
                        / max(F - 1, 1)
                    # in place: P_{i+1} sees the new P_i
                    Ps[..., i, :, :] = diffuse(Ss[..., i, :, :], mean_others)
        else:
            for _ in range(niters):
                Ps = jacobi(Ps)
    return torch.sum(Ps, dim=-3) / F


def snf(Ds: torch.Tensor, K=5, niters: int = 20, reg_diag: bool = True,
        sequential: bool = False, k_static_max: int | None = None):
    """Full SNF from stacks of DISTANCE matrices (..., F, n, n)
    (`SimilarityFusion.py:279-287`): W each, then cross-diffuse.
    Returns (Ws, fused similarity matrices)."""
    if k_static_max is None:
        k_static_max = _host_int(K)
    Ws = get_W(Ds, _per_stack(K, Ds), k_static_max=k_static_max)
    return Ws, snf_ws(Ws, K, niters=niters, reg_diag=reg_diag,
                      sequential=sequential)


def snf_padded(Ds: torch.Tensor, K, niters: int = 20, reg_diag: bool = True,
               length=None, sequential: bool = False,
               k_static_max: int | None = None):
    """`snf` over zero-padded distance matrices (..., F, n, n) with a
    valid prefix `length` per stack: affinities are masked to the valid
    block, and zero rows/cols propagate exactly through get_P / get_S /
    diffusion."""
    if k_static_max is None:
        k_static_max = _host_int(K)
    Ws = get_W(Ds, _per_stack(K, Ds),
               length=None if length is None else _per_stack(length, Ds),
               k_static_max=k_static_max)
    return snf_ws(Ws, K, niters=niters, reg_diag=reg_diag,
                  sequential=sequential)
