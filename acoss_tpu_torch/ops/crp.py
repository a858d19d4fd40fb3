"""Cross-recurrence-plot math in PyTorch (the subset of `acoss_tpu.ops.crp`
the ported algorithms use).

Every function takes optional leading batch dimensions, so one call covers
a whole tile of song pairs (the JAX package vmaps per-pair functions
instead). Ragged songs are padded to a common length and carry explicit
per-pair lengths; padded cells of every CRP are zero.

These are the plain versions: Serra09's per-pair path runs them, and on a
CUDA tile with 0 < kappa < 1 the fused kernel of `crp_cuda` replaces the
CSM -> window -> binarize chain.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def cuda_tf32(enabled: bool):
    """Set TF32 matmuls on or off for the block and restore the caller's
    setting after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def get_ssm(X: torch.Tensor) -> torch.Tensor:
    """Euclidean self-similarity matrix of the rows of X (..., N, d), with
    an exactly zero diagonal.

    The squared norms come from the diagonal of the one Gram matmul, not
    from a separate row reduction: within one matmul, bitwise-equal rows
    i, j reduce in the same order, so G[i,i] == G[j,j] == G[i,j] and their
    distance is exactly 0 (the repeat-padded ssms rows make duplicate rows
    routine; a few ulps of dust there flip kNN and affinity decisions)."""
    G = torch.matmul(X, X.transpose(-1, -2))
    sq = torch.diagonal(G, dim1=-2, dim2=-1)
    D2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * G, 0.0)
    n = X.shape[-2]
    D2 = D2 * (1.0 - torch.eye(n, dtype=D2.dtype, device=D2.device))
    return torch.sqrt(D2)


def get_csm(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Euclidean cross-similarity matrix between rows of X (..., M, d) and
    Y (..., N, d): sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))."""
    C = (torch.sum(X * X, dim=-1)[..., :, None]
         + torch.sum(Y * Y, dim=-1)[..., None, :]
         - 2.0 * torch.matmul(X, Y.transpose(-1, -2)))
    return torch.sqrt(torch.clamp_min(C, 0.0))


def get_csm_tile(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """`get_csm` of every (row song, column song) pair of a tile: X (bi, L,
    d), Y (bj, L, d) -> (bi, bj, L, L). The cross products are ONE
    (bi L, d) x (d, bj L) matmul, so wide descriptors (the 20,736-dim
    ssms) are never copied per pair."""
    bi, L, d = X.shape
    bj = Y.shape[0]
    G = torch.matmul(X.reshape(bi * L, d), Y.reshape(bj * L, d).T)
    G = G.reshape(bi, L, bj, L).permute(0, 2, 1, 3)
    C = (torch.sum(X * X, dim=-1)[:, None, :, None]
         + torch.sum(Y * Y, dim=-1)[None, :, None, :]
         - 2.0 * G)
    return torch.sqrt(torch.clamp_min(C, 0.0))


def gram_sqdist(X: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between all rows of X (N, d) from ONE
    fp32 Gram: max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0), the squared norms
    from a row reduction (the JAX package's formula; not `torch.cdist`,
    which rounds differently). TF32 is off inside, whatever the caller's
    setting: the JAX package computes the Gram at full fp32 precision."""
    sq = torch.sum(X * X, dim=1)
    with cuda_tf32(False):
        G = torch.matmul(X, X.T)
    return torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * G, 0.0)


def get_csm_centered(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """`get_csm` after subtracting X's first row from BOTH point clouds:
    exact in infinite precision, and it removes the fp32 cancellation of
    the Gram trick when feature norms are large (HTK MFCCs' leading energy
    term)."""
    c = X[..., :1, :]
    return get_csm(X - c, Y - c)


def get_csm_cosine(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Cosine-distance cross-similarity matrix between rows of X (..., M,
    d) and Y (..., N, d): 1 - cos, with a zero-norm row treated as norm
    1."""
    xn = torch.sqrt(torch.sum(X * X, dim=-1))
    yn = torch.sqrt(torch.sum(Y * Y, dim=-1))
    xn = torch.where(xn == 0, 1.0, xn)
    yn = torch.where(yn == 0, 1.0, yn)
    return 1.0 - torch.matmul(X / xn[..., None],
                              (Y / yn[..., None]).transpose(-1, -2))


def get_all_shift_scores(C1: torch.Tensor, C2: torch.Tensor) -> torch.Tensor:
    """scores[..., s] = sum_b roll(C1, s)[b] * C2[b] over all circular
    shifts s, as one matmul against the circulant of C1."""
    n = C1.shape[-1]
    ar = torch.arange(n, device=C1.device)
    idx = (ar[None, :] - ar[:, None]) % n
    circ = C1[..., idx]                      # circ[s, b] = C1[(b - s) % n]
    return torch.matmul(circ, C2[..., :, None])[..., 0]


def get_oti(C1: torch.Tensor, C2: torch.Tensor) -> torch.Tensor:
    """Optimal transposition index of C1 w.r.t. C2 (the first maximum
    over shifts on ties, as `jnp.argmax`)."""
    return torch.argmax(get_all_shift_scores(C1, C2), dim=-1)


def transpose_chroma(X: torch.Tensor, oti: torch.Tensor,
                     n_chroma: int = 12) -> torch.Tensor:
    """Circularly shift the chroma axis of X (..., n_chroma) by `oti`,
    whose shape is X's leading batch shape (without the frame axis):
    out[..., c] = X[..., (c - oti) % n_chroma]."""
    oti = torch.as_tensor(oti, device=X.device)
    idx = (torch.arange(n_chroma, device=X.device) - oti[..., None]) \
        % n_chroma                                 # (..., n_chroma)
    idx = idx[..., None, :].expand(X.shape)
    return torch.gather(X, -1, idx)


def get_csm_blocked_oti(X: torch.Tensor, Y: torch.Tensor, C1: torch.Tensor,
                        C2: torch.Tensor, csm_fn=get_csm_cosine,
                        n_chroma: int = 12) -> torch.Tensor:
    """CSM between stacked chroma blocks after a global OTI applied to X:
    X (..., M, D) holds D // n_chroma chroma vectors a row, each rolled by
    the OTI of the global chroma vectors C1 (..., n_chroma) against C2;
    then `csm_fn(X rolled, Y)`. The batch shape is that of the OTI (the
    broadcast of C1's and C2's), and X is expanded to it."""
    oti = get_oti(C1, C2)
    M, D = X.shape[-2:]
    X = X.expand(oti.shape + (M, D))
    X1 = transpose_chroma(X.reshape(oti.shape + (M * (D // n_chroma),
                                                 n_chroma)), oti, n_chroma)
    return csm_fn(X1.reshape(oti.shape + (M, D)), Y)


def sliding_window(X: torch.Tensor, win: int) -> torch.Tensor:
    """Delay embedding (..., N, d) -> (..., N - win + 1, d * win): column
    block i holds rows i .. i + N - win of X (`CRPUtils.py:8-22`; the
    layout of librosa's `stack_memory` that ChenFusion uses)."""
    M = X.shape[-2] - win + 1
    return torch.cat([X[..., i:i + M, :] for i in range(win)], dim=-1)


def sliding_window_padded(X: torch.Tensor, win: int) -> torch.Tensor:
    """`sliding_window` keeping the leading N rows: X is zero-extended by
    win - 1 rows first, so rows past length - win + 1 of a padded batch
    hold garbage from the padding (callers mask them)."""
    N = X.shape[-2]
    Xp = torch.cat([X, X.new_zeros(X.shape[:-2] + (win - 1, X.shape[-1]))],
                   dim=-2)
    return torch.cat([Xp[..., i:i + N, :] for i in range(win)], dim=-1)


def sliding_csm_padded(D: torch.Tensor, win: int) -> torch.Tensor:
    """Diagonal windowed RMS keeping the (..., M, N) shape:
    S[i, j] = sqrt(sum_k D[i+k, j+k]^2), k < win, with zeros past the
    edge (cells past length - win + 1 are garbage; callers mask them)."""
    M, N = D.shape[-2:]
    D2 = D * D
    acc = D2.clone()
    for k in range(1, win):
        acc[..., :M - k, :N - k] = acc[..., :M - k, :N - k] + D2[..., k:, k:]
    return torch.sqrt(acc)


def _lengths(length, batch_shape, device) -> torch.Tensor:
    return torch.as_tensor(length, device=device).to(torch.int64) \
        .expand(batch_shape)


def csm_to_binary(D: torch.Tensor, kappa: float, row_length=None,
                  col_length=None) -> torch.Tensor:
    """Binarize a CSM (..., M, N) by per-row nearest neighbours:

      kappa == 0  -> all ones;
      kappa < 1   -> round(kappa * valid columns) neighbours per row;
      kappa >= 1  -> int(kappa) neighbours per row;

    a row keeps every value <= its k-th smallest (ties kept), and a
    rounded count of 0 selects nothing (an all-zero CRP). Rows/columns past
    row_length/col_length are zero. Returns uint8."""
    M, N = D.shape[-2:]
    batch = D.shape[:-2]
    dev = D.device
    if kappa == 0:
        B = torch.ones(D.shape, dtype=torch.bool, device=dev)
    else:
        ncols = _lengths(N if col_length is None else col_length, batch,
                         dev)
        if kappa < 1:
            n_neighbs = torch.round(
                ncols.to(torch.float32)
                * torch.tensor(kappa, dtype=torch.float32, device=dev)
            ).to(torch.int64)
            kmax = min(max(int(round(kappa * N)) + 1, 1), N)
        else:
            n_neighbs = torch.full(batch, int(kappa), dtype=torch.int64,
                                   device=dev)
            kmax = min(max(int(kappa), 1), N)
        Dm = D
        if col_length is not None:
            col_valid = torch.arange(N, device=dev) < ncols[..., None]
            Dm = torch.where(col_valid[..., None, :], D,
                             torch.finfo(D.dtype).max)
        smallest = torch.sort(Dm, dim=-1).values
        k = torch.clamp(n_neighbs, 1, kmax)
        thresh = torch.gather(
            smallest, -1,
            (k - 1)[..., None, None].expand(batch + (M, 1)))
        thresh = torch.where((n_neighbs > 0)[..., None, None], thresh,
                             float("-inf"))
        B = Dm <= thresh
    if row_length is not None:
        rl = _lengths(row_length, batch, dev)
        B = B & (torch.arange(M, device=dev) < rl[..., None])[..., :, None]
    if col_length is not None:
        cl = _lengths(col_length, batch, dev)
        B = B & (torch.arange(N, device=dev) < cl[..., None])[..., None, :]
    return B.to(torch.uint8)


def csm_to_binary_mutual(D: torch.Tensor, kappa: float, row_length=None,
                         col_length=None) -> torch.Tensor:
    """Mutual-kNN binarization: AND of the row-kNN of D and of D^T."""
    B1 = csm_to_binary(D, kappa, row_length, col_length)
    B2 = csm_to_binary(D.transpose(-1, -2), kappa, col_length, row_length)
    return B1 * B2.transpose(-1, -2)


def chrompwr(X: torch.Tensor, P: float = 0.5, axis: int = -1) -> torch.Tensor:
    """Raise the profile of chroma columns to a power, preserving norm
    (FTM2D's helper): each column along `axis` is unit-normalized, raised
    to the power P (sign kept), renormalized and rescaled to its original
    L2 norm. Zero columns stay zero."""
    nX = torch.sqrt(torch.sum(X * X, dim=axis, keepdim=True))
    U = X / torch.where(nX == 0, 1.0, nX)
    UP = torch.abs(U) ** P * torch.sign(U)
    nUP = torch.sqrt(torch.sum(UP * UP, dim=axis, keepdim=True))
    return UP / torch.where(nUP == 0, 1.0, nUP) * nX


def chrompwr_np(X, P: float = 0.5, axis: int = -1) -> np.ndarray:
    """Host-numpy `chrompwr` in float64 (descriptor extraction calls it
    once per song)."""
    X = np.asarray(X, dtype=np.float64)
    nX = np.sqrt(np.sum(X * X, axis=axis, keepdims=True))
    safe = np.where(nX == 0, 1.0, nX)
    U = X / safe
    UP = np.abs(U) ** P * np.sign(U)
    nUP = np.sqrt(np.sum(UP * UP, axis=axis, keepdims=True))
    nUP = np.where(nUP == 0, 1.0, nUP)
    return UP / nUP * nX
