"""Cross-recurrence-plot math in plain PyTorch: a frozen copy of
`acoss_tpu_torch.ops.crp`, with the plain versions of the fused CRP and
the matrix binarizer (`crp_cuda.*_ref`) appended, so that the benchmark's
reference does not move with the program.

Every function takes optional leading batch dimensions, so one call covers
a whole tile of song pairs (the JAX package vmaps per-pair functions
instead). Ragged songs are padded to a common length and carry explicit
per-pair lengths; padded cells of every CRP are zero.

"""

from __future__ import annotations

import contextlib

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


def get_csm_centered(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """`get_csm` after subtracting X's first row from BOTH point clouds:
    exact in infinite precision, and it removes the fp32 cancellation of
    the Gram trick when feature norms are large (HTK MFCCs' leading energy
    term)."""
    c = X[..., :1, :]
    return get_csm(X - c, Y - c)


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


_INF_BITS = 0x7F800000
_MAX_FINITE_BITS = 0x7F7FFFFF


def _k(kappa: float, length: torch.Tensor) -> torch.Tensor:
    """round(kappa * length) in float32, half to even."""
    return torch.round(length.to(torch.float32)
                       * torch.tensor(kappa, dtype=torch.float32,
                                      device=length.device))


def fused_binary_crp_ref(X: torch.Tensor, Y: torch.Tensor, l1: torch.Tensor,
                         l2: torch.Tensor, kappa: float = 0.095, m: int = 9,
                         dtype: torch.dtype = torch.float32):
    """Per pair b: the squared-Euclidean CSM of X[b] (L, d) against Y[b],
    summed over the m-frame diagonal window; each valid row keeps the
    values <= its k-th smallest with k = round(kappa * l2e) and each valid
    column those <= its k-th smallest with k = round(kappa * l1e) (ties
    kept); S is the AND of both. The dot products, norms and window sums
    are explicit loops in index order. `dtype` is the precision of that
    arithmetic (float32 as the configuration states; bfloat16 only for
    the control the benchmark's correctness check must fail).

    Returns (S (B, L, L) uint8 zero outside (l1e, l2e) and all zero when
    a rounded k is 0, l1e, l2e) with l1e = max(l1 - m + 1, 0).
    """
    B, L, d = X.shape
    dev = X.device
    X, Y = X.to(dtype), Y.to(dtype)
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
    acc = acc.to(torch.float32)
    ar = torch.arange(L, device=dev)
    valid = ((ar[None, :, None] < l1e[:, None, None])
             & (ar[None, None, :] < l2e[:, None, None]))
    bits = torch.where(valid, acc.view(torch.int32), _INF_BITS)
    kr = torch.clamp_min(_k(kappa, l2e), 1).to(torch.int64)
    kc = torch.clamp_min(_k(kappa, l1e), 1).to(torch.int64)
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
