"""Batched structural-descriptor pipeline of the Struc* families (port of
`acoss_tpu.ops.structure`).

The reference computes the Struc* descriptors one song at a time on the
host (`StrucFTM2D.py:50-158`, `StrucLaplacian.py:59-164`,
`StrucScattering.py:35-150`). Here a chunk of songs, padded to one width
with explicit per-song lengths, goes through each stage in a few batched
calls on the device:

- the delay-embedding (stack_memory) distance matrices come from the
  UNstacked base features: the squared distance of stacked rows i and j
  is a window sum over the (i, j) diagonal of the base squared-distance
  matrix (likewise the stacked dots and norms of the cosine CSM);
- SNF of a chunk's (B, F, npad, npad) stack is one `fusion.snf_ws` call,
  whose kNN truncation is one launch of the kNN row-mask kernel;
- the 2D-FFT log shingle with its exact top-k, the anti-aliased resize,
  and the Laplacian eigenvectors -> k-means -> meet matrix -> SVD chain
  take per-song lengths.

Every Gram here runs in full fp32 (TF32 off), as the JAX package's
`precision="highest"`.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.ops import fusion
from acoss_tpu_torch.ops.crp import cuda_tf32

_BIG_EIG = 1e4


def _lengths(lengths, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(lengths), device=device) \
        .to(torch.int64)


# ---------------------------------------------------------------------------
# Stacked-feature distances from unstacked base features
# ---------------------------------------------------------------------------

def _window_diag_sum(A: torch.Tensor, win: int, n_out: int) -> torch.Tensor:
    """out[..., i, j] = sum_{k<win} A[..., i + k, j + k] for A (..., P, P),
    P >= n_out + win - 1, added in the order k = 0, 1, ..."""
    out = A[..., 0:n_out, 0:n_out]
    for k in range(1, win):
        out = out + A[..., k:k + n_out, k:k + n_out]
    return out


def _gram(x: torch.Tensor):
    """Row squared norms (a row reduction) and the fp32 Gram of x."""
    sq = torch.sum(x * x, dim=-1)
    with cuda_tf32(False):
        G = torch.matmul(x, x.transpose(-1, -2))
    return sq, G


def stacked_euclidean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Euclidean SSM of the `win`-step delay embedding of x, without
    materializing the embedding.

    x: (..., P, d) base features FRONT-PADDED with win-1 zero rows (the
    zero history `segment.stack_memory` shifts in); P = n + win - 1.
    Returns (..., n, n) = `crp.get_ssm(stack_memory(base, win, 1))` up to
    rounding, clamped at 0 with a zero diagonal."""
    n = x.shape[-2] - (win - 1)
    sq, G = _gram(x)
    base2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * G,
                            0.0)
    D2 = torch.clamp_min(_window_diag_sum(base2, win, n), 0.0)
    D2 = D2 * (1.0 - torch.eye(n, dtype=x.dtype, device=x.device))
    return torch.sqrt(D2)


def stacked_cosine(x: torch.Tensor, win: int) -> torch.Tensor:
    """Cosine-distance SSM of the delay embedding of x (front-padded as in
    `stacked_euclidean`): `crp.get_csm_cosine(stack, stack)`, a zero-norm
    row taken as norm 1."""
    n = x.shape[-2] - (win - 1)
    sq, G = _gram(x)
    num = _window_diag_sum(G, win, n)
    # stacked squared norm of row i = sum_k |x[i + k]|^2, a 1-D window sum
    csq = torch.cumsum(torch.cat([sq.new_zeros(sq.shape[:-1] + (1,)), sq],
                                 dim=-1), dim=-1)
    nrm = torch.sqrt(torch.clamp_min(csq[..., win:] - csq[..., :-win], 0.0))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return 1.0 - num / (nrm[..., :, None] * nrm[..., None, :])


def fused_w_batch(feats, lengths, Ks, kinds: tuple, win: int,
                  niters: int = 10, reg_diag: bool = True,
                  sequential: bool = True,
                  k_static_max: int | None = None) -> torch.Tensor:
    """Fused structural affinity matrices of a chunk of songs.

    Args:
      feats: per feature a (B, npad + win - 1, d_f) tensor, front-padded
        with win-1 zero rows and zero past each song's length.
      lengths: (B,) valid row counts (shared by the features: callers cut
        each song to its shortest feature).
      Ks: (B,) SNF neighbour counts (`autotune_k`, one per song).
      kinds: per feature "euclidean" or "cosine".
      win: the delay-embedding depth (wins_per_block).
      k_static_max: an upper bound on every K (selects `topk` instead of a
        full row sort in the affinity radii; the same values).
    Returns (B, npad, npad) fused W on the features' device; rows and
    columns past a song's length are zero but for the reg_diag 0.5 on the
    diagonal (crop before use).
    """
    Ds = torch.stack([stacked_cosine(x, win) if kind == "cosine"
                      else stacked_euclidean(x, win)
                      for x, kind in zip(feats, kinds)], dim=1)
    dev = Ds.device
    lengths, Ks = _lengths(lengths, dev), _lengths(Ks, dev)
    Ws = fusion.get_W(Ds, fusion._per_stack(Ks, Ds),
                      length=fusion._per_stack(lengths, Ds),
                      k_static_max=k_static_max)
    return fusion.snf_ws(Ws, Ks, niters=niters, reg_diag=reg_diag,
                         sequential=sequential)


def _valid_block(W: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Zero W (..., n, n) outside each matrix's valid (length, length)
    block (clears the padded 0.5 diagonal `fusion.get_P` leaves)."""
    v = torch.arange(W.shape[-1], device=W.device) < length[..., None]
    return W * (v[..., :, None] & v[..., None, :])


# ---------------------------------------------------------------------------
# StrucFTM2D / StrucShingles: 2D-FFT log shingle + exact top-k
# ---------------------------------------------------------------------------

#: extra top-k capacity for values TIED with the n_keep-th largest (the
#: reference keeps every entry >= the cutoff, `StrucFTM2D.py:141-142`;
#: |fft2| of a real canvas has exact conjugate-pair duplicates, so ties at
#: the cutoff are common)
TIE_SLACK = 64


def shingle_topk_batch(W: torch.Tensor, lengths, pad_len: int, n_keep: int,
                       do_fft: bool = True):
    """Sparse structural shingles of a chunk (`StrucFTM2D.py:133-143` per
    song): each W's valid block in a (pad_len, pad_len) zero canvas,
    optionally |fft2|, then log(flat / ||flat|| + 1) with everything below
    the n_keep-th largest value dropped (ties at the cutoff kept, up to
    TIE_SLACK extras). log(x/n + 1) is monotone in x, so the kept set does
    not depend on the norm's rounding.

    Args:
      W: (B, npad, npad) fused affinities (padding need not be clean).
      lengths: (B,) valid row counts.
    Returns (idx (B, k) int32 flat indices, -1 past the kept set; val
    (B, k) float32), k = min(n_keep + TIE_SLACK, pad_len^2), by descending
    value.
    """
    B, npad, _ = W.shape
    n_in = min(npad, pad_len)
    k_tot = min(n_keep + TIE_SLACK, pad_len * pad_len)
    n = torch.clamp_max(_lengths(lengths, W.device), n_in)
    canvas = W.new_zeros((B, pad_len, pad_len))
    canvas[:, :n_in, :n_in] = _valid_block(W, n)[:, :n_in, :n_in]
    if do_fft:
        canvas = torch.abs(torch.fft.fft2(canvas))
    flat = canvas.reshape(B, -1)
    del canvas
    nrm = torch.sqrt(torch.sum(flat * flat, dim=-1, keepdim=True))
    s = torch.log(flat / torch.where(nrm > 0, nrm, 1.0) + 1.0)
    del flat
    val, idx = torch.topk(s, k_tot, dim=-1, largest=True, sorted=True)
    keep = val >= val[:, min(n_keep, k_tot) - 1:min(n_keep, k_tot)]
    return (torch.where(keep, idx, -1).to(torch.int32),
            torch.where(keep, val, 0.0))


# ---------------------------------------------------------------------------
# StrucScattering: anti-aliased resize with per-song lengths
# ---------------------------------------------------------------------------

def _reflect_idx(idx: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror-reflect indices into [0, n) (numpy's 'reflect': no edge
    repeat, period 2 (n - 1)); n broadcasts against idx."""
    period = torch.clamp_min(2 * (n - 1), 1)
    p = torch.remainder(torch.abs(idx), period)
    return torch.where(p < n, p, period - p)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, c), idx (B, ...) -> x[b, idx[b]] (B, ..., c)."""
    b = torch.arange(x.shape[0], device=x.device) \
        .reshape((-1,) + (1,) * (idx.ndim - 1))
    return x[b, idx]


def resize_dynamic_batch(W: torch.Tensor, lengths, out_size: int,
                         max_in: int | None = None) -> torch.Tensor:
    """Anti-aliased bilinear resize of each song's valid (n, n) block of W
    (B, npad, npad) to (out_size, out_size), n per song: the Gaussian
    pre-blur takes sigma = (n / out - 1) / 2 per song over one radius, the
    batch's worst case (from `max_in`, default npad), reflecting at the
    song's true edge; then skimage's edge-aligned bilinear grid. Matches
    `ops.resize.resize` of the cropped block up to rounding."""
    B, npad, _ = W.shape
    dev = W.device
    max_in = max_in or npad
    sigma_max = max(0.0, (max_in / out_size - 1) / 2)
    R = max(1, int(np.ceil(3 * sigma_max))) if sigma_max > 0 else 0
    n = torch.clamp_min(_lengths(lengths, dev), 1)
    nf = n.to(torch.float32)
    x = W
    if R > 0:
        sigma = torch.clamp_min((nf / out_size - 1) / 2, 0.0)[:, None]
        offs = torch.arange(-R, R + 1, device=dev).to(torch.float32)
        k = torch.where(sigma > 0,
                        torch.exp(-0.5 * (offs / torch.clamp_min(sigma, 1e-6))
                                  ** 2),
                        (offs == 0).to(torch.float32))
        k = k / torch.sum(k, dim=-1, keepdim=True)             # (B, 2R+1)
        rows = torch.arange(npad, device=dev)[:, None] \
            + torch.arange(-R, R + 1, device=dev)[None]
        ridx = _reflect_idx(rows[None], n[:, None, None])    # (B, npad, 2R+1)
        x = torch.einsum("brkc,bk->brc", _gather_rows(x, ridx), k)
        x = torch.einsum("brkc,bk->brc",
                         _gather_rows(x.transpose(1, 2), ridx), k) \
            .transpose(1, 2)
    scale = nf / out_size
    g = (torch.arange(out_size, device=dev).to(torch.float32)[None] + 0.5) \
        * scale[:, None] - 0.5
    g = torch.minimum(torch.clamp_min(g, 0.0), (nf - 1.0)[:, None])
    lo = torch.floor(g).to(torch.int64)
    hi = torch.minimum(lo + 1, (n - 1)[:, None])
    w = g - lo.to(torch.float32)                              # (B, out)
    rows = _gather_rows(x, lo) * (1 - w)[..., None] \
        + _gather_rows(x, hi) * w[..., None]                  # (B, out, npad)
    return (torch.gather(rows, 2, lo[:, None, :].expand(-1, out_size, -1))
            * (1 - w)[:, None, :]
            + torch.gather(rows, 2, hi[:, None, :].expand(-1, out_size, -1))
            * w[:, None, :])


# ---------------------------------------------------------------------------
# StrucLaplacian: eigenvectors -> k-means -> meet matrix -> SVD
# ---------------------------------------------------------------------------

def _median_filter_time(x: torch.Tensor, length: torch.Tensor,
                        size: int) -> torch.Tensor:
    """Median filter of x (B, n, d) along axis 1 with scipy's 'reflect'
    (numpy's 'symmetric') boundary at each song's length. `size` is odd,
    so the median is the middle value (`torch.median`'s lower median is
    the same)."""
    n = x.shape[1]
    r = size // 2
    dev = x.device
    pos = torch.arange(n, device=dev)[:, None] \
        + torch.arange(-r, r + 1, device=dev)[None, :]
    ln = length[:, None, None]
    period = torch.clamp_min(2 * ln, 1)
    p = torch.remainder(pos[None], period)
    idx = torch.clamp(torch.where(p < ln, p, period - 1 - p), 0, n - 1)
    return torch.median(_gather_rows(x, idx), dim=2).values


def rw_laplacian_eigs_padded(W: torch.Tensor,
                             length: torch.Tensor) -> torch.Tensor:
    """`laplacian.random_walk_laplacian_eigs` of the valid block of each
    padded W (B, n, n): a large diagonal bias pushes the padded dimensions
    to the TOP of the spectrum, so the leading (small-eigenvalue)
    eigenvectors are the valid block's, zero on padded rows."""
    n = W.shape[-1]
    W = _valid_block(W, length)
    pad = torch.arange(n, device=W.device) >= length[:, None]
    d = torch.sum(W, dim=-1)
    L = torch.diag_embed(d) - W
    sq = torch.sqrt(torch.clamp_min(d, 0.0))
    inv = torch.where(sq == 0, 1.0, 1.0 / sq)
    LSym = inv[:, :, None] * L * inv[:, None, :] \
        + torch.diag_embed(_BIG_EIG * pad.to(W.dtype))
    w = torch.linalg.eigh(LSym).eigenvectors
    return inv[:, :, None] * w


def kmeans_uniforms(seed: int, songs, k: int, n_init: int) -> torch.Tensor:
    """The kmeans++ draws of `_kmeans_labels` for songs `songs` at k
    clusters: (len(songs), n_init, k) uniforms in [0, 1), song s's from a
    CPU `torch.Generator` seeded with the 32-bit word that
    `numpy.random.SeedSequence([seed, s, k])` generates (the generator
    reads 32 bits of its seed), so a song's draws depend on neither its
    chunk nor the device."""
    out = torch.empty((len(songs), n_init, k), dtype=torch.float64)
    for b, s in enumerate(songs):
        word = np.random.SeedSequence([int(seed), int(s), int(k)]) \
            .generate_state(1)[0]
        g = torch.Generator().manual_seed(int(word))
        out[b] = torch.rand((n_init, k), generator=g, dtype=torch.float64)
    return out


def _draw(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One categorical draw a row of the weights p (..., n) by the inverse
    CDF at the uniform u (...,): the first index whose cumulative weight
    exceeds u times the row total, so a zero weight is never drawn. A row
    of zero total draws by u alone (uniformly over the row)."""
    c = torch.cumsum(p.to(torch.float64), dim=-1)
    tot = c[..., -1:]
    empty = tot == 0
    n = p.shape[-1]
    c = torch.where(empty, torch.arange(1, n + 1, device=p.device,
                                        dtype=torch.float64), c)
    tot = torch.where(empty, float(n), tot)
    i = torch.searchsorted(c.contiguous(), (u[..., None] * tot).contiguous(),
                           right=True)
    return torch.clamp_max(i[..., 0], n - 1)


def _kmeans_labels(x: torch.Tensor, wmask: torch.Tensor, k: int,
                   u: torch.Tensor, iters: int) -> torch.Tensor:
    """Masked k-means labels of a batch: kmeans++ seeding, a fixed number
    of Lloyd iterations, the best of the restarts by inertia (the
    reference's sklearn KMeans(n_clusters=k, n_init=50, max_iter=500),
    `Laplacian.py:113`).

    Args:
      x: (B, n, d) points; wmask (B, n) bool, the rows that count (a
        masked row is never a seed and moves no centre, but gets a label).
      u: (B, n_init, k) uniforms of the seeding draws (`kmeans_uniforms`).
    Returns (B, n) int64 labels; label ids are arbitrary (only label
    equality is read downstream).
    """
    B, n, d = x.shape
    I = u.shape[1]
    w = wmask.to(x.dtype)[:, None, :].expand(B, I, n)       # (B, I, n)
    xs = x[:, None].expand(B, I, n, d)

    def d2_to(centers):                                     # (B, I, k, d)
        return torch.sum((xs[:, :, :, None, :] - centers[:, :, None]) ** 2,
                         dim=-1)                            # (B, I, n, k)

    def pick(i):                                            # (B, I) -> x rows
        return torch.gather(xs, 2, i[..., None, None].expand(B, I, 1, d))

    c0 = pick(_draw(w, u[..., 0]))                           # (B, I, 1, d)
    centers = [c0]
    dist = torch.sum((xs - c0) ** 2, dim=-1)                 # (B, I, n)
    for j in range(1, k):
        cj = pick(_draw(w * dist, u[..., j]))
        centers.append(cj)
        dist = torch.minimum(dist, torch.sum((xs - cj) ** 2, dim=-1))
    centers = torch.cat(centers, dim=2)                      # (B, I, k, d)
    with cuda_tf32(False):
        for _ in range(iters):
            assign = torch.argmin(d2_to(centers), dim=-1)    # (B, I, n)
            onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) \
                * w[..., None]
            counts = torch.sum(onehot, dim=2)                # (B, I, k)
            sums = torch.matmul(onehot.transpose(-1, -2), xs)
            new = sums / torch.clamp_min(counts, 1.0)[..., None]
            centers = torch.where(counts[..., None] > 0, new, centers)
    D = d2_to(centers)
    inertia = torch.sum(w * torch.amin(D, dim=-1), dim=-1)   # (B, I)
    best = torch.argmin(inertia, dim=1)
    labels = torch.argmin(D, dim=-1)                         # (B, I, n)
    return torch.gather(labels, 1, best[:, None, None].expand(B, 1, n))[:, 0]


def spectral_features(W: torch.Tensor, lengths, neigs: int,
                      evec_smooth: int = 9) -> torch.Tensor:
    """The first `neigs` random-walk Laplacian eigenvectors of each padded
    W (B, npad, npad), median-filtered along time: (B, npad, neigs)."""
    n = _lengths(lengths, W.device)
    vs = rw_laplacian_eigs_padded(W, n)
    return _median_filter_time(vs[..., :neigs].contiguous(), n, evec_smooth)


def meet_matrices(vs: torch.Tensor, lengths, times, neigs: int,
                  meet_pad: int, songs=None, seed: int = 0,
                  n_init: int = 50, iters: int = 60):
    """The hierarchy meet matrices of a chunk from its spectral features
    vs (B, npad, >= neigs): k-means of the first k features at
    k = 2..neigs (level k - 1), each song's labels sampled on its meet
    grid. Returns (meet (B, meet_pad, meet_pad) float32, nmeet (B,)
    int64)."""
    B, npad, _ = vs.shape
    dev = vs.device
    n = _lengths(lengths, dev)
    t = torch.as_tensor(np.asarray(times, np.float32), device=dev)
    songs = range(B) if songs is None else songs
    valid = torch.arange(npad, device=dev)[None] < n[:, None]
    t0 = t[:, 0]
    tend = torch.gather(t, 1, torch.clamp_min(n - 1, 0)[:, None])[:, 0]
    fs_ = torch.clamp_min((tend - t0) / torch.clamp_min(n - 1, 1), 1e-4)
    nmeet = torch.clamp(torch.round(tend / fs_).to(torch.int64), 1, meet_pad)
    q = torch.arange(meet_pad, device=dev)
    tg = (q.to(torch.float32)[None] + 0.5) * fs_[:, None]
    beat = torch.clamp(torch.searchsorted(t.contiguous(), tg.contiguous(),
                                          right=True) - 1, 0, npad - 1)
    ok = (tg >= t0[:, None]) & (tg < tend[:, None]) \
        & (q[None] < nmeet[:, None])
    ok2 = ok[:, :, None] & ok[:, None, :]

    meet = torch.zeros((B, meet_pad, meet_pad), dtype=torch.float32,
                       device=dev)
    for level, k in enumerate(range(2, neigs + 1), 1):
        u = kmeans_uniforms(seed, songs, k, n_init).to(dev)
        lab = _kmeans_labels(vs[..., :k].contiguous(), valid, k, u, iters)
        slab = torch.gather(lab, 1, beat)
        same = (slab[:, :, None] == slab[:, None, :]) & ok2
        meet = torch.where(same, float(level), meet)
    return meet, nmeet


def svd_curve(meet: torch.Tensor, neigs: int) -> torch.Tensor:
    """The SVD curve of each meet matrix: its first `neigs` left singular
    vectors scaled by the singular values over the largest,
    (B, meet_pad, neigs).

    The meet matrix has large degenerate singular subspaces; the JAX
    package measured and rejected a randomized top-k SVD for them (their
    arbitrary rotations corrupt the curve), so this is the full SVD."""
    U, s, _ = torch.linalg.svd(meet, full_matrices=False)
    s = s[:, :neigs]
    return U[..., :neigs] * (s / torch.clamp_min(s[:, :1], 1e-12))[:, None,
                                                                   :]


def laplacian_profile_batch(W: torch.Tensor, lengths, times, neigs: int,
                            meet_pad: int, songs=None, seed: int = 0,
                            evec_smooth: int = 9, n_init: int = 50,
                            iters: int = 60):
    """StrucLaplacian's structure stage for a chunk: fused W -> random-walk
    Laplacian eigenvectors -> median-filtered spectral k-means at
    k = 2..neigs -> hierarchy meet matrix -> SVD curve.

    Parity: `StrucLaplacian.py:120-140` + `Laplacian.py:80-127` with the
    `laplacian.meet_matrix` semantics: the meet value of sample frames i,
    j is the deepest level at which their beats' cluster labels agree;
    sample q sits at t = (q + 0.5) * frame_size with frame_size =
    max(mean beat interval, 1e-4), and samples outside [times[0],
    times[n-1]) carry no label.

    Args:
      W: (B, npad, npad) fused affinities (the padding may be dirty).
      lengths: (B,) beat counts: each song's valid rows of W, which must
        all have a beat time.
      times: (B, npad) float32 beat times, padded with a large value.
      meet_pad: the meet grid's capacity (>= every song's nmeet).
      songs: (B,) song ids that seed the k-means draws
        (`kmeans_uniforms`); default 0..B-1.
    Returns (X (B, meet_pad, neigs) SVD curves, nmeet (B,) int64).
    """
    with cuda_tf32(False):
        vs = spectral_features(W, lengths, neigs, evec_smooth)
        meet, nmeet = meet_matrices(vs, lengths, times, neigs, meet_pad,
                                    songs, seed, n_init, iters)
        return svd_curve(meet, neigs), nmeet
