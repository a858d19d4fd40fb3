"""Segment aggregation helpers (port of `acoss_tpu.ops.segment`).

Serra09 downsamples each song's chroma (median) and MFCC (mean) by x40
before any pair is scored (the reference's `librosa.util.sync` over
`np.arange(0, L, fac)`): `uniform_downsample_batch` groups songs by padded
length and aggregates them in a few batched calls on `device`.

`fix_frames`, `sync_agg` (beat-synchronous aggregation, FTM2D),
`uniform_downsample` (one song, the shape-DNA study) and `stack_memory`
(ChenFusion's delay embedding) are host numpy, copies of the JAX
package's functions: they run once per song on ragged data.
"""

from __future__ import annotations

import numpy as np
import torch


def fix_frames(boundaries: np.ndarray, length: int) -> np.ndarray:
    """Augment boundary frames with 0 and `length`, clip, unique."""
    b = np.concatenate([[0], np.asarray(boundaries).ravel(), [length]])
    b = np.clip(b, 0, length)
    return np.unique(b).astype(np.int64)


def sync_agg(X: np.ndarray, boundaries: np.ndarray,
             aggregate: str = "median") -> np.ndarray:
    """Aggregate frames of X (L, d) between consecutive boundaries (the
    semantics of `librosa.util.sync`). Returns (n_segments, d) float64,
    n_segments = len(fix_frames) - 1."""
    L = X.shape[0]
    b = fix_frames(boundaries, L)
    if aggregate == "mean":
        sums = np.add.reduceat(np.asarray(X, np.float64), b[:-1], axis=0)
        counts = np.diff(b)
        return sums / counts[:, None]
    # a per-segment loop: a vectorised grouped median (one lexsort per
    # dimension) measured 2x slower at ~600 beat segments x 12-23 dims
    out = np.empty((len(b) - 1, X.shape[1]), dtype=np.float64)
    for k in range(len(b) - 1):
        out[k] = np.median(X[b[k]:b[k + 1]], axis=0)
    return out


def _uniform_median(X: np.ndarray, fac: int) -> np.ndarray:
    """Median over fixed windows of `fac` frames (+ remainder window) --
    the reshape fast path of `uniform_downsample`."""
    L, d = X.shape
    nfull = L // fac
    out_full = np.median(
        X[:nfull * fac].reshape(nfull, fac, d), axis=1)
    if L % fac:
        rem = np.median(X[nfull * fac:], axis=0, keepdims=True)
        return np.concatenate([out_full, rem], axis=0)
    return out_full


def uniform_downsample(X: np.ndarray, fac: int,
                       aggregate: str = "median") -> np.ndarray:
    """Downsample one song's (L, d) frames by aggregating windows of `fac`
    frames on the host -- the reference's `librosa.util.sync(X.T,
    np.arange(0, L, fac), ...)` (`Serra09.py:104`). The shape-DNA study
    calls it once a song; the sweeps use `uniform_downsample_batch`."""
    if aggregate == "median":
        return _uniform_median(np.asarray(X), fac)
    return sync_agg(X, np.arange(0, X.shape[0], fac), aggregate)


def stack_memory(X: np.ndarray, n_steps: int, delay: int = 1) -> np.ndarray:
    """History (delay) embedding with zero padding, frames-first: X (t, d)
    -> (t, d * n_steps), column block k is X delayed by k * delay frames
    (zeros shifted in at the start), the block-major layout
    `crp.get_csm_blocked_oti` expects. n_steps=1 is the identity (the
    reference's literal ChenFusion call)."""
    t, d = X.shape
    blocks = []
    for k in range(n_steps):
        s = k * delay
        blk = np.zeros_like(X)
        if s < t:
            blk[s:] = X[:t - s]
        blocks.append(blk)
    return np.concatenate(blocks, axis=1)


def _down_batch(X: torch.Tensor, lengths: torch.Tensor, fac: int,
                agg: str) -> torch.Tensor:
    """Windowed aggregation of a (B, Lp, d) batch; Lp is a multiple of
    `fac` and `lengths` holds each song's valid frame count.

    median: invalid positions arrive pre-filled with +inf, so the valid
    values of every window sort first and the median is 0.5 * (lo + hi)
    of the two middle valid values (not `torch.median`, which returns the
    lower one). mean: invalid positions are zero and the window sum is
    divided by the valid count (float32 sums in another order than
    XLA's, so means agree with the JAX package to rounding, not bits).
    """
    B, Lp, d = X.shape
    nseg = Lp // fac
    W = X.reshape(B, nseg, fac, d)
    k = torch.arange(nseg, device=X.device)[None, :]
    c = torch.clamp(lengths[:, None] - k * fac, 0, fac)     # (B, nseg)
    cc = torch.clamp_min(c, 1)
    if agg == "mean":
        return torch.sum(W, dim=2) / cc[..., None].to(X.dtype)
    srt = torch.sort(W, dim=2).values
    lo = torch.gather(srt, 2, ((cc - 1) // 2)[:, :, None, None]
                      .expand(B, nseg, 1, d))[:, :, 0]
    hi = torch.gather(srt, 2, (cc // 2)[:, :, None, None]
                      .expand(B, nseg, 1, d))[:, :, 0]
    return 0.5 * (lo + hi)


def uniform_downsample_batch(arrays: list, fac: int,
                             aggregate: str = "median",
                             device: str | torch.device = "cuda",
                             bucket: int = 4096,
                             batch_size: int = 16) -> list:
    """Downsample each (L_i, d) array by windows of `fac` frames (the last
    window may be short). Returns per-song (ceil(L_i / fac), d) float32
    numpy arrays in input order. NaN/inf inputs are zeroed first."""
    if aggregate not in ("median", "mean"):
        raise ValueError(f"unknown aggregate {aggregate!r}")
    by_shape: dict = {}
    for i, a in enumerate(arrays):
        L = a.shape[0]
        Lp = max(-(-L // bucket) * bucket, bucket)
        by_shape.setdefault((Lp, a.shape[1]), []).append(i)

    fill = np.inf if aggregate == "median" else 0.0
    out = [None] * len(arrays)
    for (Lp, d), idxs in sorted(by_shape.items()):
        for lo_ in range(0, len(idxs), batch_size):
            chunk = idxs[lo_:lo_ + batch_size]
            X = np.full((len(chunk), -(-Lp // fac) * fac, d), fill,
                        np.float32)
            lens = np.zeros(len(chunk), np.int64)
            for b, i in enumerate(chunk):
                a = np.nan_to_num(np.asarray(arrays[i], np.float32),
                                  nan=0.0, posinf=0.0, neginf=0.0)
                X[b, :a.shape[0]] = a
                lens[b] = a.shape[0]
            Y = _down_batch(torch.from_numpy(X).to(device),
                            torch.from_numpy(lens).to(device), fac,
                            aggregate).cpu().numpy()
            for b, i in enumerate(chunk):
                out[i] = Y[b, :-(-int(lens[b]) // fac)]
    return out
