"""Uniform downsampling of a batch of songs in plain PyTorch: a frozen copy
of `acoss_tpu_torch.ops.segment.uniform_downsample_batch`, so that the
benchmark's reference does not move with the program.

Serra09 downsamples each song's chroma (median) and MFCC (mean) by x40
before any pair is scored (the reference's `librosa.util.sync` over
`np.arange(0, L, fac)`).
"""

from __future__ import annotations

import numpy as np
import torch


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
