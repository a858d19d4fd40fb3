"""Simple (SiMPle): the similarity matrix profile of smoothed chroma (port
of `acoss_tpu.benchmarking.algorithms.simple`, after the reference's
`Simple.py:13-126`).

- per song (host numpy, the JAX package's code): chroma mean-pooled over
  windows of WIN=200 frames every SKIP=100, Hann-smoothed (length 6) and
  L2-normalized per frame, and its profile (the frames' sum);
- per pair (row song A, column song B): B's chroma rolled by the shift
  that best matches its profile to A's (OTI), the Euclidean CSM, its
  SSLEN=10 diagonal windows -- the squared distances between every
  subsequence of A and of B -- the matrix profile (each subsequence of A
  to its nearest of B), score = -median of the profile.

The score is ASYMMETRIC (the reference sweeps with symmetric=False), so
the sweep scores the full pair grid. A (bi x bj) tile does every pair in
batched calls; nothing here has a hand-written kernel (the JAX package
computes it all outside Pallas).
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.ops import crp


def _hann_norm(n: int) -> np.ndarray:
    w = np.hanning(n)  # == scipy get_window('hann', n, fftbins=False)
    return w / w.sum()


def masked_median(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median of the first `n` entries of each row of x (..., L), one n
    per row; entries past n must be +inf. A row with n == 0 gives its
    first entry."""
    s = torch.sort(x, dim=-1).values
    n = torch.clamp_min(n, 1)[..., None]
    lo = torch.gather(s, -1, (n - 1) // 2)
    hi = torch.gather(s, -1, n // 2)
    return (0.5 * (lo + hi))[..., 0]


class Simple(CoverAlgorithm):
    NAME = "Simple"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = False
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", SSLEN: int = 10,
                 WIN: int = 200, SKIP: int = 100,
                 pad_to_multiple: int = 64):
        self.chroma_type = chroma_type
        self.SSLEN = SSLEN
        self.WIN = WIN
        self.SKIP = SKIP
        self.pad_to_multiple = pad_to_multiple

    def _song_descriptor(self, chroma: np.ndarray) -> np.ndarray:
        """(L, 12) -> (L // SKIP, 12): mean pooling + Hann smoothing + L2
        column norm."""
        L = chroma.shape[0]
        n = L // self.SKIP
        feat = np.zeros((12, n))
        ct = chroma.T
        for i in range(n):
            feat[:, i] = np.mean(ct[:, i * self.SKIP:
                                    i * self.SKIP + self.WIN], axis=1)
        win = np.atleast_2d(_hann_norm(6))
        feat = scipy.signal.convolve2d(feat, win, mode="same",
                                       boundary="fill")
        norms = np.linalg.norm(feat, axis=0)
        norms[norms == 0] = 1
        return (feat / norms).T.astype(np.float32)

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """Host numpy: feat (N, L, 12), profile (N, 12), length (N,), L the
        longest descriptor (at least SSLEN + 1) rounded up to
        `pad_to_multiple`."""
        feats, profiles = [], []
        clen = fs.length(self.chroma_type)
        for i in range(fs.n_songs):
            d = self._song_descriptor(
                fs.feature(self.chroma_type)[i, :clen[i]])
            feats.append(d)
            profiles.append(d.sum(axis=0))
        Lmax = max(max(f.shape[0] for f in feats), self.SSLEN + 1)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        arr, lengths = pad_stack(feats, pad_to)
        return {
            "feat": arr,
            "profile": np.stack(profiles).astype(np.float32),
            "length": lengths.astype(np.int32),
        }

    def tile_scores(self, row: dict, col: dict) -> dict:
        """-median matrix profile of every (row song, column song) pair of
        the tile: {"main": (bi, bj)}."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        L = row["feat"].shape[1]
        # OTI variant: roll B's chroma axis by the best shift of its
        # profile against A's
        shift = torch.argmax(crp.get_all_shift_scores(
            col["profile"][None], row["profile"][:, None]), dim=-1)
        B = crp.transpose_chroma(
            col["feat"][None].expand(bi, bj, L, 12), shift)
        csm = crp.get_csm(row["feat"][:, None], B)         # (bi, bj, L, L)
        w = crp.sliding_csm_padded(csm, self.SSLEN)
        d2 = w * w                                   # subsequence sq-dists
        l1e = torch.clamp_min(row["length"] - self.SSLEN + 1, 0)
        l2e = torch.clamp_min(col["length"] - self.SSLEN + 1, 0)
        jj = torch.arange(L, device=d2.device)
        d2 = torch.where((jj < l2e[:, None])[None, :, None, :], d2,
                         torch.inf)
        mp = torch.amin(d2, dim=-1)                  # the matrix profile
        mp = torch.where((jj < l1e[:, None])[:, None, :], mp, torch.inf)
        med = masked_median(mp, l1e[:, None].expand(bi, bj))
        return {"main": -med}
