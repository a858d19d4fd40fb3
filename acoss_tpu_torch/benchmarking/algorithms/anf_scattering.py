"""ANFScattering: 1D scattering of audio novelty functions (port of
`acoss_tpu.benchmarking.algorithms.anf_scattering`, after the reference's
`ANFScattering.py:10-67`).

- per song and novelty function (RNN, superflux), host numpy (the JAX
  package's code): polyphase-resampled to T = 2^14 samples, then (a)
  globally z-normalized and (b) cut into 16 segments, each z-normalized;
- on the device, in chunks of songs: (a) Scattering1D(J=6, T, Q=8), and
  (b) Scattering1D(J, T / 16, Q) of every segment, the median over the 16
  segments, unit norm (a shingle);
- every pair at once (`full_scores`): the plain Euclidean DISTANCE of the
  fixed-size descriptors from one fp32 Gram on the device (the channels
  are DISTANCE_TYPES: the evaluation negates them).
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.ops.crp import gram_sqdist
from acoss_tpu_torch.ops.scattering import Scattering1D

DOWNSAMPLE_FAC = 16

# songs per scattering call: bounds the complex first- and second-order
# working set (64 songs x 48 + 80 paths x 16,384 samples x 8 B ~ 1.1 GB
# at J=6, Q=8)
SCATTER_CHUNK = 64


def _median_segments(SC: torch.Tensor) -> torch.Tensor:
    """(n, DOWNSAMPLE_FAC, paths, t) -> (n, paths * t): the median over the
    segments, the mean of the two middle values (numpy's median; not
    `torch.median`, which returns the lower one)."""
    s = torch.sort(SC.reshape(SC.shape[0], DOWNSAMPLE_FAC, -1), dim=1).values
    return 0.5 * (s[:, (DOWNSAMPLE_FAC - 1) // 2]
                  + s[:, DOWNSAMPLE_FAC // 2])


def _chunked(scatter, X: np.ndarray, device, chunk: int,
             reduce=None) -> np.ndarray:
    """Apply a scattering instance over the leading axis of X in chunks of
    songs on `device`; `reduce(chunk_out)` runs on the device per chunk
    before the result comes back, so corpus-sized pre-reduction tensors
    never exist."""
    outs = []
    for lo in range(0, X.shape[0], chunk):
        out = scatter(torch.from_numpy(X[lo:lo + chunk]).to(device))
        outs.append((reduce(out) if reduce is not None else out)
                    .cpu().numpy())
    return np.concatenate(outs, axis=0)


class ANFScattering(CoverAlgorithm):
    NAME = "ANFScattering"
    SIMILARITY_TYPES = ("anfrnn", "anfrnn_shingle",
                        "anfsuperflux", "anfsuperflux_shingle")
    DISTANCE_TYPES = SIMILARITY_TYPES
    SYMMETRIC = True

    def __init__(self, J: int = 6, T: int = 2 ** 14, Q: int = 8):
        self.J = J
        self.T = T
        self.Q = Q
        self.S = Scattering1D(J, T, Q)
        self.S2 = Scattering1D(J, T // DOWNSAMPLE_FAC, Q)

    def _song_prep(self, novfn: np.ndarray):
        """Host prep: polyphase resample to exactly T samples, global
        z-norm vector + 16 per-segment z-normed windows (float32: the
        scattering casts its input to fp32)."""
        l = np.lcm(novfn.size, self.T)
        x = scipy.signal.resample_poly(
            novfn, int(l / novfn.size), int(l / self.T))
        y = x - np.mean(x)
        n = np.sqrt(np.sum(y ** 2))
        y = y / (n if n > 0 else 1.0)
        win = x.size // DOWNSAMPLE_FAC
        segs = x[:win * DOWNSAMPLE_FAC].reshape(DOWNSAMPLE_FAC, win)
        segs = segs - segs.mean(axis=1, keepdims=True)
        norms = np.sqrt(np.sum(segs ** 2, axis=1, keepdims=True))
        segs = segs / np.where(norms == 0, 1.0, norms)
        return y.astype(np.float32), segs.astype(np.float32)

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """Host numpy (N, n_coeffs * T / 2^J) descriptors of each channel;
        the scattering runs on `device`."""
        out = {}
        for name, key in (("novfn", "anfrnn"), ("snovfn", "anfsuperflux")):
            ln = fs.length(name)
            preps = [self._song_prep(fs.feature(name)[i, :ln[i], 0])
                     for i in range(fs.n_songs)]
            G = _chunked(self.S, np.stack([p[0] for p in preps]), device,
                         SCATTER_CHUNK)
            out[key] = np.ascontiguousarray(
                G.reshape(fs.n_songs, -1).astype(np.float32))
            sh = _chunked(self.S2, np.stack([p[1] for p in preps]), device,
                          SCATTER_CHUNK, reduce=_median_segments)
            norms = np.sqrt(np.sum(sh ** 2, axis=1, keepdims=True))
            sh = sh / np.where(norms == 0, 1.0, norms)
            out[f"{key}_shingle"] = sh.astype(np.float32)
        return out

    def full_scores(self, desc: dict,
                    device: str | torch.device = "cuda") -> dict:
        """Euclidean distances of every pair of each channel's fp32
        descriptors on the device: (N, N) each."""
        return {k: torch.sqrt(gram_sqdist(desc[k]))
                for k in self.SIMILARITY_TYPES}
