"""FTM2D: 2D Fourier Transform Magnitude shingles (port of
`acoss_tpu.benchmarking.algorithms.ftm2d`, after the reference's
`FTM2D.py:51-130`).

- per song (host numpy, the JAX package's code): beat-synchronous median
  chroma -> chrompwr(PWR=1.96) -> every 12 x 75 2D-FFT magnitude patch ->
  per-patch L2 norm and log(C x + 1) -> median patch -> unit norm;
- every pair at once (`full_scores`): the descriptor has a fixed size
  (900,), so the N x N sweep is ONE fp32 Gram on the device,
  exp(-||s_i - s_j||^2).

Ablations of the reference, as toggles:
  do_log=False           -> FTM2D_noLog.py
  do_norm=False          -> FTM2D_noNorm.py
  both False             -> FTM2D_noNormNoLog.py
  mode="zeropad"         -> FTM2D_zeroPad.py (the whole beat-chroma
                            zero-padded to 12 x PAD_LEN, ONE global fft2,
                            unit norm)
  mode="zeropad", do_log -> FTM2D_zeroPadLog.py (log(x + 1) after the norm)
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.ops.crp import chrompwr_np, gram_sqdist
from acoss_tpu_torch.ops.segment import sync_agg


def fft2_mag_patches(btchroma: np.ndarray, win: int) -> np.ndarray:
    """All fftshifted 2D-FFT magnitude patches of a (12, n_beats) matrix,
    one fft2 over the stacked (n_patches, 12, win) sliding windows.
    Returns (n_patches, 12 * win) float32."""
    nchr, nbeats = btchroma.shape
    n_patches = nbeats - win + 1
    if n_patches <= 0:
        return np.zeros((0, nchr * win), dtype=np.float32)
    idx = np.arange(win)[None, :] + np.arange(n_patches)[:, None]
    patches = np.swapaxes(btchroma.T[idx], 1, 2)      # (P, 12, win)
    F = np.abs(np.fft.fft2(patches, axes=(-2, -1)))
    F = np.fft.fftshift(F, axes=(-2, -1))
    return F.reshape(n_patches, nchr * win).astype(np.float32)


class FTM2D(CoverAlgorithm):
    NAME = "FTM2D"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True

    def __init__(self, chroma_type: str = "hpcp", PWR: float = 1.96,
                 WIN: int = 75, C: float = 5.0, do_log: bool = True,
                 do_norm: bool = True, mode: str = "median",
                 PAD_LEN: int = 2000):
        assert mode in ("median", "zeropad")
        self.chroma_type = chroma_type
        self.PWR = PWR
        self.WIN = WIN
        self.C = C
        self.do_log = do_log
        self.do_norm = do_norm
        self.mode = mode
        self.PAD_LEN = PAD_LEN

    def _dim(self) -> int:
        return 12 * (self.PAD_LEN if self.mode == "zeropad" else self.WIN)

    def _shingle_zeropad(self, bt: np.ndarray) -> np.ndarray:
        """Zero-pad the whole beat-chroma to 12 x PAD_LEN, one global 2D
        FFT magnitude, unit norm (and optionally log(x + 1))."""
        pad = np.zeros((12, self.PAD_LEN), dtype=np.float64)
        bt = bt[:, :self.PAD_LEN]
        pad[:, :bt.shape[1]] = bt
        flat = np.abs(np.fft.fft2(pad)).flatten()
        n = np.sqrt(np.sum(flat ** 2))
        s = flat / (n if n > 0 else 1.0)
        if self.do_log:
            s = np.log(s + 1)
        return s.astype(np.float32)

    def shingle(self, chroma: np.ndarray, onsets: np.ndarray) -> np.ndarray:
        """One song's shingle from its (L, 12) chroma and beat frames; all
        zeros when the song has no more beats than WIN."""
        if onsets.size <= self.WIN:
            return np.zeros(self._dim(), dtype=np.float32)
        bt = sync_agg(chroma, onsets, "median").T      # (12, n_seg)
        return self.shingle_from_bt(bt)

    def shingle_from_bt(self, bt: np.ndarray) -> np.ndarray:
        """Shingle from an already beat-synced (12, n_beats) chroma."""
        bt = chrompwr_np(bt, self.PWR, axis=0)
        if self.mode == "zeropad":
            return self._shingle_zeropad(bt)
        sh = fft2_mag_patches(bt, self.WIN)            # (P, 900)
        if sh.shape[0] == 0:
            return np.zeros(self._dim(), dtype=np.float32)
        if self.do_norm:
            norm = np.linalg.norm(sh, axis=1)
            norm[norm == 0] = 1
            sh = sh / norm[:, None]
        if self.do_log:
            sh = np.log(self.C * sh + 1)
        s = np.median(sh, axis=0)
        n = np.sqrt(np.sum(s ** 2))
        if n > 0:
            s = s / n
        return s.astype(np.float32)

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """{"shingle": (N, 12 * WIN or 12 * PAD_LEN) float32} on the host
        (the sweep uploads it to `device`)."""
        chroma = fs.feature(self.chroma_type)
        clen = fs.length(self.chroma_type)
        onsets = fs.feature("onsets")
        olen = fs.length("onsets")
        shingles = np.stack([
            self.shingle(chroma[i, :clen[i]], onsets[i, :olen[i], 0])
            for i in range(fs.n_songs)
        ])
        return {"shingle": shingles}

    def full_scores(self, desc: dict) -> dict:
        """exp(-||s_i - s_j||^2) of every pair, from the fp32 shingles on
        the device: (N, N)."""
        return {"main": torch.exp(-gram_sqdist(desc["shingle"]))}
