"""Chroma features: STFT chroma, constant-Q chroma, CENS, processed chroma
(port of `acoss_tpu.features.chroma`). All return (n_frames, 12), as the
reference does (it transposes librosa's output).

`chroma_stft`, `cqt` and `chroma_cqt` run in PyTorch on the signal's
device. The CQT is the Brown-Puckette frequency-domain kernel method: one
constant filterbank product against the spectra of 32,768-sample frames.
The JAX package takes a full complex FFT of each frame and keeps its
first half; the port takes the real FFT, the same numbers, and runs the
frames through it a chunk at a time (a 300 s song's frames alone are
3.4 GB in fp32). The filterbanks (`chroma_filterbank`, `cqt_kernels`) and
the host stages of `cens_from_chroma`, `nn_filter` and
`chroma_cqt_processed` (whose librosa harmonic separation stays the JAX
package's scipy median-filter approximation) are numpy copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from acoss_tpu_torch.features.spectral import (as_signal, frame_chunks,
                                               frame_signal, stft)
from acoss_tpu_torch.ops.crp import cuda_tf32

#: frames a chunk of the CQT's 32,768-point spectra (268 MB complex64)
CQT_FRAME_CHUNK = 2048


def chroma_filterbank(sr: int, n_fft: int, n_chroma: int = 12,
                      tuning: float = 0.0) -> np.ndarray:
    """(n_chroma, n_fft//2+1) wrapped-Gaussian chroma filters
    (librosa.filters.chroma semantics with default octwidth=2,
    base_c=True)."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)[1:]
    frqbins = n_chroma * np.log2(freqs / (440.0 / 16))  # ref A0-ish
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate(
        (np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt(np.sum(wts ** 2, axis=0)), 1e-12)
    octwidth = 2
    ctroct = 5.0
    wts *= np.tile(
        np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
        (n_chroma, 1))
    # rotate so bin 0 = C
    wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return wts.astype(np.float32)


def chroma_stft(y, sr: int = 44100, n_fft: int = 4096,
                hop_length: int = 512,
                device: str | torch.device = "cuda") -> np.ndarray:
    """(n_frames, 12) — parity: `features.py:155-167` (norm=2,
    frameSize=4096, tuning=0), computed on `device`."""
    y = as_signal(y, device)
    S = torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length)) ** 2
    fb = torch.from_numpy(chroma_filterbank(sr, n_fft)).to(y.device)
    with cuda_tf32(False):
        raw = S @ fb.T                                 # (n_frames, 12)
    # the reference passes norm=2 (`features.py:162`): each frame
    # L2-normalized, not peak-normalized
    nrm = torch.sqrt(torch.sum(raw * raw, dim=-1, keepdim=True))
    return (raw / torch.where(nrm == 0, 1.0, nrm)).cpu().numpy()


# ------------------------------------------------------------- CQT -------


def cqt_kernels(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                n_fft: int, q_scale: float = 1.0):
    """Frequency-domain CQT kernels (n_bins, n_fft//2+1) complex64."""
    return _cqt_kernels(sr, fmin, n_bins, bins_per_octave, n_fft,
                        q_scale).copy()


@functools.lru_cache(maxsize=4)
def _cqt_kernels(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                 n_fft: int, q_scale: float = 1.0) -> np.ndarray:
    """`cqt_kernels`, built once per shape (84 host FFTs of 32,768
    points, ~0.1 s; the JAX package builds them once per compile). Its
    callers only read the array."""
    Q = q_scale / (2 ** (1.0 / bins_per_octave) - 1)
    K = np.zeros((n_bins, n_fft // 2 + 1), dtype=np.complex128)
    for k in range(n_bins):
        f = fmin * 2 ** (k / bins_per_octave)
        length = int(min(np.ceil(Q * sr / f), n_fft))
        n = np.arange(length) - length // 2
        win = np.hanning(length)
        kern = win * np.exp(2j * np.pi * f * n / sr) / length
        buf = np.zeros(n_fft, dtype=np.complex128)
        start = (n_fft - length) // 2
        buf[start:start + length] = kern
        spec = np.fft.fft(buf)[:n_fft // 2 + 1] / n_fft
        # sparsify tiny coefficients (Brown-Puckette)
        mag = np.abs(spec)
        spec[mag < 0.005 * mag.max()] = 0
        K[k] = np.conj(spec)
    return K.astype(np.complex64)


def cqt_tensor(y: torch.Tensor, sr: int = 44100, hop_length: int = 512,
               fmin: float = 32.7031956626, n_bins: int = 84,
               bins_per_octave: int = 12,
               n_fft: int = 32768) -> torch.Tensor:
    """Constant-Q magnitudes of a 1-D signal tensor, (n_frames, n_bins)
    float32 on its device."""
    frames = frame_signal(y, n_fft, hop_length, center=True)
    KT = torch.from_numpy(_cqt_kernels(sr, fmin, n_bins, bins_per_octave,
                                       n_fft)).to(y.device).T
    with cuda_tf32(False):
        C = [torch.fft.rfft(f, dim=-1) @ KT
             for f in frame_chunks(frames, CQT_FRAME_CHUNK)]
    return torch.abs(torch.cat(C)) * n_fft


def cqt(y, sr: int = 44100, hop_length: int = 512,
        fmin: float = 32.7031956626, n_bins: int = 84,
        bins_per_octave: int = 12, n_fft: int = 32768,
        device: str | torch.device = "cuda") -> np.ndarray:
    """Constant-Q magnitudes, (n_frames, n_bins), computed on `device`.

    Parity: `features.py:398-416` (librosa.cqt defaults: C1, 7 octaves).
    """
    return cqt_tensor(as_signal(y, device), sr, hop_length, fmin, n_bins,
                      bins_per_octave, n_fft).cpu().numpy()


def fold_chroma(C: torch.Tensor, n_octaves: int = 7) -> torch.Tensor:
    """(n_frames, 12 * n_octaves) CQT magnitudes -> their octaves summed,
    unit-max a frame: (n_frames, 12)."""
    folded = C.reshape(C.shape[0], n_octaves, 12).sum(dim=1)
    peak = torch.amax(folded, dim=-1, keepdim=True)
    return folded / torch.where(peak == 0, 1.0, peak)


def chroma_cqt(y, sr: int = 44100, hop_length: int = 512,
               n_chroma: int = 12, n_octaves: int = 7,
               fmin: float = 32.7031956626,
               device: str | torch.device = "cuda") -> np.ndarray:
    """(n_frames, 12) CQT chroma — parity: `features.py:169-178`."""
    C = cqt_tensor(as_signal(y, device), sr, hop_length, fmin,
                   n_octaves * 12, 12)
    return fold_chroma(C, n_octaves).cpu().numpy()


def cens_from_chroma(chroma: np.ndarray, win_len_smooth: int = 41
                     ) -> np.ndarray:
    """CENS post-processing of a chroma sequence (librosa semantics):
    L1 normalize, amplitude quantization, Hann smoothing, L2 normalize."""
    c = np.asarray(chroma, dtype=np.float64)
    l1 = np.sum(np.abs(c), axis=1, keepdims=True)
    c = c / np.where(l1 == 0, 1.0, l1)
    q = np.zeros_like(c)
    for thresh, value in zip([0.4, 0.2, 0.1, 0.05], [1.0, 0.75, 0.5, 0.25]):
        q = np.where((q == 0) & (c > thresh), value, q)
    win = np.hanning(win_len_smooth + 2)[1:-1]
    win /= win.sum()
    sm = np.apply_along_axis(
        lambda x: np.convolve(x, win, mode="same"), 0, q)
    l2 = np.sqrt(np.sum(sm ** 2, axis=1, keepdims=True))
    return (sm / np.where(l2 == 0, 1.0, l2)).astype(np.float32)


def chroma_cens(y, sr: int = 44100, hop_length: int = 512,
                device: str | torch.device = "cuda") -> np.ndarray:
    """(n_frames, 12) — parity: `features.py:180-190`."""
    return cens_from_chroma(chroma_cqt(y, sr, hop_length, device=device))


def nn_filter(X: np.ndarray, k: int = 10) -> np.ndarray:
    """Nearest-neighbor smoothing (librosa.decompose.nn_filter with cosine
    affinity): replace each frame by the MEDIAN of its k most similar
    frames — the reference passes aggregate=np.median
    (`features.py:202`), the outlier-rejecting point of the denoising
    step (used by `chroma_cqt_processed`, `features.py:192-207`)."""
    Xn = X / np.maximum(
        np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    sim = Xn @ Xn.T
    np.fill_diagonal(sim, -np.inf)
    idx = np.argsort(-sim, axis=1)[:, :k]
    return np.median(X[idx], axis=1)


def chroma_cqt_processed(y, sr: int = 44100, hop_length: int = 512,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """Harmonic-enhanced, NN-filtered, median-smoothed CQT chroma
    (`features.py:192-207`; librosa's harmonic separation is approximated
    by time-median filtering of the CQT before folding). The CQT runs on
    `device`, the rest on the host."""
    import scipy.ndimage
    C = cqt(y, sr, hop_length, device=device)
    # crude harmonic enhancement: median filter along time
    Ch = scipy.ndimage.median_filter(C, size=(9, 1))
    folded = Ch.reshape(Ch.shape[0], -1, 12).sum(axis=1)
    peak = folded.max(axis=-1, keepdims=True)
    folded = folded / np.where(peak == 0, 1.0, peak)
    sm = np.minimum(folded, nn_filter(folded))
    return scipy.ndimage.median_filter(sm, size=(9, 1)).astype(np.float32)
