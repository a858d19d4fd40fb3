"""Spectral primitives: framing, STFT, mel filterbank, DCT (port of
`acoss_tpu.features.spectral`).

The filterbanks and frame counts are numpy copies of the JAX package's;
framing and the STFT are PyTorch on the signal's device. The JAX package
pads every waveform to a multiple of 2^21 samples to bound its compiles
and crops the frames afterwards; the port computes the song's frames
only, which is exact because every framing pads with zeros.
"""

from __future__ import annotations

import numpy as np
import torch


def hz_to_mel(f, htk: bool = True):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk: bool = True):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = True,
                   norm: str | None = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular mel filterbank."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - c, 1e-9)
        fb[m] = np.maximum(0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def dct_matrix(n_out: int, n_in: int, ortho: bool = True,
               htk: bool = False) -> np.ndarray:
    """DCT-II matrix (n_out, n_in).

    `ortho` is the orthonormal scaling (librosa.filters.dct: row 0 =
    1/sqrt(N), rows >= 1 scaled sqrt(2/N)). `htk=True` is the HTK book's
    convention (eq. 5.11): UNIFORM sqrt(2/N) on every row including C0 —
    what essentia's 'MFCC the HTK way' recipe computes
    (`features.py:461` dctType=3); C0 is sqrt(2) larger than ortho's."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    M = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    if htk:
        M *= np.sqrt(2.0 / n_in)
    elif ortho:
        M *= np.sqrt(2.0 / n_in)
        M[0] *= 1.0 / np.sqrt(2.0)
    return M.astype(np.float32)


def n_frames_centered(L: int, hop_length: int) -> int:
    return 1 + L // hop_length


def n_frames_uncentered(L: int, frame_length: int, hop_length: int) -> int:
    return max(1 + (L - frame_length) // hop_length, 0)


def window(name: str, win_length: int) -> np.ndarray:
    """The analysis windows of the STFT, float64: a periodic Hann (as
    librosa), essentia's 62 dB Blackman-Harris (HPCP frames) or ones."""
    if name == "hann":
        return np.hanning(win_length + 1)[:-1]
    if name == "blackmanharris62":
        n = np.arange(win_length) / win_length
        return (0.44959 - 0.49364 * np.cos(2 * np.pi * n)
                + 0.05677 * np.cos(4 * np.pi * n))
    if name == "ones":
        return np.ones(win_length)
    raise ValueError(name)


def as_signal(y, device: str | torch.device) -> torch.Tensor:
    """A waveform (numpy or tensor) as a 1-D float32 tensor on `device`."""
    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.ascontiguousarray(y, dtype=np.float32))
    return y.reshape(-1).to(device=device, dtype=torch.float32)


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(T,) -> (n_frames, frame_length), a strided view of y (of its
    zero-padded copy when `center`)."""
    if center:
        y = torch.nn.functional.pad(y, (frame_length // 2,
                                        frame_length // 2))
    if y.shape[0] < frame_length:
        return y.new_zeros((0, frame_length))
    return y.unfold(0, frame_length, hop_length)


def frame_chunks(frames: torch.Tensor, chunk: int):
    """Consecutive `chunk`-frame slices of a frame view, so that a long
    transform's intermediates stay `chunk` frames deep."""
    for at in range(0, frames.shape[0], chunk):
        yield frames[at:at + chunk]


def stft(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         win_length: int | None = None, center: bool = True,
         window_name: str = "hann") -> torch.Tensor:
    """Complex STFT of a 1-D tensor, (n_frames, n_fft // 2 + 1)."""
    win_length = win_length or n_fft
    w = window(window_name, win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
        frames = frame_signal(y, n_fft, hop_length, center)
    else:
        frames = frame_signal(y, win_length, hop_length, center)
    if frames.shape[0] == 0:        # shorter than one frame
        return torch.zeros((0, n_fft // 2 + 1), dtype=torch.complex64,
                           device=y.device)
    w = torch.from_numpy(w.astype(np.float32)).to(y.device)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1)


def magnitude_spectrogram(y: torch.Tensor, n_fft: int = 2048,
                          hop_length: int = 512, power: float = 1.0,
                          **kw) -> torch.Tensor:
    S = torch.abs(stft(y, n_fft, hop_length, **kw))
    return S if power == 1.0 else S ** power
