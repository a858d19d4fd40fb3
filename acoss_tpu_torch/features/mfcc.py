"""MFCCs, HTK-style (essentia parity) and librosa-style; port of
`acoss_tpu.features.mfcc`, in PyTorch on the signal's device.

- `mfcc_htk` (`preprocess/features.py:418-470`): Hamming window of
  22050 samples zero-padded to the next pow2 FFT, htkMel warping, 26
  triangular bands with unit-max normalization built in the Hz domain,
  log magnitudes, DCT, HTK sinusoidal liftering (CEPLIFTER=22), frames
  NOT centered (startFromZero). Returns (n_mfcc, n_frames).
- `mfcc_librosa` (`features.py:472-503`): slaney mel on
  amplitude-to-db, ortho DCT, power liftering n^0.6.

The 32,768-point spectra of a whole song would take gigabytes, so the
frames go through the FFT and the filterbank a chunk at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.features.spectral import (as_signal, dct_matrix,
                                               frame_chunks, frame_signal,
                                               mel_filterbank)
from acoss_tpu_torch.ops.crp import cuda_tf32

#: frames a chunk of the long-window spectra (a 32,768-point rfft of
#: 2,048 frames is 268 MB complex64)
FRAME_CHUNK = 2048


def _hamming(n: int) -> np.ndarray:
    return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))


def mfcc_htk(y, sr: int = 44100, window_length: int = 22050,
             hop_length: int = 512, n_mfcc: int = 13, n_mels: int = 26,
             fmax: int = 8000, lifterexp: int = 22,
             device: str | torch.device = "cuda") -> np.ndarray:
    """(n_mfcc, n_frames) HTK-style MFCCs, computed on `device`."""
    y = as_signal(y, device)
    fftlen = int(2 ** np.ceil(np.log2(window_length)))
    frames = frame_signal(y, window_length, hop_length, center=False)
    w = torch.from_numpy(_hamming(window_length).astype(np.float32)) \
        .to(y.device)
    fb = torch.from_numpy(mel_filterbank(sr, fftlen, n_mels, 0.0, fmax,
                                         htk=True, norm=None)).to(y.device)
    # HTK DCT scaling: uniform sqrt(2/N) incl. C0 (HTK book eq. 5.11 /
    # essentia dctType=3), NOT the orthonormal row-0 correction
    D = torch.from_numpy(dct_matrix(n_mfcc, n_mels, htk=True)).to(y.device)
    out = []
    with cuda_tf32(False):
        for f in frame_chunks(frames, FRAME_CHUNK):
            spec = torch.abs(torch.fft.rfft(f * w, n=fftlen, dim=-1))
            mel = spec @ fb.T
            logmel = torch.log(torch.clamp_min(mel, 1e-8))  # HTK silence
            out.append(logmel @ D.T)
    cc = torch.cat(out) if out else y.new_zeros((0, n_mfcc))
    # HTK sinusoidal liftering: c_n *= 1 + (L/2) sin(pi n / L)
    n = torch.arange(n_mfcc, device=y.device)
    lift = 1.0 + (lifterexp / 2.0) * torch.sin(torch.pi * n / lifterexp)
    return (cc * lift).T.cpu().numpy()


def mfcc_librosa(y, sr: int = 44100, window_length: int = 22050,
                 hop_length: int = 512, n_mfcc: int = 20, n_mels: int = 40,
                 fmax: int = 8000, lifterexp: float = 0.6,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """(n_mfcc, n_frames) librosa-style MFCCs with power liftering,
    computed on `device` (frames centred)."""
    y = as_signal(y, device)
    fb = torch.from_numpy(mel_filterbank(sr, window_length, n_mels, 0.0,
                                         fmax, htk=False, norm="slaney")) \
        .to(y.device)
    win = torch.from_numpy(np.hanning(window_length + 1)[:-1]
                           .astype(np.float32)).to(y.device)
    frames = frame_signal(y, window_length, hop_length, center=True)
    out = []
    with cuda_tf32(False):
        for f in frame_chunks(frames, FRAME_CHUNK):
            S = torch.abs(torch.fft.rfft(f * win, n=window_length, dim=-1))
            out.append(S @ fb.T)
        X = torch.cat(out).T                         # (n_mels, n_frames)
        # librosa.amplitude_to_db DEFAULTS (`features.py:493` passes none):
        # ref=1.0 (NOT np.max), amin=1e-5, floored at max - top_db(80)
        db = 20.0 * torch.log10(torch.clamp_min(X, 1e-5))
        db = torch.maximum(db, torch.max(db) - 80.0)
        D = torch.from_numpy(dct_matrix(n_mfcc, n_mels, ortho=True)) \
            .to(y.device)
        cc = D @ db
    coeffs = torch.from_numpy(
        np.concatenate([[1.0], np.arange(1, n_mfcc) ** lifterexp])
        .astype(np.float32)).to(y.device)
    return (coeffs[:, None] * cc).cpu().numpy()
