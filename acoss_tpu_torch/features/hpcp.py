"""Harmonic Pitch Class Profiles (Gomez 2006), port of
`acoss_tpu.features.hpcp`.

Per frame: spectral peaks (interpolated local maxima, 100-3500 Hz, top
`max_peaks`), spectral whitening, and harmonic weighting of each peak into
`n_bins` pitch classes with a cos^2 window (the reference's essentia HPCP,
`preprocess/features.py:209-275`). All in PyTorch on the signal's
device, vectorized over frames. The whitening's Gaussian smoothing is an
explicit banded sum in a fixed order, not a cuDNN convolution (TF32 and
not order-fixed by default), and the harmonic weighting runs a chunk of
frames at a time so its (frames, peaks, harmonics, bins) intermediate
stays bounded.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.features.spectral import as_signal, stft

#: frames a chunk of the harmonic weighting (its (chunk, 100, 8, 12)
#: fp32 intermediate is 157 MB)
HARMONIC_CHUNK = 4096


def _whitening_envelope(S: torch.Tensor, sr: int,
                        frame_size: int) -> torch.Tensor:
    """The Gaussian-smoothed spectrum (width ~1/3 octave at 1 kHz) of S
    (T, F), edge-padded: sum_j kern[j] * S[:, f + j - radius]."""
    sigma = max(frame_size / sr * 90.0, 3.0)    # bins
    radius = int(3 * sigma)
    kern = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    kern = (kern / kern.sum()).astype(np.float32)
    F = S.shape[1]
    Sp = torch.cat([S[:, :1].expand(-1, radius), S,
                    S[:, -1:].expand(-1, radius)], dim=1)
    env = torch.zeros_like(S)
    for j, c in enumerate(kern.tolist()):
        env += c * Sp[:, j:j + F]
    return env


def _harmonic_weighting(top_mag: torch.Tensor, top_freq: torch.Tensor,
                        ref_freq: float, n_bins: int, harmonics: int,
                        window_size: float) -> torch.Tensor:
    """(T, P) peak magnitudes and frequencies -> (T, n_bins) HPCP."""
    dev = top_mag.device
    hs = np.arange(1, harmonics + 1)
    hweights = torch.from_numpy((0.6 ** (hs - 1)).astype(np.float32)).to(dev)
    # pitch class (in bins) of each peak's h-th subharmonic; bin 0 is C
    # (essentia's bin 0 is A440), as in the chroma family
    ref = torch.from_numpy((ref_freq * hs).astype(np.float32)).to(dev)
    ratio = top_freq[:, :, None] / ref
    a_offset = 9.0 * n_bins / 12.0
    pc = torch.remainder(n_bins * torch.log2(torch.clamp_min(ratio, 1e-9))
                         + a_offset, n_bins)
    # cos^2 window of +-window_size semitones around each bin center
    bins = torch.arange(n_bins, dtype=torch.float32, device=dev)
    d = torch.abs(pc[..., None] - bins)                   # (T, P, H, B)
    d = torch.minimum(d, n_bins - d)
    semi = d * (12.0 / n_bins)
    w = torch.where(semi <= window_size,
                    torch.cos(torch.pi / 2 * semi / window_size) ** 2, 0.0)
    contrib = (top_mag[:, :, None, None] ** 2) \
        * hweights[None, None, :, None] * w
    return torch.sum(contrib, dim=(1, 2))                 # (T, B)


def hpcp(y, sr: int = 44100, frame_size: int = 4096,
         hop_length: int = 512, min_freq: float = 100.0,
         max_freq: float = 3500.0, ref_freq: float = 440.0,
         max_peaks: int = 100, n_bins: int = 12, harmonics: int = 8,
         window_size: float = 1.0, whitening: bool = True,
         device: str | torch.device = "cuda") -> np.ndarray:
    """(n_frames, n_bins) HPCP, unit-max a frame, computed on `device` —
    the reference's default feature profile entry (`extractors.py:22-29`);
    frames are not centred."""
    y = as_signal(y, device)
    S = torch.abs(stft(y, n_fft=frame_size, hop_length=hop_length,
                       window_name="blackmanharris62", center=False))
    if S.shape[0] == 0:             # shorter than one frame
        return np.zeros((0, n_bins), np.float32)
    F = S.shape[1]
    freqs = torch.from_numpy(np.linspace(0, sr / 2, frame_size // 2 + 1)
                             .astype(np.float32)).to(S.device)
    # spectral peaks: interior local maxima in [min_freq, max_freq]
    left = torch.nn.functional.pad(S[:, :-1], (1, 0))
    right = torch.nn.functional.pad(S[:, 1:], (0, 1))
    is_peak = (S > left) & (S >= right) & (freqs >= min_freq) \
        & (freqs <= max_freq)
    # parabolic interpolation around each bin
    denom = left - 2 * S + right
    delta = torch.where(torch.abs(denom) > 1e-12,
                        0.5 * (left - right) / denom, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    pk_freq = (torch.arange(F, device=S.device) + delta) * (sr / frame_size)
    pk_mag = S - 0.25 * (left - right) * delta
    if whitening:
        # spectral-envelope compensation with a relative floor, so the
        # noise floor is not boosted (essentia's band-preset whitening
        # differs in detail; a MAP-level substitution)
        floor = 1e-3 * torch.amax(S, dim=1, keepdim=True)
        pk_mag = pk_mag / torch.maximum(
            _whitening_envelope(S, sr, frame_size), floor + 1e-12)
    del S, left, right, denom, delta
    masked = torch.where(is_peak, pk_mag, -torch.inf)
    top_mag, top_idx = torch.topk(masked, max_peaks, dim=1)
    top_freq = torch.gather(pk_freq, 1, top_idx)
    valid = torch.isfinite(top_mag) & (top_mag > 0)
    top_mag = torch.where(valid, top_mag, 0.0)
    top_freq = torch.where(valid, top_freq, ref_freq)
    out = torch.cat([_harmonic_weighting(
        top_mag[t:t + HARMONIC_CHUNK], top_freq[t:t + HARMONIC_CHUNK],
        ref_freq, n_bins, harmonics, window_size)
        for t in range(0, top_mag.shape[0], HARMONIC_CHUNK)])
    peak = torch.amax(out, dim=1, keepdim=True)
    return (out / torch.where(peak == 0, 1.0, peak)).cpu().numpy()
