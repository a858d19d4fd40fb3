"""Onset novelty functions and dynamic-programming beat tracking (port of
`acoss_tpu.features.onsets`).

`onset_strength`, the superflux-style novelty (mel spectrogram -> dB ->
frequency max-filter -> positive first difference -> mean over bands), runs
in PyTorch on the signal's device. The tempo estimate reads the port's
tempogram on the device; the Ellis dynamic program of `beat_track_dp` is a
host numpy copy of the JAX package's, as are `estimate_tempo`'s prior and
`madmom_features_substitute`'s dict (the reference's madmom RNN+DBN
tracker has no pretrained-model equivalent; the DP tracker is the JAX
package's documented substitution).
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.features.rhythm import tempogram
from acoss_tpu_torch.features.spectral import as_signal, mel_filterbank, stft
from acoss_tpu_torch.ops.crp import cuda_tf32


def mel_db(y: torch.Tensor, sr: int = 44100, n_fft: int = 2048,
           hop_length: int = 512, n_mels: int = 128) -> torch.Tensor:
    """(n_frames, n_mels) slaney-mel power spectrogram in dB, floored at
    its maximum less 80 dB."""
    S = torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length))
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, htk=False,
                                         norm="slaney")).to(y.device)
    with cuda_tf32(False):
        mel = (S * S) @ fb.T
    db = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
    return torch.maximum(db, torch.max(db) - 80.0)


def flux(db: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         max_size: int = 3, lag: int = 1) -> torch.Tensor:
    """The onset envelope of a mel dB spectrogram (n_frames, n_mels):
    (n_frames,) float32."""
    ref = db
    if max_size > 1:
        # scipy's maximum_filter1d(mode='reflect') along the bands: the
        # reflected samples repeat in-window values, so it is the max over
        # the clipped window, which max_pool1d's -inf padding gives
        ref = torch.nn.functional.max_pool1d(
            db[None], max_size, stride=1, padding=max_size // 2)[0]
    env = torch.mean(torch.clamp_min(db[lag:] - ref[:-lag], 0.0), dim=1)
    # librosa compensates the lag + centering offset: pad at the front
    pad = lag + n_fft // (2 * hop_length)
    return torch.cat([env.new_zeros(pad), env])[:db.shape[0]]


def onset_strength(y, sr: int = 44100, n_fft: int = 2048,
                   hop_length: int = 512, n_mels: int = 128,
                   max_size: int = 3, lag: int = 1,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Superflux-style onset envelope, one value per hop frame
    (`features.py:66-77`), computed on `device`."""
    db = mel_db(as_signal(y, device), sr, n_fft, hop_length, n_mels)
    return flux(db, n_fft, hop_length, max_size, lag).cpu().numpy()


def estimate_tempo(oenv: np.ndarray, sr: int = 44100,
                   hop_length: int = 512, start_bpm: float = 120.0,
                   std_bpm: float = 1.0,
                   device: str | torch.device = "cuda") -> float:
    """Global tempo from the mean tempogram, log-normal prior around
    start_bpm (librosa.beat.tempo semantics)."""
    tg = tempogram(oenv, device=device).mean(axis=1)       # (win,)
    win = len(tg)
    frame_rate = sr / hop_length
    bpms = 60.0 * frame_rate / np.maximum(np.arange(win), 1e-9)
    bpms[0] = np.inf
    prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm))
                           / std_bpm) ** 2)
    best = int(np.argmax(tg * prior))
    return float(60.0 * frame_rate / max(best, 1))


def beat_track_dp(oenv: np.ndarray, sr: int = 44100, hop_length: int = 512,
                  start_bpm: float = 120.0, tightness: float = 100.0,
                  device: str | torch.device = "cuda"
                  ) -> tuple[float, np.ndarray]:
    """Ellis dynamic-programming beat tracker.

    Returns (tempo_bpm, beat frame indices in hop units).
    """
    oenv = np.asarray(oenv, dtype=np.float64).ravel()
    if oenv.size < 4 or oenv.max() <= 0:
        return 0.0, np.zeros(0, dtype=np.int64)
    tempo = estimate_tempo(oenv, sr, hop_length, start_bpm, device=device)
    period = max(int(round(60.0 * sr / (hop_length * tempo))), 1)
    # normalize envelope
    env = oenv / oenv.std() if oenv.std() > 0 else oenv
    n = env.size
    backlink = np.full(n, -1, dtype=np.int64)
    cumscore = env.copy()
    prange = np.arange(-2 * period, -period // 2)
    txcost = -tightness * (np.log(-prange / period) ** 2)
    for i in range(n):
        lo = i + prange[0]
        cand = lo + np.arange(len(prange))
        ok = cand >= 0
        if not ok.any():
            continue
        scores = np.where(ok, txcost + np.where(ok, cumscore[np.clip(
            cand, 0, n - 1)], -np.inf), -np.inf)
        best = int(np.argmax(scores))
        if scores[best] > 0:
            cumscore[i] += scores[best]
            backlink[i] = cand[best]
    # backtrace from the best ending in the last period
    tail = cumscore[max(n - period, 0):]
    end = int(np.argmax(tail)) + max(n - period, 0)
    beats = [end]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1], dtype=np.int64)
    return tempo, beats


def madmom_features_substitute(y, sr: int = 44100, hop_length: int = 512,
                               device: str | torch.device = "cuda") -> dict:
    """The `madmom_features` dict of the reference's h5 schema
    (`extractors.py:43-53`), computed with the superflux envelope + DP
    tracker substitution: {'tempos', 'onsets', 'novfn', 'snovfn'}. Both
    envelopes read one mel spectrogram."""
    db = mel_db(as_signal(y, device), sr, hop_length=hop_length)
    snovfn = flux(db, hop_length=hop_length, max_size=3).cpu().numpy()
    novfn = flux(db, hop_length=hop_length, max_size=1).cpu().numpy()
    tempo, onsets = beat_track_dp(snovfn, sr, hop_length, device=device)
    return {
        "tempos": np.array([[tempo, 1.0]], dtype=np.float64),
        "onsets": onsets,
        "novfn": novfn.astype(np.float32),
        "snovfn": snovfn.astype(np.float32),
    }
