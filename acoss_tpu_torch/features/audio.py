"""Audio decode / resample utilities (numpy copy of
`acoss_tpu.features.audio`).

Replaces essentia's MonoLoader/EasyLoader/Resample
(`preprocess/features.py:36-64`): WAV via the stdlib,
other formats (mp3 etc.) through an ffmpeg subprocess when available
(gated — this image has no audio-codec Python packages). Resampling is
polyphase via scipy.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
import wave

import numpy as np
import scipy.signal


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Mono float32 samples + sample rate from a PCM WAV file."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        nch = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2 ** 31
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if nch > 1:
        x = x.reshape(-1, nch).mean(axis=1)
    return x, sr


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio_ffmpeg(path: str, sr: int = 44100) -> np.ndarray:
    """Decode any format to mono float32 at `sr` via ffmpeg."""
    cmd = ["ffmpeg", "-v", "quiet", "-i", path, "-f", "f32le",
           "-ac", "1", "-ar", str(sr), "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype=np.float32).copy()


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (`features.py:48-53` Resample equivalent)."""
    if sr_in == sr_out:
        return np.asarray(y, dtype=np.float32)
    g = np.gcd(sr_in, sr_out)
    return scipy.signal.resample_poly(
        y, sr_out // g, sr_in // g).astype(np.float32)


def load_audio(path: str, sr: int = 44100) -> np.ndarray:
    """Mono float32 at `sr` — the AudioFeatures constructor contract
    (`features.py:36-46`)."""
    if path.lower().endswith(".wav"):
        y, in_sr = load_wav(path)
        return resample(y, in_sr, sr)
    if have_ffmpeg():
        return load_audio_ffmpeg(path, sr)
    raise RuntimeError(
        f"cannot decode {path}: not a WAV and ffmpeg is unavailable")


def audio_slicer(y: np.ndarray, sr: int, end_time: float,
                 start_time: float = 0.0) -> np.ndarray:
    """Trim to [start_time, end_time] seconds (`features.py:55-64`)."""
    i0 = max(int(round(start_time * sr)), 0)
    i1 = min(int(round(end_time * sr)), len(y))
    return y[i0:i1]


def save_wav(path: str, y: np.ndarray, sr: int = 44100) -> None:
    """Write mono float32 samples as 16-bit PCM WAV (stdlib)."""
    x = np.clip(np.asarray(y, dtype=np.float64), -1.0, 1.0)
    data = (x * 32767).astype("<i2").tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data)


def export_onset_clicks(y: np.ndarray, outname: str, onsets: np.ndarray,
                        sr: int = 44100, hop_length: int = 512) -> None:
    """Auditory beat-tracker spot check: overwrite 20 ms 440 Hz blips at
    each onset and write the result (`features.py:505-529`; WAV output is
    written directly, other formats go through ffmpeg when available)."""
    yaudio = np.array(y, dtype=np.float32)
    blipsamples = int(round(0.02 * sr))
    blip = np.cos(2 * np.pi * np.arange(blipsamples) * 440.0 / sr)
    blip = (blip * np.max(np.abs(yaudio))).astype(np.float32)
    for idx in np.asarray(onsets).ravel():
        i0 = int(idx) * hop_length
        seg = yaudio[i0:i0 + blipsamples]
        yaudio[i0:i0 + len(seg)] = blip[:len(seg)]
    if outname.lower().endswith(".wav") or not have_ffmpeg():
        save_wav(outname, yaudio, sr)
        return
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        save_wav(tmp.name, yaudio, sr)
        subprocess.run(["ffmpeg", "-y", "-v", "quiet", "-i", tmp.name,
                        outname], check=True)
