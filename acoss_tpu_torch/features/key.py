"""Key estimation from chroma (Krumhansl-Schmuckler profiles); a numpy
copy of `acoss_tpu.features.key`.

Replaces essentia's `KeyExtractor` (the reference's
`preprocess/features.py:330-370`, which returns {'key', 'scale',
'strength'}). This
correlates the time-averaged chroma with the 24 major/minor K-S profiles;
essentia's edma/temperley variants differ in the profile tables only.
"""

from __future__ import annotations

import numpy as np

_MAJOR = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09,
                   2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
_MINOR = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53,
                   2.54, 4.75, 3.98, 2.69, 3.34, 3.17])
_NAMES = ["C", "C#", "D", "D#", "E", "F",
          "F#", "G", "G#", "A", "A#", "B"]


def _corr(a, b):
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def key_extractor(chroma: np.ndarray) -> dict:
    """Estimate key from a (n_frames, 12) chroma sequence (bin 0 = C).

    Returns {'key': str, 'scale': 'major'|'minor', 'strength': float}.
    """
    chroma = np.asarray(chroma, dtype=np.float64)
    if chroma.size == 0 or not np.all(np.isfinite(chroma)):
        # audio shorter than one analysis frame (or corrupt values):
        # refuse to fabricate a key — let batch_extract's error ledger
        # record the track instead of silently storing {'C', 'major'}
        raise ValueError(
            f"key_extractor needs at least one finite chroma frame "
            f"(got shape {chroma.shape})")
    profile = chroma.mean(axis=0)
    best = ("C", "major", -np.inf)
    for shift in range(12):
        rolled = np.roll(profile, -shift)
        for scale, ref in (("major", _MAJOR), ("minor", _MINOR)):
            c = _corr(rolled, ref)
            if c > best[2]:
                best = (_NAMES[shift], scale, c)
    return {"key": best[0], "scale": best[1], "strength": best[2]}
