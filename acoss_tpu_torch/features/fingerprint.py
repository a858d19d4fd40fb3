"""Audio fingerprinting (the Chromaprinter slot); a numpy copy of
`acoss_tpu.features.fingerprint`.

The reference binds essentia's Chromaprinter — the AcoustID chromaprint
library — at `preprocess/features.py:531-545`. That
library is unavailable in this image, so this is a from-scratch
implementation of the chromaprint ALGORITHM:

- the published analysis pipeline: 11025 Hz mono, 4096-point Hamming
  frames with 2/3 overlap (hop 1365), note-mapped 12-bin chroma over
  28–3520 Hz, the [0.25, 0.75, 1.0, 0.75, 0.25] temporal chroma filter,
  per-frame L2 normalization;
- 16 two-bit classifiers over the chroma integral image (the six
  published rectangle-comparison filter shapes in the log(1+x) domain,
  Gray-coded quantizer) -> one uint32 subfingerprint per frame;
- the EXACT AcoustID container format: XOR-delta subfingerprints,
  set-bit gaps packed as 3-bit normal / 5-bit exceptional codes, a
  4-byte (algorithm, 24-bit length) header, URL-safe unpadded base64.
  `decompress_fingerprint` round-trips and also decodes fingerprints
  produced by the real library.

What is NOT reproduced: the 16 classifier CONFIGURATIONS (band/width/
threshold constants) are machine-trained values inside the chromaprint
distribution and are re-derived here, so the subfingerprint BITS differ
from AcoustID's even though any chromaprint decoder can unpack the
stream. Documented in PARITY.md.
"""

from __future__ import annotations

import base64

import numpy as np

_FS = 11025          # chromaprint analysis rate
_FRAME = 4096
_HOP = _FRAME // 3   # 2/3 overlap
_FMIN, _FMAX = 28.0, 3520.0
_ALGORITHM = 1       # header byte: CHROMAPRINT_ALGORITHM_TEST2 slot


# ---------------------------------------------------------------------------
# analysis pipeline: audio -> filtered, normalized 12-bin chroma frames
# ---------------------------------------------------------------------------

def _chroma_frames(y: np.ndarray, sr: int) -> np.ndarray:
    """(n_frames, 12) note-mapped chroma at the chromaprint analysis
    parameters (11025 Hz / 4096-pt Hamming / hop 1365 / 28-3520 Hz)."""
    from acoss_tpu_torch.features.audio import resample

    y = resample(np.asarray(y, dtype=np.float32), sr, _FS)
    if len(y) < _FRAME:
        y = np.pad(y, (0, _FRAME - len(y)))
    n_frames = 1 + (len(y) - _FRAME) // _HOP
    idx = (np.arange(_FRAME)[None, :]
           + _HOP * np.arange(n_frames)[:, None])
    frames = y[idx] * np.hamming(_FRAME)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2   # energy spectrum

    freqs = np.fft.rfftfreq(_FRAME, 1.0 / _FS)
    band = (freqs >= _FMIN) & (freqs < _FMAX)
    # nearest-note chroma index: A440 is note 0
    note = 12.0 * np.log2(np.where(band, freqs, 440.0) / 440.0)
    bins = np.round(note).astype(np.int64) % 12
    chroma = np.zeros((n_frames, 12))
    np.add.at(chroma.T, bins[band], spec[:, band].T)
    return chroma


def _filter_and_normalize(chroma: np.ndarray) -> np.ndarray:
    """Temporal FIR [0.25, 0.75, 1, 0.75, 0.25] (valid frames only),
    then per-frame L2 normalization with the 0.01 silence gate."""
    coeffs = np.array([0.25, 0.75, 1.0, 0.75, 0.25])
    if chroma.shape[0] < len(coeffs):
        return np.zeros((0, 12))
    out = np.zeros((chroma.shape[0] - len(coeffs) + 1, 12))
    for i, c in enumerate(coeffs):
        out += c * chroma[i:i + out.shape[0]]
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return np.where(norm > 0.01, out / np.maximum(norm, 1e-30), 0.0)


# ---------------------------------------------------------------------------
# classifiers: integral image -> one uint32 per frame
# ---------------------------------------------------------------------------

def _integral(img: np.ndarray) -> np.ndarray:
    """(n+1, 13) zero-padded 2D prefix sums of the (n, 12) chroma."""
    ii = np.zeros((img.shape[0] + 1, img.shape[1] + 1))
    ii[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    return ii


def _area(ii, t0, t1, b0, b1):
    """Sum over frames [t0, t1) x chroma bands [b0, b1), vectorized over
    a window-start vector t0/t1."""
    return ii[t1, b1] - ii[t0, b1] - ii[t1, b0] + ii[t0, b0]


def _filter_value(ii, ftype, t, w, b, h):
    """The six published rectangle-comparison shapes, evaluated at every
    window start in vector `t`, in the ln(1+a) - ln(1+b) domain."""
    ln = lambda a: np.log1p(np.maximum(a, 0.0))
    if ftype == 0:      # whole rectangle
        return ln(_area(ii, t, t + w, b, b + h))
    if ftype == 1:      # lower bands minus upper bands
        m = h // 2
        return (ln(_area(ii, t, t + w, b, b + m))
                - ln(_area(ii, t, t + w, b + m, b + h)))
    if ftype == 2:      # earlier frames minus later frames
        m = w // 2
        return (ln(_area(ii, t, t + m, b, b + h))
                - ln(_area(ii, t + m, t + w, b, b + h)))
    if ftype == 3:      # checkerboard
        mw, mh = w // 2, h // 2
        a = (_area(ii, t, t + mw, b, b + mh)
             + _area(ii, t + mw, t + w, b + mh, b + h))
        c = (_area(ii, t + mw, t + w, b, b + mh)
             + _area(ii, t, t + mw, b + mh, b + h))
        return ln(a) - ln(c)
    if ftype == 4:      # middle band third minus outer thirds
        m1, m2 = h // 3, 2 * h // 3
        mid = _area(ii, t, t + w, b + m1, b + m2)
        outer = _area(ii, t, t + w, b, b + h) - mid
        return ln(mid) - ln(outer)
    if ftype == 5:      # middle time third minus outer thirds
        m1, m2 = w // 3, 2 * w // 3
        mid = _area(ii, t + m1, t + m2, b, b + h)
        outer = _area(ii, t, t + w, b, b + h) - mid
        return ln(mid) - ln(outer)
    raise ValueError(f"unknown filter type {ftype}")


# 16 x (filter type, band offset, band height, frame width, thresholds).
# Same SHAPE as chromaprint's trained classifier tables; the constants
# are re-derived (spread over shapes/bands/scales), not the trained set.
_CLASSIFIERS = (
    (0, 0, 4, 15, (1.75, 2.20, 2.55)),
    (0, 4, 4, 15, (1.75, 2.20, 2.55)),
    (0, 8, 4, 15, (1.75, 2.20, 2.55)),
    (1, 0, 6, 15, (-0.35, 0.0, 0.35)),
    (1, 6, 6, 15, (-0.35, 0.0, 0.35)),
    (1, 2, 8, 9, (-0.30, 0.0, 0.30)),
    (2, 0, 4, 16, (-0.20, 0.0, 0.20)),
    (2, 4, 4, 16, (-0.20, 0.0, 0.20)),
    (2, 8, 4, 16, (-0.20, 0.0, 0.20)),
    (2, 0, 12, 10, (-0.15, 0.0, 0.15)),
    (3, 0, 6, 12, (-0.25, 0.0, 0.25)),
    (3, 6, 6, 12, (-0.25, 0.0, 0.25)),
    (3, 3, 6, 16, (-0.25, 0.0, 0.25)),
    # mid-third-vs-outer-thirds shapes compare a 1:2 area ratio, so
    # their quantizers center on the ln(1/2) offset, not 0
    (4, 0, 9, 13, (-0.95, -0.69, -0.45)),
    (4, 3, 9, 13, (-0.95, -0.69, -0.45)),
    (5, 1, 10, 15, (-0.95, -0.69, -0.45)),
)
_MAX_W = max(c[3] for c in _CLASSIFIERS)
_GRAY = np.array([0, 1, 3, 2], dtype=np.uint32)


def fingerprint_from_chroma(chroma: np.ndarray) -> np.ndarray:
    """uint32 subfingerprint per sliding window of filtered chroma
    frames: 16 classifiers x 2 Gray-coded bits (classifier 0 in the top
    bits, chromaprint's packing order)."""
    img = np.asarray(chroma, dtype=np.float64)
    if img.shape[0] < _MAX_W:
        return np.zeros(0, dtype=np.uint32)
    ii = _integral(img)
    t = np.arange(img.shape[0] - _MAX_W + 1)
    out = np.zeros(len(t), dtype=np.uint32)
    for ftype, b, h, w, thr in _CLASSIFIERS:
        v = _filter_value(ii, ftype, t, w, b, h)
        q = np.searchsorted(np.asarray(thr), v, side="right")
        out = (out << np.uint32(2)) | _GRAY[q]
    return out


# ---------------------------------------------------------------------------
# the AcoustID container format (bit-exact with chromaprint's
# FingerprintCompressor/Decompressor)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.nbits = 0

    def write(self, x: int, n: int):
        self.buf |= x << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.buf & 0xFF)
            self.buf >>= 8
            self.nbits -= 8

    def flush(self):
        if self.nbits:
            self.out.append(self.buf & 0xFF)
            self.buf = self.nbits = 0


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.pos >= len(self.data):
                raise ValueError("truncated fingerprint bitstream")
            self.buf |= self.data[self.pos] << self.nbits
            self.pos += 1
            self.nbits += 8
        x = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.nbits -= n
        return x


def compress_fingerprint(subfps: np.ndarray,
                         algorithm: int = _ALGORITHM) -> bytes:
    """chromaprint's compressed form: per subfingerprint (XOR'd with its
    predecessor) the gaps between consecutive set-bit positions plus a 0
    terminator, each gap as min(g, 7) in the 3-bit normal stream with
    g - 7 appended to the 5-bit exception stream; 4-byte header."""
    subfps = np.asarray(subfps, dtype=np.uint32)
    gaps: list[int] = []
    prev = np.uint32(0)
    for v in subfps:
        x = int(v ^ prev)
        prev = v
        bit, last = 1, 0
        while x:
            if x & 1:
                gaps.append(bit - last)
                last = bit
            x >>= 1
            bit += 1
        gaps.append(0)

    n = len(subfps)
    out = bytearray([algorithm & 0xFF,
                     (n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF])
    w = _BitWriter()
    for g in gaps:
        w.write(min(g, 7), 3)
    for g in gaps:
        if g >= 7:
            w.write(g - 7, 5)
    w.flush()
    return bytes(out) + bytes(w.out)


def decompress_fingerprint(data: bytes) -> tuple[np.ndarray, int]:
    """Inverse of `compress_fingerprint`; also decodes real
    chromaprint/AcoustID fingerprints (same container)."""
    if len(data) < 4:
        raise ValueError("fingerprint too short")
    algorithm = data[0]
    n = (data[1] << 16) | (data[2] << 8) | data[3]
    r = _BitReader(data, 4)
    gaps_per_fp: list[list[int]] = []
    cur: list[int] = []
    while len(gaps_per_fp) < n:
        g = r.read(3)
        if g == 0:
            gaps_per_fp.append(cur)
            cur = []
        else:
            cur.append(g)
    for gs in gaps_per_fp:
        for i, g in enumerate(gs):
            if g == 7:
                gs[i] = 7 + r.read(5)
    out = np.zeros(n, dtype=np.uint32)
    prev = 0
    for i, gs in enumerate(gaps_per_fp):
        x, bit = 0, 0
        for g in gs:
            bit += g
            x |= 1 << (bit - 1)
        prev ^= x
        out[i] = prev
    return out, algorithm


def chromaprint(y: np.ndarray, sr: int = 44100, analysis_time: float = 30,
                hop_length: int | None = None) -> str:
    """URL-safe base64 chromaprint of the first `analysis_time` seconds
    (`features.py:531-545` signature parity; `hop_length` accepted for
    back-compat and ignored — the chromaprint pipeline fixes its own
    hop)."""
    n = min(len(y), int(analysis_time * sr))
    chroma = _filter_and_normalize(_chroma_frames(y[:n], sr))
    h = fingerprint_from_chroma(chroma)
    return base64.urlsafe_b64encode(
        compress_fingerprint(h)).decode().rstrip("=")


def decode_chromaprint(fp: str) -> tuple[np.ndarray, int]:
    """Base64 string -> (uint32 subfingerprints, algorithm byte)."""
    pad = "=" * (-len(fp) % 4)
    return decompress_fingerprint(base64.urlsafe_b64decode(fp + pad))
