"""ctypes bridge to the native C++ aligners (the port's copy of
`acoss_tpu.native`, over its own copy of the C++ source,
`csrc/alignment_cpu.cpp`).

The single-core CPU oracle and baseline of the aligner kernels: qmax,
dmax and constrained SW computed cell by cell, a composition independent
of the plain PyTorch scans and of the CUDA kernels. The library is
compiled with g++ on first use into `build/acoss_tpu_torch/` (a file name
carrying a hash of the source and flags, written to a temporary file and
renamed into place, as `ops._build` does for the CUDA kernels). Inputs
and outputs are numpy arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

import numpy as np

from acoss_tpu_torch.ops._build import BUILD_DIR, CSRC, compile_once

SOURCE = CSRC / "alignment_cpu.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libacoss_cpu_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the C++ aligners unless a library for this source exists;
    returns its path. Raises RuntimeError with g++'s stderr on failure."""
    return compile_once(library_path(build_dir), lambda tmp: [
        "g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)])


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_F = ctypes.c_float
_I = ctypes.c_int


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native CPU alignment library."""
    lib = ctypes.CDLL(str(build()))
    for name, n_params in (("acoss_qmax", 2), ("acoss_dmax", 2),
                           ("acoss_swconstrained", 4)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [_U8P, _I, _I] + [_F] * n_params
        batch = getattr(lib, f"{name}_batch")
        batch.restype = None
        batch.argtypes = [_U8P, _I, _I, _I, _I32P, _I32P] \
            + [_F] * n_params + [_F32P]
    return lib


def _as_u8(S) -> np.ndarray:
    return np.ascontiguousarray(S, dtype=np.uint8)


def _single(name: str, S, *params: float) -> float:
    S = _as_u8(S)
    M, N = S.shape
    return float(getattr(get_lib(), name)(S.ctypes.data_as(_U8P), M, N,
                                          *params))


def _batch(name: str, S, m_len, n_len, *params: float) -> np.ndarray:
    S = _as_u8(S)
    B, M, N = S.shape
    m = np.ascontiguousarray(m_len, dtype=np.int32)
    n = np.ascontiguousarray(n_len, dtype=np.int32)
    out = np.zeros(B, dtype=np.float32)
    getattr(get_lib(), f"{name}_batch")(
        S.ctypes.data_as(_U8P), B, M, N, m.ctypes.data_as(_I32P),
        n.ctypes.data_as(_I32P), *params, out.ctypes.data_as(_F32P))
    return out


def qmax_cpu(S: np.ndarray, gap_onset: float = 0.5,
             gap_extension: float = 0.5) -> float:
    """Single-pair qmax on the CPU (golden oracle)."""
    return _single("acoss_qmax", S, gap_onset, gap_extension)


def dmax_cpu(S: np.ndarray, gap_onset: float = 0.5,
             gap_extension: float = 0.5) -> float:
    return _single("acoss_dmax", S, gap_onset, gap_extension)


def swconstrained_cpu(S: np.ndarray, gap_opening: float = -0.5,
                      gap_extension: float = -0.7,
                      match_score: float = 1.0,
                      mismatch_score: float = -1.0) -> float:
    return _single("acoss_swconstrained", S, gap_opening, gap_extension,
                   match_score, mismatch_score)


def qmax_batch_cpu(S: np.ndarray, m_len: np.ndarray, n_len: np.ndarray,
                   gap_onset: float = 0.5,
                   gap_extension: float = 0.5) -> np.ndarray:
    """Batched qmax on the CPU; S is (B, M, N), read only inside each
    pair's (m_len, n_len) window."""
    return _batch("acoss_qmax", S, m_len, n_len, gap_onset, gap_extension)


def dmax_batch_cpu(S: np.ndarray, m_len: np.ndarray, n_len: np.ndarray,
                   gap_onset: float = 0.5,
                   gap_extension: float = 0.5) -> np.ndarray:
    return _batch("acoss_dmax", S, m_len, n_len, gap_onset, gap_extension)


def swconstrained_batch_cpu(S: np.ndarray, m_len: np.ndarray,
                            n_len: np.ndarray,
                            gap_opening: float = -0.5,
                            gap_extension: float = -0.7,
                            match_score: float = 1.0,
                            mismatch_score: float = -1.0) -> np.ndarray:
    return _batch("acoss_swconstrained", S, m_len, n_len, gap_opening,
                  gap_extension, match_score, mismatch_score)
