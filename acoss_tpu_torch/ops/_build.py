"""Build and load the port's CUDA kernels (`acoss_tpu_torch/csrc/*.cu`).

The kernels expose a plain C interface and are compiled by nvcc into one
shared library, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library's file name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never
loaded; the build writes a temporary file and renames it into place, so
concurrent first uses never load a half-written library. Nothing is
built at import time: `library()` builds on first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "acoss_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
#: Shared memory one block may use on Hopper (sm_90), in bytes.
MAX_SMEM = 227 * 1024


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels "
        f"of acoss_tpu_torch are compiled from {CSRC} on first use and "
        f"need the CUDA toolkit; set CUDA_HOME or put nvcc on PATH")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return Path(build_dir) / f"libacoss_kernels_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Raises RuntimeError with nvcc's stderr on failure."""
    out = library_path(build_dir)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sources() if p.suffix == ".cu"]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(str(build()))
    for name in ("acoss_qmax", "acoss_dmax"):
        fn = getattr(lib, name)
        # S, m_len, n_len, B, M, N, gap, out, device, stream
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _F, _P, _I, _P]
        fn.restype = _I
    # X, Y, l1, l2, B, L, d, m, kappa, W, thr, S, device, stream
    lib.acoss_fused_crp.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _F,
                                    _P, _P, _P, _I, _P]
    lib.acoss_fused_crp.restype = _I
    lib.acoss_fused_crp_smem.argtypes = [_I, _I, _I]
    lib.acoss_fused_crp_smem.restype = ctypes.c_size_t
    lib.acoss_error_string.argtypes = [_I]
    lib.acoss_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        msg = library().acoss_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

