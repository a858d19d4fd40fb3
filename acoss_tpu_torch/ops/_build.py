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
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "acoss_tpu_torch"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                 "-std=c++17", "-Xcompiler", "-fPIC")
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")
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


def compile_once(out: Path, command) -> Path:
    """Build `out` unless it exists, with the compiler command
    `command(tmp)`, which writes the temporary file `tmp` that is then
    renamed into place; returns `out`. Raises RuntimeError with the
    compiler's stderr on failure."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = command(tmp)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link; returns the
    library's path. Raises RuntimeError with nvcc's stderr on failure."""
    out = library_path(build_dir)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sources():
            if src.suffix == ".cu":
                obj = Path(tmp) / f"{src.stem}.o"
                jobs.append((src, obj, subprocess.Popen(
                    [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True)))
        errors = [(src, proc.communicate()[1], proc.returncode)
                  for src, _, proc in jobs]
        failed = [f"{src.name} ({rc}):\n{err}" for src, err, rc in errors
                  if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return compile_once(out, lambda t: [
            nvcc, *NVCC_FLAGS, "-o", str(t), *(str(o) for _, o, _ in jobs)])


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# S, m_len, n_len, B, M, N, <the float parameters>, out, device, stream
_ALIGNER = ([_P, _P, _P, _I, _I, _I], [_P, _I, _P])

#: (argtypes, restype) of every C entry point of the kernel library.
SIGNATURES = {
    **{name: (_ALIGNER[0] + [_F] * n_params + _ALIGNER[1], _I)
       for name, n_params in (("acoss_qmax", 1), ("acoss_dmax", 1),
                              ("acoss_qmax_uneq", 2), ("acoss_sw", 4))},
    # X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S, device, stream
    "acoss_fused_crp": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P,
                         _I, _P], _I),
    "acoss_fused_crp_smem": ([_I, _I, _I], ctypes.c_size_t),
    "acoss_fused_crp_cluster": ([_I, _I, _I], _I),
    # D, l1, l2, B, L, kappa, thr, S, device, stream
    "acoss_binarize": ([_P, _P, _P, _I, _I, _F, _P, _P, _I, _P], _I),
    # W, k, B, n, largest, V, device, stream
    "acoss_knn_mask": ([_P, _P, _I, _I, _I, _P, _I, _P], _I),
    # SSMA, SSMB, CSM, l1, l2, K, B, L, Mu, stats, W, device, stream
    "acoss_wcsmssm": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _I, _P],
                      _I),
    # E, A, T, C, L, scratch, gamma, device, stream
    "acoss_hmm_fb": ([_P, _P, _I, _I, _I, _P, _P, _I, _P], _I),
    "acoss_hmm_fb_scratch": ([_I, _I, _I], ctypes.c_size_t),
    "acoss_error_string": ([_I], ctypes.c_char_p),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        msg = library().acoss_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

