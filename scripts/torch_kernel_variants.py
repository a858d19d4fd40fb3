"""Time variants of the fused CRP and dmax kernels on one card, each built
from a copy of `acoss_tpu_torch/csrc` with one constant changed or one
phase removed, beside the sources as they are.

    python3 scripts/torch_kernel_variants.py [--out build/kernel_variants]

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Every variant is compiled (all at once) into its own library under --out
and called through ctypes with the C signatures of `_build.SIGNATURES`.
For each it prints the mean device ms a launch (CUDA events) at the
Serra09 main path's shapes: the fused CRP at B=64, L=512, d=12 and 13
(random features, lengths 260..470), with the device time of each of its
two kernels from `torch.profiler`, and dmax at B=128, L=512 on bench.py's
CRP workload. Variants that keep the function are checked bit for bit
against the plain versions; the diagnostic ones (a phase removed) are
not. Nothing under `csrc/` is modified.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())

from acoss_tpu_torch.ops import _build, alignment_cuda, crp_cuda  # noqa: E402

# (name, [(text in csrc, its replacement)], whether it keeps the function)
CRP_VARIANTS = [
    ("as is", [], True),
    ("bands sized for 2 blocks an SM",
     [("kBandBlocksPerSm = 4", "kBandBlocksPerSm = 2")], True),
    ("strips of 8 columns",
     [("for (int cw = 16; cw", "for (int cw = 8; cw")], True),
    ("diagnostic: no row search",
     [("const unsigned t = warp_kth(key, k);\n    if (lane == 0) tr[r] = t;",
       "if (lane == 0) tr[r] = key[0];")], False),
    ("diagnostic: no CSM",
     [("for (int j = threadIdx.x; j < ny; j += kThreads) {\n"
       "    const float* yg",
       "for (int j = threadIdx.x; j < 0; j += kThreads) {\n"
       "    const float* yg")], False),
    ("diagnostic: no column search",
     [("const unsigned t = warp_kth(key, k);\n"
       "    if (lane == 0) t_col[c] = t;",
       "if (lane == 0) t_col[c] = key[0];")], False),
]
DMAX_VARIANTS = [
    ("as is", [], True),
    ("8 columns a thread (2 warps a pair)",
     [("int cols = 4;", "int cols = 8;")], True),
    ("16 columns a thread (1 warp a pair)",
     [("int cols = 4;", "int cols = 16;")], True),
    ("2 stages",
     [("constexpr int kStages = 4;", "constexpr int kStages = 2;")], True),
    ("diagnostic: no cell arithmetic",
     [("        const float v = es[2 + k] != 0.0f ? m5 + 1.0f\n"
       "                                          : fmaxf(m5 - gap, 0.0f);",
       "        const float v = es[2 + k] + e1[k];")], False),
]
CRP_SOURCES = ("crp.cu",)
DMAX_SOURCES = ("alignment.cu",)


def _start_build(out: str, name: str, sources, subs):
    """Copy `sources` from csrc with `subs` applied into out/name and start
    nvcc on them; returns (library path, process)."""
    d = os.path.join(out, name)
    os.makedirs(d)
    hits = set()
    for f in sources:
        text = (_build.CSRC / f).read_text()
        for a, b in subs:
            if a in text:
                hits.add(a)
                text = text.replace(a, b)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    missing = {a for a, _ in subs} - hits
    if missing:
        raise RuntimeError(f"{name}: not in the sources: {missing}")
    lib = os.path.join(d, "lib.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
           *[os.path.join(d, f) for f in sources]]
    return lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)


def _load(lib: str, proc, entry: str):
    err = proc.communicate()[1]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {lib}:\n{err}")
    fn = getattr(ctypes.CDLL(lib), entry)
    fn.argtypes, fn.restype = _build.SIGNATURES[entry]
    return fn


def _ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/kernel_variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    shutil.rmtree(args.out, ignore_errors=True)
    builds = {("crp", n): _start_build(args.out, f"crp{i}", CRP_SOURCES, s)
              for i, (n, s, _) in enumerate(CRP_VARIANTS)}
    builds.update({("dmax", n): _start_build(args.out, f"dmax{i}",
                                             DMAX_SOURCES, s)
                   for i, (n, s, _) in enumerate(DMAX_VARIANTS)})
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(1)
    B, L = 64, 512
    crp_in = []
    for d in (12, 13):
        l1, l2 = (rng.integers(260, 471, B).astype(np.int32) for _ in "ab")
        X, Y = (rng.standard_normal((B, L, d)).astype(np.float32)
                for _ in "ab")
        crp_in.append([torch.from_numpy(a).to(dev) for a in (X, Y, l1, l2)])
    for name, _, exact in CRP_VARIANTS:
        fn = _load(*builds["crp", name], "acoss_fused_crp")

        def fused(X, Y, l1, l2):
            W = torch.empty((B, L, L), dtype=torch.float32, device=dev)
            t_row = torch.empty((B, L), dtype=torch.int32, device=dev)
            S = torch.empty((B, L, L), dtype=torch.uint8, device=dev)
            _build.check(fn(X.data_ptr(), Y.data_ptr(), l1.data_ptr(),
                            l2.data_ptr(), B, L, X.shape[2], 9, 0.095,
                            W.data_ptr(), t_row.data_ptr(), S.data_ptr(),
                            dev.index, stream), name)
            return S

        times = []
        for a in crp_in:
            if exact and not torch.equal(
                    fused(*a), crp_cuda.fused_binary_crp_ref(*a, 0.095, 9)[0]):
                raise AssertionError(f"fused CRP {name}: != plain")
            times.append(_ms(lambda: fused(*a)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused(*crp_in[0])
            torch.cuda.synchronize()
        split = ", ".join(
            f"{e.key.split('<')[0].split('::')[-1]} "
            f"{e.self_device_time_total / 1e3:.4f}"
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0)
        print(f"fused CRP, {name}: d=12 {times[0]:.4f} ms, d=13 "
              f"{times[1]:.4f} ms, mean {np.mean(times):.4f} ms; d=12 by "
              f"kernel (ms): {split}", flush=True)
    rng = np.random.default_rng(0)
    m = rng.integers(320, L + 1, 128).astype(np.int32)
    n = rng.integers(320, L + 1, 128).astype(np.int32)
    S = np.zeros((128, L, L), np.uint8)
    for b in range(128):
        S[b, :m[b], :n[b]] = rng.random((m[b], n[b])) < 0.095
    S, m, n = (torch.from_numpy(a).to(dev) for a in (S, m, n))
    want = alignment_cuda.dmax_batch_ref(S, m, n)
    for name, _, exact in DMAX_VARIANTS:
        fn = _load(*builds["dmax", name], "acoss_dmax")

        def dmax():
            out = torch.empty(128, dtype=torch.float32, device=dev)
            _build.check(fn(S.data_ptr(), m.data_ptr(), n.data_ptr(), 128,
                            L, L, 0.5, out.data_ptr(), dev.index, stream),
                         name)
            return out

        if exact and not torch.equal(dmax(), want):
            raise AssertionError(f"dmax {name}: != plain")
        print(f"dmax, {name}: {_ms(dmax):.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
