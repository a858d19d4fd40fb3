"""Profile one warm tile of each path of the PyTorch/CUDA port, and time
whole sweeps.

    python3 scripts/torch_tile_profile.py [--trace-dir DIR] [--reps 7]
        [--paths serra09,early_snf,early_snf_fast,serra09_full,early_fusion,
                 chen_fusion,tgalg,simple] [--sweeps N]

Run from the root of a checkout on a machine with a CUDA device. It builds
the covers80-geometry corpus of `chip_smoke.py` (160 songs), extracts the
descriptors the chosen paths need (Serra09's, EarlySNF's, ChenFusion's
and TGAlg's with the card, L = 512; EarlyFusion's on the host, L = 576;
Simple's on the host, L = 192), and for tile (1, 0) (8 x 8 pairs) of
Serra09 (the main path, defaults), EarlySNF (parity), EarlySNF
(throughput), Serra09(do_ssms=True), EarlyFusion, ChenFusion, TGAlg and
Simple prints the median
wall of `--reps` warm tiles, one `torch.profiler` tile's device time by
kernel and its idle share (1 - summed kernel time / profiled wall), and
the peak device memory. With --sweeps N it also times N whole
`run_pairwise` sweeps of each path over the corpus (12,720 pairs) and
prints the median, min and max fully-scored pairs/s. With --trace-dir it
also writes one Chrome trace per path there.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from acoss_tpu_torch.benchmarking.algorithms import (  # noqa: E402
    ChenFusion, EarlyFusion, EarlySNF, Serra09, Simple, TGAlg)
from acoss_tpu_torch.benchmarking.harness import run_pairwise  # noqa: E402
from acoss_tpu_torch.convert import descriptors_from_numpy  # noqa: E402


# path -> (its algorithm, the algorithm whose descriptors it reads)
PATHS = {"serra09": (Serra09, Serra09),
         "early_snf": (EarlySNF, EarlySNF),
         "early_snf_fast": (lambda: EarlySNF(snf_precision="default"),
                            EarlySNF),
         "serra09_full": (lambda: Serra09(do_ssms=True), EarlySNF),
         "early_fusion": (EarlyFusion, EarlyFusion),
         "chen_fusion": (ChenFusion, ChenFusion),
         "tgalg": (TGAlg, TGAlg),
         "simple": (Simple, Simple)}


def _kernel_rows(prof) -> list:
    """(device ms, calls, name) of each kernel, largest first; an aten
    op's row would repeat its kernels' time, so only device events count."""
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def _sweeps(name: str, algo, desc: dict, fs, n: int) -> None:
    """Time `n` whole sweeps of `algo` over the corpus (after one warm-up
    sweep) and print the median, min and max fully-scored pairs/s."""
    pairs = fs.n_songs * (fs.n_songs - 1) // 2
    rates = []
    for rep in range(n + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_pairwise(algo, desc, fs.n_songs, device="cuda")
        torch.cuda.synchronize()
        if rep:
            rates.append(pairs / (time.perf_counter() - t))
    rates.sort()
    print(f"== {name}: {n} sweeps of {pairs} pairs: median "
          f"{rates[len(rates) // 2]:.1f} fully-scored pairs/s (min "
          f"{rates[0]:.1f}, max {rates[-1]:.1f})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--top", type=int, default=22)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--sweeps", type=int, default=0)
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fs = chip_smoke._corpus()
    descs = {}
    for name in paths:
        make, key = PATHS[name]
        algo = make()
        if key not in descs:
            t0 = time.perf_counter()
            descs[key] = descriptors_from_numpy(
                key().extract_descriptors(fs, device="cuda"), "cuda")
            torch.cuda.synchronize()
            print(f"extract {key.NAME} {time.perf_counter() - t0:.2f} s",
                  flush=True)
        row, col = chip_smoke._tile(descs[key])
        for _ in range(2):
            algo.tile_scores(row, col)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(args.reps):
            t = time.perf_counter()
            algo.tile_scores(row, col)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        walls.sort()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            algo.tile_scores(row, col)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rows = _kernel_rows(prof)
        dev_ms = sum(r[0] for r in rows)
        print(f"== {name}: wall per tile median "
              f"{walls[len(walls) // 2] * 1e3:.2f} ms (min "
              f"{walls[0] * 1e3:.2f}, max {walls[-1] * 1e3:.2f}); profiled "
              f"wall {wall:.2f} ms, kernels {dev_ms:.2f} ms, idle "
              f"{100 * (1 - dev_ms / wall):.1f}%; peak {peak:.2f} GiB",
              flush=True)
        for ms, n, kernel in rows[:args.top]:
            print(f"  {ms:9.3f} ms {n:5d}  {kernel[:90]}")
        if args.sweeps:
            _sweeps(name, algo, descs[key], fs, args.sweeps)
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.trace_dir, f"trace_{name}.json"))
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
