"""Profile one warm tile of each SNF-slice path and of EarlyFusion in the
PyTorch/CUDA port.

    python3 scripts/torch_tile_profile.py [--trace-dir DIR] [--reps 7]
        [--paths early_snf,early_snf_fast,serra09_full,early_fusion]

Run from the root of a checkout on a machine with a CUDA device. It builds
the covers80-geometry corpus of `chip_smoke.py` (160 songs), extracts the
descriptors the chosen paths need (EarlySNF's on the card, L = 512;
EarlyFusion's on the host, L = 576), and for tile (1, 0) (8 x 8 pairs) of
EarlySNF (parity), EarlySNF (throughput), Serra09(do_ssms=True) and
EarlyFusion prints the median wall of `--reps` warm tiles, one
`torch.profiler` tile's device time by kernel and its idle share
(1 - summed kernel time / profiled wall), and the peak device memory.
With --trace-dir it also writes one Chrome trace per path there.
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
    EarlyFusion, EarlySNF, Serra09)
from acoss_tpu_torch.convert import descriptors_from_numpy  # noqa: E402


PATHS = {"early_snf": EarlySNF,
         "early_snf_fast": lambda: EarlySNF(snf_precision="default"),
         "serra09_full": lambda: Serra09(do_ssms=True),
         "early_fusion": EarlyFusion}


def _kernel_rows(prof) -> list:
    """(device ms, calls, name) of each kernel, largest first; an aten
    op's row would repeat its kernels' time, so only device events count."""
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--top", type=int, default=22)
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fs = chip_smoke._corpus()
    descs = {}
    for name in paths:
        algo = PATHS[name]()
        # the three SNF-slice paths share EarlySNF's descriptors
        key = EarlyFusion if name == "early_fusion" else EarlySNF
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
        for ms, n, key in rows[:args.top]:
            print(f"  {ms:9.3f} ms {n:5d}  {key[:90]}")
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.trace_dir, f"trace_{name}.json"))
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
