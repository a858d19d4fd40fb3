"""The correctness check's two readings for a cell, on several seeds in one
process: what sound runs of the program read (the lower reading), and what
the control reads (the upper one), against the plain reference.

    python portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--controls bf16,tf32,program_default]

Per seed: the cell's own set-up at its own size, a short window at its own
load, the seeded sample of what the window produced, then the numbers the
check compares (`run.compare`) for the program and for each control:

  bf16             the reference in the program's place with its CSM and
                   window arithmetic in bfloat16
  fp64             the same in float64: sound arithmetic in another
                   rounding, which reads what a reordering of the float32
                   sums would move (Serra09 only)
  tf32             the reference in the program's place with TF32 matmuls
                   (the configurations state float32 with TF32 off)
  program_default  the program's own lower-precision path on the same
                   tiles (EarlySNF's snf_precision="default": bf16
                   diffusion operands, the fused WCSMSSM kernel)

One JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run as R  # noqa: E402


@contextlib.contextmanager
def _tf32(on: bool):
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def program_default(driver) -> dict:
    """EarlySNF's throughput path on the sampled tiles, from the program's
    own descriptors (before they are freed)."""
    import numpy as np

    from acoss_tpu_torch.benchmarking.harness import (_device_blocks,
                                                      upcast_stream)
    from portbench import corpus as C

    algo = C.algorithm({**driver.run.config,
                        "params": {**driver.run.config["params"],
                                   "snf_precision": "default"}})
    block = _device_blocks(driver.desc, driver.n, driver.tile,
                           driver.run.device)
    out: dict = {}
    for ti, tj in driver.sample:
        s = algo.tile_scores(upcast_stream(block(ti)),
                             upcast_stream(block(tj)))
        for k, v in s.items():
            out.setdefault(k, []).append(driver.checked(ti, tj,
                                                        v.cpu().numpy()))
    return {k: np.concatenate(v) for k, v in out.items()}


def readings(name: str, seed: int, seconds: float, controls: list,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The program's and each control's numbers for one seed."""
    import torch

    from portbench.trace import Tracer

    workload, config = R.load_cell(name, overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        driver = importlib.import_module(
            f"portbench.drivers.{workload['driver']}").Driver(
                R.Run(name, workload, config, seed, dev, workdir))
        driver.setup()
        driver.window(seconds, Tracer(False))
        answers = driver.answers()
        ctl = {}
        if "program_default" in controls:
            ctl["program_default"] = program_default(driver)
        driver.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = driver.reference(answers)
        out = {"seed": seed,
               "program": R.compare(answers["program"], ref)}
        for c in controls:
            if c in ("bf16", "fp64"):
                got = driver.reference(answers, dtype={
                    "bf16": torch.bfloat16, "fp64": torch.float64}[c])
            elif c == "tf32":
                with _tf32(True):
                    got = driver.reference(answers)
            else:
                got = ctl[c]
            out[c] = R.compare(got, ref)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", default="bf16,tf32")
    args = ap.parse_args(argv)
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
