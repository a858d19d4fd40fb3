"""Run one cell of the benchmark once, on the machine it is started on.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is `portbench/workloads/<cell>.json`: a configuration
(`portbench/configs/<config>.json`), a traffic driver
(`portbench/drivers/<driver>.py`) and its parameters. The run makes its
inputs from the seed, sets the program under test (acoss_tpu_torch) up
and warms every shape it will use, measures for `--seconds` seconds, then
holds a seeded sample of what the window produced against the plain
reference (`portbench/reference/`). The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics, each read
by `portbench/metrics/<metric>.py`), `device`, with `--trace 1` a
`breakdown`, and last `checks`: each number compared beside its limit,
which are also the last lines of standard error.

It needs as many CUDA devices as the cell asks for and exits nonzero,
printing no result, without them; it never falls back to the CPU. It also
refuses to print a result if JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import copy
import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "acoss_tpu")


_IMPORTED = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, overrides: dict | None = None) -> tuple:
    """(workload, config) of the cell `name`, found by name; `overrides`
    ({"workload": {...}, "config": {...}}) is merged in (tests shrink a
    cell with it)."""
    overrides = overrides or {}
    workload = _merge(_json(os.path.join(HERE, "workloads", f"{name}.json")),
                      overrides.get("workload", {}))
    config = _merge(_json(os.path.join(HERE, "configs",
                                       f"{workload['config']}.json")),
                    overrides.get("config", {}))
    return workload, config


def quantity(name: str) -> str:
    """What a metric measures: its name, less the part after its last dot
    where the quantity is split by cells (`pairs_per_s.stream`)."""
    return name.rsplit(".", 1)[0]


def load_metric(name: str):
    """`portbench/metrics/<name>.py`, or the reader of its quantity,
    `portbench/metrics/<quantity>.py`, by path (names hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{quantity(name)}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_metrics(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports (`workloads` lists them
    where a metric is not reported by every cell)."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def layer_metrics(bench: dict, cell: str) -> list:
    """The per-layer metrics a traced run of the cell reads: those listing
    it, and those without `workloads` that move an end-to-end metric the
    cell reports."""
    ends = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in ends)]


class Run:
    """What a driver is given: the cell, the seed, the device and a
    scratch directory under TMPDIR that the run deletes at its end."""

    def __init__(self, name: str, workload: dict, config: dict, seed: int,
                 device, workdir: str):
        self.name = name
        self.workload = workload
        self.traffic = workload["traffic"]
        self.config = config
        # the generators take any whole number >= 0
        self.seed = int(seed) % 2 ** 63
        self.device = device
        self.workdir = workdir


def compare(program: dict, reference: dict) -> dict:
    """The numbers the check compares, over every score of the sample:
    `mismatch_pct`, the share of scores not equal to the reference's, and
    `gap_max`, the largest absolute gap between the two."""
    import numpy as np

    n = bad = 0
    gap = 0.0
    for k, want in reference.items():
        got = np.asarray(program[k], np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape:
            raise ValueError(f"{k}: program {got.shape} vs reference "
                             f"{want.shape}")
        d = np.abs(got - want)
        d[np.isnan(d)] = np.inf
        n += d.size
        bad += int((d > 0).sum())
        gap = max(gap, float(d.max()) if d.size else 0.0)
    if n == 0:
        raise ValueError("the sample holds no score")
    return {"mismatch_pct": 100.0 * bad / n, "gap_max": gap}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             hooks=None) -> dict:
    """Run the cell once and return the result line's object. `device`
    "cpu" runs the plain versions (tests only: `main` never passes it);
    `hooks(driver)` may plant a fault in the program after set-up."""
    t_age = process_age()
    t_mono = time.perf_counter()
    workload, config = load_cell(name, overrides)
    bench = manifest()
    import torch

    from portbench.trace import Tracer

    # the windows call run_pairwise and CoverIndex directly, outside
    # benchmark() and the CLI, which switch TF32 off: TF32 flips kNN
    # decisions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        driver_mod = importlib.import_module(
            f"portbench.drivers.{workload['driver']}")
        run = Run(name, workload, config, seed, dev, workdir)
        driver = driver_mod.Driver(run)
        driver.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = t_age + (time.perf_counter() - t_mono)
        if hooks is not None:
            hooks(driver)
        tracer = Tracer(trace)
        with tracer.window():
            window = driver.window(seconds, tracer)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        answers = driver.answers()
        driver.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = compare(answers["program"], driver.reference(answers))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    limits = workload["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        for m in layer_metrics(bench, name):
            value = load_metric(m["name"]).read(tracer, window)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = dict(window["metrics"], setup_s=setup_s)
        metrics = {}
        for m in end_to_end_metrics(bench, name):
            value = e2e.get(m["name"], e2e.get(quantity(m["name"])))
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = ({"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
             "count": int(workload["chips"])} if dev.type == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 0})
    info["memory_peak_bytes"] = int(peak)
    out = {"correct": correct, "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": info}
    if trace and tracer.stretch_data is not None:
        s = tracer.stretch_data
        info["busy_s"] = s.busy_s
        info["window_s"] = s.window_s
        out["breakdown"] = s.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, _ = load_cell(args.workload)
    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" (no CPU fallback)", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not read"
    print(f"card {card}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
