"""Tracing and stage timing on `torch.profiler` (port of
`acoss_tpu.utils.profiling`).

- `device_trace(logdir)`: a `torch.profiler` capture of everything inside
  the context (CPU activity, and CUDA kernels when a card is present),
  written to `logdir/trace.json` in the Chrome trace format (open it in
  ui.perfetto.dev or chrome://tracing). The sweeps label each tile with
  `step_annotation`, so the trace is navigable tile by tile.
- `stages`: a process-global wall-clock accumulator for coarse pipeline
  stages (extract / sweep:tile / sweep:flush / eval ...). CUDA work is
  asynchronous, so a stage that ends in device tensors passes them to
  `stages.block()` to be charged where they are computed. Enabled by the
  CLI's `--stage-times`; when off, `stage()` and `block()` do nothing, so
  a run without the flag gains no synchronisation.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


class StageTimes:
    """Accumulating per-stage wall timings, gated by `enabled` (set by the
    CLI's --stage-times)."""

    def __init__(self):
        self.enabled = False
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def reset(self):
        self.total.clear()
        self.count.clear()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def block(self, value):
        """Wait for the CUDA devices of the tensors in `value` (a tensor,
        or dicts / lists / tuples of them) so the enclosing stage's time
        includes their execution; only when stages are enabled. Returns
        `value`."""
        if self.enabled:
            for dev in {t.device for t in _tensors(value)
                        if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
        return value

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k, _ in rows), default=5)
        lines = [f"{'stage':<{width}}  {'total_s':>9}  {'calls':>7}  "
                 f"{'per_call_ms':>11}"]
        for k, t in rows:
            n = self.count[k]
            lines.append(f"{k:<{width}}  {t:>9.3f}  {n:>7}  "
                         f"{1000 * t / max(n, 1):>11.2f}")
        return "\n".join(lines)


#: process-global stage collector (the CLI enables and prints it)
stages = StageTimes()


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """Capture a `torch.profiler` trace of the block into
    `logdir/trace.json` (no-op when `logdir` is None): CPU activity, and
    CUDA activity when a CUDA device is present."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def step_annotation(name: str, **kwargs):
    """A `torch.profiler.record_function` range labelling one sweep tile
    or panel inside a `device_trace` capture, e.g. "tile ti=3 tj=1"."""
    label = " ".join([name] + [f"{k}={v}" for k, v in kwargs.items()])
    return torch.profiler.record_function(label)
