"""Tracing and stage timing on `torch.profiler` (port of
`acoss_tpu.utils.profiling`).

- `stages`: the process-global collector of the program's spans and
  counters. A span (`with stages.stage("sweep:tile", ti=3, tj=1):`) is a
  named stretch of host wall time; the prefix names its layer (`store:`,
  `score:`, `sweep:`, `hybrid:`, ...). Spans nest per thread: on exit a
  span adds its duration to `total` and `count`, its duration less its
  child spans' to `self_total`, and its duration to `parents[(parent,
  name)]`. They are kept as these aggregates, never as a list, so a long
  sweep costs no memory. `stages.add(name, n)` adds to `counters`
  (callers compute `n` only under `if stages.enabled`).
  While a `torch.profiler` capture is active, each span is also a
  profiler range of the same name (a `record_function`), so the spans
  sit on the timeline of the kernels they launch, and its keyword
  arguments are kept as its label (`"ti=3 tj=1"`); without a capture no
  range is entered.
  CUDA work is asynchronous, so a span's time is the host's: a stage
  that must end in device tensors passes them to `stages.block()` to be
  charged where they are computed.
  Off by default: the CLI's `--stage-times` and `--profile` turn it on
  (the benchmark's traced window too). Off, `stage()` returns one shared
  null context and `add()` and `block()` return at once, so a run without
  them gains no synchronisation and no profiler range.
- `device_trace(logdir)`: a `torch.profiler` capture of everything inside
  the context (CPU activity, and CUDA kernels when a card is present),
  written to `logdir/trace.json` in the Chrome trace format (open it in
  ui.perfetto.dev or chrome://tracing), each span's label under the key
  `span` of its event's `args`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"

#: what `StageTimes.stage` returns while the collector is off
_OFF = contextlib.nullcontext()
#: a profiler range: the C++ range, without the operator call and the
#: Python object of `torch.profiler.record_function`, where this torch
#: has it (a span's cost under a capture: PERF.md)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


class _Span:
    """One open span: its name, its keyword arguments, its start, the
    seconds its child spans took so far, and its profiler range if one
    was entered."""

    __slots__ = ("times", "name", "args", "t0", "child", "range")

    def __init__(self, times: "StageTimes", name: str, args: dict):
        self.times = times
        self.name = name
        self.args = args

    def __enter__(self):
        stack = self.times._stack()
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = _RANGE(self.name)
            self.range.__enter__()
            if self.args:
                self.times._label(self.name, self.args)
        stack.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = self.times._stack()
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child += dt
        self.times._record(self.name, dt, dt - self.child,
                           parent.name if parent is not None else None)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class StageTimes:
    """The program's spans and counters, gated by `enabled`."""

    def __init__(self):
        self.enabled = False
        self.total = defaultdict(float)
        self.self_total = defaultdict(float)
        self.count = defaultdict(int)
        #: (parent, name) -> seconds of `name` spent under `parent`
        #: (parent None at the top of a thread)
        self.parents = defaultdict(float)
        self.counters = defaultdict(int)
        # (native thread id, name) -> the keyword arguments of each
        # profiler range the span entered, in order: a range keeps no text
        # in the trace, so `device_trace` writes them in as labels
        self._labels = defaultdict(list)
        self._local = threading.local()
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            for d in (self.total, self.self_total, self.count, self.parents,
                      self.counters, self._labels):
                d.clear()

    def stage(self, name: str, **args):
        """A span named `name` (a context manager); keyword arguments are
        its profiler range's label, kept only inside a capture."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, args)

    def add(self, name: str, n: int) -> None:
        """Add `n` to the counter `name` (only when enabled)."""
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] += n

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            # the thread's id as the profiler records it, read once: a
            # system call, tens of microseconds on some hosts
            self._local.tid = threading.get_native_id()
            return self._local.stack

    def _record(self, name: str, dt: float, own: float, parent) -> None:
        with self._lock:
            self.total[name] += dt
            self.self_total[name] += own
            self.count[name] += 1
            self.parents[(parent, name)] += dt

    def _label(self, name: str, args: dict) -> None:
        """Keep a range's keyword arguments (on the thread of `_stack`)."""
        with self._lock:
            self._labels[(self._local.tid, name)].append(args)

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
        """Each span's total and self seconds, calls, milliseconds a call
        and the parent it spent most time under ("-": none), largest total
        first; then the counters."""
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        width = max([len(k) for k, _ in rows] + [len(k) for k in
                                                  self.counters] + [7])
        under = {}
        for (parent, name), t in self.parents.items():
            if name not in under or t > under[name][1]:
                under[name] = (parent or "-", t)
        lines = [f"{'stage':<{width}}  {'total_s':>9}  {'self_s':>9}  "
                 f"{'calls':>7}  {'per_call_ms':>11}  parent"]
        for k, t in rows:
            n = self.count[k]
            lines.append(f"{k:<{width}}  {t:>9.3f}  "
                         f"{self.self_total[k]:>9.3f}  {n:>7}  "
                         f"{1000 * t / max(n, 1):>11.3f}  {under[k][0]}")
        if self.counters:
            lines.append(f"{'counter':<{width}}  {'value':>9}")
            for k, v in sorted(self.counters.items()):
                lines.append(f"{k:<{width}}  {v:>9}")
        return "\n".join(lines)


#: process-global span collector (the CLI enables and prints it)
stages = StageTimes()


def _write_labels(path: str, labels: dict) -> None:
    """Put each span's label (`ti=3 tj=1`) into its range's event of the
    Chrome trace at `path`, under `span`: the k-th range of a name on a
    thread gets the k-th arguments recorded for it."""
    with open(path) as f:
        trace = json.load(f)
    seen = defaultdict(int)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"
              and e.get("cat") in ("cpu_op", "user_annotation")
              and (e.get("tid"), e.get("name")) in labels]
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        key = (e["tid"], e["name"])
        k = seen[key]
        seen[key] += 1
        if k < len(labels[key]):
            e.setdefault("args", {})["span"] = " ".join(
                f"{a}={v}" for a, v in labels[key][k].items())
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """Capture a `torch.profiler` trace of the block into
    `logdir/trace.json` (no-op when `logdir` is None): CPU activity, and
    CUDA activity when a CUDA device is present. The spans of an enabled
    `stages` are ranges of the capture, with their labels."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with stages._lock:
        stages._labels.clear()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with stages._lock:
        labels = dict(stages._labels)
        stages._labels.clear()
    if labels:
        _write_labels(path, labels)
