"""The traced run's readings: a `torch.profiler` capture of one bounded,
steady stretch of the window, reduced to device intervals, kernel calls
and idle gaps, plus the program's stage timers over the whole window.

Spans are the benchmark's own: `record_function` ranges around the
stretch and around each kernel wrapper the roofline modules name, put in
place from outside for the stretch alone (as a spy, never an edit of the
program). The work a wrapper's call needs is counted from its inputs after
the stretch, so the count adds no synchronisation inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import os

from portbench import peaks

STRETCH = "portbench::stretch"
WRAPPER = "portbench::kernel::"


def _union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A device operation's name without its return type and argument
    list."""
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k] if k else name
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:120].strip()


class Stretch:
    """What the profiler saw in one stretch: times in seconds."""

    def __init__(self, events, units: int, calls: dict, kernels: dict):
        from torch.autograd import DeviceType

        self.units = units
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        mark = [e for e in cpu if e.name == STRETCH]
        if not mark:
            raise RuntimeError("the profiler recorded no stretch range")
        t0, t1 = mark[0].time_range.start, mark[0].time_range.end
        self.window_s = (t1 - t0) / 1e6
        # device operations: kernels, copies, memsets; the device-side
        # spans of the record_function ranges are left out
        notes = {e.name for e in cpu if e.is_user_annotation}
        self.device = [e for e in events
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation and e.name not in notes
                       and e.time_range.end > e.time_range.start]
        self.ops = [(e.name, e.time_range.start, e.time_range.end)
                    for e in self.device]
        self.busy = _union([[max(s, t0), min(e, t1)]
                            for _, s, e in self.ops if e > t0 and s < t1])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.kernel_ops = [o for o in self.ops
                           if not o[0].startswith(("Memcpy", "Memset"))]
        self.h2d_s = sum(e - s for n, s, e in self.ops
                         if n.startswith("Memcpy HtoD")) / 1e6
        self._t = (t0, t1)
        main = mark[0].thread
        self._host = sorted((e for e in cpu if e.thread == main
                             and e.name != STRETCH),
                            key=lambda e: e.time_range.start)
        self._starts = [e.time_range.start for e in self._host]
        by_id = {e.id: e for e in cpu}
        self.wrapper_of = [self._wrapper(by_id.get(
            getattr(e, "linked_correlation_id", 0))) for e in self.device]
        self.roofline = {k: self._roofline(k, calls[k], kernels[k])
                         for k in calls}

    @staticmethod
    def _wrapper(event) -> str | None:
        """The kernel wrapper whose range encloses the CPU event that
        launched a device operation, if any."""
        while event is not None:
            if event.name.startswith(WRAPPER):
                return event.name[len(WRAPPER):]
            event = event.cpu_parent
        return None

    def _roofline(self, name: str, calls: list, module) -> float | None:
        """100 x the least seconds the calls' work needs at the peaks over
        the seconds the device spent in the calls' kernels; None without
        a call or a kernel."""
        if not calls:
            return None
        mine = [e for e, w in zip(self.device, self.wrapper_of)
                if w == name and not e.name.startswith(("Memcpy", "Memset"))]
        if not mine:
            # no launch recorded under the wrapper's range: its kernels by
            # name
            mine = [e for e in self.device
                    if any(k in e.name for k in module.KERNELS)]
        spent = sum(e.time_range.end - e.time_range.start for e in mine)
        if spent <= 0:
            return None
        least = sum(peaks.least_seconds(*c) for c in calls)
        return 100.0 * least / (spent / 1e6)

    def _host_at(self, t: float) -> str:
        """The innermost host event of the main thread running at `t`."""
        k = bisect.bisect_right(self._starts, t) - 1
        for _ in range(4096):
            if k < 0:
                break
            e = self._host[k]
            if e.time_range.end >= t:
                return e.name
            k -= 1
        return "host"

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten host
        activities under which the device stood idle longest."""
        by_op: dict = {}
        for n, s, e in self.ops:
            by_op[_short(n)] = by_op.get(_short(n), 0.0) + (e - s) / 1e6
        t0, t1 = self._t
        edges = [t0] + [x for iv in self.busy for x in iv] + [t1]
        by_host: dict = {}
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e > s:
                name = self._host_at(0.5 * (s + e))
                by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


class Tracer:
    """Records the traced run: the program's stage timers over the window
    and one profiled stretch."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.stretch_data: Stretch | None = None
        self.stages = ({}, {})
        self.kernels = {}
        if enabled:
            here = os.path.join(os.path.dirname(__file__), "roofline")
            for fn in sorted(os.listdir(here)):
                if fn.endswith(".py") and not fn.startswith("_"):
                    self.kernels[fn[:-3]] = importlib.import_module(
                        f"portbench.roofline.{fn[:-3]}")

    @contextlib.contextmanager
    def window(self):
        """The program's stage timers on for the window (traced run only):
        they read the host clock and add no synchronisation."""
        if not self.enabled:
            yield
            return
        from acoss_tpu_torch.utils import profiling

        profiling.stages.reset()
        profiling.stages.enabled = True
        try:
            yield
        finally:
            profiling.stages.enabled = False
            self.stages = ({k: v for k, v in profiling.stages.total.items()},
                           {k: v for k, v in profiling.stages.count.items()})

    @contextlib.contextmanager
    def _spies(self, calls: dict):
        import torch

        undo = []
        for name, module in self.kernels.items():
            calls[name] = []
            for mod_name, attr in module.TARGETS:
                mod = importlib.import_module(mod_name)
                real = getattr(mod, attr)

                def spy(*args, _real=real, _name=name, _module=module,
                        **kwargs):
                    calls[_name].append(_module.record(*args, **kwargs))
                    with torch.profiler.record_function(WRAPPER + _name):
                        return _real(*args, **kwargs)

                # a wrapper counts its launches through its module-level
                # name, which is the spy while it is in place there: the
                # spy's count goes back to the wrapper's after the stretch
                spy.launches = 0
                setattr(mod, attr, spy)
                undo.append((mod, attr, real, spy))
        try:
            yield
        finally:
            for mod, attr, real, spy in reversed(undo):
                if hasattr(real, "launches"):
                    real.launches += spy.launches
                setattr(mod, attr, real)

    @contextlib.contextmanager
    def stretch(self, units: int):
        """Profile the block, which runs `units` tiles and must
        not be the run's first; a no-op when the run is not traced or a
        stretch was profiled already."""
        if not self.enabled or self.stretch_data is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        calls: dict = {}
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        if cuda:
            torch.cuda.synchronize()
        with self._spies(calls), profile(activities=activities) as prof:
            with torch.profiler.record_function(STRETCH):
                yield
                if cuda:
                    torch.cuda.synchronize()
        calls = {k: [module_call() for module_call in v]
                 for k, v in calls.items()}
        self.stretch_data = Stretch(prof.events(), units, calls,
                                    self.kernels)
