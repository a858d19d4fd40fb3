"""The device's idle time put down to the program's spans: over the traced
stretch, the intervals in which no device operation ran, intersected with
the timeline of the innermost program span of the stretch's main thread.

A program span is a `record_function` range the program enters for each
span of `acoss_tpu_torch.utils.profiling.stages` while a profiler
captures; its name is `<layer>:<what>` (`sweep:tile`, `score:tile`,
`store:h2d`), with one colon, unlike the profiler's own `aten::` and the
benchmark's `portbench::` names. Overlaps are exact, not sampled: idle
under no program span stays unattributed. A program that enters no such
range gives no attribution (None), so the readers report nothing there.
"""

from __future__ import annotations

import re

#: a program span's name: a layer prefix with one colon, then a name
PROGRAM = re.compile(r"^[A-Za-z0-9_+]+:[^:]")


def innermost(spans: list) -> list:
    """Disjoint, sorted (start, end, name) pieces of a properly nested set
    of (start, end, name) spans of one thread: at each instant, the
    innermost span open then. A child that outlasts its parent is cut at
    the parent's end."""
    out: list = []
    stack: list = []
    cur = None

    def close(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
            cur = max(cur, end)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if stack:
            close(s)
        if stack and s > cur:
            out.append((cur, s, stack[-1][1]))
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, name))
        cur = s
    if stack:
        close(float("inf"))
    return out


def idle_intervals(busy: list, t0: float, t1: float) -> list:
    """The complement of the merged, sorted `busy` intervals within
    [t0, t1]."""
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def overlap(pieces: list, gaps: list) -> dict:
    """Seconds-per-unit of each piece name's overlap with the gaps (both
    disjoint and sorted): {name: overlap}, and under None the part of
    the gaps no piece covers."""
    out: dict = {}
    covered = 0.0
    i = 0
    for gs, ge in gaps:
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            s, e = max(gs, pieces[j][0]), min(ge, pieces[j][1])
            if e > s:
                out[pieces[j][2]] = out.get(pieces[j][2], 0.0) + (e - s)
                covered += e - s
            j += 1
    out[None] = sum(e - s for s, e in gaps) - covered
    return out


def idle_by_span(stretch) -> dict | None:
    """{innermost program span's name: idle seconds} over a traced
    `portbench.trace.Stretch`, with the idle under no span under None;
    None where the stretch has no device operation or no program span."""
    if stretch is None or not stretch.ops:
        return None
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in stretch._host if PROGRAM.match(e.name)]
    if not spans:
        return None
    t0, t1 = stretch._t
    gaps = idle_intervals(stretch.busy, t0, t1)
    # profiler times are in microseconds
    return {k: v / 1e6 for k, v in overlap(innermost(spans), gaps).items()}


def idle_pct(stretch, prefix: str) -> float | None:
    """100 x the stretch's idle seconds under an innermost program span
    whose name starts with `prefix`, over the stretch's seconds."""
    by = idle_by_span(stretch)
    if by is None:
        return None
    return 100.0 * sum(v for k, v in by.items()
                       if k is not None and k.startswith(prefix)) \
        / stretch.window_s
