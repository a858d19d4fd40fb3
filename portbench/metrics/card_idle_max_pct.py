"""The idlest card's idle share of the traced stretch of a sweep over
several cards: the stretch's device operations (kernels, copies, memsets)
grouped by the card they ran on, each card's idle share 100 x (1 - the
union of its operations' intervals over the stretch's length), and the
largest of them. A card of the mesh with no operation in the stretch
reads 100."""

from portbench.trace import _union

LAYER = "device"
MOVES = "pairs_per_s"


def card_idle_pct(events, t0: float, t1: float, cards=None) -> dict:
    """{card index: idle share in percent} over [t0, t1] of device events
    (`device_index`, `time_range`), for `cards` (default: every card an
    event ran on)."""
    spans: dict = {c: [] for c in (cards or ())}
    for e in events:
        s, t = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if t > s:
            spans.setdefault(e.device_index, []).append([s, t])
    return {c: 100.0 * (1.0 - sum(t - s for s, t in _union(iv)) / (t1 - t0))
            for c, iv in spans.items()}


def read(tracer, window):
    s = tracer.stretch_data
    if s is None or not s.device:
        return None
    by = card_idle_pct(s.device, *s._t, window.get("cards"))
    return max(by.values())
