"""The readers of the program's spans and counters: `portbench/spans.py`
puts a synthetic timeline's idle down to its spans exactly, a traced tiny
run of each cell reports every span and counter metric, and against a
program without these spans and counters every reader reports nothing
and raises nothing."""

import os
import sys
from types import SimpleNamespace as NS

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _tiny  # noqa: E402

from portbench import run as R, spans  # noqa: E402

SPAN_METRICS = {
    "serra09-datacos.stream-sweep": (
        "store_host_ms.stream", "h2d_copies_per_tile.stream",
        "score_host_ms.stream", "writeback_pct.stream"),
    "earlysnf-covers80.sweep": ("score_host_ms.resident",
                                "writeback_pct.resident"),
}
IDLE_METRICS = ("idle_store_pct.stream", "idle_score_pct.stream",
                "idle_engine_pct.stream")


def _event(name, start, end):
    return NS(name=name, time_range=NS(start=start, end=end))


def _stretch(host, busy, t=(0.0, 100.0)):
    """A stand-in for `portbench.trace.Stretch`: times in microseconds."""
    return NS(_host=host, busy=busy, _t=t, ops=[("k", *b) for b in busy],
              window_s=(t[1] - t[0]) / 1e6)


# the main thread, 0-100 us:
#   sweep:tile 10-60 { store:read 12-20, aten::copy_ 14-16,
#                      score:tile 25-55 { store:upcast 30-35 } }
#   sweep:flush 70-80
# device busy 0-11, 18-32, 40-50, 75-90; idle 11-18, 32-40, 50-75, 90-100
HOST = [_event("sweep:tile", 10, 60), _event("store:read", 12, 20),
        _event("aten::copy_", 14, 16), _event("score:tile", 25, 55),
        _event("store:upcast", 30, 35), _event("sweep:flush", 70, 80),
        _event("portbench::kernel::qmax", 40, 45)]
BUSY = [[0, 11], [18, 32], [40, 50], [75, 90]]


def test_innermost_span_timeline():
    prog = [(e.time_range.start, e.time_range.end, e.name) for e in HOST
            if spans.PROGRAM.match(e.name)]
    assert {p[2] for p in prog} == {"sweep:tile", "store:read",
                                    "score:tile", "store:upcast",
                                    "sweep:flush"}
    assert spans.innermost(prog) == [
        (10, 12, "sweep:tile"), (12, 20, "store:read"),
        (20, 25, "sweep:tile"), (25, 30, "score:tile"),
        (30, 35, "store:upcast"), (35, 55, "score:tile"),
        (55, 60, "sweep:tile"), (70, 80, "sweep:flush")]
    # a child that outlasts its parent is cut at the parent's end
    assert spans.innermost([(0, 10, "a:x"), (5, 12, "b:y")]) == [
        (0, 5, "a:x"), (5, 10, "b:y")]


def test_idle_is_put_down_to_the_innermost_span_exactly():
    s = _stretch(HOST, BUSY)
    assert spans.idle_intervals(BUSY, 0.0, 100.0) == [
        (11, 18), (32, 40), (50, 75), (90, 100)]
    by = {k: round(v * 1e6, 9) for k, v in spans.idle_by_span(s).items()}
    # 11-12 sweep:tile, 12-18 store:read; 32-35 store:upcast, 35-40
    # score:tile; 50-55 score:tile, 55-60 sweep:tile, 60-70 none, 70-75
    # sweep:flush; 90-100 none
    assert by == {"sweep:tile": 6.0, "store:read": 6.0,
                  "store:upcast": 3.0, "score:tile": 10.0,
                  "sweep:flush": 5.0, None: 20.0}
    assert spans.idle_pct(s, "store:") == pytest.approx(9.0)
    assert spans.idle_pct(s, "score:") == pytest.approx(10.0)
    assert spans.idle_pct(s, "sweep:") == pytest.approx(11.0)
    # the shares and the unattributed part make the whole idle
    assert sum(by.values()) == pytest.approx(50.0)


def test_no_program_span_or_no_device_gives_nothing():
    aten = [_event("aten::mm", 0, 50), _event("tile ti=3 tj=1", 0, 60)]
    assert spans.idle_by_span(_stretch(aten, BUSY)) is None
    assert spans.idle_pct(_stretch(HOST, []), "store:") is None
    assert spans.idle_pct(None, "store:") is None


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_traced_tiny_run_reports_the_span_metrics(name):
    out = R.run_cell(name, 3000000037, 0.3, True, device="cpu",
                     overrides=_tiny.TINY[name])
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for m in SPAN_METRICS[name]:
        assert m in got and got[m]["value"] >= 0, m
    if name == "serra09-datacos.stream-sweep":
        # nothing leaves the host on the CPU: counted, and none
        assert got["h2d_copies_per_tile.stream"]["value"] == 0.0
        assert got["score_host_ms.stream"]["value"] \
            <= got["tile_host_ms.stream"]["value"]
    # no device events on the CPU: the idle shares read nothing
    for m in IDLE_METRICS:
        assert m not in got


def test_a_program_without_the_spans_reports_nothing(monkeypatch):
    """The readers against what a program without these spans and
    counters leaves: stage totals without them, a collector without
    `counters`, a stretch whose ranges are not program spans."""
    from acoss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "stages", NS(total={}, count={}))
    tracer = NS(stages=({"sweep:tile": 1.0, "sweep:flush": 0.1},
                        {"sweep:tile": 100, "sweep:flush": 2}),
                stretch_data=_stretch([_event("tile ti=0 tj=0", 0, 90)],
                                      BUSY))
    window = {"seconds": 10.0}
    for ms in (*SPAN_METRICS.values(), IDLE_METRICS):
        for m in ms:
            assert R.load_metric(m).read(tracer, window) is None, m
