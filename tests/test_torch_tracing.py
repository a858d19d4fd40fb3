"""The port's span and counter collector (`utils.profiling.stages`) on the
CPU: nesting and self time, counters, the off path, the profiler ranges,
threads, and the spans of a streamed sweep from an int8 store."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from acoss_tpu_torch.benchmarking import harness
from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data import descstore
from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.utils import profiling


@pytest.fixture
def stages():
    """The process-global collector, empty; the test turns it on, and it
    is left off and empty after the test."""
    st = profiling.stages
    st.reset()
    yield st
    st.enabled = False
    st.reset()


def _names(prof) -> list:
    return [e.name for e in prof.events()]


def test_child_time_comes_out_of_parent_self_time():
    st = profiling.StageTimes()
    st.enabled = True
    with st.stage("sweep:tile"):
        time.sleep(0.002)
        with st.stage("score:tile"):
            time.sleep(0.01)
            with st.stage("store:upcast"):
                time.sleep(0.003)
        with st.stage("store:read"):
            pass
    with st.stage("sweep:tile"):
        pass
    assert st.count == {"sweep:tile": 2, "score:tile": 1,
                        "store:upcast": 1, "store:read": 1}
    children = st.total["score:tile"] + st.total["store:read"]
    assert st.self_total["sweep:tile"] == pytest.approx(
        st.total["sweep:tile"] - children, abs=1e-9)
    assert st.self_total["score:tile"] == pytest.approx(
        st.total["score:tile"] - st.total["store:upcast"], abs=1e-9)
    assert st.self_total["store:upcast"] == st.total["store:upcast"]
    assert st.total["score:tile"] >= 0.013
    assert st.self_total["score:tile"] >= 0.01
    assert st.self_total["sweep:tile"] < st.total["sweep:tile"] - 0.013
    assert set(st.parents) == {(None, "sweep:tile"),
                               ("sweep:tile", "score:tile"),
                               ("score:tile", "store:upcast"),
                               ("sweep:tile", "store:read")}
    assert st.parents[(None, "sweep:tile")] == st.total["sweep:tile"]
    rep = st.report().splitlines()
    assert rep[0].split() == ["stage", "total_s", "self_s", "calls",
                              "per_call_ms", "parent"]
    row = {ln.split()[0]: ln.split() for ln in rep[1:]}
    assert row["score:tile"][3] == "1" and row["score:tile"][5] == \
        "sweep:tile"
    assert row["sweep:tile"][3] == "2" and row["sweep:tile"][5] == "-"


def test_an_exception_closes_the_span():
    st = profiling.StageTimes()
    st.enabled = True
    with pytest.raises(ValueError):
        with st.stage("sweep:tile"):
            with st.stage("score:tile"):
                raise ValueError("boom")
    with st.stage("sweep:flush"):
        pass
    assert st.count == {"sweep:tile": 1, "score:tile": 1, "sweep:flush": 1}
    assert (None, "sweep:flush") in st.parents


def test_counters_only_when_enabled_and_reset_clears_them():
    st = profiling.StageTimes()
    st.add("store:h2d_copies", 6)
    assert not st.counters
    st.enabled = True
    st.add("store:h2d_copies", 6)
    st.add("store:h2d_copies", 0)
    st.add("store:h2d_bytes", 1 << 20)
    assert st.counters == {"store:h2d_copies": 6, "store:h2d_bytes": 1 << 20}
    rep = st.report()
    assert "counter" in rep and "store:h2d_copies" in rep
    st.reset()
    assert not st.counters and not st.total and not st.self_total \
        and not st.parents and not st.count


def test_off_path_records_nothing_and_enters_no_range():
    st = profiling.StageTimes()
    assert st.stage("sweep:tile", ti=0, tj=1) is st.stage("score:tile")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.stage("sweep:tile", ti=0, tj=1):
            with st.stage("score:tile"):
                torch.ones(4) + 1
        st.add("store:h2d_copies", 6)
    assert not st.total and not st.count and not st.counters \
        and not st.parents and not st._labels
    assert not {"sweep:tile", "score:tile"} & set(_names(prof))


def test_no_range_without_a_capture(monkeypatch):
    """On, outside a profiler capture, a span times and enters no range."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(profiling, "_RANGE", refuse)
    st = profiling.StageTimes()
    st.enabled = True
    with st.stage("sweep:tile", ti=0, tj=1):
        pass
    assert st.count["sweep:tile"] == 1 and not st._labels


def test_spans_are_ranges_of_an_active_capture():
    from torch.profiler import ProfilerActivity, profile

    st = profiling.StageTimes()
    st.enabled = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.stage("sweep:tile", ti=2, tj=1):
            with st.stage("score:tile"):
                torch.ones(4) + 1
    ev = {e.name: e for e in prof.events()}
    assert ev["sweep:tile"].cpu_parent is None
    assert ev["score:tile"].cpu_parent.name == "sweep:tile"
    assert ev["aten::add"].cpu_parent.name == "score:tile"
    assert st.count["sweep:tile"] == 1


def test_threads_keep_their_own_nesting_and_lose_no_update():
    """More threads than cores, switching as often as the interpreter
    allows: each thread's spans nest on its own stack, and no count or
    counter update is lost."""
    st = profiling.StageTimes()
    st.enabled = True
    n_threads, n_spans = 4 * (os.cpu_count() or 2), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with st.stage("hybrid:col_tile"):
                    with st.stage("store:read"):
                        st.add("store:h2d_copies", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    n = n_threads * n_spans
    assert st.count == {"hybrid:col_tile": n, "store:read": n}
    assert st.counters["store:h2d_copies"] == n
    assert set(st.parents) == {(None, "hybrid:col_tile"),
                               ("hybrid:col_tile", "store:read")}


class Toy(CoverAlgorithm):
    """A tile is the dot product of two songs' vector frames; `vec` is
    large enough to be stored int8, `length` stays exact."""

    NAME = "toy"
    SIMILARITY_TYPES = ("main",)

    def extract_descriptors(self, fs, device="cpu"):
        return {"vec": np.asarray(fs.feature("vec"), np.float32),
                "length": np.asarray(fs.length("vec"), np.int32)}

    def tile_scores(self, row, col):
        return {"main": torch.einsum("ild,jld->ij", row["vec"],
                                     col["vec"])}


def _store(tmp_path, n=23, L=40):
    rng = np.random.default_rng(4)
    vec = (rng.random((n, L, 6)) + 0.1).astype(np.float32)
    fs = FeatureSet({"vec": vec}, {"vec": np.full(n, L, np.int32)},
                    np.array([f"W{i // 3}" for i in range(n)]),
                    np.array([f"t{i}" for i in range(n)]))
    store = descstore.extract_streamed(Toy(), fs, str(tmp_path / "store"),
                                       chunk_songs=7, quant="int8",
                                       half_min_bytes=256, device="cpu")
    assert store["vec"].dtype == np.int8 and "vec@qscale" in store
    return store


def test_streamed_sweep_spans_nest_under_the_tile(tmp_path, stages):
    store = _store(tmp_path)
    stages.enabled = True
    tile, every, n = 3, 4, 23
    harness.run_pairwise(Toy(), store, n, tile=tile,
                         checkpoint_path=str(tmp_path / "ledger.npz"),
                         checkpoint_every=every,
                         scores_dir=str(tmp_path / "scores"),
                         device_resident=False, device="cpu")
    n_tiles = -(-n // tile)
    tiles = n_tiles * (n_tiles + 1) // 2
    c = stages.count
    assert c["sweep:tile"] == c["score:tile"] == tiles
    assert c["sweep:row"] == n_tiles
    assert c["store:read"] == c["store:h2d"] == c["store:upcast"] \
        == tiles + n_tiles
    assert c["sweep:open"] == 1
    assert c["sweep:scatter"] == c["sweep:flush"] == tiles // every
    # one write a checkpoint's worth of tiles, and the last at finalize
    assert c["sweep:ledger"] == tiles // every + 1
    for (parent, name), _ in stages.parents.items():
        if name.startswith("store:") or name == "score:tile":
            assert parent in ("sweep:tile", "sweep:row"), (parent, name)
        if name.startswith("sweep:"):
            assert parent is None, (parent, name)
    # the descriptors stay on the host here: counted, none copied
    assert stages.counters == {"store:h2d_copies": 0, "store:h2d_bytes": 0}


def test_h2d_counters_count_each_leaf_moved_off_the_host(tmp_path, stages):
    """A column tile of the int8 store is one copy a key, scale companion
    included; a leaf already on the device is not a copy. (The meta device
    stands in for the card here.)"""
    store = _store(tmp_path)
    stages.enabled = True
    cols = harness._tile_slice(store, 3, 6, 3)
    out = harness._upload(cols, "meta")
    assert all(v.device.type == "meta" for v in out.values())
    assert stages.counters["store:h2d_copies"] == len(store) == 3
    assert stages.counters["store:h2d_bytes"] == sum(
        v.nbytes for v in cols.values())
    harness._upload(out, "meta")
    assert stages.counters["store:h2d_copies"] == 3


def test_tile_args_reach_the_trace_of_a_cli_style_capture(tmp_path, stages):
    logdir = str(tmp_path / "trace")
    stages.enabled = True
    with profiling.device_trace(logdir):
        for tj in (0, 1):
            with stages.stage("sweep:tile", ti=3, tj=tj):
                with stages.stage("score:tile"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").endswith(":tile")]
    tiles = sorted((e for e in ev if e["name"] == "sweep:tile"),
                   key=lambda e: e["ts"])
    assert [e["args"]["span"] for e in tiles] == ["ti=3 tj=0", "ti=3 tj=1"]
    assert [e for e in ev if e["name"] == "score:tile"]
    assert all("span" not in e["args"] for e in ev
               if e["name"] == "score:tile")
    assert not stages._labels
