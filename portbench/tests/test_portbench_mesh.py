"""The mesh cell (`serra09-datacos-mesh4.fold-sweep`, `drivers/mesh.py`):
its files found by name, a sound run of a tiny corpus correct on the CPU,
each fault a fold can have and the bf16 control not correct, the per-card
idle reader against a synthetic timeline, and on a host with four cards a
short run of the cell itself (marked `cuda`; it skips without them):

    python -m pytest --noconftest -p no:cacheprovider \
        portbench/tests/test_portbench_mesh.py
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace as NS

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, run as R  # noqa: E402

CELL = "serra09-datacos-mesh4.fold-sweep"
#: 30 songs over 4 CPU slots in column tiles of 2: chunks of 4 songs, the
#: last holding 2 songs and 2 of padding, and a pair below the diagonal
#: in some block of every slot
TINY = {"config": {"corpus": {"n_cliques": 7, "clique_size": 3,
                              "n_distractors": 9, "n_states": 12,
                              "base_duration": 60.0, "width": None}},
        "workload": {"traffic": {"col_tile": 2}}}


def test_the_cell_finds_its_files_by_name():
    workload, config = R.load_cell(CELL)
    assert workload["driver"] == "mesh" and workload["chips"] == 4
    assert config["name"] == "serra09-datacos-mesh4" and "store" not in config
    bench = R.manifest()
    assert [m["name"] for m in R.layer_metrics(bench, CELL)] == [
        "card_idle_max_pct.mesh", "enqueue_host_ms.mesh", "gather_pct.mesh"]
    ends = [m["name"] for m in R.end_to_end_metrics(bench, CELL)]
    assert "setup_s" in ends and len(ends) == 2


def _run(seed, hooks=None, trace=False):
    return R.run_cell(CELL, seed, 0.2, trace, device="cpu", overrides=TINY,
                      hooks=hooks)


def test_sound_run_is_correct_and_samples_every_slot():
    seen = {}
    out = _run(3000000071, lambda driver: seen.update(driver=driver))
    assert out["correct"], out["checks"]
    assert out["checks"]["mismatch_pct"]["value"] == 0.0
    d = seen["driver"]
    kinds = [k for k, _, _ in d.sample]
    # a tile of each of the 4 slots' blocks, the mirror, the diagonal and
    # the last partial row of tiles
    assert kinds.count("lower") == 5 and "upper" in kinds
    assert "diagonal" in kinds and d.sample[-1][1] == 14


def test_traced_run_reports_the_span_metrics():
    """15 songs (one call a block: the profiled sweep of the plain CPU
    path is slow under a capture): the span readers read, the device
    trace has nothing to read on the CPU."""
    small = {"config": {"corpus": dict(TINY["config"]["corpus"],
                                       n_cliques=4, n_distractors=3)},
             "workload": TINY["workload"]}
    out = R.run_cell(CELL, 3000000071, 0.2, True, device="cpu",
                     overrides=small)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["enqueue_host_ms.mesh"]["value"] > 0
    assert got["gather_pct.mesh"]["value"] > 0
    assert "card_idle_max_pct.mesh" not in got


def _zero_slot(slot):
    """The blocks of one slot of the fold zeroed in every sweep's
    matrices (and in their mirror)."""
    def fault(driver):
        from acoss_tpu_torch.parallel.mesh import fold_blocks

        real = driver._sweep
        c = driver.chunk

        def sweep():
            Ds = real()
            for rc, cc in fold_blocks(len(driver.devices))[slot]:
                for D in Ds.values():
                    D[rc * c:(rc + 1) * c, cc * c:(cc + 1) * c] = 0
                    D[cc * c:(cc + 1) * c, rc * c:(rc + 1) * c] = 0
            return Ds

        driver._sweep = sweep
    return fault


def _matrices(change):
    def fault(driver):
        real = driver._sweep
        driver._sweep = lambda: {k: change(D) for k, D in real().items()}
    return fault


FAULTS = {
    "slot_0_zeroed": _zero_slot(0),
    "slot_3_zeroed": _zero_slot(3),
    "mirror_dropped": _matrices(lambda D: np.tril(D, -1)),
    "diagonal_nonzero": _matrices(lambda D: D + np.diag(np.full(
        D.shape[0], 0.5, np.float32))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    out = _run(3000000073, FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_bf16_control_is_not_correct():
    limits = R.load_cell(CELL)[0]["limits"]
    for seed in (3000000079, 3000000083):
        r = control.readings(CELL, seed, 0.2, ["bf16"], device="cpu",
                             overrides=TINY)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["bf16"].items()), r


def _op(card, start, end):
    return NS(device_index=card, time_range=NS(start=start, end=end))


def test_card_idle_reads_each_card_and_reports_the_idlest():
    """Two cards over a stretch of 0-100 us: card 0 busy 0-50 and 40-90
    (idle 10%), card 1 busy 95-120 (idle 95%, the part past the stretch
    left out); a card of the mesh with no operation reads 100."""
    reader = R.load_metric("card_idle_max_pct.mesh")
    ops = [_op(0, 0, 50), _op(0, 40, 90), _op(1, 95, 120)]
    assert reader.card_idle_pct(ops, 0.0, 100.0) == pytest.approx(
        {0: 10.0, 1: 95.0})
    tracer = NS(stretch_data=NS(device=ops, _t=(0.0, 100.0)))
    assert reader.read(tracer, {"cards": [0, 1]}) == pytest.approx(95.0)
    assert reader.read(tracer, {"cards": [0, 1, 2]}) == pytest.approx(100.0)
    assert reader.read(NS(stretch_data=None), {}) is None
    assert reader.read(NS(stretch_data=NS(device=[], _t=(0, 1))), {}) \
        is None


def test_span_readers_read_the_mesh_spans():
    """The enqueue time a call, and the gather's share of the sweeps'
    seconds (a traced window's profiler read-back is outside them)."""
    tracer = NS(stages=({"mesh:enqueue": 2.0, "mesh:gather": 0.2,
                         "mesh:fold": 0.05},
                        {"mesh:enqueue": 1000, "mesh:gather": 36,
                         "mesh:fold": 1}))
    window = {"seconds": 100.0, "sweep_seconds": 5.0}
    assert R.load_metric("enqueue_host_ms.mesh").read(tracer, window) \
        == pytest.approx(2.0)
    assert R.load_metric("gather_pct.mesh").read(tracer, window) \
        == pytest.approx(5.0)


def test_a_program_without_the_mesh_spans_reports_nothing():
    tracer = NS(stages=({"sweep:tile": 1.0}, {"sweep:tile": 10}))
    window = {"seconds": 1.0, "sweep_seconds": 1.0}
    for m in ("enqueue_host_ms.mesh", "gather_pct.mesh"):
        assert R.load_metric(m).read(tracer, window) is None


@pytest.mark.cuda
def test_the_cell_runs_correct_on_four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (the cell's mesh)")
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "3000000089", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
