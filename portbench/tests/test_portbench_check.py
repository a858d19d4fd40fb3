"""The correctness check: sound runs of the program come out correct, and
the control (the reference in a lower precision in the program's place)
and every fault a cell can have come out not correct, at a size the CPU
holds. The chip's readings at the cells' own sizes are in PERF.md."""

import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _tiny  # noqa: E402

from portbench import control, run as R  # noqa: E402


def _limits(name):
    return R.load_cell(name)[0]["limits"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_sound_run_is_correct(name):
    out = R.run_cell(name, 3000000021, 0.5, False, device="cpu",
                     overrides=_tiny.TINY[name])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["mismatch_pct"]["value"] == 0.0


def _unchanged(driver):
    """The step that writes the scores returns the state unchanged."""
    from acoss_tpu_torch.benchmarking import harness

    real = harness._TileSweeper.flush

    def flush(self):
        self._pending = [(ti, tj, {k: torch.zeros_like(v)
                                   for k, v in s.items()})
                         for ti, tj, s in self._pending]
        return real(self)

    driver._undo = (harness._TileSweeper, "flush", real)
    harness._TileSweeper.flush = flush


def _half_batch(driver):
    """Half of each tile's column songs left out, the mean of the rest in
    their place."""
    real = driver.algo.tile_scores

    def tile_scores(row, col, **kw):
        bj = col["length"].shape[0]
        h = max(bj // 2, 1)
        out = real(row, {k: v[:h] for k, v in col.items()}, **kw)
        return {k: torch.cat([v, v.mean(dim=1, keepdim=True).expand(
            v.shape[0], bj - h)], dim=1) for k, v in out.items()}

    driver.algo.tile_scores = tile_scores


def _altered(driver):
    """One answer of each tile altered where it is produced."""
    real = driver.algo.tile_scores

    def tile_scores(row, col, **kw):
        out = real(row, col, **kw)
        k = sorted(out)[0]
        v = out[k].clone()
        v[0, -1] += 1.0 / 1024
        return dict(out, **{k: v})

    driver.algo.tile_scores = tile_scores


def _dropped(which):
    """The flush leaves the scores of some tiles out: those on the
    diagonal, or those of the last, partial block-row."""
    def fault(driver):
        from acoss_tpu_torch.benchmarking import harness

        real = harness._TileSweeper.flush
        last = driver.n_tiles - 1

        def flush(self):
            self._pending = [
                (ti, tj, s if not (ti == tj if which == "diagonal"
                                   else ti == last)
                 else {k: torch.zeros_like(v) for k, v in s.items()})
                for ti, tj, s in self._pending]
            return real(self)

        driver._undo = (harness._TileSweeper, "flush", real)
        harness._TileSweeper.flush = flush
    return fault


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered, "diagonal_dropped": _dropped("diagonal"),
          "last_row_dropped": _dropped("last_row")}


CASES = [(name, fault) for name in _tiny.CELLS for fault in sorted(FAULTS)
         # covers80's 160 songs fill their last block-row
         if not (fault == "last_row_dropped" and "covers80" in name)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    undo = []

    def hook(driver):
        FAULTS[fault](driver)
        if hasattr(driver, "_undo"):
            undo.append(driver._undo)

    try:
        out = R.run_cell(name, 3000000023, 0.5, False, device="cpu",
                         overrides=_tiny.TINY[name], hooks=hook)
    finally:
        for cls, attr, real in undo:
            setattr(cls, attr, real)
    assert not out["correct"], out["checks"]


def test_bf16_control_is_not_correct():
    name = "serra09-datacos.stream-sweep"
    limits = _limits(name)
    for seed in (3000000031, 3000000037, 3000000041):
        r = control.readings(name, seed, 0.3, ["bf16"], device="cpu",
                             overrides=_tiny.TINY[name])
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["bf16"].items()), r


def test_the_sample_holds_every_stretch_the_diagonal_and_the_last_row():
    """At the stream cell's geometry (1,875 songs, tiles of 16, bands of
    8 block-rows): an off-diagonal tile in each of the CHECK_TILES runs
    of block-rows, a diagonal tile, and a tile of the partial last
    block-row; on the diagonal only the pairs i > j are compared."""
    from portbench.drivers.sweep import CHECK_TILES, Driver

    d = Driver.__new__(Driver)
    d.n, d.tile, d.n_tiles = 1875, 16, 118
    d.bands = [(lo, min(lo + 8, 118)) for lo in range(0, 118, 8)]
    d.done_bands = set(range(len(d.bands)))
    runs = np.array_split(np.arange(118), CHECK_TILES)
    for seed in (3000000061, 3000000067, 2 ** 31 + 11):
        d.run = types.SimpleNamespace(seed=seed)
        tiles = d._pick_tiles()
        assert tiles == d._pick_tiles()
        assert any(ti == tj for ti, tj in tiles)
        assert any(ti == 117 > tj for ti, tj in tiles)
        for run in runs:
            assert any(ti in run and tj < ti for ti, tj in tiles)
    tile = np.arange(16 * 16).reshape(16, 16)
    assert d.checked(3, 1, tile).size == 256
    lower = d.checked(3, 3, tile)
    assert lower.size == 120 and all(v // 16 > v % 16 for v in lower)
