"""The rate is taken over the whole window: a stall put into the window
moves it."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _tiny  # noqa: E402

from portbench import run as R  # noqa: E402
from portbench.drivers.sweep import band_pairs  # noqa: E402

STALL = 3.0


def test_band_pairs_count_every_pair_once():
    n, tile = 11, 4
    assert sum(band_pairs(n, tile, b, b + 1) for b in range(3)) \
        == n * (n - 1) // 2
    assert band_pairs(n, tile, 0, 1) == 0 + 1 + 2 + 3


def _stall_every(n: int):
    """A hook making every n-th call of the window's unit of work sleep."""
    def hook(driver):
        real = driver._band

        def band(lo, hi):
            if lo == 0:
                time.sleep(STALL)
            return real(lo, hi)

        driver._band = band
    return hook


def test_a_stall_moves_the_sweep_rate():
    name = "serra09-datacos.stream-sweep"
    out = R.run_cell(name, 11, 0.2, False, device="cpu",
                     overrides=_tiny.TINY[name], hooks=_stall_every(1))
    rate = out["metrics"]["pairs_per_s.stream"]["value"]
    # the stalled band's second is in the window: the rate is at most the
    # pairs done over the stall alone
    assert rate * STALL <= out["attempted"]
    assert out["correct"]
