"""The roofline counts give the hand-worked numbers on small shapes."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import peaks  # noqa: E402
from portbench.roofline import (binarize, dmax, fused_crp,  # noqa: E402
                                knn_mask, qmax)


def test_fused_crp():
    # L 4, d 2, m 2, one pair of lengths 3 and 2: 6 CSM cells at 2d + 3 =
    # 7 operations, a 2 x 1 window block at m + 3 = 5; X and Y rows read
    # (4 d (3 + 2) = 40 bytes), the 4 x 4 CRP written (16) and 16 bytes
    # of lengths
    assert fused_crp.work(4, 2, 2, [3], [2]) == (52.0, 72.0)
    # a length past L counts L; a negative one counts 0
    assert fused_crp.work(4, 2, 2, [9, -1], [4, 4]) == (
        7 * 16 + 5 * 9, 4 * 2 * (4 + 0 + 4 + 4) + 2 * 16 + 32)


def test_aligners():
    # cells 3 x 2 + 4 x 4 (5 clamped to M = 4): 22
    assert qmax.work(4, 4, [3, 5], [2, 4]) == (110.0, 22.0 + 24)
    assert dmax.work(4, 4, [3, 5], [2, 4]) == (286.0, 22.0 + 24)


def test_binarize_and_knn_mask():
    assert binarize.work(4, [2], [3]) == (18.0, 24.0 + 16 + 8)
    assert knn_mask.work(2, 3) == (36.0, 8.0 * 18 + 8)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
