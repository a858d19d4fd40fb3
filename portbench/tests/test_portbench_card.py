"""On the card (marked `cuda`; each test skips without one): every cell
runs a short window through `run.py` and comes out correct, and each
control comes out not correct at a size a test run holds. Run them on the
chip with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, run as R  # noqa: E402

CELLS = ("serra09-datacos.stream-sweep", "earlysnf-covers80.sweep")
#: the control each configuration's cells must fail
CONTROL = {"serra09-datacos.stream-sweep": "bf16",
           "earlysnf-covers80.sweep": "program_default"}
#: cells cut so a test run holds them: fewer songs, the same song shapes
SMALL = {
    "serra09-datacos.stream-sweep": {"config": {"corpus": {
        "n_cliques": 10, "n_distractors": 20}}},
    "earlysnf-covers80.sweep": {"config": {"corpus": {"n_cliques": 12}}},
}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark never runs on the "
                    "CPU)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    _card()
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000043", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    _card()
    limits = R.load_cell(name)[0]["limits"]
    for seed in (3000000047, 3000000053, 3000000059):
        r = control.readings(name, seed, 2.0, [CONTROL[name]],
                             overrides=SMALL[name])
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r[CONTROL[name]].items()), r
