"""A run that finds no card exits with an error and prints no result: the
benchmark never falls back to the CPU."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cell in ("serra09-datacos.stream-sweep", "earlysnf-covers80.sweep"):
        r = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell,
             "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert "CUDA device" in r.stderr
        for line in r.stdout.splitlines():
            try:
                json.loads(line)
            except ValueError:
                continue
            raise AssertionError(f"a result was printed: {line}")


def test_only_the_benchmark_and_its_files_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder a run fails and prints no result: the program is not there."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run;"
            "print(run.run_cell('serra09-datacos.stream-sweep', 1, 1.0,"
            " False, device='cpu'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert "acoss_tpu_torch" in r.stderr
    assert not r.stdout.strip()
