"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name; a cell and a metric added as new files are picked up
with no existing file edited."""

import json
import os
import re
import shutil
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as R  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = R.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if R.quantity(m["name"]).endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        ends = [m["name"] for m in R.end_to_end_metrics(BENCH, w)]
        assert "setup_s" in ends and len(ends) >= 2
        layers = R.layer_metrics(BENCH, w)
        assert layers
        for m in layers:
            assert m["moves"] in ends, (w, m["name"])


def test_every_cell_finds_its_files_by_name():
    for w in BENCH["workloads"]:
        workload, config = R.load_cell(w["name"])
        assert workload["config"] == w["config"] == config["name"]
        assert workload["chips"] == w["chips"] and workload["why"] == w["why"]
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "drivers", f"{workload['driver']}.py"))
        assert set(workload["limits"]) == {"mismatch_pct", "gap_max"}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for m in BENCH["per_layer"]:
        mod = R.load_metric(m["name"])
        assert mod.LAYER == m["layer"]
        assert mod.MOVES == R.quantity(m["moves"])
        assert callable(mod.read)
    for k in ("fused_crp", "qmax", "dmax", "binarize", "knn_mask"):
        assert f"{k}_roofline" in {R.quantity(m["name"])
                                   for m in BENCH["per_layer"]}


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


NEW_METRIC = '''
LAYER = "device"
MOVES = "pairs_per_s"


def read(tracer, window):
    return 42.0
'''


def test_new_cell_and_metric_are_picked_up(tmp_path):
    """A later PR adds a cell and a metric as files and entries only."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    src = tmp_path / "portbench" / "workloads"
    new = json.loads((src / "serra09-datacos.stream-sweep.json").read_text())
    new.update(name="serra09-datacos.wide-band",
               traffic=dict(new["traffic"], band_rows=16))
    (src / "serra09-datacos.wide-band.json").write_text(json.dumps(new))
    (tmp_path / "portbench" / "metrics" / "new_probe.sweep.py").write_text(
        NEW_METRIC)
    bench["workloads"].append({
        "name": "serra09-datacos.wide-band", "config": "serra09-datacos",
        "traffic": "wide-band", "chips": 1, "why": new["why"]})
    bench["per_layer"].append({
        "name": "new_probe.sweep", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "pairs_per_s.stream",
        "workloads": ["serra09-datacos.wide-band"]})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s.stream":
            m["workloads"].append("serra09-datacos.wide-band")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file() and "new" not in p.name
              and "wide-band" not in p.name}
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench import run as R;"
        "b = R.manifest(); w = 'serra09-datacos.wide-band';"
        "wl, cfg = R.load_cell(w);"
        "names = [m['name'] for m in R.layer_metrics(b, w)];"
        "print(wl['traffic']['band_rows'], cfg['name'], "
        "'new_probe.sweep' in names, "
        "R.load_metric('new_probe.sweep').read(None, None), "
        "[m['name'] for m in R.end_to_end_metrics(b, w)])")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out[:4] == ["16", "serra09-datacos", "True", "42.0"]
    assert out[4:] == ["['pairs_per_s.stream',", "'setup_s']"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
