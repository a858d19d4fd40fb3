"""Package-level properties of the port: it imports neither JAX nor the
JAX package, and its kernel build fails loudly without nvcc."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from acoss_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import acoss_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    acoss_tpu_torch.__path__, 'acoss_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'acoss_tpu' or m.startswith('acoss_tpu.'))\n"
        "print(json.dumps({'modules': mods, 'bad': bad}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for m in ("acoss_tpu_torch.cli", "acoss_tpu_torch.ops.alignment_cuda",
              "acoss_tpu_torch.ops.crp_cuda", "acoss_tpu_torch.ops.fusion",
              "acoss_tpu_torch.ops.resize", "acoss_tpu_torch.ops.scattering",
              "acoss_tpu_torch.ops.ssm_features",
              "acoss_tpu_torch.benchmarking.algorithms.serra09",
              "acoss_tpu_torch.benchmarking.algorithms.early_snf",
              "acoss_tpu_torch.benchmarking.algorithms.early_fusion",
              "acoss_tpu_torch.benchmarking.algorithms.ftm2d",
              "acoss_tpu_torch.benchmarking.algorithms.simple",
              "acoss_tpu_torch.benchmarking.algorithms.chen_fusion",
              "acoss_tpu_torch.benchmarking.algorithms.tempogram",
              "acoss_tpu_torch.benchmarking.algorithms.anf_scattering",
              "acoss_tpu_torch.benchmarking.algorithms.struct_common",
              "acoss_tpu_torch.benchmarking.algorithms.struc_ftm2d",
              "acoss_tpu_torch.benchmarking.algorithms.struc_scattering",
              "acoss_tpu_torch.benchmarking.algorithms.struc_laplacian",
              "acoss_tpu_torch.ops.curvature", "acoss_tpu_torch.ops.laplacian",
              "acoss_tpu_torch.ops.sparse_gram",
              "acoss_tpu_torch.ops.structure",
              "acoss_tpu_torch.features.rhythm",
              "acoss_tpu_torch.ops.similarity_legacy",
              "acoss_tpu_torch.native"):
        assert m in out["modules"]


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_library_name_tracks_the_sources(tmp_path):
    p = _build.library_path(tmp_path)
    assert p.parent == tmp_path and p.name.startswith("libacoss_kernels_")
    assert p == _build.library_path(tmp_path)
    names = {s.name for s in _build.sources()}
    assert {"alignment.cu", "crp.cu", "knn.cu", "select.cuh"} <= names


def test_library_declares_every_c_entry_point():
    """Each C function of the sources is declared in `_build.SIGNATURES`,
    parameter by parameter, with pointer-width arguments for pointers
    (ctypes would otherwise pass a 32-bit int and cut the pointer),
    checked against the sources without building."""
    import ctypes
    import re

    src = "\n".join(p.read_text() for p in _build.sources())
    exported = dict(re.findall(
        r"^(?:int|size_t|const char\*) (acoss_\w+)\(([^)]*)\)", src, re.M))
    assert {"acoss_qmax", "acoss_dmax", "acoss_qmax_uneq", "acoss_sw",
            "acoss_fused_crp", "acoss_binarize", "acoss_knn_mask",
            "acoss_wcsmssm", "acoss_error_string"} <= set(exported)
    assert set(exported) == set(_build.SIGNATURES)
    for name, params in exported.items():
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_float if "float" in p else ctypes.c_int
                for p in params.split(",")]
        assert _build.SIGNATURES[name][0] == want, name
