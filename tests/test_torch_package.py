"""Package-level properties of the port: it imports neither JAX nor the
JAX package, and its kernel build fails loudly without nvcc."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import json
import os
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
              "acoss_tpu_torch.features.spectral",
              "acoss_tpu_torch.features.audio",
              "acoss_tpu_torch.features.onsets",
              "acoss_tpu_torch.features.hpcp",
              "acoss_tpu_torch.features.key",
              "acoss_tpu_torch.features.mfcc",
              "acoss_tpu_torch.features.chroma",
              "acoss_tpu_torch.features.chord",
              "acoss_tpu_torch.features.nsgcq",
              "acoss_tpu_torch.features.fingerprint",
              "acoss_tpu_torch.features.pipeline",
              "acoss_tpu_torch.data.manifest",
              "acoss_tpu_torch.ops.hmm_cuda",
              "acoss_tpu_torch.ops.similarity_legacy",
              "acoss_tpu_torch.native",
              "acoss_tpu_torch.serving", "acoss_tpu_torch.config",
              "acoss_tpu_torch.parallel.distributed",
              "acoss_tpu_torch.parallel.mesh", "acoss_tpu_torch.entry",
              "acoss_tpu_torch.analytics.coverstats",
              "acoss_tpu_torch.analytics.onset_timing",
              "acoss_tpu_torch.analytics.song_structure",
              "acoss_tpu_torch.analytics.studies",
              "acoss_tpu_torch.data.h5io",
              "acoss_tpu_torch.utils.logging",
              "acoss_tpu_torch.utils.profiling"):
        assert m in out["modules"]


def test_card_installs_are_enough(tmp_path):
    """The card's machine has numpy, scipy and torch but no pandas,
    matplotlib, h5py or jax: with those made unimportable, the serving,
    parallel, analytics, utils and CLI modules import, and `coverstats
    --no-figures` runs every default study on the CPU."""
    code = (
        "import sys\n"
        "for m in ('pandas', 'matplotlib', 'h5py', 'jax', 'jaxlib'):\n"
        "    sys.modules[m] = None\n"
        "from acoss_tpu_torch import analytics, cli, parallel, serving, utils\n"
        "from acoss_tpu_torch.data import make_synthetic_dataset\n"
        "fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=1)\n"
        f"fs.save({str(tmp_path / 'fs.npz')!r})\n"
        "rc = cli.main(['coverstats', '-d', "
        f"{str(tmp_path / 'fs.npz')!r}, '-o', {str(tmp_path / 'out')!r}, "
        "'--no-figures', '--device', 'cpu'])\n"
        "bad = sorted(m for m in ('pandas', 'matplotlib', 'h5py', 'jax')\n"
        "             if sys.modules.get(m) is not None)\n"
        "print('RESULT', rc, bad)\n")
    # one intra-op thread: more only spin in a loaded parallel test run
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "RESULT 0 []"
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert set(summary["studies"]) == {"key", "tempo", "onset", "stdev",
                                       "shapedna"}
    assert not list((tmp_path / "out").glob("*.svg"))


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
    assert {"alignment.cu", "crp.cu", "hmm.cu", "knn.cu",
            "select.cuh"} <= names


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
            "acoss_wcsmssm", "acoss_hmm_fb",
            "acoss_error_string"} <= set(exported)
    assert set(exported) == set(_build.SIGNATURES)
    for name, params in exported.items():
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_float if "float" in p else ctypes.c_int
                for p in params.split(",")]
        assert _build.SIGNATURES[name][0] == want, name
