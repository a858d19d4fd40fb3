"""No process of the benchmark loads JAX or the JAX package (compared by
whole top-level module name: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as R  # noqa: E402


def _modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {ROOT!r}); {code};"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=600, env=env,
        cwd=ROOT).stdout.split("\n")[-2]
    return set(out.split())


def test_forbidden_names_compare_whole_top_level_names():
    fake = {"acoss_tpu_torch_probe": sys, "jaxtyping_probe": sys}
    sys.modules.update(fake)
    try:
        found = R.forbidden_modules()
        assert "acoss_tpu_torch_probe" not in found
        assert "jaxtyping_probe" not in found
        sys.modules["acoss_tpu.probe"] = sys
        assert "acoss_tpu" in R.forbidden_modules()
    finally:
        for k in (*fake, "acoss_tpu.probe"):
            sys.modules.pop(k, None)


def test_a_run_loads_no_jax_and_no_jax_package():
    tiny = os.path.join(os.path.dirname(os.path.abspath(__file__)))
    mods = _modules(
        f"sys.path.insert(0, {tiny!r}); import _tiny;"
        "from portbench import run as R;"
        "name = 'serra09-datacos.stream-sweep';"
        "out = R.run_cell(name, 7, 0.2, True, device='cpu',"
        " overrides=_tiny.TINY[name]);"
        "assert out['checks']")
    assert "acoss_tpu_torch" in mods
    assert not mods & set(R.FORBIDDEN), mods & set(R.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(
        "import portbench.reference.serra09, portbench.data.synthetic,"
        " portbench.peaks, portbench.roofline.fused_crp,"
        " portbench.roofline.qmax, portbench.roofline.dmax,"
        " portbench.roofline.binarize, portbench.roofline.knn_mask")
    assert not mods & {"acoss_tpu_torch", *R.FORBIDDEN}
    here = os.path.join(ROOT, "portbench", "reference")
    for fn in os.listdir(here):
        if fn.endswith(".py"):
            with open(os.path.join(here, fn)) as f:
                text = f.read()
            assert "import acoss_tpu" not in text
            assert "from acoss_tpu" not in text
