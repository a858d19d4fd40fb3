"""Cover-song scoring algorithms ported so far (see ROADMAP.md, Queue A)."""

from acoss_tpu_torch.benchmarking.algorithms.anf_scattering import \
    ANFScattering  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.chen_fusion import \
    ChenFusion  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.early_fusion import \
    EarlyFusion  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.early_snf import \
    EarlySNF  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.ftm2d import FTM2D  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.serra09 import \
    Serra09  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.simple import \
    Simple  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.tempogram import \
    TGAlg  # noqa: F401

ALL_ALGORITHMS = {
    cls.NAME: cls for cls in (
        Serra09, FTM2D, ChenFusion, EarlySNF, EarlyFusion, Simple, TGAlg,
        ANFScattering)
}
