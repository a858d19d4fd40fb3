"""Cover-song scoring algorithms ported so far (see ROADMAP.md, Queue A)."""

from acoss_tpu_torch.benchmarking.algorithms.early_snf import \
    EarlySNF  # noqa: F401
from acoss_tpu_torch.benchmarking.algorithms.serra09 import \
    Serra09  # noqa: F401

ALL_ALGORITHMS = {cls.NAME: cls for cls in (Serra09, EarlySNF)}
