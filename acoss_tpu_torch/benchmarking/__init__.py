"""Benchmark harness, algorithms, and retrieval evaluation."""

from acoss_tpu_torch.benchmarking.evaluation import (  # noqa: F401
    EvalStats,
    eval_statistics,
)
