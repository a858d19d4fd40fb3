"""Dmax (`csrc/alignment.cu` via `ops/alignment_cuda.dmax_batch_cuda`):
Chen 2017's five-predecessor local alignment of a binary CRP.

A call needs what a qmax call needs (`qmax.work`), with 13 operations a
valid cell (the five predecessors with the CRP values they skip, their
maxes, the gap terms and the running max)."""

from portbench.roofline.qmax import work as _work

TARGETS = (("acoss_tpu_torch.ops.alignment_cuda", "dmax_batch_cuda"),)
KERNELS = ("dmax_kernel",)
OPS_PER_CELL = 13


def work(M: int, N: int, m_len, n_len) -> tuple[float, float]:
    return _work(M, N, m_len, n_len, OPS_PER_CELL)


def record(S, m_len, n_len, gap=0.5):
    _, M, N = S.shape
    m_len, n_len = m_len.clone(), n_len.clone()
    return lambda: work(M, N, m_len.tolist(), n_len.tolist())
