"""Qmax (`csrc/alignment.cu` via `ops/alignment_cuda.qmax_batch_cuda`):
Serra 2009's local alignment of a binary CRP.

A call needs: each pair's valid (m, n) window of the uint8 CRP read once,
its two int32 lengths read and one float32 score written; 5 operations a
valid cell (three maxes of the predecessors, the match add or the gap
subtraction and clamp, the running max)."""

TARGETS = (("acoss_tpu_torch.ops.alignment_cuda", "qmax_batch_cuda"),)
KERNELS = ("qmax_kernel",)
OPS_PER_CELL = 5


def work(M: int, N: int, m_len, n_len,
         ops_per_cell: int = OPS_PER_CELL) -> tuple[float, float]:
    """(operations, bytes) of one call on B CRPs of (M, N) with valid
    lengths m_len, n_len (sequences of ints)."""
    cells = sum(min(max(int(a), 0), M) * min(max(int(b), 0), N)
                for a, b in zip(m_len, n_len))
    return float(ops_per_cell * cells), float(cells + 12 * len(m_len))


def record(S, m_len, n_len, gap=0.5):
    _, M, N = S.shape
    m_len, n_len = m_len.clone(), n_len.clone()
    return lambda: work(M, N, m_len.tolist(), n_len.tolist())
