"""The kNN row mask (`csrc/knn.cu` via `ops/crp_cuda.knn_mask_matrix_batch`):
per row of (B, n, n) float32 matrices, keep the values at least its k-th
largest (SNF's neighbour truncation).

A call needs: every cell read and written once (the matrices carry no
lengths) and each matrix's k read; 2 operations a cell (a compare, a
select)."""

TARGETS = (("acoss_tpu_torch.ops.crp_cuda", "knn_mask_matrix_batch"),)
KERNELS = ("knn_mask",)


def work(B: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one call on B matrices of (n, n)."""
    cells = B * n * n
    return float(2 * cells), float(8 * cells + 4 * B)


def record(W, k, largest=True):
    B, n, _ = W.shape
    return lambda: work(B, n)
