"""The matrix binarizer (`csrc/knn.cu` via
`ops/crp_cuda.binarize_matrix_batch`): exact mutual-kNN of built (B, L, L)
float32 matrices.

A call needs: each matrix's valid (l1, l2) window read once (4 bytes a
cell), the whole (B, L, L) uint8 CRP written and the lengths read; 3
operations a valid cell (two compares against the row's and the column's
threshold, an AND)."""

TARGETS = (("acoss_tpu_torch.benchmarking.algorithms.early_snf",
            "binarize_matrix_batch"),
           ("acoss_tpu_torch.benchmarking.algorithms.serra09",
            "binarize_matrix_batch"))
KERNELS = ("binarize_",)


def work(L: int, l1, l2) -> tuple[float, float]:
    """(operations, bytes) of one call on B matrices of (L, L) with valid
    row / column counts l1, l2 (sequences of ints)."""
    cells = sum(min(max(int(a), 0), L) * min(max(int(b), 0), L)
                for a, b in zip(l1, l2))
    return float(3 * cells), float(4 * cells + len(l1) * (L * L + 8))


def record(D, l1, l2, kappa=0.095):
    L = D.shape[-1]
    l1, l2 = l1.clone(), l2.clone()
    return lambda: work(L, l1.tolist(), l2.tolist())
