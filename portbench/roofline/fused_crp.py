"""The fused CRP (`csrc/crp.cu` via `ops/crp_cuda.fused_binary_crp_batch`):
per pair the squared-Euclidean CSM of X (L, d) against Y, summed over the
m-frame diagonal window, mutual-kNN binarized.

A call needs: the valid rows of X and Y read once (4 d bytes a row), the
(B, L, L) uint8 CRP and the two effective lengths written; 2 d + 3
operations a valid CSM cell and m + 3 a valid window cell (the window sum
and the two thresholds' compares and AND)."""

TARGETS = (("acoss_tpu_torch.benchmarking.algorithms.serra09",
            "fused_binary_crp_batch"),)
KERNELS = ("band_kernel", "strip_kernel")


def work(L: int, d: int, m: int, l1, l2) -> tuple[float, float]:
    """(operations, bytes) of one call on B pairs of width L, feature size
    d and window m, with the pairs' valid lengths l1, l2 (sequences of
    ints)."""
    l1 = [min(max(int(a), 0), L) for a in l1]
    l2 = [min(max(int(b), 0), L) for b in l2]
    cells = sum(a * b for a, b in zip(l1, l2))
    win = sum(max(a - m + 1, 0) * max(b - m + 1, 0) for a, b in zip(l1, l2))
    B = len(l1)
    nbytes = 4 * d * (sum(l1) + sum(l2)) + B * L * L + 16 * B
    return float((2 * d + 3) * cells + (m + 3) * win), float(nbytes)


def record(X, Y, l1, l2, kappa=0.095, m=9):
    """The call's work, counted after the traced stretch (no
    synchronisation inside it)."""
    _, L, d = X.shape
    l1, l2 = l1.clone(), l2.clone()
    return lambda: work(L, d, m, l1.tolist(), l2.tolist())
