"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W), the
yardstick of every roofline share the benchmark reports."""

#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12
#: float32 operations a second outside the tensor cores (a fused
#: multiply-add counts as two)
FP32_OPS_PER_S = 67e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least seconds the card could take to do `ops` float32
    operations and move `nbytes` bytes: the larger of the two bounds."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
