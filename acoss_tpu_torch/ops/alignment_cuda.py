"""Wrappers of the hand-written CUDA aligner kernels (`csrc/alignment.cu`),
which replace the TPU kernels of `acoss_tpu/ops/alignment_pallas.py`:

- `qmax_batch_cuda` replaces `_qmax_kernel` (equal gaps);
- `dmax_batch_cuda` replaces `_dmax_kernel` (equal gaps);
- `qmax_uneq_batch_cuda` replaces `_qmax_kernel_uneq` (unequal gaps);
- `swconstrained_batch_cuda` replaces `_sw_kernel`.

A wrapper given CPU tensors returns its plain version (`*_ref`, the
length-masked scans of `alignment`); given CUDA tensors it launches its
kernel or raises. `launches` on each wrapper counts kernel launches. The
kernels mask by length, so they take any gaps and scores: the
`alignment.*_best` dispatchers send every CUDA batch to them (dmax with
unequal gaps has no kernel).
"""

from __future__ import annotations

import torch

from acoss_tpu_torch.ops import _build, alignment


def qmax_batch_ref(S, m_len, n_len, gap: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version of the qmax kernel."""
    return alignment.qmax_batch(S, m_len, n_len, gap_onset=gap,
                                gap_extension=gap)


def dmax_batch_ref(S, m_len, n_len, gap: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version of the dmax kernel."""
    return alignment.dmax_batch(S, m_len, n_len, gap_onset=gap,
                                gap_extension=gap)


def qmax_uneq_batch_ref(S, m_len, n_len, gap_onset: float,
                        gap_extension: float) -> torch.Tensor:
    """Plain PyTorch version of the unequal-gap qmax kernel."""
    return alignment.qmax_batch(S, m_len, n_len, gap_onset=gap_onset,
                                gap_extension=gap_extension)


def swconstrained_batch_ref(S, m_len, n_len, gap_opening: float = -0.5,
                            gap_extension: float = -0.7,
                            match_score: float = 1.0,
                            mismatch_score: float = -1.0) -> torch.Tensor:
    """Plain PyTorch version of the constrained SW kernel."""
    return alignment.swconstrained_batch(
        S, m_len, n_len, gap_opening=gap_opening,
        gap_extension=gap_extension, match_score=match_score,
        mismatch_score=mismatch_score)


def _check_args(S, m_len, n_len, max_n: int) -> None:
    if S.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {S.device}")
    if S.dtype != torch.uint8 or S.ndim != 3 or not S.is_contiguous():
        raise ValueError(f"S must be a contiguous (B, M, N) uint8 tensor, "
                         f"got {S.dtype} {tuple(S.shape)}")
    B, _, N = S.shape
    for name, t in (("m_len", m_len), ("n_len", n_len)):
        if (t.device != S.device or t.dtype != torch.int32
                or tuple(t.shape) != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {S.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if N > max_n:
        raise ValueError(f"the kernel takes N <= {max_n}, got N={N}")


#: The longest rows the kernels take. The register kernels (all four
#: aligners) keep their D rows in registers, at most 32 columns a thread
#: and 512 threads a pair; past that, unequal-gap qmax and SW take
#: shared-memory kernels that keep three D rows of fp32 in a block's
#: shared memory (the C entry points choose by shape).
SMEM_MAX_N = _build.MAX_SMEM // (4 * 3)
REGISTER_MAX_N = 32 * 512


def _launch(entry: str, max_n: int, S, m_len, n_len, *params: float):
    """Launch the C entry point `entry` (one block per pair, rows up to
    `max_n` long) with the float `params` after the shape."""
    _check_args(S, m_len, n_len, max_n)
    B, M, N = S.shape
    out = torch.empty(B, dtype=torch.float32, device=S.device)
    rc = getattr(_build.library(), entry)(
        S.data_ptr(), m_len.data_ptr(), n_len.data_ptr(), B, M, N,
        *params, out.data_ptr(), S.device.index,
        torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(rc, entry)
    return out


def qmax_batch_cuda(S: torch.Tensor, m_len: torch.Tensor,
                    n_len: torch.Tensor, gap: float = 0.5) -> torch.Tensor:
    """Batched qmax with gap_onset == gap_extension == gap: S (B, M, N)
    uint8, m_len/n_len (B,) int32 -> (B,) float32 scores."""
    if S.device.type == "cpu":
        return qmax_batch_ref(S, m_len, n_len, gap)
    out = _launch("acoss_qmax", REGISTER_MAX_N, S, m_len, n_len, gap)
    qmax_batch_cuda.launches += 1
    return out


def dmax_batch_cuda(S: torch.Tensor, m_len: torch.Tensor,
                    n_len: torch.Tensor, gap: float = 0.5) -> torch.Tensor:
    """Batched dmax with gap_onset == gap_extension == gap (same layout
    as `qmax_batch_cuda`)."""
    if S.device.type == "cpu":
        return dmax_batch_ref(S, m_len, n_len, gap)
    out = _launch("acoss_dmax", REGISTER_MAX_N, S, m_len, n_len, gap)
    dmax_batch_cuda.launches += 1
    return out


def qmax_uneq_batch_cuda(S: torch.Tensor, m_len: torch.Tensor,
                         n_len: torch.Tensor, gap_onset: float,
                         gap_extension: float) -> torch.Tensor:
    """Batched qmax whose gap branch subtracts each predecessor's own
    penalty (gap_onset after a match, gap_extension after a gap); same
    layout as `qmax_batch_cuda`."""
    if S.device.type == "cpu":
        return qmax_uneq_batch_ref(S, m_len, n_len, gap_onset,
                                   gap_extension)
    out = _launch("acoss_qmax_uneq", SMEM_MAX_N, S, m_len, n_len, gap_onset,
                  gap_extension)
    qmax_uneq_batch_cuda.launches += 1
    return out


def swconstrained_batch_cuda(S: torch.Tensor, m_len: torch.Tensor,
                             n_len: torch.Tensor, gap_opening: float = -0.5,
                             gap_extension: float = -0.7,
                             match_score: float = 1.0,
                             mismatch_score: float = -1.0) -> torch.Tensor:
    """Batched constrained Smith-Waterman (same layout as
    `qmax_batch_cuda`)."""
    if S.device.type == "cpu":
        return swconstrained_batch_ref(S, m_len, n_len, gap_opening,
                                       gap_extension, match_score,
                                       mismatch_score)
    out = _launch("acoss_sw", SMEM_MAX_N, S, m_len, n_len, gap_opening,
                  gap_extension, match_score, mismatch_score)
    swconstrained_batch_cuda.launches += 1
    return out


qmax_batch_cuda.launches = 0
dmax_batch_cuda.launches = 0
qmax_uneq_batch_cuda.launches = 0
swconstrained_batch_cuda.launches = 0
