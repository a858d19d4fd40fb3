"""Wrapper of the hand-written chord-HMM forward-backward kernel
(`csrc/hmm.cu`), and its plain PyTorch version.

It replaces no TPU kernel: the JAX package runs the two recursions as
`lax.scan`s inside one compiled program (`acoss_tpu/features/chord.py:
72-85`), and eager PyTorch would launch several ops a frame. Given CPU
tensors `chord_forward_backward` returns the plain version; given CUDA
tensors it launches the kernel or raises. `launches` counts launches.
"""

from __future__ import annotations

import math

import torch

from acoss_tpu_torch.ops import _build

#: the most states the kernel takes (one warp, a state a lane)
MAX_STATES = 32


def _shift(m: torch.Tensor) -> torch.Tensor:
    """A log message less its largest entry (the posteriors do not move)."""
    return m - torch.max(m)


def chord_forward_backward_ref(log_emis: torch.Tensor,
                               log_trans: torch.Tensor) -> torch.Tensor:
    """Posteriors (T, C) of an HMM with log emissions (T, C), log
    transitions (C, C) and a uniform start, by the two log-space
    recursions, one frame a step. Each message is shifted to a largest
    entry of 0: the posteriors are the same, and the messages do not grow
    with T (unshifted, they reach ~-10^4 in a 5-minute song, where fp32
    is 1e-3 apart; the JAX package's do, and its posteriors are ~6e-4
    off a float64 run on a 65 s song)."""
    T, C = log_emis.shape
    alphas = torch.empty_like(log_emis)
    if T == 0:
        return alphas
    a = _shift(log_emis[0] - math.log(C))
    alphas[0] = a
    for t in range(1, T):
        a = _shift(torch.logsumexp(a[:, None] + log_trans, dim=0)
                   + log_emis[t])
        alphas[t] = a
    betas = torch.zeros_like(log_emis)
    b = betas[T - 1]
    for t in range(T - 2, -1, -1):
        b = _shift(torch.logsumexp(
            log_trans + (log_emis[t + 1] + b)[None, :], dim=1))
        betas[t] = b
    return torch.softmax(alphas + betas, dim=1)


def chord_forward_backward(log_emis: torch.Tensor,
                           log_trans: torch.Tensor) -> torch.Tensor:
    """`chord_forward_backward_ref` on the CPU, the kernel on the card:
    log_emis (T, C) and log_trans (C, C) contiguous float32 on one device,
    C <= 32 -> (T, C) float32 posteriors."""
    if log_emis.device.type == "cpu":
        return chord_forward_backward_ref(log_emis, log_trans)
    if log_emis.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got "
                         f"{log_emis.device}")
    T, C = log_emis.shape
    for name, t, shape in (("log_emis", log_emis, (T, C)),
                           ("log_trans", log_trans, (C, C))):
        if (t.device != log_emis.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor on {log_emis.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= C <= MAX_STATES:
        raise ValueError(f"the kernel takes 1..{MAX_STATES} states, got {C}")
    gamma = torch.empty_like(log_emis)
    rc = _build.library().acoss_hmm_fb(
        log_emis.data_ptr(), log_trans.data_ptr(), T, C, gamma.data_ptr(),
        log_emis.device.index,
        torch.cuda.current_stream(log_emis.device).cuda_stream)
    _build.check(rc, "acoss_hmm_fb")
    chord_forward_backward.launches += 1
    return gamma


chord_forward_backward.launches = 0
