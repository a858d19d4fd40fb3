"""Wrapper of the hand-written chord-HMM forward-backward kernel
(`csrc/hmm.cu`), its plain PyTorch version, and a plain model of the
kernel's chunked algorithm.

It replaces no TPU kernel: the JAX package runs the two recursions as
`lax.scan`s inside one compiled program (`acoss_tpu/features/chord.py:
72-85`), and eager PyTorch would launch several ops a frame. Given CPU
tensors `chord_forward_backward` returns the plain version; given CUDA
tensors it runs the kernel's three phases or raises. `launches` counts
calls that ran the kernel, one a song.

The kernel cuts the song into chunks of `chunk_length` frames and is
parallel in time (`chord_forward_backward_chunked_ref` runs the same
three phases in plain PyTorch, for the tests and the smoke run):
1. each chunk's transfer, the log-semiring product over its frames of
   the one-frame matrices A + E_t (chunk 0 from frame 1: frame 0 has no
   transition), max-shifted after every frame;
2. the messages at the chunk boundaries, alpha carried forward and beta
   backward through the transfers, one step a chunk;
3. every chunk's frames replayed from its boundary messages, forward and
   backward, and the posteriors softmax(alpha + beta).
"""

from __future__ import annotations

import functools
import math

import torch

from acoss_tpu_torch.ops import _build

#: the most states the kernel takes (one warp, a state a lane)
MAX_STATES = 32
#: the longest chunk the kernel takes (its emissions in shared memory)
MAX_CHUNK = 1024
#: A one-frame product of messages and transitions is an inner product
#: of exp factors, each at most 1; where it comes to less than this, the
#: terms lost below fp32's normal range (each < 2^-126, at most 32 of
#: them, so < 2^-121) could be more than 2^-31 of it, and the entry is
#: taken again as a max-shifted log-sum-exp.
TINY = 2.0 ** -90


def _shift(m: torch.Tensor) -> torch.Tensor:
    """Log messages (..., C) less their largest entries (the posteriors do
    not move)."""
    return m - torch.amax(m, dim=-1, keepdim=True)


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


def chunk_length(T: int, sms: int = 132) -> int:
    """Frames a chunk of the kernel's, for a card of `sms`
    multiprocessors (the H100's 132 by default): about sqrt(T / 2), so
    that the chunk steps (phase 1 and the replay, ~1.2 us a frame on the
    H100) and the boundary steps (~0.5 us a chunk) take about as long,
    but at least T / sms, so that phase 1's blocks, one a chunk, fit on
    the card at once; at least 2 and at most MAX_CHUNK."""
    half = -(-T // 2)
    return min(MAX_CHUNK, max(2, math.isqrt(max(half - 1, 0)) + 1,
                              -(-T // sms)))


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    """A max with the JAX `logsumexp` convention: a non-finite one is 0."""
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _log_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """lse_i(x_i + w_ij) for log factors x (..., C), each <= 0, and a log
    matrix w (..., C, C), as the kernel computes it: the inner product of
    exp(x) with exp(w less its column's largest entry), whose factors are
    all at most 1, where it is at least TINY; else the max-shifted
    log-sum-exp."""
    wmax = _finite_or_zero(torch.amax(w, dim=-2, keepdim=True))
    s = (torch.exp(x)[..., :, None] * torch.exp(w - wmax)).sum(dim=-2)
    exact = torch.logsumexp(x[..., :, None] + w, dim=-2)
    return torch.where(s >= TINY, torch.log(s) + wmax[..., 0, :], exact)


def chord_forward_backward_chunked_ref(log_emis: torch.Tensor,
                                       log_trans: torch.Tensor,
                                       chunk: int) -> torch.Tensor:
    """The posteriors of `chord_forward_backward_ref` by the kernel's
    three phases over chunks of `chunk` >= 2 frames, in its arithmetic
    (log messages; one-frame products as `_log_product` takes them), with
    the chunks batched where the kernel runs them in parallel. Used by
    the tests and the smoke run only."""
    if chunk < 2:
        raise ValueError(f"chunk must be at least 2 frames, got {chunk}")
    T, C = log_emis.shape
    E, A = log_emis, log_trans
    if T == 0:
        return torch.empty_like(E)
    L, nb = chunk, -(-T // chunk)
    lo = torch.arange(nb, device=E.device) * L
    hi = torch.clamp(lo + L, max=T)
    first = lo.clamp(min=1)    # frame 0 has no transition

    # 1. each chunk's transfer P = (A + E_first) (x) ... (x) (A + E_last),
    #    less its largest entry after every frame
    P = A + E[first.clamp(max=T - 1)][:, None, :]
    P = P - _finite_or_zero(torch.amax(P, dim=(1, 2), keepdim=True))
    for k in range(1, L):
        t = first + k
        valid = t < hi
        if not bool(valid.any()):
            break
        rm = _finite_or_zero(torch.amax(P, dim=2, keepdim=True))
        y = (_log_product(P - rm, A) + rm
             + E[t.clamp(max=T - 1)][:, None, :])
        y = y - _finite_or_zero(torch.amax(y, dim=(1, 2), keepdim=True))
        P = torch.where(valid[:, None, None], y, P)

    # 2. the boundary messages: alpha at the frame before each chunk,
    #    beta at each chunk's last frame
    a0 = _shift(E[0] - math.log(C))
    alpha_in = [a0]
    for c in range(nb - 1):
        alpha_in.append(_shift(_log_product(alpha_in[-1], P[c])))
    beta_end = [torch.zeros_like(a0)]
    for c in range(nb - 1, 0, -1):
        beta_end.insert(0, _shift(_log_product(beta_end[0], P[c].T)))

    # 3. every chunk replayed from its boundaries (chunk 0 from alpha_0)
    alphas = torch.empty_like(E)
    betas = torch.empty_like(E)
    alphas[0] = a0
    a = torch.stack(alpha_in)
    for k in range(L):
        t = first + k
        valid = t < hi
        if not bool(valid.any()):
            break
        y = _shift(_log_product(a, A) + E[t.clamp(max=T - 1)])
        a = torch.where(valid[:, None], y, a)
        alphas[t[valid]] = a[valid]
    b = torch.stack(beta_end)
    betas[hi - 1] = b
    for k in range(1, L):
        t = hi - 1 - k
        valid = t >= lo
        if not bool(valid.any()):
            break
        en = E[(t + 1).clamp(0, T - 1)]
        emax = _finite_or_zero(torch.amax(en, dim=1, keepdim=True))
        y = _shift(_log_product(b + (en - emax), A.T) + emax)
        b = torch.where(valid[:, None], y, b)
        betas[t[valid]] = b[valid]
    return torch.softmax(alphas + betas, dim=1)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chord_forward_backward(log_emis: torch.Tensor,
                           log_trans: torch.Tensor) -> torch.Tensor:
    """`chord_forward_backward_ref` on the CPU, the kernel on the card:
    log_emis (T, C) and log_trans (C, C) contiguous float32 on one device,
    C <= 32 -> (T, C) float32 posteriors. On the card the song is cut
    into chunks of `chunk_length(T, <the card's SMs>)` frames; one call is
    up to three CUDA launches and adds one to `launches`."""
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
    L = chunk_length(T, _sm_count(log_emis.device))
    lib = _build.library()
    gamma = torch.empty_like(log_emis)
    scratch = torch.empty(lib.acoss_hmm_fb_scratch(T, C, L),
                          dtype=torch.float32, device=log_emis.device)
    rc = lib.acoss_hmm_fb(
        log_emis.data_ptr(), log_trans.data_ptr(), T, C, L,
        scratch.data_ptr(), gamma.data_ptr(), log_emis.device.index,
        torch.cuda.current_stream(log_emis.device).cuda_stream)
    _build.check(rc, "acoss_hmm_fb")
    chord_forward_backward.launches += 1
    return gamma


chord_forward_backward.launches = 0
