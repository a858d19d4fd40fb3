"""Wrappers of the hand-written kernels of `csrc/serra09.cu`, the glue of
a Serra09 tile around the fused CRP, each one launch a tile:

- `pair_operands_batch`: the fused CRP's operands of every (row song,
  column song) pair of a tile and their lengths;
- `scores_epilogue_batch`: the channels' qmax and dmax scores normalised
  by M + N into one block.

They replace no TPU kernel (the JAX package's tile is one jitted program,
in which XLA fuses this glue). Each wrapper given CPU tensors returns its
plain version (`*_ref`, the torch composition the tile ran before the
kernels); given CUDA tensors it launches its kernel or raises. The kernels
copy, subtract and divide as the plain versions do, so both give the same
bits. `launches` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from acoss_tpu_torch.ops import _build, crp
from acoss_tpu_torch.utils.profiling import stages

#: The most channels `scores_epilogue_batch` takes (`csrc/serra09.cu`).
MAX_CHANNELS = 4


def pair_operands_ref(rc: torch.Tensor, cc: torch.Tensor, rm: torch.Tensor,
                      cm: torch.Tensor, rlen: torch.Tensor,
                      clen: torch.Tensor, oti: torch.Tensor | None = None):
    """Plain PyTorch version of the pair operands, on the tensors' device.

    rc (bi, L, dc) and cc (bj, L, dc) are the row and column songs'
    chroma, rm (bi, L, dm) and cm (bj, L, dm) their mfcc, rlen (bi,) and
    clen (bj,) their lengths, oti (bi, bj) each pair's chroma shift (None:
    no shift). Pair b = i * bj + j gets Xc[b] = row song i's chroma rolled
    by oti[i, j] (`crp.transpose_chroma`), Yc[b] = column song j's chroma,
    Xm[b], Ym[b] = the two songs' mfcc less row song i's first frame (the
    shared origin of `crp.get_csm_centered`), zero past each song's
    length, and l1[b] = rlen[i], l2[b] = clen[j]. Returns contiguous
    (Xc, Yc, Xm, Ym, l1, l2), the first four (bi * bj, L, d).
    """
    bi, L = rc.shape[:2]
    bj = cc.shape[0]
    X = rc[:, None].expand((bi, bj) + rc.shape[1:])
    if oti is not None:
        X = crp.transpose_chroma(X, oti)
    l1 = rlen.repeat_interleave(bj)
    l2 = clen.repeat(bi)
    ar = torch.arange(L, device=l1.device)

    def flat(X, Y):
        Xf = X.reshape((bi * bj,) + X.shape[2:])
        return Xf, Y.expand((bi, bj) + Y.shape[2:]).reshape(Xf.shape)

    Xc, Yc = flat(X, cc[None])
    Xm, Ym = flat(rm[:, None].expand((bi, bj) + rm.shape[1:]), cm[None])
    c = Xm[:, :1]
    Xm = torch.where((ar < l1[:, None])[..., None], Xm - c, 0.0)
    Ym = torch.where((ar < l2[:, None])[..., None], Ym - c, 0.0)
    return (Xc.contiguous(), Yc.contiguous(), Xm.contiguous(),
            Ym.contiguous(), l1, l2)


def _check_features(rc, cc, rm, cm, rlen, clen, oti) -> None:
    dev = rc.device
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {dev}")
    bi, L, dc = rc.shape
    bj, dm = cc.shape[0], rm.shape[-1]
    for name, t, shape in (("rc", rc, (bi, L, dc)), ("cc", cc, (bj, L, dc)),
                           ("rm", rm, (bi, L, dm)), ("cm", cm, (bj, L, dm))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev):
            raise ValueError(f"{name} must be a {shape} float32 tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t, n in (("rlen", rlen, bi), ("clen", clen, bj)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) \
                or t.device != dev:
            raise ValueError(f"{name} must be a ({n},) int32 tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if oti is not None and (oti.dtype != torch.int64 or oti.device != dev
                            or tuple(oti.shape) != (bi, bj)):
        raise ValueError(f"oti must be a ({bi}, {bj}) int64 tensor on "
                         f"{dev}, got {oti.dtype} {tuple(oti.shape)} on "
                         f"{oti.device}")
    if bi * bj > 65535:
        raise ValueError(f"need bi * bj <= 65535 (got {bi} x {bj})")


def pair_operands_batch(rc: torch.Tensor, cc: torch.Tensor, rm: torch.Tensor,
                        cm: torch.Tensor, rlen: torch.Tensor,
                        clen: torch.Tensor, oti: torch.Tensor | None = None):
    """The pair operands of a tile in one launch; the contract of
    `pair_operands_ref`, bit for bit. The operands are views of two
    buffers, the lengths of a third, each contiguous. The counter
    `score:prep_calls` counts the calls that launched the kernel."""
    if rc.device.type == "cpu":
        return pair_operands_ref(rc, cc, rm, cm, rlen, clen, oti)
    _check_features(rc, cc, rm, cm, rlen, clen, oti)
    rc, cc, rm, cm, rlen, clen, oti = (
        t if t is None or t.is_contiguous() else t.contiguous()
        for t in (rc, cc, rm, cm, rlen, clen, oti))
    bi, L, dc = rc.shape
    bj, dm = cc.shape[0], rm.shape[2]
    B, dev = bi * bj, rc.device
    chroma = torch.empty((2, B, L, dc), dtype=torch.float32, device=dev)
    mfcc = torch.empty((2, B, L, dm), dtype=torch.float32, device=dev)
    lens = torch.empty((2, B), dtype=torch.int32, device=dev)
    cp, mp, lp = chroma.data_ptr(), mfcc.data_ptr(), lens.data_ptr()
    err = _build.library().acoss_serra09_pair_operands(
        rc.data_ptr(), cc.data_ptr(), rm.data_ptr(), cm.data_ptr(),
        rlen.data_ptr(), clen.data_ptr(),
        None if oti is None else oti.data_ptr(), bi, bj, L, dc, dm, cp,
        cp + 4 * B * L * dc, mp, mp + 4 * B * L * dm, lp, lp + 4 * B,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "acoss_serra09_pair_operands")
    pair_operands_batch.launches += 1
    stages.add("score:prep_calls", 1)
    (Xc, Yc), (Xm, Ym), (l1, l2) = chroma, mfcc, lens
    return Xc, Yc, Xm, Ym, l1, l2


pair_operands_batch.launches = 0


def scores_epilogue_ref(q, d, l1e: torch.Tensor,
                        l2e: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the score epilogue: the channels' (B,)
    qmax scores `q` and dmax scores `d` (sequences of nf tensors) over
    max(l1e + l2e, 1) (int32 sums, then float32), stacked (2, nf, B)."""
    denom = torch.clamp_min(l1e + l2e, 1).to(torch.float32)
    return torch.stack([torch.stack(list(q)) / denom,
                        torch.stack(list(d)) / denom])


def scores_epilogue_batch(q, d, l1e: torch.Tensor,
                          l2e: torch.Tensor) -> torch.Tensor:
    """The score epilogue in one launch; the contract of
    `scores_epilogue_ref`, bit for bit. q, d: up to `MAX_CHANNELS`
    contiguous (B,) float32 tensors each; l1e, l2e: (B,) int32."""
    if l1e.device.type == "cpu":
        return scores_epilogue_ref(q, d, l1e, l2e)
    dev = l1e.device
    B, nf = l1e.shape[0], len(q)
    if not 1 <= nf <= MAX_CHANNELS or len(d) != nf:
        raise ValueError(f"need 1 to {MAX_CHANNELS} channels of qmax and "
                         f"of dmax, got {nf} and {len(d)}")
    for t in (*q, *d):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"scores must be contiguous ({B},) float32 "
                             f"tensors on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("l1e", l1e), ("l2e", l2e)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((2, nf, B), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * (2 * nf))(*(t.data_ptr() for t in (*q, *d)))
    rc = _build.library().acoss_serra09_scores(
        ptrs, l1e.data_ptr(), l2e.data_ptr(), nf, B, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "acoss_serra09_scores")
    scores_epilogue_batch.launches += 1
    return out


scores_epilogue_batch.launches = 0
