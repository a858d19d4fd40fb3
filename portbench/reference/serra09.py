"""The plain reference of the two configurations the benchmark runs: Serra09
(Serra et al. 2009: OTI -> Euclidean CSM -> 9-frame diagonal window ->
mutual-kNN CRP -> Qmax and Dmax, divided by M + N) and EarlySNF (Serra09's
channels plus the MFCC block-SSM scattering channel and the early
similarity-network fusion of the two, after `EarlySNF.py` of acoss).

Everything here works from the raw per-song features the benchmark
rendered (`hpcp`, `mfcc_htk`): the descriptors, their int8 store, the
tiles' CRPs and the aligners' scores are worked out again, in plain
PyTorch, with no kernel and nothing of the program under test. The
functions are a frozen copy of the program's plain path (`plain=True`),
so a later change to the program cannot move them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import alignment, crp, fusion
from portbench.reference.segment import uniform_downsample_batch
from portbench.reference.ssm_features import build_ssms_device

DOWNSAMPLE = 40
PAD_MULTIPLE = 64


def padded_width(frame_counts) -> int:
    """The descriptor width of a corpus whose songs have these full-rate
    frame counts: the longest downsampled song rounded up to 64 rows."""
    n = max(-(-int(c) // DOWNSAMPLE) for c in frame_counts)
    return -(-n // PAD_MULTIPLE) * PAD_MULTIPLE


def quantize_int8(v: np.ndarray) -> np.ndarray:
    """Per-song symmetric int8 round trip of (N, ...) float32 values:
    int8(round(v / s)) * s with s = max|v| / 127 (1 for an all-zero
    song), in float32 as the store's readers restore it."""
    v = np.asarray(v, dtype=np.float32)
    amax = np.abs(v).reshape(v.shape[0], -1).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    s = scale.reshape((-1,) + (1,) * (v.ndim - 1))
    q = np.clip(np.round(v / s), -127, 127).astype(np.int8)
    return q.astype(np.float32) * s


def descriptors(songs: list, width: int, device, *, ssms: bool = False,
                m: int = 9, ssm_win_mul: int = 2, ssm_res: int = 64,
                int8: tuple = ()) -> dict:
    """Serra09's per-song descriptors of `songs` (dicts with `hpcp` and
    `mfcc_htk`) padded to `width` rows, as tensors on `device`: chroma
    (median x40), mfcc (mean x40), both cut to their common length,
    gchroma (the frame sum over its max), length, and with `ssms` the
    (N, width, 20736) block-SSM scattering rows. The keys in `int8` go
    through the int8 store's round trip."""
    chs = [np.asarray(s["hpcp"], np.float32) for s in songs]
    mfs = [np.nan_to_num(np.asarray(s["mfcc_htk"], np.float32), nan=0.0,
                         posinf=0.0, neginf=0.0) for s in songs]
    ch_all = uniform_downsample_batch(chs, DOWNSAMPLE, "median",
                                      device=device)
    mf_all = uniform_downsample_batch(mfs, DOWNSAMPLE, "mean",
                                      device=device)
    N = len(songs)
    chroma = np.zeros((N, width, 12), np.float32)
    mfcc = np.zeros((N, width, 13), np.float32)
    gchroma = np.zeros((N, 12), np.float32)
    length = np.zeros(N, np.int32)
    full_mfccs = []
    for i in range(N):
        g = chs[i].sum(axis=0)
        gchroma[i] = g / max(g.max(), 1e-12)
        n = min(ch_all[i].shape[0], mf_all[i].shape[0], width)
        chroma[i, :n] = ch_all[i][:n]
        mfcc[i, :n] = mf_all[i][:n]
        length[i] = n
        full_mfccs.append(np.asarray(mfs[i][:n * DOWNSAMPLE], np.float32))
    out = {"chroma": chroma, "mfcc": mfcc, "gchroma": gchroma,
           "length": length}
    for k in int8:
        out[k] = quantize_int8(out[k])
    out = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    if ssms:
        out["ssms"] = build_ssms_device(
            full_mfccs, [max(int(n) - m + 1, 1) for n in length], width,
            DOWNSAMPLE, m * ssm_win_mul, ssm_res, device=device)
    return out


def _rolled_chroma(row: dict, col: dict) -> torch.Tensor:
    """(bi, bj, L, 12): each row song's chroma, OTI-rolled towards each
    column song."""
    bi, bj = row["length"].shape[0], col["length"].shape[0]
    X = row["chroma"][:, None].expand((bi, bj) + row["chroma"].shape[1:])
    oti = crp.get_oti(row["gchroma"][:, None], col["gchroma"][None])
    return crp.transpose_chroma(X, oti)


def _center_ssms(row: dict, col: dict):
    """Both sides' ssms less the tile's first row song's first block (the
    origin a tile shares; exact in infinite precision)."""
    c0 = row["ssms"][0, 0]
    return dict(row, ssms=row["ssms"] - c0), dict(col, ssms=col["ssms"] - c0)


def _scores(S, l1e, l2e) -> torch.Tensor:
    """qmax and dmax of the stacked channel-major CRPs, divided by M + N:
    (2, nf, bi, bj)."""
    bi, bj = l1e.shape
    nf = S.shape[0] // (bi * bj)
    ml = l1e.reshape(-1).repeat(nf)
    nl = l2e.reshape(-1).repeat(nf)
    q = alignment.qmax_batch(S, ml, nl)
    d = alignment.dmax_batch(S, ml, nl)
    denom = torch.clamp_min(ml + nl, 1).to(torch.float32)
    return torch.stack([q / denom, d / denom]).reshape(2, nf, bi, bj)


def _named(qd: torch.Tensor, channels: list) -> dict:
    out = {}
    for k, name in enumerate(channels):
        out[f"{name}_qmax"] = qd[0, k]
        out[f"{name}_dmax"] = qd[1, k]
    return out


def serra09_tile(row: dict, col: dict, kappa: float = 0.095, m: int = 9,
                 dtype: torch.dtype = torch.float32) -> dict:
    """Serra09's four channels of every (row song, column song) pair:
    {chroma_qmax, chroma_dmax, mfcc_qmax, mfcc_dmax: (bi, bj)}. `dtype` is
    the precision of the CSM and window arithmetic."""
    bi, bj = row["length"].shape[0], col["length"].shape[0]
    L = row["chroma"].shape[1]
    l1 = row["length"].repeat_interleave(bj)
    l2 = col["length"].repeat(bi)
    ar = torch.arange(L, device=l1.device)

    def crps(X, Y, centered=False):
        Xf = X.reshape((bi * bj,) + X.shape[2:])
        Yf = Y.expand((bi, bj) + Y.shape[2:]).reshape(Xf.shape)
        if centered:
            # the row song's first frame as the pair's shared origin
            c = Xf[:, :1]
            Xf = torch.where((ar < l1[:, None])[..., None], Xf - c, 0.0)
            Yf = torch.where((ar < l2[:, None])[..., None], Yf - c, 0.0)
        S, l1e, l2e = crp.fused_binary_crp_ref(Xf, Yf, l1, l2, kappa, m,
                                               dtype)
        return S.reshape(bi, bj, L, L), l1e, l2e

    Bc, l1e, l2e = crps(_rolled_chroma(row, col), col["chroma"][None])
    Bm, _, _ = crps(row["mfcc"][:, None].expand(
        (bi, bj) + row["mfcc"].shape[1:]), col["mfcc"][None], centered=True)
    S = torch.cat([B.reshape(-1, L, L) for B in (Bc, Bm)])
    return _named(_scores(S, l1e.reshape(bi, bj), l2e.reshape(bi, bj)),
                  ["chroma", "mfcc"])


def early_snf_tile(row: dict, col: dict, kappa: float = 0.095, m: int = 9,
                   snf_niters: int = 3, sequential: bool = True) -> dict:
    """EarlySNF's eight channels (chroma, mfcc, ssms_scatter, snf; qmax and
    dmax each) of every pair of the tile, at full float32 precision with
    TF32 off: per pair the joint [[W_SSMA, W_CSM], [W_CSM^T, W_SSMB]]
    affinity of the chroma sliding-CSM and of the ssms CSM, cross-diffused
    (K = kappa (M + N) truncated, reg_diag, the reference's sequential
    update order), the fused cross block negated, each channel's matrix
    mutual-kNN binarized, then Qmax and Dmax."""
    row, col = _center_ssms(row, col)
    bi, bj = row["length"].shape[0], col["length"].shape[0]
    L = row["chroma"].shape[1]
    l1e = (row["length"] - m + 1)[:, None].expand(bi, bj)
    l2e = (col["length"] - m + 1)[None, :].expand(bi, bj)
    K = (torch.tensor(kappa, dtype=torch.float32, device=l1e.device)
         * (l1e + l2e).to(torch.float32)).to(torch.int32)
    ch1 = _rolled_chroma(row, col)
    chc = col["chroma"]
    csm_c = crp.sliding_csm_padded(crp.get_csm(ch1, chc[None]), m)
    ssma_c = crp.sliding_csm_padded(crp.get_csm(ch1, ch1), m)
    ssmb_c = crp.sliding_csm_padded(crp.get_csm(chc, chc), m)[None] \
        .expand(bi, bj, L, L)
    kmax = int(np.ceil(kappa * (2 * L))) + 1

    def build_w(sa, sb, cab):
        return fusion.get_WCSMSSM(sa, sb, cab, K, m_len=l1e, n_len=l2e,
                                  k_static_max=kmax)

    csm_s = crp.get_csm_tile(row["ssms"], col["ssms"])
    ssma_s = crp.get_ssm(row["ssms"])[:, None].expand(bi, bj, L, L)
    ssmb_s = crp.get_ssm(col["ssms"])[None].expand(bi, bj, L, L)
    Ws = torch.stack([build_w(ssma_c, ssmb_c, csm_c),
                      build_w(ssma_s, ssmb_s, csm_s)], dim=2)
    fused = fusion.snf_ws(Ws, K=K, niters=snf_niters, reg_diag=True,
                          sequential=sequential)
    cross = -fused[..., :L, L:]
    csm_m = crp.sliding_csm_padded(
        crp.get_csm_centered(row["mfcc"][:, None], col["mfcc"][None]), m)
    mats = [csm_c, csm_m, csm_s, cross]
    nf = len(mats)
    D = torch.cat([M.reshape(-1, L, L) for M in mats])
    S = crp.csm_to_binary_mutual(D, kappa,
                                 l1e.reshape(-1).repeat(nf),
                                 l2e.reshape(-1).repeat(nf))
    return _named(_scores(S, l1e, l2e),
                  ["chroma", "mfcc", "ssms_scatter", "snf"])
