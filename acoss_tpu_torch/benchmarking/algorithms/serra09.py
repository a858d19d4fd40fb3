"""Serra 2009 Qmax/Dmax, the flagship alignment algorithm (port of
`acoss_tpu.benchmarking.algorithms.serra09` with `do_ssms=False`).

- global chroma for OTI (`get_oti` over 12 shifts);
- chroma median-downsampled x40, mfcc mean-downsampled x40, both truncated
  to the common length n;
- per pair: OTI-roll -> Euclidean CSM -> m=9 diagonal window ->
  mutual-kNN binarize (kappa=0.095) -> qmax & dmax, normalized by (M + N).

A (bi x bj) tile of the pair grid builds all its binary CRPs in one
batched call per channel and runs ONE qmax and ONE dmax call over the
2 x bi x bj stacked CRPs (chroma + mfcc share the alignment batch). On a
CUDA tile with 0 < kappa < 1 the CRPs come from the fused CUDA kernel
(`ops.crp_cuda`); otherwise from the plain per-pair ops of `ops.crp`,
the split the JAX package makes between its Pallas and XLA paths.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.ops import alignment, crp
from acoss_tpu_torch.ops.crp_cuda import (fused_binary_crp_batch,
                                          fused_binary_crp_ref)
from acoss_tpu_torch.ops.segment import uniform_downsample_batch


def global_chroma(chroma: np.ndarray) -> np.ndarray:
    """Sum over frames, normalized by its max."""
    s = chroma.sum(axis=0)
    return s / max(s.max(), 1e-12)


class Serra09(CoverAlgorithm):
    NAME = "Serra09"
    SYMMETRIC = True
    TILE = 8
    SIMILARITY_TYPES = ("chroma_qmax", "chroma_dmax", "mfcc_qmax",
                        "mfcc_dmax")

    def __init__(self, chroma_type: str = "hpcp", oti: bool = True,
                 kappa: float = 0.095, m: int = 9,
                 downsample_fac: int = 40, pad_to_multiple: int = 64,
                 do_ssms: bool = False):
        if do_ssms:
            raise NotImplementedError(
                "Serra09 do_ssms=True needs the MFCC-SSM scattering "
                "descriptors and the matrix binarizer, not ported yet "
                "(ROADMAP Queue A, slice 3)")
        self.chroma_type = chroma_type
        self.oti = oti
        self.kappa = kappa
        self.m = m
        self.downsample_fac = downsample_fac
        self.pad_to_multiple = pad_to_multiple

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        clen = fs.length(self.chroma_type)
        mlen = fs.length("mfcc_htk")
        chs = [fs.feature(self.chroma_type)[i, :clen[i]]
               for i in range(fs.n_songs)]
        mfs = [np.nan_to_num(fs.feature("mfcc_htk")[i, :mlen[i]],
                             nan=0.0, posinf=0.0, neginf=0.0)
               for i in range(fs.n_songs)]
        ch_all = uniform_downsample_batch(chs, self.downsample_fac,
                                          "median", device=device)
        mf_all = uniform_downsample_batch(mfs, self.downsample_fac,
                                          "mean", device=device)
        chromas, mfccs, gchromas = [], [], []
        for i in range(fs.n_songs):
            gchromas.append(global_chroma(chs[i]))
            n = min(ch_all[i].shape[0], mf_all[i].shape[0])
            chromas.append(ch_all[i][:n].astype(np.float32))
            mfccs.append(mf_all[i][:n].astype(np.float32))
        Lmax = max(c.shape[0] for c in chromas)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        chroma_arr, lengths = pad_stack(chromas, pad_to)
        mfcc_arr, _ = pad_stack(mfccs, pad_to)
        return {
            "chroma": chroma_arr,
            "mfcc": mfcc_arr,
            "gchroma": np.stack(gchromas).astype(np.float32),
            "length": lengths.astype(np.int32),
        }

    def _rolled_chroma(self, row: dict, col: dict) -> torch.Tensor:
        """(bi, bj, L, 12): each row song's chroma, OTI-rolled towards each
        column song."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        X = row["chroma"][:, None].expand(
            (bi, bj) + row["chroma"].shape[1:])
        if not self.oti:
            return X
        oti = crp.get_oti(row["gchroma"][:, None], col["gchroma"][None])
        return crp.transpose_chroma(X, oti)

    def _pair_crps(self, row: dict, col: dict):
        """Binary CRPs (chroma + mfcc) of every pair of the tile from the
        plain per-pair ops: (Bc, Bm) each (bi, bj, L, L), l1e, l2e."""
        m = self.m
        l1e = (row["length"] - m + 1)[:, None]
        l2e = (col["length"] - m + 1)[None, :]
        l1e, l2e = torch.broadcast_tensors(l1e, l2e)

        def make(x1, x2, centered=False):
            csm = (crp.get_csm_centered if centered else crp.get_csm)(
                x1, x2)
            csm = crp.sliding_csm_padded(csm, m)
            return crp.csm_to_binary_mutual(csm, self.kappa, l1e, l2e)

        Bc = make(self._rolled_chroma(row, col), col["chroma"][None])
        # mfcc centered: HTK MFCCs carry a large leading energy term on
        # real audio, the classic fp32 Gram-cancellation case
        Bm = make(row["mfcc"][:, None], col["mfcc"][None], centered=True)
        return (Bc, Bm), l1e, l2e

    def _tile_crps_fused(self, row: dict, col: dict, crp_fn):
        """All (bi x bj) binary CRPs of the chroma (OTI-rolled) and mfcc
        channels from `crp_fn` (the fused kernel's wrapper or its plain
        version); the same structure as `_pair_crps`."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        L = row["chroma"].shape[1]
        l1 = row["length"].repeat_interleave(bj)
        l2 = col["length"].repeat(bi)
        ar = torch.arange(L, device=l1.device)

        def crps(X, Y, centered=False):
            Xf = X.reshape((bi * bj,) + X.shape[2:])
            Yf = Y.expand((bi, bj) + Y.shape[2:]).reshape(Xf.shape)
            if centered:
                # the per-pair shared origin of `crp.get_csm_centered` (the
                # row song's first frame), zero past the lengths
                c = Xf[:, :1]
                Xf = torch.where((ar < l1[:, None])[..., None], Xf - c, 0.0)
                Yf = torch.where((ar < l2[:, None])[..., None], Yf - c, 0.0)
            S, l1e, l2e = crp_fn(Xf.contiguous(), Yf.contiguous(), l1, l2,
                                 self.kappa, self.m)
            return S.reshape(bi, bj, L, L), l1e, l2e

        Bc, l1e, l2e = crps(self._rolled_chroma(row, col),
                            col["chroma"][None])
        Bm, _, _ = crps(row["mfcc"][:, None].expand(
            (bi, bj) + row["mfcc"].shape[1:]), col["mfcc"][None],
            centered=True)
        return (Bc, Bm), l1e.reshape(bi, bj), l2e.reshape(bi, bj)

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """Scores of every (row song, column song) pair of the tile.

        On a CUDA tile with 0 < kappa < 1 the CRPs come from the fused
        kernel and the aligners run their kernels; otherwise the plain
        per-pair CRP ops feed the `*_best` aligners. `plain=True` takes the
        kernel path's composition with every kernel replaced by its plain
        PyTorch version, on the tensors' device: the reference the kernel
        path is checked against.
        """
        fused = 0.0 < self.kappa < 1.0 and (plain or row["chroma"].is_cuda)
        if fused:
            Bs, l1e, l2e = self._tile_crps_fused(
                row, col,
                fused_binary_crp_ref if plain else fused_binary_crp_batch)
        else:
            Bs, l1e, l2e = self._pair_crps(row, col)
        nf = len(Bs)
        bi, bj, L, _ = Bs[0].shape
        S = torch.cat([B.reshape(-1, L, L) for B in Bs])
        ml = l1e.reshape(-1).repeat(nf)
        nl = l2e.reshape(-1).repeat(nf)
        if plain:
            q = alignment.qmax_batch(S, ml, nl)
            d = alignment.dmax_batch(S, ml, nl)
        else:
            q = alignment.qmax_batch_best(S, ml, nl)
            d = alignment.dmax_batch_best(S, ml, nl)
        denom = torch.clamp_min(ml + nl, 1).to(torch.float32)
        q = (q / denom).reshape(nf, bi, bj)
        d = (d / denom).reshape(nf, bi, bj)
        return {"chroma_qmax": q[0], "chroma_dmax": d[0],
                "mfcc_qmax": q[1], "mfcc_dmax": d[1]}
