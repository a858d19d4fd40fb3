"""Serra 2009 Qmax/Dmax, the flagship alignment algorithm (port of
`acoss_tpu.benchmarking.algorithms.serra09`).

- global chroma for OTI (`get_oti` over 12 shifts);
- chroma median-downsampled x40, mfcc mean-downsampled x40, both truncated
  to the common length n;
- per pair: OTI-roll -> Euclidean CSM -> m=9 diagonal window ->
  mutual-kNN binarize (kappa=0.095) -> qmax & dmax, normalized by (M + N).
- with `do_ssms`, a third channel: the Euclidean CSM of the MFCC
  block-SSM scattering descriptors (`ops.ssm_features`, 20,736 floats a
  row), binarized without a window.

A (bi x bj) tile of the pair grid builds all its binary CRPs in one
batched call per channel. On a CUDA tile with 0 < kappa < 1 every launch
is a hand-written kernel: the pairs' operands in one (`ops.serra09_cuda`),
the chroma and mfcc CRPs in the fused kernel and the ssms CRPs in the
matrix binarizer (`ops.crp_cuda`), one qmax and one dmax call on each
channel's CRPs where its call left them, and the normalised scores in one
(`ops.serra09_cuda`); otherwise the plain per-pair ops of `ops.crp` build
the CRPs and ONE qmax and ONE dmax call runs over the nf x bi x bj stacked
CRPs, the split the JAX package makes between its Pallas and XLA paths.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.ops import alignment, crp
from acoss_tpu_torch.ops.crp_cuda import (binarize_matrix_batch,
                                          binarize_matrix_ref,
                                          fused_binary_crp_batch,
                                          fused_binary_crp_ref)
from acoss_tpu_torch.ops.segment import uniform_downsample_batch
from acoss_tpu_torch.ops.serra09_cuda import (pair_operands_batch,
                                              pair_operands_ref,
                                              scores_epilogue_batch,
                                              scores_epilogue_ref)
from acoss_tpu_torch.ops.ssm_features import build_ssms_device


@functools.cache
def _side_stream(index: int) -> torch.cuda.Stream:
    """A second stream of card `index`: a tile aligns its first channel's
    CRPs there while the current stream aligns the other channels'."""
    return torch.cuda.Stream(device=index)


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
                 do_ssms: bool = False, ssm_win_mul: int = 2,
                 ssm_res: int = 64):
        self.chroma_type = chroma_type
        self.oti = oti
        self.kappa = kappa
        self.m = m
        self.downsample_fac = downsample_fac
        self.pad_to_multiple = pad_to_multiple
        self.do_ssms = do_ssms
        self.ssm_win_mul = ssm_win_mul
        self.ssm_res = ssm_res
        # an instance attribute, as in the JAX package: it is part of the
        # parameter snapshot a serving index stores (`serving._algo_params`)
        self.SIMILARITY_TYPES = Serra09.SIMILARITY_TYPES + (
            ("ssms_scatter_qmax", "ssms_scatter_dmax") if do_ssms else ())

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """Padded per-song descriptors: chroma, mfcc, gchroma and length as
        numpy arrays, and with `do_ssms` the (N, L, 20736) ssms corpus as a
        tensor already on `device`."""
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
        chromas, mfccs, gchromas, full_mfccs = [], [], [], []
        for i in range(fs.n_songs):
            gchromas.append(global_chroma(chs[i]))
            n = min(ch_all[i].shape[0], mf_all[i].shape[0])
            chromas.append(ch_all[i][:n].astype(np.float32))
            mfccs.append(mf_all[i][:n].astype(np.float32))
            if self.do_ssms:
                full_mfccs.append(np.asarray(
                    mfs[i][:n * self.downsample_fac], np.float32))
        Lmax = max(c.shape[0] for c in chromas)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        chroma_arr, lengths = pad_stack(chromas, pad_to)
        mfcc_arr, _ = pad_stack(mfccs, pad_to)
        desc = {
            "chroma": chroma_arr,
            "mfcc": mfcc_arr,
            "gchroma": np.stack(gchromas).astype(np.float32),
            "length": lengths.astype(np.int32),
        }
        if self.do_ssms:
            # sequences of scattered MFCC block-SSMs, length-matched to
            # M = n - m + 1 rows (`Serra09.py:126,146-152`), built on the
            # device: at 20,736 floats a row the corpus never visits the
            # host
            desc["ssms"] = build_ssms_device(
                full_mfccs, [max(int(n) - self.m + 1, 1) for n in lengths],
                pad_to, self.downsample_fac, self.m * self.ssm_win_mul,
                self.ssm_res, device=device)
        return desc

    def _oti(self, row: dict, col: dict) -> torch.Tensor | None:
        """(bi, bj) int64: the shift that rolls each row song's chroma
        towards each column song, or None without OTI."""
        if not self.oti:
            return None
        return crp.get_oti(row["gchroma"].unsqueeze(1),
                           col["gchroma"].unsqueeze(0))

    def _rolled_chroma(self, row: dict, col: dict) -> torch.Tensor:
        """(bi, bj, L, 12): each row song's chroma, OTI-rolled towards each
        column song."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        X = row["chroma"][:, None].expand(
            (bi, bj) + row["chroma"].shape[1:])
        oti = self._oti(row, col)
        return X if oti is None else crp.transpose_chroma(X, oti)

    def _operands(self, row: dict, col: dict, operands_fn):
        """The fused CRP's operands of every pair of the tile from
        `operands_fn` (the prep kernel's wrapper or its plain version):
        (Xc, Yc, Xm, Ym, l1, l2)."""
        return operands_fn(row["chroma"], col["chroma"], row["mfcc"],
                           col["mfcc"], row["length"], col["length"],
                           self._oti(row, col))

    def _pair_crps(self, row: dict, col: dict):
        """Binary CRPs of every pair of the tile from the plain per-pair
        ops: (Bc, Bm[, Bs]) each (bi, bj, L, L), l1e, l2e."""
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
        if not self.do_ssms:
            return (Bc, Bm), l1e, l2e
        # ssms rows are length-matched to the effective lengths already:
        # no window (`Serra09.py:188-195`); centred by tile_scores
        Bs = crp.csm_to_binary_mutual(
            crp.get_csm_tile(row["ssms"], col["ssms"]), self.kappa, l1e,
            l2e)
        return (Bc, Bm, Bs), l1e, l2e

    def _tile_crps_fused(self, row: dict, col: dict, crp_fn):
        """All (bi x bj) binary CRPs of the chroma (OTI-rolled) and mfcc
        channels from the plain pair operands through `crp_fn` (the fused
        kernel's plain version, or a caller's stand-in) and, with
        `do_ssms`, of the ssms channel from the Gram CSMs through the
        matrix binarizer's plain version; the same structure as
        `_pair_crps`."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        L = row["chroma"].shape[1]
        Xc, Yc, Xm, Ym, l1, l2 = self._operands(row, col, pair_operands_ref)

        def crps(X, Y):
            S, l1e, l2e = crp_fn(X, Y, l1, l2, self.kappa, self.m)
            return S.reshape(bi, bj, L, L), l1e, l2e

        Bc, l1e, l2e = crps(Xc, Yc)
        Bm, _, _ = crps(Xm, Ym)
        Bs = (Bc, Bm)
        if self.do_ssms:
            # the 20,736-dim ssms do not fit the fused kernel's shared
            # memory: their CSMs come from one Gram matmul (centred by
            # tile_scores), binarized in one matrix-input call
            D = crp.get_csm_tile(row["ssms"], col["ssms"])
            Bs += (binarize_matrix_ref(D.reshape(bi * bj, L, L), l1e, l2e,
                                       self.kappa).reshape(bi, bj, L, L),)
        return Bs, l1e.reshape(bi, bj), l2e.reshape(bi, bj)

    def _center_ssms(self, row: dict, col: dict):
        """Subtract a TILE-SHARED origin (the first row song's first block)
        from both sides' ssms, once per tile. Pairwise distances are
        translation invariant, so this is exact in infinite precision,
        and it removes the fp32 x^2 + y^2 - 2xy Gram cancellation of the
        large-norm scattering vectors (see `crp.get_csm_centered`); being
        shared by the tile, the centred operands stay per song, not per
        pair."""
        c0 = row["ssms"][0, 0]
        row = dict(row, ssms=row["ssms"] - c0)
        col = dict(col, ssms=col["ssms"] - c0)
        return row, col

    def _scores(self, S, l1e, l2e, plain: bool) -> torch.Tensor:
        """qmax and dmax of the channels' CRPs stacked channel-major
        (nf * bi * bj, L, L), in ONE call each, normalized by M + N:
        (2, nf, bi, bj)."""
        bi, bj = l1e.shape
        nf = S.shape[0] // (bi * bj)
        ml = l1e.reshape(-1).repeat(nf)
        nl = l2e.reshape(-1).repeat(nf)
        if plain:
            q = alignment.qmax_batch(S, ml, nl)
            d = alignment.dmax_batch(S, ml, nl)
        else:
            q = alignment.qmax_batch_best(S, ml, nl)
            d = alignment.dmax_batch_best(S, ml, nl)
        denom = torch.clamp_min(ml + nl, 1).to(torch.float32)
        return torch.stack([q / denom, d / denom]).reshape(2, nf, bi, bj)

    def _channel_scores(self, row: dict, col: dict,
                        plain: bool) -> torch.Tensor:
        """(2, nf, bi, bj) normalised qmax and dmax of the tile's channels,
        each channel's CRPs scored where its call left them: on a CUDA tile
        only hand-written kernels launch (the pair operands, the fused CRP
        and the binarizer, qmax and dmax once a channel, the epilogue).
        The aligners of the first channel run on a side stream beside the
        others': one aligner call covers a pair a block in a single wave,
        so two half-size calls in turn would take ~1.7x the device time of
        one call over both (PERF.md). `plain=True` replaces every kernel by
        its plain version, on the tensors' device, in one stream."""
        operands = pair_operands_ref if plain else pair_operands_batch
        crp_fn = fused_binary_crp_ref if plain else fused_binary_crp_batch
        binarize = binarize_matrix_ref if plain else binarize_matrix_batch
        epilogue = scores_epilogue_ref if plain else scores_epilogue_batch
        qmax = alignment.qmax_batch if plain else alignment.qmax_batch_best
        dmax = alignment.dmax_batch if plain else alignment.dmax_batch_best
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        Xc, Yc, Xm, Ym, l1, l2 = self._operands(row, col, operands)
        Sc, l1e, l2e = crp_fn(Xc, Yc, l1, l2, self.kappa, self.m)
        crps = [(Sc, l1e, l2e), crp_fn(Xm, Ym, l1, l2, self.kappa, self.m)]
        if self.do_ssms:
            # the Gram CSMs of the ssms (centred by tile_scores), binarized
            # in one matrix-input call
            D = crp.get_csm_tile(row["ssms"], col["ssms"])
            crps.append((binarize(D.reshape(Sc.shape).contiguous(), l1e,
                                  l2e, self.kappa), l1e, l2e))
        if plain:
            qd = [(qmax(*c), dmax(*c)) for c in crps]
        else:
            # every tensor the side stream reads is made on the current
            # stream before it waits, and the current stream waits for the
            # side's scores before the epilogue and before any later work
            # (and so any reuse of this tile's memory)
            cur = torch.cuda.current_stream(Sc.device)
            side = _side_stream(Sc.device.index)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                qd = [(qmax(*crps[0]), dmax(*crps[0]))]
            qd += [(qmax(*c), dmax(*c)) for c in crps[1:]]
            cur.wait_stream(side)
        q, d = zip(*qd)
        return epilogue(q, d, l1e, l2e).reshape(2, len(q), bi, bj)

    def _channels(self) -> list:
        return ["chroma", "mfcc"] + (["ssms_scatter"] if self.do_ssms
                                     else [])

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """Scores of every (row song, column song) pair of the tile.

        On a CUDA tile with 0 < kappa < 1 only hand-written kernels launch
        (`_channel_scores`); otherwise the plain per-pair CRP ops feed the
        `*_best` aligners. `plain=True` builds the kernel path's CRPs with
        every kernel replaced by its plain PyTorch version, on the
        tensors' device, and scores them stacked: the reference the kernel
        path is checked against.
        """
        if self.do_ssms:
            row, col = self._center_ssms(row, col)
        fused = 0.0 < self.kappa < 1.0
        if fused and row["chroma"].is_cuda and not plain:
            qd = self._channel_scores(row, col, plain=False)
        else:
            if fused and plain:
                Bs, l1e, l2e = self._tile_crps_fused(row, col,
                                                     fused_binary_crp_ref)
            else:
                Bs, l1e, l2e = self._pair_crps(row, col)
            L = Bs[0].shape[-1]
            qd = self._scores(torch.cat([B.reshape(-1, L, L) for B in Bs]),
                              l1e, l2e, plain)
        names = self._channels()
        flat = qd.flatten(0, 1).unbind()     # q of each channel, then d
        return {f"{name}_{kind}": flat[i * len(names) + k]
                for k, name in enumerate(names)
                for i, kind in enumerate(("qmax", "dmax"))}
