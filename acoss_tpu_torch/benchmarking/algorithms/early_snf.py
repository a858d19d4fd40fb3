"""EarlySNF: per-pair early similarity-network fusion + qmax/dmax (port of
`acoss_tpu.benchmarking.algorithms.early_snf`, after the reference's
`EarlySNF.py:12-97`, which extends Serra09).

Per pair: build the joint [[W_SSMA, W_CSM], [W_CSM^T, W_SSMB]] affinity
(`fusion.get_WCSMSSM`) of the chroma sliding-CSM features and of the
MFCC block-SSM scattering features, cross-diffuse the two (`snf_ws`,
K = kappa * (M + N) truncated, 3 iterations, reg_diag, the reference's
sequential update order), negate the fused cross block, mutual-kNN
binarize it and run qmax/dmax, emitting the plain Serra09 channels on the
way. Channel order: chroma, mfcc, ssms_scatter, snf.

A (bi x bj) tile runs every pair at once: the fusion is batched over the
tile's pairs (padded layout: song A's rows at [0:L), song B's at
[L:2L), so the fused cross block is a static slice). On a CUDA tile with
0 < kappa < 1 all nf x bi x bj matrices go through ONE call of the
matrix binarizer kernel, the SNF truncation through the kNN row-mask
kernel, and in the throughput mode (`snf_precision="default"`) the
affinities through the fused WCSMSSM kernel (`ops.crp_cuda`).
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.algorithms.serra09 import Serra09
from acoss_tpu_torch.ops import crp, fusion
from acoss_tpu_torch.ops.crp_cuda import (binarize_matrix_batch,
                                          binarize_matrix_ref)


class EarlySNF(Serra09):
    NAME = "EarlySNF"
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", oti: bool = True,
                 kappa: float = 0.095, m: int = 9,
                 downsample_fac: int = 40, pad_to_multiple: int = 64,
                 snf_niters: int = 3, do_ssms: bool = True,
                 ssm_win_mul: int = 2, ssm_res: int = 64,
                 sequential: bool = True,
                 snf_precision: str = "highest"):
        if snf_precision not in ("highest", "default"):
            raise ValueError(f"unknown snf_precision {snf_precision!r}")
        super().__init__(chroma_type=chroma_type, oti=oti, kappa=kappa,
                         m=m, downsample_fac=downsample_fac,
                         pad_to_multiple=pad_to_multiple, do_ssms=do_ssms,
                         ssm_win_mul=ssm_win_mul, ssm_res=ssm_res)
        self.snf_niters = snf_niters
        # sequential=True pins the reference's in-place SNF update order
        # (`fusion.snf_ws`) for upstream-comparable numbers
        self.sequential = sequential
        # "highest" is the parity setting; "default" the throughput mode
        # (bf16-rounded diffusion operands, and the fused WCSMSSM kernel
        # on the card; CLI --snf-precision)
        self.snf_precision = snf_precision
        self.SIMILARITY_TYPES = self.SIMILARITY_TYPES + (
            "snf_qmax", "snf_dmax")

    def _pair_mats(self, row: dict, col: dict, fast_w: bool = False,
                   plain: bool = False):
        """The matrices the tile binarizes, each (bi, bj, L, L), in channel
        order: chroma sliding CSM, mfcc sliding CSM, [ssms CSM,] negated
        fused SNF cross block; and l1e, l2e (bi, bj).

        fast_w: build the affinities with `fusion.get_WCSMSSM_fast` (the
        throughput mode) instead of the exact `get_WCSMSSM`. plain: the
        kernels' plain versions replace their wrappers."""
        m = self.m
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        L = row["chroma"].shape[1]
        l1e = (row["length"] - m + 1)[:, None].expand(bi, bj)
        l2e = (col["length"] - m + 1)[None, :].expand(bi, bj)
        # a float32 product, then TRUNCATION (`early_snf.py:73`); the
        # binarizer's k rounds instead
        K = (torch.tensor(self.kappa, dtype=torch.float32,
                          device=l1e.device)
             * (l1e + l2e).to(torch.float32)).to(torch.int32)

        ch1 = self._rolled_chroma(row, col)                  # per pair
        chc = col["chroma"]
        csm_c = crp.sliding_csm_padded(crp.get_csm(ch1, chc[None]), m)
        ssma_c = crp.sliding_csm_padded(crp.get_csm(ch1, ch1), m)
        ssmb_c = crp.sliding_csm_padded(crp.get_csm(chc, chc), m)[None] \
            .expand(bi, bj, L, L)
        # K <= kappa * (padded widths): the affinities' row selections need
        # only that many smallest values (the same values as a full sort)
        kmax = int(np.ceil(self.kappa * (2 * L))) + 1

        def build_w(sa, sb, cab):
            if fast_w:
                return fusion.get_WCSMSSM_fast(sa, sb, cab, K, m_len=l1e,
                                               n_len=l2e, plain=plain)
            return fusion.get_WCSMSSM(sa, sb, cab, K, m_len=l1e, n_len=l2e,
                                      k_static_max=kmax)

        Ws = [build_w(ssma_c, ssmb_c, csm_c)]
        if self.do_ssms:
            # ssms arrive centred by tile_scores (tile-shared origin)
            csm_s = crp.get_csm_tile(row["ssms"], col["ssms"])
            ssma_s = crp.get_ssm(row["ssms"])[:, None].expand(bi, bj, L, L)
            ssmb_s = crp.get_ssm(col["ssms"])[None].expand(bi, bj, L, L)
            Ws.append(build_w(ssma_s, ssmb_s, csm_s))
        Ws = torch.stack(Ws, dim=2)           # (bi, bj, F, 2L, 2L)
        fused = fusion.snf_ws(Ws, K=K, niters=self.snf_niters,
                              reg_diag=True, sequential=self.sequential,
                              precision=self.snf_precision, plain=plain)
        cross = -fused[..., :L, L:]   # similarity -> "distance" to binarize

        # the plain Serra09 channels on the way (`EarlySNF.py:60-83`)
        csm_m = crp.sliding_csm_padded(
            crp.get_csm_centered(row["mfcc"][:, None], col["mfcc"][None]), m)
        mats = [csm_c, csm_m] + ([csm_s] if self.do_ssms else []) + [cross]
        return mats, l1e, l2e

    def _pair_ws(self, row: dict, col: dict):
        """Binary CRPs of every pair of the tile from the plain per-pair
        binarization (the path off the kernels), each (bi, bj, L, L)."""
        mats, l1e, l2e = self._pair_mats(row, col)
        return ([crp.csm_to_binary_mutual(M, self.kappa, l1e, l2e)
                 for M in mats], l1e, l2e)

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """Scores of every (row song, column song) pair of the tile.

        On a CUDA tile with 0 < kappa < 1 every channel's matrices go
        through one call of the matrix binarizer kernel (and the throughput
        mode builds the affinities in the fused WCSMSSM kernel); otherwise
        the plain per-pair binarization. `plain=True` takes the kernel
        path's composition with every kernel replaced by its plain PyTorch
        version, on the tensors' device.
        """
        if self.do_ssms:
            row, col = self._center_ssms(row, col)
        L = row["chroma"].shape[1]
        if 0.0 < self.kappa < 1.0 and (plain or row["chroma"].is_cuda):
            mats, l1e, l2e = self._pair_mats(
                row, col, fast_w=self.snf_precision == "default",
                plain=plain)
            nf = len(mats)
            D = torch.cat([M.reshape(-1, L, L) for M in mats])
            binarize = binarize_matrix_ref if plain else binarize_matrix_batch
            S = binarize(D, l1e.reshape(-1).repeat(nf).contiguous(),
                         l2e.reshape(-1).repeat(nf).contiguous(), self.kappa)
        else:
            Bs, l1e, l2e = self._pair_ws(row, col)
            S = torch.cat([B.reshape(-1, L, L) for B in Bs])
        qd = self._scores(S, l1e, l2e, plain)
        out = {}
        for k, name in enumerate(self._channels() + ["snf"]):
            out[f"{name}_qmax"] = qd[0, k]
            out[f"{name}_dmax"] = qd[1, k]
        return out
