"""ChenFusion: blocked-OTI qmax/dmax with length normalization and late SNF
(port of `acoss_tpu.benchmarking.algorithms.chen_fusion`, after the
reference's `ChenFusion.py:17-109`).

- descriptors: global chroma, and chroma median-downsampled x40 (on the
  device) -> delay embedding (`segment.stack_memory`, host numpy);
- pair score: blocked-OTI Euclidean CSM -> `csm_to_binary` (NON-mutual
  row kNN) -> RAW qmax and dmax (no (M + N) division);
- after the sweep: `normalize_by_length` (sqrt(len_j) / score per COLUMN
  song, on the host), late SNF of the two normalized matrices (K=20, 20
  iterations, the reference's sequential order) on the benchmark's
  device, then the per-kernel matrices negated so larger = closer.

The reference's `stack_memory(chroma, self.tau, self.m)` binds n_steps=1,
delay=9: an identity. The default `stack_n_steps=1` reproduces it;
`stack_n_steps=None` selects the intended Chen 2017 embedding (n_steps=m,
delay=tau).

A (bi x bj) tile builds every pair's CSM and CRP in batched calls and
makes ONE qmax and ONE dmax call on the (bi bj, L, L) stack, which on the
card launch the qmax and dmax kernels. The row-kNN binarization is a row
sort (XLA in the JAX package, outside any Pallas kernel); the late SNF's
truncation launches the kNN row-mask kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.algorithms.serra09 import global_chroma
from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.ops import alignment, crp, fusion
from acoss_tpu_torch.ops.alignment_cuda import dmax_batch_ref, qmax_batch_ref
from acoss_tpu_torch.ops.segment import (stack_memory,
                                         uniform_downsample_batch)


class ChenFusion(CoverAlgorithm):
    NAME = "ChenFusion"
    SIMILARITY_TYPES = ("qmax", "dmax")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", oti: bool = True,
                 kappa: float = 0.095, tau: int = 1, m: int = 9,
                 downsample_fac: int = 40, stack_n_steps: int | None = 1,
                 late_K: int = 20, late_niters: int = 20,
                 pad_to_multiple: int = 64, sequential: bool = True):
        self.chroma_type = chroma_type
        self.oti = oti
        self.kappa = kappa
        self.tau = tau
        self.m = m
        self.downsample_fac = downsample_fac
        self.stack_n_steps = m if stack_n_steps is None else stack_n_steps
        self.late_K = late_K
        self.late_niters = late_niters
        self.pad_to_multiple = pad_to_multiple
        self.sequential = sequential

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """Host numpy: stacked (N, L, 12 stack_n_steps), gchroma (N, 12),
        length (N,); the downsampling runs on `device`."""
        clen = fs.length(self.chroma_type)
        chs = [fs.feature(self.chroma_type)[i, :clen[i]]
               for i in range(fs.n_songs)]
        ch_all = uniform_downsample_batch(chs, self.downsample_fac,
                                          "median", device=device)
        stacked = [stack_memory(c, self.stack_n_steps, self.tau)
                   .astype(np.float32) for c in ch_all]
        Lmax = max(s.shape[0] for s in stacked)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        arr, lengths = pad_stack(stacked, pad_to)
        return {
            "stacked": arr,
            "gchroma": np.stack([global_chroma(c) for c in chs])
            .astype(np.float32),
            "length": lengths.astype(np.int32),
        }

    def tile_crps(self, row: dict, col: dict):
        """The binary CRPs of every pair of the tile, (bi, bj, L, L) uint8,
        and the lengths l1, l2 (bi, bj)."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        X, Y = row["stacked"][:, None], col["stacked"][None]
        if self.oti:
            csm = crp.get_csm_blocked_oti(X, Y, row["gchroma"][:, None],
                                          col["gchroma"][None], crp.get_csm)
        else:
            csm = crp.get_csm(X, Y)
        l1 = row["length"][:, None].expand(bi, bj)
        l2 = col["length"][None, :].expand(bi, bj)
        return crp.csm_to_binary(csm, self.kappa, l1, l2), l1, l2

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """Raw qmax and dmax of every pair of the tile, one call each on
        the (bi bj, L, L) CRP stack (the kernels on a CUDA tile;
        `plain=True` calls their plain versions, on the tensors'
        device)."""
        B, l1, l2 = self.tile_crps(row, col)
        bi, bj, L, _ = B.shape
        S = B.reshape(-1, L, L)
        ml, nl = l1.reshape(-1), l2.reshape(-1)
        if plain:
            q, d = qmax_batch_ref(S, ml, nl), dmax_batch_ref(S, ml, nl)
        else:
            q = alignment.qmax_batch_best(S, ml, nl)
            d = alignment.dmax_batch_best(S, ml, nl)
        return {"qmax": q.reshape(bi, bj), "dmax": d.reshape(bi, bj)}

    def post_process(self, Ds: dict, desc: dict,
                     device: str | torch.device = "cuda") -> dict:
        """normalize_by_length on the host, late SNF of the two distance
        matrices on `device` ('Late'), the per-kernel matrices negated."""
        norm = np.sqrt(np.asarray(desc["length"], np.float64))[None, :]
        out = {}
        for k in ("qmax", "dmax"):
            D = np.asarray(Ds[k], dtype=np.float64)
            out[k] = (norm / np.maximum(D, 1e-12)).astype(np.float32)
        stackD = torch.from_numpy(np.stack([out["qmax"], out["dmax"]])) \
            .to(device)
        _, late = fusion.snf(stackD, K=self.late_K, niters=self.late_niters,
                             reg_diag=True, sequential=self.sequential)
        result = {k: -v for k, v in out.items()}
        result["Late"] = late.cpu().numpy().astype(np.float32)
        return result
