"""EarlyFusion (the reference's EarlySNF_Old): beat-blocked features +
constrained Smith-Waterman + early/late fusion (port of
`acoss_tpu.benchmarking.algorithms.early_fusion`, after
`EarlySNF_Old.py:52-241`).

- per song (host numpy, the JAX package's code): 20-beat blocks; MFCCs
  resized to 50 frames a block and Z-normalized (flattened), their SSM
  upper triangles, chroma blocks resized to 40 frames a block, median
  chroma for the OTI;
- per pair: Euclidean CSMs (blocked-OTI cosine for chroma) -> row-kNN
  `csm_to_binary(kappa=0.1)` -> `swconstrained`; EARLY fusion:
  exp(-sum_s get_WCSM(CSM_s, K, K)) -> binarize -> swconstrained;
- LATE fusion after the sweep: SNF over 1 / (1 + D) score matrices (K=20,
  20 iterations, the reference's sequential order), emitted as 'late'
  and 'early+late'.

A (bi x bj) tile builds every pair's CSMs and CRPs batched (the JAX
package vmaps per pair) and makes ONE `swconstrained_batch_best` call on
the (4 bi bj, L, L) stack, which on the card launches the SW kernel. The
row-kNN binarization and `get_WCSM` stay plain PyTorch: the JAX package
computes them outside any Pallas kernel. `post_process` runs on the
benchmark's device, where `fusion.snf`'s truncation launches the kNN
row-mask kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.ops import alignment, crp, fusion
from acoss_tpu_torch.ops.alignment_cuda import swconstrained_batch_ref


def _gauss_blur_rows_np(x: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return x
    import scipy.ndimage
    return scipy.ndimage.gaussian_filter1d(x, sigma, axis=0,
                                           mode="nearest")


def resize_rows_np(x: np.ndarray, n_out: int) -> np.ndarray:
    """Anti-aliased resize of the row axis (skimage-like), host numpy
    (block lengths vary from block to block)."""
    n_in = x.shape[0]
    if n_in == 0:
        return np.zeros((n_out, x.shape[1]), dtype=np.float64)
    if n_in == 1:
        return np.repeat(x.astype(np.float64), n_out, axis=0)
    scale = n_in / n_out
    y = _gauss_blur_rows_np(x.astype(np.float64),
                            max(0.0, (scale - 1) / 2))
    pos = np.clip((np.arange(n_out) + 0.5) * scale - 0.5, 0, n_in - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (pos - lo)[:, None]
    return y[lo] * (1 - w) + y[hi] * w


class EarlyFusion(CoverAlgorithm):
    NAME = "EarlyFusion"
    SIMILARITY_TYPES = ("mfccs", "ssms", "chromas", "early")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", blocksize: int = 20,
                 mfccs_per_block: int = 50, chromas_per_block: int = 40,
                 kappa: float = 0.1, K: int = 10,
                 late_K: int = 20, late_niters: int = 20,
                 pad_to_multiple: int = 64, sequential: bool = True):
        self.sequential = sequential
        self.chroma_type = chroma_type
        self.blocksize = blocksize
        self.mfccs_per_block = mfccs_per_block
        self.chromas_per_block = chromas_per_block
        self.kappa = kappa
        self.K = K
        self.late_K = late_K
        self.late_niters = late_niters
        self.pad_to_multiple = pad_to_multiple

    def _song(self, fs: FeatureSet, i: int):
        chroma = fs.feature(self.chroma_type)[i,
                                              :fs.length(self.chroma_type)[i]]
        mfcc = np.nan_to_num(
            fs.feature("mfcc_htk")[i, :fs.length("mfcc_htk")[i]])
        onsets = fs.feature("onsets")[i, :fs.length("onsets")[i], 0]
        n_blocks = max(len(onsets) - self.blocksize, 0)
        d = mfcc.shape[1]
        mpb, cpb = self.mfccs_per_block, self.chromas_per_block
        iu = np.triu_indices(mpb, 1)
        mfccs = np.zeros((max(n_blocks, 1), mpb * d), np.float32)
        ssms = np.zeros((max(n_blocks, 1), len(iu[0])), np.float32)
        chromas = np.zeros((max(n_blocks, 1), cpb * 12), np.float32)
        for b in range(n_blocks):
            x = resize_rows_np(
                mfcc[onsets[b]:onsets[b + self.blocksize - 1]], mpb)
            x = x - x.mean(axis=0, keepdims=True)
            norms = np.sqrt(np.sum(x ** 2, axis=1, keepdims=True))
            xn = x / np.where(norms == 0, 1.0, norms)
            mfccs[b] = xn.ravel()
            sq = np.sum(xn * xn, axis=1)
            D2 = np.maximum(sq[:, None] + sq[None, :] - 2 * xn @ xn.T, 0)
            np.fill_diagonal(D2, 0)
            ssms[b] = np.sqrt(D2)[iu]
            c = resize_rows_np(
                chroma[onsets[b]:onsets[b + self.blocksize]], cpb)
            chromas[b] = c.ravel()
        return mfccs, ssms, chromas, np.median(chroma, axis=0), n_blocks

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """Padded per-song descriptors as host numpy arrays (the sweep
        uploads them to `device` once): mfccs (N, L, 50*13), ssms (N, L,
        1225), chromas (N, L, 40*12), chroma_med (N, 12) and the block
        counts `length` (N,), L the largest count rounded up to
        `pad_to_multiple`."""
        per = [self._song(fs, i) for i in range(fs.n_songs)]
        Lmax = max(p[4] for p in per)
        pad_to = max(-(-Lmax // self.pad_to_multiple) * self.pad_to_multiple,
                     self.pad_to_multiple)
        out = {}
        for k, name in enumerate(("mfccs", "ssms", "chromas")):
            out[name], _ = pad_stack([p[k] for p in per], pad_to)
        out["chroma_med"] = np.stack(
            [p[3] for p in per]).astype(np.float32)
        out["length"] = np.array([p[4] for p in per], np.int32)
        return out

    def _tile_crps(self, row: dict, col: dict):
        """The four binary CRPs (mfccs, ssms, chromas, early) of every pair
        of the tile, each (bi, bj, L, L), and the lengths l1, l2 (bi, bj)."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        l1 = row["length"][:, None].expand(bi, bj)
        l2 = col["length"][None, :].expand(bi, bj)
        csm_m = crp.get_csm_tile(row["mfccs"], col["mfccs"])
        csm_s = crp.get_csm_tile(row["ssms"], col["ssms"])
        csm_c = crp.get_csm_blocked_oti(
            row["chromas"][:, None], col["chromas"][None],
            row["chroma_med"][:, None], col["chroma_med"][None])
        csms = (csm_m, csm_s, csm_c)
        Bs = [crp.csm_to_binary(x, self.kappa, l1, l2) for x in csms]
        # EARLY fusion: sum of exponential cross affinities, binarized with
        # the distance convention as the reference does
        # (`EarlySNF_Old.py:211-216`)
        wsum = sum(fusion.get_WCSM(x, self.K, self.K, row_length=l1,
                                   col_length=l2) for x in csms)
        Bs.append(crp.csm_to_binary(torch.exp(-wsum), self.kappa, l1, l2))
        return Bs, l1, l2

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """Scores of every (row song, column song) pair of the tile: ONE
        constrained-SW call on the four channels' stacked CRPs (the
        kernel on a CUDA tile; `plain=True` calls its plain version, on
        the tensors' device)."""
        Bs, l1, l2 = self._tile_crps(row, col)
        bi, bj, L, _ = Bs[0].shape
        S = torch.cat([B.reshape(-1, L, L) for B in Bs])
        ml = l1.reshape(-1).repeat(4)
        nl = l2.reshape(-1).repeat(4)
        sw = (swconstrained_batch_ref if plain
              else alignment.swconstrained_batch_best)(S, ml, nl)
        sw = sw.reshape(4, bi, bj)
        return {name: sw[k] for k, name in enumerate(self.SIMILARITY_TYPES)}

    def post_process(self, Ds: dict, desc: dict,
                     device: str | torch.device = "cuda") -> dict:
        """Late fusion of the swept score matrices on `device`: SNF of the
        chromas, ssms and mfccs channels ('late'), and of those and the
        early channel ('early+late')."""
        out = dict(Ds)
        D = {s: torch.from_numpy(Ds[s]).to(device)
             for s in self.SIMILARITY_TYPES}
        late_in = [1.0 / (1.0 + D[s]) for s in ("chromas", "ssms", "mfccs")]
        for name, mats in (("late", late_in),
                           ("early+late",
                            late_in + [1.0 / (1.0 + D["early"])])):
            _, fused = fusion.snf(torch.stack(mats), K=self.late_K,
                                  niters=self.late_niters, reg_diag=True,
                                  sequential=self.sequential)
            out[name] = fused.cpu().numpy().astype(np.float32)
        return out
