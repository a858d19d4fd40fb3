"""StrucFTM2D / StrucShingles: sparse shingles of the fused structural W
(port of `acoss_tpu.benchmarking.algorithms.struc_ftm2d`).

- StrucFTM2D (the reference's `StrucFTM2D.py:30-189`): the fused W of
  MFCC and HPCP (`StrucFTM2D.py:119`) zero-padded to PAD_LEN^2, its 2D-FFT
  magnitude, the L2-normalized log shingle cut to its 5 * PAD_LEN largest
  entries; every pair scored exp(-d^2) by one sparse Gram
  (`StrucFTM2D.py:173-189`).
- StrucShingles (`StrucShingles.py:32-170`): the same without the FFT.

The fused W, the FFT and the top-k run on the device a chunk of songs at
a time; only the sparse (idx, val) shingles come back. The descriptors
are ragged: lists of per-song arrays and the dense width `dim`.
`full_scores` keeps the JAX package's dispatch (`ops.sparse_gram`): scipy
on the host up to HOST_MAX_N songs or past UNION_MAX union columns, the
dense-over-union Gram on the device otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.algorithms.struct_common import (
    sparse_top_shingle, structural_fused_w, structural_fused_w_all)
from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.ops.sparse_gram import (host_gram_scores,
                                             sparse_gram_scores)
from acoss_tpu_torch.ops.structure import shingle_topk_batch


class StrucFTM2D(CoverAlgorithm):
    NAME = "StrucFTM2D"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True
    DO_FFT = True
    FUSE_FEATURES = ("mfcc", "hpcp")

    # the JAX package's dispatch (`struc_ftm2d.py:105-114`): past
    # UNION_MAX union columns the supports are not concentrated and the
    # dense-over-union product loses its economics; up to HOST_MAX_N songs
    # the host SpGEMM takes under a second
    UNION_MAX = 1 << 21
    HOST_MAX_N = 512

    def __init__(self, chroma_type: str = "hpcp", wins_per_block: int = 20,
                 K: int = 10, niters: int = 10, do_sync: bool = True,
                 downsample_fac: int = 40, PAD_LEN: int = 2000,
                 tempogram_win: int = 384):
        self.chroma_type = chroma_type
        self.wins_per_block = wins_per_block
        self.K = K
        self.niters = niters
        self.do_sync = do_sync
        self.downsample_fac = downsample_fac
        self.PAD_LEN = PAD_LEN
        self.tempogram_win = tempogram_win

    def _fuse_kw(self) -> dict:
        return dict(chroma_type=self.chroma_type,
                    wins_per_block=self.wins_per_block, K=self.K,
                    niters=self.niters, do_sync=self.do_sync,
                    downsample_fac=self.downsample_fac,
                    fuse_features=self.FUSE_FEATURES,
                    tempogram_win=self.tempogram_win)

    def _song_shingle(self, fs: FeatureSet, i: int,
                      device: str | torch.device = "cuda"):
        """Song i's shingle by the per-song path: (indices, values)."""
        W, _ = structural_fused_w(fs, i, device=device, **self._fuse_kw())
        P = self.PAD_LEN
        n = min(P, W.shape[0])
        Wres = np.zeros((P, P), dtype=np.float32)
        Wres[:n, :n] = W[:n, :n]
        if self.DO_FFT:
            flat = torch.abs(torch.fft.fft2(torch.from_numpy(Wres)
                                            .to(device))).cpu().numpy()
        else:
            flat = Wres
        return sparse_top_shingle(flat.ravel(), 5 * P)

    def chunk_shingles(self, Wb: torch.Tensor, lengths) -> list:
        """The shingles of a chunk's fused W (B, npad, npad): per song
        (indices int64, values float32) sorted by index."""
        idx, val = shingle_topk_batch(Wb, lengths, self.PAD_LEN,
                                      5 * self.PAD_LEN, self.DO_FFT)
        idx = idx.cpu().numpy().astype(np.int64)
        val = val.cpu().numpy()
        outs = []
        for b in range(idx.shape[0]):
            keep = idx[b] >= 0
            ix, v = idx[b][keep], val[b][keep]
            order = np.argsort(ix)
            outs.append((ix[order], v[order]))
        return outs

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """{"idx": [(nnz_i,) int64], "val": [(nnz_i,) float32], "dim":
        PAD_LEN^2}, each song's shingle sorted by index; the fused W, the
        FFT and the top-k run on `device`."""
        shingles = structural_fused_w_all(
            fs, consume=lambda Wb, lengths, onsets, songs:
            self.chunk_shingles(Wb, lengths), device=device,
            **self._fuse_kw())
        return {"idx": [s[0] for s in shingles],
                "val": [s[1] for s in shingles],
                "dim": self.PAD_LEN * self.PAD_LEN}

    def full_scores(self, desc: dict,
                    device: str | torch.device = "cuda") -> dict:
        """exp(-d^2) of every pair (`StrucFTM2D.py:173-189`): (N, N) host
        float32, from scipy or from the union Gram on `device`."""
        return {"main": sparse_gram_scores(
            desc["idx"], desc["val"], desc["dim"], union_max=self.UNION_MAX,
            host_max_n=self.HOST_MAX_N, device=device)}

    def full_scores_host(self, desc: dict) -> dict:
        """The reference-shaped host path, for parity tests."""
        return {"main": host_gram_scores(desc["idx"], desc["val"],
                                         desc["dim"])}


class StrucShingles(StrucFTM2D):
    """StrucFTM2D without the 2D FFT (`StrucShingles.py:132-142`)."""

    NAME = "StrucShingles"
    DO_FFT = False
