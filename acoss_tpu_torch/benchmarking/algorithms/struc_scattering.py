"""StrucScattering: 2D scattering of the fused structural W (port of
`acoss_tpu.benchmarking.algorithms.struc_scattering`, after the
reference's `StrucScattering.py:35-199`).

Per chunk of songs on the device: the fused W of all three features, the
anti-aliased resize of each song's valid block to final_size^2
(`ops.structure.resize_dynamic_batch`), `Scattering2D(J=6, L=8)` one song
a call at 512^2, optionally each path L2-normalized, then the flattened
descriptors to the host. Every pair at once (`full_scores`):
exp(-||s_i - s_j||^2) from one fp32 Gram on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.algorithms.struct_common import \
    structural_fused_w_all
from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.ops.crp import gram_sqdist
from acoss_tpu_torch.ops.scattering import Scattering2D
from acoss_tpu_torch.ops.structure import resize_dynamic_batch


class StrucScattering(CoverAlgorithm):
    NAME = "StrucScattering"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True

    def __init__(self, chroma_type: str = "hpcp", wins_per_block: int = 20,
                 K: int = 10, niters: int = 10, norm_per_path: bool = True,
                 final_size: int = 512, J: int = 6, L: int = 8,
                 do_sync: bool = True, downsample_fac: int = 40,
                 tempogram_win: int = 384):
        self.chroma_type = chroma_type
        self.wins_per_block = wins_per_block
        self.K = K
        self.niters = niters
        self.norm_per_path = norm_per_path
        self.final_size = final_size
        self.do_sync = do_sync
        self.downsample_fac = downsample_fac
        self.tempogram_win = tempogram_win
        self.scattering = Scattering2D((final_size, final_size), J=J, L=L)

    def chunk_descriptors(self, Wb: torch.Tensor, lengths) -> list:
        """The flat descriptors of a chunk's fused W (B, npad, npad): the
        resize of each valid block, the scattering and the per-path
        norm."""
        # songs a scattering call: at 512^2 one song's complex first- and
        # second-order working set is ~0.5-1 GB, and the JAX package
        # measured one song a call fastest there; small sizes batch up
        sub = max(1, (128 // self.final_size) ** 2)
        Wr = resize_dynamic_batch(Wb, lengths, self.final_size)
        outs = []
        for lo in range(0, Wr.shape[0], sub):
            S = self.scattering(Wr[lo:lo + sub])       # (b, paths, m, m)
            if self.norm_per_path:
                norms = torch.sqrt(torch.sum(S * S, dim=(-2, -1),
                                             keepdim=True))
                S = S / torch.where(norms == 0, 1.0, norms)
            outs.extend(S.reshape(S.shape[0], -1).cpu().numpy())
        return outs

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """{"shingle": (N, paths * (final_size / 2^J)^2) float32} on the
        host; the fusion, resize and scattering run on `device`."""
        shingles = structural_fused_w_all(
            fs, self.chroma_type, self.wins_per_block, self.K, self.niters,
            self.do_sync, self.downsample_fac,
            fuse_features=("mfcc", "hpcp", "tempogram"),
            tempogram_win=self.tempogram_win,
            consume=lambda Wb, lengths, onsets, songs:
            self.chunk_descriptors(Wb, lengths), device=device)
        return {"shingle": np.stack(shingles).astype(np.float32)}

    def full_scores(self, desc: dict,
                    device: str | torch.device = "cuda") -> dict:
        """exp(-||s_i - s_j||^2) of every pair from the fp32 descriptors on
        the device: (N, N)."""
        return {"main": torch.exp(-gram_sqdist(desc["shingle"]))}
