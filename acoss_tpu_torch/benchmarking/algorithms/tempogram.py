"""TGAlg: tempogram qmax/dmax (port of
`acoss_tpu.benchmarking.algorithms.tempogram`, after the reference's
`Tempogram.py:13-70`).

- descriptors: autocorrelation tempograms of the RNN and superflux
  novelty functions, mean-aggregated over windows of 40 frames
  (`features.rhythm.tempogram_aggregated_batch`, on the device);
- pair score, per novelty function: centred Euclidean CSM -> non-mutual
  row-kNN `csm_to_binary` -> qmax and dmax, divided by (M + N).

A (bi x bj) tile stacks both functions' CRPs, (2 bi bj, L, L), and makes
ONE qmax and ONE dmax call on them, which on the card launch the qmax and
dmax kernels; the row-kNN binarization is a row sort.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.features.rhythm import tempogram_aggregated_batch
from acoss_tpu_torch.ops import alignment, crp
from acoss_tpu_torch.ops.alignment_cuda import dmax_batch_ref, qmax_batch_ref

CHANNELS = (("rnn", "rnn_len"), ("sflux", "sflux_len"))


class TGAlg(CoverAlgorithm):
    NAME = "TGAlg"
    SIMILARITY_TYPES = ("tempogram_rnn_qmax", "tempogram_rnn_dmax",
                        "tempogram_sflux_qmax", "tempogram_sflux_dmax")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, kappa: float = 0.095, downsample_fac: int = 40,
                 win_length: int = 384, pad_to_multiple: int = 64):
        self.kappa = kappa
        self.downsample_fac = downsample_fac
        self.win_length = win_length
        self.pad_to_multiple = pad_to_multiple

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """Host numpy: rnn and sflux (N, L, win_length) and their lengths;
        the tempograms are computed on `device`."""
        envs, bounds = [], []
        for name in ("novfn", "snovfn"):
            ln = fs.length(name)
            for i in range(fs.n_songs):
                envs.append(fs.feature(name)[i, :ln[i], 0])
                bounds.append(np.arange(0, ln[i], self.downsample_fac))
        tgs = [t.astype(np.float32) for t in tempogram_aggregated_batch(
            envs, bounds, self.win_length, device=device)]
        rnn, sflux = tgs[:fs.n_songs], tgs[fs.n_songs:]
        Lmax = max(x.shape[0] for x in rnn + sflux)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        rnn_arr, rlen = pad_stack(rnn, pad_to)
        sflux_arr, slen = pad_stack(sflux, pad_to)
        return {"rnn": rnn_arr, "sflux": sflux_arr,
                "rnn_len": rlen.astype(np.int32),
                "sflux_len": slen.astype(np.int32)}

    def tile_crps(self, row: dict, col: dict):
        """Both channels' binary CRPs of every pair of the tile stacked,
        (2 bi bj, L, L) uint8, and their lengths (2 bi bj,) each."""
        bi, bj = row["rnn_len"].shape[0], col["rnn_len"].shape[0]
        Bs, ml, nl = [], [], []
        for key, lkey in CHANNELS:
            # centred: tempogram rows are highly correlated, so pair
            # distances are small against their norms and the plain fp32
            # Gram loses ~5e-4, above the smallest k-th-neighbour margins
            csm = crp.get_csm_centered(row[key][:, None], col[key][None])
            l1 = row[lkey][:, None].expand(bi, bj)
            l2 = col[lkey][None, :].expand(bi, bj)
            B = crp.csm_to_binary(csm, self.kappa, l1, l2)
            Bs.append(B.reshape((-1,) + B.shape[2:]))
            ml.append(l1.reshape(-1))
            nl.append(l2.reshape(-1))
        return torch.cat(Bs), torch.cat(ml), torch.cat(nl)

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """qmax and dmax / (M + N) of both channels, one call each on the
        stacked CRPs (the kernels on a CUDA tile; `plain=True` calls their
        plain versions, on the tensors' device)."""
        bi, bj = row["rnn_len"].shape[0], col["rnn_len"].shape[0]
        S, ml, nl = self.tile_crps(row, col)
        if plain:
            q, d = qmax_batch_ref(S, ml, nl), dmax_batch_ref(S, ml, nl)
        else:
            q = alignment.qmax_batch_best(S, ml, nl)
            d = alignment.dmax_batch_best(S, ml, nl)
        denom = torch.clamp_min(ml + nl, 1).to(torch.float32)
        q = (q / denom).reshape(2, bi, bj)
        d = (d / denom).reshape(2, bi, bj)
        return {"tempogram_rnn_qmax": q[0], "tempogram_rnn_dmax": d[0],
                "tempogram_sflux_qmax": q[1], "tempogram_sflux_dmax": d[1]}
