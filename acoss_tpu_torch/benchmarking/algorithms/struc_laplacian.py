"""StrucLaplacian: structural-novelty curves from spectral clustering (port
of `acoss_tpu.benchmarking.algorithms.struc_laplacian`, after the
reference's `StrucLaplacian.py:25-181`).

- descriptors, per chunk of songs on the device
  (`ops.structure.laplacian_profile_batch`): the fused W of all three
  features -> random-walk Laplacian eigenvectors -> spectral k-means at
  k = 2..neigs -> hierarchy meet matrix -> SVD; then on the host the
  curvature (velocity-magnitude) profile and its m-wide sliding window;
- pair score: Euclidean CSM -> `csm_to_binary` (NON-mutual row kNN) ->
  qmax and dmax, each divided by M + N (`StrucLaplacian.py:166-181`). A
  (bi x bj) tile builds every pair's CRP in batched calls and makes ONE
  qmax and ONE dmax call on the (bi bj, L, L) stack, which on the card
  launch the qmax and dmax kernels.

The k-means draws come from `torch.Generator`s seeded per (KMEANS_SEED,
song, k) (`ops.structure.kmeans_uniforms`); the JAX package draws with
`jax.random`, so the two packages' clusterings may differ where a restart
finds another optimum.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.algorithms.struct_common import (
    structural_fused_w, structural_fused_w_all)
from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data.store import FeatureSet, pad_stack
from acoss_tpu_torch.ops import alignment, crp
from acoss_tpu_torch.ops.alignment_cuda import dmax_batch_ref, qmax_batch_ref
from acoss_tpu_torch.ops.curvature import get_curv_vectors
from acoss_tpu_torch.ops.laplacian import (meet_matrix,
                                           random_walk_laplacian_eigs,
                                           spectral_cluster_sequential)
from acoss_tpu_torch.ops.structure import laplacian_profile_batch

HOP_LENGTH = 512
SR = 44100
FUSE_FEATURES = ("mfcc", "hpcp", "tempogram")
#: the seed of every song's k-means draws (the JAX package's PRNGKey(0))
KMEANS_SEED = 0


def meet_pad_for(npad: int, onsets_list) -> int:
    """The meet grid's capacity for a chunk: every song's
    nmeet = round(tend / frame_size), frame_size = (tend - t0) / (n - 1),
    plus 8, at least npad + 128, rounded up to a multiple of 64. A song
    whose first beat sits late needs nmeet well above n; capping it would
    cut its SVD curve short against the per-song path."""
    need = npad + 128
    for o in onsets_list:
        if len(o) >= 2:
            t = o.astype(np.float64) * HOP_LENGTH / SR
            fs_ = max((t[-1] - t[0]) / (len(o) - 1), 1e-4)
            need = max(need, int(round(t[-1] / fs_)) + 8)
    return -(-need // 64) * 64


class StrucLaplacian(CoverAlgorithm):
    NAME = "StructureLaplacian"
    SIMILARITY_TYPES = ("snovfn_qmax", "snovfn_dmax")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", kappa: float = 0.095,
                 m: int = 10, wins_per_block: int = 20, K: int = 10,
                 niters: int = 10, neigs: int = 10, do_sync: bool = True,
                 downsample_fac: int = 40, tempogram_win: int = 384,
                 pad_to_multiple: int = 64):
        self.chroma_type = chroma_type
        self.kappa = kappa
        self.m = m
        self.wins_per_block = wins_per_block
        self.K = K
        self.niters = niters
        self.neigs = neigs
        self.do_sync = do_sync
        self.downsample_fac = downsample_fac
        self.tempogram_win = tempogram_win
        self.pad_to_multiple = pad_to_multiple

    def _fuse_kw(self) -> dict:
        return dict(chroma_type=self.chroma_type,
                    wins_per_block=self.wins_per_block, K=self.K,
                    niters=self.niters, do_sync=self.do_sync,
                    downsample_fac=self.downsample_fac,
                    fuse_features=FUSE_FEATURES,
                    tempogram_win=self.tempogram_win)

    def _profile_from_curve(self, X: np.ndarray) -> np.ndarray:
        """SVD curve (nmeet, neigs) -> sliding-window velocity-magnitude
        profile (`StrucLaplacian.py:138-152`), (nmeet - m + 1, m)."""
        curvs = np.array(get_curv_vectors(X, 3, 2))    # (4, n, d)
        prof = np.sqrt(np.sum(curvs ** 2, axis=2)).T[:, 1]
        if prof.size < self.m:
            return np.zeros((1, self.m), dtype=np.float32)
        n_out = prof.size - self.m + 1
        return np.stack([prof[k:k + n_out] for k in range(self.m)],
                        axis=1).astype(np.float32)

    def _song_profile(self, fs: FeatureSet, i: int,
                      device: str | torch.device = "cuda") -> np.ndarray:
        """Song i's profile by the per-song path: the fused W of
        `structural_fused_w`, sklearn's KMeans per level
        (`laplacian.spectral_cluster_sequential`), the host meet matrix
        and SVD."""
        W, onsets = structural_fused_w(fs, i, device=device,
                                       **self._fuse_kw())
        times = onsets * HOP_LENGTH / SR
        if len(times) < max(self.neigs + 1, self.m + 2):
            return np.zeros((1, self.m), dtype=np.float32)
        vs = random_walk_laplacian_eigs(
            torch.from_numpy(W).to(device)).cpu().numpy()[:len(times)]
        labels = [spectral_cluster_sequential(vs, k, times)
                  for k in range(2, self.neigs + 1)]
        interval = float(np.mean(times[1:] - times[:-1]))
        L = meet_matrix([r["intervals_hier"] for r in labels],
                        [r["labels_hier"] for r in labels],
                        max(interval, 1e-4))
        U, s, _ = np.linalg.svd(L)
        s = s[:self.neigs]
        s = s / max(s[0], 1e-12)
        return self._profile_from_curve(U[:, :self.neigs] * s[None, :])

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        """{"profile": (N, Lpad, m) float32, "length": (N,) int32}; the
        fusion and the eigenvector -> k-means -> meet -> SVD chain run on
        `device`, the curvature and sliding window on the host."""
        min_beats = max(self.neigs + 1, self.m + 2)

        def consume(Wb, lengths, onsets_list, songs):
            npad = Wb.shape[1]
            times = np.full((len(onsets_list), npad), 1e18, np.float32)
            for b, o in enumerate(onsets_list):
                times[b, :len(o)] = o.astype(np.float64) * HOP_LENGTH / SR
            # a song's beats are its onsets; W has one more row (the
            # segment past the last onset), which has no beat time
            beats = np.minimum(lengths, [len(o) for o in onsets_list])
            X, nmeet = laplacian_profile_batch(
                Wb, beats, times, self.neigs,
                meet_pad_for(npad, onsets_list), songs=songs,
                seed=KMEANS_SEED)
            X = X.cpu().numpy().astype(np.float64)
            nmeet = nmeet.cpu().numpy()
            return [np.zeros((1, self.m), dtype=np.float32)
                    if beats[b] < min_beats
                    else self._profile_from_curve(X[b, :nmeet[b]])
                    for b in range(len(onsets_list))]

        profiles = structural_fused_w_all(fs, consume=consume, device=device,
                                          **self._fuse_kw())
        Lmax = max(p.shape[0] for p in profiles)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        arr, lengths = pad_stack(profiles, pad_to)
        return {"profile": arr, "length": lengths.astype(np.int32)}

    def tile_crps(self, row: dict, col: dict):
        """The binary CRPs of every pair of the tile, (bi, bj, L, L) uint8,
        and the lengths l1, l2 (bi, bj)."""
        bi, bj = row["length"].shape[0], col["length"].shape[0]
        with crp.cuda_tf32(False):
            csm = crp.get_csm(row["profile"][:, None], col["profile"][None])
        l1 = row["length"][:, None].expand(bi, bj)
        l2 = col["length"][None, :].expand(bi, bj)
        return crp.csm_to_binary(csm, self.kappa, l1, l2), l1, l2

    def tile_scores(self, row: dict, col: dict, plain: bool = False) -> dict:
        """qmax and dmax of every pair of the tile over M + N, one call
        each on the (bi bj, L, L) CRP stack (the kernels on a CUDA tile;
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
        denom = torch.clamp_min(ml + nl, 1).to(torch.float32)
        return {"snovfn_qmax": (q / denom).reshape(bi, bj),
                "snovfn_dmax": (d / denom).reshape(bi, bj)}
