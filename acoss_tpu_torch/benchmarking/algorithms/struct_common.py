"""The pipeline shared by the structural families (port of
`acoss_tpu.benchmarking.algorithms.struct_common`, after the reference's
`load_features` preamble of `StrucFTM2D.py:70-120`, `StrucShingles.py`,
`StrucLaplacian.py:60-120` and `StrucScattering.py`): beat-synchronous
(or uniformly downsampled) HPCP / MFCC / tempogram features, their
wins_per_block delay embeddings, SSM / cosine-CSM distance matrices, and
SNF fusion into one W per song.

`structural_fused_w_all` is the corpus path: songs are bucketed by padded
length (multiples of 128) and fused 16 at a time on the device
(`ops.structure.fused_w_batch`, one kNN-mask launch a chunk).
`structural_fused_w` is the per-song path, the oracle it is tested
against.

NOTE (a reference quirk, not kept): the reference zero-pads the matrices
in its `Ds` list when they are smaller than 2K (`StrucFTM2D.py:107-112`)
but fuses the original unpadded ones (`StrucFTM2D.py:119`), so the pad is
dead code. The JAX package and this port pad the matrices they fuse.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.features.rhythm import (tempogram_aggregated,
                                             tempogram_aggregated_batch)
from acoss_tpu_torch.ops import crp, fusion
from acoss_tpu_torch.ops.segment import stack_memory, sync_agg
from acoss_tpu_torch.ops.structure import fused_w_batch
from acoss_tpu_torch.utils.profiling import stages

#: padded-length bucket and songs per fused-W call of the corpus path
BUCKET = 128
BATCH_SIZE = 16


def autotune_k(K: int, n: int) -> int:
    """K = -1 -> 2 * log2(n) (`StrucFTM2D.py:114-117`)."""
    if K == -1:
        return int(np.round(2 * np.log(n) / np.log(2)))
    return K


def structural_fused_w(
    fs: FeatureSet,
    i: int,
    chroma_type: str = "hpcp",
    wins_per_block: int = 20,
    K: int = 10,
    niters: int = 10,
    do_sync: bool = True,
    downsample_fac: int = 40,
    fuse_features: tuple = ("mfcc", "hpcp", "tempogram"),
    tempogram_win: int = 384,
    sequential: bool = True,
    device: str | torch.device = "cuda",
):
    """Fused structural affinity matrix of song `i`, from the materialized
    delay embeddings: returns (W (n, n) np.float32, onsets (n,) int64)."""
    base, onsets, n = _prep_base_features(
        fs, i, chroma_type, do_sync, downsample_fac, fuse_features,
        tempogram_win, device=device)
    pK = autotune_k(K, n)
    # the bucket padding of the corpus path; padding is masked exactly
    npad = max(-(-n // BUCKET) * BUCKET, 2 * pK, BUCKET)
    padded = torch.zeros((len(fuse_features), npad, npad),
                         dtype=torch.float32, device=device)
    with crp.cuda_tf32(False):
        for f, name in enumerate(fuse_features):
            st = torch.from_numpy(stack_memory(base[name], wins_per_block, 1)
                                  .astype(np.float32)).to(device)
            padded[f, :n, :n] = crp.get_csm_cosine(st, st) \
                if name == "hpcp" else crp.get_ssm(st)
    W = fusion.snf_padded(padded, pK, niters=niters, length=n,
                          sequential=sequential)
    return W[:n, :n].cpu().numpy().astype(np.float32), onsets[:n]


def _song_onsets(fs: FeatureSet, i: int, do_sync: bool,
                 downsample_fac: int) -> np.ndarray:
    if do_sync:
        return fs.feature("onsets")[i, :fs.length("onsets")[i], 0] \
            .astype(np.int64)
    return np.arange(0, fs.length("mfcc_htk")[i], downsample_fac)


def _prep_base_features(
    fs: FeatureSet,
    i: int,
    chroma_type: str,
    do_sync: bool,
    downsample_fac: int,
    fuse_features: tuple,
    tempogram_win: int,
    tempogram_precomputed: np.ndarray | None = None,
    device: str | torch.device = "cuda",
):
    """Host prep of song i's synced (UNstacked) base features.

    Returns ({name: (n, d_name) float32}, onsets (n,) int64, n), every
    feature cut to the shortest one's segment count (the stacked distance
    matrices of the cut equal the [:n, :n] crop of the full ones: the
    delay embedding only looks backward). A tempogram not given in
    `tempogram_precomputed` is computed on `device`."""
    clen = fs.length(chroma_type)[i]
    mlen = fs.length("mfcc_htk")[i]
    hpcp = fs.feature(chroma_type)[i, :clen]
    mfcc = np.nan_to_num(fs.feature("mfcc_htk")[i, :mlen],
                         nan=0.0, posinf=0.0, neginf=0.0)
    onsets = _song_onsets(fs, i, do_sync, downsample_fac)

    base = {}
    for name in fuse_features:
        if name == "mfcc":
            y = sync_agg(mfcc, onsets, "mean")
        elif name == "hpcp":
            y = sync_agg(hpcp, onsets, "median")
        elif name == "tempogram":
            if tempogram_precomputed is not None:
                y = tempogram_precomputed
            else:
                snovfn = fs.feature("snovfn")[i, :fs.length("snovfn")[i], 0]
                y = tempogram_aggregated(snovfn, onsets, tempogram_win,
                                         device=device)
        else:
            raise ValueError(name)
        base[name] = np.nan_to_num(
            np.asarray(y, np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    n = min(b.shape[0] for b in base.values())
    base = {k: v[:n] for k, v in base.items()}
    return base, onsets[:n], n


def structural_fused_w_all(
    fs: FeatureSet,
    chroma_type: str = "hpcp",
    wins_per_block: int = 20,
    K: int = 10,
    niters: int = 10,
    do_sync: bool = True,
    downsample_fac: int = 40,
    fuse_features: tuple = ("mfcc", "hpcp", "tempogram"),
    tempogram_win: int = 384,
    sequential: bool = True,
    bucket: int = BUCKET,
    batch_size: int = BATCH_SIZE,
    consume=None,
    device: str | torch.device = "cuda",
):
    """Fused structural W of EVERY song, in chunks on `device`.

    Songs are bucketed by padded segment count (multiples of `bucket`) and
    fused `batch_size` at a time: each chunk is ONE `fused_w_batch` call
    (stacked distances + SNF). A chunk always has `batch_size` songs, or
    the bucket's size if smaller: a short last chunk repeats its first
    song (its outputs are dropped). The numbers match the per-song
    `structural_fused_w` to fp32 tolerance.

    Returns [(W (n, n) np.float32, onsets, n), ...] in song order; or,
    with `consume(W (B, npad, npad) tensor on the device, lengths (B,)
    int32, onsets list, songs list)`, hands each chunk's W to `consume`
    without a host round trip and returns the per-song results `consume`
    gives for the chunk's real songs, in song order.
    """
    kinds = tuple("cosine" if f == "hpcp" else "euclidean"
                  for f in fuse_features)
    with stages.stage("struct:host_prep"):
        tgs = [None] * fs.n_songs
        if "tempogram" in fuse_features:
            # every song's synced tempogram in a few batched device calls
            envs = [fs.feature("snovfn")[i, :fs.length("snovfn")[i], 0]
                    for i in range(fs.n_songs)]
            bnds = [_song_onsets(fs, i, do_sync, downsample_fac)
                    for i in range(fs.n_songs)]
            tgs = tempogram_aggregated_batch(envs, bnds, tempogram_win,
                                             device=device)
        preps = [_prep_base_features(
            fs, i, chroma_type, do_sync, downsample_fac, fuse_features,
            tempogram_win, tempogram_precomputed=tgs[i], device=device)
            for i in range(fs.n_songs)]
    results = [None] * fs.n_songs
    by_npad: dict = {}
    for i, (_, _, n) in enumerate(preps):
        npad = max(-(-n // bucket) * bucket, 2 * autotune_k(K, max(n, 2)),
                   bucket)
        by_npad.setdefault(npad, []).append(i)

    for npad, idxs in sorted(by_npad.items()):
        B = min(batch_size, len(idxs))
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo:lo + batch_size]
            songs = chunk + [chunk[0]] * (B - len(chunk))
            P = npad + wins_per_block - 1
            feats = []
            for name in fuse_features:
                d = preps[chunk[0]][0][name].shape[1]
                arr = np.zeros((B, P, d), np.float32)
                for b, si in enumerate(songs):
                    x = preps[si][0][name]
                    arr[b, wins_per_block - 1:
                        wins_per_block - 1 + x.shape[0]] = x
                feats.append(torch.from_numpy(arr).to(device))
            lengths = np.array([preps[si][2] for si in songs], np.int32)
            Ks = np.array([autotune_k(K, max(int(n), 2)) for n in lengths],
                          np.int32)
            # K is monotone in n, so the bucket's bound holds every song
            with stages.stage("struct:fused_w"):
                W = stages.block(fused_w_batch(
                    feats, lengths, Ks, kinds, wins_per_block,
                    niters=niters, sequential=sequential,
                    k_static_max=autotune_k(K, npad)))
            if consume is not None:
                with stages.stage("struct:consume"):
                    outs = consume(W, lengths,
                                   [preps[si][1] for si in songs], songs)
                for b, si in enumerate(chunk):
                    results[si] = outs[b]
            else:
                Wh = W.cpu().numpy()
                for b, si in enumerate(chunk):
                    n = int(lengths[b])
                    results[si] = (Wh[b, :n, :n], preps[si][1], n)
    return results


def sparse_top_shingle(flat: np.ndarray, n_keep: int):
    """log(flat / ||flat|| + 1), keeping only the values >= the n_keep-th
    largest (`StrucFTM2D.py:133-143`; ties AT the cutoff are all kept, so
    nnz can slightly exceed n_keep). Returns (indices int64, values
    float32) sorted by index.

    The cutoff is the EXACT n_keep-th largest (as the JAX package, which
    implements the reference's stated intent, 'the 5*PAD_LEN largest
    elements', `StrucFTM2D.py:139`, rather than its `np.partition` idiom
    that reads an unordered slot), so this host path agrees with the
    device path (`ops.structure.shingle_topk_batch`)."""
    n = np.sqrt(np.sum(flat.astype(np.float64) ** 2))
    s = np.log(flat / (n if n > 0 else 1.0) + 1)
    if n_keep >= s.size:
        idx = np.arange(s.size)
    else:
        cutoff = -np.partition(-s, n_keep - 1)[n_keep - 1]
        idx = np.flatnonzero(s >= cutoff)
    return idx.astype(np.int64), s[idx].astype(np.float32)
