"""Shape DNA: isospectral structural descriptors of cover songs (port of
`acoss_tpu.analytics.song_structure`).

Parity target: the reference's `coverstats/SongStructure.py:45-148`:
chroma + MFCC stacked SSMs -> SNF (K = 1% of N, 5 iterations) -> resize
256 -> random-walk Laplacian EIGENVALUES as the descriptor; cover vs
non-cover Euclidean distances compared with a KS test.

Per song, the SSMs, SNF and resize run on the device: SNF's kNN
truncation (`fusion._get_S_stack`) is one launch of the kNN row-mask
kernel on the song's (2, npad, npad) stack. The 256 x 256 eigenproblem
stays on the host (`np.linalg.eigvalsh`). The eigenvalues feed a KS
test, so the device path holds no order-free sum (no atomics): the same
song gives the same eigenvalues on every run.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import ks_2samp

from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.ops import crp, fusion
from acoss_tpu_torch.ops.segment import stack_memory, uniform_downsample
from acoss_tpu_torch.ops.structure import resize_dynamic_batch

#: per-song matrix sizes are padded up to a multiple of this (the JAX
#: package's compile bucket): the zero padding is masked by length, and
#: k_static_max is constant per bucket, so the numbers match the JAX
#: package's for every song length
_SHAPE_BUCKET = 64


def _rw_laplacian_eigvals(W: np.ndarray, neigs: int) -> np.ndarray:
    """Lowest `neigs`+1 generalized eigenvalues of L u = lam D u."""
    d = W.sum(axis=1)
    L = np.diag(d) - W
    sq = np.sqrt(np.maximum(d, 0.0))
    inv = np.where(sq == 0, 1.0, 1.0 / sq)
    LSym = inv[:, None] * L * inv[None, :]
    w = np.linalg.eigvalsh(LSym)
    return w[:neigs + 1]


def get_shape_dna(hpcp: np.ndarray, mfcc: np.ndarray,
                  downsample_fac: int = 10, m: int = 20, dim: int = 256,
                  neigs: int = 30,
                  device: str | torch.device = "cuda") -> dict:
    """Shape-DNA descriptor of one song (`SongStructure.py:45-75`).

    Args: hpcp (L, 12) and mfcc (L, 13) frames-first.
    Returns {'w': eigenvalues, 'W': fused+resized affinity}.
    """
    chroma = stack_memory(uniform_downsample(hpcp, downsample_fac,
                                             "median"), m, 1)
    mfcc = np.nan_to_num(mfcc, nan=0.0, posinf=0.0, neginf=0.0)
    mf = stack_memory(uniform_downsample(mfcc, downsample_fac, "median"),
                      m, 1)
    n = min(chroma.shape[0], mf.shape[0])
    npad = -(-max(n, 1) // _SHAPE_BUCKET) * _SHAPE_BUCKET
    cpad = np.zeros((npad, chroma.shape[1]), np.float32)
    cpad[:n] = chroma[:n]
    mpad = np.zeros((npad, mf.shape[1]), np.float32)
    mpad[:n] = mf[:n]
    # zero rows only touch entries outside the valid block, which
    # snf_padded masks by length
    Dstack = torch.stack([crp.get_ssm(torch.from_numpy(cpad).to(device)),
                          crp.get_ssm(torch.from_numpy(mpad).to(device))])
    K = max(int(round(n * 0.01)), 2)
    # bound K by the bucket maximum (n <= npad), constant per bucket
    kmax = max(int(round(npad * 0.01)), 2)
    fused = fusion.snf_padded(Dstack, K, niters=5, length=n,
                              sequential=True, k_static_max=kmax)
    W = resize_dynamic_batch(fused[None], [n], dim)[0].cpu().numpy()
    return {"w": _rw_laplacian_eigvals(W, neigs), "W": W}


def shape_dna_study(fs: FeatureSet, chroma_type: str = "hpcp",
                    device: str | torch.device = "cuda", **kwargs) -> dict:
    """Compute shape DNA for every song and compare cover vs non-cover
    eigenvalue distances (`SongStructure.py:100-148`)."""
    ws, labels = [], []
    for i in range(fs.n_songs):
        h = fs.feature(chroma_type)[i, :fs.length(chroma_type)[i]]
        mf = fs.feature("mfcc_htk")[i, :fs.length("mfcc_htk")[i]]
        ws.append(get_shape_dna(h, mf, device=device, **kwargs)["w"])
        labels.append(fs.labels[i])
    ws = np.stack(ws)
    labels = np.asarray(labels)
    w32 = torch.from_numpy(ws.astype(np.float32)).to(device)
    D = crp.get_csm(w32, w32).cpu().numpy()
    same = labels[:, None] == labels[None, :]
    off = ~np.eye(len(labels), dtype=bool)
    dcover = D[same & off]
    dfalse = D[~same]
    ks = ks_2samp(dcover, dfalse) if len(dcover) and len(dfalse) else None
    return {"ws": ws, "dcover": dcover, "dfalse": dfalse, "ks": ks}
