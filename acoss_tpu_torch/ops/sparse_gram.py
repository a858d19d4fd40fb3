"""Sparse Gram of the Struc* shingles (port of `acoss_tpu.ops.sparse_gram`).

The reference scores every song pair as exp(-d^2) through one host scipy
SpGEMM over the (n, PAD_LEN^2) shingle CSR (`StrucFTM2D.py:173-189`);
`host_gram_scores` keeps that form. Its cost is the sum of the squared
column counts, which grows quadratically once the shingle supports
concentrate on the same low-frequency bins.

The device path uses the flip side of that concentration: the column
union across the corpus is small (tens of thousands of the 4M dims), so
the Gram is a dense fp32 matmul over union-remapped coordinates:

1. host: U = the union of all shingle columns; each row's indices become
   positions in U (`compact_shingles`, a numpy copy of the JAX package's);
2. device: the compact (pos int32, val fp32) rows are uploaded once; row
   blocks are densified by a scatter into (R, |U|), and each pair of
   blocks is one fp32 matmul with TF32 off;
3. exp(-max(sq_a + sq_b - 2 G, 0)) on the device; only the (R, R) score
   blocks come back.

`sparse_gram_scores` keeps the JAX package's dispatch: corpora of at most
`host_max_n` songs, or whose union exceeds `union_max`, take the host
path unless `force_device` is set.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.ops.crp import cuda_tf32

__all__ = ["compact_shingles", "sparse_gram_scores", "host_gram_scores"]


def host_gram_scores(idx_list, val_list, dim: int) -> np.ndarray:
    """The reference-shaped host path (`StrucFTM2D.py:173-189`): one scipy
    SpGEMM, then exp(-d^2). The fallback and the test oracle."""
    from scipy import sparse

    n = len(idx_list)
    indptr = np.cumsum([0] + [len(ix) for ix in idx_list])
    X = sparse.csr_matrix(
        (np.concatenate(val_list), np.concatenate(idx_list), indptr),
        shape=(n, dim))
    sq = np.asarray(X.power(2).sum(axis=1)).ravel()
    G = np.asarray((X @ X.T).todense())
    d2 = sq[:, None] + sq[None, :] - 2.0 * G
    return np.exp(-np.maximum(d2, 0.0)).astype(np.float32)


def compact_shingles(idx_list, val_list):
    """Union-remap ragged (idx, val) shingles to fixed-width compact form.

    Returns (union_size, pos [n, K] int32, val [n, K] float32, sq [n]
    float32). Padding entries carry pos == union_size, which the device
    scatter drops."""
    n = len(idx_list)
    U = np.unique(np.concatenate(idx_list)) if n else np.empty(0, np.int64)
    K = max((len(ix) for ix in idx_list), default=1) or 1
    pos = np.full((n, K), U.size, np.int32)
    val = np.zeros((n, K), np.float32)
    sq = np.zeros(n, np.float32)
    for i, (ix, v) in enumerate(zip(idx_list, val_list)):
        k = len(ix)
        pos[i, :k] = np.searchsorted(U, ix)
        val[i, :k] = v
        sq[i] = np.dot(np.asarray(v, np.float64),
                       np.asarray(v, np.float64))
    return int(U.size), pos, val, sq


def _densify(pos: torch.Tensor, val: torch.Tensor, upad: int) -> torch.Tensor:
    """(R, K) compact rows -> dense (R, upad) fp32; entries with pos >=
    upad (the padding) land in a dropped extra column."""
    X = torch.zeros((pos.shape[0], upad + 1), dtype=torch.float32,
                    device=pos.device)
    X.scatter_(1, torch.clamp_max(pos.to(torch.int64), upad), val)
    return X[:, :upad]


def _score_tile(Xa: torch.Tensor, Xb: torch.Tensor, sqa: torch.Tensor,
                sqb: torch.Tensor) -> torch.Tensor:
    """exp(-max(|a|^2 + |b|^2 - 2 a.b, 0)) of every (row of Xa, row of Xb)
    pair, the product in full fp32."""
    with cuda_tf32(False):
        G = torch.matmul(Xa, Xb.T)
    d2 = sqa[:, None] + sqb[None, :] - 2.0 * G
    return torch.exp(-torch.clamp_min(d2, 0.0))


def sparse_gram_scores(idx_list, val_list, dim: int,
                       union_max: int = 1 << 21,
                       hbm_budget_bytes: int = 6 << 30,
                       max_row_block: int = 2048,
                       host_max_n: int = 512,
                       force_device: bool = False,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """exp(-d^2) over all row pairs of the sparse shingle matrix, (n, n)
    float32 on the host.

    Equal to `host_gram_scores` within fp32 rounding (an fp32 matmul
    against scipy's fp32 accumulation; tested to 1e-5). The device path
    runs on `device` when the column union is concentrated and the corpus
    has more than `host_max_n` songs, or with `force_device`; scipy
    otherwise."""
    n = len(idx_list)
    if n == 0:
        return np.zeros((0, 0), np.float32)
    if n <= host_max_n and not force_device:
        return host_gram_scores(idx_list, val_list, dim)
    usize, pos, val, sq = compact_shingles(idx_list, val_list)
    if usize > union_max and not force_device:
        return host_gram_scores(idx_list, val_list, dim)

    # the JAX package's shape buckets, kept so both packages tile alike:
    # the union to a power of two while it is small, 128-aligned past it
    if usize <= 1 << 17:
        upad = 1 << max(10, int(np.ceil(np.log2(max(usize, 1)))))
    else:
        upad = -(-usize // 128) * 128
    # two dense row blocks must fit the budget next to the compact form
    R = int(min(max_row_block,
                max(8, hbm_budget_bytes // (2 * upad * 4))))
    R = -(-R // 8) * 8
    nb = -(-n // R)
    pad = nb * R - n
    if pad:
        pos = np.pad(pos, ((0, pad), (0, 0)), constant_values=usize)
        val = np.pad(val, ((0, pad), (0, 0)))
        sq = np.pad(sq, (0, pad))
    pos_d, val_d, sq_d = (torch.from_numpy(a).to(device)
                          for a in (pos, val, sq))

    out = np.empty((n, n), np.float32)
    for a in range(nb):
        a0, a1 = a * R, (a + 1) * R
        Xa = _densify(pos_d[a0:a1], val_d[a0:a1], upad)
        for b in range(a + 1):
            b0, b1 = b * R, (b + 1) * R
            Xb = Xa if b == a else _densify(pos_d[b0:b1], val_d[b0:b1],
                                            upad)
            S = _score_tile(Xa, Xb, sq_d[a0:a1], sq_d[b0:b1]).cpu().numpy()
            ah, bh = min(a1, n) - a0, min(b1, n) - b0
            out[a0:a0 + ah, b0:b0 + bh] = S[:ah, :bh]
            if b != a:
                out[b0:b0 + bh, a0:a0 + ah] = S[:ah, :bh].T
    return out
