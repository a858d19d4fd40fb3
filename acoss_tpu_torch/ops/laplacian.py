"""Graph-Laplacian eigenvectors and sequential spectral clustering (port of
`acoss_tpu.ops.laplacian`, after the reference's `Laplacian.py:11-127`).

The eigendecompositions are `torch.linalg.eigh` on the tensor's device and
take leading batch dimensions. The random-walk variant solves the
generalized problem L u = lambda D u through the symmetric normalization
D^{-1/2} L D^{-1/2} w = lambda w, u = D^{-1/2} w, which gives
scipy.linalg.eigh(L, D)'s u^T D u = 1 normalization (up to each vector's
sign, which nothing downstream reads).

`spectral_cluster_sequential` and `meet_matrix` are host numpy, copies of
the JAX package's functions: the per-song StrucLaplacian path runs them.
The clustering imports sklearn when it is called, never at import, so the
package imports where sklearn is absent; the batched path
(`ops.structure.laplacian_profile_batch`) needs no sklearn.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch

EVEC_SMOOTH = 9


def _inv_sqrt_degree(d: torch.Tensor) -> torch.Tensor:
    sq = torch.sqrt(torch.clamp_min(d, 0.0))
    return torch.where(sq == 0, 1.0, 1.0 / sq)


def unweighted_laplacian_eigs(W: torch.Tensor) -> torch.Tensor:
    """Eigenvectors of L = D - W (`Laplacian.py:11-30`), W (..., n, n)."""
    L = torch.diag_embed(torch.sum(W, dim=-1)) - W
    return torch.linalg.eigh(L).eigenvectors


def symmetric_laplacian_eigs(W: torch.Tensor) -> torch.Tensor:
    """Eigenvectors of D^{-1/2} (D - W) D^{-1/2} (`Laplacian.py:32-55`)."""
    d = torch.sum(W, dim=-1)
    L = torch.diag_embed(d) - W
    inv = _inv_sqrt_degree(d)
    return torch.linalg.eigh(
        inv[..., :, None] * L * inv[..., None, :]).eigenvectors


def random_walk_laplacian_eigs(W: torch.Tensor) -> torch.Tensor:
    """Generalized eigenvectors of L u = lambda D u (`Laplacian.py:57-77`),
    with u^T D u = 1 like scipy.linalg.eigh(L, D)."""
    d = torch.sum(W, dim=-1)
    L = torch.diag_embed(d) - W
    inv = _inv_sqrt_degree(d)
    w = torch.linalg.eigh(inv[..., :, None] * L * inv[..., None, :]) \
        .eigenvectors
    return inv[..., :, None] * w


def spectral_cluster_sequential(v: np.ndarray, dim: int, times: np.ndarray,
                                rownorm: bool = False) -> dict:
    """Spectral clustering of Laplacian eigenvectors + merge of adjacent
    same-label points into segment intervals (`Laplacian.py:80-127`)."""
    from sklearn.cluster import KMeans

    v = np.asarray(v)
    x = np.array(v[:, :dim])
    if EVEC_SMOOTH > 0:
        x = scipy.ndimage.median_filter(x, size=(EVEC_SMOOTH, 1))
    if rownorm:
        norms = np.sqrt(np.sum(x ** 2, 1))
        norms[norms == 0] = 1
        x /= norms[:, None]
    labels = KMeans(n_clusters=dim, n_init=50, max_iter=500,
                    random_state=0).fit(x).labels_
    splits = np.where(np.abs(labels[1:] - labels[:-1]) > 0)[0] + 1
    splits = np.concatenate(([0], splits, [labels.size]))
    splits[splits >= times.size] = times.size
    if np.sum(splits == times.size) > 1:
        splits = np.unique(splits)
    groups = np.split(labels, splits)[1:-1]
    intervals_hier = np.zeros((len(groups), 2))
    timesext = np.array(times.tolist() + [times[-1]])
    intervals_hier[:, 0] = timesext[splits[:-1]]
    intervals_hier[:, 1] = timesext[splits[1:]]
    labels_hier = ["%i" % g[0] for g in groups]
    return {"labels": labels, "intervals_hier": intervals_hier,
            "labels_hier": labels_hier}


def meet_matrix(intervals_hier: list, labels_hier: list,
                frame_size: float) -> np.ndarray:
    """Hierarchy meet matrix (the reference's `mir_eval.hierarchy._meet`,
    `StrucLaplacian.py:133`): meet[i, j] = deepest level (1-based) at
    which sampled frames i and j carry the same segment label; 0 if none.
    """
    end = max(float(iv[-1, 1]) for iv in intervals_hier)
    n = int(round(end / frame_size))
    n = max(n, 1)
    t = (np.arange(n) + 0.5) * frame_size
    meet = np.zeros((n, n), dtype=np.float64)
    for level, (ivs, labs) in enumerate(zip(intervals_hier, labels_hier), 1):
        frame_labels = np.full(n, -1, dtype=np.int64)
        uniq = {lab: k for k, lab in enumerate(dict.fromkeys(labs))}
        for (a, b), lab in zip(ivs, labs):
            sel = (t >= a) & (t < b)
            frame_labels[sel] = uniq[lab]
        same = (frame_labels[:, None] == frame_labels[None, :]) & \
            (frame_labels[:, None] >= 0)
        meet[same] = level
    return meet
