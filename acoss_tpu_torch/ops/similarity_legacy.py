"""The reference's OLDER similarity API (percentile-based CRPs): the
port's copy of `acoss_tpu.ops.similarity_legacy`, after ctralie/acoss
`preprocess/similarity.py:13-137`.

A second, independent CRP implementation in the reference whose
binarization uses per-row PERCENTILE thresholds instead of CRPUtils'
argpartition-count kNN. The CRP math is host numpy, as in the JAX
package; `serra_cover_similarity_measures` wraps the port's single-pair
qmax/dmax (`ops.alignment`) instead of essentia's CoverSongSimilarity
and returns the same sqrt(N) / max_score distance. On a CUDA device,
qmax launches a qmax kernel (the unequal-gap one for unequal gaps) and
dmax with equal gaps the dmax kernel; dmax with unequal gaps is the plain
scan, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.ops import alignment


def global_hpcp(chroma: np.ndarray) -> np.ndarray:
    """Global averaged chroma, max-normalized (`similarity.py:13-18`)."""
    s = np.asarray(chroma).sum(axis=0)
    return s / max(s.max(), 1e-12)


def optimal_transposition_index(chroma_a: np.ndarray,
                                chroma_b: np.ndarray,
                                n_shifts: int = 12) -> int:
    """OTI of B w.r.t. A via global-chroma dot products
    (`similarity.py:20-36`)."""
    ga, gb = global_hpcp(chroma_a), global_hpcp(chroma_b)
    scores = [np.dot(ga, np.roll(gb, s)) for s in range(n_shifts)]
    return int(np.argmax(scores))


def transpose_by_oti(chroma_b: np.ndarray, oti: int = 0,
                     flat_roll: bool = False) -> np.ndarray:
    """Circularly shift the chroma axis (`similarity.py:38-46`).

    The reference calls `np.roll(chromaB, oti)` with NO axis, which rolls
    the FLATTENED buffer: each row's last `oti` bins spill into the next
    row. The default here rolls the chroma axis (the evident intent);
    `flat_roll=True` replicates the reference's literal behaviour.
    """
    if flat_roll:
        return np.roll(chroma_b, oti)
    return np.roll(chroma_b, oti, axis=1)


def to_embedding(x: np.ndarray, tau: int = 1, m: int = 9) -> np.ndarray:
    """Delay embedding with stride tau (`similarity.py:48-67`): rows are
    flattened stacks of m samples spaced tau apart."""
    x = np.asarray(x)
    rows = []
    for start in range(0, x.shape[0] - m * tau, tau):
        rows.append(x[start:start + m * tau:tau].ravel())
    return np.array(rows)


def cross_recurrent_plot(input_x: np.ndarray, input_y: np.ndarray,
                         tau: int = 1, m: int = 9, kappa: float = 0.095,
                         transpose: bool = True) -> np.ndarray:
    """Percentile-based mutual-neighbor binary CRP
    (`similarity.py:69-108`)."""
    if transpose:
        oti = optimal_transposition_index(input_x, input_y)
        input_y = transpose_by_oti(input_y, oti)
    A = to_embedding(input_x, tau, m)
    B = to_embedding(input_y, tau, m)
    D = np.sqrt(np.maximum(
        np.sum(A ** 2, 1)[:, None] + np.sum(B ** 2, 1)[None, :]
        - 2 * A @ B.T, 0))
    eph_x = np.percentile(D, kappa * 100, axis=1)
    eph_y = np.percentile(D.T, kappa * 100, axis=1)
    x = (eph_x[:, None] - D >= 0).astype(np.float64)
    y = (eph_y[:, None] - D.T >= 0).astype(np.float64)
    return x * y.T


def serra_cover_similarity_measures(input_crp: np.ndarray,
                                    dis_onset: float = 0.5,
                                    dis_extension: float = 0.5,
                                    sim_type: str = "qmax",
                                    device: str | torch.device = "cuda"
                                    ) -> float:
    """Cover DISTANCE from a binary CRP: sqrt(N) / max alignment score
    (`similarity.py:111-137`), the alignment on `device` (CUDA by default;
    "cpu" runs the plain scans)."""
    S = torch.from_numpy(np.ascontiguousarray(input_crp, dtype=np.uint8)) \
        .to(device)
    if sim_type == "qmax":
        score = float(alignment.qmax(S, gap_onset=dis_onset,
                                     gap_extension=dis_extension))
    elif sim_type == "dmax":
        score = float(alignment.dmax(S, gap_onset=dis_onset,
                                     gap_extension=dis_extension))
    else:
        raise ValueError(sim_type)
    return float(np.sqrt(S.shape[1]) / max(score, 1e-12))
