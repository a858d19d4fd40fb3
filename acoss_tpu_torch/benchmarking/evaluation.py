"""Retrieval evaluation: MR / MRR / MDR / MAP / Top-K (numpy copy of
`acoss_tpu.benchmarking.evaluation`, which cannot be imported where JAX is
absent).

Follows the reference's ranking-metric conventions exactly
(`CoverAlgorithm.py:330-418` of acoss), vectorized:

- rows/cols are reordered so cover cliques are contiguous, cliques sorted by
  descending size (stable, like `np.argsort(-Ks)`);
- the diagonal is filled with -inf so a song never retrieves itself; the self
  hit therefore sorts *last* among its clique and is dropped;
- only songs in cliques of size >= 2 are scored; MRR still divides by the
  FULL dataset size N (including excluded songs);
- per-song AP = mean over j of j / rank_of_jth_correct (1-based ranks).

Runs in numpy on the host: evaluation is O(N^2 log N) once per sweep, not a
hot path, and exactness (stable sorts, nan conventions) matters more than
device placement here.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class EvalStats:
    mr: float          # mean rank of first correct result
    mrr: float         # mean reciprocal rank (divided by full N)
    mdr: float         # median rank
    map: float         # mean average precision
    tops: dict[int, int]   # Top-K counts
    n_scored: int      # songs actually scored (cliques of size >= 2)

    def row(self) -> list:
        return [self.mr, self.mrr, self.mdr, self.map] + [
            self.tops[k] for k in sorted(self.tops)
        ]


def eval_statistics(
    D: np.ndarray,
    labels: np.ndarray | list,
    topsidx: tuple[int, ...] = (1, 10, 100, 1000),
) -> EvalStats:
    """Compute retrieval statistics from a similarity matrix.

    Args:
      D: (N, N) similarity matrix (HIGHER = more similar, like the
         reference; distance-valued algorithms negate before calling).
      labels: length-N clique label per song (any hashable).
      topsidx: Top-K cutoffs.
    """
    D = np.array(D, dtype=np.float32)
    N = D.shape[0]
    labels = np.asarray(labels)

    # --- Step 1: group songs into cliques, sorted by descending size, in
    # first-seen label order within equal sizes (stable argsort like the
    # reference's np.argsort(-Ks) over insertion-ordered dict cliques).
    uniq, first_pos, inv = np.unique(labels, return_index=True,
                                     return_inverse=True)
    order_by_first = np.argsort(first_pos, kind="stable")
    # clique id in first-seen order
    rank_of_uniq = np.empty(len(uniq), dtype=np.int64)
    rank_of_uniq[order_by_first] = np.arange(len(uniq))
    clique_first_seen = rank_of_uniq[inv]  # per-song clique id (first-seen)
    sizes = np.bincount(clique_first_seen, minlength=len(uniq))
    csort = np.argsort(-sizes, kind="stable")
    new_clique_id = np.empty(len(uniq), dtype=np.int64)
    new_clique_id[csort] = np.arange(len(uniq))
    song_clique = new_clique_id[clique_first_seen]
    # contiguous reorder: songs sorted by (clique id, original index)
    perm = np.lexsort((np.arange(N), song_clique))
    D = D[np.ix_(perm, perm)]
    c = song_clique[perm]               # nondecreasing clique ids
    Ks = np.bincount(c)                 # clique sizes in new order

    # --- Step 2: ranking
    np.fill_diagonal(D, -np.inf)
    idx = np.argsort(-D, axis=1, kind="stable")
    member = c[idx] == c[:, None]       # (N, N) membership in sorted order
    scored = Ks[c] >= 2                 # only cliques with >= 2 members

    # The self-hit has score -inf so it sorts last among row i's matches;
    # the correct hits for row i are the first (K_i - 1) members.
    cum = np.cumsum(member, axis=1)                    # j-th correct so far
    kmax = (Ks[c] - 1)[:, None]                        # correct hits to keep
    take = member & (cum <= kmax)
    pos = np.broadcast_to(np.arange(1, N + 1), (N, N))  # 1-based ranks

    with np.errstate(invalid="ignore", divide="ignore"):
        ap_terms = np.where(take, cum / pos, 0.0)
        ap = ap_terms.sum(axis=1) / np.maximum(kmax[:, 0], 1)
    # rank of FIRST correct hit
    first_rank = np.where(take, pos, N + 1).min(axis=1).astype(np.float64)

    ranks = first_rank[scored]
    ap = ap[scored]
    MAP = float(np.mean(ap)) if ap.size else float("nan")
    MR = float(np.mean(ranks)) if ranks.size else float("nan")
    # Reference convention: MRR divides by the FULL dataset size N.
    MRR = float(np.sum(1.0 / ranks) / N) if ranks.size else float("nan")
    MDR = float(np.median(ranks)) if ranks.size else float("nan")
    tops = {k: int(np.sum(ranks <= k)) for k in topsidx}
    return EvalStats(mr=MR, mrr=MRR, mdr=MDR, map=MAP, tops=tops,
                     n_scored=int(scored.sum()))


def write_results_csv(
    path: str,
    name: str,
    similarity_type: str,
    stats: EvalStats,
) -> None:
    """Append a row with the reference's CSV schema
    (`CoverAlgorithm.py:404-417`): header
    `name, MR, MRR, MDR, MAP, Top-1, ...`."""
    topsidx = sorted(stats.tops)
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write("name, MR, MRR, MDR, MAP")
            for t in topsidx:
                f.write(",Top-%i" % t)
            f.write("\n")
    with open(path, "a") as f:
        f.write("%s_%s," % (name, similarity_type))
        f.write("%.3g, %.3g, %.3g, %.3g" % (stats.mr, stats.mrr,
                                            stats.mdr, stats.map))
        for t in topsidx:
            f.write(", %.3g" % stats.tops[t])
        f.write("\n")
