"""Which order-free sum made StrucLaplacian's result move between runs on
the card: restore one of the four sums the port now takes in a fixed order
(the tempogram segment sum by `index_add_`, and `torch.cumsum` of floats in
the stacked cosine norms, the SNF radii and the k-means draws' CDF), run
the extraction twice, and count what differs.

    python3 scripts/torch_repeat_probe.py [--songs 160]

For each variant ("fixed" restores nothing) it prints one JSON line: the
differing entries of the tempogram segment sums of the corpus's superflux
envelopes between two runs, the differing entries of the fused W of the
first 16-song chunk, and the differing entries of the StrucLaplacian
profiles. Corpus: covers80 geometry (`chip_smoke.py`'s), cut to
`--songs`. Runs on the card (`--device cpu` rehearses it, where every
variant repeats).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from acoss_tpu_torch.benchmarking.algorithms import (  # noqa: E402
    StrucLaplacian, struct_common)
from acoss_tpu_torch.data import make_synthetic_dataset  # noqa: E402
from acoss_tpu_torch.features import rhythm  # noqa: E402
from acoss_tpu_torch.ops import fusion, structure  # noqa: E402


def _segment_sum_index_add(x, seg_ids, n_seg):
    B, F, d = x.shape
    sums = torch.zeros((B * n_seg, d), dtype=x.dtype, device=x.device)
    offs = torch.arange(B, device=x.device)[:, None] * n_seg
    sums.index_add_(0, (seg_ids + offs).reshape(-1), x.reshape(-1, d))
    return sums.reshape(B, n_seg, d)


def _stacked_cosine_cumsum(x, win):
    """`structure.stacked_cosine` with its window sum by torch.cumsum."""
    n = x.shape[-2] - (win - 1)
    sq, G = structure._gram(x)
    num = structure._window_diag_sum(G, win, n)
    csq = torch.cumsum(torch.cat([sq.new_zeros(sq.shape[:-1] + (1,)), sq],
                                 dim=-1), dim=-1)
    nrm = torch.sqrt(torch.clamp_min(csq[..., win:] - csq[..., :-win], 0.0))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return 1.0 - num / (nrm[..., :, None] * nrm[..., None, :])


def _mean_k_smallest_cumsum(D, k, k_static_max=None):
    """`fusion._mean_k_smallest` by torch.cumsum."""
    srt = fusion._smallest_sorted(D, k_static_max)
    kk = torch.clamp(fusion._per_matrix(k, D.shape[:-2], D.device), 1,
                     srt.shape[-1])
    csum = torch.cumsum(srt, dim=-1)
    idx = (kk - 1)[..., None, None].expand(D.shape[:-1] + (1,))
    tot = torch.gather(csum, -1, idx)[..., 0]
    return tot / kk.to(D.dtype)[..., None]


def _draw_cumsum(p, u):
    """`structure._draw` with its CDF by torch.cumsum."""
    c = torch.cumsum(p.to(torch.float64), dim=-1)
    tot = c[..., -1:]
    empty = tot == 0
    n = p.shape[-1]
    c = torch.where(empty, torch.arange(1, n + 1, device=p.device,
                                        dtype=torch.float64), c)
    tot = torch.where(empty, float(n), tot)
    i = torch.searchsorted(c.contiguous(), (u[..., None] * tot).contiguous(),
                           right=True)
    return torch.clamp_max(i[..., 0], n - 1)


VARIANTS = {
    "fixed": [],
    "index_add": [(rhythm, "segment_sum", _segment_sum_index_add)],
    "cumsum_stacked_cosine": [(structure, "stacked_cosine",
                               _stacked_cosine_cumsum)],
    "cumsum_snf_radii": [(fusion, "_mean_k_smallest",
                          _mean_k_smallest_cumsum)],
    "cumsum_kmeans_cdf": [(structure, "_draw", _draw_cumsum)],
}


def _tempogram_sums(fs, device):
    envs, bounds = [], []
    for i in range(fs.n_songs):
        n = fs.length("snovfn")[i]
        envs.append(fs.feature("snovfn")[i, :n, 0])
        on = fs.feature("onsets")[i, :fs.length("onsets")[i], 0]
        bounds.append(on)
    return np.concatenate([t.ravel() for t in
                           rhythm.tempogram_aggregated_batch(
                               envs, bounds, device=device)])


def _first_chunk_w(fs, device):
    out = []

    def consume(Wb, lengths, onsets_list, songs):
        if not out:
            out.append(Wb.cpu().numpy())
        return [None] * len(onsets_list)

    algo = StrucLaplacian()
    struct_common.structural_fused_w_all(fs, consume=consume, device=device,
                                         **algo._fuse_kw())
    return out[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--songs", type=int, default=160)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fs = make_synthetic_dataset(n_cliques=80, clique_size=2, n_states=48,
                                base_duration=300.0, beat_period=30.0,
                                seed=0).subset(np.arange(args.songs))
    for name, patches in VARIANTS.items():
        reals = [(m, a, getattr(m, a)) for m, a, _ in patches]
        for m, a, fn in patches:
            setattr(m, a, fn)
        try:
            runs = [(_tempogram_sums(fs, args.device),
                     _first_chunk_w(fs, args.device),
                     StrucLaplacian().extract_descriptors(
                         fs, device=args.device)["profile"])
                    for _ in range(2)]
        finally:
            for m, a, real in reals:
                setattr(m, a, real)
        (t1, w1, p1), (t2, w2, p2) = runs
        print(json.dumps({
            "variant": name,
            "tempogram_sum_entries_differing": int((t1 != t2).sum()),
            "tempogram_sum_entries": int(t1.size),
            "first_chunk_w_entries_differing": int((w1 != w2).sum()),
            "profile_entries_differing": int((p1 != p2).sum()),
            "profile_entries": int(p1.size)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
