"""Time StrucLaplacian's SVD stage on the card under each of
`torch.linalg.svd`'s CUDA solvers (its `driver=` argument), on the meet
matrices of real chunks.

    python3 scripts/torch_svd_solvers.py [--songs 32] [--reps 3]

Builds a covers80-geometry synthetic corpus (`make_synthetic_dataset`,
seed 0) of `--songs` songs, runs the port's StrucLaplacian structure
stage to its meet matrices (fused W -> eigenvectors -> k-means -> meet)
chunk by chunk, then times `structure.svd_curve` on each chunk's meet
batch with the default solver and with `gesvd`, `gesvdj` and `gesvda`
(CUDA events, the median of `--reps` calls after one warm-up), and
compares each solver's velocity profiles (the descriptor) with the
default solver's. Prints one line a solver and the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

# run from the root of a checkout
sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--songs", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from acoss_tpu_torch.benchmarking.algorithms import StrucLaplacian
    from acoss_tpu_torch.benchmarking.algorithms import struc_laplacian as sl
    from acoss_tpu_torch.benchmarking.algorithms.struct_common import \
        structural_fused_w_all
    from acoss_tpu_torch.data import make_synthetic_dataset
    from acoss_tpu_torch.ops import structure

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fs = make_synthetic_dataset(n_cliques=args.songs // 2, clique_size=2,
                                n_states=48, base_duration=300.0,
                                beat_period=30.0, seed=0)
    algo = StrucLaplacian()
    chunks = []

    def consume(Wb, lengths, onsets, songs):
        npad = Wb.shape[1]
        times = np.full((len(onsets), npad), 1e18, np.float32)
        for b, o in enumerate(onsets):
            times[b, :len(o)] = o.astype(np.float64) * sl.HOP_LENGTH / sl.SR
        beats = np.minimum(lengths, [len(o) for o in onsets])
        vs = structure.spectral_features(Wb, beats, algo.neigs)
        meet, nmeet = structure.meet_matrices(
            vs, beats, times, algo.neigs, sl.meet_pad_for(npad, onsets),
            songs)
        chunks.append((meet, nmeet.cpu().numpy()))
        return [None] * len(onsets)

    structural_fused_w_all(fs, consume=consume, device=dev,
                           **algo._fuse_kw())
    real_svd = torch.linalg.svd
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    shapes = [tuple(m.shape) for m, _ in chunks]
    base = None
    for solver in (None, "gesvd", "gesvdj", "gesvda"):
        torch.linalg.svd = lambda A, full_matrices=True, _s=solver: \
            real_svd(A, full_matrices=full_matrices, driver=_s)
        ms, profiles = [], []
        try:
            for meet, nmeet in chunks:
                structure.svd_curve(meet, algo.neigs)
                times = []
                for _ in range(args.reps):
                    torch.cuda.synchronize()
                    start.record()
                    X = structure.svd_curve(meet, algo.neigs)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                ms.append(float(np.median(times)))
                Xh = X.cpu().numpy().astype(np.float64)
                profiles += [algo._profile_from_curve(Xh[b, :nmeet[b]])
                             for b in range(len(nmeet))]
        except torch.linalg.LinAlgError as e:
            print(f"[svd] solver {solver}: {str(e).splitlines()[0]}",
                  flush=True)
            continue
        finally:
            torch.linalg.svd = real_svd
        if base is None:
            base = profiles
        err = max(float(np.abs(p - q).max()) for p, q in zip(profiles, base))
        peak = max(float(np.abs(q).max()) for q in base)
        print(f"[svd] solver {solver or 'default'}: "
              + ", ".join(f"{s} {t:.1f} ms" for s, t in zip(shapes, ms))
              + f"; profiles vs the default solver's: max abs diff "
              f"{err:.3g} (largest value {peak:.3g})", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
