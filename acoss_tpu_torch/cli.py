"""Command-line entry point of the port.

`python -m acoss_tpu_torch benchmark -a {Serra09,EarlySNF,EarlyFusion} -d
 <features.npz> -s NAME [-c hpcp] [-t TILE] [--cachedir DIR]
 [--no-checkpoint] [--snf-precision {highest,default}] [--device cuda]`
extracts descriptors, sweeps the pair grid on the device, prints
MR/MRR/MDR/MAP per similarity type and appends them to
`results_<NAME>.csv` (the reference's CSV schema). The sweep checkpoints
to `<cachedir>/<algorithm>_<NAME>_ckpt.npz` and resumes from it.
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys


def cmd_benchmark(args) -> int:
    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS
    from acoss_tpu_torch.benchmarking.harness import benchmark
    from acoss_tpu_torch.data.store import FeatureSet

    cls = ALL_ALGORITHMS[args.algorithm]
    kwargs = {"chroma_type": args.chroma_type}
    if args.snf_precision != "highest":
        if "snf_precision" not in inspect.signature(cls).parameters:
            print(f"--snf-precision is not supported by {args.algorithm}",
                  file=sys.stderr)
            return 1
        kwargs["snf_precision"] = args.snf_precision
    algo = cls(**kwargs)
    fs = FeatureSet.load(args.datapath)
    os.makedirs(args.cachedir, exist_ok=True)
    csv = f"results_{args.shortname}.csv"
    ckpt = None if args.no_checkpoint else os.path.join(
        args.cachedir, f"{algo.NAME}_{args.shortname}_ckpt.npz")
    stats = benchmark(algo, fs, tile=args.tile, results_csv=csv,
                      checkpoint_path=ckpt, verbose=True,
                      device=args.device)
    for k, s in stats.items():
        print(f"{algo.NAME}_{k}: MR={s.mr:.4g} MRR={s.mrr:.4g} "
              f"MDR={s.mdr:.4g} MAP={s.map:.4g} "
              f"Top-1={s.tops.get(1)} Top-10={s.tops.get(10)}")
    print(f"results appended to {csv}")
    return 0


def main(argv=None) -> int:
    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS

    parser = argparse.ArgumentParser(prog="acoss_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("benchmark", help="run a cover-song benchmark")
    b.add_argument("-a", "--algorithm", required=True,
                   choices=sorted(ALL_ALGORITHMS))
    b.add_argument("-d", "--datapath", required=True,
                   help="FeatureSet .npz (as written by either package)")
    b.add_argument("-s", "--shortname", default="covers80")
    b.add_argument("-c", "--chroma_type", default="hpcp")
    b.add_argument("-t", "--tile", type=int, default=None)
    b.add_argument("--cachedir", default="cache")
    b.add_argument("--no-checkpoint", action="store_true")
    b.add_argument("--snf-precision", default="highest",
                   choices=("highest", "default"),
                   help="SNF diffusion matmuls: 'highest' (parity, full "
                        "fp32) or 'default' (throughput: bf16-rounded "
                        "operands and the fused WCSMSSM kernel; not for "
                        "parity runs)")
    b.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")
    args = parser.parse_args(argv)
    return cmd_benchmark(args)
