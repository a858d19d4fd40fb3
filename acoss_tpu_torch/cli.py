"""Command-line entry point of the port.

`python -m acoss_tpu_torch benchmark -a ALGORITHM -d <features.npz>
 -s NAME [-c hpcp] [-t TILE] [--n_buckets N] [--cachedir DIR]
 [--no-checkpoint] [--snf-precision {highest,default}]
 [--stream-dir DIR [--stream-chunk N] [--stream-half | --stream-int8]
 [--hybrid-panel P [--no-panel-prefetch]]] [--device cuda]`
extracts descriptors, sweeps the pair grid on the device (ALGORITHM is any
name of `ALL_ALGORITHMS`; `-c` applies to the families that read chroma),
prints MR/MRR/MDR/MAP per similarity type and appends them to
`results_<NAME>.csv` (the reference's CSV schema). The sweep checkpoints
to `<cachedir>/<algorithm>_<NAME>_ckpt.npz` and resumes from it.

`--n_buckets N` sweeps length buckets; `--stream-dir DIR` is the
Da-TACOS-scale mode: descriptors extracted chunk by chunk into a disk
store under DIR/desc (per-bucket stores with `--n_buckets`), reused by a
later run, and N x N memmapped score matrices under DIR/scores;
`--hybrid-panel P` sweeps P-song device panels against column tiles
streamed from that store.
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys


def _stream_quant(args) -> str | None:
    """--stream-int8 / --stream-half -> the extract_streamed quant mode."""
    if args.stream_int8:
        return "int8"
    return "half" if args.stream_half else None


def _report(algo, stats: dict, csv: str) -> None:
    for k, s in stats.items():
        print(f"{algo.NAME}_{k}: MR={s.mr:.4g} MRR={s.mrr:.4g} "
              f"MDR={s.mdr:.4g} MAP={s.map:.4g} "
              f"Top-1={s.tops.get(1)} Top-10={s.tops.get(10)}")
    print(f"results appended to {csv}")


def _eval_and_report(algo, Ds: dict, desc: dict, labels, csv: str,
                     device) -> None:
    from acoss_tpu_torch.benchmarking.evaluation import (eval_statistics,
                                                         write_results_csv)

    Ds = algo.post_process(Ds, desc, device=device)
    stats = {}
    for k, D in Ds.items():
        stats[k] = eval_statistics(-D if k in algo.DISTANCE_TYPES else D,
                                   labels)
        write_results_csv(csv, algo.NAME, k, stats[k])
    _report(algo, stats, csv)


def _cmd_stream(args, algo, fs, ckpt: str | None, csv: str) -> int:
    """--stream-dir: disk descriptor stores and memmapped scores."""
    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.data.descstore import (DescriptorStore,
                                                check_stream_consistency,
                                                extract_streamed)

    if algo.full_scores is not None:
        print(f"algorithm {args.algorithm} computes scores in one shot "
              f"(full_scores) and does not support --stream-dir",
              file=sys.stderr)
        return 1
    quant = _stream_quant(args)
    if args.n_buckets > 1:
        # buckets + per-bucket disk stores + memmapped scores + resume in
        # one call: the matrices stay in length-sorted order and the
        # labels are permuted for eval (retrieval stats are
        # permutation-invariant)
        Ds, desc, perm = harness.run_pairwise_bucketed(
            algo, fs, n_buckets=args.n_buckets, tile=args.tile,
            verbose=True, checkpoint_path=ckpt, stream_dir=args.stream_dir,
            stream_chunk=args.stream_chunk, stream_quant=quant,
            return_desc=True, return_perm=True, device=args.device)
        _eval_and_report(algo, Ds, desc, fs.labels[perm], csv, args.device)
        return 0

    desc_path = os.path.join(args.stream_dir, "desc")
    if os.path.exists(os.path.join(desc_path, DescriptorStore.META)):
        print(f"reusing descriptor store {desc_path}")
        desc = DescriptorStore.open(desc_path)
        check_stream_consistency(desc, quant, desc_path)
    else:
        desc = extract_streamed(algo, fs, desc_path,
                                chunk_songs=args.stream_chunk, verbose=True,
                                quant=quant, device=args.device)
    scores_dir = os.path.join(args.stream_dir, "scores")
    if args.hybrid_panel:
        Ds = harness.run_pairwise_hybrid(
            algo, desc, fs.n_songs, panel_songs=args.hybrid_panel,
            tile=args.tile, checkpoint_path=ckpt, verbose=True,
            scores_dir=scores_dir,
            prefetch_panels=not args.no_panel_prefetch, device=args.device)
    else:
        Ds = harness.run_pairwise(
            algo, desc, fs.n_songs, tile=args.tile, checkpoint_path=ckpt,
            verbose=True, scores_dir=scores_dir, device=args.device)
    _eval_and_report(algo, Ds, desc, fs.labels, csv, args.device)
    return 0


def cmd_benchmark(args) -> int:
    import torch

    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS
    from acoss_tpu_torch.benchmarking.harness import benchmark
    from acoss_tpu_torch.data.store import FeatureSet

    cls = ALL_ALGORITHMS[args.algorithm]
    params = inspect.signature(cls).parameters
    # TGAlg and ANFScattering read novelty functions, not chroma
    kwargs = {"chroma_type": args.chroma_type} \
        if "chroma_type" in params else {}
    if args.snf_precision != "highest":
        if "snf_precision" not in params:
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
    if args.stream_dir:
        # benchmark() is not on this path: TF32 flips kNN decisions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return _cmd_stream(args, algo, fs, ckpt, csv)
    stats = benchmark(algo, fs, tile=args.tile, results_csv=csv,
                      checkpoint_path=ckpt, verbose=True,
                      device=args.device, n_buckets=args.n_buckets)
    _report(algo, stats, csv)
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
    b.add_argument("--n_buckets", type=int, default=1,
                   help="length buckets for the sweep (>1 cuts padding "
                        "waste on corpora with a wide length spread)")
    b.add_argument("--cachedir", default="cache")
    b.add_argument("--no-checkpoint", action="store_true")
    b.add_argument("--snf-precision", default="highest",
                   choices=("highest", "default"),
                   help="SNF diffusion matmuls: 'highest' (parity, full "
                        "fp32) or 'default' (throughput: bf16-rounded "
                        "operands and the fused WCSMSSM kernel; not for "
                        "parity runs)")
    b.add_argument("--stream-dir", default=None, metavar="DIR",
                   help="Da-TACOS-scale mode: chunked descriptor "
                        "extraction into a disk store under DIR/desc "
                        "(reused if present) and memmapped N x N score "
                        "matrices under DIR/scores (host RAM stays "
                        "bounded by the tile size)")
    b.add_argument("--stream-chunk", type=int, default=256,
                   help="songs per extraction chunk with --stream-dir")
    quant = b.add_mutually_exclusive_group()
    quant.add_argument("--stream-half", action="store_true",
                       help="with --stream-dir: store heavy float32 "
                            "descriptors as float16 (restored to fp32 on "
                            "the device; a throughput mode, not for "
                            "full-precision parity runs)")
    quant.add_argument("--stream-int8", action="store_true",
                       help="with --stream-dir: store heavy float32 "
                            "descriptors as per-song-scaled int8 (a "
                            "quarter of the disk store and host->device "
                            "traffic; dequantized to fp32 on the device; "
                            "absolute error ~0.4%% of each song's "
                            "max-abs; not for full-precision parity runs)")
    b.add_argument("--hybrid-panel", type=int, default=0, metavar="P",
                   help="with --stream-dir: hybrid device-panel / "
                        "disk-column sweep keeping P songs' descriptors "
                        "on the device a panel")
    b.add_argument("--no-panel-prefetch", action="store_true",
                   help="with --hybrid-panel: don't overlap the next "
                        "panel's upload with the current panel's sweep "
                        "(use when one panel already fills most of the "
                        "device memory)")
    b.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")
    args = parser.parse_args(argv)
    if args.hybrid_panel and not args.stream_dir:
        parser.error("--hybrid-panel needs --stream-dir")
    return cmd_benchmark(args)
