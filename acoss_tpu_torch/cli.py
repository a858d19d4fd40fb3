"""Command-line entry point of the port.

`python -m acoss_tpu_torch extract -i <audio dir | collection txt>
 -o features.npz [-n THREADS] [-m cluster --num-shards N --shard-id I]
 [--merge-shards] [--error-log errors.txt] [--device cuda]`
extracts the default feature profile (hpcp, key, madmom substitute,
mfcc_htk, crema) of every .wav/.mp3 under the directory (or listed in the
txt) into one FeatureSet; a song's clique label is its parent directory.
`-m cluster` extracts one contiguous shard into
`<output>.part_<I>_<N>.npz`, and `--merge-shards` concatenates the parts
into `<output>`, bit-identical to the serial extraction.

`python -m acoss_tpu_torch benchmark -a ALGORITHM -d <features.npz>
 -s NAME [-c hpcp] [-t TILE] [--n_buckets N] [--cachedir DIR]
 [--no-checkpoint] [--snf-precision {highest,default}]
 [--stream-dir DIR [--stream-chunk N] [--stream-half | --stream-int8]
 [--hybrid-panel P [--no-panel-prefetch]]] [--device cuda]`
extracts descriptors, sweeps the pair grid on the device (ALGORITHM is any
name of `ALL_ALGORITHMS` or its class name, so StructureLaplacian and
StrucLaplacian both work; `-c` applies to the families that read chroma),
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
import glob
import inspect
import os
import re
import sys


def _algorithms() -> dict:
    """Every algorithm class by its NAME (the JAX package's keys) and by
    its class name (StrucLaplacian's NAME is StructureLaplacian)."""
    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS

    return {**{c.__name__: c for c in ALL_ALGORITHMS.values()},
            **ALL_ALGORITHMS}


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

    from acoss_tpu_torch.benchmarking.harness import benchmark
    from acoss_tpu_torch.data.store import FeatureSet

    cls = _algorithms()[args.algorithm]
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


def _shard_stem(output: str) -> str:
    """The naming stem of the shard parts of `output`, for the writer and
    for the --merge-shards glob."""
    return output[:-4] if output.endswith(".npz") else output


def _shard_part_path(output: str, shard_id: int, num_shards: int) -> str:
    return f"{_shard_stem(output)}.part_{shard_id}_{num_shards}.npz"


def _merge_shards(output: str) -> int:
    """Concatenate the shard FeatureSets of `output` in shard order."""
    from acoss_tpu_torch.data.store import FeatureSet, concat_feature_sets

    stem = _shard_stem(output)
    tags = []
    for p in sorted(glob.glob(glob.escape(stem) + ".part_*_*.npz")):
        m = re.search(r"\.part_(\d+)_(\d+)\.npz$", p)
        if m:
            tags.append((int(m.group(1)), int(m.group(2)), p))
    if not tags:
        print(f"no shard files matching {stem}.part_*_*.npz",
              file=sys.stderr)
        return 1
    nshards = {t[1] for t in tags}
    if len(nshards) != 1:
        print(f"shards from different shardings {sorted(nshards)}; clean "
              f"out stale runs", file=sys.stderr)
        return 1
    n = nshards.pop()
    missing = set(range(n)) - {t[0] for t in tags}
    if missing:
        print(f"missing shard(s) {sorted(missing)} of {n}; rerun them "
              f"before merging", file=sys.stderr)
        return 1
    fs = concat_feature_sets([FeatureSet.load(p) for _, _, p in
                              sorted(tags)])
    fs.save(output)
    print(f"merged {n} shards ({fs.n_songs} songs) -> {output}")
    return 0


def cmd_extract(args) -> int:
    import numpy as np

    from acoss_tpu_torch.data.manifest import (label_of, read_txt_list,
                                               track_id_of)
    from acoss_tpu_torch.features.pipeline import batch_extract

    if args.merge_shards:
        return _merge_shards(args.output)
    if not args.input:
        print("-i/--input is required unless --merge-shards",
              file=sys.stderr)
        return 1
    if os.path.isdir(args.input):
        paths = sorted(
            glob.glob(os.path.join(args.input, "**", "*.wav"),
                      recursive=True)
            + glob.glob(os.path.join(args.input, "**", "*.mp3"),
                        recursive=True))
    else:
        paths = read_txt_list(args.input)
    if not paths:
        print("no audio files found", file=sys.stderr)
        return 1
    output = args.output
    if args.mode == "cluster":
        # one array-job shard (the reference's `-m cluster`,
        # `extractors.py:145-146`): a contiguous block of the collection
        if not 0 <= args.shard_id < args.num_shards:
            print(f"--shard-id must be in [0, {args.num_shards}), got "
                  f"{args.shard_id}", file=sys.stderr)
            return 1
        idx = np.array_split(np.arange(len(paths)),
                             args.num_shards)[args.shard_id]
        paths = [paths[i] for i in idx]
        output = _shard_part_path(args.output, args.shard_id,
                                  args.num_shards)
        if not paths:
            print(f"shard {args.shard_id} is empty ({args.num_shards} "
                  f"shards over fewer files)", file=sys.stderr)
            return 1
    fs = batch_extract(paths, [label_of(p) for p in paths],
                       [track_id_of(p) for p in paths],
                       error_log=args.error_log, n_workers=args.n_threads,
                       device=args.device)
    fs.save(output)
    print(f"extracted {fs.n_songs}/{len(paths)} songs -> {output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="acoss_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("benchmark", help="run a cover-song benchmark")
    b.add_argument("-a", "--algorithm", required=True,
                   choices=sorted(_algorithms()))
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
    b.set_defaults(fn=cmd_benchmark)

    e = sub.add_parser("extract", help="extract features from audio")
    e.add_argument("-i", "--input", default=None,
                   help="audio directory or collection txt (not needed "
                        "with --merge-shards)")
    e.add_argument("-o", "--output", default="features.npz")
    e.add_argument("-m", "--mode", default="cpu",
                   choices=["cpu", "cluster"],
                   help="'cluster' extracts one shard of the collection "
                        "(with --num-shards/--shard-id) for array jobs "
                        "(the reference's -m cluster; the name does not "
                        "pick the device, --device does)")
    e.add_argument("-n", "--n_threads", type=int, default=1,
                   help="host threads for per-song decode + feature "
                        "computation (the reference's joblib -n)")
    e.add_argument("--num-shards", type=int, default=1,
                   help="total shards in cluster mode")
    e.add_argument("--shard-id", type=int, default=0,
                   help="this job's shard index (0-based)")
    e.add_argument("--merge-shards", action="store_true",
                   help="concatenate <output>.part_*_*.npz shard "
                        "FeatureSets into <output>")
    e.add_argument("--error-log", default="errors.txt")
    e.add_argument("--device", default="cuda",
                   help="torch device of the spectral stages (default "
                        "cuda; cpu runs the plain PyTorch versions)")
    e.set_defaults(fn=cmd_extract)

    args = parser.parse_args(argv)
    if args.cmd == "benchmark" and args.hybrid_panel and not args.stream_dir:
        parser.error("--hybrid-panel needs --stream-dir")
    return args.fn(args)
