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
 -s NAME [-c hpcp] [-t TILE] [--n_buckets N] [--mesh RxC] [--cachedir DIR]
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
streamed from that store. `--num-processes N --process-id I
[--partial-dir DIR]` sweeps one process's share of the tile grid (whole
panels with `--hybrid-panel`) into a partial-score file (the reference's
`-r` array-job mode); `--merge` scatter-adds the partials and evaluates
(the reference's `-b`). `--mesh RxC` shards the pair grid over an R x C
grid of devices (`parallel.mesh`: the triangular fold for a symmetric
algorithm, the rectangular sweep otherwise); with `--device cuda` it
takes R * C visible cards, and a device that names one device (`cpu`,
`cuda:0`) fills every slot. `--stage-times` prints the program's spans
(`utils.profiling.stages`: each span's total and self seconds, calls,
milliseconds a call and parent, such as `sweep:tile` under no parent and
`score:tile` and `store:*` under it) and its counters (`store:h2d_copies`,
`store:h2d_bytes`, on a card's streamed sweep `store:stage_waits`, and on
a card's Serra09 tiles `crp:cluster_calls` and `score:prep_calls`);
`--profile LOGDIR` writes a `torch.profiler` trace in which every span is
a range of the same name beside the kernels, with its args (`ti=3 tj=1`).
`-d` is a FeatureSet .npz or a directory of the reference's per-track .h5
files, for every command.

`python -m acoss_tpu_torch query -a ALGORITHM -d <corpus> -q <queries>
 [--index-dir DIR] [--quant {half,int8}] [--top K] [--similarity-type T]
 [--device cuda]` answers 1 x N retrieval against a corpus index (built
once, kept on the device, saved to and reloaded from DIR) and prints one
JSON line a query.

`python -m acoss_tpu_torch coverstats -d <features> -o <outdir>
 [--studies key,tempo,onset,stdev,shapedna,tag] [--tags JSON]
 [--no-figures] [--device cuda]` runs the "what is a cover?" studies and
writes their CSV/.npz/SVG artifacts and summary.json.
"""

from __future__ import annotations

import argparse
import glob
import inspect
import os
import re
import sys
import time

#: how long a --stream-dir shard waits for process 0's descriptor store
SHARD_WAIT_S = 24 * 3600.0


def _algorithms() -> dict:
    """Every algorithm class by its NAME (the JAX package's keys) and by
    its class name (StrucLaplacian's NAME is StructureLaplacian)."""
    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS

    return {**{c.__name__: c for c in ALL_ALGORITHMS.values()},
            **ALL_ALGORITHMS}


def _load_featureset(datapath: str):
    """A FeatureSet .npz, or a directory of per-track .h5 files."""
    from acoss_tpu_torch.data.store import FeatureSet

    if os.path.isdir(datapath):
        from acoss_tpu_torch.data.h5io import feature_set_from_h5_dir

        return feature_set_from_h5_dir(datapath)
    return FeatureSet.load(datapath)


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


def _chroma_kwargs(cls, args) -> dict:
    """-c for the families that read chroma (TGAlg and ANFScattering read
    novelty functions)."""
    return {"chroma_type": args.chroma_type} \
        if "chroma_type" in inspect.signature(cls).parameters else {}


def _partial_paths(algo, partial_dir: str):
    """The partials of `algo` under `partial_dir`, checked as one complete
    shard set: the stems encode pid/nproc (NAME_part_<pid>_<nproc>); a
    missing shard would silently zero its block-rows in the merged
    matrices, and a stale partial of a run with another nproc would add
    tiles twice. Returns (paths, None) or (None, error message)."""
    paths = sorted(
        p for p in glob.glob(os.path.join(glob.escape(partial_dir),
                                          f"{algo.NAME}_part_*"))
        if p.endswith(".npz") or os.path.isdir(p))
    if not paths:
        return None, f"no partial files under {partial_dir}"
    tags = []
    for p in paths:
        m = re.search(r"_part_(\d+)_(\d+)(?:\.npz)?$", p)
        if not m:
            return None, f"unrecognized partial name {p}"
        tags.append((int(m.group(1)), int(m.group(2))))
    nprocs = {t[1] for t in tags}
    if len(nprocs) != 1:
        return None, (f"partials from different shardings "
                      f"{sorted(nprocs)} in {partial_dir}; clean out "
                      f"stale runs")
    nproc = nprocs.pop()
    missing = set(range(nproc)) - {t[0] for t in tags}
    if missing:
        return None, (f"missing shard(s) {sorted(missing)} of {nproc}; "
                      f"rerun them before merging")
    return paths, None


def _cmd_merge(args, algo, fs, csv: str) -> int:
    """--merge: scatter-add the partial-score files written by the
    process shards (the reference's `-b` / `load_batches`) and
    evaluate."""
    from acoss_tpu_torch.data.descstore import DescriptorStore
    from acoss_tpu_torch.parallel.distributed import merge_partials

    paths, err = _partial_paths(algo, args.partial_dir)
    if err:
        print(err, file=sys.stderr)
        return 1
    print(f"merging {len(paths)} partials")
    out_dir = (os.path.join(args.stream_dir, "merged")
               if args.stream_dir else None)
    Ds = merge_partials(paths, symmetric=algo.SYMMETRIC, out_dir=out_dir)
    # post_process only ever needs the descriptors (ChenFusion's per-song
    # lengths): reuse a streamed store when one exists instead of
    # re-running the most expensive host stage in the aggregation job
    desc_path = (os.path.join(args.stream_dir, "desc")
                 if args.stream_dir else None)
    if desc_path and os.path.exists(
            os.path.join(desc_path, DescriptorStore.META)):
        print(f"reusing descriptor store {desc_path}")
        desc = DescriptorStore.open(desc_path)
    else:
        desc = algo.extract_descriptors(fs, device=args.device)
    _eval_and_report(algo, Ds, desc, fs.labels, csv, args.device)
    return 0


def _shard_store(args, algo, fs):
    """The shared descriptor store of a --stream-dir shard: exactly ONE
    process (0) may build it (concurrent extract_streamed calls would
    race on the staging files and half-written memmaps); its META file is
    written only after the final copy pass, so its appearance is the
    barrier the other shards wait on. Returns the store, or None when
    process 0 never finished it."""
    from acoss_tpu_torch.data.descstore import (DescriptorStore,
                                                check_stream_consistency,
                                                extract_streamed)

    desc_path = os.path.join(args.stream_dir, "desc")
    meta = os.path.join(desc_path, DescriptorStore.META)
    if not os.path.exists(meta) and args.process_id == 0:
        return extract_streamed(algo, fs, desc_path,
                                chunk_songs=args.stream_chunk, verbose=True,
                                quant=_stream_quant(args),
                                device=args.device)
    if not os.path.exists(meta):
        # generous deadline: a Da-TACOS-scale extraction takes hours, but
        # if process 0 died the other shards must eventually FAIL, not
        # hang an array job forever
        deadline = time.time() + SHARD_WAIT_S
        print(f"waiting for process 0 to build {desc_path} ...",
              flush=True)
        while not os.path.exists(meta):
            if time.time() > deadline:
                print(f"gave up waiting for {meta} after "
                      f"{SHARD_WAIT_S / 3600:g} h; did process 0 die?",
                      file=sys.stderr)
                return None
            time.sleep(5.0)
    desc = DescriptorStore.open(desc_path)
    check_stream_consistency(desc, _stream_quant(args), desc_path)
    return desc


def _cmd_mesh(args, algo, fs, csv: str) -> int:
    """--mesh RxC: the devices of an R x C grid score blocks of the pair
    grid; a symmetric algorithm takes the triangular fold over the
    flattened grid, a non-symmetric one the rectangular sweep with the
    diagonal zeroed."""
    import numpy as np

    from acoss_tpu_torch.parallel.mesh import (make_pair_mesh, mesh_devices,
                                               sharded_pair_scores,
                                               sharded_pair_scores_triangular)

    if algo.full_scores is not None:
        print(f"algorithm {args.algorithm} computes scores in one shot "
              f"(full_scores) and does not support --mesh", file=sys.stderr)
        return 1
    r, c = args.mesh
    mesh = make_pair_mesh(mesh_devices(args.device, r * c), (r, c))
    home = mesh[0, 0]
    desc = algo.extract_descriptors(fs, device=home)
    col_tile = args.tile or algo.TILE
    if algo.SYMMETRIC:
        Ds = sharded_pair_scores_triangular(
            algo.tile_scores, desc, fs.n_songs, devices=mesh.ravel(),
            col_tile=col_tile)
    else:
        Ds = sharded_pair_scores(algo.tile_scores, desc, fs.n_songs, mesh,
                                 col_tile=col_tile)
        for D in Ds.values():
            np.fill_diagonal(D, 0.0)
    _eval_and_report(algo, Ds, desc, fs.labels, csv, home)
    return 0


def _cmd_shard(args, algo, fs) -> int:
    """One shard of a multi-process sweep (the reference's `-r`): write a
    partial file; a later --merge run aggregates and evaluates."""
    from acoss_tpu_torch.parallel.distributed import (
        run_process_shard, run_process_shard_hybrid)

    if not 0 <= args.process_id < args.num_processes:
        # schedulers often hand out 1-BASED task ids; failing here beats
        # an IndexError deep in the shard assignment (and a merge that
        # would silently zero shard 0's block-rows)
        print(f"--process-id must be in [0, {args.num_processes}), got "
              f"{args.process_id}; task ids are 0-based here",
              file=sys.stderr)
        return 1
    # with --stream-dir, descriptors come from the shared disk store and
    # the partial is a directory of .npy memmaps (nothing dense in RAM)
    if args.stream_dir:
        desc = _shard_store(args, algo, fs)
        if desc is None:
            return 1
    else:
        desc = algo.extract_descriptors(fs, device=args.device)
    if args.hybrid_panel:
        path = run_process_shard_hybrid(
            algo, desc, fs.n_songs, args.process_id, args.num_processes,
            args.partial_dir, panel_songs=args.hybrid_panel, tile=args.tile,
            verbose=True, prefetch_panels=not args.no_panel_prefetch,
            device=args.device)
    else:
        path = run_process_shard(
            algo, desc, fs.n_songs, args.process_id, args.num_processes,
            args.partial_dir, tile=args.tile, verbose=True,
            memmap_scores=bool(args.stream_dir), device=args.device)
    print(f"partial scores written to {path}")
    return 0


def cmd_benchmark(args) -> int:
    from acoss_tpu_torch.utils import profiling

    # the spans are the trace's ranges, so --profile turns them on too
    profiling.stages.enabled = bool(args.stage_times or args.profile)
    profiling.stages.reset()
    try:
        with profiling.device_trace(args.profile):
            rc = _cmd_benchmark_inner(args)
    finally:
        profiling.stages.enabled = False
    if args.stage_times:
        print(profiling.stages.report())
    if args.profile:
        print(f"device trace written to "
              f"{os.path.join(args.profile, profiling.TRACE_FILE)}")
    return rc


def _cmd_benchmark_inner(args) -> int:
    from acoss_tpu_torch.benchmarking.harness import benchmark

    cls = _algorithms()[args.algorithm]
    kwargs = _chroma_kwargs(cls, args)
    if args.snf_precision != "highest":
        if "snf_precision" not in inspect.signature(cls).parameters:
            print(f"--snf-precision is not supported by {args.algorithm}",
                  file=sys.stderr)
            return 1
        kwargs["snf_precision"] = args.snf_precision
    algo = cls(**kwargs)
    fs = _load_featureset(args.datapath)
    os.makedirs(args.cachedir, exist_ok=True)
    csv = f"results_{args.shortname}.csv"
    if args.merge:
        return _cmd_merge(args, algo, fs, csv)
    if args.num_processes > 1:
        return _cmd_shard(args, algo, fs)
    if args.mesh:
        return _cmd_mesh(args, algo, fs, csv)
    ckpt = None if args.no_checkpoint else os.path.join(
        args.cachedir, f"{algo.NAME}_{args.shortname}_ckpt.npz")
    if args.stream_dir:
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


def cmd_query(args) -> int:
    import json

    from acoss_tpu_torch.serving import CoverIndex

    cls = _algorithms()[args.algorithm]
    algo = cls(**_chroma_kwargs(cls, args))
    if args.index_dir and os.path.exists(
            os.path.join(args.index_dir, CoverIndex.META)):
        print(f"loading index from {args.index_dir}")
        index = CoverIndex.load(algo, args.index_dir, device=args.device)
    else:
        fs = _load_featureset(args.datapath)
        print(f"building index over {fs.n_songs} songs")
        index = CoverIndex.build(algo, fs, quant=args.quant, tile=args.tile,
                                 device=args.device)
        if args.index_dir:
            index.save(args.index_dir)
            print(f"index saved to {args.index_dir}")
    qfs = _load_featureset(args.querypath)
    ranked = index.top_k(qfs, k=args.top,
                         similarity_type=args.similarity_type)
    for qi, rows in enumerate(ranked):
        print(json.dumps({"query": str(qfs.track_ids[qi]), "top": rows}))
    return 0


def cmd_coverstats(args) -> int:
    import json

    from acoss_tpu_torch.analytics.studies import ALL_STUDIES, run_coverstats

    studies = tuple(s.strip() for s in args.studies.split(",") if s.strip())
    unknown = set(studies) - set(ALL_STUDIES)
    if unknown:
        print(f"unknown studies {sorted(unknown)}; choose from "
              f"{list(ALL_STUDIES)}", file=sys.stderr)
        return 1
    pair_tags = None
    if args.tags:
        with open(args.tags) as f:
            pair_tags = json.load(f)
    elif "tag" in studies:
        print("the 'tag' study needs --tags <pair-tags.json> "
              "(`coverstats.py:199-241` consumes per-pair auto-tag "
              "dicts, which are not derivable from a FeatureSet)",
              file=sys.stderr)
        return 1
    fs = _load_featureset(args.datapath)
    summary = run_coverstats(
        fs, args.output, studies=studies, chroma_type=args.chroma_type,
        figures=not args.no_figures, pair_tags=pair_tags, verbose=True,
        device=args.device)
    print(json.dumps(summary, indent=2))
    return 0


def _mesh_shape(text: str) -> tuple[int, int]:
    """--mesh "RxC" -> (R, C), both positive."""
    try:
        r, c = (int(x) for x in text.lower().split("x"))
    except ValueError:
        r = c = 0
    if r < 1 or c < 1:
        raise argparse.ArgumentTypeError(f"expected RxC with R, C >= 1, "
                                         f"got {text!r}")
    return r, c


def _device_arg(p, what: str) -> None:
    p.add_argument("--device", default="cuda",
                   help=f"torch device of {what} (default cuda; cpu runs "
                        f"the plain PyTorch versions of the kernels)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="acoss_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("benchmark", help="run a cover-song benchmark")
    b.add_argument("-a", "--algorithm", required=True,
                   choices=sorted(_algorithms()))
    b.add_argument("-d", "--datapath", required=True,
                   help="FeatureSet .npz (as written by either package) or "
                        "a directory of per-track .h5 files")
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
    b.add_argument("--num-processes", type=int, default=1,
                   help="total processes in a multi-process sweep (the "
                        "reference's array-job sharding, Serra09.py:210)")
    b.add_argument("--process-id", type=int, default=0,
                   help="this process's shard index (0-based)")
    b.add_argument("--partial-dir", default="partials",
                   help="directory for per-process partial score files")
    b.add_argument("--merge", action="store_true",
                   help="aggregate partial files from --partial-dir and "
                        "evaluate (the reference's -b/load_batches)")
    b.add_argument("--mesh", type=_mesh_shape, default=None, metavar="RxC",
                   help="shard the pair grid over an RxC grid of devices "
                        "(R * C cards with --device cuda; a named device "
                        "such as cpu or cuda:0 fills every slot)")
    b.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of the run (CPU "
                        "and CUDA activity, the program's spans as ranges) "
                        "into LOGDIR/trace.json")
    b.add_argument("--stage-times", action="store_true",
                   help="print the program's spans (total and self "
                        "seconds, calls, parent: extract / sweep:tile / "
                        "score:tile / store:h2d / sweep:flush / eval ...) "
                        "and counters (store:h2d_copies ...)")
    _device_arg(b, "the run")
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
    _device_arg(e, "the spectral stages")
    e.set_defaults(fn=cmd_extract)

    c = sub.add_parser(
        "coverstats",
        help="run the 'what is a cover?' studies and write artifacts "
             "(the reference's coverstats/ scripts)")
    c.add_argument("-d", "--datapath", required=True,
                   help="FeatureSet .npz or a directory of track h5 files")
    c.add_argument("-o", "--output", default="coverstats_out",
                   help="artifact directory (CSVs, .npz arrays, SVG "
                        "figures, summary.json)")
    c.add_argument("--studies", default=",".join(
        ("key", "tempo", "onset", "stdev", "shapedna")),
        help="comma-separated subset of key,tempo,onset,stdev,shapedna,"
             "tag (tag needs --tags)")
    c.add_argument("-c", "--chroma_type", default="hpcp")
    c.add_argument("--tags", default=None, metavar="JSON",
                   help="label -> [tags1, tags2] JSON for the tag study "
                        "(each tags_i a list of [tag, confidence])")
    c.add_argument("--no-figures", action="store_true",
                   help="skip SVG figure emission (needed where "
                        "matplotlib is not installed)")
    _device_arg(c, "the studies' SSMs, SNF and distances")
    c.set_defaults(fn=cmd_coverstats)

    q = sub.add_parser(
        "query",
        help="serve 1xN cover-song retrieval against a prebuilt corpus "
             "index (build once, query many times)")
    q.add_argument("-a", "--algorithm", required=True,
                   choices=sorted(_algorithms()))
    q.add_argument("-d", "--datapath", required=True,
                   help="corpus FeatureSet .npz or h5 dir (ignored when "
                        "--index-dir already holds a built index)")
    q.add_argument("-q", "--querypath", required=True,
                   help="query FeatureSet .npz or h5 dir")
    q.add_argument("-c", "--chroma_type", default="hpcp")
    q.add_argument("-t", "--tile", type=int, default=None)
    q.add_argument("--index-dir", default=None,
                   help="persist/reuse the index here (skips corpus "
                        "extraction on later invocations)")
    q.add_argument("--quant", choices=("half", "int8"), default=None,
                   help="quantize the corpus descriptors kept on the "
                        "device (2x/4x smaller; dequantized a tile)")
    q.add_argument("--top", type=int, default=10)
    q.add_argument("--similarity-type", default=None,
                   help="channel to rank by (default: the algorithm's "
                        "first similarity type)")
    _device_arg(q, "the index and the queries")
    q.set_defaults(fn=cmd_query)

    args = parser.parse_args(argv)
    if args.cmd == "benchmark" and args.hybrid_panel and not args.stream_dir:
        parser.error("--hybrid-panel needs --stream-dir")
    import torch

    # TF32 flips kNN decisions: every command keeps fp32 matmuls (the
    # merge, shard, stream, query and coverstats paths do not go through
    # benchmark(), which switches it off itself)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return args.fn(args)
