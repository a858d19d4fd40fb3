"""Serra09 at the Da-TACOS benchmark's scale (15,000 songs) on the port,
end to end: the PyTorch/CUDA counterpart of `scripts/datacos15k.py`.

The Da-TACOS benchmark subset is 1000 cliques x 13 covers + 2000
distractor singletons = 15,000 tracks, 112,492,500 symmetric pairs.

1. `extract`: render the planted-clique corpus lazily
   (`LazySyntheticCorpus`, Da-TACOS clique geometry, covers80-real song
   lengths: ~10k-20k frames) and extract Serra09 descriptors chunk by
   chunk into an int8-quantized disk `DescriptorStore`
   (`extract_streamed(quant="int8")`): host RAM stays ~one chunk.
2. `sweep`: upload the store to the device once (device-resident) and
   sweep every pair through the Serra09 tile (fused CRP, qmax, dmax), with
   the resumable tile ledger and four memmapped N x N score matrices.
   Kill it and run it again: it resumes from the ledger. The wall seconds
   of every run add up in `sweep_walls.json`.
3. `eval`: MR/MRR/MDR/MAP/Top-K per channel with the reference's ranking
   conventions, one matrix at a time; rows go to
   `<workdir>/results_datacos15k.csv`.

Every phase prints one JSON line. Usage (the workdir defaults to
`build/torch_datacos15k` under the checkout):

  python scripts/torch_datacos15k.py all
  python scripts/torch_datacos15k.py sweep        # kill + rerun to resume
  # CPU smoke: python scripts/torch_datacos15k.py all --device cpu \
  #     --cliques 8 --clique-size 3 --distractors 4 --duration 20
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _corpus(args):
    from acoss_tpu_torch.data.synthetic import LazySyntheticCorpus

    return LazySyntheticCorpus(
        n_cliques=args.cliques, clique_size=args.clique_size,
        n_distractors=args.distractors, n_states=48,
        base_duration=args.duration, beat_period=30.0, seed=args.seed)


def _algo():
    from acoss_tpu_torch.benchmarking.algorithms import Serra09

    return Serra09(chroma_type="hpcp")


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def cmd_extract(args) -> None:
    from acoss_tpu_torch.data.descstore import extract_streamed
    from acoss_tpu_torch.ops import alignment_cuda

    corpus = _corpus(args)
    print(f"corpus: {corpus.n_songs} songs ({args.cliques} x "
          f"{args.clique_size} + {args.distractors})", flush=True)
    t0 = time.perf_counter()
    # half_min_bytes below the ~20-30 KB a song of chroma / mfcc: the
    # store is int8 end to end (the 64 KB default targets heavy keys)
    desc = extract_streamed(_algo(), corpus,
                            os.path.join(args.workdir, "store"),
                            chunk_songs=args.chunk_songs, quant="int8",
                            verbose=True,
                            half_min_bytes=args.quant_min_bytes,
                            device=args.device)
    dt = time.perf_counter() - t0
    np.savez(os.path.join(args.workdir, "labels.npz"),
             labels=corpus.labels, track_ids=corpus.track_ids)
    lengths = np.asarray(desc["length"])
    L = desc["chroma"].shape[1]
    # every tile pads to the corpus width L: the fused CRP takes lines up
    # to 6,144 and qmax / dmax rows up to REGISTER_MAX_N, and raise past
    # them
    if L > min(6144, alignment_cuda.REGISTER_MAX_N):
        raise ValueError(f"descriptor width {L} is past a kernel limit")
    print(json.dumps({
        "phase": "extract", "songs": corpus.n_songs, "wall_s": dt,
        "store_bytes": int(sum(v.nbytes for v in desc.values())),
        "dtypes": {k: str(v.dtype) for k, v in sorted(desc.items())},
        "length_min": int(lengths.min()), "length_max": int(lengths.max()),
        "width": int(L), "device": _device_name(args.device)}), flush=True)


def cmd_sweep(args) -> None:
    from acoss_tpu_torch.benchmarking.harness import run_pairwise
    from acoss_tpu_torch.data.descstore import DescriptorStore

    # run_pairwise is called without benchmark(): TF32 flips kNN decisions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    desc = DescriptorStore.open(os.path.join(args.workdir, "store"))
    n = len(np.load(os.path.join(args.workdir, "labels.npz"))["labels"])
    wall_path = os.path.join(args.workdir, "sweep_walls.json")
    walls = []
    if os.path.exists(wall_path):
        with open(wall_path) as f:
            walls = json.load(f)
    walls.append(0.0)
    # a TERM (a scheduler's kill, `timeout`) unwinds through the finally
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    t0 = time.perf_counter()
    # the wall is recorded in a finally: a run killed mid-sweep (the
    # resume this script exists to exercise) still counts toward the total
    try:
        run_pairwise(_algo(), dict(desc), n, tile=args.tile,
                     scores_dir=os.path.join(args.workdir, "scores"),
                     checkpoint_path=os.path.join(args.workdir,
                                                  "ledger.npz"),
                     checkpoint_every=args.checkpoint_every,
                     device_resident=True, verbose=True,
                     device=args.device)
        if args.device.type == "cuda":
            torch.cuda.synchronize(args.device)
    finally:
        walls[-1] = time.perf_counter() - t0
        with open(wall_path, "w") as f:
            json.dump(walls, f)
    pairs = n * (n - 1) // 2
    total = sum(walls)
    print(json.dumps({
        "phase": "sweep", "songs": n, "pairs": pairs, "tile": args.tile,
        "wall_s_this_run": walls[-1], "wall_s_total": total,
        "runs": len(walls), "pairs_per_s": pairs / total,
        "device": _device_name(args.device)}), flush=True)


def cmd_eval(args) -> None:
    from acoss_tpu_torch.benchmarking.evaluation import (eval_statistics,
                                                         write_results_csv)

    labels = np.load(os.path.join(args.workdir, "labels.npz"))["labels"]
    algo = _algo()
    csv_path = os.path.join(args.workdir, "results_datacos15k.csv")
    t0 = time.perf_counter()
    for st in algo.SIMILARITY_TYPES:
        D = np.load(os.path.join(args.workdir, "scores", f"{st}.npy"),
                    mmap_mode="r")
        S = np.array(D, dtype=np.float32)     # one matrix in RAM at a time
        if st in algo.DISTANCE_TYPES:
            S = -S
        stats = eval_statistics(S, labels)
        del S
        write_results_csv(csv_path, f"{algo.NAME}_datacos15k", st, stats)
        print(json.dumps({st: {
            "MAP": stats.map, "MR": stats.mr, "MRR": stats.mrr,
            "MDR": stats.mdr, "top1": stats.tops.get(1),
            "top10": stats.tops.get(10), "n_scored": stats.n_scored}}),
            flush=True)
    print(json.dumps({"phase": "eval", "wall_s": time.perf_counter() - t0,
                      "csv": csv_path}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=("extract", "sweep", "eval", "all"))
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "build", "torch_datacos15k"))
    ap.add_argument("--cliques", type=int, default=1000)
    ap.add_argument("--clique-size", type=int, default=13)
    ap.add_argument("--distractors", type=int, default=2000)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-songs", type=int, default=256)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--checkpoint-every", type=int, default=256)
    ap.add_argument("--quant-min-bytes", type=int, default=16384)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the host")

    os.makedirs(args.workdir, exist_ok=True)
    if args.phase in ("extract", "all"):
        cmd_extract(args)
    if args.phase in ("sweep", "all"):
        cmd_sweep(args)
    if args.phase in ("eval", "all"):
        cmd_eval(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
