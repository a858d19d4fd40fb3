"""Query latency of the port's serving `CoverIndex` on the card: the
PyTorch/CUDA counterpart of `scripts/serving_latency.py`.

Two corpora:
- default: a covers80-geometry synthetic corpus (`--songs` songs of 3-8
  minutes, hop 512); the index is built with `CoverIndex.build`
  (extraction included in the build seconds) and each query extracts its
  songs (`CoverIndex.query`);
- `--store DIR`: a descriptor store written by
  `scripts/torch_datacos15k.py extract` (15,000 Da-TACOS-geometry songs,
  int8) served whole; the index is built from the store's rows as
  `CoverIndex.load` builds it, and the queries are the store's first
  songs' descriptors (`CoverIndex.query_descriptors`, no extraction).

For nq = 1 and nq = `--batch` it reports the cold latency (the first call
at that batch width; at nq = 1 in a checkout with nothing built it also
holds the kernels' first-use nvcc build) and the warm p50 / p99 over
`--reps` calls, queries a second and scored pairs a second, with the
card's name and power limit; one JSON line a measurement.

Usage:
  python scripts/torch_serving_latency.py [--songs 160] [--batch 8]
      [--quant int8] [--reps 20] [--tile T]
  python scripts/torch_datacos15k.py extract      # once, 15,000 songs
  python scripts/torch_serving_latency.py \\
      --store build/torch_datacos15k/store
  # CPU smoke: --device cpu --songs 8 --batch 2 --reps 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--songs", type=int, default=160)
    ap.add_argument("--batch", type=int, default=8,
                    help="the second query batch width (the first is 1)")
    ap.add_argument("--quant", choices=("half", "int8"), default=None,
                    help="quantize the synthetic corpus's index")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="serve this descriptor store instead of a "
                         "synthetic corpus")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the host")
    torch.backends.cuda.matmul.allow_tf32 = False

    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.data import make_synthetic_dataset
    from acoss_tpu_torch.data.descstore import DescriptorStore
    from acoss_tpu_torch.serving import CoverIndex

    card = _card(device)
    algo = Serra09(chroma_type="hpcp")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    nq_max = max(1, args.batch)
    t0 = time.perf_counter()
    if args.store:
        store = DescriptorStore.open(args.store)
        n = int(store["length"].shape[0])
        index = CoverIndex(algo, store, n, tile=args.tile, device=device)
        qdesc = {k: np.array(v[:nq_max]) for k, v in store.items()}

        def query(m: int) -> dict:
            return index.query_descriptors(
                {k: v[:m] for k, v in qdesc.items()}, m)
        corpus = f"store {args.store}"
    else:
        fs = make_synthetic_dataset(
            n_cliques=(args.songs + nq_max + 1) // 2, clique_size=2,
            n_states=48, base_duration=300.0, beat_period=30.0, seed=0)
        qfs = fs.subset(np.arange(nq_max))
        cfs = fs.subset(np.arange(nq_max, nq_max + args.songs))
        index = CoverIndex.build(algo, cfs, quant=args.quant,
                                 tile=args.tile, device=device)
        n = cfs.n_songs

        def query(m: int) -> dict:
            return index.query(qfs.subset(np.arange(m)))
        corpus = f"synthetic covers80 geometry, quant={args.quant}"
    _sync(device)
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "corpus": corpus, "songs": n,
                      "tiles": index.n_tiles, "tile": index.tile,
                      "seconds": build_s, "card": card}), flush=True)
    for m in sorted({1, nq_max}):
        t0 = time.perf_counter()
        query(m)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            query(m)
            warm.append(time.perf_counter() - t0)
        p50 = float(np.percentile(warm, 50))
        print(json.dumps({
            "phase": "query", "nq": m, "cold_ms": 1e3 * cold,
            "p50_ms": 1e3 * p50,
            "p99_ms": 1e3 * float(np.percentile(warm, 99)),
            "reps": args.reps, "queries_per_s": m / p50,
            "pairs_per_s": m * n / p50,
            "extraction_in_query": not args.store, "card": card}),
            flush=True)
    if device.type == "cuda":
        print(json.dumps({"phase": "memory", "peak_gib":
                          torch.cuda.max_memory_allocated(device) / 2 ** 30,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
