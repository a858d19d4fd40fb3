"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`acoss_tpu_torch/csrc`, checks each kernel bit for bit against its plain
PyTorch version on the card at the main path's shapes, then drives the main
path -- `acoss_tpu_torch.benchmarking.harness.benchmark` with Serra09 over a
covers80-geometry synthetic corpus (160 songs, 210 tiles, 12,720 pairs) --
and checks that every kernel ran there, that retrieval is right (MAP >= 0.99
on all four channels) and that the plain versions reproduce the first
block-row of the score matrices exactly.

Each phase prints one line; any failure raises, so the script exits nonzero
and prints no result. The last lines are the card as nvidia-smi names it,
one JSON object describing the kernels, and the verdict
`{"ok": true, "device": {...}}`. It needs a CUDA device and the CUDA toolkit
(nvcc); it uses no network and starts no process that outlives it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KAPPA = 0.095
L = 512


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of `fn` over `reps` calls after
    one warm-up call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_environment() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    from acoss_tpu_torch.ops import _build

    nvcc = _run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    _phase("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"nvcc '{nvcc}' triton {triton_v} "
           f"device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> None:
    from acoss_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.library()._name
    _phase("build", f"{time.perf_counter() - t0:.2f} s -> {path}")


def _bench_crps(dev):
    """bench.py's CRP workload (B=128, L=512, lengths 320..512, density
    kappa, default_rng(0)) plus degenerate pairs: sides of 2, 3 and 4 and
    a zero length."""
    rng = np.random.default_rng(0)
    B = 128
    m = rng.integers(320, L + 1, size=B).astype(np.int32)
    n = rng.integers(320, L + 1, size=B).astype(np.int32)
    S = np.zeros((B, L, L), dtype=np.uint8)
    for b in range(B):
        S[b, :m[b], :n[b]] = rng.random((m[b], n[b])) < KAPPA
    degenerate = [(2, L), (L, 2), (3, 3), (4, 4), (0, 100), (3, 400)]
    Sd = np.zeros((len(degenerate), L, L), dtype=np.uint8)
    for b, (mm, nn) in enumerate(degenerate):
        Sd[b, :mm, :nn] = rng.random((mm, nn)) < 0.5
    S = np.concatenate([S, Sd])
    m = np.concatenate([m, [d[0] for d in degenerate]]).astype(np.int32)
    n = np.concatenate([n, [d[1] for d in degenerate]]).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (S, m, n)]


def phase_aligners(dev) -> list[dict]:
    from acoss_tpu_torch.ops import alignment_cuda

    S, m, n = _bench_crps(dev)
    out = []
    for name, line in (("qmax", 65), ("dmax", 152)):
        kern = getattr(alignment_cuda, f"{name}_batch_cuda")
        ref = getattr(alignment_cuda, f"{name}_batch_ref")
        got = kern(S, m, n)
        want = ref(S, m, n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero().flatten().tolist()
            raise AssertionError(f"{name} kernel != plain at pairs {bad}")
        if float(got[:128].min()) <= 0:
            raise AssertionError(f"{name}: implausible scores {got}")
        main = (S[:128], m[:128], n[:128])          # the main path's batch
        ms = _cuda_ms(lambda: kern(*main), 20)
        plain_ms = _cuda_ms(lambda: ref(*main), 3)
        err = float((got - want).abs().max())
        _phase(name, f"kernel == plain bit for bit on {S.shape[0]} pairs "
               f"(128 bench + 6 degenerate); B=128 L={L}: kernel "
               f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        out.append({"name": name, "route": "cuda",
                    "source": "acoss_tpu_torch/csrc/alignment.cu",
                    "replaces": f"acoss_tpu/ops/alignment_pallas.py:{line}",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "wrapper": kern})
    return out


def _corpus():
    from acoss_tpu_torch.data import make_synthetic_dataset

    # covers80 geometry (scripts/covers80_scale.py): 160 songs of ~10k to
    # ~19k frames -> ~260..470 descriptor rows, padded to 512
    return make_synthetic_dataset(n_cliques=80, clique_size=2, n_states=48,
                                  base_duration=300.0, beat_period=30.0,
                                  seed=0)


def _descriptors(dev, fs) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.convert import descriptors_from_numpy

    desc = descriptors_from_numpy(
        Serra09().extract_descriptors(fs, device=dev), dev)
    if desc["chroma"].shape[1] != L:
        raise AssertionError(f"descriptors padded to "
                             f"{desc['chroma'].shape[1]}, expected {L}")
    return desc


def phase_fused_crp(desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.ops import crp_cuda

    algo = Serra09()
    row = {k: v[8:16] for k, v in desc.items()}
    col = {k: v[0:8] for k, v in desc.items()}
    inputs = []

    def capture(X, Y, l1, l2, kappa, m):
        inputs.append((X, Y, l1.clone(), l2.clone()))
        return crp_cuda.fused_binary_crp_ref(X, Y, l1, l2, kappa, m)

    # the exact (B=64, L=512, d=12 / 13) inputs a tile hands the kernel
    algo._tile_crps_fused(row, col, capture)
    worst, times = 0, []
    for X, Y, l1, l2 in inputs:
        # pairs whose rounded k is 0 (l1e = 4, l2e = 1) and a zero length
        l1[0], l2[1], l1[2] = 12, 9, 0
        got = crp_cuda.fused_binary_crp_batch(X, Y, l1, l2, KAPPA, 9)
        want = crp_cuda.fused_binary_crp_ref(X, Y, l1, l2, KAPPA, 9)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"fused CRP kernel != plain (d={X.shape[2]}): "
                    f"{int((g != w).sum())} cells differ")
        if int(got[0][:3].sum()) != 0 or int(got[0][3:].sum()) == 0:
            raise AssertionError("fused CRP: implausible CRPs")
        worst = max(worst, int((got[0].int() - want[0].int()).abs().max()))
        ms = _cuda_ms(lambda: crp_cuda.fused_binary_crp_batch(
            X, Y, l1, l2, KAPPA, 9), 10)
        plain_ms = _cuda_ms(lambda: crp_cuda.fused_binary_crp_ref(
            X, Y, l1, l2, KAPPA, 9), 3)
        times.append((ms, plain_ms))
        _phase("fused_crp", f"kernel == plain bit for bit, B={X.shape[0]} "
               f"L={X.shape[1]} d={X.shape[2]}: kernel {ms:.3f} ms, "
               f"plain {plain_ms:.3f} ms")
    return {"name": "fused_crp", "route": "cuda",
            "source": "acoss_tpu_torch/csrc/crp.cu",
            "replaces": "acoss_tpu/ops/crp_pallas.py:57",
            "max_abs_err": float(worst),
            "ms": float(np.mean([t[0] for t in times])),
            "plain_ms": float(np.mean([t[1] for t in times])),
            "wrapper": crp_cuda.fused_binary_crp_batch}


def phase_main_path(dev, fs, desc: dict, kernels: list[dict]) -> None:
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.benchmarking.harness import benchmark

    algo = Serra09()
    n_songs = fs.n_songs
    n_tiles = -(-n_songs // algo.TILE)
    n_tiles_swept = n_tiles * (n_tiles + 1) // 2
    expect = {"qmax": n_tiles_swept, "dmax": n_tiles_swept,
              "fused_crp": 2 * n_tiles_swept}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/ledger.npz"
        for k in kernels:
            k["wrapper"].launches = 0
        times = {}
        stats = benchmark(algo, fs, checkpoint_path=ckpt, device=dev,
                          times=times)
        for k in kernels:
            k["launches"] = k["wrapper"].launches
        with np.load(ckpt) as z:
            done = z["done"]
            Ds = {k: z[f"D::{k}"] for k in algo.SIMILARITY_TYPES}
    for k in kernels:
        if k["launches"] != expect[k["name"]]:
            raise AssertionError(f"{k['name']} launched {k['launches']} "
                                 f"times, expected {expect[k['name']]}")
    if not done[np.tril_indices(n_tiles)].all():
        raise AssertionError("the ledger misses tiles")
    for k, s in stats.items():
        if not s.map >= 0.99:
            raise AssertionError(f"{k}: MAP {s.map} < 0.99")
    for k, D in Ds.items():
        low = D[np.tril_indices(n_songs, -1)]
        if D.shape != (n_songs, n_songs) or not np.isfinite(D).all() \
                or not (low > 0).mean() > 0.9:
            raise AssertionError(f"{k}: implausible score matrix")
    pairs = n_songs * (n_songs - 1) // 2
    _phase("main_path", f"benchmark(Serra09) on {dev}: {n_songs} songs, "
           f"{n_tiles_swept} tiles, {pairs} pairs; launches "
           + ", ".join(f"{k['name']} {k['launches']}" for k in kernels)
           + "; " + ", ".join(f"{k} MAP {s.map:.4f} MR {s.mr:.3f}"
                              for k, s in stats.items()))
    _phase("main_path", f"extract {times['extract']:.2f} s, sweep "
           f"{times['sweep']:.2f} s, eval {times['eval']:.2f} s; "
           f"{pairs / times['sweep']:.1f} fully-scored pairs/s")

    # the first block-row of the symmetric matrices is the first block
    # column of the swept lower triangle: tiles (ti, 0), ti = 0..n-1
    T = algo.TILE
    col = {k: v[0:T] for k, v in desc.items()}
    for ti in range(n_tiles):
        row = {k: v[ti * T:(ti + 1) * T] for k, v in desc.items()}
        plain = algo.tile_scores(row, col, plain=True)
        ii, jj = np.meshgrid(np.arange(ti * T, ti * T + T), np.arange(T),
                             indexing="ij")
        keep = (ii > jj) & (ii < n_songs)
        for k, v in plain.items():
            if not np.array_equal(v.cpu().numpy()[keep], Ds[k][ii, jj][keep]):
                raise AssertionError(f"{k}: tile ({ti}, 0) from the plain "
                                     f"versions != the kernel path")
    _phase("main_path", f"first block-row ({n_tiles} tiles) recomputed by "
           f"the plain versions on {dev}: identical scores")


def main() -> int:
    smi, kind = phase_environment()
    dev = torch.device("cuda")
    phase_build()
    kernels = phase_aligners(dev)
    t0 = time.perf_counter()
    fs = _corpus()
    _phase("corpus", f"{fs.n_songs} songs, hpcp frames "
           f"{int(fs.length('hpcp').min())}..{int(fs.length('hpcp').max())}"
           f" ({time.perf_counter() - t0:.1f} s)")
    desc = _descriptors(dev, fs)
    kernels.append(phase_fused_crp(desc))
    phase_main_path(dev, fs, desc, kernels)
    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k != "wrapper"}
        for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
