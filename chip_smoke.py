"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`acoss_tpu_torch/csrc`, checks each kernel against its plain PyTorch
version on the card at the main paths' shapes (bit for bit, and the fused
WCSMSSM build within rtol 2e-5 / atol 2e-6), then drives the paths over a
covers80-geometry synthetic corpus (160 songs, 210 tiles, 12,720 pairs):

- `benchmark(Serra09())`, the Serra09 main path (fused CRP, qmax, dmax);
- `benchmark(EarlySNF())`, the SNF slice in parity mode (matrix
  binarizer, kNN row mask, qmax, dmax);
- `run_pairwise(EarlySNF(snf_precision="default"))`, the throughput mode
  (adds the fused WCSMSSM kernel), on the descriptors EarlySNF extracted;
- `run_pairwise(Serra09(do_ssms=True))`, Serra09 with its ssms channel
  (fused CRP, binarizer, qmax, dmax), on the same descriptors.

Every path runs with the launch counts set to 0 and checks them against
the counts its design implies, checks retrieval (MAP), and the two
`benchmark` paths recompute their first block-row with every kernel
replaced by its plain version: the scores must be identical.

Each phase prints one line or a few; any failure raises, so the script
exits nonzero and prints no result. The last lines are the card as
nvidia-smi names it, one JSON object describing the kernels, and the
verdict `{"ok": true, "device": {...}}`. It needs a CUDA device and the
CUDA toolkit (nvcc); it uses no network and starts no process that
outlives it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KAPPA = 0.095
L = 512
# the JAX package's own record of this corpus (ssms_scatter qmax / dmax
# MAP, seed 0): a tempo-warp sensitivity of the synthetic corpus
JAX_SSMS_MAP = {"ssms_scatter_qmax": 0.4803, "ssms_scatter_dmax": 0.4339}


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


def _wrappers() -> dict:
    """Every kernel wrapper by its name in the kernels line."""
    from acoss_tpu_torch.ops import alignment_cuda, crp_cuda

    return {"qmax": alignment_cuda.qmax_batch_cuda,
            "dmax": alignment_cuda.dmax_batch_cuda,
            "fused_crp": crp_cuda.fused_binary_crp_batch,
            "binarize": crp_cuda.binarize_matrix_batch,
            "knn_mask": crp_cuda.knn_mask_matrix_batch,
            "wcsmssm": crp_cuda.wcsmssm_batch}


def _counted(path: str, run, expect: dict):
    """Run one path with every launch count set to 0; the counts after it
    must be `expect` (0 for a kernel it does not name)."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    got = {k: w.launches for k, w in wrappers.items()}
    want = {k: expect.get(k, 0) for k in wrappers}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")
    return out, {k: v for k, v in got.items() if v}


@contextlib.contextmanager
def _spy(module, name: str, calls: list):
    """Record the arguments of every call of module.<name> (the call
    still goes through)."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    # a wrapper counts its launches through its module-level name, which
    # is the spy while it is in place
    spy.launches = 0
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _kernel(name: str, source: str, replaces: str, err: float, ms: float,
            plain_ms: float) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"acoss_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": float(err), "ms": float(ms),
            "plain_ms": float(plain_ms)}


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
    # the paths driven through run_pairwise directly must not depend on
    # benchmark() having switched TF32 off
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
        out.append(_kernel(name, "alignment.cu",
                           f"acoss_tpu/ops/alignment_pallas.py:{line}", err,
                           ms, plain_ms))
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
    return _kernel("fused_crp", "crp.cu", "acoss_tpu/ops/crp_pallas.py:57",
                   worst, np.mean([t[0] for t in times]),
                   np.mean([t[1] for t in times]))


def _first_block_row(algo, desc: dict, Ds: dict, n_songs: int) -> int:
    """Recompute the first block-row of the symmetric matrices -- the
    first block column of the swept lower triangle, tiles (ti, 0) -- with
    every kernel replaced by its plain version; the scores must be the
    swept ones exactly. Returns the number of tiles."""
    T = algo.TILE
    n_tiles = -(-n_songs // T)
    col = {k: v[0:T] for k, v in desc.items()}
    for ti in range(n_tiles):
        row = {k: v[ti * T:(ti + 1) * T] for k, v in desc.items()}
        plain = algo.tile_scores(row, col, plain=True)
        ii, jj = np.meshgrid(np.arange(ti * T, ti * T + T), np.arange(T),
                             indexing="ij")
        keep = (ii > jj) & (ii < n_songs)
        for k, v in plain.items():
            if not np.array_equal(v.cpu().numpy()[keep], Ds[k][ii, jj][keep]):
                raise AssertionError(f"{algo.NAME} {k}: tile ({ti}, 0) from "
                                     f"the plain versions != the kernel path")
    return n_tiles


def _benchmark_path(name: str, algo, dev, fs, expect: dict):
    """`benchmark(algo)` with counted launches; returns its stats, the
    swept (lower-triangle) score matrices from its ledger, the stage
    times and the launch counts."""
    from acoss_tpu_torch.benchmarking.harness import benchmark

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/ledger.npz"
        stats, counts = _counted(name, lambda: benchmark(
            algo, fs, checkpoint_path=ckpt, device=dev, times=times),
            expect)
        with np.load(ckpt) as z:
            done = z["done"]
            Ds = {k: z[f"D::{k}"] for k in algo.SIMILARITY_TYPES}
    n_tiles = -(-fs.n_songs // algo.TILE)
    if not done[np.tril_indices(n_tiles)].all():
        raise AssertionError(f"{name}: the ledger misses tiles")
    for k, D in Ds.items():
        low = D[np.tril_indices(fs.n_songs, -1)]
        if D.shape != (fs.n_songs,) * 2 or not np.isfinite(D).all() \
                or not (low > 0).mean() > 0.9:
            raise AssertionError(f"{name} {k}: implausible score matrix")
    return stats, Ds, times, counts


def _check_map(name: str, stats: dict, floors: dict) -> None:
    for k, s in stats.items():
        floor = next(v for c, v in floors.items() if k.startswith(c))
        if not s.map >= floor:
            raise AssertionError(f"{name} {k}: MAP {s.map} < {floor}")


def _swept_tiles(n_songs: int, tile: int) -> int:
    n_tiles = -(-n_songs // tile)
    return n_tiles * (n_tiles + 1) // 2


def phase_main_path(dev, fs, desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import Serra09

    algo = Serra09()
    T = _swept_tiles(fs.n_songs, algo.TILE)
    stats, Ds, times, counts = _benchmark_path(
        "main_path", algo, dev, fs,
        {"qmax": T, "dmax": T, "fused_crp": 2 * T})
    _check_map("main_path", stats, {"": 0.99})
    pairs = fs.n_songs * (fs.n_songs - 1) // 2
    _phase("main_path", f"benchmark(Serra09) on {dev}: {fs.n_songs} songs, "
           f"{T} tiles, {pairs} pairs; launches "
           + ", ".join(f"{k} {v}" for k, v in counts.items())
           + "; " + ", ".join(f"{k} MAP {s.map:.4f} MR {s.mr:.3f}"
                              for k, s in stats.items()))
    _phase("main_path", f"extract {times['extract']:.2f} s, sweep "
           f"{times['sweep']:.2f} s, eval {times['eval']:.2f} s; "
           f"{pairs / times['sweep']:.1f} fully-scored pairs/s")
    n = _first_block_row(algo, desc, Ds, fs.n_songs)
    _phase("main_path", f"first block-row ({n} tiles) recomputed by the "
           f"plain versions on {dev}: identical scores")
    return counts


def phase_early_snf(dev, fs) -> tuple[dict, dict]:
    """benchmark(EarlySNF()) in parity mode; returns the descriptors it
    extracted (on the card) and its launch counts."""
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF
    from acoss_tpu_torch.convert import descriptors_from_numpy

    class KeepDescriptors(EarlySNF):
        def extract_descriptors(self, fs, device="cuda"):
            self.desc = super().extract_descriptors(fs, device=device)
            return self.desc

    algo = KeepDescriptors()
    T = _swept_tiles(fs.n_songs, algo.TILE)
    torch.cuda.reset_peak_memory_stats()
    stats, Ds, times, counts = _benchmark_path(
        "early_snf", algo, dev, fs,
        {"binarize": T, "knn_mask": T, "qmax": T, "dmax": T})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_map("early_snf", stats, {"ssms": 0.40, "": 0.99})
    pairs = fs.n_songs * (fs.n_songs - 1) // 2
    desc = descriptors_from_numpy(algo.desc, dev)
    _phase("early_snf", f"benchmark(EarlySNF) on {dev}: {fs.n_songs} songs,"
           f" {T} tiles, {pairs} pairs, ssms corpus "
           f"{tuple(desc['ssms'].shape)}; launches "
           + ", ".join(f"{k} {v}" for k, v in counts.items()))
    _phase("early_snf", ", ".join(
        f"{k} MAP {s.map:.4f}" + (f" (JAX record {JAX_SSMS_MAP[k]})"
                                  if k in JAX_SSMS_MAP else "")
        for k, s in stats.items()))
    _phase("early_snf", f"extract {times['extract']:.2f} s, sweep "
           f"{times['sweep']:.2f} s, eval {times['eval']:.2f} s; "
           f"{pairs / times['sweep']:.1f} fully-scored pairs/s; peak device "
           f"memory {peak:.2f} GiB")
    n = _first_block_row(algo, desc, Ds, fs.n_songs)
    _phase("early_snf", f"first block-row ({n} tiles) recomputed by the "
           f"plain versions on {dev}: identical scores")
    return desc, counts


def _tile(desc: dict):
    return ({k: v[8:16] for k, v in desc.items()},
            {k: v[0:8] for k, v in desc.items()})


def phase_binarize(desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import early_snf
    from acoss_tpu_torch.ops import crp_cuda

    calls = []
    with _spy(early_snf, "binarize_matrix_batch", calls):
        early_snf.EarlySNF().tile_scores(*_tile(desc))
    (D, l1, l2, kappa), _ = calls[0]
    if D.shape != (256, L, L) or kappa != KAPPA:
        raise AssertionError(f"binarize: captured {tuple(D.shape)}")
    # degenerate cases: a matrix of -0.0 with +0.0 and ties, negative ties,
    # a pair whose rounded column k is 0 (5 rows), a zero length
    g = torch.Generator(device=D.device).manual_seed(0)
    ex = -torch.rand((4, L, L), generator=g, device=D.device)
    ex[0] = -0.0
    ex[0, :, ::3] = 0.0
    ex[0, ::7] = -0.5
    ex[1] = torch.round(ex[1] * 4) / 4
    ln = torch.tensor([[L, L], [400, 300], [5, L], [0, L]], dtype=torch.int32,
                      device=D.device)
    Dx = torch.cat([D, ex])
    l1x = torch.cat([l1, ln[:, 0]])
    l2x = torch.cat([l2, ln[:, 1]])
    got = crp_cuda.binarize_matrix_batch(Dx, l1x, l2x, KAPPA)
    want = crp_cuda.binarize_matrix_ref(Dx, l1x, l2x, KAPPA)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"binarize kernel != plain: "
                             f"{int((got != want).sum())} cells differ")
    if int(got[:256].sum()) == 0 or int(got[258:].sum()) != 0:
        raise AssertionError("binarize: implausible CRPs")
    ms = _cuda_ms(lambda: crp_cuda.binarize_matrix_batch(D, l1, l2, KAPPA),
                  10)
    plain_ms = _cuda_ms(lambda: crp_cuda.binarize_matrix_ref(D, l1, l2,
                                                             KAPPA), 3)
    _phase("binarize", f"kernel == plain bit for bit on the EarlySNF tile's "
           f"(256, {L}, {L}) stack + 4 degenerate; kernel {ms:.3f} ms, "
           f"plain {plain_ms:.3f} ms")
    return _kernel("binarize", "knn.cu", "acoss_tpu/ops/crp_pallas.py:276",
                   (got.int() - want.int()).abs().max(), ms, plain_ms)


def phase_knn_mask(desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF
    from acoss_tpu_torch.ops import crp_cuda

    calls = []
    with _spy(crp_cuda, "knn_mask_matrix_batch", calls):
        EarlySNF().tile_scores(*_tile(desc))
    (W, k), kw = calls[0]
    n = W.shape[-1]
    if W.shape != (128, 2 * L, 2 * L) or not kw.get("largest", True):
        raise AssertionError(f"knn_mask: captured {tuple(W.shape)} {kw}")
    # k = 1, k = n, and two matrices with rows of ties
    kx = torch.cat([k, k[2:4]]).clone()
    kx[0], kx[1] = 1, n
    Wx = torch.cat([W, torch.round(W[2:4] * 64) / 64])
    got = crp_cuda.knn_mask_matrix_batch(Wx, kx)
    want = crp_cuda.knn_mask_matrix_ref(Wx, kx)
    torch.cuda.synchronize()
    if not (torch.equal(got, want)
            and torch.equal(torch.signbit(got), torch.signbit(want))):
        raise AssertionError(f"knn_mask kernel != plain: "
                             f"{int((got != want).sum())} cells differ")
    ms = _cuda_ms(lambda: crp_cuda.knn_mask_matrix_batch(W, k), 10)
    plain_ms = _cuda_ms(lambda: crp_cuda.knn_mask_matrix_ref(W, k), 3)
    _phase("knn_mask", f"kernel == plain bit for bit on the EarlySNF tile's "
           f"({W.shape[0]}, {n}, {n}) W stack + k=1, k=n and 2 tie "
           f"matrices; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return _kernel("knn_mask", "knn.cu", "acoss_tpu/ops/crp_pallas.py:431",
                   (got - want).abs().max(), ms, plain_ms)


def phase_wcsmssm(desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF
    from acoss_tpu_torch.ops import crp_cuda

    calls = []
    with _spy(crp_cuda, "wcsmssm_batch", calls):
        EarlySNF(snf_precision="default").tile_scores(*_tile(desc))
    if len(calls) != 2:
        raise AssertionError(f"wcsmssm: {len(calls)} calls a tile")
    worst_abs, worst_rel, times = 0.0, 0.0, []
    for (A, Bm, C, l1, l2, K), kw in calls:
        if A.shape != (64, L, L):
            raise AssertionError(f"wcsmssm: captured {tuple(A.shape)}")
        K = K.clone()
        K[0], K[1] = 1, 0                          # tiny neighbour budgets
        args = (A, Bm, C, l1, l2, K)
        got = crp_cuda.wcsmssm_batch(*args, **kw)
        want = crp_cuda.wcsmssm_ref(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
        diff = (got - want).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        big = want.abs() > 2e-6
        worst_rel = max(worst_rel, float((diff[big] / want.abs()[big]).max()))
        times.append((_cuda_ms(lambda: crp_cuda.wcsmssm_batch(*args, **kw),
                               10),
                      _cuda_ms(lambda: crp_cuda.wcsmssm_ref(*args, **kw), 3)))
    ms = float(np.mean([t[0] for t in times]))
    plain_ms = float(np.mean([t[1] for t in times]))
    _phase("wcsmssm", f"kernel within rtol 2e-5 / atol 2e-6 of plain on the "
           f"throughput tile's 2 x (64, {L}, {L}) stacks (K=1 and K=0 "
           f"included): max abs err {worst_abs:.3g}, max rel err "
           f"{worst_rel:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return _kernel("wcsmssm", "knn.cu", "acoss_tpu/ops/crp_pallas.py:598",
                   worst_abs, ms, plain_ms)


def _sweep_path(name: str, algo, dev, fs, desc: dict, expect: dict,
                floors: dict) -> dict:
    """`run_pairwise(algo)` on already extracted descriptors, counted, timed
    and checked for retrieval."""
    from acoss_tpu_torch.benchmarking.evaluation import eval_statistics
    from acoss_tpu_torch.benchmarking.harness import run_pairwise

    t0 = time.perf_counter()
    Ds, counts = _counted(name, lambda: run_pairwise(
        algo, desc, fs.n_songs, device=dev), expect)
    sweep = time.perf_counter() - t0
    stats = {k: eval_statistics(D, fs.labels) for k, D in Ds.items()}
    _check_map(name, stats, floors)
    pairs = fs.n_songs * (fs.n_songs - 1) // 2
    _phase(name, f"run_pairwise({algo.NAME}) on {dev}: launches "
           + ", ".join(f"{k} {v}" for k, v in counts.items()) + "; "
           + ", ".join(f"{k} MAP {s.map:.4f}" for k, s in stats.items()))
    _phase(name, f"sweep {sweep:.2f} s, {pairs / sweep:.1f} fully-scored "
           f"pairs/s")
    return counts


def phase_early_snf_fast(dev, fs, desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF

    algo = EarlySNF(snf_precision="default")
    T = _swept_tiles(fs.n_songs, algo.TILE)
    return _sweep_path(
        "early_snf_fast", algo, dev, fs, desc,
        {"binarize": T, "knn_mask": T, "wcsmssm": 2 * T, "qmax": T,
         "dmax": T}, {"ssms": 0.0, "": 0.99})


def phase_serra09_full(dev, fs, desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import Serra09

    algo = Serra09(do_ssms=True)
    T = _swept_tiles(fs.n_songs, algo.TILE)
    return _sweep_path(
        "serra09_full", algo, dev, fs, desc,
        {"fused_crp": 2 * T, "binarize": T, "qmax": T, "dmax": T},
        {"ssms": 0.40, "": 0.99})


def main() -> int:
    smi, kind = phase_environment()
    dev = torch.device("cuda")
    phase_build()
    kernels = {k["name"]: k for k in phase_aligners(dev)}
    t0 = time.perf_counter()
    fs = _corpus()
    _phase("corpus", f"{fs.n_songs} songs, hpcp frames "
           f"{int(fs.length('hpcp').min())}..{int(fs.length('hpcp').max())}"
           f" ({time.perf_counter() - t0:.1f} s)")
    desc = _descriptors(dev, fs)
    kernels["fused_crp"] = phase_fused_crp(desc)
    launches = {"main_path": phase_main_path(dev, fs, desc)}
    del desc
    snf_desc, launches["early_snf"] = phase_early_snf(dev, fs)
    for phase in (phase_binarize, phase_knn_mask, phase_wcsmssm):
        k = phase(snf_desc)
        kernels[k["name"]] = k
    launches["early_snf_fast"] = phase_early_snf_fast(dev, fs, snf_desc)
    launches["serra09_full"] = phase_serra09_full(dev, fs, snf_desc)
    # each kernel's launches are read from the path it was ported for
    for path, names in (("main_path", ("qmax", "dmax", "fused_crp")),
                        ("early_snf", ("binarize", "knn_mask")),
                        ("early_snf_fast", ("wcsmssm",))):
        for name in names:
            kernels[name]["launches"] = launches[path][name]
            kernels[name]["path"] = path
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
