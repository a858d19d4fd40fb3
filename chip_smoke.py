"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`acoss_tpu_torch/csrc`, checks each kernel against its plain PyTorch
version on the card at the main paths' shapes (bit for bit, and the fused
WCSMSSM build within rtol 2e-5 / atol 2e-6, with the split of its two
launches; the fused CRP also on a tie-heavy batch and on odd lengths),
checks the four aligner
kernels bit for bit against the port's native C++ aligners (`native.py`),
then drives the paths over a covers80-geometry synthetic corpus (160
songs, 210 tiles, 12,720 pairs):

- `benchmark(Serra09())`, the Serra09 main path (fused CRP, qmax, dmax);
- `serra_cover_similarity_measures(dis_onset=0.3, dis_extension=0.8)`
  of the legacy similarity API on percentile CRPs of song pairs (the
  unequal-gap qmax kernel);
- `benchmark(EarlySNF())`, the SNF slice in parity mode (matrix
  binarizer, kNN row mask, qmax, dmax);
- `run_pairwise(EarlySNF(snf_precision="default"))`, the throughput mode
  (adds the fused WCSMSSM kernel), on the descriptors EarlySNF extracted;
- `run_pairwise(Serra09(do_ssms=True))`, Serra09 with its ssms channel
  (fused CRP, binarizer, qmax, dmax), on the same descriptors;
- `benchmark(EarlyFusion())`, constrained Smith-Waterman and late fusion
  (the SW kernel; the kNN row mask in the late SNF);
- `benchmark(FTM2D())` and its zeropad ablation, and
  `benchmark(ANFScattering())`: one fp32 Gram a channel (`full_scores`),
  no kernel; the N x N matrices, MAP, and `full_scores` timed alone;
- `benchmark(Simple())`, the asymmetric sweep: all 400 tiles of the
  20 x 20 grid, no kernel;
- `benchmark(ChenFusion())` and `benchmark(TGAlg())`: non-mutual row-kNN
  CRPs (a row sort), then qmax and dmax (one launch each a tile), and
  ChenFusion's late SNF (the kNN row mask, its (2, 160, 160) output held
  bit for bit against the plain version); the first block-row recomputed
  by the plain versions; one tile's wall and device time split into the
  sort, qmax, dmax and the rest;
- `benchmark()` of StrucFTM2D, StrucShingles, StrucScattering and
  StrucLaplacian at their defaults (PAD_LEN 2000, a 512^2 scattering,
  50 k-means restarts): the fused W of each chunk of 16 songs (one
  kNN-mask launch, every output held bit for bit against the plain
  version, as many launches as the npad buckets imply), the extraction
  split into host prep, fused W and the chunk stage, peak memory, MAP
  against the JAX package's records; the two shingle families' union
  Gram forced onto the card against the float64 SpGEMM (rtol 1e-5);
  StrucLaplacian's qmax and dmax a tile (210 each), its first block-row
  recomputed by the plain versions, a tile's split, one chunk's
  eigenvector, k-means and SVD stages timed, and a second `benchmark()`
  whose score matrices and MAP must equal the first's;
- an fp32 `CoverIndex.build` (`serving_fp32`): the last 16 songs as
  queries, their rows == the main path's swept scores bit for bit;
- `shards`: four `python -m acoss_tpu_torch benchmark --num-processes 4
  --process-id i` processes at once and the CLI's `--merge`, == the
  unsharded sweep bit for bit with its MAP; the four shards run in this
  process launch what the unsharded sweep launches; the same from a
  `--stream-dir --stream-int8 --hybrid-panel 64` store (process 0 builds
  it) against the unsharded hybrid sweep; a missing shard and a 1-based
  id return 1; one `--stage-times --profile` run;
- `coverstats`: the CLI's five default studies and `tag`, no figures; one
  kNN-mask launch a song in the shape-DNA study, its first three == plain
  bit for bit, 8 songs' eigenvalues within 1e-4 of the plain path's;
- `mesh`: the device-mesh sweeps over four slots of card 0:
  `sharded_pair_scores` on a 2 x 2 grid (strict lower triangle == the
  main path's matrices bit for bit) and `sharded_pair_scores_triangular`
  over 4 slots (whole matrix == the main path's), and with four or more
  cards visible the same fold over cards 0-3, each launching the fused
  CRP, qmax and dmax as often as its tile calls imply; `benchmark --mesh
  2x2 --device cuda:0` for Serra09 (the fold; MAP rows == the main
  path's) and Simple (the rectangular branch; matrix == the simple
  phase's); then
  `dryrun_multichip(4, device="cuda:0")`; pairs/s beside the main path's;

then Serra09 at Da-TACOS song geometry through the sweep engines
(`datacos_geometry`: 600 songs of a `LazySyntheticCorpus`, 40 cliques x
13 + 80 distractors, extracted into an int8 disk store; the plain in-RAM
sweep of the dequantized store, the bucketed sweep streamed from
per-bucket int8 stores into memmapped scores, killed half way and resumed
from its ledger, and the hybrid 128-song-panel sweep; all bit-equal to
their plain references, with the device's idle share on the bucketed
sweep); the query path at that geometry (`serving`: 2,016 songs, 150
cliques x 13 + 66 distractors, in one int8 store; P_0 of cliques 0-15
held out as 16 queries against a `CoverIndex` of the other 2,000, saved
and loaded back; the query rows == the sweep's last two block-rows bit for
bit, every query's top 10 in its clique, qmax / dmax / fused CRP launched
once / once / twice a corpus tile; cold and warm latency at nq = 1 and 8);
and last the extraction layer from audio (`extract`: 16
placeholder WAVs from `scripts/torch_covers80_placeholder.py` through
`batch_extract` with the default profile, all 16 extracted with one
launch a song of the chord HMM's forward-backward kernel, `hmm_fb`, held
to its plain version and to the plain model of its chunked algorithm on
the path's emissions, two calls bit-equal; seconds a stage a song, one
300 s song, peak memory, and hmm_fb checked and timed again on that
song's own emissions (about 25,800 frames); then `benchmark(Serra09)` on the extracted
features, its chroma MAP against the JAX package's CPU record on the
same WAVs less 0.02).

Every path runs with the launch counts set to 0 and checks them against
the counts its design implies, checks retrieval (MAP), and the
`benchmark` paths with kernels recompute their first block-row with
every kernel replaced by its plain version: the scores must be
identical.

Each phase prints one line or a few; any failure raises, so the script
exits nonzero and prints no result. The last lines are the card as
nvidia-smi names it, one JSON object describing the kernels (each with
its time, its plain version's, the least time the card could take for
the same work and what bounds that), and the verdict
`{"ok": true, "device": {...}}`. It needs a CUDA device, the CUDA toolkit
(nvcc) and g++; it uses no network and starts no process that outlives
it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KAPPA = 0.095
L = 512
# the H100 SXM's peaks, for the least time a kernel's work could take: its
# published HBM bytes/s, and the fp32 instructions it issues a second
# (132 SMs x 128 lanes x 1.98 GHz). The published 67 TFLOP/s counts an FMA
# as two operations; the kernels' counted operations are adds,
# subtractions, multiplies, compares and maxes, one instruction each.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
# fp32 operations a cell of each aligner's recurrence needs (adds,
# subtractions and maxes, the running max included)
ALIGNER_OPS = {"qmax": 5, "dmax": 13, "qmax_uneq": 8, "sw": 11}
# the legacy surface's unequal gaps, both ways round
UNEQ_GAPS = ((0.3, 0.8), (0.8, 0.3))
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


def _kernel_split(fn) -> str:
    """The device ms of each kernel launched by one call of `fn`, by
    torch.profiler: "name ms + name ms"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " + ".join(
        f"{e.key.split('<')[0].split('::')[-1].split('(')[0]} "
        f"{e.self_device_time_total / 1e3:.4f} ms"
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def _wrappers() -> dict:
    """Every kernel wrapper by its name in the kernels line."""
    from acoss_tpu_torch.ops import alignment_cuda, crp_cuda, hmm_cuda

    return {"qmax": alignment_cuda.qmax_batch_cuda,
            "dmax": alignment_cuda.dmax_batch_cuda,
            "qmax_uneq": alignment_cuda.qmax_uneq_batch_cuda,
            "sw": alignment_cuda.swconstrained_batch_cuda,
            "fused_crp": crp_cuda.fused_binary_crp_batch,
            "binarize": crp_cuda.binarize_matrix_batch,
            "knn_mask": crp_cuda.knn_mask_matrix_batch,
            "wcsmssm": crp_cuda.wcsmssm_batch,
            "hmm_fb": hmm_cuda.chord_forward_backward}


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
def _spy(module, name: str, calls: list, outs: list | None = None):
    """Record the arguments of every call of module.<name> (the call
    still goes through), and its result in `outs` if given."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        out = real(*args, **kwargs)
        if outs is not None:
            outs.append(out)
        return out

    # a wrapper counts its launches through its module-level name, which
    # is the spy while it is in place
    spy.launches = 0
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least milliseconds the card could take to move `nbytes` and do
    `ops` fp32 operations (one instruction each), and which of the two
    bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_INSTR_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _cells(l1, l2, L: int) -> float:
    """Valid cells of (B,) length pairs clamped to [0, L]."""
    return float((l1.clamp(0, L).double() * l2.clamp(0, L).double()).sum())


def _aligner_bound(name: str, S, m, n) -> tuple[float, str]:
    """An aligner reads each pair's valid CRP window once and its two
    lengths, writes one score, and does ALIGNER_OPS[name] operations a
    valid cell."""
    cells = _cells(m, n, S.shape[-1])
    return _bound(cells + 12 * S.shape[0], ALIGNER_OPS[name] * cells)


def _kernel(name: str, source: str, replaces: str, err: float, ms: float,
            plain_ms: float, bound: tuple[float, str],
            library_ms: float | None = None) -> dict:
    """One entry of the kernels line. `library_ms` stays None: no single
    PyTorch call computes any of these functions (PERF.md, section 6)."""
    return {"name": name, "route": "cuda",
            "source": f"acoss_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": float(err), "ms": float(ms),
            "plain_ms": float(plain_ms), "bound_ms": float(bound[0]),
            "bound_by": bound[1], "library_ms": library_ms}


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
    degenerate = [(2, L), (L, 2), (3, 3), (4, 4), (0, 100), (3, 400),
                  (L, L)]
    Sd = np.zeros((len(degenerate), L, L), dtype=np.uint8)
    for b, (mm, nn) in enumerate(degenerate):
        Sd[b, :mm, :nn] = rng.random((mm, nn)) < 0.5
    Sd[-1, :2] = 1          # rows 0 and 1 all matches (gap penalties)
    S = np.concatenate([S, Sd])
    m = np.concatenate([m, [d[0] for d in degenerate]]).astype(np.int32)
    n = np.concatenate([n, [d[1] for d in degenerate]]).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (S, m, n)]


def _native_fn(name: str):
    """The port's native C++ (single-core) batched aligner of a kernel."""
    from acoss_tpu_torch import native

    return getattr(native, {"sw": "swconstrained"}.get(
        name, name.split("_")[0]) + "_batch_cpu")


def _check_native(name: str, got, S, m, n, idx=None, **kw) -> int:
    """The kernel's scores on the pairs `idx` (by default the first 16
    bench pairs and the degenerate ones) must equal the port's native C++
    aligner's bit for bit (a composition independent of the plain scans).
    Returns the pairs."""
    if idx is None:
        idx = list(range(16)) + list(range(128, S.shape[0]))
    want = _native_fn(name)(*(t[idx].cpu().numpy() for t in (S, m, n)),
                            **kw)
    if not np.array_equal(got[idx].cpu().numpy(), want):
        raise AssertionError(f"{name} {kw}: kernel != native C++")
    return len(idx)


# unequal-gap qmax and SW: (name, wrapper stem, keyword arguments)
PRED3_CASES = [("qmax_uneq", "qmax_uneq",
                {"gap_onset": go, "gap_extension": ge})
               for go, ge in UNEQ_GAPS] + [("sw", "swconstrained", {})]


def phase_long_rows(dev) -> None:
    """Unequal-gap qmax and SW on rows past the 4-column runs (N = 2,304
    and 2,101: 8 columns a thread, aligned and not) and past the register
    kernel's range (N = 16,400: the shared-memory kernel), each bit for
    bit equal to its plain version and to native C++, with a side of 2
    and rows 0 and 1 of a pair all matches."""
    from acoss_tpu_torch.ops import alignment_cuda

    rng = np.random.default_rng(2)
    shapes = ((6, 160, 2304), (6, 160, 2101), (2, 40, 16400))
    if not alignment_cuda.REGISTER_MAX_N < shapes[-1][2] \
            <= alignment_cuda.SMEM_MAX_N:
        raise AssertionError("long_rows: N misses the shared-memory range")
    for B, M, N in shapes:
        m = rng.integers(M * 5 // 8, M + 1, B).astype(np.int32)
        n = rng.integers(N * 5 // 8, N + 1, B).astype(np.int32)
        m[:2], n[:2] = [M, 2], [N, N]
        S = (rng.random((B, M, N)) < KAPPA).astype(np.uint8)
        S[0, :2] = 1
        S, m, n = (torch.from_numpy(a).to(dev) for a in (S, m, n))
        for name, fn, kw in PRED3_CASES:
            got = getattr(alignment_cuda, f"{fn}_batch_cuda")(S, m, n, **kw)
            want = getattr(alignment_cuda, f"{fn}_batch_ref")(S, m, n, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {kw} N={N}: kernel != plain")
            if float(got[0]) <= 0 or float(got[1]) != 0:
                raise AssertionError(f"{name} N={N}: implausible {got}")
            _check_native(name, got, S, m, n, idx=list(range(B)), **kw)
    _phase("long_rows", "qmax_uneq (both gap orders) and sw: kernel == "
           "plain == native C++ bit for bit on rows of "
           + ", ".join(f"{N} ({B} x {M})" for B, M, N in shapes)
           + " (the last past REGISTER_MAX_N: the shared-memory kernels)")


def phase_aligners(dev) -> list[dict]:
    """qmax, dmax, unequal-gap qmax and SW on the bench CRPs: each bit for
    bit equal to its plain version and to the native C++ aligners; qmax,
    dmax and qmax_uneq timed on the bench batch (SW is timed on the
    EarlyFusion tile's stack, `phase_sw`)."""
    from acoss_tpu_torch.ops import alignment_cuda

    S, m, n = _bench_crps(dev)
    main = (S[:128], m[:128], n[:128])              # the main path's batch
    cases = [("qmax", "qmax", 65, {}), ("dmax", "dmax", 152, {})]
    cases += [("qmax_uneq", "qmax_uneq", 101,
               {"gap_onset": go, "gap_extension": ge})
              for go, ge in UNEQ_GAPS]
    cases += [("sw", "swconstrained", 196, {})]
    out = []
    for name, fn, line, kw in cases:
        kern = getattr(alignment_cuda, f"{fn}_batch_cuda")
        ref = getattr(alignment_cuda, f"{fn}_batch_ref")
        got = kern(S, m, n, **kw)
        want = ref(S, m, n, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero().flatten().tolist()
            raise AssertionError(f"{name} {kw}: kernel != plain at pairs "
                                 f"{bad}")
        if float(got[:128].min()) <= 0 or float(got[-1]) <= 0:
            raise AssertionError(f"{name}: implausible scores {got}")
        n_native = _check_native(name, got, S, m, n, **kw)
        msg = (f"kernel == plain bit for bit on {S.shape[0]} pairs (128 "
               f"bench + {S.shape[0] - 128} degenerate), == native C++ on "
               f"{n_native}")
        if name == "sw" or any(k["name"] == name for k in out):
            _phase(name, f"{msg} {kw}")
            continue
        ms = _cuda_ms(lambda: kern(*main, **kw), 20)
        plain_ms = _cuda_ms(lambda: ref(*main, **kw), 3)
        # the single-core C++ baseline on the host, one call
        host = [t.cpu().numpy() for t in main]
        t0 = time.perf_counter()
        _native_fn(name)(*host, **kw)
        native_ms = 1e3 * (time.perf_counter() - t0)
        err = float((got - want).abs().max())
        _phase(name, f"{msg} {kw}; B=128 L={L}: kernel {ms:.3f} ms, plain "
               f"{plain_ms:.3f} ms, native C++ on one host core "
               f"{native_ms:.1f} ms ({native_ms / ms:.1f}x the kernel)")
        out.append(_kernel(name, "alignment.cu",
                           f"acoss_tpu/ops/alignment_pallas.py:{line}", err,
                           ms, plain_ms, _aligner_bound(name, *main)))
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


def _ties_at_kth(X, Y, l1, l2, m: int = 9) -> int:
    """Rows of the pairs' windowed CSMs, summed in float64, whose k-th
    smallest value occurs more than once."""
    n = 0
    for b in range(X.shape[0]):
        l1e, l2e = max(int(l1[b]) - m + 1, 0), max(int(l2[b]) - m + 1, 0)
        k = int(round(KAPPA * l2e))
        if l1e == 0 or k == 0:
            continue
        x, y = X[b].double(), Y[b].double()
        D = ((x[:, None] - y[None]) ** 2).sum(-1)
        W = sum(D[q:q + l1e, q:q + l2e] for q in range(m))
        kth = torch.sort(W, dim=1).values[:, k - 1:k]
        n += int(((W == kth).sum(1) > 1).sum())
    return n


def _check_fused(what: str, X, Y, l1, l2):
    """The fused CRP kernel == its plain version bit for bit; returns the
    kernel's output."""
    from acoss_tpu_torch.ops import crp_cuda

    got = crp_cuda.fused_binary_crp_batch(X, Y, l1, l2, KAPPA, 9)
    want = crp_cuda.fused_binary_crp_ref(X, Y, l1, l2, KAPPA, 9)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"fused CRP kernel != plain ({what}, "
                                 f"d={X.shape[2]}): "
                                 f"{int((g != w).sum())} cells differ")
    return got


def _two_launch_crp():
    """`acoss_fused_crp` of a copy of `csrc/crp.cu` in which every shape
    takes the two launches, the design the one-launch cluster kernel
    replaced at lines of up to 512: its yardstick. Built by
    `scripts/torch_kernel_variants.py` (its `CRP_TWO_LAUNCHES`). Returns
    fn(X, Y, l1, l2) -> S."""
    import importlib.util

    from acoss_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "torch_kernel_variants",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                     "torch_kernel_variants.py"))
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fn = variants._load(*variants._start_build(
        tempfile.mkdtemp(dir=_build.BUILD_DIR), "crp_two_launches",
        variants.CRP_SOURCES, variants.CRP_TWO_LAUNCHES), "acoss_fused_crp")

    def run(X, Y, l1, l2):
        B, L, _ = X.shape
        W = torch.empty((B, L, L), dtype=torch.float32, device=X.device)
        t_row = torch.empty((B, L), dtype=torch.int32, device=X.device)
        S = torch.empty((B, L, L), dtype=torch.uint8, device=X.device)
        _build.check(fn(X.data_ptr(), Y.data_ptr(), l1.data_ptr(),
                        l2.data_ptr(), B, L, X.shape[2], 9, KAPPA,
                        W.data_ptr(), t_row.data_ptr(), S.data_ptr(),
                        X.device.index,
                        torch.cuda.current_stream(X.device).cuda_stream),
                     "two-launch acoss_fused_crp")
        return S

    return run


def _fused_crp_at_cells(inputs: list) -> None:
    """The fused CRP at the benchmark cells' calls, a stream tile's B = 256
    and a mesh call's 1,920 (the tile's pairs repeated), d = 12 and 13:
    the one-launch kernel == the two launches bit for bit, and both
    timed."""
    from acoss_tpu_torch.ops import crp_cuda

    two = _two_launch_crp()
    for B in (256, 1920):
        for X, Y, l1, l2 in inputs:
            n = B // X.shape[0]
            Xc, Yc = X.repeat(n, 1, 1), Y.repeat(n, 1, 1)
            l1c, l2c = l1.repeat(n), l2.repeat(n)
            got = crp_cuda.fused_binary_crp_batch(Xc, Yc, l1c, l2c, KAPPA,
                                                  9)[0]
            if not torch.equal(got, two(Xc, Yc, l1c, l2c)):
                raise AssertionError(f"fused CRP: one launch != two at "
                                     f"B={B}")
            del got
            ms = _cuda_ms(lambda: crp_cuda.fused_binary_crp_batch(
                Xc, Yc, l1c, l2c, KAPPA, 9), 10)
            ms2 = _cuda_ms(lambda: two(Xc, Yc, l1c, l2c), 10)
            _phase("fused_crp", f"B={B} L={X.shape[1]} d={X.shape[2]}: one "
                   f"launch (cluster of "
                   f"{crp_cuda.fused_crp_cluster(X.shape[1], X.shape[2], 9)}"
                   f") {ms:.4f} ms, two launches {ms2:.4f} ms "
                   f"({ms / ms2:.3f}x), bit-equal")


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
    # a tie-heavy batch (the chroma features on a grid of 1/4, so that
    # many windowed sums tie at the k-th value) and lengths that are not
    # multiples of 32, from the d = 12 input
    X, Y, l1, l2 = inputs[0]
    g = torch.Generator(device="cpu").manual_seed(0)
    ragged = torch.randint(40, L + 1, (2, X.shape[0]), generator=g)
    ragged = (ragged | 1).clamp_max(L - 1).to(torch.int32).to(X.device)
    Xq, Yq = torch.round(X * 4) / 4, torch.round(Y * 4) / 4
    ties = _ties_at_kth(Xq[:8], Yq[:8], l1[:8], l2[:8])
    if ties == 0:
        raise AssertionError("fused CRP: the tie-heavy batch has no ties")
    _check_fused("ties", Xq, Yq, l1, l2)
    _check_fused("ragged lengths", X, Y, ragged[0].contiguous(),
                 ragged[1].contiguous())
    _phase("fused_crp", f"kernel == plain bit for bit on a tie-heavy "
           f"batch ({ties} rows of its first 8 pairs tie at their k-th "
           f"value) and on odd lengths {int(ragged.min())}.."
           f"{int(ragged.max())}")
    worst, times, bounds = 0, [], []
    for X, Y, l1, l2 in inputs:
        # pairs whose rounded k is 0 (l1e = 4, l2e = 1) and a zero length
        l1[0], l2[1], l1[2] = 12, 9, 0
        got = _check_fused("tile", X, Y, l1, l2)
        want = crp_cuda.fused_binary_crp_ref(X, Y, l1, l2, KAPPA, 9)
        if int(got[0][:3].sum()) != 0 or int(got[0][3:].sum()) == 0:
            raise AssertionError("fused CRP: implausible CRPs")
        worst = max(worst, int((got[0].int() - want[0].int()).abs().max()))
        ms = _cuda_ms(lambda: crp_cuda.fused_binary_crp_batch(
            X, Y, l1, l2, KAPPA, 9), 10)
        plain_ms = _cuda_ms(lambda: crp_cuda.fused_binary_crp_ref(
            X, Y, l1, l2, KAPPA, 9), 3)
        times.append((ms, plain_ms))
        # reads the valid rows of X and Y, writes S and the effective
        # lengths; the CSM (2d + 3 operations a cell), the window and the
        # two masks (m + 3 a valid window cell)
        B, _, d = X.shape
        l1e, l2e = (torch.clamp_min(t - 9 + 1, 0) for t in (l1, l2))
        bounds.append(_bound(
            4 * d * float((l1.clamp(0, L) + l2.clamp(0, L)).sum())
            + B * L * L + 16 * B,
            (2 * d + 3) * _cells(l1, l2, L) + 12 * _cells(l1e, l2e, L)))
        _phase("fused_crp", f"kernel == plain bit for bit, B={X.shape[0]} "
               f"L={X.shape[1]} d={X.shape[2]}: kernel {ms:.3f} ms, "
               f"plain {plain_ms:.3f} ms, bound {bounds[-1][0]:.4f} ms "
               f"({bounds[-1][1]})")
    _fused_crp_at_cells(inputs)
    return _kernel("fused_crp", "crp.cu", "acoss_tpu/ops/crp_pallas.py:57",
                   worst, np.mean([t[0] for t in times]),
                   np.mean([t[1] for t in times]),
                   (float(np.mean([b[0] for b in bounds])), bounds[0][1]))


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


def _mostly_positive(scores) -> bool:
    """Aligner scores: most pairs have some alignment."""
    return (scores > 0).mean() > 0.9


def _benchmark_path(name: str, algo, dev, fs, expect: dict,
                    plausible=_mostly_positive):
    """`benchmark(algo)` with counted launches; returns its stats, the
    swept score matrices from its ledger (the lower triangle of a
    symmetric algorithm, every tile of an asymmetric one), the stage times
    and the launch counts. Every swept pair's score must be finite and
    the swept scores of each type `plausible`."""
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
    n, n_tiles = fs.n_songs, -(-fs.n_songs // algo.TILE)
    swept = done[np.tril_indices(n_tiles)] if algo.SYMMETRIC else done
    if not swept.all():
        raise AssertionError(f"{name}: the ledger misses tiles")
    pairs = np.tril_indices(n, -1) if algo.SYMMETRIC \
        else ~np.eye(n, dtype=bool)
    for k, D in Ds.items():
        if D.shape != (n, n) or not np.isfinite(D).all() \
                or not plausible(D[pairs]):
            raise AssertionError(f"{name} {k}: implausible score matrix")
    return stats, Ds, times, counts


def _keeping(cls):
    """A subclass of the algorithm `cls` that keeps the descriptors it
    extracted (`desc`) and the score matrices handed to its post_process
    (`Ds`)."""
    class Keeping(cls):
        def extract_descriptors(self, fs, device="cuda"):
            self.desc = super().extract_descriptors(fs, device=device)
            return self.desc

        def post_process(self, Ds, desc, device="cuda"):
            self.Ds = Ds
            return super().post_process(Ds, desc, device=device)

    Keeping.__name__ = cls.__name__
    return Keeping


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
    return counts, Ds, pairs / times["sweep"]


def phase_early_snf(dev, fs) -> tuple[dict, dict]:
    """benchmark(EarlySNF()) in parity mode; returns the descriptors it
    extracted (on the card) and its launch counts."""
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF
    from acoss_tpu_torch.convert import descriptors_from_numpy

    algo = _keeping(EarlySNF)()
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


def phase_legacy(dev, desc: dict) -> tuple[dict, dict]:
    """The legacy similarity API on the 15 pairs of the first 6 songs (3
    cliques): percentile CRPs (host numpy) of their x40-downsampled
    chroma, then `serra_cover_similarity_measures` with the unequal gaps
    (0.3, 0.8) on the card, counted. Each distance must equal the one from
    the native C++ qmax bit for bit, and covers must be nearer than
    non-covers on average. Then the unequal-gap qmax kernel on each of
    those (1, M, N) CRPs must equal its plain version bit for bit, and is
    timed there. Returns the launch counts and the kernel's entry."""
    from acoss_tpu_torch import native
    from acoss_tpu_torch.ops import alignment_cuda
    from acoss_tpu_torch.ops import similarity_legacy as legacy

    go, ge = UNEQ_GAPS[0]
    songs = [desc["chroma"][i, :int(desc["length"][i])].cpu().numpy()
             for i in range(6)]
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    crps = [legacy.cross_recurrent_plot(songs[i], songs[j])
            for i, j in pairs]
    t0 = time.perf_counter()
    dist, counts = _counted("legacy", lambda: [
        legacy.serra_cover_similarity_measures(
            c, dis_onset=go, dis_extension=ge, device=dev) for c in crps],
        {"qmax_uneq": len(pairs)})
    secs = time.perf_counter() - t0
    scores = [native.qmax_cpu(c, go, ge) for c in crps]
    for c, got, score in zip(crps, dist, scores):
        if got != float(np.sqrt(c.shape[1]) / max(score, 1e-12)):
            raise AssertionError("legacy qmax: kernel != native C++")
    cover = [d for (i, j), d in zip(pairs, dist) if j == i + 1 and i % 2 == 0]
    other = [d for (i, j), d in zip(pairs, dist)
             if not (j == i + 1 and i % 2 == 0)]
    if not np.isfinite(dist).all() or not np.mean(cover) < np.mean(other):
        raise AssertionError(f"legacy: implausible distances {dist}")
    _phase("legacy", f"serra_cover_similarity_measures(dis_onset={go}, "
           f"dis_extension={ge}) on {dev}, {len(pairs)} pairs of CRPs up to "
           f"{max(c.shape[0] for c in crps)} x "
           f"{max(c.shape[1] for c in crps)}: launches "
           + ", ".join(f"{k} {v}" for k, v in counts.items())
           + f"; == native C++ bit for bit; mean distance covers "
           f"{np.mean(cover):.4f}, others {np.mean(other):.4f}; "
           f"{secs:.3f} s")
    # the kernel's inputs on this path: one (1, M, N) CRP a launch
    args = [(torch.from_numpy(np.ascontiguousarray(c, dtype=np.uint8))[None]
             .to(dev), torch.tensor([c.shape[0]], dtype=torch.int32,
                                    device=dev),
             torch.tensor([c.shape[1]], dtype=torch.int32, device=dev))
            for c in crps]
    err = 0.0
    for a, score in zip(args, scores):
        got = alignment_cuda.qmax_uneq_batch_cuda(*a, go, ge)
        want = alignment_cuda.qmax_uneq_batch_ref(*a, go, ge)
        if not torch.equal(got, want) or not float(got[0]) > 0 \
                or float(got[0]) != score:
            raise AssertionError(f"legacy qmax_uneq kernel {got} != plain "
                                 f"{want} or native C++ {score}, "
                                 f"{tuple(a[0].shape)}")
        err = max(err, float((got - want).abs().max()))
    ms = _cuda_ms(lambda: [alignment_cuda.qmax_uneq_batch_cuda(*a, go, ge)
                           for a in args], 10) / len(args)
    plain_ms = _cuda_ms(lambda: [alignment_cuda.qmax_uneq_batch_ref(
        *a, go, ge) for a in args], 1) / len(args)
    bounds = [_aligner_bound("qmax_uneq", *a) for a in args]
    _phase("legacy", f"qmax_uneq kernel == plain == native C++ bit for bit "
           f"on each of the {len(args)} CRPs; a launch: kernel {ms:.4f} ms, "
           f"plain "
           f"{plain_ms:.3f} ms")
    return counts, _kernel(
        "qmax_uneq", "alignment.cu", "acoss_tpu/ops/alignment_pallas.py:101",
        err, ms, plain_ms,
        (float(np.mean([b[0] for b in bounds])), bounds[0][1]))


def _tile(desc: dict):
    return ({k: v[8:16] for k, v in desc.items()},
            {k: v[0:8] for k, v in desc.items()})


def _long_lines(dev, seed: int = 0):
    """(2, L, L) float32 lines 2,048 past the register design's range
    (`crp_cuda.SELECT_REGISTER_MAX_L`), which take the block-a-line
    kernels: uniform [0, 1) with a fifth of the cells tied at 0.25."""
    from acoss_tpu_torch.ops import crp_cuda

    B, L = 2, crp_cuda.SELECT_REGISTER_MAX_L + 2048
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.rand((B, L, L), generator=g, device=dev)
    X[torch.rand((B, L, L), generator=g, device=dev) < 0.2] = 0.25
    return X


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
    # lines past the register range (negated, so the keys are signed), and
    # an odd width (byte stores)
    Dl = -_long_lines(D.device)
    Ll = Dl.shape[-1]
    lnl = torch.tensor([[Ll, Ll - 191], [Ll - 1000, Ll]], dtype=torch.int32,
                       device=D.device)
    Do = Dx[:8, :L - 3, :L - 3].contiguous()
    cases = [("tile + degenerate", Dx, l1x, l2x),
             (f"long lines L={Ll}", Dl, lnl[:, 0].contiguous(),
              lnl[:, 1].contiguous()),
             (f"odd width L={L - 3}", Do, l1x[:8].clamp_max(L - 3),
              l2x[:8].clamp_max(L - 3))]
    for what, Dc, a, b in cases:
        got = crp_cuda.binarize_matrix_batch(Dc, a, b, KAPPA)
        want = crp_cuda.binarize_matrix_ref(Dc, a, b, KAPPA)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"binarize kernel != plain ({what}): "
                                 f"{int((got != want).sum())} cells differ")
        if int(got.sum()) == 0:
            raise AssertionError(f"binarize: implausible CRPs ({what})")
        if what.startswith("tile"):
            err = (got.int() - want.int()).abs().max()
            if int(got[:256].sum()) == 0 or int(got[258:].sum()) != 0:
                raise AssertionError("binarize: implausible CRPs")
    del Dl, got, want
    ms = _cuda_ms(lambda: crp_cuda.binarize_matrix_batch(D, l1, l2, KAPPA),
                  10)
    plain_ms = _cuda_ms(lambda: crp_cuda.binarize_matrix_ref(D, l1, l2,
                                                             KAPPA), 3)
    split = _kernel_split(lambda: crp_cuda.binarize_matrix_batch(
        D, l1, l2, KAPPA))
    _phase("binarize", f"kernel == plain bit for bit on the EarlySNF tile's "
           f"(256, {L}, {L}) stack + 4 degenerate, on 2 lines of {Ll} and "
           f"on 8 of {L - 3}; kernel {ms:.3f} ms ({split}, by "
           f"torch.profiler), plain {plain_ms:.3f} ms")
    # reads the valid (l1, l2) window, writes the whole CRP; two compares
    # and an AND a valid cell
    cells = _cells(l1, l2, L)
    bound = _bound(4 * cells + D.shape[0] * (L * L + 8), 3 * cells)
    return _kernel("binarize", "knn.cu", "acoss_tpu/ops/crp_pallas.py:276",
                   err, ms, plain_ms, bound)


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
    # k = 1, k = n, k = 65 and 128 (past the lanes' two smallest keys),
    # and two matrices with rows of ties
    kx = torch.cat([k, k[2:4], k[4:6]]).clone()
    kx[0], kx[1], kx[-2], kx[-1] = 1, n, 65, 128
    Wx = torch.cat([W, torch.round(W[2:4] * 64) / 64, W[4:6]])
    # lines past the register range, and an odd width (a lane's last
    # cells cut short)
    Wl = _long_lines(W.device, seed=1)
    nl = Wl.shape[-1]
    kl = torch.tensor([100, nl], dtype=torch.int32, device=W.device)
    Wo = Wx[-8:, :n - 2, :n - 2].contiguous()
    cases = [("tile + 6", Wx, kx), (f"long lines n={nl}", Wl, kl),
             (f"odd width n={n - 2}", Wo, kx[-8:].contiguous())]
    for what, Wc, kc in cases:
        got = crp_cuda.knn_mask_matrix_batch(Wc, kc)
        want = crp_cuda.knn_mask_matrix_ref(Wc, kc)
        torch.cuda.synchronize()
        if not (torch.equal(got, want)
                and torch.equal(torch.signbit(got), torch.signbit(want))):
            raise AssertionError(f"knn_mask kernel != plain ({what}): "
                                 f"{int((got != want).sum())} cells differ")
        if what.startswith("tile"):
            err = (got - want).abs().max()
    del Wl, got, want
    ms = _cuda_ms(lambda: crp_cuda.knn_mask_matrix_batch(W, k), 10)
    plain_ms = _cuda_ms(lambda: crp_cuda.knn_mask_matrix_ref(W, k), 3)
    split = _kernel_split(lambda: crp_cuda.knn_mask_matrix_batch(W, k))
    _phase("knn_mask", f"kernel == plain bit for bit on the EarlySNF tile's "
           f"({W.shape[0]}, {n}, {n}) W stack (k {int(k.min())}.."
           f"{int(k.max())}) + k=1, k=n, k=65, k=128 and 2 tie matrices, on "
           f"2 lines of {nl} and on 8 of {n - 2}; kernel {ms:.3f} ms "
           f"({split}, by torch.profiler), plain {plain_ms:.3f} ms")
    # reads and writes every cell of W (no lengths); a compare and a
    # select a cell
    bound = _bound(8 * W.numel() + 4 * W.shape[0], 2 * W.numel())
    return _kernel("knn_mask", "knn.cu", "acoss_tpu/ops/crp_pallas.py:431",
                   err, ms, plain_ms, bound)


def phase_wcsmssm(desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF
    from acoss_tpu_torch.ops import crp_cuda

    calls = []
    with _spy(crp_cuda, "wcsmssm_batch", calls):
        EarlySNF(snf_precision="default").tile_scores(*_tile(desc))
    if len(calls) != 2:
        raise AssertionError(f"wcsmssm: {len(calls)} calls a tile")
    worst_abs, worst_rel, times, bounds = 0.0, 0.0, [], []
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
        WA, WB, WC = got[:, :L, :L], got[:, L:, L:], got[:, :L, L:]
        if not (torch.equal(WA, WA.transpose(1, 2))
                and torch.equal(WB, WB.transpose(1, 2))
                and torch.equal(got[:, L:, :L], WC.transpose(1, 2))):
            raise AssertionError("wcsmssm: output not symmetric")
        split = _kernel_split(lambda: crp_cuda.wcsmssm_batch(*args, **kw))
        # reads the valid SSM and CSM windows, writes the whole (2L, 2L)
        # affinity; ~10 operations (sums, products, a quotient, an exp)
        # a valid affinity cell
        valid = _cells(l1, l1, L) + _cells(l2, l2, L) + _cells(l1, l2, L)
        bounds.append(_bound(4 * valid + 16 * A.shape[0] * L * L,
                             10 * (valid + _cells(l1, l2, L))))
    ms = float(np.mean([t[0] for t in times]))
    plain_ms = float(np.mean([t[1] for t in times]))
    _phase("wcsmssm", f"kernel within rtol 2e-5 / atol 2e-6 of plain on the "
           f"throughput tile's 2 x (64, {L}, {L}) stacks (K=1 and K=0 "
           f"included), symmetric bit for bit: max abs err "
           f"{worst_abs:.3g}, max rel err {worst_rel:.3g}; kernel {ms:.3f} "
           f"ms ({split} of the last stack, by torch.profiler), plain "
           f"{plain_ms:.3f} ms")
    return _kernel("wcsmssm", "knn.cu", "acoss_tpu/ops/crp_pallas.py:598",
                   worst_abs, ms, plain_ms,
                   (float(np.mean([b[0] for b in bounds])), bounds[0][1]))


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


def phase_early_fusion(dev, fs) -> tuple[dict, dict]:
    """benchmark(EarlyFusion()); returns the descriptors it extracted (on
    the card) and its launch counts."""
    from acoss_tpu_torch.benchmarking.algorithms import EarlyFusion
    from acoss_tpu_torch.convert import descriptors_from_numpy

    algo = _keeping(EarlyFusion)()
    T = _swept_tiles(fs.n_songs, algo.TILE)
    torch.cuda.reset_peak_memory_stats()
    # one SW launch a tile, one kNN row-mask launch in each late SNF
    stats, Ds, times, counts = _benchmark_path(
        "early_fusion", algo, dev, fs, {"sw": T, "knn_mask": 2})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_map("early_fusion", stats, {"": 0.99})
    pairs = fs.n_songs * (fs.n_songs - 1) // 2
    desc = descriptors_from_numpy(algo.desc, dev)
    blocks = algo.desc["length"]
    _phase("early_fusion", f"benchmark(EarlyFusion) on {dev}: "
           f"{fs.n_songs} songs of {blocks.min()}..{blocks.max()} blocks, "
           f"padded to {desc['mfccs'].shape[1]}; {T} tiles, {pairs} pairs; "
           "launches " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    _phase("early_fusion", ", ".join(f"{k} MAP {s.map:.4f} MR {s.mr:.3f}"
                                     for k, s in stats.items()))
    _phase("early_fusion", f"extract {times['extract']:.2f} s, sweep "
           f"{times['sweep']:.2f} s, eval {times['eval']:.2f} s "
           f"(late fusion included); {pairs / times['sweep']:.1f} "
           f"fully-scored pairs/s; peak device memory {peak:.2f} GiB")
    n = _first_block_row(algo, desc, Ds, fs.n_songs)
    _phase("early_fusion", f"first block-row ({n} tiles) recomputed by the "
           f"plain versions on {dev}: identical scores")
    return desc, counts


class _Killed(Exception):
    """Stands for a process killed in the middle of a sweep."""


def _device_busy_ms(prof) -> float:
    """Summed device time of every kernel and copy in a profile."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def phase_datacos_geometry(dev) -> dict:
    """Serra09 at Da-TACOS song geometry through the sweep engines: a
    LazySyntheticCorpus of 40 cliques x 13 covers + 80 distractors (600
    songs, covers80-real song lengths), extracted into an int8 disk store,
    then swept by the plain in-RAM sweep of the dequantized store (the
    reference), the bucketed sweep streamed from per-bucket int8 stores
    into memmapped scores (killed about half way, then resumed from its
    ledger; the resumed half profiled for the device's idle share), and
    the hybrid 128-song-panel sweep of the store. Every engine's scores
    equal its reference bit for bit; every sweep launches qmax, dmax and
    the fused CRP once, once and twice a tile it sweeps."""
    from torch.profiler import ProfilerActivity, profile

    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.benchmarking.evaluation import eval_statistics
    from acoss_tpu_torch.data import LazySyntheticCorpus
    from acoss_tpu_torch.data.descstore import (DescriptorStore,
                                                extract_streamed,
                                                upcast_stream)
    from acoss_tpu_torch.ops import _build, alignment_cuda

    name = "datacos_geometry"
    t_phase = time.perf_counter()
    corpus = LazySyntheticCorpus(n_cliques=40, clique_size=13,
                                 n_distractors=80, base_duration=300.0)
    n = corpus.n_songs
    pairs = n * (n - 1) // 2
    T = _swept_tiles(n, Serra09.TILE)
    expect = _serra_launches(T)

    def check_map(what: str, Ds: dict, labels) -> dict:
        stats = {k: eval_statistics(np.asarray(D), labels)
                 for k, D in Ds.items()}
        _check_map(f"{name} {what}", stats, {"": 0.99})
        return stats

    def check_equal(what: str, got: dict, want: dict) -> None:
        for k in Serra09.SIMILARITY_TYPES:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            if not np.array_equal(g, w):
                raise AssertionError(f"{name}: {what} {k} != its reference "
                                     f"at {int((g != w).sum())} cells")

    def timed(what: str, run, tiles: int):
        t0 = time.perf_counter()
        out, _ = _counted(f"{name} {what}", run, _serra_launches(tiles))
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store = extract_streamed(Serra09(), corpus, f"{tmp}/store",
                                 quant="int8", half_min_bytes=16384,
                                 device=dev)
        t_extract = time.perf_counter() - t0
        if not (store["chroma"].dtype == store["mfcc"].dtype == np.int8):
            raise AssertionError(f"{name}: the store is not int8: "
                                 f"{ {k: str(v.dtype) for k, v in store.items()} }")
        lengths = np.asarray(store["length"])
        Lw = store["chroma"].shape[1]
        # every tile pads to the store's width: it must be inside the
        # fused CRP's lines (its C entry point sizes the shared memory and
        # returns 0 past them) and qmax / dmax's rows
        lib = _build.library()
        crp_smem = [lib.acoss_fused_crp_smem(Lw, d, 9) for d in (12, 13)]
        if not (Lw <= alignment_cuda.REGISTER_MAX_N
                and all(0 < s <= _build.MAX_SMEM for s in crp_smem)):
            raise AssertionError(f"{name}: width {Lw} is past a kernel "
                                 f"limit (fused CRP shared memory "
                                 f"{crp_smem})")
        _phase(name, f"{n} songs ({corpus.n_cliques} x {corpus.clique_size}"
               f" + {corpus.n_distractors}), {pairs} pairs, {T} tiles; "
               f"descriptor rows {int(lengths.min())}..{int(lengths.max())}"
               f", store width {Lw} (fused CRP lines <= 6144, qmax / dmax "
               f"rows <= {alignment_cuda.REGISTER_MAX_N}); int8 store "
               f"{sum(v.nbytes for v in store.values())} bytes; extract "
               f"{t_extract:.2f} s")

        # the reference: the plain in-RAM sweep of the dequantized store
        deq = upcast_stream({k: torch.from_numpy(np.array(v))
                             for k, v in store.items()})
        ref, t_ref = timed("plain", lambda: harness.run_pairwise(
            Serra09(), deq, n, device=dev), T)
        t0 = time.perf_counter()
        check_map("plain", ref, corpus.labels)
        t_eval = time.perf_counter() - t0

        # the bucketed sweep from per-bucket int8 stores into memmapped
        # scores, killed after about half its tiles, then resumed
        fs = corpus.subset(np.arange(n))
        sd, ckpt = f"{tmp}/stream", f"{tmp}/ledger.npz"
        killed_at = T // 2
        bucket_kw = dict(n_buckets=4, stream_dir=sd, stream_quant="int8",
                         stream_min_bytes=16384, checkpoint_path=ckpt,
                         checkpoint_every=max(1, min(16, killed_at // 4)),
                         return_perm=True, device=dev)

        class KilledSerra09(Serra09):
            calls = 0

            def tile_scores(self, row, col, plain=False):
                if self.calls == killed_at:
                    raise _Killed
                self.calls += 1
                return super().tile_scores(row, col, plain)

        stage = {}

        def killed_run() -> bool:
            try:
                harness.run_pairwise_bucketed(KilledSerra09(), fs,
                                              times=stage, **bucket_kw)
            except _Killed:
                return True
            return False

        t0 = time.perf_counter()
        killed, _ = _counted(f"{name} bucketed (killed)", killed_run,
                             _serra_launches(killed_at))
        t_killed = time.perf_counter() - t0
        if not killed:
            raise AssertionError(f"{name}: the bucketed sweep was not killed")
        with np.load(ckpt) as z:
            ledger_done = int(z["done"].sum())
        if not 0 < ledger_done <= killed_at:
            raise AssertionError(f"{name}: {ledger_done} tiles in the ledger "
                                 f"after {killed_at} swept")
        bucket_times = {}
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (Db, perm), _ = _counted(
                f"{name} bucketed (resumed)",
                lambda: harness.run_pairwise_bucketed(
                    Serra09(), fs, times=bucket_times, **bucket_kw),
                _serra_launches(T - ledger_done))
        t_resumed = time.perf_counter() - t0
        busy_s = _device_busy_ms(prof) / 1e3
        idle = 1 - busy_s / bucket_times["sweep"]

        # the bucketed sweep's reference: the plain sweep of its own
        # per-bucket stores, dequantized and merged in the sorted order
        # (a pair's orientation, row song or column song, is part of its
        # score: the plain sweep in the caller's order would orient the
        # pairs whose order the sort swaps the other way)
        edges = harness._bucket_edges(n, 4, Serra09.TILE)
        buckets = [upcast_stream({k: torch.from_numpy(np.array(v)) for k, v
                                  in DescriptorStore.open(
                                      f"{sd}/desc/bucket_{b:04d}").items()})
                   for b in range(len(edges) - 1)]
        merged = harness._merge_bucket_descs(buckets, np.arange(n))
        same_desc = all(np.array_equal(merged[k], deq[k].numpy()[perm])
                        for k in deq)
        ref_sorted, t_ref_sorted = timed(
            "plain (sorted)", lambda: harness.run_pairwise(
                Serra09(), merged, n, device=dev), T)
        check_equal("bucketed (killed and resumed)", Db, ref_sorted)
        check_map("bucketed", Db, corpus.labels[perm])
        _phase(name, f"bucketed: {len(buckets)} buckets at widths "
               f"{[int(b['chroma'].shape[1]) for b in buckets]}, extract "
               f"{stage['extract']:.2f} s; killed after {killed_at} tiles "
               f"({t_killed:.2f} s, the ledger held {ledger_done}), resumed "
               f"{T - ledger_done} tiles under the profiler ({t_resumed:.2f} "
               f"s, sweep {bucket_times['sweep']:.2f} s, device busy "
               f"{busy_s:.2f} s, idle {idle:.1%}); == the plain sweep of its "
               f"stores in the sorted order bit for bit; its stores "
               f"{'equal' if same_desc else 'differ from'} the plain "
               f"store's rows")

        # the hybrid sweep: 128-song device panels, column tiles streamed
        # from the int8 store
        Dh, t_hybrid = timed("hybrid", lambda: harness.run_pairwise_hybrid(
            Serra09(), store, n, panel_songs=128, device=dev,
            scores_dir=f"{tmp}/hybrid"), T)
        check_equal("hybrid", Dh, ref)
        stats = check_map("hybrid", Dh, corpus.labels)

    _phase(name, f"plain {t_ref:.2f} s = {pairs / t_ref:.1f} pairs/s, plain "
           f"(sorted) {t_ref_sorted:.2f} s = {pairs / t_ref_sorted:.1f} "
           f"pairs/s, bucketed (killed half, unprofiled) "
           f"{killed_at / T * pairs / (t_killed - stage['extract']):.1f} "
           f"pairs/s, hybrid {t_hybrid:.2f} s = {pairs / t_hybrid:.1f} "
           f"pairs/s; launches a sweep {expect}; eval (4 channels) "
           f"{t_eval:.2f} s; phase {time.perf_counter() - t_phase:.1f} s")
    _phase(name, "plain == hybrid bit for bit; " + ", ".join(
        f"{k} MAP {s.map:.4f} MR {s.mr:.3f} Top-1 {s.tops.get(1)}"
        for k, s in stats.items()))
    return expect


def phase_sw(desc: dict) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import EarlyFusion
    from acoss_tpu_torch.ops import alignment_cuda

    calls = []
    with _spy(alignment_cuda, "swconstrained_batch_cuda", calls):
        EarlyFusion().tile_scores(*_tile(desc))
    (S, m, n), kw = calls[0]
    Lf = desc["mfccs"].shape[1]
    if len(calls) != 1 or S.shape != (256, Lf, Lf):
        raise AssertionError(f"sw: {len(calls)} calls, {tuple(S.shape)}")
    # degenerate pairs: sides of 2 and 3, a zero length, rows 0 and 1 all
    # matches
    rng = np.random.default_rng(1)
    sizes = [(2, Lf), (Lf, 2), (3, 3), (0, 100), (Lf, Lf)]
    Sd = np.zeros((len(sizes), Lf, Lf), np.uint8)
    for b, (mm, nn) in enumerate(sizes):
        Sd[b, :mm, :nn] = rng.random((mm, nn)) < 0.1
    Sd[-1, :2] = 1
    Sx = torch.cat([S, torch.from_numpy(Sd).to(S.device)])
    mx = torch.cat([m, torch.tensor([z[0] for z in sizes], dtype=m.dtype,
                                    device=m.device)])
    nx = torch.cat([n, torch.tensor([z[1] for z in sizes], dtype=n.dtype,
                                    device=n.device)])
    got = alignment_cuda.swconstrained_batch_cuda(Sx, mx, nx, **kw)
    want = alignment_cuda.swconstrained_batch_ref(Sx, mx, nx, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).nonzero().flatten().tolist()
        raise AssertionError(f"sw kernel != plain at pairs {bad}")
    # a side below 3 or a zero length scores 0; (3, 3) may score a match
    zero = [256 + b for b, z in enumerate(sizes) if min(z) < 3]
    if float(got[:256].min()) <= 0 or float(got[-1]) <= 0 \
            or float(got[zero].abs().max()) != 0:
        raise AssertionError(f"sw: implausible scores {got}")
    ms = _cuda_ms(lambda: alignment_cuda.swconstrained_batch_cuda(
        S, m, n, **kw), 20)
    plain_ms = _cuda_ms(lambda: alignment_cuda.swconstrained_batch_ref(
        S, m, n, **kw), 3)
    host = [t.cpu().numpy() for t in (S, m, n)]
    t0 = time.perf_counter()
    native_tile = _native_fn("sw")(*host, **kw)
    native_ms = 1e3 * (time.perf_counter() - t0)
    native_deg = _native_fn("sw")(
        *(t[S.shape[0]:].cpu().numpy() for t in (Sx, mx, nx)), **kw)
    if not np.array_equal(got.cpu().numpy(),
                          np.concatenate([native_tile, native_deg])):
        raise AssertionError("sw kernel != native C++ on the tile stack")
    _phase("sw", f"kernel == plain == native C++ bit for bit on the "
           f"EarlyFusion tile's ({S.shape[0]}, {Lf}, {Lf}) stack (lengths "
           f"{int(m.min())}..{int(m.max())}) + {len(sizes)} degenerate; "
           f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, native C++ on one "
           f"host core {native_ms:.1f} ms ({native_ms / ms:.1f}x the "
           f"kernel)")
    return _kernel("sw", "alignment.cu",
                   "acoss_tpu/ops/alignment_pallas.py:196",
                   (got - want).abs().max(), ms, plain_ms,
                   _aligner_bound("sw", S, m, n))


def _stage_lines(name: str, label: str, dev, fs, stats: dict, times: dict,
                 counts: dict, note: str = "") -> None:
    """A new family's lines: launches and MAP per channel, then its
    extract / sweep / eval seconds and fully-scored pairs/s."""
    pairs = fs.n_songs * (fs.n_songs - 1) // 2
    _phase(name, f"benchmark({label}) on {dev}: {fs.n_songs} songs, "
           f"{pairs} pairs{note}; launches "
           + (", ".join(f"{k} {v}" for k, v in counts.items()) or "none")
           + "; " + ", ".join(f"{k} MAP {s.map:.4f} MR {s.mr:.3f}"
                              for k, s in stats.items()))
    _phase(name, f"extract {times['extract']:.2f} s, sweep "
           f"{times['sweep']:.2f} s, eval {times['eval']:.2f} s; "
           f"{pairs / times['sweep']:.1f} fully-scored pairs/s")


def _full_scores_path(name: str, label: str, algo, dev, fs, floors: dict,
                      plausible) -> dict:
    """`benchmark(algo)` of a family whose sweep is one Gram
    (`full_scores`): no kernel launches; every N x N matrix finite with a
    zero diagonal and `plausible` off it; MAP floors; `full_scores` timed
    alone by CUDA events. Returns the launch counts (none)."""
    from acoss_tpu_torch.benchmarking.harness import benchmark
    from acoss_tpu_torch.convert import descriptors_from_numpy

    times = {}
    stats, counts = _counted(name, lambda: benchmark(
        algo, fs, device=dev, times=times), {})
    n = fs.n_songs
    off = ~np.eye(n, dtype=bool)
    if sorted(algo.Ds) != sorted(algo.SIMILARITY_TYPES):
        raise AssertionError(f"{name}: matrices {sorted(algo.Ds)}")
    for k, D in algo.Ds.items():
        if D.shape != (n, n) or not np.isfinite(D).all() \
                or np.diag(D).any() or not plausible(D[off]):
            raise AssertionError(f"{name} {k}: implausible score matrix")
    _check_map(name, stats, floors)
    desc = descriptors_from_numpy(algo.desc, dev)
    ms = _cuda_ms(lambda: algo.full_scores(desc), 10)
    dims = ", ".join(f"{k} {tuple(v.shape)}" for k, v in desc.items())
    _stage_lines(name, label, dev, fs, stats, times, counts,
                 f", one Gram a channel ({dims}): full_scores {ms:.4f} ms")
    return counts


def phase_ftm2d(dev, fs) -> dict:
    """benchmark(FTM2D()) (BASELINE config 1's algorithm) and its zeropad
    ablation: the shingle Gram exp(-||s_i - s_j||^2) in (0, 1]."""
    from acoss_tpu_torch.benchmarking.algorithms import FTM2D

    def in_unit(v) -> bool:
        return bool(((v > 0) & (v <= 1)).all())

    counts = _full_scores_path("ftm2d", "FTM2D", _keeping(FTM2D)(), dev,
                               fs, {"": 0.99}, in_unit)
    _full_scores_path("ftm2d_zeropad", 'FTM2D(mode="zeropad")',
                      _keeping(FTM2D)(mode="zeropad"), dev, fs, {"": 0.0},
                      in_unit)
    return counts


def phase_anf(dev, fs) -> dict:
    """benchmark(ANFScattering()): host resampling, the 1D scattering on
    the card in chunks of 64 songs, Euclidean distances from one Gram a
    channel."""
    from acoss_tpu_torch.benchmarking.algorithms import ANFScattering

    torch.cuda.reset_peak_memory_stats()
    counts = _full_scores_path(
        "anf_scattering", "ANFScattering", _keeping(ANFScattering)(), dev,
        fs, {"": 0.95}, lambda v: bool((v > 0).all()))
    _phase("anf_scattering", f"peak device memory "
           f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
           f"(JAX record MAP 0.988-1.000)")
    return counts


def phase_simple(dev, fs) -> dict:
    """benchmark(Simple()), the asymmetric sweep: every tile of the full
    grid scored, the score matrix not symmetric, -median profiles <= 0."""
    from acoss_tpu_torch.benchmarking.algorithms import Simple

    class Counted(Simple):
        tiles = 0

        def tile_scores(self, row, col):
            Counted.tiles += 1
            return super().tile_scores(row, col)

    algo = Counted()
    stats, Ds, times, counts = _benchmark_path(
        "simple", algo, dev, fs, {},
        lambda v: bool((v <= 0).all() and (v < 0).mean() > 0.9))
    n_tiles = -(-fs.n_songs // algo.TILE)
    D = Ds["main"]
    upper = np.triu_indices(fs.n_songs, 1)
    if Counted.tiles != n_tiles * n_tiles \
            or np.array_equal(D[upper], D.T[upper]):
        raise AssertionError(f"simple: {Counted.tiles} tiles for a "
                             f"{n_tiles} x {n_tiles} grid, or a symmetric "
                             f"matrix")
    _check_map("simple", stats, {"": 0.99})
    _stage_lines("simple", "Simple", dev, fs, stats, times, counts,
                 f", {Counted.tiles} tiles (the full {n_tiles} x {n_tiles} "
                 f"grid, asymmetric)")
    return counts, D


def _tile_split(algo, row: dict, col: dict, reps: int = 7) -> str:
    """One tile of `algo` on the card: the median wall of `reps` warm
    calls, and one profiled call's device time, split into the row sorts
    of the non-mutual binarization, the qmax and dmax kernels and the
    rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        algo.tile_scores(row, col)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        algo.tile_scores(row, col)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        algo.tile_scores(row, col)
        torch.cuda.synchronize()
    split = {"sort": 0.0, "qmax": 0.0, "dmax": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key.lower()
        part = next((p for p in ("qmax", "dmax") if f"{p}_kernel" in key),
                    "sort" if "sort" in key else "other")
        split[part] += e.self_device_time_total / 1e3
    return (f"tile wall median {float(np.median(walls)):.3f} ms, device "
            f"{sum(split.values()):.3f} ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))


def _check_knn_calls(name: str, calls: list, outs: list, n: int) -> None:
    """The path made `n` kNN-mask calls, and each output equals the plain
    version's on the inputs the path gave it, bit for bit, signbit
    included."""
    from acoss_tpu_torch.ops import crp_cuda

    if len(calls) != n:
        raise AssertionError(f"{name}: {len(calls)} kNN-mask calls, "
                             f"expected {n}")
    shapes = {}
    for ((W, k), kw), got in zip(calls, outs):
        want = crp_cuda.knn_mask_matrix_ref(W, k, **kw)
        if not (torch.equal(got, want)
                and torch.equal(torch.signbit(got), torch.signbit(want))):
            raise AssertionError(f"{name}: knn_mask kernel != plain on the "
                                 f"path's {tuple(W.shape)} W: "
                                 f"{int((got != want).sum())} cells differ")
        key = (tuple(W.shape), tuple(sorted(set(k.tolist()))))
        shapes[key] = shapes.get(key, 0) + 1
    _phase(name, "knn_mask kernel == plain bit for bit on the path's W: "
           + ", ".join(f"{c} x {shape} (k {ks})"
                       for (shape, ks), c in shapes.items()))


def _row_knn_path(name: str, algo, dev, fs, floors: dict,
                  extra_expect: dict | None = None, note: str = "") -> dict:
    """benchmark(algo) of a non-mutual row-kNN family that ends in qmax and
    dmax: one qmax and one dmax launch a tile (and `extra_expect`, such as
    the late SNF's kNN mask), MAP floors, every kNN-mask call of the run
    bit-equal to its plain version on the inputs it got, the first
    block-row recomputed by the plain versions, a tile's wall and device
    split."""
    from acoss_tpu_torch.convert import descriptors_from_numpy
    from acoss_tpu_torch.ops import crp_cuda

    T = _swept_tiles(fs.n_songs, algo.TILE)
    expect = {"qmax": T, "dmax": T, **(extra_expect or {})}
    calls, outs = [], []
    with _spy(crp_cuda, "knn_mask_matrix_batch", calls, outs):
        stats, Ds, times, counts = _benchmark_path(name, algo, dev, fs,
                                                   expect)
    _check_knn_calls(name, calls, outs, expect.get("knn_mask", 0))
    _check_map(name, stats, floors)
    _stage_lines(name, algo.NAME, dev, fs, stats, times, counts,
                 f", {T} tiles{note}")
    desc = descriptors_from_numpy(algo.desc, dev)
    n = _first_block_row(algo, desc, Ds, fs.n_songs)
    _phase(name, f"first block-row ({n} tiles) recomputed by the plain "
           f"versions on {dev}: identical scores")
    _phase(name, _tile_split(algo, *_tile(desc)))
    return counts


def phase_chen_fusion(dev, fs) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import ChenFusion

    # one (2, N, N) late SNF truncation
    return _row_knn_path("chen_fusion", _keeping(ChenFusion)(), dev, fs,
                         {"": 0.99}, {"knn_mask": 1})


def phase_tgalg(dev, fs) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import TGAlg

    return _row_knn_path("tgalg", _keeping(TGAlg)(), dev, fs,
                         {"tempogram_sflux": 0.15, "": 0.0},
                         note=" (JAX record MAP 0.26-0.27)")


# the JAX package's MAP records of the Struc* families on this corpus
# (RESULTS.md, covers80-scale table; one channel each, StrucLaplacian's
# for both): floors are these less 0.02, and less 0.05 for StrucLaplacian
JAX_STRUC_MAP = {"StrucFTM2D": 0.928, "StrucShingles": 0.992,
                 "StrucScattering": 1.000, "StructureLaplacian": 0.72}


def _struc_chunks(fs, fuse_features: tuple) -> tuple[int, dict]:
    """The fused-W chunks the corpus path makes (one kNN-mask launch
    each): every song's segment count (the onsets' segments of its
    shortest feature), its npad bucket, then chunks of BATCH_SIZE songs a
    bucket. Returns (chunks, {npad: songs})."""
    from acoss_tpu_torch.benchmarking.algorithms import struct_common as sc
    from acoss_tpu_torch.ops.segment import fix_frames

    feature = {"mfcc": "mfcc_htk", "hpcp": "hpcp", "tempogram": "snovfn"}
    songs = {}
    for i in range(fs.n_songs):
        on = fs.feature("onsets")[i, :fs.length("onsets")[i], 0]
        n = min(len(fix_frames(on, fs.length(feature[f])[i])) - 1
                for f in fuse_features)
        npad = max(-(-n // sc.BUCKET) * sc.BUCKET,
                   2 * sc.autotune_k(10, max(n, 2)), sc.BUCKET)
        songs[npad] = songs.get(npad, 0) + 1
    return (sum(-(-c // sc.BATCH_SIZE) for c in songs.values()),
            dict(sorted(songs.items())))


@contextlib.contextmanager
def _struc_stage_clock(module, seconds: dict):
    """Time the fused-W calls and the per-chunk `consume` of the Struc*
    corpus path (each ends at a device synchronize) while `module`'s
    `structural_fused_w_all` runs; the rest of the extraction is host
    prep (syncing the features, tempograms)."""
    from acoss_tpu_torch.benchmarking.algorithms import struct_common as sc

    real_all, real_fused = module.structural_fused_w_all, sc.fused_w_batch

    def clocked(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def fused_all(*args, consume, **kwargs):
        return real_all(*args, consume=clocked("consume", consume), **kwargs)

    module.structural_fused_w_all = fused_all
    sc.fused_w_batch = clocked("fused_w", real_fused)
    try:
        yield
    finally:
        module.structural_fused_w_all = real_all
        sc.fused_w_batch = real_fused


def _struc_path(name: str, algo, module, dev, fs, fuse: tuple,
                extra_expect: dict | None = None):
    """`benchmark(algo)` of a Struc* family at its defaults: every
    fused-W chunk's kNN-mask launch held bit for bit against the plain
    version, the launches checked against the chunks the npad buckets
    imply, MAP against the JAX record's floor, the N x N matrices finite
    with a zero diagonal, and the extraction split into host prep, fused
    W and the chunk stage. Returns (stats, times, counts)."""
    from acoss_tpu_torch.benchmarking.harness import benchmark
    from acoss_tpu_torch.ops import crp_cuda

    chunks, buckets = _struc_chunks(fs, fuse)
    expect = {"knn_mask": chunks, **(extra_expect or {})}
    calls, outs, stage, times = [], [], {}, {}
    torch.cuda.reset_peak_memory_stats()
    with _spy(crp_cuda, "knn_mask_matrix_batch", calls, outs), \
            _struc_stage_clock(module, stage):
        if algo.full_scores is None:
            stats, _, times, counts = _benchmark_path(name, algo, dev, fs,
                                                      expect)
        else:
            stats, counts = _counted(name, lambda: benchmark(
                algo, fs, device=dev, times=times), expect)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_knn_calls(name, calls, outs, chunks)
    n = fs.n_songs
    for k, D in algo.Ds.items():
        if D.shape != (n, n) or not np.isfinite(D).all() \
                or np.diag(D).any():
            raise AssertionError(f"{name} {k}: implausible score matrix")
    floor = JAX_STRUC_MAP[algo.NAME] - (0.05 if algo.full_scores is None
                                        else 0.02)
    _check_map(name, stats, {"": floor})
    # the kNN mask at the path's widest chunk, timed
    (W, k), kw = max(calls, key=lambda c: c[0][0].shape[-1])
    ms = _cuda_ms(lambda: crp_cuda.knn_mask_matrix_batch(W, k, **kw), 10)
    plain_ms = _cuda_ms(lambda: crp_cuda.knn_mask_matrix_ref(W, k, **kw), 3)
    del calls, outs, W
    prep = times["extract"] - stage["fused_w"] - stage["consume"]
    _stage_lines(name, algo.NAME, dev, fs, stats, times, counts,
                 f", {chunks} fused-W chunks (npad: songs {buckets})")
    _phase(name, f"extract split: host prep {prep:.2f} s, fused W (SNF) "
           f"{stage['fused_w']:.2f} s, chunk stage {stage['consume']:.2f} s;"
           f" peak device memory {peak:.2f} GiB; MAP floor {floor:.3f} "
           f"(JAX record {JAX_STRUC_MAP[algo.NAME]}); knn_mask on the "
           f"widest chunk: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return stats, times, counts


def _check_sparse_gram(name: str, desc: dict, dev) -> None:
    """The union Gram on the card (forced; at 160 songs the JAX package's
    dispatch takes scipy) against the host SpGEMM, both timed. The
    reference is the SpGEMM in float64: the fp32 SpGEMM itself is ~2e-5
    off it on these shingles (scores ~0.96-0.99), and so is the JAX
    package's own device path against the fp32 SpGEMM; the device Gram
    must be within rtol 1e-5 of the float64 one."""
    from acoss_tpu_torch.ops import sparse_gram

    args = (desc["idx"], desc["val"], desc["dim"])
    t0 = time.perf_counter()
    host = sparse_gram.host_gram_scores(*args)
    t_host = time.perf_counter() - t0
    want = sparse_gram.host_gram_scores(
        desc["idx"], [v.astype(np.float64) for v in desc["val"]],
        desc["dim"])
    sparse_gram.sparse_gram_scores(*args, force_device=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sparse_gram.sparse_gram_scores(*args, force_device=True,
                                         device=dev)
    t_dev = time.perf_counter() - t0

    def rel(a):
        return float(np.max(np.abs(a - want) / np.abs(want)))

    if not np.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"{name}: device sparse Gram off the float64 "
                             f"SpGEMM by {rel(got)} (relative)")
    usize = sparse_gram.compact_shingles(desc["idx"], desc["val"])[0]
    nnz = [len(ix) for ix in desc["idx"]]
    _phase(name, f"sparse Gram: device (forced) within rtol 1e-5 of the "
           f"float64 SpGEMM (max relative error {rel(got):.3g}; the fp32 "
           f"SpGEMM's {rel(host):.3g}); union {usize} of {desc['dim']} "
           f"columns, nnz a song {min(nnz)}..{max(nnz)}, scores "
           f"{float(got.min()):.4f}..{float(got.max()):.4f}; device "
           f"{1e3 * t_dev:.1f} ms, host fp32 {1e3 * t_host:.1f} ms (wall)")


def phase_struc_ftm2d(dev, fs) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import (StrucFTM2D,
                                                         StrucShingles,
                                                         struc_ftm2d)

    counts = {}
    for name, cls in (("struc_ftm2d", StrucFTM2D),
                      ("struc_shingles", StrucShingles)):
        algo = _keeping(cls)()
        _, _, counts[name] = _struc_path(name, algo, struc_ftm2d, dev, fs,
                                         cls.FUSE_FEATURES)
        _check_sparse_gram(name, algo.desc, dev)
    return counts


def phase_struc_scattering(dev, fs) -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import (StrucScattering,
                                                         struc_scattering)
    from acoss_tpu_torch.convert import descriptors_from_numpy

    t0 = time.perf_counter()
    algo = _keeping(StrucScattering)()
    t_init = time.perf_counter() - t0
    _, _, counts = _struc_path("struc_scattering", algo, struc_scattering,
                               dev, fs, ("mfcc", "hpcp", "tempogram"))
    desc = descriptors_from_numpy(algo.desc, dev)
    ms = _cuda_ms(lambda: algo.full_scores(desc), 10)
    _phase("struc_scattering", f"Scattering2D((512, 512), J=6, L=8) filter "
           f"bank built on the host in {t_init:.2f} s; full_scores (one "
           f"{tuple(desc['shingle'].shape)} Gram) {ms:.4f} ms")
    return counts


def phase_struc_laplacian(dev, fs) -> dict:
    """StrucLaplacian: the fused-W kNN mask a chunk, then qmax and dmax a
    tile (210 each), the first block-row recomputed by the plain
    versions, a tile's split, and one chunk's profile stage split into
    eigenvectors, k-means + meet and SVD (CUDA events)."""
    from acoss_tpu_torch.benchmarking.algorithms import (StrucLaplacian,
                                                         struc_laplacian)
    from acoss_tpu_torch.convert import descriptors_from_numpy
    from acoss_tpu_torch.ops import structure

    name = "struc_laplacian"
    algo = _keeping(StrucLaplacian)()
    T = _swept_tiles(fs.n_songs, algo.TILE)
    chunk_args = []

    real = struc_laplacian.laplacian_profile_batch

    def record(*args, **kwargs):
        if not chunk_args:
            chunk_args.append((args, kwargs))
        return real(*args, **kwargs)

    struc_laplacian.laplacian_profile_batch = record
    try:
        stats, _, counts = _struc_path(name, algo, struc_laplacian, dev, fs,
                                       ("mfcc", "hpcp", "tempogram"),
                                       {"qmax": T, "dmax": T})
    finally:
        struc_laplacian.laplacian_profile_batch = real
    # the same benchmark again in this process: the score matrices and
    # MAP must repeat bit for bit (the extraction is order-fixed)
    from acoss_tpu_torch.benchmarking.harness import benchmark

    again = _keeping(StrucLaplacian)()
    stats2 = benchmark(again, fs, device=dev)
    for k in algo.SIMILARITY_TYPES:
        if not np.array_equal(algo.Ds[k], again.Ds[k]) \
                or stats[k].map != stats2[k].map:
            raise AssertionError(
                f"{name} {k}: a second run differs (MAP {stats[k].map} / "
                f"{stats2[k].map}, {int((algo.Ds[k] != again.Ds[k]).sum())}"
                f" scores)")
    _phase(name, "a second benchmark() in this call: equal score matrices; "
           + ", ".join(f"{k} MAP {stats[k].map:.4f} / {stats2[k].map:.4f}"
                       for k in algo.SIMILARITY_TYPES))
    del again
    desc = descriptors_from_numpy(algo.desc, dev)
    n = _first_block_row(algo, desc, algo.Ds, fs.n_songs)
    _phase(name, f"first block-row ({n} tiles) recomputed by the plain "
           f"versions on {dev}: identical scores; profiles "
           f"{tuple(desc['profile'].shape)}, lengths "
           f"{int(desc['length'].min())}..{int(desc['length'].max())}")
    _phase(name, _tile_split(algo, *_tile(desc)))

    # one chunk's profile stage, stage by stage
    (W, beats, times, neigs, meet_pad), kw = chunk_args[0]
    split, out = {}, {}
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    for key, fn in (
            ("eigenvectors", lambda: structure.spectral_features(
                W, beats, neigs)),
            ("k-means + meet", lambda: structure.meet_matrices(
                out["eigenvectors"], beats, times, neigs, meet_pad,
                kw["songs"], kw["seed"])),
            ("SVD", lambda: structure.svd_curve(out["k-means + meet"][0],
                                                neigs))):
        torch.cuda.synchronize()
        start.record()
        out[key] = fn()
        end.record()
        end.synchronize()
        split[key] = start.elapsed_time(end)
    _phase(name, f"one chunk's profile stage ({tuple(W.shape)} W, meet "
           f"grid {meet_pad}): " + ", ".join(
               f"{k} {v:.1f} ms" for k, v in split.items()))
    return counts


# the JAX package's Serra09 MAP on the smoke's 16 placeholder WAVs (8
# cliques, seed 0), extracted and scored on the CPU by
#   JAX_PLATFORMS=cpu python scripts/covers80_parity.py --make-placeholder \
#     --placeholder-cliques 8 --cpu --only Serra09 --audio-dir covers32k \
#     --features feats.npz --csv results.csv
# (which writes the same bytes as `torch_covers80_placeholder.py`); the
# extract phase's floor is its chroma MAP less 0.02
JAX_PLACEHOLDER_MAP = {"chroma_qmax": 1.0, "chroma_dmax": 1.0,
                       "mfcc_qmax": 0.8839, "mfcc_dmax": 0.8839}
EXTRACT_STAGES = ("load", "hpcp", "crema", "cqt", "chord", "mfcc_htk",
                  "madmom", "beat_dp")


def _placeholder_script():
    """scripts/torch_covers80_placeholder.py of this checkout, as a
    module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / \
        "torch_covers80_placeholder.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _extract_stage_clock(seconds: dict):
    """Time the extraction's stages (each ends at a device synchronize)
    while the block runs: audio load, hpcp, crema (its cqt and the chord
    HMM inside), mfcc_htk, madmom (its beat DP inside; the rest are the
    two onset envelopes)."""
    from acoss_tpu_torch.features import chord, onsets, pipeline

    patches = [(pipeline, "load_audio", "load"), (pipeline, "hpcp", "hpcp"),
               (pipeline, "crema_substitute", "crema"),
               (chord, "cqt_tensor", "cqt"),
               (chord, "_posteriors", "chord"),
               (pipeline, "mfcc_htk", "mfcc_htk"),
               (pipeline, "madmom_features_substitute", "madmom"),
               (onsets, "beat_track_dp", "beat_dp")]

    def clocked(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    reals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for (m, n, key), (_, _, real) in zip(patches, reals):
        setattr(m, n, clocked(key, real))
    try:
        yield
    finally:
        for m, n, real in reals:
            setattr(m, n, real)


def _stage_text(seconds: dict, per: float) -> str:
    return ", ".join(f"{k} {seconds.get(k, 0.0) / per:.3f}"
                     for k in EXTRACT_STAGES)


def _hmm_check(name: str, le, lt, reps: int) -> dict:
    """hmm_fb on (T, C) emissions from the path: within atol 1e-5 of its
    plain version (timed on the same call) and of the plain model of its
    chunked algorithm, two calls bit-equal; its device ms over `reps`
    calls and each launch's; its bound (the algorithm's bytes and
    operations, not the chunk products' extra T C^3 multiply-adds)."""
    from acoss_tpu_torch.ops import hmm_cuda

    T, C = le.shape
    L = hmm_cuda.chunk_length(T, hmm_cuda._sm_count(le.device))
    got = hmm_cuda.chord_forward_backward(le, lt)
    again = hmm_cuda.chord_forward_backward(le, lt)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = hmm_cuda.chord_forward_backward_ref(le, lt)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    model = hmm_cuda.chord_forward_backward_chunked_ref(le, lt, L)
    err = float((got - want).abs().max())
    err_model = float((got - model).abs().max())
    if not (err <= 1e-5 and err_model <= 1e-5):
        raise AssertionError(f"{name}: hmm_fb on ({T}, {C}) off its plain "
                             f"version by {err}, off the chunked model by "
                             f"{err_model}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: hmm_fb does not repeat bit for bit")
    ms = _cuda_ms(lambda: hmm_cuda.chord_forward_backward(le, lt), reps)
    # (late in a full run torch.profiler records no kernels: then none)
    split = _kernel_split(lambda: hmm_cuda.chord_forward_backward(le, lt))
    split = f" ({split})" if split else ""
    # reads E and A once, writes gamma once; a step of either pass does
    # C^2 adds, maxes, subtractions, exps and sums (the rest is O(C))
    bound = _bound(4 * (2 * T * C + C * C), 2 * 5 * T * C * C)
    kernel = _kernel("hmm_fb", "hmm.cu", "none: acoss_tpu/features/"
                     "chord.py:72 (two lax.scans, no Pallas kernel)", err,
                     ms, plain_ms, bound)
    kernel.update(shape=[T, C], chunk=L)
    _phase(name, f"hmm_fb on ({T}, {C}) emissions, chunks of {L}: max abs "
           f"err {err:.3g} (plain), {err_model:.3g} (chunked model; atol "
           f"1e-5), two calls bit-equal; kernel {ms:.4f} ms{split}, "
           f"plain {plain_ms:.1f} ms, bound {bound[0]:.5f} ms ({bound[1]}; "
           f"the chunk products' {T * C ** 3 / 1e9:.2f} G multiply-adds "
           f"not counted)")
    return kernel


def phase_extract(dev) -> tuple[dict, dict]:
    """The extraction layer from audio: a 16-song placeholder WAV corpus
    (8 cliques, the port's copy of the placeholder recipe) through
    `batch_extract(device="cuda")` with the default profile (all 16 songs,
    an empty error log, one hmm_fb launch a song), seconds a stage a song
    and the peak device memory; hmm_fb against its plain version on the
    path's own emissions (`_hmm_check`); one 300 s song (the takes
    concatenated) stage by stage, and `_hmm_check` on its emissions; then
    `benchmark(Serra09)` on the extracted FeatureSet (fused CRP, qmax,
    dmax) against the JAX package's record on the same WAVs. Returns (hmm_fb's kernels entry, the
    extraction's launch counts)."""
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.features import chord, pipeline
    from acoss_tpu_torch.features.audio import load_audio

    name = "extract"
    script = _placeholder_script()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        script.make_placeholder(f"{tmp}/covers32k", seed=0, n_cliques=8)
        t_synth = time.perf_counter() - t0
        paths, labels = script.placeholder_paths(f"{tmp}/covers32k")
        errors = f"{tmp}/errors.txt"
        seconds, calls = {}, []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _extract_stage_clock(seconds), \
                _spy(chord, "chord_forward_backward", calls):
            fs, counts = _counted(name, lambda: pipeline.batch_extract(
                paths, labels, error_log=errors, device=dev),
                {"hmm_fb": len(paths)})
        t_all = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if fs.n_songs != len(paths) or os.path.exists(errors):
            raise AssertionError(f"{name}: {fs.n_songs} of {len(paths)} "
                                 f"songs extracted")
        audio = np.concatenate([load_audio(p) for p in paths])
    frames = fs.length("hpcp")
    _phase(name, f"{len(paths)} placeholder WAVs synthesized in "
           f"{t_synth:.1f} s; batch_extract on {dev}: {fs.n_songs} of "
           f"{len(paths)} songs, hpcp frames {int(frames.min())}.."
           f"{int(frames.max())}, {t_all:.2f} s ({t_all / len(paths):.3f} "
           f"s a song); launches hmm_fb {counts['hmm_fb']}; peak device "
           f"memory {peak:.2f} GiB")
    _phase(name, "seconds a song: " + _stage_text(seconds, len(paths)))

    # hmm_fb against its plain version on the first song's emissions
    (le, lt), _ = calls[0]
    kernel = _hmm_check(name, le, lt, reps=20)

    # one 300 s song: the takes concatenated
    song = audio[:300 * 44100]
    seconds, calls = {}, []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _extract_stage_clock(seconds), \
            _spy(chord, "chord_forward_backward", calls):
        feats = pipeline.compute_features(song, device=dev)
    t_song = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(feats[k]).all()
               for k in ("hpcp", "crema", "mfcc_htk")):
        raise AssertionError(f"{name}: non-finite features of the 300 s "
                             f"song")
    _phase(name, f"one {song.size / 44100:.0f} s song "
           f"({feats['hpcp'].shape[0]} hpcp frames): {t_song:.2f} s, "
           f"peak device memory {peak:.2f} GiB; seconds: "
           + _stage_text(seconds, 1))
    # and on the 300 s song's own emissions
    (le, lt), _ = calls[0]
    long_song = _hmm_check(name, le, lt, reps=10)
    kernel["long_song"] = {k: long_song[k] for k in (
        "shape", "chunk", "max_abs_err", "ms", "plain_ms", "bound_ms")}

    # Serra09 on the extracted features
    algo = Serra09()
    T = _swept_tiles(fs.n_songs, algo.TILE)
    stats, _, times, serra = _benchmark_path(
        "extract_serra09", algo, dev, fs,
        {"qmax": T, "dmax": T, "fused_crp": 2 * T})
    floors = {k: JAX_PLACEHOLDER_MAP[k] - 0.02 for k in JAX_PLACEHOLDER_MAP
              if k.startswith("chroma")}
    for k, floor in floors.items():
        if not stats[k].map >= floor:
            raise AssertionError(f"{name} Serra09 {k}: MAP {stats[k].map} "
                                 f"< {floor:.4f}")
    _phase(name, f"benchmark(Serra09) on the extracted features: launches "
           + ", ".join(f"{k} {v}" for k, v in serra.items()) + "; "
           + ", ".join(f"{k} MAP {s.map:.4f} (JAX CPU record "
                       f"{JAX_PLACEHOLDER_MAP[k]})" for k, s in stats.items())
           + f"; extract {times['extract']:.2f} s, sweep "
           f"{times['sweep']:.2f} s")
    return kernel, counts


# ---------------------------------------------------------------------------
# serving, process shards and coverstats
# ---------------------------------------------------------------------------

def _serra_launches(tiles: int) -> dict:
    """qmax, dmax and the fused CRP of `tiles` Serra09 tile calls."""
    return {"qmax": tiles, "dmax": tiles, "fused_crp": 2 * tiles}


def _ms_stats(seconds: list) -> str:
    ms = 1e3 * np.asarray(seconds)
    return (f"p50 {np.percentile(ms, 50):.2f} ms, p99 "
            f"{np.percentile(ms, 99):.2f} ms over {len(ms)} warm calls")


def phase_serving_fp32(dev, fs, Ds: dict) -> None:
    """An fp32 `CoverIndex.build` over the 160-song corpus answers the
    main path's swept scores: for each of the last 16 songs as a query,
    its row against every earlier song (the pairs the symmetric sweep
    scored with the query as the row song) bit for bit."""
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.serving import CoverIndex

    name = "serving_fp32"
    t0 = time.perf_counter()
    index = CoverIndex.build(Serra09(), fs, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    Q = np.arange(fs.n_songs - 16, fs.n_songs)
    t0 = time.perf_counter()
    S = index.query(fs.subset(Q))
    t_query = time.perf_counter() - t0
    for k in Serra09.SIMILARITY_TYPES:
        for i, q in enumerate(Q):
            if not np.array_equal(S[k][i, :q], Ds[k][q, :q]):
                raise AssertionError(
                    f"{name}: query {q} {k} != the main path's row at "
                    f"{int((S[k][i, :q] != Ds[k][q, :q]).sum())} pairs")
    _phase(name, f"CoverIndex.build(Serra09) over {fs.n_songs} songs "
           f"{t_build:.2f} s (extraction included); 16 queries "
           f"{t_query:.2f} s (extraction included); rows == the main "
           f"path's swept scores bit for bit on {int(Q.sum())} pairs a "
           f"channel")


def phase_serving(dev) -> dict:
    """The query path at Da-TACOS song geometry: a LazySyntheticCorpus of
    150 cliques x 13 + 66 distractors (2,016 songs); performance P_0 of
    cliques 0-15 held out as 16 queries, the other 2,000 songs the index.
    All 2,016 are extracted into one int8 store (queries last, so queries
    and corpus share one padded width); the CoverIndex is built from the
    store's first 2,000 rows as `load` builds it, saved and loaded back.
    The 16 query rows must equal the last two block-rows of a sweep of the
    whole store bit for bit, each query's top 10 on chroma_qmax must be
    members of its clique, and a query batch launches qmax, dmax and the
    fused CRP once, once and twice a corpus tile."""
    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.data import LazySyntheticCorpus
    from acoss_tpu_torch.data.descstore import extract_streamed
    from acoss_tpu_torch.serving import CoverIndex

    name = "serving"
    corpus = LazySyntheticCorpus(n_cliques=150, clique_size=13,
                                 n_distractors=66, base_duration=300.0)
    n = corpus.n_songs
    held = np.arange(16) * corpus.clique_size        # W_c/P_0, c < 16
    order = np.concatenate([np.setdiff1d(np.arange(n), held), held])
    nq, nc, T = len(held), n - len(held), Serra09.TILE
    labels, ids = corpus.labels[order], corpus.track_ids[order]
    if nc % T:
        raise AssertionError(f"{name}: {nc} corpus songs is not a whole "
                             f"number of tiles")

    class Reordered:
        """The corpus with the held-out queries last."""
        n_songs = n

        @staticmethod
        def subset(idx):
            return corpus.subset(order[np.asarray(idx)])

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store = extract_streamed(Serra09(), Reordered(), f"{tmp}/store",
                                 quant="int8", half_min_bytes=16384,
                                 device=dev)
        t_extract = time.perf_counter() - t0
        if not (store["chroma"].dtype == store["mfcc"].dtype == np.int8):
            raise AssertionError(f"{name}: the store is not int8")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = CoverIndex(Serra09(), {k: v[:nc] for k, v in store.items()},
                           nc, ids=[str(i) for i in ids[:nc]], device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        qdesc = {k: np.array(v[nc:]) for k, v in store.items()}

        def batch(m: int) -> dict:
            return {k: v[:m] for k, v in qdesc.items()}

        # cold: the first call at each batch width
        cold = {}
        for m in (1, T):
            t0 = time.perf_counter()
            index.query_descriptors(batch(m), m)
            cold[m] = time.perf_counter() - t0
        S, counts = _counted(name, lambda: index.query_descriptors(qdesc, nq),
                             _serra_launches(index.n_tiles))
        warm = {}
        for m in (1, T):
            warm[m] = []
            for _ in range(20):
                t0 = time.perf_counter()
                index.query_descriptors(batch(m), m)
                warm[m].append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        t0 = time.perf_counter()
        index.save(f"{tmp}/index")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = CoverIndex.load(Serra09(), f"{tmp}/index", device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        again = loaded.query_descriptors(qdesc, nq)
        for k in S:
            if not np.array_equal(again[k], S[k]):
                raise AssertionError(f"{name}: the loaded index answers "
                                     f"{k} differently from the built one")

        t0 = time.perf_counter()
        ref = harness.run_pairwise(
            Serra09(), store, n, device=dev, skip_symmetrize=True,
            tile_filter=lambda ti, tj: ti >= nc // T)
        t_sweep = time.perf_counter() - t0
        for k in Serra09.SIMILARITY_TYPES:
            want = ref[k][nc:, :nc]
            if not np.array_equal(S[k], want):
                raise AssertionError(
                    f"{name}: query rows {k} != the sweep's at "
                    f"{int((S[k] != want).sum())} pairs")
    for q in range(nq):
        top = np.argsort(-S["chroma_qmax"][q], kind="stable")[:10]
        if not (labels[top] == labels[nc + q]).all():
            raise AssertionError(f"{name}: query {ids[nc + q]}'s top 10 "
                                 f"holds {list(labels[top])}")
    _phase(name, f"{n} songs ({corpus.n_cliques} x {corpus.clique_size} + "
           f"{corpus.n_distractors}), {nq} held out; int8 store of all "
           f"{n} at width {store['chroma'].shape[1]}: extract "
           f"{t_extract:.2f} s; index of {nc} songs ({index.n_tiles} "
           f"tiles) build {t_build:.3f} s, save {t_save:.3f} s, load "
           f"{t_load:.3f} s (answers == the built index); launches a "
           f"{nq}-query batch " + ", ".join(f"{k} {v}" for k, v in
                                            counts.items()))
    _phase(name, f"query rows == the sweep's last {nq // T} block-rows "
           f"bit for bit ({t_sweep:.2f} s); every query's top 10 on "
           f"chroma_qmax in its own clique")
    for m in (1, T):
        p50 = float(np.percentile(warm[m], 50))
        _phase(name, f"nq={m}: cold {1e3 * cold[m]:.2f} ms, warm "
               f"{_ms_stats(warm[m])}; {m / p50:.2f} queries/s, "
               f"{m * nc / p50:.1f} scored pairs/s")
    _phase(name, f"peak device memory {peak:.2f} GiB")
    return counts


def _cli(args: list) -> tuple:
    """`python -m acoss_tpu_torch <args>` in this process: its exit code
    and standard output."""
    import io

    from acoss_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def _cli_maps(out: str) -> dict:
    """{channel: the MAP text} of the CLI's report lines."""
    return {ln.split(":")[0][len("Serra09_"):]: ln.split("MAP=")[1].split()[0]
            for ln in out.splitlines()
            if ln.startswith("Serra09_") and "MAP=" in ln}


def _check_cli_maps(what: str, out: str, Ds: dict, labels) -> None:
    from acoss_tpu_torch.benchmarking.evaluation import eval_statistics

    want = {k: f"{eval_statistics(np.asarray(D), labels).map:.4g}"
            for k, D in Ds.items()}
    got = _cli_maps(out)
    if got != want:
        raise AssertionError(f"{what}: MAP {got} != the unsharded sweep's "
                             f"{want}")


def phase_shards(dev, fs) -> dict:
    """Process-sharded sweeps of the 160-song corpus: four shard processes
    of `python -m acoss_tpu_torch benchmark --num-processes 4` at once,
    then the CLI's `--merge` (in this process), held to the unsharded
    sweep bit for bit (and its MAP); the four shards' launches, counted in this process, sum to the
    unsharded sweep's; then the same from a --stream-dir store with
    --hybrid-panel 64 (process 0 builds the store, the others reuse it)
    against the unsharded hybrid sweep; a missing shard and a 1-based id
    each return 1; one `--stage-times --profile` run."""
    import glob
    import shutil

    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.data.descstore import DescriptorStore
    from acoss_tpu_torch.parallel import (assign_block_rows, merge_partials,
                                          run_process_shard)

    name = "shards"
    n, T = fs.n_songs, Serra09.TILE
    n_tiles = -(-n // T)
    tiles = _swept_tiles(n, T)
    nproc, panel = 4, 64
    types = Serra09.SIMILARITY_TYPES
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        fsp = f"{tmp}/fs.npz"
        fs.save(fsp)
        common = ["benchmark", "-a", "Serra09", "-d", fsp, "-s", "shards",
                  "--device", str(dev)]
        algo = Serra09()
        desc = algo.extract_descriptors(fs, device=dev)
        ref = harness.run_pairwise(algo, desc, n, device=dev)

        # the shard processes, all at once; then the merge
        env = {**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.abspath(__file__))}
        cmd = [sys.executable, "-m", "acoss_tpu_torch"] + common

        def spawn(extra):
            return subprocess.Popen(cmd + extra, cwd=tmp, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        t0 = time.perf_counter()
        procs = [spawn(["--num-processes", str(nproc), "--process-id",
                        str(i), "--partial-dir", f"{tmp}/parts"])
                 for i in range(nproc)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_shards = time.perf_counter() - t0
        for i, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"{name}: shard process {i} exited "
                                     f"{p.returncode}: {err[-2000:]}")
        t0 = time.perf_counter()
        rc, merged_out = _cli(common + ["--merge", "--partial-dir",
                                        f"{tmp}/parts"])
        t_merge = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"{name}: the merge returned {rc}")
        _check_cli_maps(f"{name} merge", merged_out, ref, fs.labels)
        parts = sorted(glob.glob(f"{tmp}/parts/Serra09_part_*"))
        merged = merge_partials(parts)
        for k in types:
            if not np.array_equal(merged[k], ref[k]):
                raise AssertionError(f"{name}: the shard processes' merged "
                                     f"{k} != the unsharded sweep")

        # the same shards in this process, counted
        rows = assign_block_rows(n_tiles, nproc)
        total = dict.fromkeys(_serra_launches(0), 0)
        t0 = time.perf_counter()
        for i in range(nproc):
            _, c = _counted(f"{name} shard {i}", lambda: run_process_shard(
                algo, desc, n, i, nproc, f"{tmp}/inproc", device=dev),
                _serra_launches(int(sum(rows[i] + 1))))
            for k, v in c.items():
                total[k] += v
        t_inproc = time.perf_counter() - t0
        if total != _serra_launches(tiles):
            raise AssertionError(f"{name}: the shards launched {total}, the "
                                 f"unsharded sweep {_serra_launches(tiles)}")

        # from a --stream-dir store, whole 64-song panels a shard
        sd, p8 = f"{tmp}/stream", f"{tmp}/parts8"
        stream = ["--stream-dir", sd, "--stream-int8"]
        per_panel = panel // T
        prow = assign_block_rows(-(-n_tiles // per_panel), nproc)
        shard_tiles = [sum(ti + 1 for p in prow[i] for ti in range(
            p * per_panel, min((p + 1) * per_panel, n_tiles)))
            for i in range(nproc)]
        if sum(shard_tiles) != tiles:
            raise AssertionError(f"{name}: the panels hold {shard_tiles} "
                                 f"tiles, the sweep {tiles}")
        t0 = time.perf_counter()
        for i in range(nproc):
            (rc, out), _ = _counted(
                f"{name} hybrid shard {i}", lambda: _cli(
                    common + stream + ["--hybrid-panel", str(panel),
                                       "--num-processes", str(nproc),
                                       "--process-id", str(i),
                                       "--partial-dir", p8]),
                _serra_launches(shard_tiles[i]))
            if rc:
                raise AssertionError(f"{name}: hybrid shard {i} returned "
                                     f"{rc}")
        rc, out = _cli(common + stream + ["--merge", "--partial-dir", p8])
        t_hybrid = time.perf_counter() - t0
        if rc or "reusing descriptor store" not in out:
            raise AssertionError(f"{name}: the hybrid merge returned {rc}")
        store = DescriptorStore.open(f"{sd}/desc")
        href = harness.run_pairwise_hybrid(
            Serra09(), store, n, panel_songs=panel, device=dev,
            scores_dir=f"{tmp}/hybrid_ref")
        for k in types:
            if not np.array_equal(np.load(f"{sd}/merged/{k}.npy"),
                                  np.asarray(href[k])):
                raise AssertionError(f"{name}: the hybrid shards' merged "
                                     f"{k} != the unsharded hybrid sweep")
        _check_cli_maps(f"{name} hybrid merge", out, href, fs.labels)
        dtypes = sorted({str(v.dtype) for v in store.values()})

        # bad shard sets
        os.makedirs(f"{tmp}/missing")
        for p in parts:
            if not p.endswith("_part_2_4.npz"):
                shutil.copy(p, f"{tmp}/missing")
        bad = {"missing shard": common + ["--merge", "--partial-dir",
                                          f"{tmp}/missing"],
               "1-based id": common + ["--num-processes", str(nproc),
                                       "--process-id", str(nproc)]}
        for what, args in bad.items():
            with contextlib.redirect_stderr(open(os.devnull, "w")):
                rc, _ = _cli(args)
            if rc != 1:
                raise AssertionError(f"{name}: a {what} returned {rc}")

        # --stage-times and --profile
        t0 = time.perf_counter()
        rc, out = _cli(common + ["--no-checkpoint", "--stage-times",
                                 "--profile", f"{tmp}/prof"])
        t_prof = time.perf_counter() - t0
        trace = f"{tmp}/prof/trace.json"
        report = [ln for ln in out.splitlines()
                  if ln.split()[:1] and ln.split()[0] in
                  ("stage", "extract", "sweep", "sweep:tile", "sweep:flush",
                   "post_process", "eval")]
        if rc or not os.path.getsize(trace) or not any(
                ln.startswith("sweep:tile") for ln in report):
            raise AssertionError(f"{name}: --stage-times --profile gave rc "
                                 f"{rc}, report {report}")
        trace_mb = os.path.getsize(trace) / 2 ** 20
    _phase(name, f"{nproc} shard processes {t_shards:.2f} s (concurrent), "
           f"merge {t_merge:.2f} s: == the unsharded sweep bit for bit, "
           f"MAP " + ", ".join(f"{k} {v}" for k, v in
                               _cli_maps(merged_out).items()))
    _phase(name, f"in this process: {nproc} shards {t_inproc:.2f} s, "
           f"launches " + ", ".join(f"{k} {v}" for k, v in total.items())
           + f" == the unsharded sweep's ({tiles} tiles)")
    _phase(name, f"--stream-dir store ({', '.join(dtypes)}; the CLI "
           f"quantizes keys of >= 64 KB a song) + --hybrid-panel {panel}: "
           f"{nproc} shards ({shard_tiles} tiles, launches counted) and the "
           f"merge {t_hybrid:.2f} s, == the "
           f"unsharded hybrid sweep bit for bit, same MAP; a missing shard "
           f"and a 1-based id return 1")
    _phase(name, f"--stage-times --profile run {t_prof:.2f} s, trace "
           f"{trace_mb:.1f} MiB; " + " | ".join(
               " ".join(ln.split()) for ln in report))
    return total


@contextlib.contextmanager
def _clocked(targets: list, seconds: dict):
    """Time each (module, attribute) function while the block runs, ending
    each call at a device synchronize; seconds go to seconds[attribute]."""
    reals = [(m, a, getattr(m, a)) for m, a in targets]

    def clocked(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    for m, a, fn in reals:
        setattr(m, a, clocked(a, fn))
    try:
        yield
    finally:
        for m, a, fn in reals:
            setattr(m, a, fn)


def _mesh_calls(n: int, col_tile: int, shape=None, fold: int = 0) -> int:
    """The `tile_scores` calls the mesh decomposition implies for n songs:
    an (r, c) `shape` pads n to a multiple of lcm(r, c * col_tile) and
    gives each of its r * c blocks its column tiles; a fold over `fold`
    slots cuts 2 * fold chunks of a whole number of column tiles (at least
    one) and gives each slot 2 * fold + 1 chunk x chunk blocks. A block's
    rows go in sub-blocks of MAX_PAIRS_PER_CALL // col_tile songs."""
    import math

    from acoss_tpu_torch.parallel.mesh import MAX_PAIRS_PER_CALL

    sub = max(1, MAX_PAIRS_PER_CALL // col_tile)
    if fold:
        chunk = max(-(-n // (2 * fold)), col_tile)
        chunk = -(-chunk // col_tile) * col_tile
        return (fold * (2 * fold + 1) * -(-chunk // sub)
                * (chunk // col_tile))
    r, c = shape
    q = math.lcm(r, c * col_tile)
    n_pad = -(-n // q) * q
    return r * c * -(-(n_pad // r) // sub) * (n_pad // c // col_tile)


def phase_mesh(dev, fs, desc: dict, main_Ds: dict, main_rate: float,
               simple_D, smi: str) -> dict:
    """The device-mesh sweeps (`parallel.mesh`) at covers80 geometry over
    four slots of one card: `sharded_pair_scores` on a 2 x 2 grid (its
    strict lower triangle == the main path's matrices bit for bit) and
    `sharded_pair_scores_triangular` over 4 slots (its whole matrix == the
    main path's mirrored matrices bit for bit), and with four cards
    visible the same fold over cards 0-3 (the same); the CLI's `--mesh 2x2
    --device cuda:0` for Serra09 (the fold; MAP rows == the main path's)
    and for Simple (the rectangular branch; its matrix == the simple
    phase's off the diagonal); every path's fused-CRP / qmax / dmax
    launches == the tile calls the decomposition implies times the
    launches a call; then `dryrun_multichip(4, device="cuda:0")`. Prints
    each sweep's fully-scored pairs/s beside the main path's."""
    import io

    from acoss_tpu_torch import cli
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.entry import dryrun_multichip
    from acoss_tpu_torch.parallel import (make_pair_mesh, sharded_pair_scores,
                                          sharded_pair_scores_triangular)

    name = "mesh"
    n, T = fs.n_songs, Serra09.TILE
    card = torch.device(dev.type, 0)
    slots = [card] * 4
    algo = Serra09()
    pairs = n * (n - 1) // 2
    tril = np.tril_indices(n, -1)
    full = {}
    for k, D in main_Ds.items():
        low = np.tril(D, -1)
        full[k] = low + low.T
    n_calls = {"rect": _mesh_calls(n, T, shape=(2, 2)),
               "fold": _mesh_calls(n, T, fold=4)}
    sweeps = {"rect": lambda fn: sharded_pair_scores(
                  fn, desc, n, make_pair_mesh(slots, (2, 2)), col_tile=T),
              "fold": lambda fn: sharded_pair_scores_triangular(
                  fn, desc, n, devices=slots, col_tile=T)}
    cards = [torch.device(dev.type, i) for i in range(4)]
    if torch.cuda.device_count() >= 4:
        # the same fold over four distinct cards
        n_calls["fold4"] = n_calls["fold"]
        sweeps["fold4"] = lambda fn: sharded_pair_scores_triangular(
            fn, desc, n, devices=cards, col_tile=T)
    counts, seconds, computed = {}, {}, {}
    for what, sweep in sweeps.items():
        calls = []

        def counted(row, col):
            calls.append(row["length"].shape[0] * col["length"].shape[0])
            return algo.tile_scores(row, col)

        t0 = time.perf_counter()
        Ds, counts[what] = _counted(f"{name} {what}", lambda: sweep(counted),
                                    _serra_launches(n_calls[what]))
        seconds[what] = time.perf_counter() - t0
        computed[what] = sum(calls)
        if len(calls) != n_calls[what]:
            raise AssertionError(f"{name} {what}: {len(calls)} tile calls, "
                                 f"the decomposition implies "
                                 f"{n_calls[what]}")
        for k in algo.SIMILARITY_TYPES:
            got, want = (Ds[k][tril], main_Ds[k][tril]) if what == "rect" \
                else (Ds[k], full[k])
            if not np.array_equal(got, want):
                raise AssertionError(f"{name} {what} {k} != the main path's "
                                     f"matrix")
    if torch.cuda.current_device() != card.index:
        raise AssertionError(f"{name}: the sweeps left the current device "
                             f"at {torch.cuda.current_device()}")

    seen = {}
    real = cli._eval_and_report

    def keep(algo, Ds, *args, **kwargs):
        seen.update(Ds)
        return real(algo, Ds, *args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        fs.save(f"{tmp}/fs.npz")
        common = ["benchmark", "-d", f"{tmp}/fs.npz", "-s", "mesh",
                  "--mesh", "2x2", "--device", str(card)]
        t0 = time.perf_counter()
        (rc, out), counts["cli"] = _counted(
            f"{name} CLI", lambda: _cli(common + ["-a", "Serra09"]),
            _serra_launches(n_calls["fold"]))
        t_cli = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"{name}: the CLI returned {rc}")
        _check_cli_maps(f"{name} CLI", out, full, fs.labels)
        cli._eval_and_report = keep
        try:
            (rc, _), _ = _counted(f"{name} CLI Simple",
                                  lambda: _cli(common + ["-a", "Simple"]),
                                  {})
        finally:
            cli._eval_and_report = real
    off = ~np.eye(n, dtype=bool)
    if rc or not np.array_equal(seen["main"][off], simple_D[off]) \
            or seen["main"].diagonal().any():
        raise AssertionError(f"{name}: the CLI's rectangular Simple sweep "
                             f"(rc {rc}) != the simple phase's matrix")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4, device=str(card))
    t_dry = time.perf_counter() - t0
    line = buf.getvalue().strip()
    if not line.startswith("dryrun_multichip OK"):
        raise AssertionError(f"{name}: dryrun_multichip printed {line!r}")

    _phase(name, f"2x2 grid of {card}: {n_calls['rect']} tile calls, "
           f"{computed['rect']} pairs scored, strict lower triangle == the "
           f"main path's bit for bit; fold over 4 x {card}: "
           f"{n_calls['fold']} calls, {computed['fold']} pairs, whole matrix "
           f"== the main path's bit for bit; launches " + "; ".join(
               f"{w} " + ", ".join(f"{k} {v}" for k, v in c.items())
               for w, c in counts.items()))
    if "fold4" in seconds:
        _phase(name, f"fold over {', '.join(map(str, cards))}: "
               f"{n_calls['fold4']} calls, whole matrix == the main path's "
               f"bit for bit; {pairs / seconds['fold4']:.1f} pairs/s "
               f"({seconds['fold4']:.3f} s) against "
               f"{pairs / seconds['fold']:.1f} over 4 x {card}")
    else:
        _phase(name, f"{torch.cuda.device_count()} card(s) visible: no fold "
               f"over four distinct cards")
    _phase(name, f"CLI --mesh 2x2 --device {card}: Serra09 (fold) MAP rows "
           f"== the main path's ({t_cli:.2f} s with extraction), Simple "
           f"(rectangular) matrix == the simple phase's")
    _phase(name, f"{line} ({t_dry:.2f} s)")
    _phase(name, f"{smi}: fully-scored pairs/s ({pairs} pairs): main path "
           f"{main_rate:.1f}, 2x2 rect {pairs / seconds['rect']:.1f} "
           f"({seconds['rect']:.3f} s), fold over 4 "
           f"{pairs / seconds['fold']:.1f} ({seconds['fold']:.3f} s)")
    return {f"mesh_{w}": c for w, c in counts.items()}


def phase_coverstats(dev, fs) -> dict:
    """`python -m acoss_tpu_torch coverstats` over the 160-song corpus: the
    five default studies and `tag` (tags the smoke writes), no figures.
    The shape-DNA study launches the kNN row mask once a song; its first
    three launches equal the plain version bit for bit, and the first 8
    songs' eigenvalues from the card are within 1e-4 of the plain path's
    on the card."""
    from acoss_tpu_torch.analytics import coverstats as cs
    from acoss_tpu_torch.analytics import song_structure, studies
    from acoss_tpu_torch.ops import crp_cuda

    name = "coverstats"
    n = fs.n_songs
    rng = np.random.default_rng(0)
    vocab = ["rock", "pop", "jazz", "blues", "folk", "soul", "metal"]
    tags = {str(lbl): [[[str(t), float(c)] for t, c in zip(
        rng.choice(vocab, 3, replace=False), rng.random(3))]
        for _ in range(2)] for lbl in sorted(set(fs.labels))}
    real = crp_cuda.knn_mask_matrix_batch
    first = []

    def spy(W, k, largest=True):
        out = real(W, k, largest=largest)
        if len(first) < 3:
            first.append((W.clone(), k.clone(), largest, out.clone()))
        return out

    # the wrapper counts its launches through its module-level name
    spy.launches = 0
    seconds = {}
    targets = [(cs, "key_table"), (cs, "tempo_table"), (cs, "tag_stats"),
               (studies, "onset_timing_study"),
               (studies, "onset_stdev_study"),
               (studies, "shape_dna_study")]
    with tempfile.TemporaryDirectory() as tmp:
        fs.save(f"{tmp}/fs.npz")
        with open(f"{tmp}/tags.json", "w") as f:
            json.dump(tags, f)
        args = ["coverstats", "-d", f"{tmp}/fs.npz", "-o", f"{tmp}/out",
                "--studies", "key,tempo,onset,stdev,shapedna,tag",
                "--tags", f"{tmp}/tags.json", "--no-figures",
                "--device", str(dev)]
        crp_cuda.knn_mask_matrix_batch = spy
        try:
            with _clocked(targets, seconds):
                t0 = time.perf_counter()
                (rc, _), counts = _counted(name, lambda: _cli(args),
                                           {"knn_mask": n})
                t_all = time.perf_counter() - t0
        finally:
            crp_cuda.knn_mask_matrix_batch = real
        if rc:
            raise AssertionError(f"{name}: the CLI returned {rc}")
        with open(f"{tmp}/out/summary.json") as f:
            summary = json.load(f)
        with np.load(f"{tmp}/out/shapedna.npz") as z:
            ws = z["ws"]
    if set(summary["studies"]) != set(studies.ALL_STUDIES) \
            or ws.shape[0] != n or not np.isfinite(ws).all():
        raise AssertionError(f"{name}: summary {summary}, ws {ws.shape}")
    for W, k, largest, out in first:
        want = crp_cuda.knn_mask_matrix_ref(W, k, largest=largest)
        if not (torch.equal(out, want)
                and torch.equal(torch.signbit(out), torch.signbit(want))):
            raise AssertionError(f"{name}: knn_mask kernel != plain on a "
                                 f"{tuple(W.shape)} stack")
    ct = "hpcp"
    worst = 0.0
    for i in range(8):
        h = fs.feature(ct)[i, :fs.length(ct)[i]]
        m = fs.feature("mfcc_htk")[i, :fs.length("mfcc_htk")[i]]
        card = song_structure.get_shape_dna(h, m, device=dev)["w"]
        crp_cuda.knn_mask_matrix_batch = crp_cuda.knn_mask_matrix_ref
        try:
            plain = song_structure.get_shape_dna(h, m, device=dev)["w"]
        finally:
            crp_cuda.knn_mask_matrix_batch = real
        if not np.array_equal(card, ws[i]):
            raise AssertionError(f"{name}: song {i}'s eigenvalues do not "
                                 f"repeat")
        worst = max(worst, float(np.abs(card - plain).max()))
    if worst > 1e-4:
        raise AssertionError(f"{name}: eigenvalues {worst} from the plain "
                             f"path's")
    _phase(name, f"coverstats CLI, 6 studies over {n} songs {t_all:.2f} s: "
           + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
           + f"; knn_mask launches {counts.get('knn_mask', 0)} (one a "
           f"song), the first 3 == plain bit for bit on "
           f"{[tuple(w.shape) for w, *_ in first]}; 8 songs' eigenvalues "
           f"repeat the CLI's and are {worst:.3g} from the plain path's")
    _phase(name, "summary.json " + json.dumps(summary, sort_keys=True))
    return counts


def main() -> int:
    t_start = time.perf_counter()
    smi, kind = phase_environment()
    dev = torch.device("cuda")
    phase_build()
    kernels = {k["name"]: k for k in phase_aligners(dev)}
    phase_long_rows(dev)
    t0 = time.perf_counter()
    fs = _corpus()
    _phase("corpus", f"{fs.n_songs} songs, hpcp frames "
           f"{int(fs.length('hpcp').min())}..{int(fs.length('hpcp').max())}"
           f" ({time.perf_counter() - t0:.1f} s)")
    desc = _descriptors(dev, fs)
    kernels["fused_crp"] = phase_fused_crp(desc)
    launches = {}
    launches["main_path"], main_Ds, main_rate = phase_main_path(dev, fs,
                                                                desc)
    phase_serving_fp32(dev, fs, main_Ds)
    # qmax_uneq's entry is timed at its path's shapes, one CRP a launch
    # (phase_aligners printed its time on the bench batch)
    launches["legacy"], kernels["qmax_uneq"] = phase_legacy(dev, desc)
    snf_desc, launches["early_snf"] = phase_early_snf(dev, fs)
    for phase in (phase_binarize, phase_knn_mask, phase_wcsmssm):
        k = phase(snf_desc)
        kernels[k["name"]] = k
    launches["early_snf_fast"] = phase_early_snf_fast(dev, fs, snf_desc)
    launches["serra09_full"] = phase_serra09_full(dev, fs, snf_desc)
    del snf_desc
    ef_desc, launches["early_fusion"] = phase_early_fusion(dev, fs)
    kernels["sw"] = phase_sw(ef_desc)
    del ef_desc
    for name, phase in (("ftm2d", phase_ftm2d),
                        ("chen_fusion", phase_chen_fusion),
                        ("tgalg", phase_tgalg),
                        ("anf_scattering", phase_anf)):
        launches[name] = phase(dev, fs)
    launches["simple"], simple_D = phase_simple(dev, fs)
    t0 = time.perf_counter()
    launches.update(phase_mesh(dev, fs, desc, main_Ds, main_rate, simple_D,
                               smi))
    _phase("mesh", f"phase {time.perf_counter() - t0:.1f} s")
    del desc, main_Ds, simple_D
    for phase in (phase_struc_ftm2d, phase_struc_scattering,
                  phase_struc_laplacian):
        t0 = time.perf_counter()
        counts = phase(dev, fs)
        if phase is phase_struc_ftm2d:
            launches.update(counts)
        else:
            launches[phase.__name__[len("phase_"):]] = counts
        _phase(phase.__name__[len("phase_"):],
               f"phase {time.perf_counter() - t0:.1f} s")
    for name, phase in (("shards", phase_shards),
                        ("coverstats", phase_coverstats)):
        t0 = time.perf_counter()
        launches[name] = phase(dev, fs)
        _phase(name, f"phase {time.perf_counter() - t0:.1f} s")
    del fs
    launches["datacos_geometry"] = phase_datacos_geometry(dev)
    t0 = time.perf_counter()
    launches["serving"] = phase_serving(dev)
    _phase("serving", f"phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels["hmm_fb"], launches["extract"] = phase_extract(dev)
    _phase("extract", f"phase {time.perf_counter() - t0:.1f} s")
    # each kernel's launches are read from the path it was ported for
    for path, names in (("main_path", ("qmax", "dmax", "fused_crp")),
                        ("legacy", ("qmax_uneq",)),
                        ("early_snf", ("binarize", "knn_mask")),
                        ("early_snf_fast", ("wcsmssm",)),
                        ("early_fusion", ("sw",)),
                        ("extract", ("hmm_fb",))):
        for name in names:
            kernels[name]["launches"] = launches[path][name]
            kernels[name]["path"] = path
    # and the launches of every path that ran the kernel
    for name, k in kernels.items():
        k["paths"] = {path: c[name] for path, c in launches.items()
                      if c.get(name)}
    # the order of redesign work: the time each kernel spends above its
    # bound over its path's launches
    above = {k["name"]: k["launches"] * (k["ms"] - k["bound_ms"])
             for k in kernels.values()}
    _phase("above_bound", ", ".join(
        f"{name} {ms:.1f} ms" for name, ms in
        sorted(above.items(), key=lambda kv: -kv[1])))
    _phase("total",f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
