"""Time variants of the fused CRP, dmax, qmax, SW, unequal-gap qmax,
WCSMSSM, binarizer and kNN mask kernels on one card, each built from a
copy of `acoss_tpu_torch/csrc` with one constant changed, one phase
removed, (qmax) its row barrier replaced by hand-offs between warps or
(SW, unequal-gap qmax) the shared-memory kernel forced, beside the
sources as they are.

    python3 scripts/torch_kernel_variants.py [--out build/kernel_variants]
        [--kernels crp,dmax,qmax,sw,qmax_uneq,wcsmssm,binarize,knn_mask]

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Every variant is compiled (all at once) into its own library under --out
and called through ctypes with the C signatures of `_build.SIGNATURES`.
For each it prints the mean device ms a launch (CUDA events) at the
Serra09 main path's shapes: the fused CRP at B=64, 256 and 1,920, L=512,
d=12 and 13 (random features, lengths 260..470), with the device time of
each of its kernels from `torch.profiler` at B=64, and the variants that
keep its function also at L=128, 200, 256 and 384, B=64 and 256 (lengths
L/2..L: the bucketed and hybrid sweeps' and serving's narrower lines);
dmax and qmax at B=128, L=512 on
bench.py's CRP workload; WCSMSSM at B=64, L=512 (random SSMs and CSM,
lengths 260..470, K = trunc(0.095 (l1 + l2)), EarlySNF's budget), with
the device time of its stats and out launches; SW at EarlyFusion's
B=256, L=576 and unequal-gap qmax on 15 single-pair CRPs of the legacy
API's sizes (`_pred3_inputs`), with the blocks an SM holds of each
variant; the binarizer at the
EarlySNF tile's B=256, L=512 (standard normal matrices, a third of them
negated uniform ones with zeros, lengths 260..470), with the device time
of its row and strip launches; the kNN mask at B=128, n=1024 (uniform
[0, 1) with zeros outside a ragged block, k = trunc(0.095 (l1 + l2)) as
EarlySNF's, 49..89). Variants that keep the function are checked against
the plain versions (bit for bit, WCSMSSM within rtol 2e-5 / atol 2e-6);
the diagnostic ones (a phase removed) are not. Nothing under `csrc/` is
modified.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from acoss_tpu_torch.ops import _build, alignment_cuda, crp_cuda  # noqa: E402
from chip_smoke import _kernel_split  # noqa: E402

# the search's bracket off: bisection from the line's smallest key to the
# top of the key range, for every caller of warp_kth in the build
NO_BRACKET = [("if (jk == j + 1) mj = m[j];", "if (jk < 0) mj = m[j];")]
# the bracket's lower end raised to the smallest over the lanes of their
# j-th smallest keys (below it each lane holds at most j - 1 keys, fewer
# than k in all)
TIGHT_LOW = [("unsigned lo = min(__reduce_min_sync(kFull, m[0]), top);",
              "unsigned lo = min(__reduce_min_sync(kFull, jk <= J ? mj : "
              "m[0]), top);")]
SCALAR_STRIP = [("const int vec = L % 4 == 0 &&", "const int vec = L < 0 &&")]
# (name, [(text in csrc, its replacement)], whether it keeps the function)
# every shape of the fused CRP to the two launches (W through device
# memory), the design the one-launch cluster kernel replaced at L <= 512
CRP_TWO_LAUNCHES = [("  if (L <= 0 || L > kClusterThreads ||",
                     "  if (true || L > kClusterThreads ||")]
CRP_VARIANTS = [
    ("as is", [], True),
    ("two launches (W through device memory)", CRP_TWO_LAUNCHES, True),
    ("clusters of at least 2 blocks",
     [("for (int C = 1; C <= kMaxCluster;", "for (int C = 2; C <= kMaxCluster;")],
     True),
    ("clusters of at least 4 blocks",
     [("for (int C = 1; C <= kMaxCluster;", "for (int C = 4; C <= kMaxCluster;")],
     True),
    ("window sums 8 rows at once",
     [("kWindowRows = 4;", "kWindowRows = 8;")], True),
    ("diagnostic: no row search",
     [("        const unsigned t = line_kth(l2e, kr, [&](int t) {\n"
       "          return slab[(lane + 32 * t) * Rp + line];\n        });",
       "        const unsigned t = slab[lane * Rp + line];")], False),
    ("diagnostic: no column search",
     [("        const unsigned t = line_kth(l1e, kc, [&](int t) {\n"
       "          return ld_cluster(row[t] + 4u * c * Rp);\n        });",
       "        const unsigned t = ld_cluster(row[0] + 4u * c * Rp);")], False),
    ("diagnostic: no CSM",
     [("  float xy[U];\n#pragma unroll\n  for (int q = 0; q < kRegDims / 4; ++q) {"
       "\n    if (4 * q >= d) break;",
       "  float xy[U] = {};\n#pragma unroll\n  for (int q = 0; q < kRegDims / 4;"
       " ++q) {\n    if (4 * q >= 0) break;")], False),
    ("diagnostic: no window sums",
     [("  for (int q = 1; q < m; ++q)\n#pragma unroll\n    for (int u = 0; u < U;",
       "  for (int q = 1; q < 1; ++q)\n#pragma unroll\n    for (int u = 0; u < U;"
       )], False),
    ("diagnostic: no CRP stores",
     [("      if (c < L) Sr[c] = (c < l2e) & (v <= t_row) & (v <= tc[cc]);",
       "      if (c < 0) Sr[c] = (c < l2e) & (v <= t_row) & (v <= tc[cc]);")],
     False),
    ("diagnostic: every CRP all zero (launch, cluster start, stores)",
     [("  if (!(round_k(kappa, l2e) > 0.0f && round_k(kappa, l1e) > 0.0f)) {\n"
       "    zero_rows(Sb, L, r, C, L);",
       "  if (true) {\n    zero_rows(Sb, L, r, C, L);")], False),
]
DMAX_VARIANTS = [
    ("as is", [], True),
    ("8 columns a thread (2 warps a pair)",
     [("int cols = 4;", "int cols = 8;")], True),
    ("16 columns a thread (1 warp a pair)",
     [("int cols = 4;", "int cols = 16;")], True),
    ("2 stages",
     [("constexpr int kStages = 4;", "constexpr int kStages = 2;")], True),
    ("diagnostic: no cell arithmetic",
     [("        const float v = es[2 + k] != 0.0f ? m5 + 1.0f\n"
       "                                          : fmaxf(m5 - gap, 0.0f);",
       "        const float v = es[2 + k] + e1[k];")], False),
]
# qmax without its block barrier a row: each warp hands its last two
# values to the next warp through a ring of 4 slots, with an mbarrier each
# way (full: written; empty: read), so that warps may run a row apart; the
# stage of chunk c - 1 is refilled once every warp has arrived on its
# `empty` barrier, by thread 0 at the end of chunk c
QMAX_HANDOFF = [
    ("__device__ __forceinline__ void mbar_init(",
     "__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {\n"
     "  asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\"\n"
     "               :: \"r\"(smem_addr(bar)) : \"memory\");\n"
     "}\n\n"
     "__device__ __forceinline__ void mbar_init("),
    ("""  __shared__ uint64_t full[kStages];
  // the last two D values of each warp's run, double-buffered by row
  __shared__ float xch[2][kMaxBlock / 32][2];""",
     """  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float xch[4][kMaxBlock / 32][2];
  __shared__ uint64_t xfull[4][kMaxBlock / 32], xempty[4][kMaxBlock / 32];"""),
    ("""      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
      for (int c = 0; c < kStages && c < chunks; ++c)
        issue_chunk(Sb + (size_t)(2 + c * R) * N,""",
     """      const int nw = blockDim.x >> 5;
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], nw);
      }
      for (int s = 0; s < 4; ++s)
        for (int w = 0; w < nw; ++w) {
          mbar_init(&xfull[s][w], 1);
          mbar_init(&xempty[s][w], 1);
        }
      asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
      for (int c = 0; c < kStages && c < chunks; ++c)
        issue_chunk(Sb + (size_t)(2 + c * R) * N,"""),
    ("""      if (lane == 31) {
        xch[i & 1][warp][0] = d0[kCols - 2];
        xch[i & 1][warp][1] = d0[kCols - 1];
      }
      // every thread has read row i (and, at a chunk's last row, the
      // chunk), and the warps' last values are out
      __syncthreads();
      if (lane == 0 && warp > 0) {
        nl[0] = xch[i & 1][warp - 1][0];
        nl[1] = xch[i & 1][warp - 1][1];
      }
      if (threadIdx.x == 0) {
        nl[0] = nl[1] = 0.0f;
        // the chunk is consumed: its stage takes chunk c + kStages
        const int cn = c + kStages;
        if (r == R - 1 && cn < chunks)
          issue_chunk(Sb + (size_t)(2 + cn * R) * N,
                      Sb + (size_t)min(2 + (cn + 1) * R, m) * N,
                      stages + s * sb, &full[s]);
      }""",
     """      const int nw = blockDim.x >> 5, t = i - 2;
      const int slot = t % 4, use = t / 4;
      if (warp + 1 < nw) {
        if (use > 0) mbar_wait(&xempty[slot][warp], (use - 1) & 1);
        if (lane == 31) {
          xch[slot][warp][0] = d0[kCols - 2];
          xch[slot][warp][1] = d0[kCols - 1];
          mbar_arrive(&xfull[slot][warp]);
        }
      }
      if (r == R - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (warp > 0) {
        mbar_wait(&xfull[slot][warp - 1], use & 1);
        if (lane == 0) {
          nl[0] = xch[slot][warp - 1][0];
          nl[1] = xch[slot][warp - 1][1];
          mbar_arrive(&xempty[slot][warp - 1]);
        }
      }
      if (threadIdx.x == 0) {
        nl[0] = nl[1] = 0.0f;
        const int cn = c - 1 + kStages;
        if (r == R - 1 && c >= 1 && cn < chunks) {
          const int sp = (s + kStages - 1) % kStages;
          mbar_wait(&empty[sp], ((c - 1) / kStages) & 1);
          issue_chunk(Sb + (size_t)(2 + cn * R) * N,
                      Sb + (size_t)min(2 + (cn + 1) * R, m) * N,
                      stages + sp * sb, &full[sp]);
        }
      }"""),
]
QMAX_VARIANTS = [
    ("as is", [], True),
    ("warps hand off by mbarriers, no block barrier a row", QMAX_HANDOFF,
     True),
    ("8 columns a thread (2 warps a pair)",
     [("int cols = 4;", "int cols = 8;")], True),
    ("diagnostic: no cell arithmetic",
     [("          const float x = (v & (0xFFu << (8 * e))) != 0u\n"
       "                              ? pre + 1.0f\n"
       "                              : fmaxf(pre - gap, 0.0f);",
       "          const float x = p1 + (float)((v >> (8 * e)) & 1u);")],
     False),
]
WCSMSSM_VARIANTS = [
    ("as is", [], True),
    ("stats bands of 8 lines",
     [("for (int rb = 16; rb >= 8;", "for (int rb = 8; rb >= 8;")], True),
    ("stats bands of 32 lines",
     [("for (int rb = 16; rb >= 8;", "for (int rb = 32; rb >= 8;")], True),
    ("diagnostic: no stats search",
     [("const unsigned tk = warp_kth(key, k, kMaxFiniteUKey);",
       "const unsigned tk = key[0];")], False),
]
BINARIZE_VARIANTS = [
    ("as is", [], True),
    ("strips of 8 columns",
     [("for (int rb = 16; rb >= 8;", "for (int rb = 8; rb >= 8;")], True),
    ("strips of 32 columns",
     [("for (int rb = 16; rb >= 8;", "for (int rb = 32; rb >= 8;")], True),
    ("blocks of 4 warps (4 rows a row block)",
     [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
     True),
    ("blocks of 16 warps (16 rows a row block)",
     [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
     True),
    ("32 keys a lane at L = 512",
     [("auto run = kpl <= 16   ? binarize_lines<16>",
       "auto run = kpl <= 0    ? binarize_lines<16>")], True),
    ("plain bisection (no bracket)", NO_BRACKET, True),
    ("bracket's lower end from the lanes' j-th smallest keys", TIGHT_LOW,
     True),
    ("scalar strip loads and byte stores", SCALAR_STRIP, True),
    ("diagnostic: no row search",
     [("const unsigned t = warp_kth(key, k, kMaxFiniteUKey);\n"
       "  if (lane == 0) *out = t;",
       "if (lane == 0) *out = key[0];")], False),
    ("diagnostic: no column search",
     [("const unsigned t = warp_kth(key, k, kMaxFiniteUKey);\n"
       "      if (lane == 0) t_col[c] = t;",
       "if (lane == 0) t_col[c] = key[0];")], False),
    ("diagnostic: no search", [("const unsigned t = warp_kth(key, k, "
                                "kMaxFiniteUKey);",
                                "const unsigned t = key[0] + 0u * k;")],
     False),
]
KNN_MASK_VARIANTS = [
    ("as is", [], True),
    ("bracket from the lanes' 2 smallest keys (k <= 64)",
     [("constexpr int kMaskBracket = 4;", "constexpr int kMaskBracket = 2;")],
     True),
    ("bracket from the lanes' 8 smallest keys (k <= 256)",
     [("constexpr int kMaskBracket = 4;", "constexpr int kMaskBracket = 8;")],
     True),
    ("plain bisection (no bracket)", NO_BRACKET, True),
    ("bracket's lower end from the lanes' j-th smallest keys", TIGHT_LOW,
     True),
    ("blocks of 4 warps",
     [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
     True),
    ("diagnostic: no search",
     [("const unsigned t = warp_kth<K, kMaskBracket>(key, kk, kInfUKey);",
       "const unsigned t = key[0] + 0u * kk;")], False),
]
# unequal-gap qmax and SW: every build gets a C function that reports the
# blocks an SM holds of the kernel the entry point would launch at row
# length N (it follows the variant's own dispatch and stage count)
PRED3_OCCUPANCY = [("const char* acoss_error_string(int err) {", """\
int variant_blocks_per_sm(int sw, int N) {
  const bool registers = N <= kRegisterMaxN;
  const int cols = register_cols(N), threads = register_threads(N, cols);
  const size_t ring = (size_t)kStages * stage_bytes(N, cols);
  int blocks = -1;
  cudaError_t err;
  if (registers && sw)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pred3_kernel_at<SwRule>(cols), threads, ring);
  else if (registers)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pred3_kernel_at<QmaxUneqRule>(cols), threads, ring);
  else if (sw)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sw_kernel, kThreads, 3 * N * sizeof(float));
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, qmax_uneq_kernel, kThreads, 3 * N * sizeof(float));
  return err == cudaSuccess ? blocks : -1;
}

const char* acoss_error_string(int err) {""")]
PRED3_CELL = """\
        const float x = rule(match_at(u0, l0, k), p1, p2, p3,
                             match_at(u1, l1, k - 1),
                             match_at(u2, l2, k - 1),
                             match_at(u1, l1, k - 2));"""
PRED3_VARIANTS = [
    ("as is", [], True),
    ("the shared-memory kernel (the parent's design)",
     [("const bool registers = N <= kRegisterMaxN;",
       "const bool registers = false;")], True),
    ("2 stages",
     [("constexpr int kStages = 4;", "constexpr int kStages = 2;")], True),
    ("3 stages",
     [("constexpr int kStages = 4;", "constexpr int kStages = 3;")], True),
    ("8 columns a thread",
     [("int cols = 4;", "int cols = 8;")], True),
    ("diagnostic: no fp cell arithmetic (the four bits still tested)",
     [(PRED3_CELL,
       "        const float x = match_at(u0, l0, k) | match_at(u1, l1, k - 1)"
       "\n            | match_at(u2, l2, k - 1) | match_at(u1, l1, k - 2)"
       "\n            ? p1 + 1.0f : p2;")], False),
    ("diagnostic: no cell arithmetic",
     [(PRED3_CELL,
       "        const float x = match_at(u0, l0, k) ? p1 + 1.0f : p2;")],
     False),
]
SW_VARIANTS = [(name, PRED3_OCCUPANCY + subs, exact)
               for name, subs, exact in PRED3_VARIANTS]
QMAX_UNEQ_VARIANTS = SW_VARIANTS
CRP_SOURCES = ("crp.cu", "select.cuh", "device.cuh")
# (L, B): the narrower lines the variants that keep the function are also
# timed at, at B/4 and B pairs
CRP_NARROW = ((128, 256), (200, 256), (256, 256), (384, 256))
DMAX_SOURCES = ("alignment.cu", "device.cuh")
WCSMSSM_SOURCES = ("knn.cu", "select.cuh", "device.cuh")


def _start_build(out: str, name: str, sources, subs):
    """Copy `sources` from csrc with `subs` applied into out/name and start
    nvcc on them; returns (library path, process)."""
    d = os.path.join(out, name)
    os.makedirs(d)
    hits = set()
    for f in sources:
        text = (_build.CSRC / f).read_text()
        for a, b in subs:
            if a in text:
                hits.add(a)
                text = text.replace(a, b)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    missing = {a for a, _ in subs} - hits
    if missing:
        raise RuntimeError(f"{name}: not in the sources: {missing}")
    lib = os.path.join(d, "lib.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
           *[os.path.join(d, f) for f in sources if f.endswith(".cu")]]
    return lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)


def _load(lib: str, proc, entry: str):
    err = proc.communicate()[1]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {lib}:\n{err}")
    fn = getattr(ctypes.CDLL(lib), entry)
    fn.argtypes, fn.restype = _build.SIGNATURES[entry]
    return fn


def _ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _aligner(builds, variants, kind: str, entry: str, S, m, n, want):
    """Check and time each variant of an aligner kernel at B=128."""
    dev, B, L = S.device, S.shape[0], S.shape[2]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, _, exact in variants:
        fn = _load(*builds[kind, name], entry)

        def run():
            out = torch.empty(B, dtype=torch.float32, device=dev)
            _build.check(fn(S.data_ptr(), m.data_ptr(), n.data_ptr(), B, L,
                            L, 0.5, out.data_ptr(), dev.index, stream), name)
            return out

        if exact and not torch.equal(run(), want):
            raise AssertionError(f"{kind} {name}: != plain")
        print(f"{kind}, {name}: {_ms(run):.4f} ms", flush=True)


def _wcsmssm(builds, dev) -> None:
    """Check and time each WCSMSSM variant at B=64, L=512, with the split
    of its two launches."""
    rng = np.random.default_rng(2)
    B, L = 64, 512
    A, Bm, C = rng.random((3, B, L, L)).astype(np.float32)
    l1, l2 = (rng.integers(260, 471, B).astype(np.int32) for _ in "ab")
    K = (np.float32(0.095) * (l1 + l2).astype(np.float32)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (A, Bm, C, l1, l2, K)]
    want = crp_cuda.wcsmssm_ref(*args)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, _, exact in WCSMSSM_VARIANTS:
        fn = _load(*builds["wcsmssm", name], "acoss_wcsmssm")

        def run():
            stats = torch.empty((B, 4, L), dtype=torch.float32, device=dev)
            W = torch.empty((B, 2 * L, 2 * L), dtype=torch.float32,
                            device=dev)
            _build.check(fn(*(a.data_ptr() for a in args), B, L, 0.5,
                            stats.data_ptr(), W.data_ptr(), dev.index,
                            stream), name)
            return W

        if exact:
            torch.testing.assert_close(run(), want, rtol=2e-5, atol=2e-6)
        print(f"wcsmssm, {name}: {_ms(run):.4f} ms; by kernel: "
              f"{_kernel_split(run)}", flush=True)


def _binarize(builds, dev) -> None:
    """Check and time each binarizer variant at B=256, L=512, with the
    split of its two launches."""
    rng = np.random.default_rng(3)
    B, L = 256, 512
    D = rng.standard_normal((B, L, L)).astype(np.float32)
    fused = rng.random((B // 3, L, L)).astype(np.float32)
    fused[rng.random(fused.shape) < 0.3] = 0.0
    D[:B // 3] = -fused
    l1, l2 = (rng.integers(260, 471, B).astype(np.int32) for _ in "ab")
    D, l1, l2 = (torch.from_numpy(a).to(dev) for a in (D, l1, l2))
    want = crp_cuda.binarize_matrix_ref(D, l1, l2, 0.095)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, _, exact in BINARIZE_VARIANTS:
        fn = _load(*builds["binarize", name], "acoss_binarize")

        def run():
            thr = torch.empty((B, 2, L), dtype=torch.int32, device=dev)
            S = torch.empty((B, L, L), dtype=torch.uint8, device=dev)
            _build.check(fn(D.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, L,
                            0.095, thr.data_ptr(), S.data_ptr(), dev.index,
                            stream), name)
            return S

        if exact and not torch.equal(run(), want):
            raise AssertionError(f"binarize {name}: != plain")
        print(f"binarize, {name}: {_ms(run):.4f} ms; by kernel: "
              f"{_kernel_split(run)}", flush=True)


def _knn_mask(builds, dev) -> None:
    """Check and time each kNN mask variant at B=128, n=1024."""
    rng = np.random.default_rng(4)
    B, n = 128, 1024
    W = rng.random((B, n, n)).astype(np.float32)
    l1, l2 = (rng.integers(260, 471, B) for _ in "ab")
    for b in range(B):
        W[b, l1[b] + l2[b]:] = 0.0
        W[b, :, l1[b] + l2[b]:] = 0.0
    k = (np.float32(0.095) * (l1 + l2).astype(np.float32)).astype(np.int32)
    W, k = torch.from_numpy(W).to(dev), torch.from_numpy(k).to(dev)
    want = crp_cuda.knn_mask_matrix_ref(W, k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, _, exact in KNN_MASK_VARIANTS:
        fn = _load(*builds["knn_mask", name], "acoss_knn_mask")

        def run():
            V = torch.empty_like(W)
            _build.check(fn(W.data_ptr(), k.data_ptr(), B, n, 1,
                            V.data_ptr(), dev.index, stream), name)
            return V

        if exact and not torch.equal(run(), want):
            raise AssertionError(f"knn_mask {name}: != plain")
        print(f"knn_mask, {name}: {_ms(run):.4f} ms", flush=True)


def _pred3_inputs(kind: str, dev):
    """SW: one (256, 576, 576) stack as an EarlyFusion tile hands the
    kernel (lengths 385..561, density 0.08); qmax_uneq: 15 (1, M, N) CRPs
    as the legacy API hands it one a launch (sides 260..470, density
    0.1). Each batch is (S, m_len, n_len) on `dev`."""
    rng = np.random.default_rng(5)
    if kind == "sw":
        B, L = 256, 576
        m, n = (rng.integers(385, 562, B).astype(np.int32) for _ in "ab")
        S = np.zeros((B, L, L), np.uint8)
        for b in range(B):
            S[b, :m[b], :n[b]] = rng.random((m[b], n[b])) < 0.08
        shapes = [(S, m, n)]
    else:
        shapes = []
        for _ in range(15):
            mm, nn = (int(x) for x in rng.integers(260, 471, 2))
            S = (rng.random((1, mm, nn)) < 0.1).astype(np.uint8)
            shapes.append((S, np.array([mm], np.int32),
                           np.array([nn], np.int32)))
    return [[torch.from_numpy(a).to(dev) for a in batch] for batch in shapes]


def _pred3(builds, kind: str, dev) -> None:
    """Check and time each variant of the SW or unequal-gap qmax kernel
    (the mean ms a launch over the batches of `_pred3_inputs`), with the
    blocks an SM holds of it at the batches' row length."""
    entry, params = {"sw": ("acoss_sw", (-0.5, -0.7, 1.0, -1.0)),
                     "qmax_uneq": ("acoss_qmax_uneq", (0.3, 0.8))}[kind]
    ref = {"sw": alignment_cuda.swconstrained_batch_ref,
           "qmax_uneq": alignment_cuda.qmax_uneq_batch_ref}[kind]
    batches = _pred3_inputs(kind, dev)
    wants = [ref(*a, *params) for a in batches]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, _, exact in KINDS[kind][0]:
        lib, proc = builds[kind, name]
        fn = _load(lib, proc, entry)
        occ = ctypes.CDLL(lib).variant_blocks_per_sm
        occ.argtypes, occ.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int

        def run():
            outs = []
            for S, m, n in batches:
                B, M, N = S.shape
                out = torch.empty(B, dtype=torch.float32, device=dev)
                _build.check(fn(S.data_ptr(), m.data_ptr(), n.data_ptr(), B,
                                M, N, *params, out.data_ptr(), dev.index,
                                stream), name)
                outs.append(out)
            return outs

        if exact and not all(torch.equal(g, w) for g, w in zip(run(), wants)):
            raise AssertionError(f"{kind} {name}: != plain")
        blocks = {occ(kind == "sw", int(a[0].shape[2])) for a in batches}
        print(f"{kind}, {name}: {_ms(run) / len(batches):.4f} ms a launch; "
              f"blocks an SM {sorted(blocks)}", flush=True)


# kind: (variants, sources) of every kernel this script times
KINDS = {"crp": (CRP_VARIANTS, CRP_SOURCES),
         "dmax": (DMAX_VARIANTS, DMAX_SOURCES),
         "qmax": (QMAX_VARIANTS, DMAX_SOURCES),
         "sw": (SW_VARIANTS, DMAX_SOURCES),
         "qmax_uneq": (QMAX_UNEQ_VARIANTS, DMAX_SOURCES),
         "wcsmssm": (WCSMSSM_VARIANTS, WCSMSSM_SOURCES),
         "binarize": (BINARIZE_VARIANTS, WCSMSSM_SOURCES),
         "knn_mask": (KNN_MASK_VARIANTS, WCSMSSM_SOURCES)}


def _crp_inputs(dev, L: int, B: int, lo: int, hi: int, seed: int) -> list:
    """[X, Y, l1, l2] at d = 12 and 13: standard normal features, lengths
    lo .. hi."""
    rng = np.random.default_rng(seed)
    out = []
    for d in (12, 13):
        l1, l2 = (rng.integers(lo, hi + 1, B).astype(np.int32) for _ in "ab")
        X, Y = (rng.standard_normal((B, L, d)).astype(np.float32)
                for _ in "ab")
        out.append([torch.from_numpy(a).to(dev) for a in (X, Y, l1, l2)])
    return out


def _crp(builds, dev) -> None:
    """Check and time each fused CRP variant at L=512, B=64, 256 and 1,920
    (lengths 260..470), with the split of its launches at B=64; those that
    keep the function also at the narrower lines of the bucketed and
    hybrid sweeps and serving (`CRP_NARROW`, lengths L/2..L)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    wide = _crp_inputs(dev, 512, 64, 260, 470, 1)
    narrow = {L: _crp_inputs(dev, L, B, L // 2, L, L)
              for L, B in CRP_NARROW}
    for name, _, exact in CRP_VARIANTS:
        fn = _load(*builds["crp", name], "acoss_fused_crp")

        def fused(X, Y, l1, l2):
            B, L, d = X.shape
            W = torch.empty((B, L, L), dtype=torch.float32, device=dev)
            t_row = torch.empty((B, L), dtype=torch.int32, device=dev)
            S = torch.empty((B, L, L), dtype=torch.uint8, device=dev)
            _build.check(fn(X.data_ptr(), Y.data_ptr(), l1.data_ptr(),
                            l2.data_ptr(), B, L, d, 9, 0.095,
                            W.data_ptr(), t_row.data_ptr(), S.data_ptr(),
                            dev.index, stream), name)
            return S

        def check(a):
            if exact and not torch.equal(
                    fused(*a), crp_cuda.fused_binary_crp_ref(*a, 0.095, 9)[0]):
                raise AssertionError(f"fused CRP {name}: != plain at "
                                     f"{tuple(a[0].shape)}")

        times = {}
        for a in wide:
            check(a)
            for n in (1, 4, 30):    # B = 64, 256 (a stream tile), 1,920
                big = [t.repeat(n, *[1] * (t.ndim - 1)) for t in a]
                times.setdefault(64 * n, []).append(
                    _ms(lambda: fused(*big), 10 if n > 1 else 30))
                del big
        split = _kernel_split(lambda: fused(*wide[0]))
        print(f"fused CRP, {name}, L=512: " + "; ".join(
            f"B={B} d=12 {t[0]:.4f} ms, d=13 {t[1]:.4f} ms"
            for B, t in times.items())
            + f"; B=64 d=12 by kernel: {split}", flush=True)
        if not exact:
            continue
        for L, B in CRP_NARROW:
            row = []
            for a in narrow[L]:
                check(a)
                for n in (B // 4, B):
                    sub = [t[:n] for t in a]
                    row.append((n, a[0].shape[2], _ms(lambda: fused(*sub))))
            print(f"fused CRP, {name}, L={L} (cluster of "
                  f"{crp_cuda.fused_crp_cluster(L, 12, 9)} as is): "
                  + "; ".join(f"B={n} d={d} {ms:.4f} ms" for n, d, ms in
                              sorted(row)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/kernel_variants")
    ap.add_argument("--kernels", default=",".join(KINDS))
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    shutil.rmtree(args.out, ignore_errors=True)
    builds = {(kind, n): _start_build(args.out, f"{kind}{i}", KINDS[kind][1],
                                      s)
              for kind in kinds
              for i, (n, s, _) in enumerate(KINDS[kind][0])}
    dev = torch.device("cuda", torch.cuda.current_device())
    for kind in ("sw", "qmax_uneq"):
        if kind in kinds:
            _pred3(builds, kind, dev)
    if "binarize" in kinds:
        _binarize(builds, dev)
    if "knn_mask" in kinds:
        _knn_mask(builds, dev)
    if "wcsmssm" in kinds:
        _wcsmssm(builds, dev)
    if "crp" in kinds:
        _crp(builds, dev)
    L = 512
    rng = np.random.default_rng(0)
    m = rng.integers(320, L + 1, 128).astype(np.int32)
    n = rng.integers(320, L + 1, 128).astype(np.int32)
    S = np.zeros((128, L, L), np.uint8)
    for b in range(128):
        S[b, :m[b], :n[b]] = rng.random((m[b], n[b])) < 0.095
    S, m, n = (torch.from_numpy(a).to(dev) for a in (S, m, n))
    if "dmax" in kinds:
        _aligner(builds, DMAX_VARIANTS, "dmax", "acoss_dmax", S, m, n,
                 alignment_cuda.dmax_batch_ref(S, m, n))
    if "qmax" in kinds:
        _aligner(builds, QMAX_VARIANTS, "qmax", "acoss_qmax", S, m, n,
                 alignment_cuda.qmax_batch_ref(S, m, n))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
