// Local alignment over a batch of binary CRPs: Serra Qmax (equal and
// unequal gaps), Chen Dmax and constrained Smith-Waterman.
//
// Replaces the TPU kernels of `acoss_tpu/ops/alignment_pallas.py`:
// `_qmax_kernel` (:65), `_qmax_kernel_uneq` (:101), `_dmax_kernel` (:152)
// and `_sw_kernel` (:196), and computes exactly what the length-masked
// scans of `acoss_tpu_torch.ops.alignment` compute: `qmax_batch` /
// `dmax_batch` with gap_onset == gap_extension == gap, `qmax_batch` with
// unequal gaps, and `swconstrained_batch`.
//
// What bounds it on the H100: the recurrence is serial over the M rows
// (row i needs rows i-1..i-3), so each pair is a chain of M dependent row
// steps of N independent cells. The work per cell is a handful of fp32
// max/add operations, and the CRP is read once (B*M*N bytes), so neither
// memory bandwidth nor arithmetic is the limit: the latency of one row step
// times M is. A row step that waits for its CRP row to come from device
// memory, or for every thread of a large block, takes ~0.5 us.
//
// qmax and dmax (the Serra09 main path's): one block per pair, each thread
// owning a run of kCols consecutive columns (128 threads x 4 at N = 512).
// The D rows the cell reads (i-1, i-2; dmax also i-3 and the S rows i-1,
// i-2 it adds) live in registers; the values left of the run (D row i-1 at
// j0-2..j0-1 and row i-2 at j0-1; dmax one more of each) come from the
// next lane down by __shfl_up_sync, and across a warp boundary through a
// shared slot, so a row step has no shared-memory D traffic. The CRP
// arrives ahead of the recurrence: thread 0 keeps kStages chunks of up to
// 16 rows in flight as TMA bulk copies (cp.async.bulk) into a ring of
// shared-memory stages, each completing on its own mbarrier, so the
// threads wait once a chunk, never on device memory, and read each row
// as one 32-bit word of 4 columns. dmax converts its bytes to floats
// (it adds them); qmax only tests them for a match, in the word. What is
// left is the row step itself, closed by one block barrier (four warps at
// N = 512), one SM a pair. (Handing the slots from warp to warp through an
// mbarrier each way, so that warps may run a row apart, measured slower:
// the waits and arrivals cost more than the barrier.)
//
// unequal-gap qmax and SW (`pred3_kernel`, one template over the cell
// rule): qmax's design. The three predecessors are qmax's; what differs is
// that each predecessor's penalty depends on its own S, so the ring starts
// at row 0 (rows 0 and 1 compute no cell, but their S sets row 2's
// penalties), and each thread keeps, beside its D rows i-1 and i-2, the
// CRP words of those rows: its run's words and the 2 bytes left of the run
// (read from the stage, not exchanged). Every bit is tested in its word; a
// row step reads its stage once and touches no device memory.
//
// Rows longer than the registers hold (N > kRegisterMaxN) take the
// shared-memory kernels (`qmax_uneq_kernel`, `sw_kernel`): threads
// striding over the N columns, three D rows in shared memory as a ring,
// the CRP bytes and the predecessors' S read through the L1 cache, and one
// __syncthreads() per row. The C entry points choose by shape.
//
// In all four, cells outside (m_len, n_len) are never computed (they stay
// 0), so the kernels need no zero-padding argument and no guard on the
// gaps. Each thread keeps a running max, reduced over the block at the
// end. Every operation is the same fp32 operation in the same order as the
// plain version (the additions as __fadd_rn / __fsub_rn where a product
// could be contracted), or a max taken before an addition where rounding's
// monotonicity makes the two equal, so the scores are bit-equal to it,
// also where the gaps (SW's -0.7) are not exact in fp32.
//
// The TPU kernels' transposed pair-on-lane layout, pre-rolled carries,
// -BIG row/column biases and block_b/block_t tiling are TPU choices and are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;

// Max over the block; the result is valid in thread 0.
__device__ float block_max(float v) {
  __shared__ float red[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

// qmax and dmax: one block per pair, each thread owning kCols consecutive
// columns; the D rows live in registers, the CRP rows arrive in a ring of
// shared-memory stages by TMA bulk copies (see the note at the top).
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 4;        // chunks of CRP rows in flight
constexpr int kMaxBlock = 512;    // threads a pair (registers: 128 each)
constexpr int kRegisterMaxN = 32 * kMaxBlock;   // at most 32 columns each
constexpr int kStageBudget = 96 * 1024;   // bytes of all the stages

// Rows a chunk holds at row length N, and the bytes of one stage: the
// chunk's rows after up to 15 bytes of alignment offset, plus slack for
// the runs that reach past N and the last word a run's reads touch.
__host__ __device__ __forceinline__ int chunk_rows(int N) {
  const int r = kStageBudget / kStages / (N > 0 ? N : 1);
  return r < 1 ? 1 : r > 16 ? 16 : r;
}

__host__ __device__ __forceinline__ int stage_bytes(int N, int cols) {
  return (16 + chunk_rows(N) * N + 32 * cols + 16 + 15) & ~15;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Thread 0 only: copy CRP bytes [start, stop) of global memory into the
// stage, byte g to stage[(start & 15) + g - start]. The 16-byte aligned
// interior goes by one TMA bulk copy that completes on `bar`; the few
// bytes before and after it are copied by this thread, before its arrive
// (whose release makes them visible with the copy).
__device__ void issue_chunk(const uint8_t* start, const uint8_t* stop,
                            uint8_t* stage, uint64_t* bar) {
  const uintptr_t s = (uintptr_t)start, e = (uintptr_t)stop;
  uintptr_t a = (s + 15) & ~(uintptr_t)15, z = e & ~(uintptr_t)15;
  if (a >= z) a = z = e;               // too short: all by this thread
  uint8_t* dst = stage + (s & 15);        // dst[g - s] is the slot of g
  for (uintptr_t g = s; g < a; ++g) dst[g - s] = *(const uint8_t*)g;
  for (uintptr_t g = z; g < e; ++g) dst[g - s] = *(const uint8_t*)g;
  const unsigned bytes = (unsigned)(z - a);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst + (a - s))), "l"((const void*)a), "r"(bytes),
           "r"(smem_addr(bar))
        : "memory");
}

// Byte c of w as a float, exactly: the bits of 2^23 + byte, less 2^23
// (a byte permute and an add, where a conversion would take a slower
// unit).
__device__ __forceinline__ float byte_float(uint32_t w, int c) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, c | 0x7540)) -
         8388608.0f;
}

// The 4 bytes at byte offset q of a word array.
__device__ __forceinline__ uint32_t bytes4(const uint32_t* w, int q) {
  const uint32_t lo = w[q >> 2];
  if ((q & 3) == 0) return lo;
  return __funnelshift_r(lo, w[(q >> 2) + 1], 8 * (q & 3));
}

// The max of the block's `best`s, written to *out by thread 0; red holds
// one float a warp.
__device__ __forceinline__ void store_block_max(float best, float* red,
                                                float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_down_sync(kFull, best, o));
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nwarps = blockDim.x >> 5;
    for (int w = 1; w < nwarps; ++w) best = fmaxf(best, red[w]);
    *out = best;
  }
}

template <int kCols>
__global__ void __launch_bounds__(kMaxBlock)
dmax_kernel(const uint8_t* __restrict__ S, const int* __restrict__ m_len,
            const int* __restrict__ n_len, int M, int N, float gap,
            float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t stages[];
  __shared__ uint64_t full[kStages];
  // the last three D values of each warp's run, double-buffered by row
  __shared__ float xch[2][kMaxBlock / 32][3];
  __shared__ float red[kMaxBlock / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = min(m_len[b], M), n = min(n_len[b], N);
  const int j0 = threadIdx.x * kCols;
  const int R = chunk_rows(N), sb = stage_bytes(N, kCols);
  const uint8_t* Sb = S + (size_t)b * M * N;
  float best = 0.0f;
  if (m_len[b] >= 4 && n_len[b] >= 4) {
    // chunk c holds rows 1 + c*R .. 1 + (c+1)*R - 1 (row 0 is never read)
    const int chunks = (m - 1 + R - 1) / R;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int c = 0; c < kStages && c < chunks; ++c)
        issue_chunk(Sb + (size_t)(1 + c * R) * N,
                    Sb + (size_t)min(1 + (c + 1) * R, m) * N,
                    stages + c * sb, &full[c]);
    }
    __syncthreads();
    // D rows i-1, i-2, i-3 of the run, and of the columns left of it:
    // ld1 at j0-3 .. j0-1 (row i-1), ld2 and ld3 at j0-1 (rows i-2, i-3);
    // f1, f2: S rows i-1 and i-2 of the run as floats
    float d1[kCols], d2[kCols], d3[kCols], f1[kCols], f2[kCols];
    float ld1[3] = {0.0f, 0.0f, 0.0f}, ld2 = 0.0f, ld3 = 0.0f;
    bool ok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      d1[c] = d2[c] = d3[c] = f1[c] = f2[c] = 0.0f;
      ok[c] = j0 + c >= 3 && j0 + c < n;
    }
    // row i is row r of chunk c, in stage s; the run's bytes of row i
    // start at byte q of the stage, 4-aligned for every row and chunk
    // when S and N are
    int c = 0, r = 0, s = 0;
    int q = (int)((uintptr_t)(Sb + N) & 15) + j0;
    const bool aligned = ((uintptr_t)Sb & 3) == 0 && (N & 3) == 0;
    for (int i = 1; i < m; ++i) {
      if (r == 0) mbar_wait(&full[s], (c / kStages) & 1);
      // S row i: es[2 + k] = S[i, j0 + k], es[0..1] = S[i, j0-2 .. j0-1]
      const uint32_t* w = reinterpret_cast<const uint32_t*>(stages + s * sb);
      float es[kCols + 2];
      const uint32_t left = j0 < 4 ? 0u
                            : aligned ? w[(q >> 2) - 1] >> 16
                                      : bytes4(w, q - 2);
      es[0] = byte_float(left, 0);
      es[1] = byte_float(left, 1);
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const uint32_t v = aligned ? w[(q >> 2) + g] : bytes4(w, q + 4 * g);
#pragma unroll
        for (int e = 0; e < 4; ++e) es[2 + 4 * g + e] = byte_float(v, e);
      }
      // e1[3 + k] = D[i-1, j0 + k], e1[0..2] = D[i-1, j0-3 .. j0-1]
      float e1[kCols + 3];
      e1[0] = ld1[0];
      e1[1] = ld1[1];
      e1[2] = ld1[2];
#pragma unroll
      for (int k = 0; k < kCols; ++k) e1[3 + k] = d1[k];
      float d0[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float a1 = f1[k];                   // S[i-1, j]
        const float a2 = f2[k];                   // S[i-2, j]
        const float c1 = es[1 + k];               // S[i, j-1]
        const float c2 = es[k];                   // S[i, j-2]
        const float p1 = e1[2 + k];
        const float p2 = (k == 0 ? ld2 : d2[k - 1]) + a1;
        const float p3 = e1[1 + k] + c1;
        const float p4 = ((k == 0 ? ld3 : d3[k - 1]) + a2) + a1;
        const float p5 = (e1[k] + c2) + c1;
        const float m5 = fmaxf(fmaxf(fmaxf(p1, p2), p3), fmaxf(p4, p5));
        // max over paths of (p - gap) == (max over paths of p) - gap: a
        // rounded subtraction is monotone, so this is exact.
        const float v = es[2 + k] != 0.0f ? m5 + 1.0f
                                          : fmaxf(m5 - gap, 0.0f);
        // rows 0..2 stay 0: the recurrence starts at row 3
        d0[k] = ok[k] && i >= 3 ? v : 0.0f;
        best = fmaxf(best, d0[k]);
      }
      // the run's last three values go to the next thread's ld1
      float nl[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        nl[k] = __shfl_up_sync(0xffffffffu, d0[kCols - 3 + k], 1);
      if (lane == 31) {
#pragma unroll
        for (int k = 0; k < 3; ++k) xch[i & 1][warp][k] = d0[kCols - 3 + k];
      }
      // every thread has read row i (and, at a chunk's last row, the
      // chunk), and the warps' last values are out
      __syncthreads();
      if (lane == 0 && warp > 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) nl[k] = xch[i & 1][warp - 1][k];
      }
      if (threadIdx.x == 0) {
        nl[0] = nl[1] = nl[2] = 0.0f;
        // the chunk is consumed: its stage takes chunk c + kStages
        const int cn = c + kStages;
        if (r == R - 1 && cn < chunks)
          issue_chunk(Sb + (size_t)(1 + cn * R) * N,
                      Sb + (size_t)min(1 + (cn + 1) * R, m) * N,
                      stages + s * sb, &full[s]);
      }
      ld3 = ld2;
      ld2 = ld1[2];
#pragma unroll
      for (int k = 0; k < 3; ++k) ld1[k] = nl[k];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        d3[k] = d2[k];
        d2[k] = d1[k];
        d1[k] = d0[k];
        f2[k] = f1[k];
        f1[k] = es[2 + k];
      }
      q += N;
      if (++r == R) {
        r = 0;
        ++c;
        s = s + 1 == kStages ? 0 : s + 1;
        q = (int)((uintptr_t)(Sb + (size_t)(1 + c * R) * N) & 15) + j0;
      }
    }
  }
  store_block_max(best, red, out + b);
}

// qmax: cells from row 2 and column 2, the three predecessors D[i-1, j-1],
// D[i-2, j-1] and D[i-1, j-2]; a pair with a side shorter than 3 scores 0.
template <int kCols>
__global__ void __launch_bounds__(kMaxBlock)
qmax_kernel(const uint8_t* __restrict__ S, const int* __restrict__ m_len,
            const int* __restrict__ n_len, int M, int N, float gap,
            float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t stages[];
  __shared__ uint64_t full[kStages];
  // the last two D values of each warp's run, double-buffered by row
  __shared__ float xch[2][kMaxBlock / 32][2];
  __shared__ float red[kMaxBlock / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = min(m_len[b], M), n = min(n_len[b], N);
  const int j0 = threadIdx.x * kCols;
  const int R = chunk_rows(N), sb = stage_bytes(N, kCols);
  const uint8_t* Sb = S + (size_t)b * M * N;
  float best = 0.0f;
  if (m_len[b] >= 3 && n_len[b] >= 3) {
    // chunk c holds rows 2 + c*R .. 2 + (c+1)*R - 1 (rows 0, 1 are never
    // read: the recurrence reads no S of a predecessor)
    const int chunks = (m - 2 + R - 1) / R;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int c = 0; c < kStages && c < chunks; ++c)
        issue_chunk(Sb + (size_t)(2 + c * R) * N,
                    Sb + (size_t)min(2 + (c + 1) * R, m) * N,
                    stages + c * sb, &full[c]);
    }
    __syncthreads();
    // D rows i-1 and i-2 of the run, and of the columns left of it: ld1
    // at j0-2, j0-1 (row i-1), ld2 at j0-1 (row i-2)
    float d1[kCols], d2[kCols];
    float ld1[2] = {0.0f, 0.0f}, ld2 = 0.0f;
    bool ok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      d1[c] = d2[c] = 0.0f;
      ok[c] = j0 + c >= 2 && j0 + c < n;
    }
    // row i is row r of chunk c, in stage s; the run's bytes of row i
    // start at byte q of the stage, 4-aligned when S and N are
    int c = 0, r = 0, s = 0;
    int q = (int)((uintptr_t)(Sb + 2 * (size_t)N) & 15) + j0;
    const bool aligned = ((uintptr_t)Sb & 3) == 0 && (N & 3) == 0;
    for (int i = 2; i < m; ++i) {
      if (r == 0) mbar_wait(&full[s], (c / kStages) & 1);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(stages + s * sb);
      float d0[kCols];
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const uint32_t v = aligned ? w[(q >> 2) + g] : bytes4(w, q + 4 * g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * g + e;
          const float p1 = k == 0 ? ld1[1] : d1[k - 1];   // D[i-1, j-1]
          const float p2 = k == 0 ? ld2 : d2[k - 1];      // D[i-2, j-1]
          const float p3 = k == 0   ? ld1[0]              // D[i-1, j-2]
                           : k == 1 ? ld1[1]
                                    : d1[k - 2];
          const float pre = fmaxf(fmaxf(p1, p2), p3);
          const float x = (v & (0xFFu << (8 * e))) != 0u
                              ? pre + 1.0f
                              : fmaxf(pre - gap, 0.0f);
          d0[k] = ok[k] ? x : 0.0f;
          best = fmaxf(best, d0[k]);
        }
      }
      // the run's last two values go to the next thread's ld1
      float nl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        nl[k] = __shfl_up_sync(kFull, d0[kCols - 2 + k], 1);
      if (lane == 31) {
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
      }
      ld2 = ld1[1];
      ld1[0] = nl[0];
      ld1[1] = nl[1];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        d2[k] = d1[k];
        d1[k] = d0[k];
      }
      q += N;
      if (++r == R) {
        r = 0;
        ++c;
        s = s + 1 == kStages ? 0 : s + 1;
        q = (int)((uintptr_t)(Sb + (size_t)(2 + c * R) * N) & 15) + j0;
      }
    }
  }
  store_block_max(best, red, out + b);
}

// The cell rules of `pred3_kernel`: the score of cell (i, j) from whether
// S[i, j] is a match (cur), its predecessors' D values p1 = D[i-1, j-1],
// p2 = D[i-2, j-1], p3 = D[i-1, j-2], and whether each predecessor's own
// S is a match (s1, s2, s3).
//
// Unequal-gap qmax: on a match max(p1, p2, p3) + 1, else
// max(p1 - g1, p2 - g2, p3 - g3, 0), g = onset after a match, else
// extension.
struct QmaxUneqRule {
  float onset, extension;
  __device__ __forceinline__ float operator()(bool cur, float p1, float p2,
                                              float p3, bool s1, bool s2,
                                              bool s3) const {
    const float hit = __fadd_rn(fmaxf(fmaxf(p1, p2), p3), 1.0f);
    const float gap = fmaxf(
        fmaxf(fmaxf(__fsub_rn(p1, s1 ? onset : extension),
                    __fsub_rn(p2, s2 ? onset : extension)),
              __fsub_rn(p3, s3 ? onset : extension)),
        0.0f);
    return cur ? hit : gap;
  }
};

// Constrained SW: max(v1, v2, v3, 0), v_p = (p + MS) + Delta_p, MS = match
// or mismatch by cur, Delta_p = 0 on a match, else opening after a matched
// predecessor and extension after an unmatched one. On a match
// max_p((p + match) + 0) == max(p1, p2, p3) + match exactly: x + 0 == x,
// and a rounded addition is monotone.
struct SwRule {
  float opening, extension, match, mismatch;
  __device__ __forceinline__ float operator()(bool cur, float p1, float p2,
                                              float p3, bool s1, bool s2,
                                              bool s3) const {
    const float hit = __fadd_rn(fmaxf(fmaxf(p1, p2), p3), match);
    const float v1 =
        __fadd_rn(__fadd_rn(p1, mismatch), s1 ? opening : extension);
    const float v2 =
        __fadd_rn(__fadd_rn(p2, mismatch), s2 ? opening : extension);
    const float v3 =
        __fadd_rn(__fadd_rn(p3, mismatch), s3 ? opening : extension);
    return fmaxf(cur ? hit : fmaxf(fmaxf(v1, v2), v3), 0.0f);
  }
};

// Whether S at column j0 + t of a row is a match, from the row's run words
// u (columns j0 ..) and its left word l (bytes 0, 1: columns j0-2, j0-1),
// for t in [-2, kCols); t is a constant once the loops are unrolled.
template <int kWords>
__device__ __forceinline__ bool match_at(const uint32_t (&u)[kWords],
                                         uint32_t l, int t) {
  const uint32_t w = t < 0 ? l : u[t < 0 ? 0 : t >> 2];
  return (w & (0xFFu << (8 * (t < 0 ? t + 2 : t & 3)))) != 0u;
}

// Unequal-gap qmax and SW (the note at the top): cells from row 2 and
// column 2, the three predecessors of qmax; a pair with a side shorter
// than 3 scores 0.
template <typename Rule, int kCols>
__global__ void __launch_bounds__(kMaxBlock)
pred3_kernel(const uint8_t* __restrict__ S, const int* __restrict__ m_len,
             const int* __restrict__ n_len, int M, int N, Rule rule,
             float* __restrict__ out) {
  constexpr int kWords = kCols / 4;
  extern __shared__ __align__(128) uint8_t stages[];
  __shared__ uint64_t full[kStages];
  // the last two D values of each warp's run, double-buffered by row
  __shared__ float xch[2][kMaxBlock / 32][2];
  __shared__ float red[kMaxBlock / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = min(m_len[b], M), n = min(n_len[b], N);
  const int j0 = threadIdx.x * kCols;
  const int R = chunk_rows(N), sb = stage_bytes(N, kCols);
  const uint8_t* Sb = S + (size_t)b * M * N;
  float best = 0.0f;
  if (m_len[b] >= 3 && n_len[b] >= 3) {
    // chunk c holds rows c*R .. (c+1)*R - 1
    const int chunks = (m + R - 1) / R;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int c = 0; c < kStages && c < chunks; ++c)
        issue_chunk(Sb + (size_t)(c * R) * N,
                    Sb + (size_t)min((c + 1) * R, m) * N, stages + c * sb,
                    &full[c]);
    }
    __syncthreads();
    // D rows i-1 and i-2 of the run, and of the columns left of it: ld1
    // at j0-2, j0-1 (row i-1), ld2 at j0-1 (row i-2); u1, l1 and u2, l2:
    // the run and left words of S rows i-1 and i-2
    float d1[kCols], d2[kCols];
    float ld1[2] = {0.0f, 0.0f}, ld2 = 0.0f;
    uint32_t u1[kWords], u2[kWords], l1 = 0u, l2 = 0u;
    bool ok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      d1[c] = d2[c] = 0.0f;
      ok[c] = j0 + c >= 2 && j0 + c < n;
    }
#pragma unroll
    for (int g = 0; g < kWords; ++g) u1[g] = u2[g] = 0u;
    // row i is row r of chunk c, in stage s; the run's bytes of row i
    // start at byte q of the stage, 4-aligned when S and N are
    int c = 0, r = 0, s = 0;
    int q = (int)((uintptr_t)Sb & 15) + j0;
    const bool aligned = ((uintptr_t)Sb & 3) == 0 && (N & 3) == 0;
    for (int i = 0; i < m; ++i) {
      if (r == 0) mbar_wait(&full[s], (c / kStages) & 1);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(stages + s * sb);
      uint32_t u0[kWords];
#pragma unroll
      for (int g = 0; g < kWords; ++g)
        u0[g] = aligned ? w[(q >> 2) + g] : bytes4(w, q + 4 * g);
      // thread 0's left columns do not exist (its cells start at j = 2)
      const uint32_t l0 = j0 < 4 ? 0u
                          : aligned ? w[(q >> 2) - 1] >> 16
                                    : bytes4(w, q - 2);
      // rows 0 and 1 stay 0: the recurrence starts at row 2
      const bool live = i >= 2;
      float d0[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float p1 = k == 0 ? ld1[1] : d1[k - 1];   // D[i-1, j-1]
        const float p2 = k == 0 ? ld2 : d2[k - 1];      // D[i-2, j-1]
        const float p3 = k == 0   ? ld1[0]              // D[i-1, j-2]
                         : k == 1 ? ld1[1]
                                  : d1[k - 2];
        const float x = rule(match_at(u0, l0, k), p1, p2, p3,
                             match_at(u1, l1, k - 1),
                             match_at(u2, l2, k - 1),
                             match_at(u1, l1, k - 2));
        d0[k] = ok[k] && live ? x : 0.0f;
        best = fmaxf(best, d0[k]);
      }
      // the run's last two values go to the next thread's ld1
      float nl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        nl[k] = __shfl_up_sync(kFull, d0[kCols - 2 + k], 1);
      if (lane == 31) {
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
          issue_chunk(Sb + (size_t)(cn * R) * N,
                      Sb + (size_t)min((cn + 1) * R, m) * N,
                      stages + s * sb, &full[s]);
      }
      ld2 = ld1[1];
      ld1[0] = nl[0];
      ld1[1] = nl[1];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        d2[k] = d1[k];
        d1[k] = d0[k];
      }
#pragma unroll
      for (int g = 0; g < kWords; ++g) {
        u2[g] = u1[g];
        u1[g] = u0[g];
      }
      l2 = l1;
      l1 = l0;
      q += N;
      if (++r == R) {
        r = 0;
        ++c;
        s = s + 1 == kStages ? 0 : s + 1;
        q = (int)((uintptr_t)(Sb + (size_t)(c * R) * N) & 15) + j0;
      }
    }
  }
  store_block_max(best, red, out + b);
}

// The shared-memory kernels, for rows past kRegisterMaxN.
//
// Qmax with gap_onset != gap_extension: the gap branch subtracts each
// predecessor cell's own penalty, gamma = onset if that cell of S is a
// match, else extension. gamma comes from S for every row, rows 0 and 1
// included, as in the plain scan.
__global__ void __launch_bounds__(kThreads)
qmax_uneq_kernel(const uint8_t* __restrict__ S,
                 const int* __restrict__ m_len,
                 const int* __restrict__ n_len, int M, int N, float onset,
                 float extension, float* __restrict__ out) {
  extern __shared__ float sh[];
  float* d0 = sh;          // D row i (being written)
  float* d1 = sh + N;      // D row i-1
  float* d2 = sh + 2 * N;  // D row i-2
  const int b = blockIdx.x;
  const int m = min(m_len[b], M), n = min(n_len[b], N);
  for (int j = threadIdx.x; j < 3 * N; j += kThreads) sh[j] = 0.0f;
  __syncthreads();
  const uint8_t* Sb = S + (size_t)b * M * N;
  float best = 0.0f;
  for (int i = 2; i < m; ++i) {
    const uint8_t* s0 = Sb + (size_t)i * N;   // S row i
    const uint8_t* s1 = s0 - N;               // S row i-1
    const uint8_t* s2 = s1 - N;               // S row i-2
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float v = 0.0f;
      if (j >= 2 && j < n) {
        const float p1 = d1[j - 1], p2 = d2[j - 1], p3 = d1[j - 2];
        if (__ldg(s0 + j)) {
          v = __fadd_rn(fmaxf(fmaxf(p1, p2), p3), 1.0f);
        } else {
          const float g1 = __ldg(s1 + j - 1) ? onset : extension;
          const float g2 = __ldg(s2 + j - 1) ? onset : extension;
          const float g3 = __ldg(s1 + j - 2) ? onset : extension;
          v = fmaxf(fmaxf(fmaxf(__fsub_rn(p1, g1), __fsub_rn(p2, g2)),
                          __fsub_rn(p3, g3)),
                    0.0f);
        }
      }
      d0[j] = v;
      best = fmaxf(best, v);
    }
    __syncthreads();
    float* t = d2;
    d2 = d1;
    d1 = d0;
    d0 = t;
  }
  best = block_max(best);
  if (threadIdx.x == 0)
    out[b] = (m_len[b] >= 3 && n_len[b] >= 3) ? best : 0.0f;
}

// Constrained Smith-Waterman: for the predecessors p of (i, j),
// v_p = (D[p] + MS) + Delta with MS = match or mismatch by S[i, j], and
// Delta = 0 on a match, else opening after a matched predecessor S[p] and
// extension after an unmatched one; D = max(v_1, v_2, v_3, 0).
__global__ void __launch_bounds__(kThreads)
sw_kernel(const uint8_t* __restrict__ S, const int* __restrict__ m_len,
          const int* __restrict__ n_len, int M, int N, float opening,
          float extension, float match, float mismatch,
          float* __restrict__ out) {
  extern __shared__ float sh[];
  float* d0 = sh;          // D row i (being written)
  float* d1 = sh + N;      // D row i-1
  float* d2 = sh + 2 * N;  // D row i-2
  const int b = blockIdx.x;
  const int m = min(m_len[b], M), n = min(n_len[b], N);
  for (int j = threadIdx.x; j < 3 * N; j += kThreads) sh[j] = 0.0f;
  __syncthreads();
  const uint8_t* Sb = S + (size_t)b * M * N;
  float best = 0.0f;
  for (int i = 2; i < m; ++i) {
    const uint8_t* s0 = Sb + (size_t)i * N;   // S row i
    const uint8_t* s1 = s0 - N;               // S row i-1
    const uint8_t* s2 = s1 - N;               // S row i-2
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float v = 0.0f;
      if (j >= 2 && j < n) {
        const bool cur = __ldg(s0 + j) != 0;
        const float ms = cur ? match : mismatch;
        // Delta of each predecessor, by its own S
        const float e1 = cur ? 0.0f
                             : (__ldg(s1 + j - 1) ? opening : extension);
        const float e2 = cur ? 0.0f
                             : (__ldg(s2 + j - 1) ? opening : extension);
        const float e3 = cur ? 0.0f
                             : (__ldg(s1 + j - 2) ? opening : extension);
        const float v1 = __fadd_rn(__fadd_rn(d1[j - 1], ms), e1);
        const float v2 = __fadd_rn(__fadd_rn(d2[j - 1], ms), e2);
        const float v3 = __fadd_rn(__fadd_rn(d1[j - 2], ms), e3);
        v = fmaxf(fmaxf(fmaxf(v1, v2), v3), 0.0f);
      }
      d0[j] = v;
      best = fmaxf(best, v);
    }
    __syncthreads();
    float* t = d2;
    d2 = d1;
    d1 = d0;
    d0 = t;
  }
  best = block_max(best);
  if (threadIdx.x == 0)
    out[b] = (m_len[b] >= 3 && n_len[b] >= 3) ? best : 0.0f;
}

// One block per pair with `rows` rows of N floats of dynamic shared
// memory; `args` are the kernel's arguments.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int rows, int B, int N, int device,
           cudaStream_t stream, Args... args) {
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)rows * N * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0) kernel<<<B, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The register kernels' columns a thread at row length N: 4 up to N =
// 2048 (128 threads at N = 512), then 8, 16, 32, so at most kMaxBlock
// threads.
int register_cols(int N) {
  int cols = 4;
  while (N > cols * kMaxBlock) cols *= 2;
  return cols;
}

int register_threads(int N, int cols) {
  const int warps = (N + 32 * cols - 1) / (32 * cols);
  return 32 * (warps > 0 ? warps : 1);
}

// A register kernel of `cols` columns a thread, one block per pair, its
// ring of stages in dynamic shared memory; `args` are its arguments.
template <typename Kernel, typename... Args>
int launch_registers(Kernel kernel, int cols, int B, int N, int device,
                     void* stream, Args... args) {
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (N > kRegisterMaxN) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kStages * stage_bytes(N, cols);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, register_threads(N, cols), smem, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

using RowKernel = void (*)(const uint8_t*, const int*, const int*, int, int,
                           float, float*);

template <int kCols>
RowKernel row_kernel(bool dmax) {
  return dmax ? dmax_kernel<kCols> : qmax_kernel<kCols>;
}

// dmax or qmax, one block per pair.
int launch_row(bool dmax, const uint8_t* S, const int* m_len,
               const int* n_len, int B, int M, int N, float gap, float* out,
               int device, void* stream) {
  const int cols = register_cols(N);
  const RowKernel kernel = cols == 4    ? row_kernel<4>(dmax)
                           : cols == 8  ? row_kernel<8>(dmax)
                           : cols == 16 ? row_kernel<16>(dmax)
                                        : row_kernel<32>(dmax);
  return launch_registers(kernel, cols, B, N, device, stream, S, m_len,
                          n_len, M, N, gap, out);
}

template <typename Rule>
using Pred3Kernel = void (*)(const uint8_t*, const int*, const int*, int,
                             int, Rule, float*);

template <typename Rule>
Pred3Kernel<Rule> pred3_kernel_at(int cols) {
  return cols == 4    ? pred3_kernel<Rule, 4>
         : cols == 8  ? pred3_kernel<Rule, 8>
         : cols == 16 ? pred3_kernel<Rule, 16>
                      : pred3_kernel<Rule, 32>;
}

// Unequal-gap qmax or SW, one block per pair: the register kernel for
// rows up to kRegisterMaxN, the shared-memory kernel `smem_kernel`
// (whose arguments after the shape are `params`) past them.
template <typename Rule, typename SmemKernel, typename... Params>
int launch_pred3(Rule rule, SmemKernel smem_kernel, const uint8_t* S,
                 const int* m_len, const int* n_len, int B, int M, int N,
                 float* out, int device, void* stream, Params... params) {
  const bool registers = N <= kRegisterMaxN;
  if (!registers)
    return launch(smem_kernel, 3, B, N, device, (cudaStream_t)stream, S,
                  m_len, n_len, M, N, params..., out);
  const int cols = register_cols(N);
  return launch_registers(pred3_kernel_at<Rule>(cols), cols, B, N, device,
                          stream, S, m_len, n_len, M, N, rule, out);
}

}  // namespace

extern "C" {

int acoss_qmax(const uint8_t* S, const int* m_len, const int* n_len, int B,
               int M, int N, float gap, float* out, int device,
               void* stream) {
  return launch_row(false, S, m_len, n_len, B, M, N, gap, out, device,
                    stream);
}

int acoss_dmax(const uint8_t* S, const int* m_len, const int* n_len, int B,
               int M, int N, float gap, float* out, int device,
               void* stream) {
  return launch_row(true, S, m_len, n_len, B, M, N, gap, out, device,
                    stream);
}

int acoss_qmax_uneq(const uint8_t* S, const int* m_len, const int* n_len,
                    int B, int M, int N, float gap_onset,
                    float gap_extension, float* out, int device,
                    void* stream) {
  return launch_pred3(QmaxUneqRule{gap_onset, gap_extension},
                      qmax_uneq_kernel, S, m_len, n_len, B, M, N, out,
                      device, stream, gap_onset, gap_extension);
}

int acoss_sw(const uint8_t* S, const int* m_len, const int* n_len, int B,
             int M, int N, float gap_opening, float gap_extension,
             float match_score, float mismatch_score, float* out,
             int device, void* stream) {
  return launch_pred3(
      SwRule{gap_opening, gap_extension, match_score, mismatch_score},
      sw_kernel, S, m_len, n_len, B, M, N, out, device, stream, gap_opening,
      gap_extension, match_score, mismatch_score);
}

const char* acoss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
