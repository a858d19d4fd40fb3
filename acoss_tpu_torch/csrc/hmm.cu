// Forward-backward posteriors of the chord HMM, parallel in time.
//
// Computes what the two `lax.scan`s of `acoss_tpu/features/chord.py:72-85`
// (`_chord_posteriors_padded`) compute, without the JAX package's frame
// padding: for log emissions E (T, C) and log transitions A (C, C),
//   alpha_0 = E_0 - log C,
//   alpha_t[j] = lse_i(alpha_{t-1}[i] + A[i, j]) + E_t[j],
//   beta_{T-1} = 0,
//   beta_t[i] = lse_j(A[i, j] + E_{t+1}[j] + beta_{t+1}[j]),
//   gamma_t = softmax(alpha_t + beta_t),
// with lse the max-shifted log-sum-exp (an all -inf row takes a max of 0,
// `jax.nn.logsumexp`'s convention), and each message shifted to a largest
// entry of 0, as `ops/hmm_cuda.py`'s plain version does. It is not a TPU
// kernel: it replaces two scans of T dependent steps each.
//
// With M_t = A + E_t[None, :] (the one-frame matrix), alpha_t = alpha_{t-1}
// (x) M_t and beta_{t-1} = M_t (x) beta_t in the log semiring, so a run of
// frames collapses into one C x C transfer, the product of its M_t, which
// serves both directions. The frames are cut into chunks of L (chunk c
// holds frames [cL, min(cL + L, T)); chunk 0's transfer starts at frame 1)
// and the work runs in three launches:
//   1. hmm_chunk_kernel, a block a chunk, a warp a row of the chunk's
//      running product: L dependent frames, each a C x C x C product;
//   2. hmm_boundary_kernel, one block: warp 0 carries alpha forward and
//      warp 1 beta backward through the transfers, T / L steps each;
//   3. hmm_replay_kernel, a block a chunk: warp 0 replays the chunk's
//      frames forward from its boundary alpha, warp 1 backward from its
//      boundary beta (a state a lane, as the one-warp kernel this replaces
//      did for the whole song), then the block's four warps write gamma =
//      softmax(alpha + beta).
// A song of T <= L frames is one chunk and runs phase 3 alone.
//
// What bounds it on the H100: latency. The algorithm reads E once and
// writes gamma once (4 (2TC + C^2) bytes) and does about 10 T C^2 fp32
// operations (chip_smoke.py's bound: about a microsecond for a song). The
// chunking adds phase 1's products, C^3 multiply-adds a frame (T C^3 in
// all: 0.09 G for T = 5,762, C = 25, 0.40 G for 25,832), which that bound
// does not count. What remains is three chains of dependent steps: L frames
// in phase 1 (about 0.8 us a frame on the H100: 25 warps and a block
// barrier a frame), T / L chunks in phase 2 and L frames in phase 3 (about
// 0.5 us a step each, the two directions on two warps at once). The
// default L (`ops/hmm_cuda.py:chunk_length`) is about sqrt(T / 2), which
// balances them, but at least T / (the card's SMs), so that phase 1's
// blocks run in one wave: 54 frames for a 5,762-frame song, 196 for
// 25,832 (`scripts/torch_hmm_fb.py` times other L). The one-warp kernel
// this replaces ran 2 (T - 1) steps one after another (16.93 ms at T =
// 5,762).
//
// The arithmetic domain. The messages and the chunk products stay in log
// space, shifted to a largest entry of 0 after every frame, so no product
// of any length leaves fp32's range, whatever the inputs (Dirichlet-random
// transitions, -inf entries). Only the one-frame inner product is linear:
//   lse_i(x_i + W[i][j]) = log(sum_i exp(x_i) * exp(W[i][j] - wmax_j)) + wmax_j
// with x (a message or a product row, less its largest entry) <= 0 and
// wmax_j the column's largest entry, so every factor is at most 1 and the
// sum at most 32: one exp a lane and 32 fused multiply-adds, where the
// log-space step takes C exps. A factor or a product that falls below
// fp32's normal range loses less than 2^-126, at most 32 of them, so
// where the sum is >= kTiny = 2^-90 the lost part is below 2^-31 of it;
// where it is smaller (or not a number), the entry is taken again by the
// exact max-shifted log-sum-exp (`lse_exact`). The chord HMM's inputs
// never take that branch; spiky transitions, emissions spread over
// hundreds of nats and state changes whose every factor underflows do,
// and the tests hold all of them against the plain version. The exps and
// logs are the hardware approximations (__expf, __logf: relative error
// about 2^-21 where it matters, at the largest terms, and the logs of sums
// in [2^-90, 32]); the posteriors stay within ~3e-6 of the plain version,
// inside the 1e-5 the callers hold them to.
//
// Repeatability: no atomics and no order-free sums. Every sum runs in a
// fixed order, and no two blocks write the same element (chunk c writes
// gamma and beta rows [cL, min(cL + L, T)) only), so two calls give the
// same bits. The wrapper allocates the scratch; the kernels allocate
// nothing. Phase 1 stages its chunk's emissions in shared memory, so L is
// at most kMaxChunk (128 KB at C = 32).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "device.cuh"

namespace {

constexpr int kMaxStates = 32;
constexpr int kMaxChunk = 1024;
constexpr int kGroup = 8;
constexpr int kMat = kMaxStates * kMaxStates;
constexpr int kReplayWarps = 4;
constexpr int kSoftFrames = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 0x1p-90f;

// an int that orders as the float does (for __reduce_max_sync)
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// the largest value over the warp, exactly, in one reduction
__device__ __forceinline__ float warp_max(float v) {
  return key_float(__reduce_max_sync(kFull, float_key(v)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// jax.nn.logsumexp's convention: a non-finite max shifts by 0
__device__ __forceinline__ float finite_or_zero(float m) {
  return isfinite(m) ? m : 0.f;
}

// x less its largest value over the lanes on (lanes past C: -inf); every
// lane takes part in the reduction.
__device__ __forceinline__ float shift(float x, bool on) {
  const float m = warp_max(on ? x : -INFINITY);
  return on ? x - m : -INFINITY;
}

// lse over i < C of (x on lane i) + w(i), exactly, for every lane at once
// (lanes past C take part and return garbage).
template <class W>
__device__ float lse_exact(float x, W w, int C, bool on) {
  float m = -INFINITY;
  for (int i = 0; i < C; ++i)
    m = fmaxf(m, __shfl_sync(kFull, x, i) + (on ? w(i) : 0.f));
  m = finite_or_zero(m);
  float s = 0.f;
  for (int i = 0; i < C; ++i)
    s += __expf(__shfl_sync(kFull, x, i) + (on ? w(i) : 0.f) - m);
  return __logf(s) + m;
}

// sum over i < 32 of (p on lane i) * ew[i], the four partial sums in a
// fixed order; p and ew are 0 past C, so no lane tests C (a branch around
// warp-synchronous code in every term cost half the step). The lanes'
// p reach each other through `buf`, 32 floats of this warp's shared
// memory, 16-byte aligned, not read by any lane since the warp's last
// __syncwarp, as 8 broadcast reads (faster than 32 shuffles).
__device__ __forceinline__ float dot_lanes(float p,
                                           const float (&ew)[kMaxStates],
                                           float* buf) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  buf[threadIdx.x & 31] = p;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kMaxStates; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(buf + i);
    acc[0] = fmaf(q.x, ew[i], acc[0]);
    acc[1] = fmaf(q.y, ew[i + 1], acc[1]);
    acc[2] = fmaf(q.z, ew[i + 2], acc[2]);
    acc[3] = fmaf(q.w, ew[i + 3], acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// lse over i < C of (x on lane i) + W[i][lane], for every lane: x <= 0 is
// the lane's log factor (-inf past C); ew[i] = exp(W[i][lane] - wmax), 0
// past C, with wmax the column's largest entry (0 if none is finite);
// w(i) reads W[i][lane] for the exact branch.
template <class W>
__device__ __forceinline__ float lse_product(float x,
                                             const float (&ew)[kMaxStates],
                                             float wmax, int C, bool on,
                                             float* buf, W w) {
  const float s = dot_lanes(__expf(x), ew, buf);
  const bool small = !(s >= kTiny);
  if (__any_sync(kFull, on && small)) {
    const float ex = lse_exact(x, w, C, on);
    if (small) return ex;
  }
  return __logf(s) + wmax;
}

// softmax over the lanes of x (lanes past C excluded), written to *out
// where `store`.
__device__ __forceinline__ void write_softmax(float x, bool on, bool store,
                                              float* out) {
  const float m = warp_max(on ? x : -INFINITY);
  const float e = on ? __expf(x - m) : 0.f;
  const float s = warp_sum(e);
  if (on && store) *out = e / s;
}

// Phase 1. Block c builds chunk c's transfer P, the log-semiring product of
// M_t = A + E_t over frames [max(cL, 1), min(cL + L, T)), less its largest
// entry after every frame: warp r holds row r, lane j entry (r, j). A frame
// is P'[r][j] = lse_i(P[r][i] + A[i][j]) + E_t[j]: each warp writes its
// row's exp factors to shared memory and every lane reads them back as
// broadcasts against its column of exp(A) in registers. The row maxima go
// through shared memory, one barrier a frame, for the block's shift. The
// chunk's emissions are staged in shared memory first (dynamic, (e - s) C
// floats). Writes, for the boundary scan: P (mlog), exp(P - its column
// max) (ecol, column j of chunk c at c * kMat + j, stride kMaxStates),
// exp(P - its row max) transposed (erowT, row i at c * kMat + i, stride
// kMaxStates), and the column and row maxima (cmax, rmax).
__global__ void __launch_bounds__(kMaxStates * 32)
    hmm_chunk_kernel(const float* __restrict__ E, const float* __restrict__ A,
                     int T, int C, int L, float* __restrict__ mlog,
                     float* __restrict__ ecol, float* __restrict__ erowT,
                     float* __restrict__ cmax, float* __restrict__ rmax) {
  extern __shared__ float sE[];
  __shared__ float sA[kMaxStates][kMaxStates + 1];
  __shared__ __align__(16) float sp[kMaxStates][kMaxStates];
  __shared__ float smax[2][kMaxStates];
  const int r = threadIdx.x >> 5, j = threadIdx.x & 31;
  const bool on = j < C;
  const int c = blockIdx.x;
  const int s = max(c * L, 1), e = min(c * L + L, T);  // s < e: L >= 2
  for (int k = threadIdx.x; k < C * C; k += blockDim.x)
    sA[k / C][k % C] = A[k];
  const float* Es = E + (size_t)s * C;
  for (int k = threadIdx.x; k < (e - s) * C; k += blockDim.x) sE[k] = Es[k];
  __syncthreads();

  float cA = -INFINITY;
  for (int i = 0; i < C; ++i) cA = fmaxf(cA, on ? sA[i][j] : -INFINITY);
  cA = finite_or_zero(cA);
  float ew[kMaxStates];
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i)
    ew[i] = on && i < C ? __expf(sA[i][j] - cA) : 0.f;

  // the first frame: P = M_s
  float x = on ? sA[r][j] + sE[j] : -INFINITY;
  float rm = warp_max(x);
  if (j == 0) smax[0][r] = rm;
  __syncthreads();
  float g = finite_or_zero(warp_max(j < C ? smax[0][j] : -INFINITY));
  x -= g;
  float mr = finite_or_zero(rm - g);  // row r's largest entry

  for (int t = 1; t < e - s; ++t) {
    const float xl = x - mr;  // <= 0, largest 0
    // sp[r] is free: the last barrier came after every lane's last read
    const float sum = dot_lanes(on ? __expf(xl) : 0.f, ew, sp[r]);
    const bool small = !(sum >= kTiny);
    float y = __logf(sum) + cA;
    if (__any_sync(kFull, on && small)) {
      const float ex = lse_exact(xl, [=](int i) { return sA[i][j]; }, C, on);
      if (small) y = ex;
    }
    y = on ? y + mr + sE[t * C + j] : -INFINITY;
    rm = warp_max(y);
    if (j == 0) smax[t & 1][r] = rm;
    __syncthreads();
    g = finite_or_zero(warp_max(j < C ? smax[t & 1][j] : -INFINITY));
    x = y - g;
    mr = finite_or_zero(rm - g);
  }

  // the transfer and its scaled exps for the boundary scan
  __shared__ float sP[kMaxStates][kMaxStates + 1];
  sP[r][j] = x;
  __syncthreads();
  float cm = -INFINITY;
  for (int i = 0; i < C; ++i) cm = fmaxf(cm, sP[i][j]);
  cm = finite_or_zero(cm);
  if (on) {
    const size_t base = (size_t)c * kMat;
    mlog[base + r * kMaxStates + j] = x;
    ecol[base + r * kMaxStates + j] = __expf(x - cm);
    erowT[base + j * kMaxStates + r] = __expf(x - mr);
    if (r == 0) cmax[(size_t)c * kMaxStates + j] = cm;
    if (j == 0) rmax[(size_t)c * kMaxStates + r] = mr;
  }
}

// Phase 2. Warp 0: alpha_in[c + 1] = shift(alpha_in[c] (x) P_c) from
// alpha_in[0] = alpha_0, the message at the frame before each chunk. Warp
// 1: beta_end[c - 1] = shift(P_c (x) beta_end[c]) from beta_end[nb - 1] = 0,
// the message at each chunk's last frame. A lane is a state; the two
// directions run one code path over their own factors (warp 0 column
// `lane` of ecol, warp 1 row `lane` of erowT) and strides, and the next
// chunk's factors load while the current step runs.
__global__ void __launch_bounds__(64)
    hmm_boundary_kernel(const float* __restrict__ E, int C, int nb,
                        const float* __restrict__ mlog,
                        const float* __restrict__ ecol,
                        const float* __restrict__ erowT,
                        const float* __restrict__ cmax,
                        const float* __restrict__ rmax,
                        float* __restrict__ alpha_in,
                        float* __restrict__ beta_end) {
  __shared__ __align__(16) float sb[2][2][kMaxStates];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool on = lane < C;
  const bool fwd = w == 0;
  const float* fac = fwd ? ecol : erowT;
  const float* wm = fwd ? cmax : rmax;
  float* out = fwd ? alpha_in : beta_end;
  // the exact branch reads P_c[i][lane] forward, P_c[lane][i] backward
  const int si = fwd ? kMaxStates : 1, sl = fwd ? 1 : kMaxStates;
  const int c0 = fwd ? 0 : nb - 1, dc = fwd ? 1 : -1;
  const int steps = nb - 1;
  float cur[kMaxStates], nxt[kMaxStates];
  float wcur = 0.f, wnxt = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i)
    cur[i] = on && i < C ? fac[(size_t)c0 * kMat + i * kMaxStates + lane] : 0.f;
  if (on) wcur = wm[(size_t)c0 * kMaxStates + lane];

  float m = on ? (fwd ? E[lane] - __logf((float)C) : 0.f) : -INFINITY;
  m = shift(m, on);
  for (int k = 0; k < steps; ++k) {
    const int c = c0 + k * dc;
    if (k + 1 < steps) {
      const size_t b = (size_t)(c + dc) * kMat;
#pragma unroll
      for (int i = 0; i < kMaxStates; ++i)
        nxt[i] = on && i < C ? fac[b + i * kMaxStates + lane] : 0.f;
      if (on) wnxt = wm[(size_t)(c + dc) * kMaxStates + lane];
    }
    const float* M = mlog + (size_t)c * kMat + lane * sl;
    m = shift(lse_product(m, cur, wcur, C, on, sb[w][k & 1],
                          [=](int i) { return M[i * si]; }),
              on);
    if (on) out[(size_t)(c + dc) * kMaxStates + lane] = m;
#pragma unroll
    for (int i = 0; i < kMaxStates; ++i) cur[i] = nxt[i];
    wcur = wnxt;
  }
}

// Phase 3. Block c replays chunk c: warp 0 alpha forward from alpha_in[c]
// (chunk 0: alpha_0, frame 0 included), into gamma's rows; warp 1 beta
// backward from beta_end[c] (the last chunk: 0), into beta's rows; then
// the block's warps write gamma = softmax(alpha + beta) over the chunk's
// frames, kSoftFrames a warp at once. Emissions load a group of kGroup
// frames ahead of the recursion; only the last group tests each frame.
__global__ void __launch_bounds__(kReplayWarps * 32)
    hmm_replay_kernel(const float* __restrict__ E,
                      const float* __restrict__ A, int T, int C, int L,
                      int nb, const float* __restrict__ alpha_in,
                      const float* __restrict__ beta_end, float* beta,
                      float* gamma) {
  __shared__ __align__(16) float sb[2][2][kMaxStates];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool on = lane < C;
  const int c = blockIdx.x;
  const int lo = c * L, hi = min(lo + L, T);

  if (w == 0) {
    // column `lane` of exp(A - its max)
    float cA = -INFINITY;
    for (int i = 0; i < C; ++i)
      cA = fmaxf(cA, on ? A[i * C + lane] : -INFINITY);
    cA = finite_or_zero(cA);
    float ew[kMaxStates];
#pragma unroll
    for (int i = 0; i < kMaxStates; ++i)
      ew[i] = on && i < C ? __expf(A[i * C + lane] - cA) : 0.f;
    float a;
    int t0 = lo;
    if (c == 0) {
      a = shift(on ? E[lane] - __logf((float)C) : -INFINITY, on);
      if (on) gamma[lane] = a;
      t0 = 1;
    } else {
      a = on ? alpha_in[(size_t)c * kMaxStates + lane] : -INFINITY;
    }
    auto step = [&](int t, float et) {
      a = shift(lse_product(a, ew, cA, C, on, sb[0][t & 1],
                            [=](int i) { return A[i * C + lane]; }) +
                    et,
                on);
      if (on) gamma[(size_t)t * C + lane] = a;
    };
    float cur[kGroup], nxt[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      cur[k] = on && t0 + k < hi ? E[(size_t)(t0 + k) * C + lane] : 0.f;
    for (int g0 = t0; g0 < hi; g0 += kGroup) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int t = g0 + kGroup + k;
        nxt[k] = on && t < hi ? E[(size_t)t * C + lane] : 0.f;
      }
      if (g0 + kGroup <= hi) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) step(g0 + k, cur[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (g0 + k < hi) step(g0 + k, cur[k]);  // warp-uniform
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
    }
  } else if (w == 1) {
    // row `lane` of exp(A - its max)
    float rA = -INFINITY;
    for (int i = 0; i < C; ++i)
      rA = fmaxf(rA, on ? A[lane * C + i] : -INFINITY);
    rA = finite_or_zero(rA);
    float ew[kMaxStates];
#pragma unroll
    for (int i = 0; i < kMaxStates; ++i)
      ew[i] = on && i < C ? __expf(A[lane * C + i] - rA) : 0.f;
    float b = on ? (c == nb - 1 ? 0.f : beta_end[(size_t)c * kMaxStates + lane])
                 : -INFINITY;
    if (on) beta[(size_t)(hi - 1) * C + lane] = b;
    // frame t's step reads E_{t+1}, less its largest entry (emax, off the
    // recursion's chain)
    auto step = [&](int t, float ed, float emax) {
      b = shift(lse_product(on ? b + ed : -INFINITY, ew, rA, C, on,
                            sb[1][t & 1],
                            [=](int i) { return A[lane * C + i]; }) +
                    emax,
                on);
      if (on) beta[(size_t)t * C + lane] = b;
    };
    // cur[k] is frame t0 - k's
    const int t0 = hi - 2;
    float cur[kGroup], nxt[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      cur[k] = on && t0 - k >= lo ? E[(size_t)(t0 - k + 1) * C + lane] : 0.f;
    for (int g0 = t0; g0 >= lo; g0 -= kGroup) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int t = g0 - kGroup - k;
        nxt[k] = on && t >= lo ? E[(size_t)(t + 1) * C + lane] : 0.f;
      }
      float emax[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        emax[k] = finite_or_zero(warp_max(on ? cur[k] : -INFINITY));
        cur[k] -= emax[k];
      }
      if (g0 - kGroup + 1 >= lo) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) step(g0 - k, cur[k], emax[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (g0 - k >= lo) step(g0 - k, cur[k], emax[k]);  // warp-uniform
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
    }
  }
  __syncthreads();  // the chunk's alphas and betas are written

  for (int t0 = lo + w; t0 < hi; t0 += kReplayWarps * kSoftFrames) {
    float x[kSoftFrames];
#pragma unroll
    for (int u = 0; u < kSoftFrames; ++u) {
      const int t = t0 + u * kReplayWarps;
      const size_t o = (size_t)t * C + lane;
      x[u] = on && t < hi ? gamma[o] + beta[o] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSoftFrames; ++u) {
      const int t = t0 + u * kReplayWarps;
      write_softmax(x[u], on, t < hi, gamma + (size_t)t * C + lane);
    }
  }
}

int chunks(int T, int L) { return T <= 0 ? 0 : (T - 1) / L + 1; }

}  // namespace

extern "C" {

// Floats of scratch a call needs: the chunk transfers and their scaled
// exps (3 nb kMat), their column and row maxima and the boundary messages
// (4 nb kMaxStates), and the betas (T C).
size_t acoss_hmm_fb_scratch(int T, int C, int L) {
  if (T <= 0 || C < 1 || C > kMaxStates || L < 2 || L > kMaxChunk) return 0;
  const size_t nb = (size_t)chunks(T, L);
  return nb * (3 * kMat + 4 * kMaxStates) + (size_t)T * C;
}

// E (T, C) and A (C, C) fp32 row-major on `device`; gamma (T, C) fp32 out;
// scratch of acoss_hmm_fb_scratch(T, C, L) floats; chunks of 2 <= L <=
// kMaxChunk frames.
int acoss_hmm_fb(const float* E, const float* A, int T, int C, int L,
                 float* scratch, float* gamma, int device, void* stream_) {
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > kMaxStates || T < 0 || L < 2 || L > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t stream = (cudaStream_t)stream_;
  const int nb = chunks(T, L);
  const size_t mat = (size_t)nb * kMat, vec = (size_t)nb * kMaxStates;
  float* mlog = scratch;
  float* ecol = mlog + mat;
  float* erowT = ecol + mat;
  float* cmax = erowT + mat;
  float* rmax = cmax + vec;
  float* alpha_in = rmax + vec;
  float* beta_end = alpha_in + vec;
  float* beta = beta_end + vec;
  if (nb > 1) {
    const int smem = L * C * (int)sizeof(float);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(hmm_chunk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
    }
    hmm_chunk_kernel<<<nb, 32 * C, smem, stream>>>(E, A, T, C, L, mlog, ecol,
                                                    erowT, cmax, rmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hmm_boundary_kernel<<<1, 64, 0, stream>>>(E, C, nb, mlog, ecol, erowT,
                                              cmax, rmax, alpha_in, beta_end);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  hmm_replay_kernel<<<nb, kReplayWarps * 32, 0, stream>>>(
      E, A, T, C, L, nb, alpha_in, beta_end, beta, gamma);
  return (int)cudaGetLastError();
}

}  // extern "C"
