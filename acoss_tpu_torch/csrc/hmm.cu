// Forward-backward posteriors of the chord HMM, in log space.
//
// Computes what the two `lax.scan`s of `acoss_tpu/features/chord.py:72-85`
// (`_chord_posteriors_padded`) compute, without the JAX package's frame
// padding: for log emissions E (T, C) and log transitions A (C, C),
//   alpha_0 = E_0 - log C,
//   alpha_t[j] = lse_i(alpha_{t-1}[i] + A[i, j]) + E_t[j],
//   beta_{T-1} = 0,
//   beta_t[i] = lse_j(A[i, j] + E_{t+1}[j] + beta_{t+1}[j]),
//   gamma_t = softmax(alpha_t + beta_t),
// with lse the max-shifted log-sum-exp, and each message shifted to a
// largest entry of 0, as `ops/hmm_cuda.py`'s plain version does: the
// posteriors are the same, and the messages do not grow with T (fp32
// would lose ~1e-3 of them in a long song). It is not a TPU kernel: it
// exists because eager PyTorch would launch several ops a frame, two
// recursions of T steps each (about 50k steps for a 5-minute song at hop
// 512), and wait on the host at every one.
//
// What bounds it on the H100: neither bytes nor arithmetic. The song reads
// E once (T x C floats) and writes gamma once, and a step does ~C^2 exps
// and adds (C = 25), so the card could finish a song in microseconds; the
// two recursions are chains of T dependent steps, and one step's latency
// (C shuffles, C exps, a log) times 2T is the time.
//
// Design: one warp a song, state j on lane j (C <= 32). Each lane keeps
// its column of A (for the forward step) and its row (for the backward
// step) in registers; a step broadcasts the C previous messages with
// __shfl_sync and each lane reduces its own log-sum-exp, so a step touches
// no shared or device memory but for its own emission. Emissions (and, in
// the backward pass, the alphas) are loaded a group of kGroup frames
// ahead of the recurrence, so a step never waits on device memory. The
// forward pass writes alpha_t into gamma's row t; the backward pass reads
// it back (each lane its own, written by itself) and overwrites it with
// the posterior, so the kernel needs no scratch. One launch, both passes.

#include <cuda_runtime.h>
#include <math.h>

#include "device.cuh"

namespace {

constexpr int kMaxStates = 32;
constexpr int kGroup = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// lse over i < C of (x on lane i) + w[i], for every lane at once.
__device__ __forceinline__ float lse_from_lanes(float x,
                                                const float (&w)[kMaxStates],
                                                int C) {
  float v[kMaxStates];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i) {
    const float xi = __shfl_sync(kFull, x, i);
    v[i] = i < C ? xi + w[i] : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  if (!isfinite(m)) m = 0.f;  // jax.nn.logsumexp's convention
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i) s += i < C ? expf(v[i] - m) : 0.f;
  return logf(s) + m;
}

// x less its largest value over the lanes on (lanes past C: -inf); every
// lane takes part in the shuffles.
__device__ __forceinline__ float shift(float x, bool on) {
  const float m = warp_max(on ? x : -INFINITY);
  return on ? x - m : -INFINITY;
}

// softmax over the lanes of x (lanes past C excluded), written to *out.
__device__ __forceinline__ void write_softmax(float x, bool on, float* out) {
  const float m = warp_max(on ? x : -INFINITY);
  const float e = on ? expf(x - m) : 0.f;
  const float s = warp_sum(e);
  if (on) *out = e / s;
}

__global__ void __launch_bounds__(32)
    hmm_fb_kernel(const float* __restrict__ E, const float* __restrict__ A,
                  int T, int C, float* gamma) {
  const int lane = threadIdx.x;
  const bool on = lane < C;
  float col[kMaxStates], row[kMaxStates];
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i) {
    col[i] = on && i < C ? A[i * C + lane] : 0.f;
    row[i] = on && i < C ? A[lane * C + i] : 0.f;
  }

  // forward: gamma's row t holds alpha_t
  float a = shift(on ? E[lane] - logf((float)C) : -INFINITY, on);
  if (on) gamma[lane] = a;
  float cur[kGroup], nxt[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    cur[k] = on && 1 + k < T ? E[(1 + k) * C + lane] : 0.f;
  for (int t0 = 1; t0 < T; t0 += kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int t = t0 + kGroup + k;
      nxt[k] = on && t < T ? E[t * C + lane] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int t = t0 + k;
      if (t < T) {  // warp-uniform
        a = shift(lse_from_lanes(a, col, C) + cur[k], on);
        if (on) gamma[t * C + lane] = a;
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
  }

  // backward: beta_{T-1} = 0, then gamma_t from alpha_t + beta_t
  float b = 0.f;
  write_softmax(on ? gamma[(T - 1) * C + lane] : 0.f, on,
                gamma + (T - 1) * C + lane);
  float cur_e[kGroup], cur_a[kGroup], nxt_e[kGroup], nxt_a[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int t = T - 2 - k;
    cur_e[k] = on && t >= 0 ? E[(t + 1) * C + lane] : 0.f;
    cur_a[k] = on && t >= 0 ? gamma[t * C + lane] : 0.f;
  }
  for (int t0 = T - 2; t0 >= 0; t0 -= kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int t = t0 - kGroup - k;
      nxt_e[k] = on && t >= 0 ? E[(t + 1) * C + lane] : 0.f;
      nxt_a[k] = on && t >= 0 ? gamma[t * C + lane] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int t = t0 - k;
      if (t >= 0) {  // warp-uniform
        b = shift(lse_from_lanes(cur_e[k] + b, row, C), on);
        write_softmax(cur_a[k] + b, on, gamma + t * C + lane);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      cur_e[k] = nxt_e[k];
      cur_a[k] = nxt_a[k];
    }
  }
}

}  // namespace

extern "C" {

// E (T, C) and A (C, C) fp32 row-major on `device`; gamma (T, C) fp32 out.
int acoss_hmm_fb(const float* E, const float* A, int T, int C, float* gamma,
                 int device, void* stream) {
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > kMaxStates || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  hmm_fb_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(E, A, T, C, gamma);
  return (int)cudaGetLastError();
}

}  // extern "C"
