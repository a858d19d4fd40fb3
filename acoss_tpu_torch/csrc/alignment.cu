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
// (shared-memory reads, a block barrier) times M is.
//
// Design: one thread block per pair, threads striding over the N columns.
// The previous D rows (2 for qmax and SW, 3 for dmax) live in shared memory
// as a ring, so a row step touches device memory only to read its CRP bytes
// (the S values of rows i-1..i-3 that dmax adds, and the predecessors' S
// that set the unequal-gap and SW penalties, come from the L1 cache).
// One __syncthreads() per row separates writing row i from reading it as
// row i-1. Cells outside (m_len, n_len) are never computed (they stay 0),
// so the kernel needs no zero-padding argument and no guard on the gaps.
// Each thread keeps a running max, reduced over the block at the end.
// Every operation is the same fp32 operation in the same order as the
// plain version (the additions as __fadd_rn / __fsub_rn, so nothing is
// contracted), so the scores are bit-equal to it, also where the gaps
// (SW's -0.7) are not exact in fp32.
//
// The TPU kernels' transposed pair-on-lane layout, pre-rolled carries,
// -BIG row/column biases and block_b/block_t tiling are TPU choices and are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
qmax_kernel(const uint8_t* __restrict__ S, const int* __restrict__ m_len,
            const int* __restrict__ n_len, int M, int N, float gap,
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
    const uint8_t* row = Sb + (size_t)i * N;
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float v = 0.0f;
      if (j >= 2 && j < n) {
        const float pre = fmaxf(fmaxf(d1[j - 1], d2[j - 1]), d1[j - 2]);
        v = row[j] ? pre + 1.0f : fmaxf(pre - gap, 0.0f);
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

__global__ void __launch_bounds__(kThreads)
dmax_kernel(const uint8_t* __restrict__ S, const int* __restrict__ m_len,
            const int* __restrict__ n_len, int M, int N, float gap,
            float* __restrict__ out) {
  extern __shared__ float sh[];
  float* d0 = sh;          // D row i (being written)
  float* d1 = sh + N;      // D row i-1
  float* d2 = sh + 2 * N;  // D row i-2
  float* d3 = sh + 3 * N;  // D row i-3
  const int b = blockIdx.x;
  const int m = min(m_len[b], M), n = min(n_len[b], N);
  for (int j = threadIdx.x; j < 4 * N; j += kThreads) sh[j] = 0.0f;
  __syncthreads();
  const uint8_t* Sb = S + (size_t)b * M * N;
  float best = 0.0f;
  for (int i = 3; i < m; ++i) {
    const uint8_t* s0 = Sb + (size_t)i * N;   // S row i
    const uint8_t* s1 = s0 - N;               // S row i-1
    const uint8_t* s2 = s1 - N;               // S row i-2
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float v = 0.0f;
      if (j >= 3 && j < n) {
        const float a1 = (float)__ldg(s1 + j);       // S[i-1, j]
        const float a2 = (float)__ldg(s2 + j);       // S[i-2, j]
        const float c1 = (float)__ldg(s0 + j - 1);   // S[i, j-1]
        const float c2 = (float)__ldg(s0 + j - 2);   // S[i, j-2]
        const float p1 = d1[j - 1];
        const float p2 = d2[j - 1] + a1;
        const float p3 = d1[j - 2] + c1;
        const float p4 = (d3[j - 1] + a2) + a1;
        const float p5 = (d1[j - 3] + c2) + c1;
        const float m5 = fmaxf(fmaxf(fmaxf(p1, p2), p3), fmaxf(p4, p5));
        // max over paths of (p - gap) == (max over paths of p) - gap: a
        // rounded subtraction is monotone, so this is exact.
        v = __ldg(s0 + j) ? m5 + 1.0f : fmaxf(m5 - gap, 0.0f);
      }
      d0[j] = v;
      best = fmaxf(best, v);
    }
    __syncthreads();
    float* t = d3;
    d3 = d2;
    d2 = d1;
    d1 = d0;
    d0 = t;
  }
  best = block_max(best);
  if (threadIdx.x == 0)
    out[b] = (m_len[b] >= 4 && n_len[b] >= 4) ? best : 0.0f;
}

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
  cudaError_t err = cudaSetDevice(device);
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

}  // namespace

extern "C" {

int acoss_qmax(const uint8_t* S, const int* m_len, const int* n_len, int B,
               int M, int N, float gap, float* out, int device,
               void* stream) {
  return launch(qmax_kernel, 3, B, N, device, (cudaStream_t)stream, S,
                m_len, n_len, M, N, gap, out);
}

int acoss_dmax(const uint8_t* S, const int* m_len, const int* n_len, int B,
               int M, int N, float gap, float* out, int device,
               void* stream) {
  return launch(dmax_kernel, 4, B, N, device, (cudaStream_t)stream, S,
                m_len, n_len, M, N, gap, out);
}

int acoss_qmax_uneq(const uint8_t* S, const int* m_len, const int* n_len,
                    int B, int M, int N, float gap_onset,
                    float gap_extension, float* out, int device,
                    void* stream) {
  return launch(qmax_uneq_kernel, 3, B, N, device, (cudaStream_t)stream, S,
                m_len, n_len, M, N, gap_onset, gap_extension, out);
}

int acoss_sw(const uint8_t* S, const int* m_len, const int* n_len, int B,
             int M, int N, float gap_opening, float gap_extension,
             float match_score, float mismatch_score, float* out,
             int device, void* stream) {
  return launch(sw_kernel, 3, B, N, device, (cudaStream_t)stream, S, m_len,
                n_len, M, N, gap_opening, gap_extension, match_score,
                mismatch_score, out);
}

const char* acoss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
