// The selection kernels of the SNF slice (EarlySNF and Serra09's ssms
// channel): exact per-line order statistics of built fp32 matrices.
//
// Replaces three TPU kernels of `acoss_tpu/ops/crp_pallas.py`, and
// computes what the plain versions in `acoss_tpu_torch/ops/crp_cuda.py`
// compute:
//  1. `_binarize_kernel` (:276, wrapper `binarize_matrix_batch` :355):
//     exact mutual-kNN binarization of a (B, L, L) matrix that may be
//     negative -> uint8 CRP (plain: `binarize_matrix_ref`, bit-equal).
//  2. `_knn_mask_kernel` (:431, `knn_mask_matrix_batch` :728): get_S's
//     rank threshold, W where W >= its row's k-th largest, else 0
//     (plain: `knn_mask_matrix_ref`, bit-equal).
//  3. `_wcsmssm_kernel` (:598, `wcsmssm_batch` :707): the SNF parent
//     affinity [[W_SSMA, W_CSM], [W_CSM^T, W_SSMB]] (plain:
//     `wcsmssm_ref` = `fusion.get_WCSMSSM`, value-equal: the
//     neighbourhood means are summed in another order).
//
// What bounds them on the H100: every output needs a line statistic (the
// k-th value of a row or column of 512..1024 floats), found by 32
// dependent count-and-halve passes. The TPU kernels keep whole (L, L)
// matrices in VMEM and search all lines of a pair at once; a block here
// has 227 KB of shared memory, and one (1024, 1024) fp32 matrix is 4 MB.
// So the design is one block per line: the line's keys (and values) go to
// shared memory once (at most 8 KB), each pass is a block-wide count with
// one barrier, and the many independent lines (65k..262k blocks a call)
// keep the SMs busy while each one waits on its barriers. The matrices are
// read from device memory twice (search, then mask or affinity), and a
// column line is a strided read; both are small next to the passes.
// The TPU-only parts (two pairs a grid step, the `dual` layout, VMEM slab
// sizing, custom_vmap) have no counterpart: a launch takes a flat batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select.cuh"

namespace {

using acoss::block_kth_key;
using acoss::float_key;
using acoss::key_float;
using acoss::kInfBits;
using acoss::kMaxFiniteBits;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// fusion._BIG: the stand-in distance of padded cells
constexpr float kBig = 1e30f;

// round(kappa * len) in fp32, half to even (jnp.round / torch.round)
__device__ __forceinline__ float round_k(float kappa, int len) {
  return rintf(__fmul_rn(kappa, (float)len));
}

// ---------------------------------------------------------------- 1 ------
// grid (L, B, 2): blockIdx.z == 0 searches row blockIdx.x, 1 the column.
// A row keeps round(kappa * l2) neighbours among its l2 valid cells, a
// column round(kappa * l1) among its l1 (at least 1 each; a pair whose
// rounded count is 0 is zeroed by the mask kernel).
__global__ void __launch_bounds__(kThreads)
binarize_threshold_kernel(const float* __restrict__ D,
                          const int* __restrict__ l1,
                          const int* __restrict__ l2, int L, float kappa,
                          int* __restrict__ thr) {
  extern __shared__ int line[];
  __shared__ int red[2 * kWarps];
  const int b = blockIdx.y, col = blockIdx.z, q = blockIdx.x;
  const int r1 = l1[b], r2 = l2[b];
  int* out = thr + ((size_t)b * 2 + col) * L + q;
  // a line outside the valid block holds only masked cells
  if (q >= (col ? r2 : r1)) {
    if (threadIdx.x == 0) *out = kMaxFiniteBits;
    return;
  }
  // masked cells key to +inf, above every finite key: they never count,
  // so only the valid prefix of the line is searched
  const int n = min(max(col ? r1 : r2, 0), L);
  const float* Db = D + (size_t)b * L * L;
  for (int t = threadIdx.x; t < n; t += kThreads)
    line[t] = float_key(col ? Db[(size_t)t * L + q] : Db[(size_t)q * L + t]);
  const int k = (int)fmaxf(round_k(kappa, col ? r1 : r2), 1.0f);
  __syncthreads();
  const int t = block_kth_key<kThreads>(line, n, k, red);
  if (threadIdx.x == 0) *out = t;
}

// grid (L, B): S[b, i, j] = valid && key <= t_row[i] && key <= t_col[j],
// all zero for a pair whose rounded neighbour count is 0.
__global__ void __launch_bounds__(kThreads)
binarize_mask_kernel(const float* __restrict__ D, const int* __restrict__ thr,
                     const int* __restrict__ l1, const int* __restrict__ l2,
                     int L, float kappa, uint8_t* __restrict__ S) {
  const int b = blockIdx.y, i = blockIdx.x;
  const int r1 = l1[b], r2 = l2[b];
  const bool any = round_k(kappa, r2) > 0.0f && round_k(kappa, r1) > 0.0f;
  const int* tr = thr + (size_t)b * 2 * L;
  const int* tc = tr + L;
  const int ti = tr[i];
  const float* Dr = D + ((size_t)b * L + i) * L;
  uint8_t* Sr = S + ((size_t)b * L + i) * L;
  for (int j = threadIdx.x; j < L; j += kThreads) {
    bool s = false;
    if (any && i < r1 && j < r2) {
      const int key = float_key(Dr[j]);
      s = key <= ti && key <= tc[j];
    }
    Sr[j] = (uint8_t)s;
  }
}

// ---------------------------------------------------------------- 2 ------
// grid (n, B): one block per row. Keys of -W (largest) or W (smallest);
// the row keeps the cells whose key is <= its k-th smallest, k clamped to
// [1, n], and writes W there and +0.0 elsewhere.
__global__ void __launch_bounds__(kThreads)
knn_mask_kernel(const float* __restrict__ W, const int* __restrict__ k,
                int n, int largest, float* __restrict__ V) {
  extern __shared__ int line[];
  __shared__ int red[2 * kWarps];
  const int b = blockIdx.y;
  const size_t row = ((size_t)b * n + blockIdx.x) * n;
  const float* Wr = W + row;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float w = Wr[t];
    line[t] = float_key(largest ? -w : w);
  }
  const int kk = min(max(k[b], 1), n);
  __syncthreads();
  const int t = block_kth_key<kThreads>(line, n, kk, red);
  float* Vr = V + row;
  for (int j = threadIdx.x; j < n; j += kThreads)
    Vr[j] = line[j] <= t ? Wr[j] : 0.0f;
}

// ---------------------------------------------------------------- 3 ------
__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The neighbour budget split of `SimilarityFusion.py:110-132`.
__device__ __forceinline__ void split_k(int K, int m, int n, int* k1,
                                        int* k2) {
  *k1 = floordiv(K * m, max(m + n, 1));
  *k2 = K - *k1;
}

// get_W's symmetrized, zero-diagonal self-dissimilarity of A at (i, j)
__device__ __forceinline__ float dsym(const float* A, int L, int i, int j) {
  return i == j ? 0.0f : 0.5f * (A[(size_t)i * L + j] + A[(size_t)j * L + i]);
}

// grid (L, B, 4), one block per line statistic of pair b:
//   z = 0: row q of DSym(SSMA), columns >= l1 -> BIG: the mean of its
//          clip(k1 + 1) smallest, scaled by (k1 + 1) / max(k1, 1)
//   z = 1: the same for SSMB with l2 and k2
//   z = 2: row q of the CSM, cells outside (l1, l2) -> BIG: the mean of
//          its clip(k2) smallest
//   z = 3: column q of the CSM: the mean of its clip(k1) smallest
// (clip to [1, L]). The mean of the k smallest is sum(v < t) +
// (k - count(v < t)) * t over k, t the k-th smallest value: the TPU
// kernel's formula. Lines outside the valid block are never read.
__global__ void __launch_bounds__(kThreads)
wcsmssm_stats_kernel(const float* __restrict__ SA,
                     const float* __restrict__ SB,
                     const float* __restrict__ C, const int* __restrict__ l1,
                     const int* __restrict__ l2, const int* __restrict__ Ks,
                     int L, float* __restrict__ stats) {
  extern __shared__ int line[];          // (L,) keys then (L,) values
  float* vals = reinterpret_cast<float*>(line + L);
  __shared__ int red[2 * kWarps];
  __shared__ float fsum[kWarps];
  __shared__ int isum[kWarps];
  const int b = blockIdx.y, z = blockIdx.z, q = blockIdx.x;
  const int m = l1[b], n = l2[b];
  int k1, k2;
  split_k(Ks[b], m, n, &k1, &k2);
  float* out = stats + ((size_t)b * 4 + z) * L + q;
  if (q >= (z == 1 || z == 3 ? n : m)) {
    if (threadIdx.x == 0) *out = 0.0f;
    return;
  }
  const size_t off = (size_t)b * L * L;
  for (int t = threadIdx.x; t < L; t += kThreads) {
    float v;
    if (z == 0) {
      v = t < m ? dsym(SA + off, L, q, t) : kBig;
    } else if (z == 1) {
      v = t < n ? dsym(SB + off, L, q, t) : kBig;
    } else if (z == 2) {
      v = t < n ? C[off + (size_t)q * L + t] : kBig;
    } else {
      v = t < m ? C[off + (size_t)t * L + q] : kBig;
    }
    vals[t] = v;
    line[t] = float_key(v);
  }
  const int kraw = z == 0 ? k1 + 1 : z == 1 ? k2 + 1 : z == 2 ? k2 : k1;
  const int k = min(max(kraw, 1), L);
  __syncthreads();
  const int tk = block_kth_key<kThreads>(line, L, k, red);
  float s = 0.0f;
  int c = 0;
  for (int t = threadIdx.x; t < L; t += kThreads) {
    if (line[t] < tk) {
      s += vals[t];
      ++c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  c = __reduce_add_sync(0xffffffffu, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    fsum[warp] = s;
    isum[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f;
    int tcnt = 0;
    for (int w = 0; w < kWarps; ++w) {
      ts += fsum[w];
      tcnt += isum[w];
    }
    const float kf = (float)k;
    float mean = (ts + (kf - (float)tcnt) * key_float(tk)) / kf;
    if (z < 2) {
      const float Kf = (float)(z == 0 ? k1 : k2);
      mean = mean * (Kf + 1.0f) / fmaxf(Kf, 1.0f);
    }
    *out = mean;
  }
}

// exp(-d^2 / (2 (Mu eps)^2)), eps = (ra + rb + d) / 3, denominator 0 -> 1
__device__ __forceinline__ float affinity(float d, float ra, float rb,
                                          float Mu) {
  const float eps = (ra + rb + d) / 3.0f;
  const float me = Mu * eps;
  float denom = 2.0f * (me * me);
  if (denom == 0.0f) denom = 1.0f;
  return expf(-(d * d) / denom);
}

// grid (2L, B): output row r of [[WA, WC], [WC^T, WB]] (B, 2L, 2L); zero
// outside each block's valid (l1, l2) part.
__global__ void __launch_bounds__(kThreads)
wcsmssm_out_kernel(const float* __restrict__ SA, const float* __restrict__ SB,
                   const float* __restrict__ C, const int* __restrict__ l1,
                   const int* __restrict__ l2, const float* __restrict__ stats,
                   int L, float Mu, float* __restrict__ W) {
  const int b = blockIdx.y, r = blockIdx.x;
  const int m = l1[b], n = l2[b];
  const size_t off = (size_t)b * L * L;
  const float* mA = stats + (size_t)b * 4 * L;
  const float* mB = mA + L;
  const float* m1 = mB + L;
  const float* m2 = m1 + L;
  float* out = W + ((size_t)b * 2 * L + r) * 2 * L;
  for (int c = threadIdx.x; c < 2 * L; c += kThreads) {
    float w = 0.0f;
    if (r < L && c < L) {                       // W_SSMA
      if (r < m && c < m)
        w = affinity(dsym(SA + off, L, r, c), mA[r], mA[c], Mu);
    } else if (r >= L && c >= L) {              // W_SSMB
      const int i = r - L, j = c - L;
      if (i < n && j < n)
        w = affinity(dsym(SB + off, L, i, j), mB[i], mB[j], Mu);
    } else {                                    // W_CSM or its transpose
      const int i = r < L ? r : c, j = r < L ? c - L : r - L;
      if (i < m && j < n)
        w = affinity(C[off + (size_t)i * L + j], m1[i], m2[j], Mu);
    }
    out[c] = w;
  }
}

cudaError_t smem_limit(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int acoss_binarize(const float* D, const int* l1, const int* l2, int B,
                   int L, float kappa, int* thr, uint8_t* S, int device,
                   void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || L == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)L * sizeof(int);
  err = smem_limit((const void*)binarize_threshold_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  binarize_threshold_kernel<<<dim3(L, B, 2), kThreads, smem, stream>>>(
      D, l1, l2, L, kappa, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  binarize_mask_kernel<<<dim3(L, B), kThreads, 0, stream>>>(D, thr, l1, l2,
                                                            L, kappa, S);
  return (int)cudaGetLastError();
}

int acoss_knn_mask(const float* W, const int* k, int B, int n, int largest,
                   float* V, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n * sizeof(int);
  err = smem_limit((const void*)knn_mask_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  knn_mask_kernel<<<dim3(n, B), kThreads, smem, stream>>>(W, k, n, largest,
                                                          V);
  return (int)cudaGetLastError();
}

int acoss_wcsmssm(const float* SA, const float* SB, const float* C,
                  const int* l1, const int* l2, const int* K, int B, int L,
                  float Mu, float* stats, float* W, int device,
                  void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || L == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)L * (sizeof(int) + sizeof(float));
  err = smem_limit((const void*)wcsmssm_stats_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  wcsmssm_stats_kernel<<<dim3(L, B, 4), kThreads, smem, stream>>>(
      SA, SB, C, l1, l2, K, L, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wcsmssm_out_kernel<<<dim3(2 * L, B), kThreads, 0, stream>>>(
      SA, SB, C, l1, l2, stats, L, Mu, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
