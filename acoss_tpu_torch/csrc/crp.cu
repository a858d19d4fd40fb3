// Fused binary CRP builder: squared-Euclidean CSM -> m-frame diagonal
// window sum -> exact mutual k-nearest-neighbour binarization -> uint8 CRP.
//
// Replaces the TPU kernel `acoss_tpu/ops/crp_pallas.py` `_fused_kernel`
// (:57, wrapper `fused_binary_crp_batch` :163) for the surface Serra09 uses
// (metric "sqeuclidean", mutual, 0 < kappa < 1), and computes exactly what
// `acoss_tpu_torch.ops.crp_cuda.fused_binary_crp_ref` computes.
//
// What bounds it on the H100: the TPU kernel keeps a whole (L, L) windowed
// matrix per pair in fast memory and searches its rows and columns there.
// At L = 512 that matrix is 1 MB, more than the 227 KB of shared memory a
// block has, so the windowed matrix W goes through device memory once:
// written by the row pass, read once by the column pass (its valid cells,
// ~2 x 34 MB at the Serra09 tile's B = 64, L = 512, plus the 16 MB CRP:
// ~21 us at 3.35 TB/s, above the 8 us operations bound). Past that, what
// costs time is the CSM's fp32 multiplies and adds, which must stay
// unfused and in index order, and latency: each line's exact k-th
// smallest is a chain of dependent count-and-halve steps.
//
// Design, two launches on one stream:
//  1. band_kernel, one block per (pair, band of `rb` rows; 16 at L = 512,
//     so that four blocks share an SM): a thread keeps one column of Y in
//     registers and builds that column of the band's rb + m - 1 CSM rows
//     in shared memory, reading each X row as float4 broadcasts (Serra09's
//     d = 12 and 13 are compiled in). Then each warp takes whole rows: a
//     lane sums the m-term diagonal window of L/32 columns into registers
//     (its keys), writes them to W, and the warp finds the row's threshold
//     with the keys in registers (`warp_kth`: warp reductions, no block
//     barrier). No sqrt: the ranks of the squared sums equal those of the
//     Euclidean ones. Every dot product and window sum is taken in index
//     order with __fmul_rn/__fadd_rn (no FMA contraction, no tensor
//     cores), the order of the plain version, so W is bit-equal to it.
//  2. strip_kernel, one block per (pair, strip of `cw` columns; 16 at
//     L = 512): stages the strip's valid rows of W in shared memory as
//     coalesced row segments, several loads in flight a thread (odd row
//     stride, so a warp reading a column hits 32 banks), each warp finds
//     its columns' thresholds with the keys in registers, and the block
//     writes the strip of S = (v <= t_row[i]) & (v <= t_col[j]) from the
//     staged values. Six blocks share an SM, so one block's loads overlap
//     another's searches.
// Cells outside (l1e, l2e) are +inf in the plain version; here they are
// never computed, written or read (the keys stand in as 0xFFFFFFFF, above
// every threshold), bands and strips wholly outside only write their
// constants, and a pair whose rounded neighbour count is 0 gets an
// all-zero CRP. k = rint(kappa * length) rounds half to even, as
// jnp.round and torch.round do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"
#include "select.cuh"

namespace {

using acoss::kNoKey;       // above every threshold
using acoss::warp_kth;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxFiniteBits = 0x7F7FFFFFu;
constexpr int kMaxKeysPerLane = 192;        // lines of up to 6,144
constexpr int kLoads = 8;    // loads in flight a thread in the strip kernel
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ int effective(int len, int L, int m) {
  return max(min(len, L) - m + 1, 0);
}

__device__ __forceinline__ float round_k(float kappa, int len) {
  return rintf(__fmul_rn(kappa, (float)len));
}

constexpr int kRegDims = 16;   // feature dims a thread keeps in registers
// blocks of the band kernel an SM should hold (its searches are latency
// bound); a taller band is taken only while this many still fit
constexpr int kBandBlocksPerSm = 4;

// X row stride in shared memory: whole float4s
__host__ __device__ __forceinline__ int x_stride(int d) {
  return (d + 3) & ~3;
}

size_t band_smem(int L, int d, int m, int rb) {
  const size_t R = rb + m - 1;
  return sizeof(float) * (R * x_stride(d) + R + R * L);
}

size_t strip_smem(int L, int cw) {
  return sizeof(unsigned) * (size_t)L * (cw + 1);
}

// The tallest band of which kBandBlocksPerSm blocks fit an SM, else the
// tallest that fits at all, and the widest strip that fits; 0 when none
// does.
int band_rows(int L, int d, int m) {
  for (int rb = 32; rb >= 1; rb /= 2)
    if (band_smem(L, d, m, rb) * kBandBlocksPerSm <= kMaxSmem) return rb;
  for (int rb = 32; rb >= 1; rb /= 2)
    if (band_smem(L, d, m, rb) <= kMaxSmem) return rb;
  return 0;
}

int strip_cols(int L) {
  for (int cw = 16; cw >= 8; cw /= 2)
    if (strip_smem(L, cw) <= kMaxSmem) return cw;
  return 0;
}

// grid (ceil(L / rb), B). Writes W's valid cells of the band's rows and
// t_row of each of its rows. K: keys per lane, L <= 32 K.
template <int K, int kD>
__global__ void __launch_bounds__(kThreads)
band_kernel(const float* __restrict__ X, const float* __restrict__ Y,
            const int* __restrict__ l1, const int* __restrict__ l2, int L,
            int d_, int m, int rb, float kappa, float* __restrict__ W,
            unsigned* __restrict__ t_row) {
  // kD > 0: the feature width, known when compiled (Serra09's 12 and 13)
  const int d = kD > 0 ? kD : d_;
  extern __shared__ float sh[];
  const int dx = x_stride(d), R = rb + m - 1;
  float* xs = sh;                 // (R, dx)
  float* sx = xs + R * dx;        // (R,)
  float* cs = sx + R;             // (R, L): CSM rows i0 .. i0 + R - 1
  const int b = blockIdx.y, i0 = blockIdx.x * rb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l1e = effective(l1[b], L, m), l2e = effective(l2[b], L, m);
  const int nr = l2e > 0 ? min(rb, l1e - i0) : 0;  // rows with keys
  unsigned* tr = t_row + (size_t)b * L + i0;
  // rows outside the valid block hold only +inf: no threshold selects it
  for (int r = max(nr, 0) + threadIdx.x; r < rb && i0 + r < L;
       r += kThreads)
    tr[r] = kMaxFiniteBits;
  if (nr <= 0) return;
  const int nx = nr + m - 1;      // CSM rows the windows reach (< l1)
  const int ny = l2e + m - 1;     // CSM columns they reach (== l2)
  const float* Xb = X + ((size_t)b * L + i0) * d;
  const float* Yb = Y + (size_t)b * L * d;
  for (int t = threadIdx.x; t < nx * d; t += kThreads) {
    const int r = t / d;
    xs[r * dx + t - r * d] = Xb[t];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nx; r += kThreads) {
    const float* x = xs + r * dx;
    float s = __fmul_rn(x[0], x[0]);
    for (int k = 1; k < d; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
    sx[r] = s;
  }
  __syncthreads();
  // a thread builds column j of every CSM row of the band, with Y[j] in
  // registers and each X row read as float4 broadcasts
  for (int j = threadIdx.x; j < ny; j += kThreads) {
    const float* yg = Yb + (size_t)j * d;
    float y[kRegDims];
#pragma unroll
    for (int k = 0; k < kRegDims; ++k) y[k] = k < d ? __ldg(yg + k) : 0.0f;
    float sy = __fmul_rn(y[0], y[0]);
#pragma unroll
    for (int k = 1; k < kRegDims; ++k)
      if (k < d) sy = __fadd_rn(sy, __fmul_rn(y[k], y[k]));
    for (int k = kRegDims; k < d; ++k)
      sy = __fadd_rn(sy, __fmul_rn(__ldg(yg + k), __ldg(yg + k)));
    for (int r = 0; r < nx; ++r) {
      const float* x = xs + r * dx;
      float xy = 0.0f;
#pragma unroll
      for (int q = 0; q < kRegDims / 4; ++q) {
        if (4 * q >= d) break;
        const float4 v = reinterpret_cast<const float4*>(x)[q];
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * q + e;
          if (k == 0) xy = __fmul_rn(xv[0], y[0]);
          else if (k < d) xy = __fadd_rn(xy, __fmul_rn(xv[e], y[k]));
        }
      }
      for (int k = kRegDims; k < d; ++k)
        xy = __fadd_rn(xy, __fmul_rn(x[k], __ldg(yg + k)));
      const float c = __fsub_rn(__fadd_rn(sx[r], sy), __fmul_rn(2.0f, xy));
      cs[r * L + j] = fmaxf(c, 0.0f);
    }
  }
  __syncthreads();
  // rows keep round(kappa * l2e) neighbours
  const int k = (int)fmaxf(round_k(kappa, l2e), 1.0f);
  for (int r = warp; r < nr; r += kWarps) {
    float* Wr = W + ((size_t)b * L + i0 + r) * L;
    unsigned key[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int j = lane + 32 * t;
      key[t] = kNoKey;
      if (j < l2e) {
        // i + k < l1 and j + k < l2: the window stays in the staged block
        float acc = cs[r * L + j];
        for (int q = 1; q < m; ++q)
          acc = __fadd_rn(acc, cs[(r + q) * L + j + q]);
        Wr[j] = acc;
        key[t] = __float_as_uint(acc);
      }
    }
    const unsigned t = warp_kth(key, k, kMaxFiniteBits);
    if (lane == 0) tr[r] = t;
  }
}

// grid (ceil(L / cw), B). Writes the strip's columns of S, every row.
template <int K>
__global__ void __launch_bounds__(kThreads)
strip_kernel(const float* __restrict__ W, const unsigned* __restrict__ t_row,
             const int* __restrict__ l1, const int* __restrict__ l2, int L,
             int m, int cw, float kappa, uint8_t* __restrict__ S) {
  extern __shared__ unsigned strip[];   // (L, cw + 1), rows < l1e
  __shared__ unsigned t_col[32];
  const int b = blockIdx.y, q0 = blockIdx.x * cw, cs = cw + 1;
  const int cw_log2 = __ffs(cw) - 1;          // cw is a power of two
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l1e = effective(l1[b], L, m), l2e = effective(l2[b], L, m);
  const bool any = round_k(kappa, l2e) > 0.0f && round_k(kappa, l1e) > 0.0f;
  const int cols = min(cw, L - q0);           // the strip's columns
  const int vc = any ? min(cols, l2e - q0) : 0;  // those with keys
  uint8_t* Sb = S + (size_t)b * L * L + q0;
  if (vc <= 0) {
    for (int t = threadIdx.x; t < L * cw; t += kThreads) {
      const int i = t >> cw_log2, c = t & (cw - 1);
      if (c < cols) Sb[(size_t)i * L + c] = 0;
    }
    return;
  }
  const float* Wb = W + (size_t)b * L * L + q0;
  // coalesced row segments, kLoads of them in flight a thread
  for (int t0 = threadIdx.x; t0 < l1e * cw; t0 += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int t = t0 + u * kThreads, i = t >> cw_log2, c = t & (cw - 1);
      v[u] = t < l1e * cw && c < vc ? __ldg(Wb + (size_t)i * L + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int t = t0 + u * kThreads, i = t >> cw_log2, c = t & (cw - 1);
      if (t < l1e * cw && c < vc) strip[i * cs + c] = __float_as_uint(v[u]);
    }
  }
  __syncthreads();
  // columns keep round(kappa * l1e) neighbours
  const int k = (int)fmaxf(round_k(kappa, l1e), 1.0f);
  for (int c = warp; c < vc; c += kWarps) {
    unsigned key[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int i = lane + 32 * t;
      key[t] = i < l1e ? strip[i * cs + c] : kNoKey;
    }
    const unsigned t = warp_kth(key, k, kMaxFiniteBits);
    if (lane == 0) t_col[c] = t;
  }
  __syncthreads();
  const unsigned* tr = t_row + (size_t)b * L;
  for (int t = threadIdx.x; t < L * cw; t += kThreads) {
    const int i = t >> cw_log2, c = t & (cw - 1);
    if (c >= cols) continue;
    bool s = false;
    if (i < l1e && c < vc) {
      const unsigned v = strip[i * cs + c];
      s = v <= tr[i] && v <= t_col[c];
    }
    Sb[(size_t)i * L + c] = (uint8_t)s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int K, int kD>
int launch(const float* X, const float* Y, const int* l1, const int* l2,
           int B, int L, int d, int m, float kappa, float* W,
           unsigned* t_row, uint8_t* S, cudaStream_t stream) {
  const int rb = band_rows(L, d, m), cw = strip_cols(L);
  const size_t bsm = band_smem(L, d, m, rb), ssm = strip_smem(L, cw);
  cudaError_t err = allow_smem(band_kernel<K, kD>, bsm);
  if (err == cudaSuccess) err = allow_smem(strip_kernel<K>, ssm);
  if (err != cudaSuccess) return (int)err;
  band_kernel<K, kD><<<dim3((L + rb - 1) / rb, B), kThreads, bsm,
                       stream>>>(X, Y, l1, l2, L, d, m, rb, kappa, W, t_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  strip_kernel<K><<<dim3((L + cw - 1) / cw, B), kThreads, ssm, stream>>>(
      W, t_row, l1, l2, L, m, cw, kappa, S);
  return (int)cudaGetLastError();
}

// Serra09's widths (chroma 12, mfcc 13) compiled in, up to L = 1,024
template <int K>
int launch_k(const float* X, const float* Y, const int* l1, const int* l2,
             int B, int L, int d, int m, float kappa, float* W,
             unsigned* t_row, uint8_t* S, cudaStream_t stream) {
  if constexpr (K <= 32) {
    if (d == 12)
      return launch<K, 12>(X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S,
                           stream);
    if (d == 13)
      return launch<K, 13>(X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S,
                           stream);
  }
  return launch<K, 0>(X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S, stream);
}

}  // namespace

extern "C" {

// The larger of the two kernels' shared memory per block at the band
// height and strip width they would take; 0 if L, d or m is out of range
// or no band or strip fits.
size_t acoss_fused_crp_smem(int L, int d, int m) {
  if (L <= 0 || d <= 0 || m <= 0 || L > 32 * kMaxKeysPerLane) return 0;
  const int rb = band_rows(L, d, m), cw = strip_cols(L);
  if (rb == 0 || cw == 0) return 0;
  const size_t a = band_smem(L, d, m, rb), s = strip_smem(L, cw);
  return a > s ? a : s;
}

int acoss_fused_crp(const float* X, const float* Y, const int* l1,
                    const int* l2, int B, int L, int d, int m, float kappa,
                    float* W, unsigned* t_row, uint8_t* S, int device,
                    void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (acoss_fused_crp_smem(L, d, m) == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  // keys per lane: the first that covers a line of L (16 up to L = 512)
  const int kpl = (L + 31) / 32;
  if (kpl <= 16)
    return launch_k<16>(X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S, stream);
  if (kpl <= 32)
    return launch_k<32>(X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S, stream);
  if (kpl <= 64)
    return launch_k<64>(X, Y, l1, l2, B, L, d, m, kappa, W, t_row, S, stream);
  return launch_k<kMaxKeysPerLane>(X, Y, l1, l2, B, L, d, m, kappa, W,
                                   t_row, S, stream);
}

}  // extern "C"
