// Fused binary CRP builder: squared-Euclidean CSM -> m-frame diagonal
// window sum -> exact mutual k-nearest-neighbour binarization -> uint8 CRP.
//
// Replaces the TPU kernel `acoss_tpu/ops/crp_pallas.py` `_fused_kernel`
// (:57, wrapper `fused_binary_crp_batch` :163) for the surface Serra09 uses
// (metric "sqeuclidean", mutual, 0 < kappa < 1), and computes exactly what
// `acoss_tpu_torch.ops.crp_cuda.fused_binary_crp_ref` computes.
//
// What bounds it on the H100: the TPU kernel keeps a whole (L, L) matrix per
// pair in fast memory and searches it 31 times. At L = 512 that matrix is
// 1 MB, which does not fit the 227 KB of shared memory a block can use, so
// here the windowed (B, L, L) fp32 matrix goes through device memory
// (64 MB for 64 pairs): the passes are bound by that traffic and by the
// latency of the 31 dependent count-and-halve steps of every row and
// column search.
//
// Design, three launches on one stream:
//  1. window_kernel, one block per (pair, tile of kRowTile rows): the pair's
//     Y block and the X rows the tile's windows reach are staged in shared
//     memory, the CSM rows of the tile are built there, and the m-term
//     diagonal sums are written out; +inf outside (l1e, l2e). No sqrt: the
//     ranks of the squared sums equal those of the Euclidean ones. Every
//     dot product and window sum is taken in index order with
//     __fmul_rn/__fadd_rn (no FMA contraction), the order of the plain
//     version, so the windowed matrix is bit-equal to it.
//  2. threshold_kernel, one block per (pair, row or column): the exact k-th
//     smallest of the line by a binary search over fp32 bit patterns
//     (monotone for non-negative floats), 31 passes of a block-wide count,
//     the search the TPU kernel runs. Ties at the k-th value are all kept.
//  3. mask_kernel: S = (v <= t_row[i]) & (v <= t_col[j]), and an all-zero
//     CRP for a pair whose rounded neighbour count is 0.
// k = rint(kappa * length) rounds half to even, as jnp.round and
// torch.round do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;
constexpr unsigned kMaxFiniteBits = 0x7F7FFFFFu;

__device__ __forceinline__ int effective(int len, int m) {
  return max(len - m + 1, 0);
}

__device__ __forceinline__ float round_k(float kappa, int len) {
  return rintf(__fmul_rn(kappa, (float)len));
}

__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              const int* __restrict__ l1, const int* __restrict__ l2,
              int L, int d, int m, float* __restrict__ W) {
  extern __shared__ float sh[];
  const int R = kRowTile + m - 1;        // CSM rows the windows reach
  float* ys = sh;                        // (L, d)
  float* sy = ys + L * d;                // (L,)
  float* xs = sy + L;                    // (R, d)
  float* sx = xs + R * d;                // (R,)
  float* cs = sx + R;                    // (R, L) CSM rows i0 .. i0+R-1
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRowTile;
  const float* Xb = X + (size_t)b * L * d;
  const float* Yb = Y + (size_t)b * L * d;
  const int l1e = effective(l1[b], m), l2e = effective(l2[b], m);

  for (int t = threadIdx.x; t < L * d; t += kThreads) ys[t] = Yb[t];
  for (int t = threadIdx.x; t < R * d; t += kThreads) {
    const int r = i0 + t / d;
    xs[t] = r < L ? Xb[(size_t)i0 * d + t] : 0.0f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += kThreads) {
    const float* y = ys + j * d;
    float s = __fmul_rn(y[0], y[0]);
    for (int k = 1; k < d; ++k) s = __fadd_rn(s, __fmul_rn(y[k], y[k]));
    sy[j] = s;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float* x = xs + r * d;
    float s = __fmul_rn(x[0], x[0]);
    for (int k = 1; k < d; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
    sx[r] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * L; t += kThreads) {
    const int r = t / L, j = t - r * L;
    const float* x = xs + r * d;
    const float* y = ys + j * d;
    float xy = __fmul_rn(x[0], y[0]);
    for (int k = 1; k < d; ++k) xy = __fadd_rn(xy, __fmul_rn(x[k], y[k]));
    const float c = __fsub_rn(__fadd_rn(sx[r], sy[j]), __fmul_rn(2.0f, xy));
    cs[t] = fmaxf(c, 0.0f);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kRowTile * L; t += kThreads) {
    const int r = t / L, j = t - r * L, i = i0 + r;
    if (i >= L) break;
    float acc = INFINITY;
    if (i < l1e && j < l2e) {
      // i + k < l1 <= L and j + k < l2 <= L: the window stays in range
      acc = cs[r * L + j];
      for (int k = 1; k < m; ++k)
        acc = __fadd_rn(acc, cs[(r + k) * L + j + k]);
    }
    W[((size_t)b * L + i) * L + j] = acc;
  }
}

// grid (L, B, 2): blockIdx.z == 0 searches row blockIdx.x, 1 column.
__global__ void __launch_bounds__(kThreads)
threshold_kernel(const float* __restrict__ W, const int* __restrict__ l1,
                 const int* __restrict__ l2, int L, int m, float kappa,
                 unsigned* __restrict__ thr) {
  extern __shared__ unsigned line[];
  __shared__ int red[2][kThreads / 32];
  const int b = blockIdx.y, col = blockIdx.z, q = blockIdx.x;
  const int l1e = effective(l1[b], m), l2e = effective(l2[b], m);
  unsigned* out = thr + ((size_t)b * 2 + col) * L + q;
  // A line outside the valid block holds only +inf, which no threshold
  // <= kMaxFiniteBits selects; the search would end there too.
  if (q >= (col ? l2e : l1e)) {
    if (threadIdx.x == 0) *out = kMaxFiniteBits;
    return;
  }
  const float* Wb = W + (size_t)b * L * L;
  for (int t = threadIdx.x; t < L; t += kThreads)
    line[t] = __float_as_uint(col ? Wb[(size_t)t * L + q]
                                  : Wb[(size_t)q * L + t]);
  // rows keep round(kappa * l2e) neighbours, columns round(kappa * l1e)
  const int k = (int)fmaxf(round_k(kappa, col ? l1e : l2e), 1.0f);
  __syncthreads();
  unsigned lo = 0, hi = kMaxFiniteBits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = 0; it < 31; ++it) {
    const unsigned mid = lo + (hi - lo) / 2;
    int cnt = 0;
    for (int t = threadIdx.x; t < L; t += kThreads) cnt += line[t] <= mid;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) red[it & 1][warp] = cnt;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += red[it & 1][w];
    if (total >= k) hi = mid; else lo = mid + 1;
  }
  if (threadIdx.x == 0) *out = hi;
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ W, const unsigned* __restrict__ thr,
            const int* __restrict__ l1, const int* __restrict__ l2, int L,
            int m, float kappa, uint8_t* __restrict__ S) {
  const int b = blockIdx.y, i = blockIdx.x;
  const int l1e = effective(l1[b], m), l2e = effective(l2[b], m);
  const bool any = round_k(kappa, l2e) > 0.0f && round_k(kappa, l1e) > 0.0f;
  const unsigned* tr = thr + (size_t)b * 2 * L;
  const unsigned* tc = tr + L;
  const unsigned ti = tr[i];
  const float* Wr = W + ((size_t)b * L + i) * L;
  uint8_t* Sr = S + ((size_t)b * L + i) * L;
  for (int j = threadIdx.x; j < L; j += kThreads) {
    const unsigned v = __float_as_uint(Wr[j]);
    Sr[j] = (uint8_t)(any && v <= ti && v <= tc[j]);
  }
}

}  // namespace

extern "C" {

// Shared memory window_kernel needs for one block; 0 if L, d or m is
// out of range.
size_t acoss_fused_crp_smem(int L, int d, int m) {
  if (L <= 0 || d <= 0 || m <= 0) return 0;
  const size_t R = kRowTile + m - 1;
  return sizeof(float) * ((size_t)L * d + L + R * d + R + R * L);
}

int acoss_fused_crp(const float* X, const float* Y, const int* l1,
                    const int* l2, int B, int L, int d, int m, float kappa,
                    float* W, unsigned* thr, uint8_t* S, int device,
                    void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = acoss_fused_crp_smem(L, d, m);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_kernel<<<dim3((L + kRowTile - 1) / kRowTile, B), kThreads, smem,
                  stream>>>(X, Y, l1, l2, L, d, m, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  threshold_kernel<<<dim3(L, B, 2), kThreads, L * sizeof(unsigned),
                     stream>>>(W, l1, l2, L, m, kappa, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mask_kernel<<<dim3(L, B), kThreads, 0, stream>>>(W, thr, l1, l2, L, m,
                                                   kappa, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
