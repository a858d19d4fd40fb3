// Fused binary CRP builder: squared-Euclidean CSM -> m-frame diagonal
// window sum -> exact mutual k-nearest-neighbour binarization -> uint8 CRP.
//
// Replaces the TPU kernel `acoss_tpu/ops/crp_pallas.py` `_fused_kernel`
// (:57, wrapper `fused_binary_crp_batch` :163) for the surface Serra09 uses
// (metric "sqeuclidean", mutual, 0 < kappa < 1), and computes exactly what
// `acoss_tpu_torch.ops.crp_cuda.fused_binary_crp_ref` computes.
//
// What bounds it on the H100: the TPU kernel keeps a whole (L, L) windowed
// matrix W per pair in fast memory and searches its rows and columns
// there. At L = 512 W is 1 MB, more than the 227 KB of shared memory a
// block has, but not more than a thread-block cluster of 8 blocks holds
// together (distributed shared memory). What costs time is then the
// instructions themselves: the searches (each line's exact k-th smallest
// is a chain of count-and-halve steps over its keys, 2 L lines a pair)
// and the CSM's fp32 multiplies and adds, which must stay unfused and in
// index order (bit-equal to the plain version, so no FMA and no tensor
// cores). The bytes (the valid rows of X and Y in, the uint8 CRP out) are
// far below either.
//
// Two designs, chosen from (L, d, m) alone (`cluster_size`):
//
// A. One launch, W on chip (lines of up to 512 = kClusterThreads, d up to
//    kRegDims): `band_strip_kernel`, one cluster of C blocks a pair, C the
//    least power of two up to the portable 8 whose slab fits a block's
//    shared memory (1 up to L ~ 200, 2 at 256, 8 at 512). It does B's
//    band and strip work in one launch, and its name says so: the
//    benchmark's fused CRP reader (`portbench/roofline/fused_crp.py`)
//    finds the fused CRP's kernels by `band_kernel` / `strip_kernel`.
//     1. Block r owns ~l1e / C of the pair's valid rows (its slab). A
//        thread owns one column j, with Y[j] in registers, and builds its
//        column of the slab's CSM rows (plus m - 1 rows of halo) into a
//        ring of kChunkRows + m - 1 rows, kCsmRows rows at once, X rows
//        read as float4 broadcasts; the m - 1 rows a chunk shares with
//        the next are carried over, so each CSM cell is computed once. A
//        thread then sums the m-frame windows of its column, kWindowRows
//        rows at once, into the slab of W as keys, column-major with an
//        odd stride, so that a warp reading a row or a column of it hits
//        32 banks.
//     2. The block arrives on the cluster barrier, then its warps take
//        lines from a shared counter: its own rows first (keys from its
//        slab), then, once the barrier has completed (every slab whole),
//        its ~l2e / C columns, whose keys a warp gathers from every
//        block's slab over distributed shared memory (a slab holds a
//        column's rows contiguously, so the reads coalesce). Each line is
//        searched by `warp_kth` with the fewest keys a lane that hold
//        it (10, 12, 14 or 16); a column's threshold is written into
//        every block's copy.
//     3. The block arrives again, zeroes its share of the rows past l1e
//        and waits: the last point at which any block touches another's
//        shared memory, so no block outlives a reader. It then writes its
//        rows of S = (v <= t_row[i]) & (v <= t_col[j]) from its own slab.
//    Nothing of W goes to device memory, and there is no W scratch.
//
// B. Two launches, W through device memory (longer lines, up to 6,144, and
//    d past kRegDims); kept as it was designed for L = 512:
//     1. band_kernel, one block per (pair, band of `rb` rows): a thread
//        keeps one column of Y in registers and builds that column of the
//        band's rb + m - 1 CSM rows in shared memory, reading each X row
//        as float4 broadcasts (Serra09's d = 12 and 13 are compiled in).
//        Then each warp takes whole rows: a lane sums the m-term diagonal
//        window of L/32 columns into registers (its keys), writes them to
//        W, and the warp finds the row's threshold with the keys in
//        registers.
//     2. strip_kernel, one block per (pair, strip of `cw` columns): stages
//        the strip's valid rows of W in shared memory as coalesced row
//        segments, several loads in flight a thread (odd row stride), each
//        warp finds its columns' thresholds with the keys in registers,
//        and the block writes the strip of S from the staged values.
//
// Both: no sqrt (the ranks of the squared sums equal those of the
// Euclidean ones); every dot product and window sum is taken in index
// order with __fmul_rn/__fadd_rn, the order of the plain version, so W is
// bit-equal to it, and the selection is the exact search of select.cuh
// (ties at the k-th value are kept). Cells outside (l1e, l2e) are +inf in
// the plain version; here they are never computed, written or read (the
// keys stand in as 0xFFFFFFFF, above every threshold), and a pair whose
// rounded neighbour count is 0 gets an all-zero CRP. k = rint(kappa *
// length) rounds half to even, as jnp.round and torch.round do.

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

// ---- B. the two-launch kernels ----------------------------------------

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

// ---- A. the one-launch cluster kernel ----------------------------------

constexpr int kClusterThreads = 512;   // a thread a column: lines <= 512
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterKeys = kClusterThreads / 32;   // keys a lane
constexpr int kChunkRows = 16;   // window rows a pass over the CSM ring
constexpr int kCsmRows = 4;      // CSM cells a thread builds at once
constexpr int kWindowRows = 4;   // window sums a thread takes at once
constexpr int kMaxCluster = 8;   // the portable cluster size

// rows of a block's slab at most (its column stride is the odd R | 1)
__host__ __device__ __forceinline__ int slab_rows(int L, int C) {
  return (L + C - 1) / C;
}

// X rows, their norms, row and column thresholds, the slab, the CSM ring
// and the line counter of step 2
size_t cluster_smem(int L, int d, int m, int C) {
  const size_t R = slab_rows(L, C), H = R + m - 1;
  return sizeof(float) * (H * x_stride(d) + H + R + L
                          + (size_t)L * (R | 1)
                          + (size_t)(kChunkRows + m - 1) * L + 1);
}

// The least cluster size whose slab fits a block, or 0: the line is too
// long for a thread a column or the features too wide for registers.
int cluster_size(int L, int d, int m) {
  if (L <= 0 || L > kClusterThreads || d <= 0 || d > kRegDims || m <= 0)
    return 0;
  for (int C = 1; C <= kMaxCluster; C *= 2)
    if (cluster_smem(L, d, m, C) <= kMaxSmem) return C;
  return 0;
}

// U CSM cells of one column, rows r .. r + U - 1 (X rows dx apart in
// shared memory, read as float4 broadcasts; their norms sx[0 .. U - 1]),
// the column's Y row in registers: out[u * stride]. Each cell in the
// plain version's order (d <= kRegDims); the U chains are independent.
template <int U>
__device__ __forceinline__ void csm_cells(const float* x, int dx,
                                          const float* sx,
                                          const float (&y)[kRegDims],
                                          float sy, int d, float* out,
                                          int stride) {
  float xy[U];
#pragma unroll
  for (int q = 0; q < kRegDims / 4; ++q) {
    if (4 * q >= d) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 v = reinterpret_cast<const float4*>(x + u * dx)[q];
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        if (k == 0) xy[u] = __fmul_rn(xv[0], y[0]);
        else if (k < d) xy[u] = __fadd_rn(xy[u], __fmul_rn(xv[e], y[k]));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float c = __fsub_rn(__fadd_rn(sx[u], sy), __fmul_rn(2.0f, xy[u]));
    out[u * stride] = fmaxf(c, 0.0f);
  }
}

// U window sums of one column, rows i .. i + U - 1 of the ring (rows L
// apart, w at row i's cell): sum over q < m of w[q (L + 1)], in index
// order, as keys at out[u].
template <int U, int kM>
__device__ __forceinline__ void window_sums(const float* w, int L, int m_,
                                            unsigned* out) {
  const int m = kM > 0 ? kM : m_;
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = w[u * L];
#pragma unroll
  for (int q = 1; q < m; ++q)
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc[u] = __fadd_rn(acc[u], w[u * L + q * (L + 1)]);
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = __float_as_uint(acc[u]);
}

// Zero rows first, first + step, ... < end of a pair's S (L bytes a row)
// with the whole block.
__device__ __forceinline__ void zero_rows(uint8_t* Sb, int L, int first,
                                          int step, int end) {
  const int n = first < end ? (end - first + step - 1) / step : 0;
  if ((L & 15) == 0) {
    const int w = L >> 4;
    for (int t = threadIdx.x; t < n * w; t += blockDim.x) {
      const int u = t / w;
      reinterpret_cast<uint4*>(Sb + (size_t)(first + u * step) * L)[t - u * w]
          = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int t = threadIdx.x; t < n * L; t += blockDim.x) {
      const int u = t / L;
      Sb[(size_t)(first + u * step) * L + t - u * L] = 0;
    }
  }
}

// Distributed shared memory: the address of `p` of this block's shared
// memory in block `rank`'s, and a 32-bit load and store there.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ unsigned ld_cluster(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(addr), "r"(v)
               : "memory");
}

// The two halves of cluster.sync(): arrive (releasing this block's shared
// memory writes, local and remote) and wait (acquiring the others'), so
// that work between them hides the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The threshold of a line of n keys (n the same across the warp), key t of
// a lane at line position lane + 32 t read by key_at(t), searched with
// K keys a lane.
template <int K, typename KeyAt>
__device__ __forceinline__ unsigned line_kth(int n, int k, KeyAt key_at) {
  const int lane = threadIdx.x & 31;
  unsigned key[K];
#pragma unroll
  for (int t = 0; t < K; ++t)
    key[t] = lane + 32 * t < n ? key_at(t) : kNoKey;
  return warp_kth(key, k, kMaxFiniteBits);
}

// line_kth with the fewest keys a lane (of 10, 12, 14, 16) that hold n
template <typename KeyAt>
__device__ __forceinline__ unsigned line_kth(int n, int k, KeyAt key_at) {
  if (n <= 32 * 10) return line_kth<10>(n, k, key_at);
  if (n <= 32 * 12) return line_kth<12>(n, k, key_at);
  if (n <= 32 * 14) return line_kth<14>(n, k, key_at);
  return line_kth<16>(n, k, key_at);
}

// grid (C, B), clusters of (C, 1, 1): one cluster a pair, C from
// cluster_size. Writes every byte of S. kD, kM > 0: d and m compiled in.
template <int kD, int kM>
__global__ void __launch_bounds__(kClusterThreads, 1)
band_strip_kernel(const float* __restrict__ X, const float* __restrict__ Y,
               const int* __restrict__ l1, const int* __restrict__ l2, int L,
               int d_, int m_, float kappa, uint8_t* __restrict__ S) {
  const int d = kD > 0 ? kD : d_, m = kM > 0 ? kM : m_;
  const int C = gridDim.x, r = blockIdx.x;   // the cluster spans x
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int l1e = effective(l1[b], L, m), l2e = effective(l2[b], L, m);
  uint8_t* Sb = S + (size_t)b * L * L;
  // the same for every block of the cluster: none of them syncs
  if (!(round_k(kappa, l2e) > 0.0f && round_k(kappa, l1e) > 0.0f)) {
    zero_rows(Sb, L, r, C, L);
    return;
  }
  const int R = slab_rows(L, C), Rp = R | 1, dx = x_stride(d);
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);    // (R + m - 1, dx)
  float* sx = xs + (R + m - 1) * dx;             // (R + m - 1)
  unsigned* tr = reinterpret_cast<unsigned*>(sx + R + m - 1);   // (R)
  unsigned* tc = tr + R;                         // (L): every column's
  unsigned* slab = tc + L;                       // (L, Rp): W's keys
  float* ring = reinterpret_cast<float*>(slab + (size_t)L * Rp);
  // the next line of step 2 to search
  int* next_line = reinterpret_cast<int*>(ring + (kChunkRows + m - 1) * L);
  if (tid == 0) *next_line = 0;
  // this block's rows i0 .. i0 + nr - 1 of the valid l1e
  const int nb = (l1e + C - 1) / C, i0 = r * nb;
  const int nr = max(min(nb, l1e - i0), 0);

  // 1. the slab's CSM and window sums, then its rows' thresholds
  if (nr > 0) {
    const int nx = nr + m - 1;    // CSM rows the windows reach (< l1)
    const int ny = l2e + m - 1;   // CSM columns they reach (== l2)
    const int j = tid;    // this thread's column
    float y[kRegDims];
    if (j < ny) {
      const float* yg = Y + ((size_t)b * L + j) * d;
#pragma unroll
      for (int k = 0; k < kRegDims; ++k) y[k] = k < d ? __ldg(yg + k) : 0.0f;
    }
    const float* Xb = X + ((size_t)b * L + i0) * d;
    for (int t = tid; t < nx * d; t += kClusterThreads) {
      const int q = t / d;
      xs[q * dx + t - q * d] = Xb[t];
    }
    __syncthreads();
    for (int q = tid; q < nx; q += kClusterThreads) {
      const float* x = xs + q * dx;
      float s = __fmul_rn(x[0], x[0]);
      for (int k = 1; k < d; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
      sx[q] = s;
    }
    float sy = 0.0f;
    if (j < ny) {
      sy = __fmul_rn(y[0], y[0]);
#pragma unroll
      for (int k = 1; k < kRegDims; ++k)
        if (k < d) sy = __fadd_rn(sy, __fmul_rn(y[k], y[k]));
    }
    __syncthreads();
    // ring row q holds CSM row c0 + q of the chunk starting at row c0
    for (int c0 = 0; c0 < nr; c0 += kChunkRows) {
      const int h = min(kChunkRows, nr - c0), hm = h + m - 1;
      if (j < ny) {
        int q = 0;
        if (c0 > 0)   // the previous (whole) chunk's last m - 1 rows
          for (; q < m - 1; ++q)
            ring[q * L + j] = ring[(kChunkRows + q) * L + j];
        for (; q + kCsmRows <= hm; q += kCsmRows)
          csm_cells<kCsmRows>(xs + (c0 + q) * dx, dx, sx + c0 + q, y, sy, d,
                              ring + q * L + j, L);
        for (; q < hm; ++q)
          csm_cells<1>(xs + (c0 + q) * dx, dx, sx + c0 + q, y, sy, d,
                       ring + q * L + j, L);
      }
      __syncthreads();
      // i + q < nx and j + q < ny: the windows stay in the ring
      if (j < l2e) {
        unsigned* out = slab + j * Rp + c0;
        int i = 0;
        for (; i + kWindowRows <= h; i += kWindowRows)
          window_sums<kWindowRows, kM>(ring + i * L + j, L, m, out + i);
        for (; i < h; ++i)
          window_sums<1, kM>(ring + i * L + j, L, m, out + i);
      }
      __syncthreads();
    }
  }
  __syncthreads();   // blocks without rows: the line counter is set

  // 2. the thresholds of this block's rows, then of its ~l2e / C columns,
  // a warp a line from a shared counter: rows first, as soon as this
  // block's slab is whole, columns once every block's is (their keys from
  // every block's slab; each threshold is sent to every block). Rows keep
  // round(kappa * l2e) neighbours, columns round(kappa * l1e).
  cluster_arrive();
  {
    const int kr = (int)round_k(kappa, l2e), kc = (int)round_k(kappa, l1e);
    const int ncb = (l2e + C - 1) / C, j0 = r * ncb;
    const int nc = max(min(ncb, l2e - j0), 0);
    // where each of the lane's rows lane + 32 t lives: its block's slab
    // ((i + 1/2) / nb in float is floor(i / nb) plus a fraction in (0, 1)
    // that rounding cannot push past an integer, i < 512)
    const float inv_nb = 1.0f / (float)nb;
    unsigned row[kClusterKeys];
#pragma unroll
    for (int t = 0; t < kClusterKeys; ++t) {
      const int i = min(lane + 32 * t, l1e - 1);
      const int o = (int)(((float)i + 0.5f) * inv_nb);
      row[t] = cluster_addr(slab + (i - o * nb), o);
    }
    bool waited = false;
    for (;;) {
      int line = 0;
      if (lane == 0) line = atomicAdd(next_line, 1);
      line = __shfl_sync(0xffffffffu, line, 0);
      if (line >= nr + nc) break;
      if (line < nr) {
        const unsigned t = line_kth(l2e, kr, [&](int t) {
          return slab[(lane + 32 * t) * Rp + line];
        });
        if (lane == 0) tr[line] = t;
      } else {
        if (!waited) cluster_wait();
        waited = true;
        const int c = j0 + line - nr;
        const unsigned t = line_kth(l1e, kc, [&](int t) {
          return ld_cluster(row[t] + 4u * c * Rp);
        });
        if (lane < C) st_cluster(cluster_addr(tc + c, lane), t);
      }
    }
    if (!waited) cluster_wait();
  }
  // every threshold is sent; the rows past l1e need none
  cluster_arrive();
  zero_rows(Sb, L, l1e + r, C, L);
  cluster_wait();

  // 3. this block's rows of S, a warp a row, a lane's bytes 32 apart
  for (int i = warp; i < nr; i += kClusterWarps) {
    const unsigned t_row = tr[i];
    uint8_t* Sr = Sb + (size_t)(i0 + i) * L;
#pragma unroll
    for (int e = 0; e < kClusterKeys; ++e) {
      const int c = lane + 32 * e, cc = c < l2e ? c : 0;
      const unsigned v = slab[cc * Rp + i];
      if (c < L) Sr[c] = (c < l2e) & (v <= t_row) & (v <= tc[cc]);
    }
  }
}

// ---- the launches -----------------------------------------------------

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

template <int kD, int kM>
int launch_cluster(const float* X, const float* Y, const int* l1,
                   const int* l2, int B, int L, int d, int m, float kappa,
                   int C, uint8_t* S, cudaStream_t stream) {
  const size_t smem = cluster_smem(L, d, m, C);
  cudaError_t err = allow_smem(band_strip_kernel<kD, kM>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, band_strip_kernel<kD, kM>, X, Y, l1, l2, L,
                           d, m, kappa, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The size of the cluster that builds a pair's CRP in one launch (1 to 8,
// design A), or 0 when the shape takes the two launches of design B.
int acoss_fused_crp_cluster(int L, int d, int m) {
  return cluster_size(L, d, m);
}

// Shared memory per block of the design the shape takes: design A's, or
// the larger of design B's two kernels at the band height and strip width
// they would take; 0 if L, d or m is out of range or no band or strip
// fits.
size_t acoss_fused_crp_smem(int L, int d, int m) {
  if (L <= 0 || d <= 0 || m <= 0 || L > 32 * kMaxKeysPerLane) return 0;
  const int C = cluster_size(L, d, m);
  if (C > 0) return cluster_smem(L, d, m, C);
  const int rb = band_rows(L, d, m), cw = strip_cols(L);
  if (rb == 0 || cw == 0) return 0;
  const size_t a = band_smem(L, d, m, rb), s = strip_smem(L, cw);
  return a > s ? a : s;
}

// W (B, L, L) float32 and t_row (B, L) are design B's scratch: null when
// design A takes the shape.
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
  const int C = cluster_size(L, d, m);
  if (C > 0) {   // Serra09's widths and window compiled in
    if (d == 12 && m == 9)
      return launch_cluster<12, 9>(X, Y, l1, l2, B, L, d, m, kappa, C, S,
                                   stream);
    if (d == 13 && m == 9)
      return launch_cluster<13, 9>(X, Y, l1, l2, B, L, d, m, kappa, C, S,
                                   stream);
    return launch_cluster<0, 0>(X, Y, l1, l2, B, L, d, m, kappa, C, S,
                                stream);
  }
  if (W == nullptr || t_row == nullptr) return (int)cudaErrorInvalidValue;
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
