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
// k-th value of a row or column of 512..1024 floats), an exact search of
// dependent count-and-halve steps. The TPU kernels keep whole (L, L)
// matrices in VMEM and search all lines of a pair at once; a block here
// has 227 KB of shared memory, and one (1024, 1024) fp32 matrix is 4 MB.
// So a warp owns a line, with its keys in registers (L/32 a lane), and
// finds its k-th smallest with `warp_kth` (warp reductions, no barrier, a
// bracket from the lanes' smallest keys, an exact early stop); the bytes
// each kernel must move then set its pace:
//  1. The binarizer is two launches. The row launch reads each valid row
//     once, coalesced, and writes its threshold. The strip launch stages a
//     strip of 16 columns of the valid rows in shared memory as coalesced
//     row segments (float4 loads where L % 4 == 0; odd row stride: a warp
//     reading a column hits 32 banks), searches its columns from there and
//     writes the strip of the CRP from the staged keys, 4 bytes a store. D
//     is read twice and never strided; strips outside the valid block
//     write zeros and read nothing. Those two reads and the CRP write are
//     its design floor; the searches (on the row launch's path: it does
//     nothing else) cost about as much again.
//  2. The kNN mask is one launch: a warp reads its row once, coalesced,
//     keeps the keys in registers, finds the k-th with a bracket from each
//     lane's 4 smallest keys (k <= 128: EarlySNF's k of 50..95 at
//     n = 1024), and writes the row from the keys, which give back W's
//     bits (a bit a key keeps the sign of a zero). Its bound is W read and
//     V written once; float4 loads and stores measured no faster.
// Lines longer than registers hold (past 32 x 192 = 6,144) take the first
// design instead: one block a line, the line's keys in shared memory and
// `block_kth_key` (32 passes, a block barrier each; a binarizer column is
// a strided read and the mask launch reads D again).
//  3. WCSMSSM is one warp per line with its keys in registers (`warp_kth`),
// the column lines staged as coalesced row segments, then an output pass in
// 32 x 32 tiles that computes each affinity once and stores it with 128-bit
// stores to its cell and to the mirror cell (W_SSMA and W_SSMB are
// symmetric, the lower-left quadrant is the upper-right's transpose); its
// bound is the (B, 2L, 2L) output it writes.
// The TPU-only parts (two pairs a grid step, the `dual` layout, VMEM slab
// sizing, custom_vmap) have no counterpart: a launch takes a flat batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"
#include "select.cuh"

namespace {

using acoss::block_kth_key;
using acoss::float_key;
using acoss::key_float;
using acoss::kInfBits;
using acoss::kMaxFiniteBits;
using acoss::kMaxFiniteUKey;
using acoss::kNoKey;
using acoss::float_ukey;
using acoss::ukey_float;
using acoss::warp_kth;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// fusion._BIG: the stand-in distance of padded cells
constexpr float kBig = 1e30f;
constexpr int kLoads = 8;             // loads in flight a thread (staging)
constexpr int kMaxKeysPerLane = 192;  // register lines of up to 6,144
constexpr size_t kMaxSmem = 227 * 1024;
// the kNN mask's bracket: each lane's 4 smallest keys bound k <= 128
constexpr int kMaskBracket = 4;
// the key of +inf: the kNN mask's answer always exists (1 <= k <= n)
constexpr unsigned kInfUKey = 0xFF800000u;

// round(kappa * len) in fp32, half to even (jnp.round / torch.round)
__device__ __forceinline__ float round_k(float kappa, int len) {
  return rintf(__fmul_rn(kappa, (float)len));
}

size_t strip_bytes(int L, int cw) {
  return sizeof(float) * (size_t)L * (cw + 1);
}

// ---------------------------------------------------------------- 1 ------
// grid (ceil(L / kWarps), B), one warp a row, K keys a lane (L <= 32 K):
// row i < l1 keeps round(kappa * l2) neighbours among its l2 valid cells
// (at least 1). Its threshold goes to thr[b, 0, i]; kMaxFiniteUKey for a
// row outside the valid block.
template <int K>
__global__ void __launch_bounds__(kThreads)
binarize_row_kernel(const float* __restrict__ D, const int* __restrict__ l1,
                    const int* __restrict__ l2, int L, float kappa,
                    unsigned* __restrict__ thr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, i = blockIdx.x * kWarps + warp;
  if (i >= L) return;
  const int r1 = l1[b], r2 = l2[b];
  unsigned* out = thr + (size_t)b * 2 * L + i;
  if (i >= r1) {
    if (lane == 0) *out = kMaxFiniteUKey;
    return;
  }
  // masked cells are above every threshold: only the valid prefix counts
  const int n = min(max(r2, 0), L);
  const float* Dr = D + ((size_t)b * L + i) * L;
  unsigned key[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int j = lane + 32 * u;
    key[u] = j < n ? float_ukey(__ldg(Dr + j)) : kNoKey;
  }
  const int k = (int)fmaxf(round_k(kappa, r2), 1.0f);
  const unsigned t = warp_kth(key, k, kMaxFiniteUKey);
  if (lane == 0) *out = t;
}

// grid (ceil(L / cw), B), one block a strip of cw columns (a power of
// two), every row: stages the keys of the strip's cells of the valid rows,
// a warp finds each valid column's threshold (round(kappa * l1) of its l1
// cells, at least 1), then S[i, j] = key <= t_row[i] && key <= t_col[j]
// inside (l1, l2), else 0; all zero for a pair whose rounded neighbour
// count is 0. `vec`: L % 4 == 0, D 16-byte and S 4-byte aligned, so a
// thread loads and stores 4 cells at once.
template <int K>
__global__ void __launch_bounds__(kThreads)
binarize_strip_kernel(const float* __restrict__ D,
                      const unsigned* __restrict__ thr,
                      const int* __restrict__ l1, const int* __restrict__ l2,
                      int L, int cw, float kappa, int vec,
                      uint8_t* __restrict__ S) {
  extern __shared__ unsigned skeys[];   // (rows < l1, cw + 1)
  __shared__ unsigned t_col[32];
  const int b = blockIdx.y, q0 = blockIdx.x * cw, cs = cw + 1;
  const int cw_log2 = __ffs(cw) - 1, qw_log2 = cw_log2 - 2;  // 4-cell words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r1 = l1[b], r2 = l2[b];
  const int m = min(max(r1, 0), L), n = min(max(r2, 0), L);
  const bool any = round_k(kappa, r2) > 0.0f && round_k(kappa, r1) > 0.0f;
  const int cols = min(cw, L - q0);                // the strip's columns
  const int vc = any ? min(cols, n - q0) : 0;      // those with keys
  uint8_t* Sb = S + (size_t)b * L * L + q0;
  if (vc > 0) {
    const float* Db = D + (size_t)b * L * L + q0;
    // coalesced row segments, kLoads loads in flight a thread; with vec a
    // load takes 4 cells (those past vc are never read)
    const int words = m << qw_log2;
    for (int t0 = threadIdx.x; vec && t0 < words; t0 += kLoads * kThreads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u * kThreads, i = t >> qw_log2;
        const int c = (t & ((1 << qw_log2) - 1)) * 4;
        v[u] = t < words && c < vc
                   ? __ldg(reinterpret_cast<const float4*>(
                         Db + (size_t)i * L + c))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u * kThreads, i = t >> qw_log2;
        const int c = (t & ((1 << qw_log2) - 1)) * 4;
        if (t < words && c < vc) {
          unsigned* s = skeys + i * cs + c;
          s[0] = float_ukey(v[u].x);
          s[1] = float_ukey(v[u].y);
          s[2] = float_ukey(v[u].z);
          s[3] = float_ukey(v[u].w);
        }
      }
    }
    for (int t0 = threadIdx.x; !vec && t0 < m * cw;
         t0 += kLoads * kThreads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u * kThreads, i = t >> cw_log2, c = t & (cw - 1);
        v[u] = t < m * cw && c < vc ? __ldg(Db + (size_t)i * L + c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u * kThreads, i = t >> cw_log2, c = t & (cw - 1);
        if (t < m * cw && c < vc) skeys[i * cs + c] = float_ukey(v[u]);
      }
    }
    __syncthreads();
    const int k = (int)fmaxf(round_k(kappa, r1), 1.0f);
    for (int c = warp; c < vc; c += kWarps) {
      unsigned key[K];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int i = lane + 32 * u;
        key[u] = i < m ? skeys[i * cs + c] : kNoKey;
      }
      const unsigned t = warp_kth(key, k, kMaxFiniteUKey);
      if (lane == 0) t_col[c] = t;
    }
    __syncthreads();
  }
  const unsigned* tr = thr + (size_t)b * 2 * L;
  // one cell of row i, column c of the strip
  auto cell = [&](int i, int c) -> unsigned {
    if (i >= m || c >= vc) return 0u;
    const unsigned v = skeys[i * cs + c];
    return v <= __ldg(tr + i) && v <= t_col[c];
  };
  if (vec) {
    // cols is a multiple of 4 (L and q0 are)
    for (int t = threadIdx.x; t < (L << qw_log2); t += kThreads) {
      const int i = t >> qw_log2, c = (t & ((1 << qw_log2) - 1)) * 4;
      if (c >= cols) continue;
      unsigned w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) w |= cell(i, c + e) << (8 * e);
      *reinterpret_cast<unsigned*>(Sb + (size_t)i * L + c) = w;
    }
  } else {
    for (int t = threadIdx.x; t < L * cw; t += kThreads) {
      const int i = t >> cw_log2, c = t & (cw - 1);
      if (c < cols) Sb[(size_t)i * L + c] = (uint8_t)cell(i, c);
    }
  }
}

// Lines longer than registers hold: grid (L, B, 2), blockIdx.z == 0
// searches row blockIdx.x, 1 the column, one block a line with its keys in
// shared memory (signed keys; a line outside the valid block gets
// kMaxFiniteBits); then binarize_mask_kernel reads D again.
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
// grid (ceil(n / kWarps), B), one warp a row, K keys a lane (n <= 32 K).
// Keys of -W (largest) or W (smallest); the row keeps the cells whose key
// is <= its k-th smallest, k clamped to [1, n], and writes W there and
// +0.0 elsewhere.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_mask_row_kernel(const float* __restrict__ W, const int* __restrict__ k,
                    int n, int largest, float* __restrict__ V) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, i = blockIdx.x * kWarps + warp;
  if (i >= n) return;
  const size_t row = ((size_t)b * n + i) * n;
  const float* Wr = W + row;
  float* Vr = V + row;
  // W's bits first, every load in flight
  unsigned key[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int j = lane + 32 * u;
    key[u] = j < n ? __float_as_uint(__ldg(Wr + j)) : 0u;
  }
  // then the keys; -0.0 and +0.0 share a key, so a bit a key keeps which
  // one W held
  const unsigned flip = largest ? 0x80000000u : 0u;
  unsigned negz[(K + 31) / 32];
#pragma unroll
  for (int w = 0; w < (K + 31) / 32; ++w) negz[w] = 0u;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (lane + 32 * u < n) {
      if (key[u] == 0x80000000u) negz[u / 32] |= 1u << (u % 32);
      key[u] = float_ukey(__uint_as_float(key[u] ^ flip));
    } else {
      key[u] = kNoKey;
    }
  }
  const int kk = min(max(k[b], 1), n);
  const unsigned t = warp_kth<K, kMaskBracket>(key, kk, kInfUKey);
  // W's value back from its key (exact but for the sign of a zero)
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int j = lane + 32 * u;
    if (j < n) {
      unsigned r = __float_as_uint(ukey_float(key[u])) ^ flip;
      if ((r << 1) == 0u) r = ((negz[u / 32] >> (u % 32)) & 1u) << 31;
      Vr[j] = key[u] <= t ? __uint_as_float(r) : 0.0f;
    }
  }
}

// Lines longer than registers hold: grid (n, B), one block a row, its keys
// in shared memory, searched by `block_kth_key`; reads W twice.
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

constexpr int kTile = 32;             // the out kernel's square tiles

// Lines a WCSMSSM stats block or a binarizer strip block takes: the
// widest band (16 or 8) whose column strip fits a block's shared memory;
// 0 when none does.
int band_lines(int L) {
  for (int rb = 16; rb >= 8; rb /= 2)
    if (strip_bytes(L, rb) <= kMaxSmem) return rb;
  return 0;
}

// grid (ceil(L / rb), B, 3), one block per band of rb lines (a power of
// two) of pair b, each line's mean of its k smallest values into stats
// (B, 4, L):
//   z = 0: row q of DSym(SSMA), cells >= l1 -> BIG: the mean of its
//          clip(k1 + 1) smallest, scaled by (k1 + 1) / max(k1, 1) (row 0)
//   z = 1: the same for SSMB with l2 and k2 (row 1)
//   z = 2: row q of the CSM, cells outside (l1, l2) -> BIG: the mean of
//          its clip(k2) smallest (row 2); and column q: of its clip(k1)
//          smallest (row 3)
// (clip to [1, L]); 0 for a line outside the valid block. A DSym row q
// needs column q of its matrix as well as row q, and a CSM column line is
// a column, so the block first stages the band's columns of the matrix's
// valid rows in shared memory as coalesced row segments (odd row stride:
// a warp reading a column hits 32 banks). Then a warp takes whole lines,
// with L/32 keys a lane in registers: the k-th smallest by `warp_kth`,
// then the sum and count of the values below it by warp reductions. The
// mean of the k smallest is sum(v < t) + (k - count(v < t)) * t over k,
// t the k-th smallest value: the TPU kernel's formula.
template <int K>
__global__ void __launch_bounds__(kThreads)
wcsmssm_stats_kernel(const float* __restrict__ SA,
                     const float* __restrict__ SB,
                     const float* __restrict__ C, const int* __restrict__ l1,
                     const int* __restrict__ l2, const int* __restrict__ Ks,
                     int L, int rb, float* __restrict__ stats) {
  extern __shared__ float strip[];      // (rows, rb + 1): X[t, q0 + c]
  const int b = blockIdx.y, z = blockIdx.z, q0 = blockIdx.x * rb;
  const int cs = rb + 1, rb_log2 = __ffs(rb) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = min(max(l1[b], 0), L), n = min(max(l2[b], 0), L);
  int k1, k2;
  split_k(Ks[b], l1[b], l2[b], &k1, &k2);
  const float* X = (z == 0 ? SA : z == 1 ? SB : C) + (size_t)b * L * L;
  // the matrix's valid rows and columns; the band's columns that are lines
  const int rows = z == 1 ? n : m, cols = z == 0 ? m : n;
  const int sc = max(min(rb, cols - q0), 0);
  if (sc > 0) {
    for (int t0 = threadIdx.x; t0 < rows * rb; t0 += kLoads * kThreads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u * kThreads, i = t >> rb_log2, c = t & (rb - 1);
        v[u] = t < rows * rb && c < sc ? __ldg(X + (size_t)i * L + q0 + c)
                                       : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u * kThreads, i = t >> rb_log2, c = t & (rb - 1);
        if (t < rows * rb && c < sc) strip[i * cs + c] = v[u];
      }
    }
  }
  __syncthreads();
  for (int ln = warp; ln < (z == 2 ? 2 * rb : rb); ln += kWarps) {
    const bool column = ln >= rb;       // a CSM column line
    const int c = ln & (rb - 1), q = q0 + c;
    if (q >= L) continue;
    float* out = stats + ((size_t)b * 4 + z + column) * L + q;
    // valid lines, and valid cells a line (the others are BIG)
    const bool csm_row = z == 2 && !column;
    const int lines = csm_row ? rows : cols, nv = csm_row ? cols : rows;
    if (q >= lines) {
      if (lane == 0) *out = 0.0f;
      continue;
    }
    const float* xr = X + (size_t)q * L;
    unsigned key[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int t = lane + 32 * u;
      key[u] = kNoKey;
      if (t < L) {
        float v = kBig;
        if (t < nv) {
          if (column) v = strip[t * cs + c];
          else if (csm_row) v = __ldg(xr + t);
          else v = t == q ? 0.0f : 0.5f * (__ldg(xr + t) + strip[t * cs + c]);
        }
        key[u] = float_ukey(v);
      }
    }
    const int kraw = z == 0 ? k1 + 1 : z == 1 ? k2 + 1 : column ? k1 : k2;
    const int k = min(max(kraw, 1), L);
    const unsigned tk = warp_kth(key, k, kMaxFiniteUKey);
    float s = 0.0f;
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if (key[u] < tk) {
        s += ukey_float(key[u]);
        ++cnt;
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float kf = (float)k;
      float mean = (s + (kf - (float)cnt) * ukey_float(tk)) / kf;
      if (z < 2) {
        const float Kf = (float)(z == 0 ? k1 : k2);
        mean = mean * (Kf + 1.0f) / fmaxf(Kf, 1.0f);
      }
      *out = mean;
    }
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

// v[0 .. min(avail, 4)) to p, one 128-bit store when kVec and all four fit
template <bool kVec>
__device__ __forceinline__ void put4(float* p, const float (&v)[4],
                                     int avail) {
  if (kVec && avail >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < avail) p[k] = v[k];
}

// grid (units, B), one unit of pair b's (2L, 2L) output a block: unit
// u < nt * nt is the W_CSM tile (I, J) = (u / nt, u % nt), written with
// its transpose into W_CSM^T; the units after it are the tiles (I, J),
// I <= J, of W_SSMA and then of W_SSMB, each written with its mirror
// (J, I), which holds the same values: (a + b) and (ra + rb) are the
// same sums either way round. A thread computes 4 consecutive cells of a
// tile row and stores them as one float4 (kVec: L and the pointers
// 16-byte aligned); the mirror's rows come from a padded shared tile, and
// an SSM's transposed operand X[J, I] is staged in another. Cells outside
// the valid (l1, l2) part are 0, and a tile wholly outside it writes its
// zeros and reads nothing.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
wcsmssm_out_kernel(const float* __restrict__ SA, const float* __restrict__ SB,
                   const float* __restrict__ C, const int* __restrict__ l1,
                   const int* __restrict__ l2, const float* __restrict__ stats,
                   int L, float Mu, float* __restrict__ W) {
  __shared__ float xt[kTile][kTile + 1];   // X tile (J, I)
  __shared__ float wt[kTile][kTile + 1];   // this tile's affinities
  const int b = blockIdx.y, nt = (L + kTile - 1) / kTile;
  int u = blockIdx.x, z = 0, I, J;
  if (u < nt * nt) {
    I = u / nt;
    J = u % nt;
  } else {
    const int tri = nt * (nt + 1) / 2;
    u -= nt * nt;
    z = 1 + (u >= tri);
    u -= (z - 1) * tri;
    I = 0;
    while (u >= nt - I) {
      u -= nt - I;
      ++I;
    }
    J = I + u;
  }
  const int m = min(max(l1[b], 0), L), n = min(max(l2[b], 0), L);
  // the quadrant's valid rows and columns, and its origin in the output
  // (its mirror's is (co, ro))
  const int rv = z == 2 ? n : m, cv = z == 1 ? m : n;
  const int ro = z == 2 ? L : 0, co = z == 1 ? 0 : L;
  const float* X = (z == 0 ? C : z == 1 ? SA : SB) + (size_t)b * L * L;
  const float* st = stats + (size_t)b * 4 * L;
  const float* rs = st + (z == 0 ? 2 * L : z == 1 ? 0 : L);   // row radii
  const float* cr = st + (z == 0 ? 3 * L : z == 1 ? 0 : L);   // column's
  const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 4;
  const int i = I * kTile + r, j0 = J * kTile + c;
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (I * kTile < rv && J * kTile < cv) {
    if (z > 0) {
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int gi = J * kTile + (e >> 5), gj = I * kTile + (e & 31);
        xt[e >> 5][e & 31] =
            gi < rv && gj < rv ? __ldg(X + (size_t)gi * L + gj) : 0.0f;
      }
    }
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (i < rv) {
      const float* xr = X + (size_t)i * L + j0;
      if (kVec && j0 < cv) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr));
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j0 + k < cv) x[k] = __ldg(xr + k);
      }
    }
    __syncthreads();
    if (i < rv) {
      const float ra = __ldg(rs + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        if (j < cv) {
          const float d = z == 0   ? x[k]
                          : i == j ? 0.0f
                                   : 0.5f * (x[k] + xt[c + k][r]);
          w[k] = affinity(d, ra, __ldg(cr + j), Mu);
        }
      }
    }
  }
  float* Wb = W + (size_t)b * 4 * L * L;
  const size_t ld = 2 * (size_t)L;
  if (i < L) put4<kVec>(Wb + (ro + i) * ld + co + j0, w, L - j0);
  if (z > 0 && I == J) return;
  // the mirror tile (J, I): its row r is this tile's column r
#pragma unroll
  for (int k = 0; k < 4; ++k) wt[r][c + k] = w[k];
  __syncthreads();
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = wt[c + k][r];
  const int i2 = J * kTile + r, j2 = I * kTile + c;
  if (i2 < L) put4<kVec>(Wb + (co + i2) * ld + ro + j2, v, L - j2);
}

cudaError_t smem_limit(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The binarizer's register design: the row launch, then the strip launch.
template <int K>
cudaError_t binarize_lines(const float* D, const int* l1, const int* l2,
                           int B, int L, float kappa, unsigned* thr,
                           uint8_t* S, cudaStream_t stream) {
  const int cw = band_lines(L);
  const size_t smem = strip_bytes(L, cw);
  cudaError_t err = smem_limit((const void*)binarize_strip_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  binarize_row_kernel<K><<<dim3((L + kWarps - 1) / kWarps, B), kThreads, 0,
                           stream>>>(D, l1, l2, L, kappa, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec = L % 4 == 0 && ((uintptr_t)D & 15) == 0 &&
                  ((uintptr_t)S & 3) == 0;
  binarize_strip_kernel<K><<<dim3((L + cw - 1) / cw, B), kThreads, smem,
                             stream>>>(D, thr, l1, l2, L, cw, kappa, vec, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int acoss_binarize(const float* D, const int* l1, const int* l2, int B,
                   int L, float kappa, int* thr, uint8_t* S, int device,
                   void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || L == 0) return (int)cudaGetLastError();
  // keys per lane: the first that covers a line of L (16 up to L = 512)
  const int kpl = (L + 31) / 32;
  if (kpl <= kMaxKeysPerLane) {
    auto run = kpl <= 16   ? binarize_lines<16>
               : kpl <= 32 ? binarize_lines<32>
               : kpl <= 64 ? binarize_lines<64>
                           : binarize_lines<kMaxKeysPerLane>;
    return (int)run(D, l1, l2, B, L, kappa, (unsigned*)thr, S, stream);
  }
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
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const int kpl = (n + 31) / 32;
  if (kpl <= kMaxKeysPerLane) {
    auto kernel = kpl <= 16   ? knn_mask_row_kernel<16>
                  : kpl <= 32 ? knn_mask_row_kernel<32>
                  : kpl <= 64 ? knn_mask_row_kernel<64>
                              : knn_mask_row_kernel<kMaxKeysPerLane>;
    kernel<<<dim3((n + kWarps - 1) / kWarps, B), kThreads, 0, stream>>>(
        W, k, n, largest, V);
    return (int)cudaGetLastError();
  }
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
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (L > 32 * kMaxKeysPerLane) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return (int)cudaGetLastError();
  const int rb = band_lines(L);
  const size_t smem = strip_bytes(L, rb);
  // keys per lane: the first that covers a line of L (16 up to L = 512)
  const int kpl = (L + 31) / 32;
  auto stats_kernel = kpl <= 16   ? wcsmssm_stats_kernel<16>
                      : kpl <= 32 ? wcsmssm_stats_kernel<32>
                      : kpl <= 64 ? wcsmssm_stats_kernel<64>
                                  : wcsmssm_stats_kernel<kMaxKeysPerLane>;
  err = smem_limit((const void*)stats_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<dim3((L + rb - 1) / rb, B, 3), kThreads, smem, stream>>>(
      SA, SB, C, l1, l2, K, L, rb, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + kTile - 1) / kTile;
  const dim3 grid(nt * nt + nt * (nt + 1), B);
  const bool vec = L % 4 == 0 && (((uintptr_t)SA | (uintptr_t)SB |
                                   (uintptr_t)C | (uintptr_t)W) & 15) == 0;
  if (vec)
    wcsmssm_out_kernel<true><<<grid, kThreads, 0, stream>>>(
        SA, SB, C, l1, l2, stats, L, Mu, W);
  else
    wcsmssm_out_kernel<false><<<grid, kThreads, 0, stream>>>(
        SA, SB, C, l1, l2, stats, L, Mu, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
