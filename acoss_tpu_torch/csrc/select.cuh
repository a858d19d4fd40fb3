// Exact order statistics of one line (a matrix row or column), shared by
// the selection kernels of knn.cu and crp.cu.
//
// A float becomes a signed monotone int32 key (int order == float order),
// and the k-th smallest key of a line is found by a binary search over the
// finite-key range: each halving counts the keys <= the midpoint. This is
// the search of the TPU kernels of `acoss_tpu/ops/crp_pallas.py`
// (`_binarize_kernel`, `_knn_mask_kernel`, `_mean_k_smallest_vmem`), so
// ties at the k-th value are exact and every key <= the result is kept.
// Two forms: `block_kth_key`, a line in shared memory searched by a whole
// block (32 halvings, a block barrier each), and `warp_kth`, a line held
// in one warp's registers (warp reductions, no barrier, early stop).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acoss {

// key of -FLT_MAX (bits 0xFF7FFFFF), and the bits of +FLT_MAX and +inf
constexpr int kMinFiniteKey = -2139095040;
constexpr int kMaxFiniteBits = 0x7F7FFFFF;
constexpr int kInfBits = 0x7F800000;
constexpr unsigned kNoKey = 0xFFFFFFFFu;   // above every key warp_kth takes

// Identity on non-negative floats, bit complement of the magnitude on
// negative ones. -0.0 is made +0.0 first: the two compare equal as floats,
// so they must get one key (the negated SNF cross block is full of -0.0).
__device__ __forceinline__ int float_key(float v) {
  int b = __float_as_int(v);
  if (b == (int)0x80000000) b = 0;
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// float_key with its sign bit flipped: monotone as an unsigned int, for
// warp_kth; +FLT_MAX keys to kMaxFiniteUKey.
constexpr unsigned kMaxFiniteUKey = 0xFF7FFFFFu;
__device__ __forceinline__ unsigned float_ukey(float v) {
  return (unsigned)float_key(v) ^ 0x80000000u;
}

__device__ __forceinline__ float ukey_float(unsigned k) {
  return key_float((int)(k ^ 0x80000000u));
}

// The k-th smallest key (k >= 1) of line[0, n): the smallest t in
// [kMinFiniteKey, kMaxFiniteBits] with count(line <= t) >= k, or
// kMaxFiniteBits when there is none. The midpoint floor((lo + hi) / 2) is
// taken as (lo & hi) + ((lo ^ hi) >> 1): lo + hi would overflow int32.
// Every thread of the block calls it after line is written and the block
// has synchronised; it returns the same value to all of them. red holds
// 2 * kThreads / 32 ints (double-buffered, so one barrier a pass).
template <int kThreads>
__device__ int block_kth_key(const int* line, int n, int k, int* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo = kMinFiniteKey, hi = kMaxFiniteBits;
  for (int it = 0; it < 32; ++it) {
    const int mid = (lo & hi) + ((lo ^ hi) >> 1);
    int cnt = 0;
    for (int t = threadIdx.x; t < n; t += kThreads) cnt += line[t] <= mid;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    int* r = red + (it & 1) * kWarps;
    if (lane == 0) r[warp] = cnt;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += r[w];
    if (total >= k) hi = mid; else lo = mid + 1;
  }
  return hi;
}

// The exact k-th smallest (k >= 1) of a warp's unsigned monotone keys
// (kNoKey for none; which lane holds which key does not matter), clamped
// to `top`: the smallest t <= top with count(key <= t) >= k, else top.
// Bisection between the smallest key and a bound from the lanes' J
// smallest keys; once a midpoint has exactly k keys at or below it, the
// answer is the largest of those, so the search stops there. Same value
// in every lane. That largest key is found by testing key < mid + 1
// (mid < hi <= top: no overflow), the keys of key <= mid, so that the
// compiler does not keep every predicate of the count for the exit (two
// more bit operations a key each step).
template <int K, int J = 2>
__device__ __forceinline__ unsigned warp_kth(const unsigned (&key)[K], int k,
                                             unsigned top) {
  constexpr unsigned kFull = 0xffffffffu;
  // the J smallest keys of each lane, ascending: at least 32 j keys of the
  // warp are <= the largest over the lanes of their j-th smallest, so for
  // k <= 32 j the answer is at most that
  unsigned m[J];
#pragma unroll
  for (int j = 0; j < J; ++j) m[j] = kNoKey;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    unsigned x = key[t];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned y = max(m[j], x);
      m[j] = min(m[j], x);
      x = y;
    }
  }
  const int jk = (k + 31) / 32;
  unsigned mj = top;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (jk == j + 1) mj = m[j];
  unsigned lo = min(__reduce_min_sync(kFull, m[0]), top);
  unsigned hi = min(__reduce_max_sync(kFull, mj), top);
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2;
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) cnt += key[t] <= mid;
    cnt = __reduce_add_sync(kFull, cnt);
    if (cnt == k) {
      const unsigned above = mid + 1;
      unsigned best = 0;
#pragma unroll
      for (int t = 0; t < K; ++t)
        if (key[t] < above) best = max(best, key[t]);
      return __reduce_max_sync(kFull, best);
    }
    if (cnt > k) hi = mid; else lo = mid + 1;
  }
  return hi;
}

}  // namespace acoss
