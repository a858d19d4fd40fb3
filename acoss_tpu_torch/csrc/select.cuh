// Exact order statistics of one line (a matrix row or column) held in
// shared memory, shared by the selection kernels of knn.cu.
//
// A float becomes a signed monotone int32 key (int order == float order),
// and the k-th smallest key of a line is found by a binary search over the
// finite-key range [kMinFiniteKey, kMaxFiniteBits]: 32 halvings, each one
// block-wide count of the keys <= the midpoint. This is the search of the
// TPU kernels of `acoss_tpu/ops/crp_pallas.py` (`_binarize_kernel`,
// `_knn_mask_kernel`, `_mean_k_smallest_vmem`), so ties at the k-th value
// are exact and every key <= the result is kept.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acoss {

// key of -FLT_MAX (bits 0xFF7FFFFF), and the bits of +FLT_MAX and +inf
constexpr int kMinFiniteKey = -2139095040;
constexpr int kMaxFiniteBits = 0x7F7FFFFF;
constexpr int kInfBits = 0x7F800000;

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

}  // namespace acoss
