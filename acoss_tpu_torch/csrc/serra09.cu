// Serra09's tile glue around the fused CRP (`crp.cu`), in two launches:
//
// - serra09_pair_operands: the fused CRP's per-pair operands of a (bi x bj)
//   tile, pair b = i bj + j: row song i's chroma rolled by the pair's
//   optimal transposition index, column song j's chroma, both songs' mfcc
//   with row song i's first frame subtracted and zero past each song's
//   length, and the pair's two lengths;
// - serra09_scores_epilogue: the channels' qmax and dmax scores over
//   max(l1e + l2e, 1), written as one (2, nf, B) block.
//
// They replace no TPU kernel: the JAX package's tile is one jitted program
// (`acoss_tpu/benchmarking/algorithms/serra09.py` `_tile_crps_fused`,
// `_scores`) in which XLA fuses this glue. Run eagerly, it was ~30 small
// PyTorch launches a tile, which the host enqueued more slowly than the
// card ran the tile. So what bounds these kernels is their launch: each
// moves a few hundred KB a tile (tens of MB at a mesh call's 1,920 pairs)
// and does at most one fp32 operation an element; a block copies a stretch
// of frames of one pair, a thread one element, coalesced.
//
// Every value is a copy, one fp32 subtraction (__fsub_rn), an int-to-float
// conversion or one fp32 division (__fdiv_rn), the operations of the torch
// composition (`acoss_tpu_torch.ops.serra09_cuda`'s `*_ref`) in the same
// rounding, so both give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 32;      // frames of one pair a block copies
constexpr int kMaxChannels = 4;  // channels the epilogue takes

// grid (ceil(L / kFrames), bi bj). oti (bi, bj) may be null (no roll).
__global__ void __launch_bounds__(kThreads)
serra09_pair_operands(const float* __restrict__ rc,
                      const float* __restrict__ cc,
                      const float* __restrict__ rm,
                      const float* __restrict__ cm,
                      const int* __restrict__ rlen,
                      const int* __restrict__ clen,
                      const long long* __restrict__ oti, int bj, int L,
                      int dc, int dm, float* __restrict__ Xc,
                      float* __restrict__ Yc, float* __restrict__ Xm,
                      float* __restrict__ Ym, int* __restrict__ l1,
                      int* __restrict__ l2) {
  const int b = blockIdx.y, i = b / bj, j = b - i * bj;
  const int t0 = blockIdx.x * kFrames, nt = min(kFrames, L - t0);
  const int li = rlen[i], lj = clen[j];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    l1[b] = li;
    l2[b] = lj;
  }
  // out[c] = in[(c - s) mod dc], `crp.transpose_chroma`'s roll
  int s = 0;
  if (oti != nullptr) {
    s = (int)(oti[b] % dc);
    if (s < 0) s += dc;
  }
  const size_t pair = (size_t)b * L + t0;
  {
    const float* r = rc + ((size_t)i * L + t0) * dc;
    const float* c = cc + ((size_t)j * L + t0) * dc;
    float* x = Xc + pair * dc;
    float* y = Yc + pair * dc;
    for (int e = threadIdx.x; e < nt * dc; e += kThreads) {
      const int t = e / dc, k = e - t * dc;
      x[e] = r[t * dc + (k >= s ? k - s : k - s + dc)];
      y[e] = c[e];
    }
  }
  {
    const float* origin = rm + (size_t)i * L * dm;   // row song's frame 0
    const float* r = rm + ((size_t)i * L + t0) * dm;
    const float* c = cm + ((size_t)j * L + t0) * dm;
    float* x = Xm + pair * dm;
    float* y = Ym + pair * dm;
    for (int e = threadIdx.x; e < nt * dm; e += kThreads) {
      const int t = e / dm, k = e - t * dm;
      const float o = origin[k];
      x[e] = t0 + t < li ? __fsub_rn(r[e], o) : 0.0f;
      y[e] = t0 + t < lj ? __fsub_rn(c[e], o) : 0.0f;
    }
  }
}

struct ChannelScores {
  const float* q[kMaxChannels];
  const float* d[kMaxChannels];
};

// grid ceil(B / kThreads). out[0, f, b] = q_f[b] / den, out[1, f, b] =
// d_f[b] / den, den = max(l1e[b] + l2e[b], 1) converted to float.
__global__ void __launch_bounds__(kThreads)
serra09_scores_epilogue(ChannelScores in, const int* __restrict__ l1e,
                        const int* __restrict__ l2e, int nf, int B,
                        float* __restrict__ out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float den = __int2float_rn(max(l1e[b] + l2e[b], 1));
  for (int f = 0; f < nf; ++f) {
    out[(size_t)f * B + b] = __fdiv_rn(in.q[f][b], den);
    out[(size_t)(nf + f) * B + b] = __fdiv_rn(in.d[f][b], den);
  }
}

}  // namespace

extern "C" {

// rc (bi, L, dc), cc (bj, L, dc), rm (bi, L, dm), cm (bj, L, dm) float32;
// rlen (bi,), clen (bj,) int32; oti (bi, bj) int64 or null. Writes Xc, Yc
// (bi bj, L, dc), Xm, Ym (bi bj, L, dm) and l1, l2 (bi bj,).
int acoss_serra09_pair_operands(const float* rc, const float* cc,
                                const float* rm, const float* cm,
                                const int* rlen, const int* clen,
                                const long long* oti, int bi, int bj, int L,
                                int dc, int dm, float* Xc, float* Yc,
                                float* Xm, float* Ym, int* l1, int* l2,
                                int device, void* stream) {
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (bi < 0 || bj < 0 || (size_t)bi * bj > 65535 || L <= 0 || dc <= 0
      || dm <= 0)
    return (int)cudaErrorInvalidValue;
  if (bi == 0 || bj == 0) return (int)cudaGetLastError();
  serra09_pair_operands<<<dim3((L + kFrames - 1) / kFrames, bi * bj),
                          kThreads, 0, (cudaStream_t)stream>>>(
      rc, cc, rm, cm, rlen, clen, oti, bj, L, dc, dm, Xc, Yc, Xm, Ym, l1, l2);
  return (int)cudaGetLastError();
}

// qd: a host array of 2 nf device pointers, the nf channels' (B,) qmax
// scores and then their dmax scores; l1e, l2e (B,) int32; out (2, nf, B).
int acoss_serra09_scores(const float* const* qd, const int* l1e,
                         const int* l2e, int nf, int B, float* out,
                         int device, void* stream) {
  acoss::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  if (nf < 1 || nf > kMaxChannels || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  ChannelScores in = {};
  for (int f = 0; f < nf; ++f) {
    in.q[f] = qd[f];
    in.d[f] = qd[nf + f];
  }
  serra09_scores_epilogue<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(in, l1e, l2e, nf, B,
                                                    out);
  return (int)cudaGetLastError();
}

}  // extern "C"
