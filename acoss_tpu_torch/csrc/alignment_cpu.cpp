// CPU reference/baseline implementations of the cover-song alignment
// kernels (qmax / dmax / constrained Smith-Waterman): the port's own copy
// of the JAX package's `native/alignment_cpu.cpp`, built by
// `acoss_tpu_torch.native` with g++ (nvcc never sees this file).
//
// These implement the published recurrences (Serra 2009 Qmax, Chen 2017
// Dmax, constrained SW with affine gaps) with semantics matching the
// reference framework's kernels (`benchmarking/SequenceAlignment.c:73-180`
// of ctralie/acoss): same predecessors, gap penalties, loop bounds and
// small-size early-outs. Rolling DP rows (O(N) memory instead of O(M*N))
// and a branch-lean inner loop; the cells are computed one by one, which
// is a composition of its own, independent of the PyTorch plain scans and
// of the CUDA kernels.
//
// Used by acoss_tpu_torch as (a) the golden oracle for the CUDA kernels
// and the plain scans and (b) the single-core CPU baseline.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline float max3(float a, float b, float c) {
  return std::max(std::max(a, b), c);
}

inline float gap_of(uint8_t s, float onset, float ext) {
  return s ? onset : ext;
}

}  // namespace

extern "C" {

// Serra 2009 Qmax on a binary M x N cross-recurrence plot.
// Returns the maximum DP cell. Cells with i < 2 or j < 2 stay 0.
float acoss_qmax(const uint8_t* S, int M, int N, float gap_onset,
                 float gap_extension) {
  if (M < 3 || N < 3) return 0.0f;
  std::vector<float> buf(3 * N, 0.0f);
  float* rows[3] = {buf.data(), buf.data() + N, buf.data() + 2 * N};
  float best = 0.0f;
  for (int i = 2; i < M; ++i) {
    float* cur = rows[i % 3];        // row i
    const float* r1 = rows[(i - 1) % 3];  // row i-1
    const float* r2 = rows[(i - 2) % 3];  // row i-2
    const uint8_t* s_cur = S + (size_t)i * N;
    const uint8_t* s1 = S + (size_t)(i - 1) * N;
    const uint8_t* s2 = S + (size_t)(i - 2) * N;
    cur[0] = cur[1] = 0.0f;
    for (int j = 2; j < N; ++j) {
      float v;
      if (s_cur[j]) {
        v = max3(r1[j - 1], r2[j - 1], r1[j - 2]) + 1.0f;
      } else {
        v = max3(r1[j - 1] - gap_of(s1[j - 1], gap_onset, gap_extension),
                 r2[j - 1] - gap_of(s2[j - 1], gap_onset, gap_extension),
                 r1[j - 2] - gap_of(s1[j - 2], gap_onset, gap_extension));
        v = std::max(v, 0.0f);
      }
      cur[j] = v;
      if (v > best) best = v;
    }
  }
  return best;
}

// Chen 2017 Dmax: five predecessors, long paths accumulate skipped S.
float acoss_dmax(const uint8_t* S, int M, int N, float gap_onset,
                 float gap_extension) {
  if (M < 4 || N < 4) return 0.0f;
  std::vector<float> buf(4 * N, 0.0f);
  float* rows[4] = {buf.data(), buf.data() + N, buf.data() + 2 * N,
                    buf.data() + 3 * N};
  float best = 0.0f;
  for (int i = 3; i < M; ++i) {
    float* cur = rows[i % 4];
    const float* r1 = rows[(i - 1) % 4];
    const float* r2 = rows[(i - 2) % 4];
    const float* r3 = rows[(i - 3) % 4];
    const uint8_t* s0 = S + (size_t)i * N;
    const uint8_t* s1 = S + (size_t)(i - 1) * N;
    const uint8_t* s2 = S + (size_t)(i - 2) * N;
    const uint8_t* s3 = S + (size_t)(i - 3) * N;
    cur[0] = cur[1] = cur[2] = 0.0f;
    for (int j = 3; j < N; ++j) {
      float p1 = r1[j - 1];
      float p2 = r2[j - 1] + s1[j];
      float p3 = r1[j - 2] + s0[j - 1];
      float p4 = r3[j - 1] + s2[j] + s1[j];
      float p5 = r1[j - 3] + s0[j - 2] + s0[j - 1];
      float v;
      if (s0[j]) {
        v = std::max(max3(p1, p2, p3), std::max(p4, p5)) + 1.0f;
      } else {
        float c1 = p1 - gap_of(s1[j - 1], gap_onset, gap_extension);
        float c2 = p2 - gap_of(s2[j - 1], gap_onset, gap_extension);
        float c3 = p3 - gap_of(s1[j - 2], gap_onset, gap_extension);
        float c4 = p4 - gap_of(s3[j - 1], gap_onset, gap_extension);
        float c5 = p5 - gap_of(s1[j - 3], gap_onset, gap_extension);
        v = std::max(max3(c1, c2, c3), max3(c4, c5, 0.0f));
      }
      cur[j] = v;
      if (v > best) best = v;
    }
  }
  return best;
}

// Constrained Smith-Waterman with +-1 match score and affine Delta gaps.
// 0-based recurrence equivalent to the reference's offset DP table:
// for a, b >= 2:
//   MS = S[a,b] ? match : mismatch
//   D[a,b] = max(0, max_p D[p] + MS + Delta(S[p], S[a,b]))
//   preds p in {(a-1,b-1), (a-2,b-1), (a-1,b-2)}
//   Delta(prev, cur) = 0 if cur else (gap_opening if prev else gap_extension)
float acoss_swconstrained(const uint8_t* S, int M, int N, float gap_opening,
                          float gap_extension, float match_score,
                          float mismatch_score) {
  if (M < 3 || N < 3) return 0.0f;
  std::vector<float> buf(3 * N, 0.0f);
  float* rows[3] = {buf.data(), buf.data() + N, buf.data() + 2 * N};
  float best = 0.0f;
  for (int a = 2; a < M; ++a) {
    float* cur = rows[a % 3];
    const float* r1 = rows[(a - 1) % 3];
    const float* r2 = rows[(a - 2) % 3];
    const uint8_t* s0 = S + (size_t)a * N;
    const uint8_t* s1 = S + (size_t)(a - 1) * N;
    const uint8_t* s2 = S + (size_t)(a - 2) * N;
    cur[0] = cur[1] = 0.0f;
    for (int b = 2; b < N; ++b) {
      const float ms = s0[b] ? match_score : mismatch_score;
      const bool cm = s0[b] != 0;
      auto delta = [&](uint8_t sprev) -> float {
        if (cm) return 0.0f;
        return sprev ? gap_opening : gap_extension;
      };
      float d1 = r1[b - 1] + ms + delta(s1[b - 1]);
      float d2 = r2[b - 1] + ms + delta(s2[b - 1]);
      float d3 = r1[b - 2] + ms + delta(s1[b - 2]);
      float v = std::max(max3(d1, d2, d3), 0.0f);
      cur[b] = v;
      if (v > best) best = v;
    }
  }
  return best;
}

// Batched variants over B pairs stored contiguously as (B, M, N) with
// per-pair valid sizes; padded region of S must be zero.
void acoss_qmax_batch(const uint8_t* S, int B, int M, int N,
                      const int* m_len, const int* n_len, float gap_onset,
                      float gap_extension, float* out) {
  for (int b = 0; b < B; ++b) {
    out[b] = 0.0f;
    const uint8_t* Sb = S + (size_t)b * M * N;
    // Compact the valid (m, n) window into a contiguous buffer so row
    // stride matches the single-pair kernel's expectation.
    int m = std::min(m_len[b], M), n = std::min(n_len[b], N);
    if (m < 3 || n < 3) continue;
    std::vector<uint8_t> tmp((size_t)m * n);
    for (int i = 0; i < m; ++i)
      std::memcpy(&tmp[(size_t)i * n], Sb + (size_t)i * N, n);
    out[b] = acoss_qmax(tmp.data(), m, n, gap_onset, gap_extension);
  }
}

void acoss_dmax_batch(const uint8_t* S, int B, int M, int N,
                      const int* m_len, const int* n_len, float gap_onset,
                      float gap_extension, float* out) {
  for (int b = 0; b < B; ++b) {
    out[b] = 0.0f;
    const uint8_t* Sb = S + (size_t)b * M * N;
    int m = std::min(m_len[b], M), n = std::min(n_len[b], N);
    if (m < 4 || n < 4) continue;
    std::vector<uint8_t> tmp((size_t)m * n);
    for (int i = 0; i < m; ++i)
      std::memcpy(&tmp[(size_t)i * n], Sb + (size_t)i * N, n);
    out[b] = acoss_dmax(tmp.data(), m, n, gap_onset, gap_extension);
  }
}

void acoss_swconstrained_batch(const uint8_t* S, int B, int M, int N,
                               const int* m_len, const int* n_len,
                               float gap_opening, float gap_extension,
                               float match_score, float mismatch_score,
                               float* out) {
  for (int b = 0; b < B; ++b) {
    out[b] = 0.0f;
    const uint8_t* Sb = S + (size_t)b * M * N;
    int m = std::min(m_len[b], M), n = std::min(n_len[b], N);
    if (m < 3 || n < 3) continue;
    std::vector<uint8_t> tmp((size_t)m * n);
    for (int i = 0; i < m; ++i)
      std::memcpy(&tmp[(size_t)i * n], Sb + (size_t)i * N, n);
    out[b] = acoss_swconstrained(tmp.data(), m, n, gap_opening,
                                 gap_extension, match_score, mismatch_score);
  }
}

}  // extern "C"
