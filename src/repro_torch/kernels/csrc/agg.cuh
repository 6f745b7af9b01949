// Coordinate-wise robust aggregation of one coordinate over the worker
// axis: the device functions both aggregation kernels (vrmom.cu: the plain
// aggregate and the fused aggregate + sample tail) call, so the fused
// greedy tokens are bit-identical to an argmax over the plain aggregate.
//
// Replaces `_agg_block` / `_sort_rows` of repro/kernels/vrmom.py (the
// Pallas TPU kernel). The TPU kernel sorts a [m_pad, tile] VMEM block with
// an odd-even transposition network over the sublanes; here each thread
// owns whole coordinates: it holds the m worker values of one coordinate
// in registers, sorts them with a compile-time network over a width N
// (padded with NaN, which sorts past the m real rows), and evaluates the
// estimator in f32.
//
// The sort is the plain version's (torch.sort): NaN ranks above every
// number, so a NaN row sorts last and counts like any other. Each
// compare-exchange is `min.f32` (which drops a NaN operand) for the low
// side and `max.NaN.f32` (which keeps it) for the high side.
//
// Numerics follow the TPU kernel's op order (repro/kernels/vrmom.py
// l.93-120): means are row-order sums times the f32 reciprocal of the row
// count (the form XLA gives the reference's division by a count); median
// = 0.5 * (two middle order statistics), MAD = the same of |x - med|,
// s = MAD / 0.6744897501960817, z = (x - med) / max(s, eps), counts of
// z <= Delta_k, and out = med - s * total / (m * psi_sum(K)) with the
// denominator one f32 computed on the host; s <= eps returns the median.
// Built with --fmad=false so no multiply-add is contracted.
#pragma once

#include "common.cuh"

namespace agg {

constexpr int kMaxK = 64;
constexpr float kMadConst = 0.6744897501960817f;

enum Method : int { kMean = 0, kMedian = 1, kTrimmedMean = 2, kVrmom = 3 };

struct Params {
  int m;          // worker rows
  int method;     // Method
  int K;          // VRMOM quantile levels (<= kMaxK)
  int k_trim;     // trimmed mean: rows dropped at each end
  float eps;      // degenerate-scale guard
  float denom;    // f32(m * psi_sum(K)), computed in float64 on the host
  float deltas[kMaxK];  // f32(ndtri(k / (K + 1))), k = 1..K, ascending
};

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fffffff); }

// a <- the lower, b <- the higher of the two; NaN counts as the highest
__device__ __forceinline__ void cmpx(float& a, float& b) {
  float hi;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(hi) : "f"(a), "f"(b));
  a = fminf(a, b);
  b = hi;
}

// Sorts v ascending, NaN last. Every compare-exchange orders NaN, so any
// sorting network gives the same sorted values.
template <int N>
__device__ __forceinline__ void sort_network(float (&v)[N]) {
  if constexpr (N == 8) {
    // Batcher's merge-exchange network: 19 comparators, depth 6
    cmpx(v[0], v[2]); cmpx(v[1], v[3]); cmpx(v[4], v[6]); cmpx(v[5], v[7]);
    cmpx(v[0], v[4]); cmpx(v[1], v[5]); cmpx(v[2], v[6]); cmpx(v[3], v[7]);
    cmpx(v[0], v[1]); cmpx(v[2], v[3]); cmpx(v[4], v[5]); cmpx(v[6], v[7]);
    cmpx(v[2], v[4]); cmpx(v[3], v[5]);
    cmpx(v[1], v[4]); cmpx(v[3], v[6]);
    cmpx(v[1], v[2]); cmpx(v[3], v[4]); cmpx(v[5], v[6]);
  } else {
    // odd-even transposition sort: N phases, alternating even and odd pairs
#pragma unroll 1
    for (int p = 0; p < N; p += 2) {
#pragma unroll
      for (int i = 0; i + 1 < N; i += 2) cmpx(v[i], v[i + 1]);
#pragma unroll
      for (int i = 1; i + 1 < N; i += 2) cmpx(v[i], v[i + 1]);
    }
  }
}

// Average of the two middle order statistics of the first m sorted slots.
// Static indices only, so the array stays in registers.
template <int N>
__device__ __forceinline__ float median_sorted(const float (&v)[N], int m) {
  const int ia = (m - 1) / 2, ib = m / 2;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == ia) a = v[i];
    if (i == ib) b = v[i];
  }
  return 0.5f * (a + b);
}

// Aggregate v[0..m) (m <= N); v[m..N) is scratch. v is clobbered.
// M and KK, where not 0, fix a vrmom spec at compile time, m = M and
// K = KK: the serving spec (m = K = 8) is such an instance, with no
// branch on the method, the median indices folded and the count of
// z <= Delta_k unrolled. Its bits are those of the instance that reads the
// spec from P.
template <int N, int M = 0, int KK = 0>
__device__ __forceinline__ float aggregate_values(float (&v)[N],
                                                  const Params& P) {
  const int method = KK ? kVrmom : P.method;
  const int m = M ? M : P.m;
  const int K = KK ? KK : P.K;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i >= m) v[i] = nan_f32();
  if (method == kMean) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < m) acc += v[i];
    return acc * (1.f / (float)m);
  }
  sort_network<N>(v);
  if (method == kTrimmedMean) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i >= P.k_trim && i < m - P.k_trim) acc += v[i];
    return acc * (1.f / (float)(m - 2 * P.k_trim));
  }
  const float med = median_sorted<N>(v, m);
  if (method == kMedian) return med;
  float dev[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dev[i] = fabsf(v[i] - med);  // pads stay NaN
  sort_network<N>(dev);
  const float s = median_sorted<N>(dev, m) / kMadConst;
  const float sd = fmaxf(s, P.eps);
  int count = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < m) {
      const float z = (v[i] - med) / sd;
      for (int k = 0; k < K; ++k) count += z <= P.deltas[k];
    }
  }
  // sum over rows of (count_i - K/2): a half-integer, exact in f32
  const float total = 0.5f * (float)(2 * count - m * K);
  const float out = med - s * total / P.denom;
  return s <= P.eps ? med : out;
}

}  // namespace agg
