// Coordinate-wise robust aggregation of one coordinate over the worker
// axis: the device function both aggregation kernels (vrmom.cu: the plain
// aggregate and the fused aggregate + sample tail) call, so the fused
// greedy tokens are bit-identical to an argmax over the plain aggregate.
//
// Replaces `_agg_block` / `_sort_rows` of repro/kernels/vrmom.py (the
// Pallas TPU kernel). The TPU kernel sorts a [m_pad, tile] VMEM block with
// an odd-even transposition network over the sublanes; here each thread
// owns ONE coordinate: it loads the m worker values (threads of a warp on
// neighbouring coordinates, so every load is coalesced), sorts them in
// registers with the same odd-even transposition network over a
// compile-time width MMAX (padded with +inf, which sorts past the m real
// rows), and evaluates the estimator in f32.
//
// Numerics follow the TPU kernel's op order (repro/kernels/vrmom.py
// l.93-120): means are row-order sums times the f32 reciprocal of the row
// count (the form XLA gives the reference's division by a count); median
// = 0.5 * (two middle order statistics), MAD from a
// second sort of |x - med|, s = MAD / 0.6744897501960817,
// z = (x - med) / max(s, eps), counts of z <= Delta_k, and
// out = med - s * total / (m * psi_sum(K)) with the denominator one f32
// computed on the host; s <= eps returns the median. Built with
// --fmad=false so no multiply-add is contracted.
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
  float deltas[kMaxK];  // f32(ndtri(k / (K + 1))), k = 1..K
};

template <int N>
__device__ __forceinline__ void sort_network(float (&v)[N]) {
  // odd-even transposition sort: N phases, alternating even and odd pairs
#pragma unroll 1
  for (int p = 0; p < N; p += 2) {
#pragma unroll
    for (int i = 0; i + 1 < N; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      v[i + 1] = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
    }
#pragma unroll
    for (int i = 1; i + 1 < N; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      v[i + 1] = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
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

// Aggregate x[0], x[stride], ..., x[(m-1)*stride] (m <= N).
template <int N, typename T>
__device__ __forceinline__ float aggregate(const T* __restrict__ x,
                                           long long stride,
                                           const Params& P) {
  const int m = P.m;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = i < m ? kern::to_f32(x[(long long)i * stride]) : INFINITY;
  if (P.method == kMean) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < m) acc += v[i];
    return acc * (1.f / (float)m);
  }
  sort_network<N>(v);
  if (P.method == kTrimmedMean) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i >= P.k_trim && i < m - P.k_trim) acc += v[i];
    return acc * (1.f / (float)(m - 2 * P.k_trim));
  }
  const float med = median_sorted<N>(v, m);
  if (P.method == kMedian) return med;
  float dev[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dev[i] = fabsf(v[i] - med);  // pads stay +inf
  sort_network<N>(dev);
  const float s = median_sorted<N>(dev, m) / kMadConst;
  const float sd = fmaxf(s, P.eps);
  int count = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < m) {
      const float z = (v[i] - med) / sd;
      for (int k = 0; k < P.K; ++k) count += z <= P.deltas[k];
    }
  }
  // sum over rows of (count_i - K/2): a half-integer, exact in f32
  const float total = 0.5f * (float)(2 * count - m * P.K);
  const float out = med - s * total / P.denom;
  return s <= P.eps ? med : out;
}

}  // namespace agg
