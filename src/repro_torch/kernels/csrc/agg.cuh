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
// estimator in f32. The networks are Batcher's: 19 comparators at N = 8,
// 191 at N = 32, 1,471 at N = 128.
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
//
// The count of z <= Delta_k runs on the FP32 adders, not on compares (on
// sm_90 compares, min/max and integer adds issue at half the rate of an
// FP32 add): with S = 2^s large enough that every float z != Delta_k has
// |z - Delta_k| >= 1 / S (s = 24 - the least exponent of a nonzero
// delta), z' = z * S and Delta'_k = Delta_k * S are exact (an overflow of
// z' keeps its sign against a finite Delta'_k), so fl(z' - Delta'_k) is 0
// where z == Delta_k and at least 1 in size elsewhere, and saturating it
// to [0, 1] gives [z > Delta_k] exactly. A NaN z is taken as +inf first
// (above every delta, as the brute count has it: NaN <= Delta is false).
// An odd K has the delta 0, whose neighbours are subnormal: there
// [z > 0] is the saturation of z' * 2^126 * 2^126. The count is
// m * K - sum [z > Delta_k], the brute count's integer on every input.
// The argument holds at any K: S only grows as the least |Delta_k|
// shrinks (2^31 at K = 100, whose least is |ndtri(50/101)| ~ 0.0124), and
// the sum of m * K ones stays exact in f32 while m * K <= 2^24, which the
// host checks (vrmom.py ``count_table``: K up to 131,072 at m = 128).
// The scaled deltas travel by value in Params up to K = kMaxK, where each
// add takes its delta from the constant bank; above, they live in device
// memory, read through the read-only path (one address across a warp).
// Device memory for every K cost the serving spec 5 % in B1 and 9 % in B4
// (PERF.md).
#pragma once

#include "common.cuh"

namespace agg {

constexpr int kMaxK = 64;  // deltas that travel by value
constexpr float kMadConst = 0.6744897501960817f;

enum Method : int { kMean = 0, kMedian = 1, kTrimmedMean = 2, kVrmom = 3 };

struct Params {
  int m;          // worker rows
  int method;     // Method
  int K;          // VRMOM quantile levels
  int k_trim;     // trimmed mean: rows dropped at each end
  float eps;      // degenerate-scale guard
  float denom;    // f32(m * psi_sum(K)), computed in float64 on the host
  float scale;    // S = 2^s (the count's scale)
  int zero_k;     // the k with Delta_k == 0 (odd K), else -1
  // f32(ndtri(k / (K + 1))) * S, k = 1..K, ascending: in `table` where
  // K <= kMaxK, else in device memory at `table_ext`
  float table[kMaxK];
  const float* table_ext;
};

// The deltas of a runtime K: by value, or from device memory.
struct ByValue {
  const Params& P;
  __device__ __forceinline__ float operator()(int k) const {
    return P.table[k];
  }
};
struct InMemory {
  const float* t;
  __device__ __forceinline__ float operator()(int k) const {
    return __ldg(t + k);
  }
};

// sum over the m rows of v (z * S) and the K levels of [z > Delta_k]
template <int N, typename Delta>
__device__ __forceinline__ float count_above(const float (&v)[N], int m,
                                             int K, int zero_k, Delta delta) {
  float gt = 0.f;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float d = delta(k);
    if (k != zero_k) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < m) gt += __saturatef(v[i] - d);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < m) gt += __saturatef(v[i] * 0x1p126f * 0x1p126f);
    }
  }
  return gt;
}

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fffffff); }

// a <- the lower, b <- the higher of the two; NaN counts as the highest
__device__ __forceinline__ void cmpx(float& a, float& b) {
  float hi;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(hi) : "f"(a), "f"(b));
  a = fminf(a, b);
  b = hi;
}

// Batcher's odd-even merge of v[LO, LO + LEN), whose two halves are
// sorted, comparing elements R apart and then, recursively, the odd and
// even subsequences.
template <int N, int LO, int LEN, int R>
__device__ __forceinline__ void batcher_merge(float (&v)[N]) {
  constexpr int STEP = 2 * R;
  if constexpr (STEP < LEN) {
    batcher_merge<N, LO, LEN, STEP>(v);
    batcher_merge<N, LO + R, LEN, STEP>(v);
#pragma unroll
    for (int i = LO + R; i + R < LO + LEN; i += STEP) cmpx(v[i], v[i + R]);
  } else {
    cmpx(v[LO], v[LO + R]);
  }
}

template <int N, int LO, int LEN>
__device__ __forceinline__ void batcher_sort(float (&v)[N]) {
  if constexpr (LEN > 1) {
    batcher_sort<N, LO, LEN / 2>(v);
    batcher_sort<N, LO + LEN / 2, LEN / 2>(v);
    batcher_merge<N, LO, LEN, 1>(v);
  }
}

// Sorts v ascending, NaN last. Every compare-exchange orders NaN, so any
// sorting network gives the same sorted values.
template <int N>
__device__ __forceinline__ void sort_network(float (&v)[N]) {
  static_assert((N & (N - 1)) == 0, "the networks sort powers of two");
  if constexpr (N == 8) {
    // Batcher's merge-exchange network: 19 comparators, depth 6
    cmpx(v[0], v[2]); cmpx(v[1], v[3]); cmpx(v[4], v[6]); cmpx(v[5], v[7]);
    cmpx(v[0], v[4]); cmpx(v[1], v[5]); cmpx(v[2], v[6]); cmpx(v[3], v[7]);
    cmpx(v[0], v[1]); cmpx(v[2], v[3]); cmpx(v[4], v[5]); cmpx(v[6], v[7]);
    cmpx(v[2], v[4]); cmpx(v[3], v[5]);
    cmpx(v[1], v[4]); cmpx(v[3], v[6]);
    cmpx(v[1], v[2]); cmpx(v[3], v[4]); cmpx(v[5], v[6]);
  } else {
    // odd-even merge sort: 191 comparators at N = 32, 1,471 at N = 128
    batcher_sort<N, 0, N>(v);
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
// branch on the method, the median indices folded and the count
// unrolled. Its bits are those of the instance that reads the spec from P.
template <int N, int M = 0, int KK = 0>
__device__ __forceinline__ float aggregate_values(float (&v)[N],
                                                  const Params& P) {
  static_assert(KK % 2 == 0, "an odd K has a zero delta: runtime K only");
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
  // v <- z * S, NaN as +inf; gt <- sum over rows and k of [z > Delta_k]
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < m) v[i] = fminf((v[i] - med) / sd * P.scale, INFINITY);
  float gt = 0.f;
  if constexpr (KK != 0) {
#pragma unroll
    for (int k = 0; k < KK; ++k) {
      const float d = P.table[k];
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < m) gt += __saturatef(v[i] - d);
    }
  } else if (K <= kMaxK) {
    gt = count_above<N>(v, m, K, P.zero_k, ByValue{P});
  } else {
    gt = count_above<N>(v, m, K, P.zero_k, InMemory{P.table_ext});
  }
  const int count = m * K - (int)gt;
  // sum over rows of (count_i - K/2): a half-integer, exact in f32
  const float total = 0.5f * (float)(2 * count - m * K);
  const float out = med - s * total / P.denom;
  return s <= P.eps ? med : out;
}

}  // namespace agg
