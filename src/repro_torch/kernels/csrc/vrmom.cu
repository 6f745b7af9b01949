// Robust aggregation kernels for Hopper (sm_90a): B1 and B4 of the port.
//
// B1 `agg_kernel` replaces `_agg_2d` / `_kernel` of repro/kernels/vrmom.py
// (the Pallas call at l.151): median / vrmom / trimmed_mean / mean of an
// [m, C] stack over axis 0. One thread per coordinate, through the shared
// device function agg::aggregate (agg.cuh).
//
// B4 `tail_partial_kernel` + `tail_finish_kernel` replace `_tail_3d` /
// `_tail_kernel` (the Pallas call at l.269): the same aggregate of an
// [m, B, V] logit stack, then greedy (k = 1) or top-k token selection in
// (value descending, index ascending) order — jnp.argmax's first
// occurrence and lax.top_k's tie order. The TPU kernel carries a running
// argmax / top-k across its sequential vocab grid; on the GPU the tiles
// run in no order, so each block writes its tile's top-k as partials and
// a finishing pass merges them per row. Selection needs no mutable mask:
// round r picks the best item strictly after round r-1's pick in that
// total order, so every pass is order-independent.
//
// Bound on the H100: both kernels read the stack once (m * C * 4 bytes for
// f32) and write little (B1: C values; B4: k ids per row, plus the [B, V]
// aggregate only when asked), so they are bound by memory bandwidth; the
// per-coordinate sort is O(m^2) compare-exchanges in registers, which for
// the serving width m = 8 stays far below the load time. Design: coalesced
// loads (thread t on coordinate t), no intermediate written to device
// memory, the [B, V] aggregate write skipped when not requested.
#include <climits>
#include <cstdint>

#include "agg.cuh"

namespace {

constexpr int kAggThreads = 256;
constexpr int kTailThreads = 256;
constexpr int kTailItems = 8;  // coordinates per thread in the tail
constexpr int kTailTile = kTailThreads * kTailItems;
constexpr int kFinishThreads = 1024;

// (value, index) total order: larger value first, then smaller index.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Reduce (v, i) to the block's best under `better`; every thread gets it.
template <int THREADS>
__device__ __forceinline__ void block_best(float& v, int& i) {
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  v = sv[0];
  i = si[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w)
    if (better(sv[w], si[w], v, i)) { v = sv[w]; i = si[w]; }
  __syncthreads();  // the scratch is reused by the next call
}

template <int N, typename T>
__global__ void __launch_bounds__(kAggThreads)
agg_kernel(const T* __restrict__ x, T* __restrict__ out, long long C,
           agg::Params P) {
  const long long c = (long long)blockIdx.x * kAggThreads + threadIdx.x;
  if (c >= C) return;
  kern::store(out + c, agg::aggregate<N>(x + c, C, P));
}

// grid (n_tiles, B): block (tile, b) aggregates coordinates
// [tile * kTailTile, (tile + 1) * kTailTile) of row b, then writes the
// tile's top-k (value, index) partials.
template <int N, typename T>
__global__ void __launch_bounds__(kTailThreads)
tail_partial_kernel(const T* __restrict__ x, T* __restrict__ agg_out,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    int B, int V, int top_k, agg::Params P) {
  __shared__ float tile_v[kTailTile];
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTailTile;
  const long long row = (long long)b * V;
  const long long stride = (long long)B * V;
#pragma unroll 1
  for (int j = 0; j < kTailItems; ++j) {
    const int v = v0 + j * kTailThreads + threadIdx.x;
    float a = -INFINITY;
    if (v < V) {
      a = agg::aggregate<N>(x + row + v, stride, P);
      if (agg_out != nullptr) kern::store(agg_out + row + v, a);
    }
    tile_v[j * kTailThreads + threadIdx.x] = a;
  }
  __syncthreads();
  float pv = INFINITY;  // previous pick: every item comes after it
  int pi = -1;
  float* pv_out = part_v + ((long long)b * gridDim.x + blockIdx.x) * top_k;
  int* pi_out = part_i + ((long long)b * gridDim.x + blockIdx.x) * top_k;
  for (int r = 0; r < top_k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < kTailItems; ++j) {
      const int v = v0 + j * kTailThreads + threadIdx.x;
      const float a = tile_v[j * kTailThreads + threadIdx.x];
      if (v < V && better(pv, pi, a, v) && better(a, v, bv, bi)) {
        bv = a;
        bi = v;
      }
    }
    block_best<kTailThreads>(bv, bi);
    if (threadIdx.x == 0) { pv_out[r] = bv; pi_out[r] = bi; }
    pv = bv;
    pi = bi;
  }
}

// grid (B): merge row b's n_cand partials into its top-k.
__global__ void __launch_bounds__(kFinishThreads)
tail_finish_kernel(const float* __restrict__ part_v,
                   const int* __restrict__ part_i, int n_cand, int top_k,
                   float* __restrict__ topv, int* __restrict__ topi) {
  const int b = blockIdx.x;
  const float* cv = part_v + (long long)b * n_cand;
  const int* ci = part_i + (long long)b * n_cand;
  float pv = INFINITY;
  int pi = -1;
  for (int r = 0; r < top_k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < n_cand; c += kFinishThreads) {
      const float a = cv[c];
      const int ai = ci[c];
      if (better(pv, pi, a, ai) && better(a, ai, bv, bi)) {
        bv = a;
        bi = ai;
      }
    }
    block_best<kFinishThreads>(bv, bi);
    if (threadIdx.x == 0) {
      topv[(long long)b * top_k + r] = bv;
      topi[(long long)b * top_k + r] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

agg::Params make_params(int m, int method, int K, int k_trim, float eps,
                        float denom, const float* deltas) {
  agg::Params P;
  P.m = m;
  P.method = method;
  P.K = K;
  P.k_trim = k_trim;
  P.eps = eps;
  P.denom = denom;
  for (int k = 0; k < agg::kMaxK; ++k) P.deltas[k] = k < K ? deltas[k] : 0.f;
  return P;
}

template <int N, typename T>
void launch_agg(const void* x, void* out, long long C, const agg::Params& P,
                cudaStream_t stream) {
  const unsigned blocks = (unsigned)((C + kAggThreads - 1) / kAggThreads);
  agg_kernel<N, T><<<blocks, kAggThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), C, P);
}

template <int N, typename T>
void launch_tail(const void* x, void* agg_out, float* part_v, int* part_i,
                 float* topv, int* topi, int B, int V, int top_k,
                 const agg::Params& P, cudaStream_t stream) {
  const int n_tiles = (V + kTailTile - 1) / kTailTile;
  tail_partial_kernel<N, T><<<dim3(n_tiles, B), kTailThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(agg_out), part_v, part_i, B,
      V, top_k, P);
  tail_finish_kernel<<<B, kFinishThreads, 0, stream>>>(
      part_v, part_i, n_tiles * top_k, top_k, topv, topi);
}

template <typename T>
bool dispatch_agg(const void* x, void* out, long long C, const agg::Params& P,
                  cudaStream_t s) {
  if (P.m <= 8) launch_agg<8, T>(x, out, C, P, s);
  else if (P.m <= 32) launch_agg<32, T>(x, out, C, P, s);
  else if (P.m <= 128) launch_agg<128, T>(x, out, C, P, s);
  else return false;
  return true;
}

template <typename T>
bool dispatch_tail(const void* x, void* agg_out, float* pv, int* pi,
                   float* topv, int* topi, int B, int V, int k,
                   const agg::Params& P, cudaStream_t s) {
  if (P.m <= 8) launch_tail<8, T>(x, agg_out, pv, pi, topv, topi, B, V, k, P, s);
  else if (P.m <= 32) launch_tail<32, T>(x, agg_out, pv, pi, topv, topi, B, V, k, P, s);
  else if (P.m <= 128) launch_tail<128, T>(x, agg_out, pv, pi, topv, topi, B, V, k, P, s);
  else return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (input and output alike).
int agg_launch(const void* x, void* out, int dtype, int m, long long C,
               int method, int K, int k_trim, float eps, float denom,
               const float* deltas, void* stream) {
  if (K > agg::kMaxK) return (int)cudaErrorInvalidValue;
  const agg::Params P = make_params(m, method, K, k_trim, eps, denom, deltas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 0
      ? dispatch_agg<float>(x, out, C, P, s)
      : dispatch_agg<__nv_bfloat16>(x, out, C, P, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Scratch part_v / part_i hold B * ceil(V / 2048) * top_k partials.
// agg_out may be null (no [B, V] aggregate is written then).
int agg_sample_launch(const void* x, void* agg_out, float* part_v,
                      int* part_i, float* topv, int* topi, int dtype, int m,
                      int B, int V, int top_k, int method, int K, int k_trim,
                      float eps, float denom, const float* deltas,
                      void* stream) {
  if (K > agg::kMaxK || top_k < 1) return (int)cudaErrorInvalidValue;
  const agg::Params P = make_params(m, method, K, k_trim, eps, denom, deltas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 0
      ? dispatch_tail<float>(x, agg_out, part_v, part_i, topv, topi, B, V,
                             top_k, P, s)
      : dispatch_tail<__nv_bfloat16>(x, agg_out, part_v, part_i, topv, topi,
                                     B, V, top_k, P, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int agg_tail_tile() { return kTailTile; }

}  // extern "C"
