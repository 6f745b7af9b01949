// Robust aggregation kernels for Hopper (sm_90a): B1 and B4 of the port.
//
// B1 `agg_kernel` replaces `_agg_2d` / `_kernel` of repro/kernels/vrmom.py
// (the Pallas call at l.151): median / vrmom / trimmed_mean / mean of an
// [m, C] stack over axis 0, through agg::aggregate_values of agg.cuh (at
// the serving spec, vrmom at m = 8, K = 8, its instance with the spec fixed
// at compile time: the same bits).
//
// B4 `tail_kernel` replaces `_tail_3d` / `_tail_kernel` (the Pallas call
// at l.269): the same aggregate of an [m, B, V] logit stack, then greedy
// (k = 1) or top-k token selection in (value descending, index ascending)
// order: jnp.argmax's first occurrence and lax.top_k's tie order. NaN
// ranks above every number, as in torch.argmax and torch.sort, which the
// plain version and the unfused path use. The TPU kernel carries a running
// argmax / top-k across its sequential vocab grid. Here blocks run in no
// order, all in ONE launch: each block aggregates a tile of one row,
// writes its tile's best k (value, index) records, and takes a ticket from
// the row's counter; the block that draws the row's last ticket merges the
// row's records and writes its top-k, then resets the counter to zero, so
// the counters are zeroed once and never filled again.
//
// A (value, index) pair travels as one 64-bit key whose unsigned order is
// the selection order: the value's bits made monotone (NaN highest, -0
// equal to +0) above the complemented index. Greedy is a max over keys; a
// tile's top-k is a bitonic sort of its keys in shared memory; the merge
// walks the rows' sorted record lists by their heads, one pick a round.
//
// Bound on the H100: both kernels read the stack once (m * C * 4 bytes for
// f32) and write little (B1: C values; B4: k ids per row, plus the [B, V]
// aggregate only when asked): the bytes bound both. At the serving shape
// neither comes near it, nor does a torch.sum over the same stack; what
// holds them there is not measured (PERF.md).
// Design of B1: a thread a coordinate, a block 256 of them, each thread
// loading its coordinate's m values itself (coalesced across the warp),
// so the registers stay few (27 at the serving spec) and the hardware's
// block scheduler overlaps one block's loads with another's arithmetic.
// Neither a persistent grid nor a shared-memory copy pipeline beat it
// (PERF.md).
// Design of B4: a thread loads every row of its coordinates (2 at m <= 8,
// one 8-byte load a row along V in f32; 1 above) before it sorts any, so
// each thread keeps m * 2 loads in flight; no intermediate but the
// per-block records reaches device memory. The last block's merge follows
// at most kMergeLists record lists a thread, so where V has more than
// kMergeLists * kTailThreads tiles a block covers several tiles in turn
// and keeps their best keys.
#include <cmath>
#include <cstdint>

#include "agg.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kAggThreads = 256;
constexpr int kTailThreads = 256;
constexpr int kMergeLists = 4;  // record lists one thread of the merge follows

// coordinates a thread of B4 aggregates: 2 where the m values of two fit
// in registers (the 8-wide network), else 1
template <int N>
constexpr int kItems = N <= 8 ? 2 : 1;

// -- (value, index) keys -----------------------------------------------------

__device__ __forceinline__ u64 pack(float a, int idx) {
  unsigned u = a == 0.f ? 0u : __float_as_uint(a);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  if (a != a) u = 0xffffffffu;
  return ((u64)u << 32) | (unsigned)~idx;
}

__device__ __forceinline__ float key_value(u64 k) {
  const unsigned u = (unsigned)(k >> 32);
  if (u == 0xffffffffu) return agg::nan_f32();
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_index(u64 k) { return (int)~(unsigned)k; }

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

// Block-wide max; every thread gets it. `buf` is free again only after the
// next barrier, so back-to-back calls alternate two buffers.
template <int THREADS>
__device__ __forceinline__ u64 block_max(u64 v, u64* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = umax(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
  __syncthreads();
  v = buf[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) v = umax(v, buf[w]);
  return v;
}

// Sort `s` [TILE] descending (bitonic network, THREADS threads).
template <int TILE, int THREADS>
__device__ __forceinline__ void block_sort_desc(u64* s) {
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < TILE / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

// -- B1 ----------------------------------------------------------------------

// One coordinate's aggregate; FAST: the serving spec (vrmom, m = 8,
// K = 8) fixed at compile time, the same bits.
template <int N, bool FAST>
__device__ __forceinline__ float aggregate_coord(float (&v)[N],
                                                 const agg::Params& P) {
  if constexpr (FAST) {
    static_assert(N == 8, "the fast instance is vrmom at m = 8, K = 8");
    return agg::aggregate_values<8, 8, 8>(v, P);
  } else {
    return agg::aggregate_values<N>(v, P);
  }
}

// Block b aggregates coordinates [b * kAggThreads, ...), a thread one.
template <int N, typename T, bool FAST>
__global__ void __launch_bounds__(kAggThreads)
agg_kernel(const T* __restrict__ x, T* __restrict__ out, long long C,
           const __grid_constant__ agg::Params P) {
  const long long c = (long long)blockIdx.x * kAggThreads + threadIdx.x;
  if (c >= C) return;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = FAST || i < P.m ? kern::to_f32(x[c + i * C]) : 0.f;
  kern::store(out + c, aggregate_coord<N, FAST>(v, P));
}

// -- B4 ----------------------------------------------------------------------

// The m rows of coordinates v0 .. v0 + ITEMS - 1 of one logit row, every
// load issued before any is used. `vec`: V and the stack are aligned for
// one ITEMS-wide load per row.
template <int N, typename T, int ITEMS>
__device__ __forceinline__ void load_items(const T* __restrict__ xb,
                                           long long stride, int v0, int V,
                                           bool vec, int m,
                                           float (&vals)[ITEMS][N]) {
  if (vec && v0 + ITEMS <= V) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < m) {
        float f[ITEMS];
        kern::load_vec<T, ITEMS>(xb + i * stride + v0, f);
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) vals[j][i] = f[j];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        vals[j][i] = i < m && v0 + j < V
            ? kern::to_f32(xb[i * stride + v0 + j]) : 0.f;
  }
}

// The last block of a row: merge the row's n_blk sorted record lists (kk
// records each, best first, empty slots 0) into its top_k. Thread t
// follows lists t, t + THREADS, ...: their heads, and the record after
// each head, loaded ahead, sit in registers. Each round the block takes the
// largest head; its owner moves that list on. top_k <= V, so a round never
// finds every list empty.
template <int THREADS>
__device__ __forceinline__ void merge_row(const u64* __restrict__ rb,
                                          int n_blk, int kk, int top_k,
                                          float* __restrict__ tv,
                                          int* __restrict__ ti,
                                          u64 (&red)[2][THREADS / 32]) {
  u64 head[kMergeLists], next[kMergeLists];
  int pos[kMergeLists];
#pragma unroll
  for (int l = 0; l < kMergeLists; ++l) {
    const int j = threadIdx.x + l * THREADS;
    const u64* list = rb + (long long)j * kk;
    head[l] = j < n_blk ? __ldcg(list) : 0ull;
    next[l] = j < n_blk && kk > 1 ? __ldcg(list + 1) : 0ull;
    pos[l] = 0;
  }
  for (int r = 0; r < top_k; ++r) {
    u64 mine = 0;
    int lm = 0;
#pragma unroll
    for (int l = 0; l < kMergeLists; ++l)
      if (head[l] > mine) {
        mine = head[l];
        lm = l;
      }
    const u64 w = block_max<THREADS>(mine, red[r & 1]);
    if (threadIdx.x == 0) {
      tv[r] = key_value(w);
      ti[r] = key_index(w);
    }
    if (mine == w && w != 0) {  // keys are distinct: one owner
#pragma unroll
      for (int l = 0; l < kMergeLists; ++l) {
        if (l != lm) continue;
        const int p = ++pos[l];
        head[l] = next[l];
        next[l] = p + 1 < kk ? __ldcg(rb + (long long)(threadIdx.x + l *
                                      THREADS) * kk + p + 1)
                             : 0ull;
      }
    }
  }
}

// grid (n_blk, B): block (t, b) aggregates the `chunks` tiles from tile
// t * chunks on of row b (TILE coordinates each; one tile a block unless V
// has more than kMergeLists * kTailThreads tiles), writes its best
// kk = min(top_k, TILE) keys to rec[b][t], and the row's last block merges
// them. Top-k over several tiles keeps the best TILE keys in keys[0, TILE)
// and sorts each further tile's keys in with them in keys[0, 2 * TILE).
template <int N, typename T, bool FAST>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const T* __restrict__ x, T* __restrict__ agg_out,
            u64* __restrict__ rec, int* __restrict__ tickets,
            float* __restrict__ topv, int* __restrict__ topi, int B, int V,
            int top_k, int kk, int chunks, bool vec,
            const __grid_constant__ agg::Params P) {
  constexpr int ITEMS = kItems<N>;
  constexpr int TILE = kTailThreads * ITEMS;
  extern __shared__ u64 keys[];  // [TILE] or [2 * TILE], top_k > 1 only
  __shared__ u64 red[2][kTailThreads / 32];
  __shared__ int ticket;
  const int b = blockIdx.y, n_blk = gridDim.x;
  const long long stride = (long long)B * V;

  u64 best = 0;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const long long t0 = ((long long)blockIdx.x * chunks + c) * TILE;
    if (t0 >= V) break;  // the same for every thread of the block
    const int v0 = (int)t0 + threadIdx.x * ITEMS;
    float vals[ITEMS][N];
    load_items<N, T, ITEMS>(x + (long long)b * V, stride, v0, V, vec,
                            FAST ? N : P.m, vals);
    u64* tile_keys = keys + (c == 0 ? 0 : TILE);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      u64 key = 0;
      if (v0 + j < V) {
        const float a = aggregate_coord<N, FAST>(vals[j], P);
        if (agg_out != nullptr)
          kern::store(agg_out + (long long)b * V + v0 + j, a);
        key = pack(a, v0 + j);
      }
      if (top_k == 1) best = umax(best, key);
      else tile_keys[threadIdx.x * ITEMS + j] = key;
    }
    if (top_k > 1) {
      if (c == 0) block_sort_desc<TILE, kTailThreads>(keys);
      else block_sort_desc<2 * TILE, kTailThreads>(keys);
    }
  }
  u64* rb = rec + (long long)b * n_blk * kk;
  if (top_k == 1) {
    best = block_max<kTailThreads>(best, red[0]);
    if (threadIdx.x == 0) rb[blockIdx.x] = best;
  } else {
    for (int r = threadIdx.x; r < kk; r += kTailThreads)
      rb[(long long)blockIdx.x * kk + r] = keys[r];
  }
  // One thread releases the block's records (ordered before it by the
  // barrier), takes the ticket and acquires the other blocks' records, as
  // decode_attention.cu's merge does.
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    ticket = atomicAdd(tickets + b, 1);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (ticket != n_blk - 1) return;
  merge_row<kTailThreads>(rb, n_blk, kk, top_k, topv + (long long)b * top_k,
                          topi + (long long)b * top_k, red);
  if (threadIdx.x == 0) tickets[b] = 0;
}

// -- host side ---------------------------------------------------------------

// The count's scale S, the zero delta's index and the scaled table come
// from the host (vrmom.py ``count_table``), which also checks that the
// count is exact at this m and K: `table` (host memory, copied into the
// parameters) where K <= kMaxK, else `table_ext` (device memory).
agg::Params make_params(int m, int method, int K, int k_trim, float eps,
                        float denom, float scale, int zero_k,
                        const float* table, const float* table_ext) {
  agg::Params P;
  P.m = m;
  P.method = method;
  P.K = K;
  P.k_trim = k_trim;
  P.eps = eps;
  P.denom = denom;
  P.scale = scale;
  P.zero_k = zero_k;
  for (int k = 0; k < agg::kMaxK; ++k)
    P.table[k] = table != nullptr && k < K ? table[k] : 0.f;
  P.table_ext = table_ext;
  return P;
}

// the brute count's integer needs m * K <= 2^24 (agg.cuh)
bool valid_spec(int m, int method, int K, const float* table,
                const float* table_ext) {
  if (method != agg::kVrmom) return true;
  return K >= 1 && (long long)m * K <= (1LL << 24) &&
         (K <= agg::kMaxK ? table != nullptr : table_ext != nullptr);
}

// vrmom at m = 8, K = 8: the serving spec, which takes the fast path
bool fast_spec(const agg::Params& P) {
  return P.method == agg::kVrmom && P.m == 8 && P.K == 8;
}

template <int N, typename T, bool FAST = false>
void launch_agg(const void* x, void* out, long long C, const agg::Params& P,
                cudaStream_t stream) {
  const unsigned blocks = (unsigned)((C + kAggThreads - 1) / kAggThreads);
  agg_kernel<N, T, FAST><<<blocks, kAggThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), C, P);
}

struct TailArgs {
  const void* x;
  void* agg_out;
  u64* rec;
  int* tickets;
  float* topv;
  int* topi;
  int B, V, top_k;
  cudaStream_t s;
};

// The grid of plan_tail (vrmom.py): tiles of TILE coordinates, `chunks`
// tiles a block so that a row has at most kMergeLists * kTailThreads
// blocks, as few blocks as that allows.
struct TailGrid {
  int chunks, n_blk;
};

inline TailGrid tail_grid(int V, int tile) {
  const int n_tiles = (V + tile - 1) / tile;
  const int cap = kMergeLists * kTailThreads;
  const int chunks = (n_tiles + cap - 1) / cap;
  return {chunks, (n_tiles + chunks - 1) / chunks};
}

template <int N, typename T, bool FAST = false>
void launch_tail(const TailArgs& a, const agg::Params& P) {
  constexpr int ITEMS = kItems<N>;
  constexpr int TILE = kTailThreads * ITEMS;
  const TailGrid g = tail_grid(a.V, TILE);
  const int kk = a.top_k < TILE ? a.top_k : TILE;
  const bool vec = a.V % ITEMS == 0 &&
      reinterpret_cast<uintptr_t>(a.x) % (ITEMS * sizeof(T)) == 0;
  const size_t smem =
      a.top_k > 1 ? (g.chunks > 1 ? 2 : 1) * TILE * sizeof(u64) : 0;
  tail_kernel<N, T, FAST><<<dim3(g.n_blk, a.B), kTailThreads, smem, a.s>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.agg_out), a.rec,
      a.tickets, a.topv, a.topi, a.B, a.V, a.top_k, kk, g.chunks, vec, P);
}

template <typename T>
bool dispatch_agg(const void* x, void* out, long long C, const agg::Params& P,
                  cudaStream_t s) {
  if (fast_spec(P)) launch_agg<8, T, true>(x, out, C, P, s);
  else if (P.m <= 8) launch_agg<8, T>(x, out, C, P, s);
  else if (P.m <= 32) launch_agg<32, T>(x, out, C, P, s);
  else if (P.m <= 128) launch_agg<128, T>(x, out, C, P, s);
  else return false;
  return true;
}

template <typename T>
bool dispatch_tail(const TailArgs& a, const agg::Params& P) {
  if (fast_spec(P)) launch_tail<8, T, true>(a, P);
  else if (P.m <= 8) launch_tail<8, T>(a, P);
  else if (P.m <= 32) launch_tail<32, T>(a, P);
  else if (P.m <= 128) launch_tail<128, T>(a, P);
  else return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (input and output alike).
// vrmom only (else null): table, the K scaled deltas in host memory
// where K <= 64; table_ext, the same in device memory above.
int agg_launch(const void* x, void* out, int dtype, int m, long long C,
               int method, int K, int k_trim, float eps, float denom,
               float scale, int zero_k, const float* table,
               const float* table_ext, void* stream) {
  if (!valid_spec(m, method, K, table, table_ext)) {
    return (int)cudaErrorInvalidValue;
  }
  const agg::Params P = make_params(m, method, K, k_trim, eps, denom, scale,
                                    zero_k, table, table_ext);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 0
      ? dispatch_agg<float>(x, out, C, P, s)
      : dispatch_agg<__nv_bfloat16>(x, out, C, P, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One launch. rec holds B * n_blk * min(top_k, tile) keys (uninitialised),
// with tile = 512 coordinates at m <= 8 and 256 above, and n_blk as
// tail_grid gives it (plan_tail in vrmom.py); tickets B int32 counters,
// zero on entry and left zero. agg_out may be null (no [B, V] aggregate is
// written then). topv / topi are [B, top_k].
int agg_sample_launch(const void* x, void* agg_out, void* rec, int* tickets,
                      float* topv, int* topi, int dtype, int m, int B, int V,
                      int top_k, int method, int K, int k_trim, float eps,
                      float denom, float scale, int zero_k,
                      const float* table, const float* table_ext,
                      void* stream) {
  if (!valid_spec(m, method, K, table, table_ext) || top_k < 1 ||
      top_k > V) {
    return (int)cudaErrorInvalidValue;
  }
  const agg::Params P = make_params(m, method, K, k_trim, eps, denom, scale,
                                    zero_k, table, table_ext);
  const TailArgs a{x, agg_out, static_cast<u64*>(rec), tickets, topv, topi,
                   B, V, top_k, static_cast<cudaStream_t>(stream)};
  const bool ok = dtype == 0 ? dispatch_tail<float>(a, P)
                             : dispatch_tail<__nv_bfloat16>(a, P);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
