// Single-query (decode) attention over a KV cache for Hopper (sm_90a): B3
// of the port, split over the kv axis (flash-decoding) in one launch.
//
// Replaces `_decode_grouped` of repro/kernels/decode_attention.py (the
// Pallas call at l.246) and both of its bodies, `_kernel_narrow` (the TPU
// grid) and `_kernel_wide` (the interpret-mode layout): q [B, 1, H, dh]
// against k/v [B, T, Hkv, dh] read in place (never repeated to H heads),
// per-row valid length (a [B] int32 vector, or one scalar for every row),
// optional int8 K/V with per-(row, position) f32 scales multiplied in at
// load, f32 online softmax, out [B, 1, H, dh] in q's dtype. A row with
// length 0 gives 0.
//
// Bound on the H100: the kernel reads the valid K/V rows once and does
// 4 * G * dh flops per key, far below the card's rate, so the bytes bound
// it: at q [4, 1, 16, 128] over a [4, 216, 8, 128] bf16 cache, 3.5 MB in
// 1.07 us at 3.35 TB/s. Launch and memory latency, not bandwidth, set
// its time at that size.
//
// Design, against the faults of the first version (one block per (kv
// head, row): 32 blocks on 132 SMs; lane j walking key row j one 2-byte
// element at a time, 32 lanes 2 KB apart; V keys walked one after
// another; a second launch to fill the lengths):
// - Split the kv axis. Grid (Hkv, B, n_split); the block covers the whole
//   query group of one (kv head, row), so K/V are still read once, over
//   `chunks_per_split` consecutive 32-key chunks. The wrapper's planner
//   picks n_split for about two waves of blocks (7 splits, 224 blocks at
//   the slice shape; 2 at batch 32). A split wholly past the row's length
//   returns at once: it reads and writes nothing.
// - Coalesced 16-byte loads staged with cp.async. Each 32-key chunk's K
//   and V tiles (and int8 scales) are copied 16 bytes a thread into a
//   double buffer of padded shared rows, so the next chunk is in flight
//   while this one is computed. Tiles are 32 keys of at most 512 bytes, so
//   TMA and mbarriers buy nothing here.
// - A warp per 8 keys of the chunk, no block barrier between the phases.
//   Four lanes share a key row and dot interleaved 16-byte pieces of it
//   with the G query rows (pre-scaled by log2(e) / sqrt(dh) in shared
//   memory); two shuffles finish each score, three more give the warp's
//   max and sum over its keys, and P.V runs over the warp's keys with each
//   lane owning DP / 32 output dims, p broadcast by shuffle. The four warp
//   states merge in warp order into the chunk's record. Tensor cores would
//   waste >= 8x here: the group is G = 2 rows at the slice shape and the
//   smallest mma tile has 16.
// - Head dims 32, 64 and 128 compute at their own width (DP = dh). Head
//   dims 96 and 112 compute at DP = 128: the copies bring the dh real
//   columns of each row (a whole number of 16-byte pieces in every kv
//   dtype), the columns past dh of every shared tile and of q are zeros
//   written once, so they add nothing to a score, and their P.V outputs
//   are never written to a record. The scale is 1 / sqrt(dh), the true dh.
// - The group bound is a template parameter: G <= 8 runs the instance with
//   8-entry score and accumulator arrays, 8 < G <= 16 the one with 16, so
//   a small group pays nothing for the large ones.
// - Merge in the same launch, in a fixed order. Every 32-key chunk leaves
//   its own f32 record (m, l, acc[G][dh]) in the scratch buffer; the block
//   fences, takes a ticket from its (row, kv head) counter, and the block
//   that draws the last ticket merges all chunk records in chunk order
//   (online rescale, two outputs a thread, four records' loads in flight
//   at once), writes out, and resets the counter to 0 for the next call.
//   A chunk's
//   record and the merge do not depend on how chunks are grouped into
//   splits, so the result is bitwise the same at every batch size and in
//   every call: the robust contract (identical greedy tokens whether the
//   replicas share one batch-4 pass or run as batch 32) rests on that.
//   One call is exactly one kernel launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                   // keys per chunk record
constexpr int kKeysPerWarp = kChunk / kWarps;
constexpr int kLanesPerKey = 32 / kKeysPerWarp;  // 4 lanes share a key row
constexpr int kStages = 2;                   // chunk tiles in flight
constexpr int kMaxGroup = 16;                // query heads per kv head, at most
constexpr int kMergeBatch = 4;               // records the merge loads at once
constexpr float kLog2e = 1.4426950408889634f;

template <int DH, typename TKV>
struct Cfg {
  // compute width: dh 96 and 112 run at 128 with zero columns past dh
  static constexpr int kDP = DH <= 32 ? 32 : DH <= 64 ? 64 : 128;
  static constexpr int kSrcBytes = DH * (int)sizeof(TKV);  // a row in memory
  static_assert(kSrcBytes % 16 == 0 && DH <= kDP, "16-byte row pieces");
  static constexpr int kRowBytes = kDP * (int)sizeof(TKV);  // a shared row
  static constexpr int kPitch = kRowBytes + 16;  // padded: no bank conflicts
  static constexpr int kTile = kChunk * kPitch;  // bytes of one K or V tile
  // scores: lane s of a key reads pieces s, s + 4, ... of its row
  static constexpr int kSlice = kRowBytes / kLanesPerKey;
  static constexpr int kPiece = kSlice < 16 ? kSlice : 16;
  static constexpr int kPieces = kSlice / kPiece;
  static constexpr int kEpp = kPiece / (int)sizeof(TKV);
  static constexpr int kDpl = kDP / 32;  // P.V: output dims per lane
  // dynamic shared memory: the tiles, q (f32) and the warps' partial acc
  static int smem(int G) {
    return kStages * 2 * kTile + G * kDP * 4 * (1 + kWarps);
  }
};

template <int DH, int MAXG, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lens, int len_all,
                    TQ* __restrict__ o, float* __restrict__ part,
                    int* __restrict__ tickets, int Tk, int H, int Hkv,
                    int n_chunks, int chunks_per_split, float qscale) {
  using C = Cfg<DH, TKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ksc_s[kStages][kChunk], vsc_s[kStages][kChunk];
  __shared__ float mw[kWarps][MAXG], lw[kWarps][MAXG];
  __shared__ int ticket;

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = max(0, min(lens ? lens[b] : len_all, Tk));
  const int n_act = (len + kChunk - 1) / kChunk;  // chunks with a valid key
  const int n_split = max(1, (n_act + chunks_per_split - 1) / chunks_per_split);
  if (split >= n_split) return;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_act);

  float* qs = reinterpret_cast<float*>(smem + kStages * 2 * C::kTile);
  float* accw = qs + G * C::kDP;  // [kWarps][G][DP]
  const long long row_bytes = (long long)Hkv * C::kSrcBytes;  // a position
  const char* kb = reinterpret_cast<const char*>(k)
      + (long long)b * Tk * row_bytes + (long long)kvh * C::kSrcBytes;
  const char* vb = reinterpret_cast<const char*>(v)
      + (long long)b * Tk * row_bytes + (long long)kvh * C::kSrcBytes;
  const float* ksb = k_scale ? k_scale + (long long)b * Tk : nullptr;
  const float* vsb = v_scale ? v_scale + (long long)b * Tk : nullptr;
  const int bk = b * Hkv + kvh;
  const int rec = G * (DH + 2);  // acc[G][DH], m[G], l[G]
  float* part_bk = part + (long long)bk * n_chunks * rec;

  // K and V rows (and int8 scales) of chunk c into its stage: 16 bytes a
  // copy, rows past len never read
  auto stage = [&](int c) {
    const int st = (c - c_begin) % kStages, t0 = c * kChunk;
    const int n = min(kChunk, len - t0);
    unsigned char* kt = smem + st * 2 * C::kTile;
    unsigned char* vt = kt + C::kTile;
    for (int i = tid; i < kChunk * C::kSrcBytes / 16; i += kThreads) {
      const int j = i / (C::kSrcBytes / 16), off = i % (C::kSrcBytes / 16) * 16;
      if (j < n) {
        const long long src = (long long)(t0 + j) * row_bytes + off;
        kern::cp_async16(kern::smem_addr(kt + j * C::kPitch + off), kb + src);
        kern::cp_async16(kern::smem_addr(vt + j * C::kPitch + off), vb + src);
      }
    }
    if (ksb && tid < n)
      kern::cp_async4(kern::smem_addr(&ksc_s[st][tid]), ksb + t0 + tid);
    if (vsb && tid >= 32 && tid - 32 < n)
      kern::cp_async4(kern::smem_addr(&vsc_s[st][tid - 32]), vsb + t0 + tid - 32);
  };
  if constexpr (C::kDP != DH) {
    // the columns past dh of every row of every tile: zero once (the
    // copies never write them; the first barrier orders these stores)
    constexpr int kPad = (C::kRowBytes - C::kSrcBytes) / 16;
    for (int i = tid; i < kStages * 2 * kChunk * kPad; i += kThreads)
      *reinterpret_cast<uint4*>(smem + i / kPad * C::kPitch + C::kSrcBytes
                                + i % kPad * 16) = make_uint4(0, 0, 0, 0);
  }
  for (int c = c_begin; c < c_begin + kStages; ++c) {
    if (c < c_end) stage(c);
    kern::cp_async_commit();
  }
  const TQ* qb = q + ((long long)b * H + kvh * G) * DH;
  if constexpr (C::kDP == DH) {
    for (int i = tid; i < G * DH; i += kThreads)
      qs[i] = kern::to_f32(qb[i]) * qscale;
  } else {
    for (int i = tid; i < G * C::kDP; i += kThreads) {
      const int g = i / C::kDP, d = i % C::kDP;
      qs[i] = d < DH ? kern::to_f32(qb[g * DH + d]) * qscale : 0.f;
    }
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) % kStages, t0 = c * kChunk;
    const int n = min(kChunk, len - t0);
    const unsigned char* kt = smem + st * 2 * C::kTile;
    const unsigned char* vt = kt + C::kTile;
    kern::cp_async_wait<kStages - 1>();  // chunk c is in
    __syncthreads();

    // scores: warp w takes keys 8w .. 8w + 7 of the chunk, 4 lanes a key
    const int j = warp * kKeysPerWarp + lane / kLanesPerKey;
    const int sl = lane % kLanesPerKey;
    const bool valid = j < n;
    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
    if (valid) {
#pragma unroll
      for (int pc = 0; pc < C::kPieces; ++pc) {
        const int piece = sl + kLanesPerKey * pc;
        float kf[C::kEpp];
        kern::load_vec<TKV, C::kEpp>(reinterpret_cast<const TKV*>(
            kt + j * C::kPitch + piece * C::kPiece), kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float* qg = qs + g * C::kDP + piece * C::kEpp;
#pragma unroll
          for (int e = 0; e < C::kEpp; ++e) sc[g] += qg[e] * kf[e];
        }
      }
    }
    const float kscale = ksb && valid ? ksc_s[st][j] : 1.f;
    const float vscale = vsb && valid ? vsc_s[st][j] : 1.f;
    // softmax over the warp's keys, P.V over its lanes' dims
    float acc[MAXG][C::kDpl];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float x = sc[g];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x = valid ? x * kscale : -INFINITY;
      float m = x;
#pragma unroll
      for (int off = kLanesPerKey; off < 32; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float p = valid ? exp2f(x - m) : 0.f;
      float l = p;
#pragma unroll
      for (int off = kLanesPerKey; off < 32; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      sc[g] = p * vscale;
      if (lane == 0) {
        mw[warp][g] = m;
        lw[warp][g] = l;
      }
#pragma unroll
      for (int e = 0; e < C::kDpl; ++e) acc[g][e] = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < kKeysPerWarp; ++jj) {
      if (warp * kKeysPerWarp + jj >= n) break;
      float vf[C::kDpl];
      kern::load_vec<TKV, C::kDpl>(reinterpret_cast<const TKV*>(
          vt + (warp * kKeysPerWarp + jj) * C::kPitch) + lane * C::kDpl, vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        const float pj = __shfl_sync(0xffffffffu, sc[g], jj * kLanesPerKey);
#pragma unroll
        for (int e = 0; e < C::kDpl; ++e) acc[g][e] += pj * vf[e];
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < C::kDpl; ++e)
        accw[(warp * G + g) * C::kDP + lane * C::kDpl + e] = acc[g][e];
    }
    __syncthreads();  // the stage is consumed, the warps' partials are in
    if (c + kStages < c_end) stage(c + kStages);
    kern::cp_async_commit();

    // the chunk's record: the four warps' states merged in warp order
    float* rc = part_bk + (long long)c * rec;
    for (int i = tid; i < G * DH; i += kThreads) {
      const int g = i / DH;
      const int ai = C::kDP == DH ? i : g * C::kDP + i % DH;  // i in accw
      float m = mw[0][g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, mw[w][g]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = exp2f(mw[w][g] - m);  // 0 for a warp with no key
        l += lw[w][g] * wt;
        a += accw[w * G * C::kDP + ai] * wt;
      }
      rc[i] = a;
      if (i % DH == 0) {
        rc[G * DH + g] = m;
        rc[G * DH + G + g] = l;
      }
    }
  }

  // the last of the row's splits to finish merges every chunk in order.
  // One thread releases the block's records (ordered before it by the
  // barrier), takes the ticket and acquires the other blocks' records, as
  // CUTLASS's semaphores do.
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    ticket = atomicAdd(tickets + bk, 1);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (ticket != n_split - 1) return;
  // each thread merges two outputs' chunk records in chunk order, with an
  // online rescale, the loads of kMergeBatch records in flight together
  // (from L2: the other blocks' writes are not in this SM's L1)
  TQ* ob = o + ((long long)b * H + kvh * G) * DH;
  for (int i0 = tid; i0 < G * DH; i0 += 2 * kThreads) {
    const int i1 = min(i0 + kThreads, G * DH - 1);
    const int ix[2] = {i0, i1};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
    for (int c0 = 0; c0 < n_act; c0 += kMergeBatch) {
      float mc[2][kMergeBatch], lc[2][kMergeBatch], xc[2][kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float* rc = part_bk + (long long)min(c0 + u, n_act - 1) * rec;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mc[h][u] = __ldcg(rc + G * DH + ix[h] / DH);
          lc[h][u] = __ldcg(rc + G * DH + G + ix[h] / DH);
          xc[h][u] = __ldcg(rc + ix[h]);
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (c0 + u >= n_act) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mn = fmaxf(m[h], mc[h][u]);
          const float sa = exp2f(m[h] - mn), sb = exp2f(mc[h][u] - mn);
          l[h] = l[h] * sa + lc[h][u] * sb;
          a[h] = a[h] * sa + xc[h][u] * sb;
          m[h] = mn;
        }
      }
    }
    kern::store(ob + i0, a[0] / fmaxf(l[0], 1e-30f));
    if (i0 + kThreads < G * DH) kern::store(ob + i1, a[1] / fmaxf(l[1], 1e-30f));
  }
  if (tid == 0) tickets[bk] = 0;
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* lens;
  int len_all;
  void* o;
  float* part;
  int* tickets;
  int B, Tk, H, Hkv, n_split, n_chunks, chunks_per_split;
  cudaStream_t s;
};

template <int DH, int MAXG, typename TQ, typename TKV>
int launch(const Args& a) {
  using C = Cfg<DH, TKV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<DH, MAXG, TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem(MAXG));
  if (attr != cudaSuccess) return (int)attr;
  decode_split_kernel<DH, MAXG, TQ, TKV><<<dim3(a.Hkv, a.B, a.n_split),
                                           kThreads, C::smem(a.H / a.Hkv),
                                           a.s>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.lens, a.len_all,
      static_cast<TQ*>(a.o), a.part, a.tickets, a.Tk, a.H, a.Hkv,
      a.n_chunks, a.chunks_per_split, kLog2e / sqrtf((float)DH));
  return 0;
}

constexpr int kBadArg = (int)cudaErrorInvalidValue;

// the instance with the smallest group bound that holds G
template <int DH, typename TQ, typename TKV>
int dispatch_group(const Args& a) {
  return a.H / a.Hkv <= 8 ? launch<DH, 8, TQ, TKV>(a)
                          : launch<DH, 16, TQ, TKV>(a);
}

template <typename TQ, typename TKV>
int dispatch_dh(int dh, const Args& a) {
  switch (dh) {
    case 32: return dispatch_group<32, TQ, TKV>(a);
    case 64: return dispatch_group<64, TQ, TKV>(a);
    case 96: return dispatch_group<96, TQ, TKV>(a);
    case 112: return dispatch_group<112, TQ, TKV>(a);
    case 128: return dispatch_group<128, TQ, TKV>(a);
    default: return kBadArg;
  }
}

template <typename TQ>
int dispatch_kv(int kv_dtype, int dh, const Args& a) {
  switch (kv_dtype) {
    case 0: return dispatch_dh<TQ, float>(dh, a);
    case 1: return dispatch_dh<TQ, __nv_bfloat16>(dh, a);
    case 2: return dispatch_dh<TQ, int8_t>(dh, a);
    default: return kBadArg;
  }
}

}  // namespace

extern "C" {

// dh: 32, 64, 96, 112 or 128; H / Hkv at most 16. q_dtype: 0 = float32,
// 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (then k_scale / v_scale are [B, T] f32, else
// null). lens: [B] int32 valid lengths, or null and then len_all for every
// row (both clamped to [0, T] in the kernel). part: f32 scratch of
// B * Hkv * n_chunks * G * (dh + 2) floats, n_chunks = ceil(T / 32) (at
// least 1); tickets: B * Hkv int32 counters, zero before the call and left
// zero after it. Calls that share `tickets` must be ordered on one stream.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const float* k_scale, const float* v_scale,
                         const int* lens, int len_all, void* o, float* part,
                         int* tickets, int q_dtype, int kv_dtype, int B,
                         int Tk, int H, int Hkv, int dh, int n_split,
                         int chunks_per_split, void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup || n_split < 1
      || chunks_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = Tk > 0 ? (Tk + kChunk - 1) / kChunk : 1;
  if ((long long)n_split * chunks_per_split < n_chunks)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lens, len_all, o, part, tickets,
               B, Tk, H, Hkv, n_split, n_chunks, chunks_per_split,
               static_cast<cudaStream_t>(stream)};
  const int err = q_dtype == 0 ? dispatch_kv<float>(kv_dtype, dh, a)
                              : dispatch_kv<__nv_bfloat16>(kv_dtype, dh, a);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
