// Single-query (decode) attention over a KV cache for Hopper (sm_90a): B3
// of the port.
//
// Replaces `_decode_grouped` of repro/kernels/decode_attention.py (the
// Pallas call at l.246) and both of its bodies, `_kernel_narrow` (the TPU
// grid) and `_kernel_wide` (the interpret-mode layout): q [B, 1, H, dh]
// against k/v [B, T, Hkv, dh] read in place (never repeated to H heads),
// per-row valid length lens[b] (already clamped to T), optional int8 K/V
// with per-(row, position) f32 scales multiplied in at load, f32 online
// softmax, out [B, 1, H, dh] in q's dtype.
//
// Design: one block per (kv head, batch row) covering all G = H / Hkv
// query rows of the group, so each K/V row is read once for the whole
// group. The TPU walks the kv axis on a sequential grid dimension; here
// the block's four warps take 32-key chunks in turn (warp w: chunks w,
// w + 4, ...). Lane j scores key j of a chunk for all G rows (q pre-scaled
// by 1/sqrt(dh) in shared memory, as the TPU kernel scales q before the
// dot), the warp reduces max and sum with shuffles, and each lane
// accumulates dh / 32 output dimensions, reading V rows coalesced. Chunks
// past lens[b] are never read. At the end the four warps' (m, l, acc)
// states merge through shared memory. A row with lens[b] == 0 returns 0.
//
// Bound on the H100: decode attention reads the valid K/V rows once and
// does 4 * G * dh flops per key, far below the card's rate: it is bound by
// memory bandwidth. With B * Hkv blocks (32 at B = 4, Hkv = 8) it fills
// only part of the card's 132 SMs; splitting T across blocks
// (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;  // query heads per kv head
constexpr float kNegInf = -1e30f;

template <int DH, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ lens,
              TQ* __restrict__ o, int Tk, int H, int Hkv, float scale) {
  constexpr int kDpl = DH / 32;
  __shared__ float qs[kMaxGroup][DH];
  __shared__ float ps[kWarps][kMaxGroup][32];
  __shared__ float m_w[kWarps][kMaxGroup];
  __shared__ float l_w[kWarps][kMaxGroup];
  __shared__ float acc_w[kWarps][kMaxGroup][DH];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lens[b];

  for (int idx = threadIdx.x; idx < G * DH; idx += kThreads) {
    const int g = idx / DH, d = idx % DH;
    const long long off = ((long long)b * H + kvh * G + g) * DH + d;
    qs[g][d] = kern::to_f32(q[off]) * scale;
  }
  __syncthreads();

  float m_g[kMaxGroup], l_g[kMaxGroup], acc[kMaxGroup][kDpl];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m_g[g] = kNegInf;
    l_g[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[g][i] = 0.f;
  }

  const long long row_stride = (long long)Hkv * DH;  // one position
  const TKV* kb = k + (long long)b * Tk * row_stride + (long long)kvh * DH;
  const TKV* vb = v + (long long)b * Tk * row_stride + (long long)kvh * DH;
  const float* ksb = k_scale ? k_scale + (long long)b * Tk : nullptr;
  const float* vsb = v_scale ? v_scale + (long long)b * Tk : nullptr;

  for (int t0 = warp * 32; t0 < len; t0 += kWarps * 32) {
    const int t = t0 + lane;
    const bool valid = t < len;
    float dot[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) dot[g] = 0.f;
    if (valid) {
      const TKV* krow = kb + (long long)t * row_stride;
      const float kscale = ksb ? ksb[t] : 1.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kd = kern::to_f32(krow[d]) * kscale;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) dot[g] += qs[g][d] * kd;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= G) break;
      const float s = valid ? dot[g] : kNegInf;
      const float m_new = fmaxf(m_g[g], kern::warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_g[g] - m_new);
      l_g[g] = l_g[g] * alpha + kern::warp_sum(p);
      m_g[g] = m_new;
      ps[warp][g][lane] = p;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[g][i] *= alpha;
    }
    __syncwarp();
    const int n = min(32, len - t0);
    for (int j = 0; j < n; ++j) {
      const TKV* vrow = vb + (long long)(t0 + j) * row_stride;
      const float vscale = vsb ? vsb[t0 + j] : 1.f;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) {
        const float vd = kern::to_f32(vrow[lane + 32 * i]) * vscale;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g][i] += ps[warp][g][j] * vd;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_w[warp][g] = m_g[g];
      l_w[warp][g] = l_g[g];
    }
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc_w[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += kThreads) {
    const int g = idx / DH, d = idx % DH;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_w[w][g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = l_w[w][g] > 0.f ? expf(m_w[w][g] - m) : 0.f;
      l += l_w[w][g] * c;
      a += acc_w[w][g][d] * c;
    }
    kern::store(o + ((long long)b * H + kvh * G + g) * DH + d,
                a / fmaxf(l, 1e-30f));
  }
}

template <int DH, typename TQ, typename TKV>
void launch(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, const int* lens, void* o, int B, int Tk, int H,
            int Hkv, cudaStream_t s) {
  decode_kernel<DH, TQ, TKV><<<dim3(Hkv, B), kThreads, 0, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, lens, static_cast<TQ*>(o), Tk, H,
      Hkv, 1.0f / sqrtf((float)DH));
}

template <typename TQ, typename TKV>
bool dispatch_dh(int dh, const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* lens, void* o,
                 int B, int Tk, int H, int Hkv, cudaStream_t s) {
  switch (dh) {
    case 32: launch<32, TQ, TKV>(q, k, v, ks, vs, lens, o, B, Tk, H, Hkv, s); return true;
    case 64: launch<64, TQ, TKV>(q, k, v, ks, vs, lens, o, B, Tk, H, Hkv, s); return true;
    case 128: launch<128, TQ, TKV>(q, k, v, ks, vs, lens, o, B, Tk, H, Hkv, s); return true;
    default: return false;
  }
}

template <typename TQ>
bool dispatch_kv(int kv_dtype, int dh, const void* q, const void* k,
                 const void* v, const float* ks, const float* vs,
                 const int* lens, void* o, int B, int Tk, int H, int Hkv,
                 cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return dispatch_dh<TQ, float>(dh, q, k, v, ks, vs, lens, o, B, Tk, H, Hkv, s);
    case 1: return dispatch_dh<TQ, __nv_bfloat16>(dh, q, k, v, ks, vs, lens, o, B, Tk, H, Hkv, s);
    case 2: return dispatch_dh<TQ, int8_t>(dh, q, k, v, ks, vs, lens, o, B, Tk, H, Hkv, s);
    default: return false;
  }
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then k_scale / v_scale are [B, T] f32, else
// null). lens: [B] int32 valid lengths, each <= T.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const float* k_scale, const float* v_scale,
                         const int* lens, void* o, int q_dtype, int kv_dtype,
                         int B, int Tk, int H, int Hkv, int dh,
                         void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = q_dtype == 0
      ? dispatch_kv<float>(kv_dtype, dh, q, k, v, k_scale, v_scale, lens, o, B, Tk, H, Hkv, s)
      : dispatch_kv<__nv_bfloat16>(kv_dtype, dh, q, k, v, k_scale, v_scale, lens, o, B, Tk, H, Hkv, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
