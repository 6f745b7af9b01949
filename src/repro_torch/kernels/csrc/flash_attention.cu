// Full-sequence flash attention forward for Hopper (sm_90a): B2 of the port.
//
// Replaces `_flash_bh` / `_kernel` of repro/kernels/flash_attention.py (the
// Pallas call at l.108). q [B, S, H, dh], k/v [B, T, Hkv, dh] in their
// model layout (no transpose), out [B, S, H, dh] in q's dtype. Online
// softmax keeps (m, l, acc) in f32; the causal mask is k_pos <= q_pos with
// no offset; keys past T are never read; out = acc / max(l, 1e-30). GQA
// stays grouped: query head h reads kv head h / (H / Hkv), and K/V are
// never repeated.
//
// Design: one block per (query tile of kRows rows, batch * head). The TPU
// grid walks the kv axis sequentially and carries (m, l, acc) in VMEM
// scratch; here a loop inside the block walks the key tiles of kKeys keys,
// staged in shared memory as f32 (K with a padded row so the per-key dot
// products of a warp hit distinct banks). Each warp owns kRows / 4 query
// rows: lane j scores key j of the tile for all of the warp's rows, the
// warp reduces the tile max and sum with shuffles, and each lane
// accumulates dh / 32 output dimensions. Causal blocks stop at the last
// key their rows can see.
//
// Bound on the H100: at the prefill shapes (S = T = 192, dh = 128) the
// bytes (q, k, v read once, out written once) bound it, far below the
// tensor-core rate. This first kernel computes on the CUDA cores in f32,
// so it is compute-bound well above that bound; a wgmma/TMA version is
// later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                   // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;                   // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int H, int Hkv, int causal, float scale) {
  constexpr int kDpl = DH / 32;  // output dims per lane
  __shared__ float qs[kRows][DH];
  __shared__ float ks[kKeys][DH + 1];
  __shared__ float vs[kKeys][DH];
  __shared__ float ps[kWarps][kRowsPerWarp][kKeys];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    const int qi = q0 + r;
    const long long off = (((long long)b * S + qi) * H + h) * DH + d;
    qs[r][d] = qi < S ? kern::to_f32(q[off]) : 0.f;
  }

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[r][i] = 0.f;
  }

  // keys any row of this block can see
  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;
  for (int t0 = 0; t0 < k_end; t0 += kKeys) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int idx = threadIdx.x; idx < kKeys * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH;
      const int t = t0 + j;
      const long long off = (((long long)b * Tk + t) * Hkv + kvh) * DH + d;
      ks[j][d] = t < Tk ? kern::to_f32(k[off]) : 0.f;
      vs[j][d] = t < Tk ? kern::to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int t = t0 + lane;
    float dot[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        dot[r] += qs[warp * kRowsPerWarp + r][d] * kd;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + r;
      const bool valid = t < Tk && (!causal || t <= qi);
      const float s = valid ? dot[r] * scale : kNegInf;
      const float m_new = fmaxf(m_r[r], kern::warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + kern::warp_sum(p);
      m_r[r] = m_new;
      ps[warp][r][lane] = p;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int i = 0; i < kDpl; ++i) {
        const float vd = vs[j][lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][i] += ps[warp][r][j] * vd;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    T* orow = o + (((long long)b * S + qi) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      kern::store(orow + lane + 32 * i, acc[r][i] * inv);
  }
}

template <int DH, typename T>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int Tk, int H, int Hkv, int causal, cudaStream_t s) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<DH, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, Hkv, causal,
      1.0f / sqrtf((float)DH));
}

template <typename T>
bool dispatch(int dh, const void* q, const void* k, const void* v, void* o,
              int B, int S, int Tk, int H, int Hkv, int causal,
              cudaStream_t s) {
  switch (dh) {
    case 32: launch<32, T>(q, k, v, o, B, S, Tk, H, Hkv, causal, s); return true;
    case 64: launch<64, T>(q, k, v, o, B, S, Tk, H, Hkv, causal, s); return true;
    case 128: launch<128, T>(q, k, v, o, B, S, Tk, H, Hkv, causal, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int Tk, int H, int Hkv,
                        int dh, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == 0
      ? dispatch<float>(dh, q, k, v, o, B, S, Tk, H, Hkv, causal, s)
      : dispatch<__nv_bfloat16>(dh, q, k, v, o, B, S, Tk, H, Hkv, causal, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
