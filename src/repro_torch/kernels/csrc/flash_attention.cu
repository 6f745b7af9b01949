// Full-sequence flash attention forward for Hopper (sm_90a): B2 of the port.
//
// Replaces `_flash_bh` / `_kernel` of repro/kernels/flash_attention.py (the
// Pallas call at l.108). q [B, S, H, dh], k/v [B, T, Hkv, dh] in their
// model layout (no transpose), out [B, S, H, dh] in q's dtype. Online
// softmax keeps (m, l, acc) in f32; the causal mask is k_pos <= q_pos with
// no offset; keys past T are never used; out = acc / max(l, 1e-30). GQA
// stays grouped: query head h reads kv head h / (H / Hkv), and K/V are
// never repeated.
//
// Bound on the H100: at the prefill shape (q [4, 192, 16, 128], k/v
// [4, 192, 8, 128] bf16, causal) the bytes (q, k, v read once, out written
// once: 9.4 MB) take 2.8 us at 3.35 TB/s and the 0.6 GFLOP of the two
// products 0.6 us on the bf16 tensor cores: the bytes bound it.
//
// bf16 design (flash_fwd_wgmma): one warpgroup (128 threads) per 64-row
// query tile of one (b, h), the longest causal tiles dispatched first
// (blockIdx.y counts tiles from the last). The TPU grid walks the kv axis
// in order and carries (m, l, acc) in VMEM scratch; here a loop inside the
// block walks 64-key tiles:
// - S = Q.K^T on the tensor cores, wgmma m64n64k16 (dh / 16 k-steps) with
//   Q and the K tile in shared memory in wgmma's 128-byte-swizzled
//   K-major layout (ceil(dh / 64) 64-column panels of 64 rows x 128
//   bytes; the columns of the last panel past dh, at dh 32, 96 and 112,
//   are zeros written once and never copied over), addressed by wgmma
//   descriptors.
// - Online softmax on the f32 accumulator fragment: each thread holds two
//   rows of its warp's 16 and reduces max and sum over the quad that
//   shares them. The diagonal tile and the rows and keys past S and T are
//   masked; tiles past the diagonal are never loaded.
// - O += P.V on the tensor cores: P rounded to bf16 in registers is
//   wgmma's register A operand (the accumulator fragment of S is already
//   A's layout), V (64 keys x dh) the shared-memory B operand read
//   MN-major through the descriptor's transpose bit, 64 output columns a
//   panel (a padded panel's zero columns give zeros that are not
//   stored). O stays in f32 registers (64 a thread at dh 96 to 128).
// - The softmax scale is 1 / sqrt(dh), the true dh, at every width.
// - K/V tiles are double-buffered in dynamic shared memory and filled by
//   16-byte cp.async (zero-filled past T), the next tile's copy in flight
//   while this one is computed: Q 16 KB + 2 stages x (K + V) 64 KB at
//   dh 128.
// Rounding P to bf16 adds at most 2^-9 relative per weight, as in every
// bf16 flash kernel.
//
// f32 design (flash_fwd_f32, the first version, kept for f32 inputs): one
// block per (16-query tile, batch * head), 32-key tiles staged in shared
// memory as f32 (K with a padded row so the per-key dot products of a warp
// hit distinct banks); each warp owns 4 query rows, lane j scores key j
// for all of them, and each lane accumulates ceil(dh / 32) output
// dimensions on the CUDA cores (at dh 112 the last one only on lanes 0-15:
// the V columns past dh are left unset and their sums are never stored).
// Causal blocks stop at the last key their rows can see.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                   // query rows per f32 block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;                   // keys per f32 tile (one per lane)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int Tk, int H, int Hkv, int causal, float scale) {
  using T = float;
  constexpr int kDpl = (DH + 31) / 32;  // output dims per lane
  __shared__ float qs[kRows][DH];
  __shared__ float ks[kKeys][DH + 1];
  __shared__ float vs[kKeys][kDpl * 32];
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
      if (DH % 32 == 0 || lane + 32 * i < DH)
        kern::store(orow + lane + 32 * i, acc[r][i] * inv);
  }
}

// ---- bf16: wgmma ----------------------------------------------------------

namespace wg {

constexpr int kRows = 64;            // query rows per block (wgmma M)
constexpr int kKeys = 64;            // keys per tile (N of Q.K^T, K of P.V)
constexpr int kPanel = 64 * 128;     // bytes of a 64-row x 64-column panel

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// address and byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)(lbo >> 4) << 16)
       | ((uint64_t)(sbo >> 4) << 32)
       | (1ull << 62);
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled
// panel (rows 128 bytes apart; chunk c lands at c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A.B, A and B from shared memory, both K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, A (bf16 pairs) from registers, B from shared memory MN-major.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int DH>
struct Shape {
  static constexpr int kPanels = (DH + 63) / 64;  // the last one padded
  static constexpr int kTile = kPanels * kPanel;         // 64 rows, bytes
  static constexpr int kSmem = 5 * kTile + 1024;  // Q, 2 x (K, V), align
};

template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int Tk, int H, int Hkv,
                int causal, float scale_log2) {
  constexpr int kPanels = Shape<DH>::kPanels;
  constexpr int kTile = Shape<DH>::kTile;
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = kern::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t sQ = base, sK = base + kTile, sV = base + 3 * kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int tq = lane % 4;

  if (DH % 64 != 0) {  // zero the padded columns once; no copy writes them
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (base - raw));
    for (int i = tid; i < 5 * kTile / 16; i += 128) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  const long long q_stride = (long long)H * DH, kv_stride = (long long)Hkv * DH;
  const __nv_bfloat16* qb = q + ((long long)b * S * H + h) * DH;
  const __nv_bfloat16* kb = k + ((long long)b * Tk * Hkv + kvh) * DH;
  const __nv_bfloat16* vb = v + ((long long)b * Tk * Hkv + kvh) * DH;
  // rows [r0, r0 + 64) of a [rows, stride] operand into a swizzled tile;
  // rows past `rows` are zero-filled
  auto load_tile = [&](uint32_t dst, const __nv_bfloat16* src,
                       long long stride, int r0, int rows) {
    for (int i = tid; i < kRows * kChunks; i += 128) {
      const int r = i / kChunks, c = i % kChunks;
      const bool in = r0 + r < rows;
      kern::cp_async16(dst + (c / 8) * kPanel + swz(r, c % 8),
                       src + (in ? (long long)(r0 + r) * stride : 0) + c * 8,
                       in ? 16 : 0);
    }
  };

  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  load_tile(sQ, qb, q_stride, q0, S);
  load_tile(sK, kb, kv_stride, 0, Tk);
  load_tile(sV, vb, kv_stride, 0, Tk);
  kern::cp_async_commit();

  float acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (st ^ 1) * kTile, kb, kv_stride, (j + 1) * kKeys, Tk);
      load_tile(sV + (st ^ 1) * kTile, vb, kv_stride, (j + 1) * kKeys, Tk);
    }
    kern::cp_async_commit();
    kern::cp_async_wait<1>();  // tile j (and Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q.K^T: 64 rows x 64 keys in f32
    const uint32_t kt = sK + st * kTile, vt = sV + st * kTile;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {  // zero columns past dh skipped
      const uint32_t off = (kk / 4) * kPanel + (kk % 4) * 32;
      mma_ss(s, desc(sQ + off, 16, 1024), desc(kt + off, 16, 1024), kk > 0);
    }
    commit();
    wait_all();
    pin(s);

    // online softmax (base 2) on the fragment: s[i] is row (i & 2 ? row1 :
    // row0), key t0 + 8 * (i / 4) + 2 * tq + (i & 1)
    const int t0 = j * kKeys;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = t0 + 8 * (i / 4) + 2 * tq + (i & 1);
      const int row = (i & 2) ? row1 : row0;
      const bool ok = key < Tk && (!causal || key <= row);
      s[i] = ok ? s[i] * scale_log2 : -INFINITY;
      if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float u0 = n0 == -INFINITY ? 0.f : n0;  // fully masked so far
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - ((i & 2) ? u1 : u0));
      if (i & 2) sum1 += s[i]; else sum0 += s[i];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    // P in bf16, in the register layout of wgmma's A operand: k-step kk
    // takes keys 16 kk .. 16 kk + 15, which are s[8 kk .. 8 kk + 7]
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= (i & 2) ? a1 : a0;

    // O += P.V: V tile rows are keys (K), columns dh (N), MN-major
    fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        mma_rs(acc[p], pa[kk], desc(vt + p * kPanel + kk * 2048, kPanel, 1024));
    commit();
    wait_all();
#pragma unroll
    for (int p = 0; p < kPanels; ++p) pin(acc[p]);
    __syncthreads();  // stage st is free for tile j + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? row1 : row0;
      const int col = p * 64 + 8 * (i / 4) + 2 * tq;
      const float inv = (i & 2) ? inv1 : inv0;
      if (row < S && col < DH)
        *reinterpret_cast<__nv_bfloat162*>(
            o + (((long long)b * S + row) * H + h) * DH + col) =
            __floats2bfloat162_rn(acc[p][i] * inv, acc[p][i + 1] * inv);
    }
}

}  // namespace wg

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int dtype,
           int B, int S, int Tk, int H, int Hkv, int causal, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid((S + kRows - 1) / kRows, B * H);
    flash_fwd_f32<DH><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, Hkv,
        causal, 1.0f / sqrtf((float)DH));
    return 0;
  }
  constexpr int kSmem = wg::Shape<DH>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg::flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (S + wg::kRows - 1) / wg::kRows);
  wg::flash_fwd_wgmma<DH><<<grid, 128, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Tk, H, Hkv, causal, kLog2e / sqrtf((float)DH));
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (wgmma body); q, k,
// v and out alike. dh: 32, 64, 96, 112 or 128.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int Tk, int H, int Hkv,
                        int dh, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  int err;
  switch (dh) {
    case 32: err = launch<32>(q, k, v, o, dtype, B, S, Tk, H, Hkv, causal, s); break;
    case 64: err = launch<64>(q, k, v, o, dtype, B, S, Tk, H, Hkv, causal, s); break;
    case 96: err = launch<96>(q, k, v, o, dtype, B, S, Tk, H, Hkv, causal, s); break;
    case 112: err = launch<112>(q, k, v, o, dtype, B, S, Tk, H, Hkv, causal, s); break;
    case 128: err = launch<128>(q, k, v, o, dtype, B, S, Tk, H, Hkv, causal, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
