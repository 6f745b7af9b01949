// Small device helpers shared by the port's kernels: loads that widen the
// storage types to f32, stores that round f32 back, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace kern {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte asynchronous copy from device to shared memory (cp.async.cg:
// cached in L2 only). With `src_bytes` 0 nothing is read and the 16
// destination bytes are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t smem_addr,
                                           const void* gmem,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy (cp.async.ca), for arrays whose rows are only
// 4-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t smem_addr,
                                          const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr), "l"(gmem) : "memory");
}

// Storage bits of one element, and their value as f32.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = float; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };
template <> struct Bits<int8_t> { using type = int8_t; };
__device__ __forceinline__ float bits_f32(float x) { return x; }
__device__ __forceinline__ float bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ float bits_f32(int8_t x) { return (float)x; }

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };
template <> struct Vec<1> { using type = unsigned char; };

// N consecutive elements at p (aligned to their total size, 1 to 16
// bytes) in one load, widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[N]) {
  using V = typename Vec<N * (int)sizeof(T)>::type;
  union {
    V v;
    typename Bits<T>::type s[N];
  } u;
  u.v = *reinterpret_cast<const V*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = bits_f32(u.s[i]);
}

}  // namespace kern
