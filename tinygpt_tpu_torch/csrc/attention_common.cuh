// Shared helpers of the attention kernels: element types, vector loads
// converted to float, the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tg {

// Same finite "minus infinity" as the JAX kernels: exp(m_prev - m_new) stays
// finite (never exp(-inf + inf) = NaN) while a row has seen no visible slot.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers (ops/attention_kernels.py);
// kE4M3 is a KV cache or pool type only (q and the output keep theirs)
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kE4M3 = 3 };

using e4m3 = __nv_fp8_e4m3;

// The in-flight K/V type beside a frozen cache of type C when q is T: T
// itself, or bf16 beside an e4m3 cache (the JAX package keeps the newest
// tokens in bf16 until they are merged into an fp8 cache).
template <typename T, typename C>
struct Inflight {
  using type = T;
};
template <typename T>
struct Inflight<T, e4m3> {
  using type = __nv_bfloat16;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// e4m3 decodes exactly through the card's conversion (0x7F, never written by
// the port, decodes as the conversion gives it: NaN)
__device__ __forceinline__ float to_f32(e4m3 x) { return static_cast<float>(x); }

// N elements of E at p (N * sizeof(E) = 4, 8 or 16 bytes, aligned to that),
// read through the read-only path into the low bytes of a uint4.
template <typename E, int N>
__device__ __forceinline__ uint4 load_raw(const E* p) {
  constexpr int BYTES = N * static_cast<int>(sizeof(E));
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "4, 8 or 16 bytes a load");
  if constexpr (BYTES == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (BYTES == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(r.x, r.y, 0u, 0u);
  } else {
    return make_uint4(__ldg(reinterpret_cast<const unsigned int*>(p)), 0u, 0u, 0u);
  }
}

// The N elements of E in the low bytes of `raw`, as floats.
template <typename E, int N>
__device__ __forceinline__ void raw_to_float(const uint4& raw, float* f) {
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
}

// Elements per 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// Sets the dynamic shared memory a kernel may use, once per kernel. Above
// 48 KB the launch is refused unless this attribute allows it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Query heads one block of the one-token decode kernels (K2, K8, K9, K13) holds:
// the largest divisor of G = Nq / Nk that is at most kMaxGroupTile. A KV
// head with more query heads (G = 16: Llama-3.1-405B's 128 over 8) is
// served by G / GT blocks, each reading the head's K/V rows once (the later
// reads mostly from L2), so that a thread's registers (GT query rows and GT
// accumulators of D / 8 values) stay those of G <= 8 and no instantiation
// is added.
constexpr int kMaxGroupTile = 8;

inline int group_tile(int G) {
  for (int gt = kMaxGroupTile; gt > 1; --gt)
    if (G % gt == 0) return gt;
  return 1;
}

}  // namespace tg
