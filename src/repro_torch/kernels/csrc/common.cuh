// Shared by the port's kernel sources: element access for fp32 and bf16,
// the NaN-propagating clamp, the launch helpers, and the 16-byte alignment
// and shared-memory address helpers.
//
// Build flags (kernels/_build.py) carry no --use_fast_math and no -ftz:
// the kernels need IEEE rounding and keep subnormals.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_cuda {

constexpr int64_t kMaxBlocks = 2147483647;  // gridDim.x limit

// Element access by raw bits: fp32 as float, bf16 as its 16-bit pattern,
// converted on load and rounded to nearest even on store.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using Raw = float;
  static __device__ __forceinline__ float get(Raw r) { return r; }
  static __device__ __forceinline__ Raw put(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float get(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ Raw put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// clamp(v, lo, hi) = min(max(v, lo), hi); a NaN fails both tests and stays,
// as through jnp.clip (fminf/fmaxf would drop it)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Blocks of `threads` for one thread per item, capped at the grid's limit
// (a kernel loops over items past the cap).
inline unsigned blocks_for(int64_t items, int threads) {
  const int64_t need = (items + threads - 1) / threads;
  return static_cast<unsigned>(need < kMaxBlocks ? need : kMaxBlocks);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The shared-memory address of a generic pointer, for PTX operands
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace repro_cuda
