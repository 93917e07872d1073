// Shared by the port's kernel sources: element access for fp32 and bf16,
// 16-byte vectors of either (Vec, and Elems for one element or one
// vector at a time), the NaN-propagating clamp, the launch helpers, and
// the 16-byte alignment and shared-memory address helpers.
//
// Build flags (kernels/_build.py) carry no --use_fast_math and no -ftz:
// the kernels need IEEE rounding and keep subnormals.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// 16 bytes, kept raw in registers until used: 8 bf16 or 4 fp32 elements.
// ldg reads an aligned vector, gather the first `valid` elements one by
// one (zeros after), cvt widens to fp32, pack rounds fp32 back to T.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ uint4 ldg(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 gather(const float* p, int valid) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = i < valid ? __float_as_uint(p[i]) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void cvt(uint4 u, float (&o)[V]) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&o)[V]) {
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                      __float_as_uint(o[2]), __float_as_uint(o[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ uint4 ldg(const unsigned short* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 gather(const unsigned short* p,
                                                 int valid) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < valid ? unsigned(p[2 * i]) : 0u) |
             (2 * i + 1 < valid ? unsigned(p[2 * i + 1]) << 16 : 0u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void cvt(uint4 u, float (&o)[V]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // bf16 -> fp32 is exact: shift
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&o)[V]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)          // each rounded to nearest even
      w[i] = Elem<__nv_bfloat16>::put(o[2 * i]) |
             unsigned(Elem<__nv_bfloat16>::put(o[2 * i + 1])) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// V consecutive elements of T at a time: one 16-byte Vec where V is
// Vec<T>::V (the pointer then 16-byte aligned), else (V = 1) one element.
// ld keeps them raw (Bits) so that a thread can issue all of its loads
// before it uses any; cvt widens them to fp32; st rounds V fp32 values to
// T and stores them; st_cs does so with the streaming hint (evict first),
// for an output that should not push inputs out of L2.
template <typename T, int V>
struct Elems {
  using Raw = typename Elem<T>::Raw;
  static_assert(V == 1 || V == Vec<T>::V, "one element or one 16-byte vector");
  using Bits = typename std::conditional<V == 1, Raw, uint4>::type;
  static __device__ __forceinline__ Bits ld(const Raw* p) {
    if constexpr (V == 1) return __ldg(p);
    else return Vec<T>::ldg(p);
  }
  static __device__ __forceinline__ void cvt(Bits b, float (&o)[V]) {
    if constexpr (V == 1) o[0] = Elem<T>::get(b);
    else Vec<T>::cvt(b, o);
  }
  static __device__ __forceinline__ void st(Raw* p, const float (&o)[V]) {
    if constexpr (V == 1) *p = Elem<T>::put(o[0]);
    else *reinterpret_cast<uint4*>(p) = Vec<T>::pack(o);
  }
  static __device__ __forceinline__ void st_cs(Raw* p, const float (&o)[V]) {
    if constexpr (V == 1) __stcs(p, Elem<T>::put(o[0]));
    else __stcs(reinterpret_cast<uint4*>(p), Vec<T>::pack(o));
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
