// Customized elementwise kernels for the NVIDIA H100 (sm_90a):
// vtanh, vsigmoid, vsqrt and vrelu.
//
// Replaces the Pallas kernels of src/repro/kernels/elementwise.py:
// vtanh (:156), vsigmoid (:161), vsqrt (:166) and vrelu (:171), all four
// launched through _elementwise_call (:129), which packs any shape into
// (rows, 128) tiles, pads the tail and slices it off again.
//
// Bound on this card: each kernel reads n elements once and writes n
// once, with at most ~30 fp32 operations per element.  At 3.35 TB/s of
// HBM against 67 TFLOP/s of fp32 outside the tensor cores, bytes bound
// it: 8n bytes / 3.35e12 s for fp32 and 4n bytes for bf16.
//
// Design for that bound: one pass over the flat tensor, no padding and
// no copy (the tail is masked by the loop bound rather than padded as
// on the TPU), each element loaded once and its result stored once.  Each
// thread moves 16 bytes (4 fp32 or 8 bf16) in one vector load and one
// vector store; neighbouring threads touch neighbouring 16-byte chunks,
// so each warp's access is one coalesced 512-byte run.  The grid has one
// thread per chunk, so every thread makes one step and the card's block
// scheduler balances the SMs (a grid capped at the resident size, each
// thread looping, measured 5-14% slower).  The loop, with an int64
// index, only covers an n beyond the grid's limit.  The math
// stays in fp32 registers; bf16 is converted on load and rounded to
// nearest even on store.
//
// Numerics follow the plain torch version step by step, so that the two
// agree on the card to a few fp32 ulps:
//   * __fmul_rn / __fadd_rn / __fsub_rn round after every operation, as
//     the op-by-op plain version does, and keep nvcc from contracting a
//     multiply and an add into one FMA;
//   * division is IEEE (__fdiv_rn); the build passes no --use_fast_math
//     and no -ftz, so subnormals are kept;
//   * rintf rounds half to even, like jnp.round and torch.round;
//   * 2^n is assembled in the exponent bits, valid only because the
//     inputs are clipped first (|x| <= 20 for tanh, |x| <= 30 for
//     sigmoid, so n >= -58 and the biased exponent stays positive);
//   * the clamps are comparisons, which let NaN through, as jnp.clip
//     does; fminf/fmaxf would drop a NaN operand.
#include "common.cuh"

namespace {

using repro_cuda::Elem;
using repro_cuda::clip;

constexpr int kThreads = 256;

// Constants are written as doubles and rounded to float, as Python floats
// are when they meet a float32 tensor.
__device__ __forceinline__ float c(double v) { return static_cast<float>(v); }

// 2^f for f in [-0.5, 0.5]: the degree-5 polynomial of _exp2_poly (:44)
__device__ __forceinline__ float exp2_poly(float f) {
  float p = c(0.0013333558146428443);
  p = __fadd_rn(__fmul_rn(p, f), c(0.009618129107628477));
  p = __fadd_rn(__fmul_rn(p, f), c(0.05550410866482158));
  p = __fadd_rn(__fmul_rn(p, f), c(0.24022650695910072));
  p = __fadd_rn(__fmul_rn(p, f), c(0.6931471805599453));
  p = __fadd_rn(__fmul_rn(p, f), c(1.0));
  return p;
}

// exp(x) = 2^n * 2^f by range reduction, 2^n built in the exponent bits
// (_exp, :54)
__device__ __forceinline__ float exp_reduced(float x) {
  float y = __fmul_rn(x, c(1.4426950408889634));
  float n = rintf(y);
  float f = __fsub_rn(y, n);
  unsigned biased = static_cast<unsigned>(static_cast<int>(n) + 127);
  float two_n = __int_as_float(static_cast<int>(biased << 23));
  return __fmul_rn(exp2_poly(f), two_n);
}

// jnp.sign: +-1, and x itself for +-0 and NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

struct Tanh {  // vtanh_math (:73)
  __device__ float operator()(float x) const {
    float t = clip(fabsf(x), 0.0f, 20.0f);
    float z = exp_reduced(__fmul_rn(c(-2.0), t));
    float th = __fdiv_rn(__fsub_rn(1.0f, z), __fadd_rn(1.0f, z));
    return __fmul_rn(sign_of(x), th);
  }
};

struct Sigmoid {  // vsigmoid_math (:80)
  __device__ float operator()(float x) const {
    float t = clip(x, -30.0f, 30.0f);
    float z = exp_reduced(-fabsf(t));
    float den = __fadd_rn(1.0f, z);
    float r = __fdiv_rn(1.0f, den);
    r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));  // one Newton step
    float zr = __fmul_rn(z, r);
    return t >= 0.0f ? __fsub_rn(1.0f, zr) : zr;
  }
};

struct Sqrt {  // vsqrt_math (:91)
  __device__ float operator()(float x) const {
    float y = rsqrtf(x);  // approximate seed, refined by two Newton steps
    for (int k = 0; k < 2; ++k) {
      float xyy = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, x), y), y);
      y = __fmul_rn(y, __fsub_rn(1.5f, xyy));
    }
    float s = __fmul_rn(x, y);
    s = x == 0.0f ? 0.0f : s;              // first 0 -> 0 (rsqrt(0) = inf)
    return isinf(x) ? __int_as_float(0x7f800000) : s;  // then +-inf -> inf
  }
};

// vrelu_math (:100).  The result is x or a bound; stored to bf16 it is x or
// the bound rounded to bf16, as the reference's clamp in x's own dtype.
struct Relu {
  float lo, hi;
  __device__ float operator()(float x) const { return clip(x, lo, hi); }
};

// V elements per thread and step: 16 bytes (4 fp32 or 8 bf16) in one
// vector load and one vector store when both pointers are 16-byte aligned,
// else V = 1.  The n % V elements after the last whole vector form the
// tail, done one by one.
template <typename T, int V, typename F>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const typename Elem<T>::Raw* __restrict__ x,
                   typename Elem<T>::Raw* __restrict__ y, int64_t n, F f) {
  using E = Elem<T>;
  using Raw = typename E::Raw;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t whole = V > 1 ? n / V : 0;  // whole vectors; V = 1: none
  if constexpr (V > 1) {
    static_assert(V * sizeof(Raw) == sizeof(uint4), "one 16-byte vector");
    union Pack { uint4 v; Raw e[V]; };
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (int64_t c = tid; c < whole; c += stride) {
      Pack in, out;
      in.v = xv[c];
#pragma unroll
      for (int k = 0; k < V; ++k) out.e[k] = E::put(f(E::get(in.e[k])));
      yv[c] = out.v;
    }
  }
  for (int64_t i = whole * V + tid; i < n; i += stride) {
    y[i] = E::put(f(E::get(x[i])));
  }
}

template <typename T, typename F>
int launch(const void* x, void* y, int64_t n, F f, void* stream) {
  using Raw = typename Elem<T>::Raw;
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(Raw));
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
       sizeof(uint4)) == 0;
  const int64_t per_thread = aligned ? kVec : 1;
  const unsigned blocks =
      repro_cuda::blocks_for((n + per_thread - 1) / per_thread, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Raw* xr = static_cast<const Raw*>(x);
  Raw* yr = static_cast<Raw*>(y);
  if (aligned)
    elementwise_kernel<T, kVec, F><<<blocks, kThreads, 0, s>>>(xr, yr, n, f);
  else
    elementwise_kernel<T, 1, F><<<blocks, kThreads, 0, s>>>(xr, yr, n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: pointers and the
// stream as void*, n as int64.  Each returns cudaGetLastError() after its
// launch (0 = launched).
extern "C" {

int repro_vtanh_f32(const void* x, void* y, int64_t n, void* s) {
  return launch<float>(x, y, n, Tanh{}, s);
}
int repro_vtanh_bf16(const void* x, void* y, int64_t n, void* s) {
  return launch<__nv_bfloat16>(x, y, n, Tanh{}, s);
}
int repro_vsigmoid_f32(const void* x, void* y, int64_t n, void* s) {
  return launch<float>(x, y, n, Sigmoid{}, s);
}
int repro_vsigmoid_bf16(const void* x, void* y, int64_t n, void* s) {
  return launch<__nv_bfloat16>(x, y, n, Sigmoid{}, s);
}
int repro_vsqrt_f32(const void* x, void* y, int64_t n, void* s) {
  return launch<float>(x, y, n, Sqrt{}, s);
}
int repro_vsqrt_bf16(const void* x, void* y, int64_t n, void* s) {
  return launch<__nv_bfloat16>(x, y, n, Sqrt{}, s);
}
int repro_vrelu_f32(const void* x, void* y, int64_t n, float lo, float hi,
                    void* s) {
  return launch<float>(x, y, n, Relu{lo, hi}, s);
}
int repro_vrelu_bf16(const void* x, void* y, int64_t n, float lo, float hi,
                     void* s) {
  return launch<__nv_bfloat16>(x, y, n, Relu{lo, hi}, s);
}

}  // extern "C"
