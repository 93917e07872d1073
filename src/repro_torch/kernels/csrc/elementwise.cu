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
// on the TPU), each element loaded once and its result stored once, in
// 16-byte vectors (4 fp32 or 8 bf16); neighbouring threads touch
// neighbouring vectors, so each warp's access is one coalesced 512-byte
// run.  The first design (one vector a thread: load, all of its math,
// store; 256-thread blocks with no register bound) held vrelu at 88% of
// the bound but left fp32 vsigmoid and vsqrt 3-5% short of it, and bf16
// vtanh and vsigmoid 11-15% behind torch.  Now:
//   * __launch_bounds__ asks for 8 blocks of 256 threads an SM, which
//     caps registers at 32 and keeps every thread slot busy: fp32 at one
//     vector a thread then matches or beats torch for all four;
//   * a bf16 thread of a large tensor takes two vectors and issues both
//     loads before any math (8 elements of math per 16 bytes is twice
//     fp32's), in 4 blocks an SM so the second vector does not spill;
//   * a small tensor, such as a decode step's 32768 bf16 elements, runs
//     in blocks as small as 32 threads, so that its grid spreads over the
//     SMs and not over 16 of them;
//   * streaming hints (__ldcs / __stcs) measured 1-3% slower and are not
//     used.
// The launch shape is computed in kernels/elementwise.py (plan).  The
// math stays in fp32 registers; bf16 is converted on load and rounded to
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
// Blocks an SM must hold: eight of 256 threads fill its 2048 thread slots
// (32 registers a thread).  Two vectors a thread need more registers than
// that (bf16 vsqrt spilled under the cap), so they ask for four.
template <int U> constexpr int kMinBlocks = U == 1 ? 8 : 4;

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

// One thread takes U vectors of V elements: 16 bytes each (4 fp32 or 8
// bf16) when both pointers are 16-byte aligned, else V = 1.  A block
// covers U * blockDim.x consecutive vectors, and vector k of a thread is
// k * blockDim.x + threadIdx.x of them, so each load instruction of a warp
// is one coalesced 512-byte run and a block's runs are adjacent.  All U
// loads are issued before any math, so the IEEE division and Newton
// steps of one vector run while the next one is still in flight; the
// stores follow the math.  The n % V elements after the last whole vector
// form the tail, done one by one.  With a grid past its limit
// (blocks_for caps it) the blocks loop.
template <typename T, int V, int U, typename F>
__global__ void __launch_bounds__(kThreads, kMinBlocks<U>)
elementwise_kernel(const typename Elem<T>::Raw* __restrict__ x,
                   typename Elem<T>::Raw* __restrict__ y, int64_t n, F f) {
  using E = Elem<T>;
  using Raw = typename E::Raw;
  const int64_t span = static_cast<int64_t>(U) * blockDim.x;
  const int64_t stride = span * gridDim.x;
  const int64_t whole = V > 1 ? n / V : 0;  // whole vectors; V = 1: none
  if constexpr (V > 1) {
    static_assert(V * sizeof(Raw) == sizeof(uint4), "one 16-byte vector");
    union Pack { uint4 v; Raw e[V]; };
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (int64_t c = blockIdx.x * span + threadIdx.x; c < whole;
         c += stride) {
      Pack buf[U];
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (c + k * blockDim.x < whole) buf[k].v = xv[c + k * blockDim.x];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j)
          buf[k].e[j] = E::put(f(E::get(buf[k].e[j])));
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (c + k * blockDim.x < whole) yv[c + k * blockDim.x] = buf[k].v;
    }
  }
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = whole * V + tid; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    y[i] = E::put(f(E::get(x[i])));
  }
}

// The launch shape comes from the caller (kernels/elementwise.py: plan):
// `threads` a power of two in [32, kThreads], `per_thread` U in {1, 2}.
template <typename T, int V, typename F>
cudaError_t launch_v(const typename Elem<T>::Raw* x, typename Elem<T>::Raw* y,
                     int64_t n, F f, int threads, int per_thread,
                     cudaStream_t s) {
  const int64_t items = V > 1 ? n / V : n;
  const int64_t groups = (items + per_thread - 1) / per_thread;
  const unsigned blocks =
      repro_cuda::blocks_for(groups > 0 ? groups : 1, threads);
  if (per_thread == 2)
    elementwise_kernel<T, V, 2, F><<<blocks, threads, 0, s>>>(x, y, n, f);
  else
    elementwise_kernel<T, V, 1, F><<<blocks, threads, 0, s>>>(x, y, n, f);
  return cudaGetLastError();
}

template <typename T, typename F>
int launch(const void* x, void* y, int64_t n, F f, int threads,
           int per_thread, void* stream) {
  using Raw = typename Elem<T>::Raw;
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(Raw));
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (threads < 32 || threads > kThreads || (threads & (threads - 1)) ||
      (per_thread != 1 && per_thread != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = repro_cuda::aligned16(x) && repro_cuda::aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Raw* xr = static_cast<const Raw*>(x);
  Raw* yr = static_cast<Raw*>(y);
  const cudaError_t err =
      aligned ? launch_v<T, kVec>(xr, yr, n, f, threads, per_thread, s)
              : launch_v<T, 1>(xr, yr, n, f, threads, per_thread, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: pointers and the
// stream as void*, n as int64, the launch shape (threads a block, vectors a
// thread) as int.  Each returns cudaGetLastError() after its
// launch (0 = launched).
extern "C" {

#define REPRO_EW_ENTRY(OP, SUFFIX, T, FUNCTOR)                              \
  int repro_##OP##_##SUFFIX(const void* x, void* y, int64_t n, int threads, \
                            int per_thread, void* s) {                      \
    return launch<T>(x, y, n, FUNCTOR, threads, per_thread, s);             \
  }
REPRO_EW_ENTRY(vtanh, f32, float, Tanh{})
REPRO_EW_ENTRY(vtanh, bf16, __nv_bfloat16, Tanh{})
REPRO_EW_ENTRY(vsigmoid, f32, float, Sigmoid{})
REPRO_EW_ENTRY(vsigmoid, bf16, __nv_bfloat16, Sigmoid{})
REPRO_EW_ENTRY(vsqrt, f32, float, Sqrt{})
REPRO_EW_ENTRY(vsqrt, bf16, __nv_bfloat16, Sqrt{})
#undef REPRO_EW_ENTRY

int repro_vrelu_f32(const void* x, void* y, int64_t n, float lo, float hi,
                    int threads, int per_thread, void* s) {
  return launch<float>(x, y, n, Relu{lo, hi}, threads, per_thread, s);
}
int repro_vrelu_bf16(const void* x, void* y, int64_t n, float lo, float hi,
                     int threads, int per_thread, void* s) {
  return launch<__nv_bfloat16>(x, y, n, Relu{lo, hi}, threads, per_thread,
                               s);
}

}  // extern "C"
