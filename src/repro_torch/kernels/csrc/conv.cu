// Customized convolutions for the NVIDIA H100 (sm_90a): conv_hwc (direct
// VALID NHWC conv, any stride) and dwconv (depthwise, VALID, stride 1).
//
// Replace the Pallas kernels of src/repro/kernels/conv.py: conv_hwc (:57,
// launched at :66), which holds one whole (H, W, Ci) image per grid step
// in VMEM and unrolls the kh*kw taps as (oh*ow, Ci) x (Ci, Co) MXU
// products; and dwconv (:99, launched at :106), a per-tap multiply-add
// chain over (oh, ow, C) slabs.
//
// conv_hwc.  Bound: 2*pixels*Co*kh*kw*Ci fp32 operations, which exceed
// the bytes' time at every Figure-2-like shape (x (1,28,28,128), w
// (3,3,128,128): 3.0 us of operations, 0.4 us of bytes).  A whole image
// does not fit the 227 KB of shared memory a block can use, so the design
// is an implicit GEMM: M = N*oh*ow output pixels, N = Co, K = kh*kw*Ci.
// It is the fp32 SIMT product of simt_mm.cuh, the one gemm.cu's fp32
// variant runs (8 x 8 sums a thread, a 3-stage cp.async ring of 16-deep K
// slots, K slices from gemm.simt_plan where the tiles leave the card
// empty, added in slice order by splitk_reduce), with A read as the
// im2col rows of x (simt::ConvA: each row's window origin decoded once, a
// thread's two K columns decoded into (tap row, offset) once a slot, so a
// slot or a slice may straddle taps) and B the HWIO weights as they are,
// a (kh*kw*Ci, Co) row-major matrix.  No im2col matrix is written.  The
// bias is fused into the store, the clamp is +-inf.  bf16 operands are
// staged through ordinary loads converted to fp32 (cp.async cannot widen
// them); the sums are fp32 either way.
//
// dwconv.  Bound: bytes (each of x, w, bias read once and y written once;
// 9 FMAs per output do not reach the operations bound).  A plain one
// thread per output spends its time issuing instructions (an index decode
// by divisions, 9 scalar loads of x and 9 of w per output), far from
// HBM's rate.  Here a thread owns 4 consecutive channels (one 16-byte fp32
// or 8-byte bf16 vector, widened to fp32 in registers) of a run of `run`
// consecutive output columns of one output row: it decodes its (image,
// row, run) once, holds its channels' weights and bias in registers and,
// for 3 x 3 taps, a sliding window of 3 input columns x 3 rows, so each
// input column is loaded once per output row and not 3 times; loads and
// stores are vectors, neighbouring lanes on neighbouring channels.  Blocks are (channel vectors) x (tasks): the
// host plan (kernels/conv.py dwconv_plan) picks the run so that the grid
// fills the card.  Other tap shapes take a loop that reads each tap's x
// and w vectors in turn; C off 4, or an operand off the vector's
// alignment, takes one channel a thread.  The sum runs in the reference
// kernel's order, acc = 0, then acc += x * w tap by tap in (i, j) order,
// then + bias, each step rounded (__fmul_rn / __fadd_rn, no FMA
// contraction), so it equals the op-by-op plain torch version bitwise.
#include <limits>

#include "simt_mm.cuh"

namespace {

using repro_cuda::Elem;

constexpr int64_t kInt = 2147483647;

// ---------------------------------------------------------------------------
// dwconv
// ---------------------------------------------------------------------------

namespace dw {

constexpr int kThreads = 256;

// A thread's channels, widened to fp32 as they are loaded (bf16 -> fp32 is
// exact): 4 consecutive channels, one 16-byte (fp32) or 8-byte (bf16)
// load, where VEC; else one channel.
template <typename T, bool VEC>
struct Lanes {
  using Raw = typename Elem<T>::Raw;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int V = VEC ? 4 : 1;
  float f[V];

  __device__ __forceinline__ void load(const Raw* p) {
    if constexpr (!VEC) {
      f[0] = Elem<T>::get(__ldg(p));
    } else if constexpr (kF32) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      f[0] = __uint_as_float(u.x << 16);
      f[1] = __uint_as_float(u.x & 0xffff0000u);
      f[2] = __uint_as_float(u.y << 16);
      f[3] = __uint_as_float(u.y & 0xffff0000u);
    }
  }
};

// The V channels at p from acc, each rounded once to T: one 16-byte (fp32)
// or 8-byte (bf16) store where VEC.
template <typename T, bool VEC>
__device__ __forceinline__ void store(typename Elem<T>::Raw* p,
                                      const float (&acc)[Lanes<T, VEC>::V]) {
  if constexpr (!VEC) {
    p[0] = Elem<T>::put(acc[0]);
  } else if constexpr (Lanes<T, VEC>::kF32) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        Elem<T>::put(acc[0]) | (uint32_t(Elem<T>::put(acc[1])) << 16),
        Elem<T>::put(acc[2]) | (uint32_t(Elem<T>::put(acc[3])) << 16));
  }
}

struct Shape {
  int h, w, c, kh, kw, oh, ow;
  int nv;      // channel vectors (c / V)
  int runs;    // runs of an output row: ceil(ow / RUN)
  int tasks;   // n * oh * runs
};

// Thread (threadIdx.x, threadIdx.y) of block (x, y): channel vector cv =
// y * blockDim.x + threadIdx.x (channels cv*V .. + V-1), task x *
// blockDim.y + threadIdx.y = output columns r*RUN .. of output row (img,
// oy).  KH, KW > 0: taps fixed at compile time, weights and a window of
// KW input columns x KH rows in registers; 0: g.kh x g.kw read per tap.
template <typename T, bool VEC, int KH, int KW, int RUN>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(const typename Elem<T>::Raw* __restrict__ x,
              const typename Elem<T>::Raw* __restrict__ wt,
              const typename Elem<T>::Raw* __restrict__ bias,
              typename Elem<T>::Raw* __restrict__ y, Shape g) {
  using L = Lanes<T, VEC>;
  constexpr int V = L::V;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  const int task = blockIdx.x * blockDim.y + threadIdx.y;
  if (cv >= g.nv || task >= g.tasks) return;
  const int ch = cv * V;
  const int r = task % g.runs, row = task / g.runs;   // row = img*oh + oy
  const int oy = row % g.oh, img = row / g.oh;
  const int ox0 = r * RUN;
  const int cnt = g.ow - ox0 < RUN ? g.ow - ox0 : RUN;
  const int64_t cs = g.c;                             // a pixel's stride
  const typename Elem<T>::Raw* xp =
      x + ((static_cast<int64_t>(img) * g.h + oy) * g.w + ox0) * cs + ch;
  typename Elem<T>::Raw* yp = y + (static_cast<int64_t>(row) * g.ow + ox0)
                                      * cs + ch;
  L bv;
  if (bias != nullptr) bv.load(bias + ch);

  auto finish = [&](float (&acc)[V], int o) {
    if (bias != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], bv.f[e]);
    }
    store<T, VEC>(yp + o * cs, acc);
  };

  if constexpr (KH > 0) {
    L wr[KH][KW], win[KH][KW];
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < KW; ++j) wr[i][j].load(wt + (i * KW + j) * cs + ch);
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < KW - 1; ++j)
        win[i][j].load(xp + (static_cast<int64_t>(i) * g.w + j) * cs);
    // output column o: load input column o + KW - 1 of each row, run the
    // tap chain, slide the window by one column
    auto step = [&](int o) {
#pragma unroll
      for (int i = 0; i < KH; ++i)
        win[i][KW - 1].load(
            xp + (static_cast<int64_t>(i) * g.w + o + KW - 1) * cs);
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int i = 0; i < KH; ++i)
#pragma unroll
        for (int j = 0; j < KW; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = __fadd_rn(acc[e],
                               __fmul_rn(win[i][j].f[e], wr[i][j].f[e]));
      finish(acc, o);
#pragma unroll
      for (int i = 0; i < KH; ++i)
#pragma unroll
        for (int j = 0; j < KW - 1; ++j) win[i][j] = win[i][j + 1];
    };
    if (cnt == RUN) {
#pragma unroll
      for (int o = 0; o < RUN; ++o) step(o);
    } else {
#pragma unroll 1
      for (int o = 0; o < cnt; ++o) step(o);
    }
  } else {
#pragma unroll 1
    for (int o = 0; o < cnt; ++o) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      for (int i = 0; i < g.kh; ++i) {
        for (int j = 0; j < g.kw; ++j) {
          L xv, wv;
          xv.load(xp + (static_cast<int64_t>(i) * g.w + o + j) * cs);
          wv.load(wt + (i * g.kw + j) * cs + ch);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(xv.f[e], wv.f[e]));
        }
      }
      finish(acc, o);
    }
  }
}

template <typename T, bool VEC, int KH, int KW>
cudaError_t launch_run(const typename Elem<T>::Raw* x,
                       const typename Elem<T>::Raw* w,
                       const typename Elem<T>::Raw* bias,
                       typename Elem<T>::Raw* y, const Shape& g, int run,
                       dim3 grid, dim3 block, cudaStream_t stream) {
  switch (run) {
    case 1:
      dwconv_kernel<T, VEC, KH, KW, 1><<<grid, block, 0, stream>>>(x, w, bias,
                                                                   y, g);
      break;
    case 2:
      dwconv_kernel<T, VEC, KH, KW, 2><<<grid, block, 0, stream>>>(x, w, bias,
                                                                   y, g);
      break;
    case 4:
      dwconv_kernel<T, VEC, KH, KW, 4><<<grid, block, 0, stream>>>(x, w, bias,
                                                                   y, g);
      break;
    case 8:
      dwconv_kernel<T, VEC, KH, KW, 8><<<grid, block, 0, stream>>>(x, w, bias,
                                                                   y, g);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_taps(const typename Elem<T>::Raw* x,
                        const typename Elem<T>::Raw* w,
                        const typename Elem<T>::Raw* bias,
                        typename Elem<T>::Raw* y, const Shape& g, int run,
                        dim3 grid, dim3 block, cudaStream_t stream) {
  if (g.kh == 3 && g.kw == 3)
    return launch_run<T, VEC, 3, 3>(x, w, bias, y, g, run, grid, block,
                                    stream);
  return launch_run<T, VEC, 0, 0>(x, w, bias, y, g, run, grid, block, stream);
}

// vec: 4 channels a thread (C a multiple of 4, every operand on 4
// elements); group: channel vectors a block takes (a power of two up to
// 32); run: output columns a thread takes (1, 2, 4 or 8).
template <typename T>
int launch(const void* x_, const void* w_, const void* bias_, void* y_,
           int64_t n, int64_t h, int64_t wd, int64_t c, int64_t kh,
           int64_t kw, int64_t vec, int64_t group, int64_t run,
           cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t dims[] = {n, h, wd, c, kh, kw};
  for (int64_t d : dims)
    if (d <= 0 || d > kInt) return static_cast<int>(cudaErrorInvalidValue);
  if (kh > h || kw > wd || group < 1 || group > 32 ||
      (group & (group - 1)) != 0 || run < 1 || kh * kw * c > kInt)
    return static_cast<int>(cudaErrorInvalidValue);
  const int V = vec ? 4 : 1;
  const uintptr_t vb = V * sizeof(Raw) - 1;      // vector alignment mask
  auto off = [vb](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & vb) != 0;
  };
  if (vec && (c % V != 0 || off(x_) || off(w_) || off(y_) ||
              (bias_ != nullptr && off(bias_))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t oh = h - kh + 1, ow = wd - kw + 1;
  const int64_t runs = (ow + run - 1) / run, tasks = n * oh * runs;
  const int64_t rows = kThreads / group, nv = c / V;
  const int64_t gx = (tasks + rows - 1) / rows, gy = (nv + group - 1) / group;
  if (tasks > kInt || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape g{static_cast<int>(h),    static_cast<int>(wd),
                static_cast<int>(c),    static_cast<int>(kh),
                static_cast<int>(kw),   static_cast<int>(oh),
                static_cast<int>(ow),   static_cast<int>(nv),
                static_cast<int>(runs), static_cast<int>(tasks)};
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(static_cast<unsigned>(group), static_cast<unsigned>(rows));
  const Raw* x = static_cast<const Raw*>(x_);
  const Raw* w = static_cast<const Raw*>(w_);
  const Raw* bias = static_cast<const Raw*>(bias_);
  Raw* y = static_cast<Raw*>(y_);
  const int r = static_cast<int>(run);
  return static_cast<int>(
      vec ? launch_taps<T, true>(x, w, bias, y, g, r, grid, block, stream)
          : launch_taps<T, false>(x, w, bias, y, g, r, grid, block, stream));
}

}  // namespace dw

// ---------------------------------------------------------------------------
// conv_hwc: the SIMT product over the im2col rows of x
// ---------------------------------------------------------------------------

// bm x bn tiles and K slices (splits of ks) as gemm.simt_plan gives them
// for (n*oh*ow, co, kh*kw*ci); ws: splits * n*oh*ow * co floats where
// splits > 1, else NULL.
template <typename T>
int launch_conv(const void* x, const void* w, const void* bias, void* y,
                void* ws, int64_t n, int64_t h, int64_t wd, int64_t ci,
                int64_t kh, int64_t kw, int64_t co, int64_t sh, int64_t sw,
                int64_t bm, int64_t bn, int64_t splits, int64_t ks,
                cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t dims[] = {n, h, wd, ci, kh, kw, co, sh, sw};
  for (int64_t d : dims)
    if (d <= 0 || d > kInt) return static_cast<int>(cudaErrorInvalidValue);
  if (kh > h || kw > wd) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t oh = (h - kh) / sh + 1, ow = (wd - kw) / sw + 1;
  const int64_t m = n * oh * ow, k = kh * kw * ci;
  // ConvA decodes pixels, K columns and offsets inside an image in int
  if (m > kInt || k > kInt - 64 || h * wd * ci > kInt)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro_cuda::simt::ConvA a{
      static_cast<int>(h),  static_cast<int>(wd), static_cast<int>(ci),
      static_cast<int>(oh), static_cast<int>(ow), static_cast<int>(sh),
      static_cast<int>(sw), static_cast<int>(kw * ci)};
  return repro_cuda::simt::launch<T>(
      static_cast<const Raw*>(x), a, static_cast<const Raw*>(w),
      static_cast<const Raw*>(bias),
      static_cast<Raw*>(y), static_cast<float*>(ws), m, co, k, bm, bn,
      splits, ks, -std::numeric_limits<float>::infinity(),
      std::numeric_limits<float>::infinity(), stream);
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  conv_hwc: x NHWC
// (n, h, w, ci), w HWIO (kh, kw, ci, co), bias (co,) or NULL, y (n, oh, ow,
// co), the fp32 workspace and the plan (see launch_conv).  dwconv: x NHWC
// (n, h, w, c), w (kh, kw, c), bias (c,) or NULL, y (n, h-kh+1, w-kw+1,
// c), and the launch shape (see dw::launch).  One dtype per call; each
// returns cudaGetLastError() after its launches (0 = launched).
extern "C" {

#define REPRO_CONV_ENTRIES(SUFFIX, T)                                         \
  int repro_conv_hwc_##SUFFIX(const void* x, const void* w, const void* bias, \
                              void* y, void* ws, int64_t n, int64_t h,        \
                              int64_t wd, int64_t ci, int64_t kh, int64_t kw, \
                              int64_t co, int64_t sh, int64_t sw, int64_t bm, \
                              int64_t bn, int64_t splits, int64_t ks,         \
                              void* s) {                                      \
    return launch_conv<T>(x, w, bias, y, ws, n, h, wd, ci, kh, kw, co, sh,    \
                          sw, bm, bn, splits, ks,                             \
                          static_cast<cudaStream_t>(s));                      \
  }                                                                           \
  int repro_dwconv_##SUFFIX(const void* x, const void* w, const void* bias,   \
                            void* y, int64_t n, int64_t h, int64_t wd,        \
                            int64_t c, int64_t kh, int64_t kw, int64_t vec,   \
                            int64_t group, int64_t run, void* s) {            \
    return dw::launch<T>(x, w, bias, y, n, h, wd, c, kh, kw, vec, group, run, \
                         static_cast<cudaStream_t>(s));                       \
  }
REPRO_CONV_ENTRIES(f32, float)
REPRO_CONV_ENTRIES(bf16, __nv_bfloat16)
#undef REPRO_CONV_ENTRIES

}  // extern "C"
