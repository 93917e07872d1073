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
// is an implicit GEMM instead: M = N*oh*ow output pixels, N = Co,
// K = kh*kw*Ci, walked tap by tap in 16-channel slices.  For each slice a
// block stages the im2col rows of its 64 pixels straight from x (no
// im2col matrix is written) and the matching 16 x 64 slice of w, which in
// HWIO layout already is a (kh*kw*Ci, Co) row-major matrix, and reuses the
// fp32 register-tiled product of tile_mm.cuh.  The bias is fused into the
// store.
//
// dwconv.  Bound: bytes (each of x, w, bias read once and y written once;
// 9 FMAs per output do not reach the operations bound).  One thread per
// output (n, oh, ow, c): neighbouring threads take neighbouring channels,
// so each tap is a coalesced read of a channel run, and the 3 x 3 window
// is re-read from L1/L2 rather than from HBM.  The sum runs in the
// reference kernel's order, acc = 0, then acc += x * w tap by tap in
// (i, j) order, then + bias, each step rounded (__fmul_rn / __fadd_rn, no
// FMA contraction), so it equals the op-by-op plain torch version
// bitwise.
#include <math_constants.h>

#include "tile_mm.cuh"

namespace {

using repro_cuda::Elem;
namespace tile = repro_cuda::tile;

constexpr int kThreads = 256;

struct ConvShape {
  int n, h, w, ci, kh, kw, co, sh, sw, oh, ow;
};

template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
conv_kernel(const typename Elem<T>::Raw* __restrict__ x,
            const typename Elem<T>::Raw* __restrict__ wt,
            const typename Elem<T>::Raw* __restrict__ bias,
            typename Elem<T>::Raw* __restrict__ y, ConvShape g) {
  __shared__ tile::Smem s;
  const int64_t pixels = static_cast<int64_t>(g.n) * g.oh * g.ow;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * tile::BM;
  const int n0 = blockIdx.y * tile::BN;
  const int q = tile::a_col();
  // offset in x of the window origin of each pixel this thread stages,
  // -1 past the last pixel
  int64_t origin[tile::kAPasses];
#pragma unroll
  for (int p = 0; p < tile::kAPasses; ++p) {
    const int64_t gm = m0 + tile::a_row(p);
    if (gm < pixels) {
      const int64_t ox = gm % g.ow, rest = gm / g.ow;
      const int64_t oy = rest % g.oh, img = rest / g.oh;
      origin[p] = ((img * g.h + oy * g.sh) * g.w + ox * g.sw) * g.ci;
    } else {
      origin[p] = -1;
    }
  }
  float acc[tile::TM][tile::TN] = {};
  for (int i = 0; i < g.kh; ++i) {
    for (int j = 0; j < g.kw; ++j) {
      const int64_t tap_x = (static_cast<int64_t>(i) * g.w + j) * g.ci;
      const int64_t tap_w = static_cast<int64_t>(i * g.kw + j) * g.ci;
      for (int c0 = 0; c0 < g.ci; c0 += tile::BK) {
        const int cc = c0 + q;
#pragma unroll
        for (int p = 0; p < tile::kAPasses; ++p) {
          s.a[q][tile::a_row(p)] =
              (origin[p] >= 0 && cc < g.ci)
                  ? Elem<T>::get(x[origin[p] + tap_x + cc])
                  : 0.0f;
        }
        tile::load_b<T>(s, wt, tap_w + c0, tap_w + g.ci, n0, g.co);
        __syncthreads();
        tile::mma(s, acc);
        __syncthreads();
      }
    }
  }
  tile::store<T>(acc, bias, y, m0, pixels, n0, g.co, -CUDART_INF_F,
                 CUDART_INF_F);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(const typename Elem<T>::Raw* __restrict__ x,
              const typename Elem<T>::Raw* __restrict__ wt,
              const typename Elem<T>::Raw* __restrict__ bias,
              typename Elem<T>::Raw* __restrict__ y, int64_t total, int h,
              int w, int c, int kh, int kw, int oh, int ow) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       o < total; o += stride) {
    const int ch = static_cast<int>(o % c);
    const int64_t pix = o / c;
    const int64_t ox = pix % ow, rest = pix / ow;
    const int64_t oy = rest % oh, img = rest / oh;
    const typename Elem<T>::Raw* xp = x + ((img * h + oy) * w + ox) * c + ch;
    float acc = 0.0f;
    for (int i = 0; i < kh; ++i) {
      for (int j = 0; j < kw; ++j) {
        const float xv = Elem<T>::get(xp[(static_cast<int64_t>(i) * w + j) * c]);
        const float wv = Elem<T>::get(wt[(i * kw + j) * c + ch]);
        acc = __fadd_rn(acc, __fmul_rn(xv, wv));
      }
    }
    if (bias != nullptr) acc = __fadd_rn(acc, Elem<T>::get(bias[ch]));
    y[o] = Elem<T>::put(acc);
  }
}

template <typename T>
int launch_conv(const void* x, const void* w, const void* bias, void* y,
                int64_t n, int64_t h, int64_t wd, int64_t ci, int64_t kh,
                int64_t kw, int64_t co, int64_t sh, int64_t sw,
                void* stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t dims[] = {n, h, wd, ci, kh, kw, co, sh, sw};
  for (int64_t d : dims)
    if (d <= 0 || d > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  if (kh > h || kw > wd) return static_cast<int>(cudaErrorInvalidValue);
  ConvShape g{static_cast<int>(n),  static_cast<int>(h),
              static_cast<int>(wd), static_cast<int>(ci),
              static_cast<int>(kh), static_cast<int>(kw),
              static_cast<int>(co), static_cast<int>(sh),
              static_cast<int>(sw), static_cast<int>((h - kh) / sh + 1),
              static_cast<int>((wd - kw) / sw + 1)};
  dim3 grid;
  if (!tile::grid_for(n * g.oh * g.ow, co, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  conv_kernel<T><<<grid, tile::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(x), static_cast<const Raw*>(w),
      static_cast<const Raw*>(bias), static_cast<Raw*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dwconv(const void* x, const void* w, const void* bias, void* y,
                  int64_t n, int64_t h, int64_t wd, int64_t c, int64_t kh,
                  int64_t kw, void* stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t dims[] = {n, h, wd, c, kh, kw};
  for (int64_t d : dims)
    if (d <= 0 || d > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  if (kh > h || kw > wd) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t oh = h - kh + 1, ow = wd - kw + 1;
  const int64_t total = n * oh * ow * c;
  dwconv_kernel<T><<<repro_cuda::blocks_for(total, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(x), static_cast<const Raw*>(w),
      static_cast<const Raw*>(bias), static_cast<Raw*>(y), total,
      static_cast<int>(h), static_cast<int>(wd), static_cast<int>(c),
      static_cast<int>(kh), static_cast<int>(kw), static_cast<int>(oh),
      static_cast<int>(ow));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  conv_hwc: x NHWC
// (n, h, w, ci), w HWIO (kh, kw, ci, co), bias (co,) or NULL, y (n, oh, ow,
// co).  dwconv: x NHWC (n, h, w, c), w (kh, kw, c), bias (c,) or NULL,
// y (n, h-kh+1, w-kw+1, c).  One dtype per call; each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" {

int repro_conv_hwc_f32(const void* x, const void* w, const void* bias,
                       void* y, int64_t n, int64_t h, int64_t wd, int64_t ci,
                       int64_t kh, int64_t kw, int64_t co, int64_t sh,
                       int64_t sw, void* s) {
  return launch_conv<float>(x, w, bias, y, n, h, wd, ci, kh, kw, co, sh, sw,
                            s);
}
int repro_conv_hwc_bf16(const void* x, const void* w, const void* bias,
                        void* y, int64_t n, int64_t h, int64_t wd, int64_t ci,
                        int64_t kh, int64_t kw, int64_t co, int64_t sh,
                        int64_t sw, void* s) {
  return launch_conv<__nv_bfloat16>(x, w, bias, y, n, h, wd, ci, kh, kw, co,
                                    sh, sw, s);
}
int repro_dwconv_f32(const void* x, const void* w, const void* bias, void* y,
                     int64_t n, int64_t h, int64_t wd, int64_t c, int64_t kh,
                     int64_t kw, void* s) {
  return launch_dwconv<float>(x, w, bias, y, n, h, wd, c, kh, kw, s);
}
int repro_dwconv_bf16(const void* x, const void* w, const void* bias,
                      void* y, int64_t n, int64_t h, int64_t wd, int64_t c,
                      int64_t kh, int64_t kw, void* s) {
  return launch_dwconv<__nv_bfloat16>(x, w, bias, y, n, h, wd, c, kh, kw, s);
}

}  // extern "C"
