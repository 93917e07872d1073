// Customized ibilinear for the NVIDIA H100 (sm_90a): bilinear interpolation
// of an (H, W, C) image at P output pixels, each given by its top-left
// corner (iy, ix) and fractional weights (wy, wx).
//
// Replaces the Pallas kernel of src/repro/kernels/ibilinear.py: ibilinear
// (:42, launched at :52), which holds the whole image in VMEM, brings the
// corner coordinates in by scalar prefetch and blends 2 x 2 x C corner
// slices eight pixels per grid step, channels on the lanes.
//
// Bound on this card: bytes.  The image is read once at best (corners of
// neighbouring pixels overlap), the four per-pixel vectors once and the
// (P, C) output written once; nine fp32 operations per output are far
// below the operations bound.  One thread per output (p, c): neighbouring
// threads take neighbouring channels of one pixel, so each corner read is
// a coalesced channel run, and the per-pixel iy/ix/wy/wx reads are
// broadcasts within the warp.  No image slab is staged: the image stays in
// global memory and the corner reads go through L1/L2.
//
// The blend is the TPU kernel's (ibilinear.py:36-38), each step rounded
// (__fmul_rn / __fadd_rn / __fsub_rn, no FMA contraction), so it equals the
// op-by-op plain torch version bitwise:
//   top = c00*(1-wx) + c01*wx,  bot = c10*(1-wx) + c11*wx,
//   out = top*(1-wy) + bot*wy.
// Corner reads are clamped to the image (rows 0..H-1, columns 0..W-1), so
// no index can read outside it; callers keep iy in [0, H-2] and ix in
// [0, W-2], as the TPU kernel assumes, and there the clamp changes nothing.
#include "common.cuh"

namespace {

using repro_cuda::Elem;

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clampi(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ibilinear_kernel(const typename Elem<T>::Raw* __restrict__ img,
                 const int* __restrict__ iy, const int* __restrict__ ix,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 typename Elem<T>::Raw* __restrict__ out, int64_t total,
                 int h, int w, int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       o < total; o += stride) {
    const int64_t ch = o % c, p = o / c;
    const int64_t y0 = clampi(iy[p], h - 1), y1 = clampi(iy[p] + 1LL, h - 1);
    const int64_t x0 = clampi(ix[p], w - 1), x1 = clampi(ix[p] + 1LL, w - 1);
    const float c00 = Elem<T>::get(img[(y0 * w + x0) * c + ch]);
    const float c01 = Elem<T>::get(img[(y0 * w + x1) * c + ch]);
    const float c10 = Elem<T>::get(img[(y1 * w + x0) * c + ch]);
    const float c11 = Elem<T>::get(img[(y1 * w + x1) * c + ch]);
    const float fy = wy[p], fx = wx[p];
    const float top = __fadd_rn(__fmul_rn(c00, __fsub_rn(1.0f, fx)),
                                __fmul_rn(c01, fx));
    const float bot = __fadd_rn(__fmul_rn(c10, __fsub_rn(1.0f, fx)),
                                __fmul_rn(c11, fx));
    out[o] = Elem<T>::put(__fadd_rn(__fmul_rn(top, __fsub_rn(1.0f, fy)),
                                    __fmul_rn(bot, fy)));
  }
}

template <typename T>
int launch(const void* img, const void* iy, const void* ix, const void* wy,
           const void* wx, void* out, int64_t h, int64_t w, int64_t c,
           int64_t p, void* stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t dims[] = {h, w, c};
  for (int64_t d : dims)
    if (d <= 0 || d > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  if (p < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = p * c;
  if (total == 0) return static_cast<int>(cudaSuccess);
  ibilinear_kernel<T><<<repro_cuda::blocks_for(total, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(img), static_cast<const int*>(iy),
      static_cast<const int*>(ix), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<Raw*>(out), total,
      static_cast<int>(h), static_cast<int>(w), static_cast<int>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: img (h, w, c) of
// the entry's dtype, iy/ix (p,) int32, wy/wx (p,) float32, out (p, c) of
// img's dtype.  Each returns cudaGetLastError() after its launch
// (0 = launched).
extern "C" {

int repro_ibilinear_f32(const void* img, const void* iy, const void* ix,
                        const void* wy, const void* wx, void* out, int64_t h,
                        int64_t w, int64_t c, int64_t p, void* s) {
  return launch<float>(img, iy, ix, wy, wx, out, h, w, c, p, s);
}
int repro_ibilinear_bf16(const void* img, const void* iy, const void* ix,
                         const void* wy, const void* wx, void* out, int64_t h,
                         int64_t w, int64_t c, int64_t p, void* s) {
  return launch<__nv_bfloat16>(img, iy, ix, wy, wx, out, h, w, c, p, s);
}

}  // extern "C"
