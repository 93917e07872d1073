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
// below the operations bound.  Where the corners are random over an image
// larger than L2, each pixel reads two runs of 2C elements (x0 and x1 are
// adjacent), which no design avoids.  Design for that:
//   * a group of `group` threads (a power of two up to 32) takes a pixel,
//     each thread V channels at a time: one 16-byte vector (4 fp32 or 8
//     bf16) where C is a multiple of V and img and out are 16-byte
//     aligned, else one channel (V = 1).  Several pixels share a warp when
//     C is small (C 64 fp32: 16 threads a pixel, two pixels a warp); a
//     group loops over C when C has more than 32 vectors;
//   * iy, ix, wy and wx are read once a pixel: lane j of a warp loads pixel
//     j's four (coalesced), and the group of pixel j takes them by shuffle;
//   * a thread issues its four corner loads (two adjacent runs a row)
//     before the blend, and stores its V outputs as one vector, with the
//     streaming hint, so that the output does not push image lines out of
//     L2 (measured a little faster);
//   * image offsets are 32-bit where H*W*C and P*C are below 2^31, 64-bit
//     otherwise (a separate instantiation, chosen by the plan);
//   * no register cap: under the 32 registers of 8 blocks an SM the
//     vector instantiations spilled and ran slower;
//   * no shared memory: random corners give no reuse within a block; the
//     image stays in global memory and repeated corners hit L2.
// The launch shape (V, group, block size, index width) is computed in
// kernels/ibilinear.py (ibilinear_plan) and re-checked here: a claim that
// does not hold is refused with cudaErrorInvalidValue.
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
using repro_cuda::Elems;

constexpr int kThreads = 256;
constexpr int64_t kInt = 2147483647;

__device__ __forceinline__ int64_t clampi(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename I>
struct Shape {
  int64_t p;          // output pixels
  int h, w;
  I c, cv;            // channels, channel vectors (c / V)
  int lg;             // log2 of the group: threads a pixel
};

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
ibilinear_kernel(const typename Elem<T>::Raw* __restrict__ img,
                 const int* __restrict__ iy, const int* __restrict__ ix,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 typename Elem<T>::Raw* __restrict__ out, Shape<I> s) {
  using E = Elems<T, V>;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 >> s.lg;            // pixels a warp
  const int sub = lane >> s.lg;               // this thread's pixel
  const I cv0 = lane & ((1 << s.lg) - 1);     // its first channel vector
  const int64_t warps =
      static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t wp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
       wp * per_warp < s.p; wp += warps) {
    // lane j < per_warp reads pixel j's corner and weights; the group of
    // pixel `sub` takes them from lane `sub`
    const int64_t q = wp * per_warp + lane;
    int qy = 0, qx = 0;
    float qwy = 0.0f, qwx = 0.0f;
    if (lane < per_warp && q < s.p) {
      qy = iy[q];
      qx = ix[q];
      qwy = wy[q];
      qwx = wx[q];
    }
    const int cy = __shfl_sync(0xffffffffu, qy, sub);
    const int cx = __shfl_sync(0xffffffffu, qx, sub);
    const float fy = __shfl_sync(0xffffffffu, qwy, sub);
    const float fx = __shfl_sync(0xffffffffu, qwx, sub);
    const int64_t p = wp * per_warp + sub;
    if (p >= s.p) continue;
    const I y0 = static_cast<I>(clampi(cy, s.h - 1));
    const I y1 = static_cast<I>(clampi(cy + 1LL, s.h - 1));
    const I x0 = static_cast<I>(clampi(cx, s.w - 1));
    const I x1 = static_cast<I>(clampi(cx + 1LL, s.w - 1));
    // element offsets of the four corners' channel runs, in I
    const I w = static_cast<I>(s.w);
    const I r00 = (y0 * w + x0) * s.c, r01 = (y0 * w + x1) * s.c;
    const I r10 = (y1 * w + x0) * s.c, r11 = (y1 * w + x1) * s.c;
    const I o = static_cast<I>(p) * s.c;
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    for (I cv = cv0; cv < s.cv; cv += (I(1) << s.lg)) {
      const I ch = cv * V;
      const typename E::Bits b00 = E::ld(img + (r00 + ch));
      const typename E::Bits b01 = E::ld(img + (r01 + ch));
      const typename E::Bits b10 = E::ld(img + (r10 + ch));
      const typename E::Bits b11 = E::ld(img + (r11 + ch));
      float c00[V], c01[V], c10[V], c11[V], res[V];
      E::cvt(b00, c00);
      E::cvt(b01, c01);
      E::cvt(b10, c10);
      E::cvt(b11, c11);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const float top = __fadd_rn(__fmul_rn(c00[l], gx),
                                    __fmul_rn(c01[l], fx));
        const float bot = __fadd_rn(__fmul_rn(c10[l], gx),
                                    __fmul_rn(c11[l], fx));
        res[l] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
      }
      E::st_cs(out + (o + ch), res);
    }
  }
}

template <typename T, int V, typename I>
void run(const void* img, const void* iy, const void* ix, const void* wy,
         const void* wx, void* out, int64_t h, int64_t w, int64_t c,
         int64_t p, int lg, int threads, cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  Shape<I> s;
  s.p = p;
  s.h = static_cast<int>(h);
  s.w = static_cast<int>(w);
  s.c = static_cast<I>(c);
  s.cv = static_cast<I>(c / V);
  s.lg = lg;
  const int64_t per_warp = 32 >> lg;
  const int64_t warps = (p + per_warp - 1) / per_warp;
  const unsigned blocks = repro_cuda::blocks_for(warps * 32, threads);
  ibilinear_kernel<T, V, I><<<blocks, threads, 0, stream>>>(
      static_cast<const Raw*>(img), static_cast<const int*>(iy),
      static_cast<const int*>(ix), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<Raw*>(out), s);
}

template <typename T>
int launch(const void* img, const void* iy, const void* ix, const void* wy,
           const void* wx, void* out, int64_t h, int64_t w, int64_t c,
           int64_t p, int64_t lanes, int64_t group, int64_t threads,
           int64_t wide, void* stream) {
  using repro_cuda::aligned16;
  constexpr int kVec = repro_cuda::Vec<T>::V;
  const int64_t dims[] = {h, w, c};
  for (int64_t d : dims)
    if (d <= 0 || d > kInt) return static_cast<int>(cudaErrorInvalidValue);
  const bool vector = lanes == kVec;
  int lg = 0;
  while (lg < 5 && (int64_t(1) << lg) < group) ++lg;
  if (p < 0 || (lanes != 1 && !vector) ||
      (vector && (c % kVec != 0 || !aligned16(img) || !aligned16(out))) ||
      group < 1 || group > 32 || (int64_t(1) << lg) != group ||
      threads < 32 || threads > kThreads || (threads & (threads - 1)) ||
      (!wide && (h * w * c > kInt || p * c > kInt)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(threads);
  if (wide) {
    if (vector)
      run<T, kVec, uint64_t>(img, iy, ix, wy, wx, out, h, w, c, p, lg, t, s);
    else
      run<T, 1, uint64_t>(img, iy, ix, wy, wx, out, h, w, c, p, lg, t, s);
  } else {
    if (vector)
      run<T, kVec, uint32_t>(img, iy, ix, wy, wx, out, h, w, c, p, lg, t, s);
    else
      run<T, 1, uint32_t>(img, iy, ix, wy, wx, out, h, w, c, p, lg, t, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: img (h, w, c) of
// the entry's dtype, iy/ix (p,) int32, wy/wx (p,) float32, out (p, c) of
// img's dtype; then the plan of kernels/ibilinear.py (ibilinear_plan):
// lanes (1, or the 16-byte vector's 4 fp32 / 8 bf16), group (threads a
// pixel, a power of two up to 32), threads a block (a power of two in
// [32, 256]) and wide (64-bit offsets).  Each returns cudaGetLastError()
// after its launch (0 = launched), or cudaErrorInvalidValue for a plan the
// operands do not allow.
extern "C" {

int repro_ibilinear_f32(const void* img, const void* iy, const void* ix,
                        const void* wy, const void* wx, void* out, int64_t h,
                        int64_t w, int64_t c, int64_t p, int64_t lanes,
                        int64_t group, int64_t threads, int64_t wide,
                        void* s) {
  return launch<float>(img, iy, ix, wy, wx, out, h, w, c, p, lanes, group,
                       threads, wide, s);
}
int repro_ibilinear_bf16(const void* img, const void* iy, const void* ix,
                         const void* wy, const void* wx, void* out, int64_t h,
                         int64_t w, int64_t c, int64_t p, int64_t lanes,
                         int64_t group, int64_t threads, int64_t wide,
                         void* s) {
  return launch<__nv_bfloat16>(img, iy, ix, wy, wx, out, h, w, c, p, lanes,
                               group, threads, wide, s);
}

}  // extern "C"
