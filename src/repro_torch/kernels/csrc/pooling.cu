// Customized pooling for the NVIDIA H100 (sm_90a): maxpool and argmaxpool,
// NHWC, stride == window, VALID (the ragged tail rows and columns are
// dropped: oh = H // kh, ow = W // kw).
//
// Replaces the Pallas kernels of src/repro/kernels/pooling.py: maxpool
// (:84) and argmaxpool (:91), both launched through _pool_call (:67), which
// trims the tail, pads the rows to whole blocks and reduces each window by
// reshape decimation (_maxpool_body :29, _argmaxpool_body :37).
//
// Bound on this card: bytes.  Each input element is read once and each
// output written once (plus an int32 index for argmaxpool); a window of
// four costs three compares.  One template serves both, with the index
// output switched on for argmaxpool.  One thread per output (n, oh, ow, c):
// neighbouring threads take neighbouring channels, so every window tap is
// a coalesced read of a channel run, and the tail is never read at all,
// so nothing is trimmed or padded.
//
// maxpool: the window max with NaN propagating, as jnp.max in
// _maxpool_body; ties and order do not change a max.
// argmaxpool: _argmaxpool_body's select ladder, bit for bit: best starts at
// -inf, index 0; each tap in (i, j) order is taken only if strictly
// greater, so the first max wins and a NaN is never taken (a window of
// NaN gives -inf and index 0).  The index is i * kw + j as int32.
#include <math_constants.h>

#include "common.cuh"

namespace {

using repro_cuda::Elem;

constexpr int kThreads = 256;

template <typename T, bool kIndex>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const typename Elem<T>::Raw* __restrict__ x,
            typename Elem<T>::Raw* __restrict__ y, int* __restrict__ idx,
            int64_t total, int h, int w, int c, int kh, int kw, int oh,
            int ow) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       o < total; o += stride) {
    const int64_t ch = o % c, pix = o / c;
    const int64_t ox = pix % ow, rest = pix / ow;
    const int64_t oy = rest % oh, img = rest / oh;
    const typename Elem<T>::Raw* xp =
        x + ((img * h + oy * kh) * w + ox * kw) * c + ch;
    if constexpr (kIndex) {
      float best = -CUDART_INF_F;
      int best_i = 0;
      for (int i = 0; i < kh; ++i) {
        for (int j = 0; j < kw; ++j) {
          const float v =
              Elem<T>::get(xp[(static_cast<int64_t>(i) * w + j) * c]);
          if (v > best) {
            best = v;
            best_i = i * kw + j;
          }
        }
      }
      y[o] = Elem<T>::put(best);
      idx[o] = best_i;
    } else {
      float best = Elem<T>::get(xp[0]);
      for (int i = 0; i < kh; ++i) {
        for (int j = 0; j < kw; ++j) {
          const float v =
              Elem<T>::get(xp[(static_cast<int64_t>(i) * w + j) * c]);
          // a NaN, once taken, stays: v > NaN and v != v are both false
          if (v > best || v != v) best = v;
        }
      }
      y[o] = Elem<T>::put(best);
    }
  }
}

template <typename T, bool kIndex>
int launch(const void* x, void* y, int* idx, int64_t n, int64_t h,
           int64_t w, int64_t c, int64_t kh, int64_t kw, void* stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t dims[] = {n, h, w, c, kh, kw};
  for (int64_t d : dims)
    if (d <= 0 || d > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t oh = h / kh, ow = w / kw;
  const int64_t total = n * oh * ow * c;
  if (total == 0) return static_cast<int>(cudaSuccess);
  pool_kernel<T, kIndex><<<repro_cuda::blocks_for(total, kThreads), kThreads,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(x), static_cast<Raw*>(y), idx, total,
      static_cast<int>(h), static_cast<int>(w), static_cast<int>(c),
      static_cast<int>(kh), static_cast<int>(kw), static_cast<int>(oh),
      static_cast<int>(ow));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: x NHWC (n, h, w, c),
// y (n, h // kh, w // kw, c) of x's dtype, idx of the same shape as int32.
// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" {

int repro_maxpool_f32(const void* x, void* y, int64_t n, int64_t h,
                      int64_t w, int64_t c, int64_t kh, int64_t kw, void* s) {
  return launch<float, false>(x, y, nullptr, n, h, w, c, kh, kw, s);
}
int repro_maxpool_bf16(const void* x, void* y, int64_t n, int64_t h,
                       int64_t w, int64_t c, int64_t kh, int64_t kw,
                       void* s) {
  return launch<__nv_bfloat16, false>(x, y, nullptr, n, h, w, c, kh, kw, s);
}
int repro_argmaxpool_f32(const void* x, void* y, void* idx, int64_t n,
                         int64_t h, int64_t w, int64_t c, int64_t kh,
                         int64_t kw, void* s) {
  return launch<float, true>(x, y, static_cast<int*>(idx), n, h, w, c, kh,
                             kw, s);
}
int repro_argmaxpool_bf16(const void* x, void* y, void* idx, int64_t n,
                          int64_t h, int64_t w, int64_t c, int64_t kh,
                          int64_t kw, void* s) {
  return launch<__nv_bfloat16, true>(x, y, static_cast<int*>(idx), n, h, w,
                                     c, kh, kw, s);
}

}  // extern "C"
