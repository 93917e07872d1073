// Customized pooling for the NVIDIA H100 (sm_90a): maxpool and argmaxpool,
// NHWC, stride == window, VALID (the ragged tail rows and columns are
// dropped: oh = H // kh, ow = W // kw).
//
// Replaces the Pallas kernels of src/repro/kernels/pooling.py: maxpool
// (:84) and argmaxpool (:91), both launched through _pool_call (:67), which
// trims the tail, pads the rows to whole blocks and reduces each window by
// reshape decimation (_maxpool_body :29, _argmaxpool_body :37).
//
// Bound on this card: bytes.  With stride equal to the window no input
// element is read twice: each is read once and each output written once
// (plus an int32 index for argmaxpool); a window of four costs three
// compares.  So the kernel is a pure stream, built as the elementwise
// template is (elementwise.cu).  The first design (one thread an output
// element, scalar loads, 64-bit div/mod for each, runtime window bounds)
// ran at 39% (maxpool) and 53% (argmaxpool) of the bound.  Now:
//   * a thread makes one output vector of V channels: one 16-byte vector
//     (4 fp32 or 8 bf16 channels) where C is a multiple of V and x, y and
//     idx are 16-byte aligned, else one channel (V = 1).  Neighbouring
//     threads take neighbouring vectors, so each load and store of a warp
//     is one coalesced run of channels, and the tail is never read, so
//     nothing is trimmed or padded.  Two vectors a thread measured no
//     consistent gain and are not used;
//   * the 2 x 2 window (the Figure-2 and XNNPACK window) is a compile-time
//     instantiation: a thread issues all four 16-byte loads of its window
//     before any compare (measured a little faster than the generic loop
//     at 2 x 2); other windows loop over the taps at run time;
//   * the output vector's window origin is decoded with 32-bit index
//     arithmetic where x has fewer than 2^31 elements, with 64-bit
//     arithmetic otherwise (a separate instantiation, chosen by the plan);
//   * __launch_bounds__ asks for 8 blocks of 256 threads an SM, as the
//     elementwise template found best; no shared memory, since nothing is
//     read twice.  Streaming (evict-first) loads or stores helped some
//     cases and hurt others by a few percent, and are not used.
// The launch shape (V, the window instantiation, block size, 32- or 64-bit
// indexing) is computed in kernels/pooling.py (pool_plan) and re-checked
// here: a claim that does not hold (alignment, C % V, the window, the index
// width) is refused with cudaErrorInvalidValue, never quietly replaced by
// another path.
//
// Lane by lane the compares are the reference's, bit for bit:
// maxpool: the window max with NaN propagating, as jnp.max in
// _maxpool_body: it starts from tap 0 and takes `v > best || v != v`, so a
// NaN, once taken, stays; ties and order do not change a max.
// argmaxpool: _argmaxpool_body's select ladder: best starts at -inf,
// index 0; each tap in (i, j) order is taken only if strictly greater, so
// the first max wins and a NaN is never taken (a window of NaN gives -inf
// and index 0).  The index is i * kw + j as int32.  fmaxf, __hmax2 and
// __hmax2_nan each break one of these two rules and are not used.
#include <math_constants.h>

#include "common.cuh"

namespace {

using repro_cuda::Elem;
using repro_cuda::Elems;

constexpr int kThreads = 256;
// Blocks an SM must hold: eight of 256 threads fill its 2048 thread slots
// (32 registers a thread, which the 2 x 2 instantiations fit unspilled)
constexpr int kMinBlocks = 8;
constexpr int64_t kInt = 2147483647;

// The output as rows (n * oh) of ow pixels of cv channel vectors, and the
// input it is read from, in index type I.
template <typename I>
struct Shape {
  I total;            // output vectors: n * oh * ow * cv
  I row_vecs, cv;     // vectors a row (ow * cv), vectors a pixel (c / V)
  I oh, h, w, c;
  int kh, kw;
};

// Element offset into x of the window origin of output vector o.
template <typename I>
__device__ __forceinline__ I window_origin(const Shape<I>& s, I o, int v) {
  const I row = o / s.row_vecs, pos = o - row * s.row_vecs;
  const I ox = pos / s.cv, ch = (pos - ox * s.cv) * v;
  const I img = row / s.oh, oy = row - img * s.oh;
  return ((img * s.h + oy * s.kh) * s.w + ox * s.kw) * s.c + ch;
}

// Window tap `tap` (i * kw + j) folded into the running result, lane by
// lane.  maxpool takes tap 0 as it is (so a NaN there stays), then
// `v > best || v != v`; argmaxpool starts from -inf, index 0, and takes a
// tap only where it is strictly greater.
template <int V, bool kIndex>
__device__ __forceinline__ void fold(float (&best)[V], int (&best_i)[V],
                                     const float (&v)[V], int tap) {
#pragma unroll
  for (int l = 0; l < V; ++l) {
    if constexpr (kIndex) {
      if (v[l] > best[l]) {
        best[l] = v[l];
        best_i[l] = tap;
      }
    } else if (tap == 0 || v[l] > best[l] || v[l] != v[l]) {
      // a NaN, once taken, stays: v > NaN and v != v are both false
      best[l] = v[l];
    }
  }
}

template <int V>
__device__ __forceinline__ void store_index(int* p, const int (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<int4*>(p + q) =
          make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// KH = KW = 0: the window (s.kh, s.kw) is read tap by tap at run time.
template <typename T, int V, int KH, int KW, bool kIndex, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pool_kernel(const typename Elem<T>::Raw* __restrict__ x,
            typename Elem<T>::Raw* __restrict__ y, int* __restrict__ idx,
            Shape<I> s) {
  using E = Elems<T, V>;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I o = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < s.total; o += stride) {
    const I base = window_origin(s, o, V);
    float best[V], v[V];
    int best_i[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      best[l] = -CUDART_INF_F;
      best_i[l] = 0;
    }
    if constexpr (KH > 0) {
      typename E::Bits raw[KH * KW];
#pragma unroll
      for (int t = 0; t < KH * KW; ++t)
        raw[t] = E::ld(x + base + (static_cast<I>(t / KW) * s.w + t % KW) *
                                      s.c);
#pragma unroll
      for (int t = 0; t < KH * KW; ++t) {
        E::cvt(raw[t], v);
        fold<V, kIndex>(best, best_i, v, t);
      }
    } else {
      for (int i = 0; i < s.kh; ++i)
        for (int j = 0; j < s.kw; ++j) {
          E::cvt(E::ld(x + base + (static_cast<I>(i) * s.w + j) * s.c), v);
          fold<V, kIndex>(best, best_i, v, i * s.kw + j);
        }
    }
    E::st(y + o * V, best);
    if constexpr (kIndex) store_index<V>(idx + o * V, best_i);
  }
}

template <typename T, int V, int KH, int KW, bool kIndex, typename I>
void run(const void* x, void* y, int* idx, const Shape<I>& s, int threads,
         cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  const unsigned blocks =
      repro_cuda::blocks_for(static_cast<int64_t>(s.total), threads);
  pool_kernel<T, V, KH, KW, kIndex, I><<<blocks, threads, 0, stream>>>(
      static_cast<const Raw*>(x), static_cast<Raw*>(y), idx, s);
}

template <typename T, int V, bool kIndex, typename I>
void run_window(const void* x, void* y, int* idx, int64_t n, int64_t h,
                int64_t w, int64_t c, int64_t kh, int64_t kw, bool fixed2x2,
                int threads, cudaStream_t stream) {
  const int64_t oh = h / kh, ow = w / kw, cv = c / V;
  Shape<I> s;
  s.total = static_cast<I>(n * oh * ow * cv);
  s.row_vecs = static_cast<I>(ow * cv);
  s.cv = static_cast<I>(cv);
  s.oh = static_cast<I>(oh);
  s.h = static_cast<I>(h);
  s.w = static_cast<I>(w);
  s.c = static_cast<I>(c);
  s.kh = static_cast<int>(kh);
  s.kw = static_cast<int>(kw);
  if (fixed2x2)
    run<T, V, 2, 2, kIndex, I>(x, y, idx, s, threads, stream);
  else
    run<T, V, 0, 0, kIndex, I>(x, y, idx, s, threads, stream);
}

template <typename T, bool kIndex>
int launch(const void* x, void* y, int* idx, int64_t n, int64_t h,
           int64_t w, int64_t c, int64_t kh, int64_t kw, int64_t lanes,
           int64_t fixed2x2, int64_t threads, int64_t wide, void* stream) {
  using repro_cuda::aligned16;
  constexpr int kVec = repro_cuda::Vec<T>::V;
  const int64_t dims[] = {n, h, w, c, kh, kw};
  for (int64_t d : dims)
    if (d <= 0 || d > kInt) return static_cast<int>(cudaErrorInvalidValue);
  const bool vector = lanes == kVec;
  if ((lanes != 1 && !vector) ||
      (vector && (c % kVec != 0 || !aligned16(x) || !aligned16(y) ||
                  (kIndex && !aligned16(idx)))) ||
      (fixed2x2 != 0 && (kh != 2 || kw != 2)) || threads < 32 ||
      threads > kThreads || (threads & (threads - 1)) ||
      (!wide && n * h * w * c > kInt))   // n*h*w*c < 2^63: each dim < 2^31
    return static_cast<int>(cudaErrorInvalidValue);
  if (n * (h / kh) * (w / kw) == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(threads);
  const bool f2 = fixed2x2 != 0;
  if (wide) {
    if (vector)
      run_window<T, kVec, kIndex, uint64_t>(x, y, idx, n, h, w, c, kh, kw,
                                            f2, t, s);
    else
      run_window<T, 1, kIndex, uint64_t>(x, y, idx, n, h, w, c, kh, kw, f2,
                                         t, s);
  } else {
    if (vector)
      run_window<T, kVec, kIndex, uint32_t>(x, y, idx, n, h, w, c, kh, kw,
                                            f2, t, s);
    else
      run_window<T, 1, kIndex, uint32_t>(x, y, idx, n, h, w, c, kh, kw, f2,
                                         t, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: x NHWC (n, h, w, c),
// y (n, h // kh, w // kw, c) of x's dtype, idx of the same shape as int32;
// then the plan of kernels/pooling.py (pool_plan): lanes (1, or the 16-byte
// vector's 4 fp32 / 8 bf16), fixed2x2 (the compile-time 2 x 2 window),
// threads a block (a power of two in [32, 256]) and wide (64-bit
// indexing).  Each returns
// cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a plan the operands do not allow.
extern "C" {

#define REPRO_POOL_ARGS                                                  \
  int64_t n, int64_t h, int64_t w, int64_t c, int64_t kh, int64_t kw,    \
      int64_t lanes, int64_t fixed2x2, int64_t threads, int64_t wide, void* s
#define REPRO_POOL_PASS n, h, w, c, kh, kw, lanes, fixed2x2, threads, wide, s

int repro_maxpool_f32(const void* x, void* y, REPRO_POOL_ARGS) {
  return launch<float, false>(x, y, nullptr, REPRO_POOL_PASS);
}
int repro_maxpool_bf16(const void* x, void* y, REPRO_POOL_ARGS) {
  return launch<__nv_bfloat16, false>(x, y, nullptr, REPRO_POOL_PASS);
}
int repro_argmaxpool_f32(const void* x, void* y, void* idx,
                         REPRO_POOL_ARGS) {
  return launch<float, true>(x, y, static_cast<int*>(idx), REPRO_POOL_PASS);
}
int repro_argmaxpool_bf16(const void* x, void* y, void* idx,
                          REPRO_POOL_ARGS) {
  return launch<__nv_bfloat16, true>(x, y, static_cast<int*>(idx),
                                     REPRO_POOL_PASS);
}

#undef REPRO_POOL_PASS
#undef REPRO_POOL_ARGS

}  // extern "C"
