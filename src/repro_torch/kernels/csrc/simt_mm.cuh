// The fp32 SIMT product shared by gemm.cu (its section (c): C = clamp(A @
// B + bias) for fp32 M > 16) and conv.cu (conv_hwc as an implicit GEMM).
//
// Bound by operations: 2MNK fp32 FMAs (at 2048^3 0.257 ms at the 67
// TFLOP/s of the H100 SXM data sheet, 700 W).  No tensor cores: they would
// round fp32 to TF32 and miss the reference's fp32 tolerance.  SIMT
// register tiles of 256 threads, each keeping 8 x 8 fp32 sums of a
// 128 x 128 block tile (8 x 4 of 128 x 64, 4 x 4 of 64 x 64 where larger
// tiles leave the card empty).  What it does about the three holds of a
// plain tiled kernel (64 x 64 tiles, 4 x 4 sums, synchronous scalar
// loads):
// - loads overlap the products: K runs through a 3-stage ring of 16-deep
//   slots filled by cp.async (dynamic shared memory: at 128 x 128 the ring
//   passes the static limit), so slots t+1 and t+2 load while slot t is
//   multiplied, one barrier a slot; each thread's copy addresses are set
//   once and step by a slot;
// - fewer shared-memory loads: A sits k-major (copied element by element,
//   the transpose happening in the copy; a warp's copies still cover whole
//   32-byte sectors of A, and a pad of 4 floats a row spreads its stores
//   over the 32 banks), B row-major (16-byte copies; element by element
//   where N is not a multiple of 4 or B is off 16 bytes).  Per k a thread
//   reads its 8 A and 8 B values as four float4 for 64 FMAs; a warp's A
//   reads are two broadcast addresses and its B reads 256 contiguous
//   bytes, so no bank conflicts;
// - grid fill: the host plan (kernels/gemm.py simt_plan) takes smaller
//   tiles, then cuts K into slices, until ~128 blocks are in flight; the
//   slices' fp32 sums go to a workspace and splitk_reduce adds them in
//   slice order, so two runs agree bitwise.
//
// A is read through an addressing policy, so the two callers share every
// line above.  DenseA is gemm's row-major (m, k) matrix.  ConvA is the
// im2col matrix of an NHWC image, never written: its row r is output pixel
// r, starting at that pixel's window origin in x, and its column kc =
// (i kw + j) Ci + c is tap (i, j), channel c, which lies (kc / (kw Ci)) W Ci
// + kc % (kw Ci) past the origin, because a row of kw taps is one
// contiguous run of kw Ci elements of x.  A thread decodes the origins of
// its rows once, and its two columns once a slot, whatever Ci is: a slot
// or a K slice may straddle taps.  B is a row-major (K, N) matrix in both
// (conv: the HWIO weights as they are).
//
// fp32 operands are staged by cp.async.  bf16 ones (conv_hwc only), which
// cp.async cannot widen, go through ordinary loads converted to fp32 into
// the same layout: the same sums, synchronously staged (right, not fast).
#pragma once
#include <type_traits>

#include "common.cuh"

namespace repro_cuda {

// c[i] = clip(sum over slices of ws[s][i] + bias, lo, hi), slices in order,
// rounded once to T.  Finishes the K slices of the SIMT kernel here and of
// gemm.cu's split-K kernel.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              const typename Elem<T>::Raw* __restrict__ bias,
                              typename Elem<T>::Raw* __restrict__ c,
                              int64_t mn, int64_t n, int splits, float lo,
                              float hi) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < mn; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = ws[i];
    for (int sp = 1; sp < splits; ++sp) sum += ws[sp * mn + i];
    if (bias != nullptr) sum = __fadd_rn(sum, Elem<T>::get(bias[i % n]));
    c[i] = Elem<T>::put(clip(sum, lo, hi));
  }
}

namespace simt {

constexpr int kThreads = 256;          // 16 x 16
constexpr int BK = 16;                 // K rows a ring slot
constexpr int kStages = 3;

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 64 g + 4 ty + i and
// columns 64 h + 4 tx + j of the block tile: TM / 4 groups of 4 rows, TN
// / 4 groups of 4 columns, each read from shared memory as one float4.
template <int TM, int TN>
struct Tile {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  static constexpr int LDA = BM + 4;   // an A row (one k), padded
  static constexpr int kA = BK * LDA, kB = BK * BN;  // floats a slot
  static constexpr int kSmem = kStages * (kA + kB) * 4;
  // copies a thread issues a slot: A rows tid / 8 + 32 i at columns
  // tid % 8 and tid % 8 + 8; B rows tid / (BN / 4) + j (1024 / BN) at
  // columns 4 (tid % (BN / 4)) .. + 3 (or single columns tid % BN)
  static_assert(BK == 16, "the A copies cover columns tid % 8 and + 8");
  static constexpr int kARows = BM / 32;
  static constexpr int kBVec = BK * BN / 4 / kThreads;
  static constexpr int kBOne = BK * BN / kThreads;
};

// cp.async of 4 or 16 bytes, zero-filled where !ok (src must still be a
// valid address)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One element, or four consecutive ones, of T into fp32 shared memory,
// zeros where !ok (src must still be a valid address).
template <typename T> struct Stage;
template <> struct Stage<float> {
  static __device__ __forceinline__ void one(float* dst, const float* src,
                                             bool ok) {
    cp4(dst, src, ok);
  }
  static __device__ __forceinline__ void four(float* dst, const float* src,
                                              bool ok) {
    cp16(dst, src, ok);
  }
};
template <> struct Stage<__nv_bfloat16> {
  using Raw = Elem<__nv_bfloat16>::Raw;
  static __device__ __forceinline__ void one(float* dst, const Raw* src,
                                             bool ok) {
    *dst = ok ? Elem<__nv_bfloat16>::get(*src) : 0.0f;
  }
  static __device__ __forceinline__ void four(float* dst, const Raw* src,
                                              bool ok) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[e] = ok ? Elem<__nv_bfloat16>::get(src[e]) : 0.0f;
  }
};

// A as a row-major (m, k) matrix at a: a thread's rows row0, row0 + 32,
// ... are one pointer and a stride, column kc is kc elements along.
struct DenseA {
  int64_t k;
  template <typename Raw, int R>
  struct Rows {
    const Raw* p;
    int64_t step;
    __device__ __forceinline__ const Raw* at(int i, int64_t off) const {
      return p + i * step + off;
    }
  };
  template <int R, typename Raw>
  __device__ __forceinline__ Rows<Raw, R> rows(const Raw* a, int64_t row0,
                                               int64_t) const {
    return {a + row0 * k, 32 * k};
  }
  __device__ __forceinline__ int64_t col(int64_t kc) const { return kc; }
};

// A as the im2col rows of x (n, h, w, ci) at a, under kh x kw taps and
// stride (sh, sw), output (n, oh, ow): a thread's rows are the window
// origins of its R pixels (a itself past the last), column kc lies
// (kc / run) w ci + kc % run past an origin, run = kw ci.  32-bit decode:
// the launch checks that the pixels, kh kw ci + 64 and h w ci fit in an
// int.
struct ConvA {
  int h, w, ci, oh, ow, sh, sw, run;
  template <typename Raw, int R>
  struct Rows {
    const Raw* p[R];
    __device__ __forceinline__ const Raw* at(int i, int64_t off) const {
      return p[i] + off;
    }
  };
  template <int R, typename Raw>
  __device__ __forceinline__ Rows<Raw, R> rows(const Raw* a, int64_t row0,
                                               int64_t m) const {
    Rows<Raw, R> r;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t gm = row0 + 32 * i;
      if (gm < m) {
        const int g = static_cast<int>(gm);
        const int ox = g % ow, rest = g / ow;
        const int oy = rest % oh, img = rest / oh;
        r.p[i] = a + ((static_cast<int64_t>(img) * h + oy * sh) * w +
                      ox * sw) * ci;
      } else {
        r.p[i] = a;
      }
    }
    return r;
  }
  __device__ __forceinline__ int64_t col(int64_t kc) const {
    const int q = static_cast<int>(kc);
    return (q / run) * (w * ci) + q % run;
  }
};

// Four consecutive outputs from v, rounded to T: one 16-byte (fp32) or
// 8-byte (bf16) store where VEC, else the first `left` one by one.
template <typename T, bool VEC>
__device__ __forceinline__ void store4(typename Elem<T>::Raw* p,
                                       const float (&v)[4], int64_t left) {
  if constexpr (VEC && std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(Elem<T>::put(v[0]) | (uint32_t(Elem<T>::put(v[1])) << 16),
                   Elem<T>::put(v[2]) | (uint32_t(Elem<T>::put(v[3])) << 16));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < left) p[j] = Elem<T>::put(v[j]);
  }
}

// Block (x, y, z): rows m0 = BM x .., columns n0 = BN y .., K slice
// [z ks, min(k, (z + 1) ks)).  One slice (gridDim.z == 1) stores
// clip(acc + bias) into c, rounded to T; several store their raw fp32 sums
// into slice z of ws, and splitk_reduce finishes them.  VEC: n % 4 == 0,
// b and c on 16 bytes, so B slots are 4-element copies and the stores
// vectors.  A warp's A copies are 4 rows x 8 columns (whole 32-byte
// sectors of a dense A; banks 4 q + r, all 32 distinct).
template <typename T, int TM, int TN, bool VEC, typename A>
__global__ void __launch_bounds__(kThreads, 2)
simt_kernel(const typename Elem<T>::Raw* __restrict__ a, const A amap,
            const typename Elem<T>::Raw* __restrict__ b,
            const typename Elem<T>::Raw* __restrict__ bias,
            typename Elem<T>::Raw* __restrict__ c, float* __restrict__ ws,
            int64_t m, int64_t n, int64_t k, int64_t ks, float lo,
            float hi) {
  using S = Tile<TM, TN>;
  using Raw = typename Elem<T>::Raw;
  extern __shared__ __align__(16) float smem[];
  float* const sa = smem;                        // kStages x kA
  float* const sb = smem + kStages * S::kA;      // kStages x kB
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * S::BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * S::BN;
  const int64_t kb = static_cast<int64_t>(blockIdx.z) * ks;
  const int64_t ke = kb + ks < k ? kb + ks : k;
  // slots of the slice; the slot and its ring stage are 32-bit counters,
  // so no 64-bit modulo is taken per slot
  const int nt = ke > kb ? static_cast<int>((ke - kb + BK - 1) / BK) : 0;

  // this thread's copies, fixed for the walk: A rows below a_rows valid,
  // B columns valid where b_col < n
  const int aq = tid & 7, ar = tid >> 3;
  const int64_t a_left = m - m0 - ar;
  const int a_rows = a_left <= 0 ? 0
                     : a_left >= 32 * S::kARows ? S::kARows
                                                : static_cast<int>((a_left + 31) / 32);
  const auto rows = amap.template rows<S::kARows>(a, m0 + ar, m);
  constexpr int kBRow = VEC ? S::BN / 4 : S::BN;  // copies a B row
  const int bq = tid / kBRow;
  const int bc = VEC ? (tid % kBRow) * 4 : tid % kBRow;
  const bool b_col = n0 + bc < n;
  const Raw* const b_src = b + (kb + bq) * n + n0 + bc;

  auto load = [&](int t, int st) {     // slot t of the slice, ring stage st
    const int64_t k0 = kb + static_cast<int64_t>(t) * BK;
    float* da = sa + st * S::kA + aq * S::LDA + ar;
    float* db = sb + st * S::kB + bq * S::BN + bc;
    const int64_t kc = k0 + aq;
    const bool c0 = kc < ke, c1 = kc + 8 < ke;
    const int64_t o0 = amap.col(kc), o1 = amap.col(kc + 8);
#pragma unroll
    for (int i = 0; i < S::kARows; ++i) {
      const bool ok = i < a_rows;
      Stage<T>::one(da + 32 * i, ok && c0 ? rows.at(i, o0) : a, ok && c0);
      Stage<T>::one(da + 8 * S::LDA + 32 * i, ok && c1 ? rows.at(i, o1) : a,
                    ok && c1);
    }
    const Raw* pb = b_src + static_cast<int64_t>(t) * BK * n;
    constexpr int kStep = kThreads / kBRow;      // B rows between copies
#pragma unroll
    for (int j = 0; j < (VEC ? S::kBVec : S::kBOne); ++j) {
      const bool ok = b_col && k0 + bq + j * kStep < ke;
      const Raw* src = ok ? pb + j * kStep * n : b;
      if (VEC)
        Stage<T>::four(db + j * kStep * S::BN, src, ok);
      else
        Stage<T>::one(db + j * kStep * S::BN, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) load(t, t);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int cur = 0, nxt = kStages - 1;
  for (int t = 0; t < nt; ++t) {
    // slot t has landed (this thread's copies, then everyone's), and
    // every thread is done with slot t - 1, which slot t + 2 reuses
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    if (t + kStages - 1 < nt) load(t + kStages - 1, nxt);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    nxt = nxt == kStages - 1 ? 0 : nxt + 1;
    const float* pa = sa + cur * S::kA + ty * 4;
    const float* pb = sb + cur * S::kB + tx * 4;
    cur = cur == kStages - 1 ? 0 : cur + 1;
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(pa + q * S::LDA + g * 64);
        av[4 * g] = x.x; av[4 * g + 1] = x.y;
        av[4 * g + 2] = x.z; av[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 x =
            *reinterpret_cast<const float4*>(pb + q * S::BN + h * 64);
        bv[4 * h] = x.x; bv[4 * h + 1] = x.y;
        bv[4 * h + 2] = x.z; bv[4 * h + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // epilogue: the bias add rounds before the clamp, as the reference's
  // separate add; a K slice stores its raw sums
  const bool whole = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int64_t col = n0 + h * 64 + tx * 4;
      if (col >= n) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * h + j];
        if (whole && col + j < n) {
          if (bias != nullptr) v[j] = __fadd_rn(v[j], Elem<T>::get(bias[col + j]));
          v[j] = clip(v[j], lo, hi);
        }
      }
      if (whole)
        store4<T, VEC>(c + row * n + col, v, n - col);
      else
        store4<float, VEC>(ws + (static_cast<int64_t>(blockIdx.z) * m + row) * n + col,
                           v, n - col);
    }
  }
}

template <typename T, int TM, int TN, bool VEC, typename A>
cudaError_t launch_vec(const typename Elem<T>::Raw* a, const A& amap,
                       const typename Elem<T>::Raw* b,
                       const typename Elem<T>::Raw* bias,
                       typename Elem<T>::Raw* c, float* ws, int64_t m,
                       int64_t n, int64_t k, int64_t ks, float lo, float hi,
                       dim3 grid, cudaStream_t stream) {
  constexpr int smem = Tile<TM, TN>::kSmem;
  static bool attr = false;            // set once per instantiation
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        simt_kernel<T, TM, TN, VEC, A>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  simt_kernel<T, TM, TN, VEC, A><<<grid, kThreads, smem, stream>>>(
      a, amap, b, bias, c, ws, m, n, k, ks, lo, hi);
  return cudaGetLastError();
}

template <typename T, int TM, int TN, typename A>
cudaError_t launch_tile(const typename Elem<T>::Raw* a, const A& amap,
                        const typename Elem<T>::Raw* b,
                        const typename Elem<T>::Raw* bias,
                        typename Elem<T>::Raw* c, float* ws, int64_t m,
                        int64_t n, int64_t k, int64_t splits, int64_t ks,
                        float lo, float hi, bool vec, cudaStream_t stream) {
  using S = Tile<TM, TN>;
  const int64_t gx = (m + S::BM - 1) / S::BM, gy = (n + S::BN - 1) / S::BN;
  if (gx > kMaxBlocks || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(splits));
  return vec ? launch_vec<T, TM, TN, true>(a, amap, b, bias, c, ws, m, n, k,
                                           ks, lo, hi, grid, stream)
             : launch_vec<T, TM, TN, false>(a, amap, b, bias, c, ws, m, n, k,
                                            ks, lo, hi, grid, stream);
}

// C (m, n) = clamp(A @ B + bias) with A read from a through `amap`: tiles
// bm x bn
// of 128 x 128, 128 x 64 or 64 x 64; K cut into `splits` slices of ks rows
// (a multiple of BK where there are several, which then need ws: splits *
// m * n floats).  Returns cudaGetLastError() after the launches.
template <typename T, typename A>
int launch(const typename Elem<T>::Raw* a, const A& amap,
           const typename Elem<T>::Raw* b,
           const typename Elem<T>::Raw* bias, typename Elem<T>::Raw* c,
           float* ws, int64_t m, int64_t n, int64_t k, int64_t bm,
           int64_t bn, int64_t splits, int64_t ks, float lo, float hi,
           cudaStream_t stream) {
  if (k < 0 || splits < 1 || splits > 65535 || ks < 0 || splits * ks < k ||
      (splits > 1 && (ks % BK != 0 || ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && aligned16(b) && aligned16(c);
  cudaError_t err;
  if (bm == 128 && bn == 128)
    err = launch_tile<T, 8, 8>(a, amap, b, bias, c, ws, m, n, k, splits, ks,
                               lo, hi, vec, stream);
  else if (bm == 128 && bn == 64)
    err = launch_tile<T, 8, 4>(a, amap, b, bias, c, ws, m, n, k, splits, ks,
                               lo, hi, vec, stream);
  else if (bm == 64 && bn == 64)
    err = launch_tile<T, 4, 4>(a, amap, b, bias, c, ws, m, n, k, splits, ks,
                               lo, hi, vec, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t mn = m * n;
  splitk_reduce<T><<<blocks_for(mn, 256), 256, 0, stream>>>(
      ws, bias, c, mn, n, static_cast<int>(splits), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt
}  // namespace repro_cuda
