// Customized GEMM for the NVIDIA H100 (sm_90a): C = clamp(A @ B + bias).
//
// Replaces the Pallas kernel of src/repro/kernels/gemm.py: gemm (:53),
// launched at :74, which pads M, N and K to MXU tiles, accumulates
// (bm, bk) x (bk, bn) blocks in an fp32 VMEM scratch across the K grid
// axis and fuses bias and clamp into the last K step.
//
// Bound on this card: 2MNK fp32 operations against 4(MK + KN + MN) bytes;
// at 67 TFLOP/s of fp32 outside the tensor cores and 3.35 TB/s of HBM the
// operations bound it for every shape past a few dozen on a side (the
// Figure-2 256x512x256 product: 1.0 us of operations, 0.3 us of bytes).
//
// Design for that bound (tile_mm.cuh): 64 x 64 output tiles per block,
// K in slices of 16 staged in shared memory, a 4 x 4 fp32 register tile
// per thread, so each staged value feeds four FMAs.  The sequential K grid
// axis of the TPU kernel becomes the loop inside the block; the sum never
// leaves registers.  Bias and clamp are fused into the store.  The clamp
// is two comparisons, so a NaN propagates as through jnp.clip.  No TF32
// and no tensor cores: the numerics are fp32 throughout, and the result
// differs from a library fp32 GEMM only by the order of the sum.
// A wgmma/TMA pipeline (bf16 or TF32 on the tensor cores) is later work.
#include "tile_mm.cuh"

namespace {

using repro_cuda::Elem;
namespace tile = repro_cuda::tile;

template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
gemm_kernel(const typename Elem<T>::Raw* __restrict__ a,
            const typename Elem<T>::Raw* __restrict__ b,
            const typename Elem<T>::Raw* __restrict__ bias,
            typename Elem<T>::Raw* __restrict__ c, int64_t m, int n,
            int64_t k, float lo, float hi) {
  __shared__ tile::Smem s;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * tile::BM;
  const int n0 = blockIdx.y * tile::BN;
  const int q = tile::a_col();
  float acc[tile::TM][tile::TN] = {};
  for (int64_t k0 = 0; k0 < k; k0 += tile::BK) {
    const int64_t gk = k0 + q;
#pragma unroll
    for (int p = 0; p < tile::kAPasses; ++p) {
      const int r = tile::a_row(p);
      const int64_t gm = m0 + r;
      s.a[q][r] = (gm < m && gk < k) ? Elem<T>::get(a[gm * k + gk]) : 0.0f;
    }
    tile::load_b<T>(s, b, k0, k, n0, n);
    __syncthreads();
    tile::mma(s, acc);
    __syncthreads();
  }
  tile::store<T>(acc, bias, c, m0, m, n0, n, lo, hi);
}

template <typename T>
int launch(const void* a, const void* b, const void* bias, void* c,
           int64_t m, int64_t n, int64_t k, float lo, float hi,
           void* stream) {
  using Raw = typename Elem<T>::Raw;
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (k < 0 || !tile::grid_for(m, n, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  gemm_kernel<T><<<grid, tile::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(a), static_cast<const Raw*>(b),
      static_cast<const Raw*>(bias), static_cast<Raw*>(c), m,
      static_cast<int>(n), k, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: row-major a (m, k),
// b (k, n), bias (n,) or NULL, c (m, n), all of one dtype.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" {

int repro_gemm_f32(const void* a, const void* b, const void* bias, void* c,
                   int64_t m, int64_t n, int64_t k, float lo, float hi,
                   void* s) {
  return launch<float>(a, b, bias, c, m, n, k, lo, hi, s);
}
int repro_gemm_bf16(const void* a, const void* b, const void* bias, void* c,
                    int64_t m, int64_t n, int64_t k, float lo, float hi,
                    void* s) {
  return launch<__nv_bfloat16>(a, b, bias, c, m, n, k, lo, hi, s);
}

}  // extern "C"
