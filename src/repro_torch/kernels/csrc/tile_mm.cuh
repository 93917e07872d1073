// The block-tiled fp32 product shared by gemm.cu and conv.cu.
//
// A block computes one BM x BN tile of C = A @ B with 256 threads, each
// holding a TM x TN = 4 x 4 tile of fp32 sums in registers.  K is walked in
// BK-deep slices: the caller stages BM x BK of A (its own addressing: a
// plain matrix for gemm, the implicit im2col rows for conv) and load_b
// stages BK x BN of B, both in shared memory, then mma adds the slice's
// products.  Tails are masked by bounds (zeros are staged past the end),
// so no operand is padded or copied.  No tensor cores: the products stay
// in fp32 FMA, so the numerics are those of an fp32 sum in another order.
#pragma once
#include "common.cuh"

namespace repro_cuda {
namespace tile {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kRowsPerPass = kThreads / BK;      // A rows staged per pass: 16
constexpr int kAPasses = BM / kRowsPerPass;      // A elements per thread: 4

struct Smem {
  float a[BK][BM + 4];  // A slice, k-major; +4 spreads the transposing
                        // stores over the banks
  float b[BK][BN];
};

// The A element this thread stages in each pass: column threadIdx.x % BK of
// the slice, rows a_row(0..kAPasses-1).  Consecutive threads take
// consecutive k, so a warp reads two 64-byte runs of A.
__device__ __forceinline__ int a_col() { return threadIdx.x % BK; }
__device__ __forceinline__ int a_row(int pass) {
  return threadIdx.x / BK + pass * kRowsPerPass;
}

// Stage rows k0 .. k0+BK-1 (zeros from k_end on) and columns n0 .. n0+BN-1
// (zeros from n on) of a (K, n) row-major matrix.
template <typename T>
__device__ __forceinline__ void load_b(Smem& s,
                                       const typename Elem<T>::Raw* b,
                                       int64_t k0, int64_t k_end, int n0,
                                       int n) {
  for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
    const int q = e / BN, col = e % BN;
    const int64_t gk = k0 + q;
    const int gn = n0 + col;
    s.b[q][col] =
        (gk < k_end && gn < n) ? Elem<T>::get(b[gk * n + gn]) : 0.0f;
  }
}

// acc += (staged A slice) @ (staged B slice) for this thread's outputs:
// rows (threadIdx.x / 16) * TM + i, columns (threadIdx.x % 16) * TN + j.
__device__ __forceinline__ void mma(const Smem& s, float (&acc)[TM][TN]) {
  const int tr = threadIdx.x / (BN / TN), tc = threadIdx.x % (BN / TN);
#pragma unroll
  for (int q = 0; q < BK; ++q) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = s.a[q][tr * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = s.b[q][tc * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The fused epilogue: out[m][col] = clip(acc + bias[col], lo, hi) in fp32,
// rounded once to T, for rows m0.. below m_end and columns n0.. below n.
// The bias add rounds before the clamp, as the reference's separate add.
template <typename T>
__device__ __forceinline__ void store(const float (&acc)[TM][TN],
                                      const typename Elem<T>::Raw* bias,
                                      typename Elem<T>::Raw* out, int64_t m0,
                                      int64_t m_end, int n0, int n, float lo,
                                      float hi) {
  const int tr = threadIdx.x / (BN / TN), tc = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + tr * TM + i;
    if (gm >= m_end) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc * TN + j;
      if (gn >= n) continue;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, Elem<T>::get(bias[gn]));
      out[gm * n + gn] = Elem<T>::put(clip(v, lo, hi));
    }
  }
}

// Grid of BM x BN tiles: M tiles on x (up to 2^31 - 1), N tiles on y (up
// to 65535, so n <= 4194240); false if the product does not fit.
inline bool grid_for(int64_t m, int64_t n, dim3* grid) {
  const int64_t gx = (m + BM - 1) / BM, gy = (n + BN - 1) / BN;
  if (gx > kMaxBlocks || gy > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return true;
}

}  // namespace tile
}  // namespace repro_cuda
