// Mamba2 chunked SSD (state-space duality) scan for the NVIDIA H100
// (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd.py: ssd (:68),
// launched at :87 with body _ssd_body (:34).  There each (batch, head)
// walks chunks of L steps on a sequential grid axis, the (p, n) fp32 state
// in VMEM scratch, groups repeated to heads and the sequence zero-padded
// in HBM beforehand.
//
// Bound on this card.  Per chunk and (batch, head) the block decomposition
// does L·L·n (C Bᵀ, causal half) + L·L·p (the masked product with x) +
// 2·L·n·p (C Sᵀ and the state update) multiply-adds against L·(p + 2n + 1)
// elements read and L·p written: at zamba2's prefill (b 4, s 512, h 64,
// p 64, g 2, n 64, L 128, bf16) 4.3 GFLOP against 21 MB, so the operations
// bound it (4.4 us at the bf16 tensor-core rate, 64 us at fp32 FMA).
//
// Design, simple first (fp32 FMA from shared memory, no tensor cores):
// one block of 512 threads per (batch, head); the chunks are a loop inside
// the block, in order, so the state never leaves shared memory.  Per
// chunk: x (L,p), B (L,n), C (L,n) and dt are staged as fp32 (rows past
// the sequence as zeros, the TPU kernel's zero-dt padding without a copy;
// B and C read from group h / (h/g), not repeated in memory); la = cumsum(
// dt·A) by one thread in order; the L x L matrix (C Bᵀ)∘decay built with
// the decay masked *before* exp (for i < j, la_i - la_j > 0 can overflow,
// and inf·0 would be NaN); then y and the new state.  B and the state are
// padded by one float per row so that lanes walking rows hit distinct
// banks.  At L 128, p 64, n 64 the block holds 182.5 KB of shared memory
// (requested with cudaFuncSetAttribute), so one block fits an SM: with
// b·h = 256 blocks on 132 SMs the grid runs in two waves, the second
// 124 blocks wide.  Tensor-core products and more blocks per SM are
// later work.
#include "common.cuh"

namespace {

using repro_cuda::Elem;

constexpr int kThreads = 512;

struct Ssd {
  int64_t b, s, h, p, g, n, L;
  int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg;
};

inline size_t ssd_smem_bytes(int64_t L, int64_t p, int64_t n) {
  return sizeof(float) *
         static_cast<size_t>(L * p + L * (n + 1) + L * n + p * (n + 1) +
                             L * L + 3 * L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const typename Elem<T>::Raw* __restrict__ x,
           const float* __restrict__ dt, const float* __restrict__ A,
           const typename Elem<T>::Raw* __restrict__ B,
           const typename Elem<T>::Raw* __restrict__ C,
           typename Elem<T>::Raw* __restrict__ y, Ssd a) {
  extern __shared__ float smem[];
  const int L = static_cast<int>(a.L), p = static_cast<int>(a.p),
            n = static_cast<int>(a.n);
  float* xs = smem;                    // L x p
  float* bs = xs + L * p;              // L x (n + 1)
  float* cs = bs + L * (n + 1);        // L x n
  float* st = cs + L * n;              // p x (n + 1), the carried state
  float* mm = st + p * (n + 1);        // L x L, (C Bᵀ)∘decay
  float* la = mm + L * L;              // L
  float* dts = la + L;                 // L
  float* wj = dts + L;                 // L
  const int tid = threadIdx.x;
  const int64_t hh = blockIdx.x, b0 = blockIdx.y;
  const int64_t gg = hh / (a.h / a.g);
  const float av = A[hh];

  for (int i = tid; i < p * (n + 1); i += blockDim.x) st[i] = 0.0f;

  for (int64_t c0 = 0; c0 < a.s; c0 += L) {
    __syncthreads();                   // the previous chunk is consumed
    for (int i = tid; i < L * p; i += blockDim.x) {
      const int r = i / p, c = i - r * p;
      const int64_t t = c0 + r;
      xs[i] = t < a.s ? Elem<T>::get(x[b0 * a.xb + t * a.xs + hh * a.xh + c])
                      : 0.0f;
    }
    for (int i = tid; i < L * n; i += blockDim.x) {
      const int r = i / n, c = i - r * n;
      const int64_t t = c0 + r;
      float bv = 0.0f, cv = 0.0f;
      if (t < a.s) {
        bv = Elem<T>::get(B[b0 * a.bb + t * a.bs + gg * a.bg + c]);
        cv = Elem<T>::get(C[b0 * a.cb + t * a.cs + gg * a.cg + c]);
      }
      bs[r * (n + 1) + c] = bv;
      cs[i] = cv;
    }
    for (int i = tid; i < L; i += blockDim.x) {
      const int64_t t = c0 + i;
      dts[i] = t < a.s ? dt[b0 * a.db + t * a.ds + hh * a.dh] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {                    // inclusive log-decay, in order
      float run = 0.0f;
      for (int i = 0; i < L; ++i) {
        run += dts[i] * av;
        la[i] = run;
      }
    }
    __syncthreads();
    const float la_end = la[L - 1];
    for (int i = tid; i < L; i += blockDim.x)
      wj[i] = expf(la_end - la[i]) * dts[i];
    // mm[i][j] = (C_i . B_j) exp(la_i - la_j) dt_j for j <= i, else 0
    for (int e = tid; e < L * L; e += blockDim.x) {
      const int i = e / L, j = e - i * L;
      float v = 0.0f;
      if (j <= i) {
        const float* ci = cs + i * n;
        const float* bj = bs + j * (n + 1);
        float dot = 0.0f;
        for (int k = 0; k < n; ++k) dot = fmaf(ci[k], bj[k], dot);
        v = dot * (expf(la[i] - la[j]) * dts[j]);
      }
      mm[e] = v;
    }
    __syncthreads();
    // y[i][q] = exp(la_i) (C_i . S_q) + sum_{j <= i} mm[i][j] x[j][q]
    for (int e = tid; e < L * p; e += blockDim.x) {
      const int i = e / p, q = e - i * p;
      const int64_t t = c0 + i;
      if (t >= a.s) continue;
      const float* ci = cs + i * n;
      const float* sq = st + q * (n + 1);
      float inter = 0.0f;
      for (int k = 0; k < n; ++k) inter = fmaf(ci[k], sq[k], inter);
      const float* mi = mm + i * L;
      float intra = 0.0f;
      for (int j = 0; j <= i; ++j) intra = fmaf(mi[j], xs[j * p + q], intra);
      y[((b0 * a.s + t) * a.h + hh) * p + q] =
          Elem<T>::put(expf(la[i]) * inter + intra);
    }
    __syncthreads();                   // every y read the old state
    // S[q][k] = exp(la_L) S[q][k] + sum_j x[j][q] wj[j] B[j][k]
    const float decay = expf(la_end);
    for (int e = tid; e < p * n; e += blockDim.x) {
      const int q = e / n, k = e - q * n;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j)
        acc = fmaf(xs[j * p + q] * wj[j], bs[j * (n + 1) + k], acc);
      st[q * (n + 1) + k] = decay * st[q * (n + 1) + k] + acc;
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, const Ssd& a, void* stream) {
  using Raw = typename Elem<T>::Raw;
  if (a.b <= 0 || a.h <= 0 || a.s <= 0 || a.p <= 0 || a.n <= 0)
    return static_cast<int>(cudaSuccess);
  if (a.g <= 0 || a.h % a.g != 0 || a.L <= 0 || a.h > 2147483647 ||
      a.b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ssd_smem_bytes(a.L, a.p, a.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(a.h), static_cast<unsigned>(a.b));
  ssd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const Raw*>(B),
      static_cast<const Raw*>(C), static_cast<Raw*>(y), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  x (b, s, h, p),
// B and C (b, s, g, n) in x's dtype, each with strides (batch, position,
// head or group) in elements and a contiguous last axis; dt (b, s, h) with
// its three strides and A (h,), float32; y contiguous (b, s, h, p) in x's
// dtype, without the D term.  L is the chunk length.  Each returns
// cudaGetLastError() after its launch (0 = launched).
#define REPRO_SSD_ENTRY(SUFFIX, T)                                           \
  int repro_ssd_##SUFFIX(const void* x, const void* dt, const void* A,       \
                         const void* B, const void* C, void* y, int64_t b,   \
                         int64_t s, int64_t h, int64_t p, int64_t g,         \
                         int64_t n, int64_t L, int64_t xb, int64_t xs,       \
                         int64_t xh, int64_t db, int64_t ds, int64_t dh,     \
                         int64_t bb, int64_t bs, int64_t bg, int64_t cb,     \
                         int64_t cs, int64_t cg, void* stream) {             \
    const Ssd a = {b, s, h, p, g, n, L, xb, xs, xh, db, ds, dh,             \
                   bb, bs, bg, cb, cs, cg};                                  \
    return launch<T>(x, dt, A, B, C, y, a, stream);                          \
  }

extern "C" {
REPRO_SSD_ENTRY(f32, float)
REPRO_SSD_ENTRY(bf16, __nv_bfloat16)
}  // extern "C"
