// Customized GEMM for the NVIDIA H100 (sm_90a): C = clamp(A @ B + bias).
//
// Replaces the Pallas kernel of src/repro/kernels/gemm.py: gemm (:53),
// launched at :74, which pads M, N and K to MXU tiles, accumulates
// (bm, bk) x (bk, bn) blocks in an fp32 VMEM scratch across the K grid
// axis and fuses bias and clamp into the last K step.
//
// Three kernels, one per regime; the wrapper (kernels/gemm.py) picks one
// from the dtype and M alone:
//
//  (a) small M (decode), fp32 and bf16: bound by the bytes of B (at M = 4
//      a (2048, 8512) bf16 weight is 34.9 MB against 0.14 GFLOP).  A
//      weight-streaming split-K kernel: each thread reads B as 16-byte
//      vectors along N (neighbouring lanes on neighbouring addresses), the
//      M rows of A sit in shared memory in fp32, and each thread keeps
//      M x 8 (bf16) or M x 4 (fp32) sums in registers.  K is cut into
//      slices so that ~132 blocks run even where N gives only 8-34 column
//      blocks; each block streams its slice with the next group of rows'
//      loads in flight while the current group is multiplied, and writes
//      its fp32 partial sums to a workspace; splitk_reduce adds the
//      slices in slice order, then the bias, clamps and rounds once.  No
//      atomics: the sum has one fixed order, so two runs agree bitwise.
//      (A last-arriving block doing that sum instead was slower: one
//      block then reads every slice of its columns.)
//  (b) large M (prefill), bf16: bound by operations (2MNK against the
//      989 TFLOP/s of the bf16 tensor cores).  wgmma.mma_async m64n128k16
//      with fp32 sums in registers; 128 x 128 output tiles per block of
//      two warpgroups; K in 64-deep tiles through a 3-stage ring in
//      dynamic shared memory filled by TMA (one thread requests a tile,
//      an mbarrier counts its bytes, the ragged ends arrive as zeros), in
//      the 128-byte-swizzled layouts wgmma reads.  Where K or N is not a
//      multiple of 8 (rows TMA cannot address) the threads stage the same
//      layout element by element.  A is K-major; B stays the reference's
//      (K, N) row-major matrix, read N-major with the instruction's
//      transpose bit, never copied.  Bias, clamp and the single rounding
//      to bf16 are fused into the store.
//  (c) large M, fp32: bound by operations (2MNK fp32 FMAs).  The SIMT
//      register tiles of simt_mm.cuh (shared with conv.cu's conv_hwc):
//      8 x 8 fp32 sums a thread on 128 x 128 blocks, K through a 3-stage
//      cp.async ring of 16-deep slots, and K slices from the host plan
//      (gemm.simt_plan) added in slice order by splitk_reduce where the
//      tiles leave the card empty, so two runs agree bitwise.  A is read
//      as the plain row-major matrix (simt::DenseA).
//
// The clamp is two comparisons, so a NaN propagates as through jnp.clip.
#include <cuda.h>

#include "simt_mm.cuh"

namespace {

using repro_cuda::aligned16;
using repro_cuda::clip;
using repro_cuda::Elem;
using repro_cuda::smem_u32;
using repro_cuda::splitk_reduce;

// ---------------------------------------------------------------------------
// (a) small M: split-K weight streaming
// ---------------------------------------------------------------------------

namespace small {

constexpr int kThreads = 256;
constexpr int kWarpsK = kThreads / 32;  // warps along K
constexpr int kChunk = 512;             // K rows of A staged at a time
constexpr int kUnroll = 8;              // B rows a thread loads at once

using repro_cuda::Vec;

// This thread's B rows kk, kk + kWarpsK, ... (kUnroll of them) of the
// chunk at row c0, columns col..col+V-1; zeros past the chunk's kn rows
// or past n.
template <typename T, bool VEC>
__device__ __forceinline__ void load_group(
    uint4 (&raw)[kUnroll], const typename Elem<T>::Raw* __restrict__ b,
    int64_t n, int64_t col, int64_t c0, int kk, int kn) {
  const int64_t left = n - col;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int row = kk + u * kWarpsK;
    const typename Elem<T>::Raw* p = b + (c0 + row) * n + col;
    if (row >= kn || left <= 0)
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
    else if (VEC)
      raw[u] = Vec<T>::ldg(p);
    else
      raw[u] = Vec<T>::gather(p, static_cast<int>(
                                     left < Vec<T>::V ? left : Vec<T>::V));
  }
}

// Block (blockIdx.x, blockIdx.y): columns blockIdx.x * BN .. + BN (BN =
// 32 lanes x V), K slice [blockIdx.y * ks, + ks).  Lane l takes columns
// l*V .. l*V + V-1; warp wk takes the slice's rows wk, wk + kWarpsK, ...:
// in groups of kUnroll, the next group's loads issued before the
// current group's products, the first group's before A is staged.  The
// kWarpsK warps' sums are added in warp order, four rows of M at a time,
// into ws[blockIdx.y][row][col].
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
small_m_kernel(const typename Elem<T>::Raw* __restrict__ a,
               const typename Elem<T>::Raw* __restrict__ b,
               float* __restrict__ ws, int m, int64_t n, int64_t k,
               int64_t ks) {
  constexpr int V = Vec<T>::V, BN = 32 * V;
  constexpr int kAs = MT * kChunk, kRed = kWarpsK * 4 * BN;
  // A's chunk while the products run, the warps' sums after them
  __shared__ float smem[kAs > kRed ? kAs : kRed];
  float (*as)[kChunk] = reinterpret_cast<float (*)[kChunk]>(smem);
  float (*red)[4][BN] = reinterpret_cast<float (*)[4][BN]>(smem);
  const int tid = threadIdx.x, lane = tid & 31, wk = tid >> 5;
  const int cw = lane * V;              // this thread's first column
  const int64_t col = static_cast<int64_t>(blockIdx.x) * BN + cw;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.y) * ks;
  const int64_t k_hi = k_lo + ks < k ? k_lo + ks : k;
  constexpr int kStep = kWarpsK * kUnroll;
  float acc[MT][V];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;

  for (int64_t c0 = k_lo; c0 < k_hi; c0 += kChunk) {
    const int kn = static_cast<int>(k_hi - c0 < kChunk ? k_hi - c0 : kChunk);
    uint4 raw[kUnroll];
    load_group<T, VEC>(raw, b, n, col, c0, wk, kn);
    __syncthreads();                    // the previous chunk is consumed
    for (int i = tid; i < MT * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      as[r][c] = (r < m && c < kn) ? Elem<T>::get(a[r * k + c0 + c]) : 0.0f;
    }
    __syncthreads();
    for (int kk = wk; kk < kn; kk += kStep) {
      uint4 next[kUnroll];
      load_group<T, VEC>(next, b, n, col, c0, kk + kStep, kn);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = kk + u * kWarpsK;
        if (row >= kn) break;
        float bv[V];
        Vec<T>::cvt(raw[u], bv);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float av = as[r][row];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(av, bv[v], acc[r][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = next[u];
    }
  }

  float* out = ws + static_cast<int64_t>(blockIdx.y) * m * n;
#pragma unroll
  for (int r0 = 0; r0 < MT; r0 += 4) {
    if (r0 >= m) break;
    __syncthreads();                    // A, or the last rows, consumed
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) red[wk][r][cw + v] = acc[r0 + r][v];
    __syncthreads();
    for (int e = tid; e < 4 * BN; e += kThreads) {
      const int r = e / BN, cc = e % BN;
      const int64_t gm = r0 + r;
      const int64_t gn = static_cast<int64_t>(blockIdx.x) * BN + cc;
      if (gm >= m || gn >= n) continue;
      float sum = red[0][r][cc];
#pragma unroll
      for (int w = 1; w < kWarpsK; ++w) sum += red[w][r][cc];
      out[gm * n + gn] = sum;
    }
  }
}

template <typename T, int MT>
cudaError_t launch_mt(const typename Elem<T>::Raw* a,
                      const typename Elem<T>::Raw* b, float* ws, int m,
                      int64_t n, int64_t k, int64_t ks, dim3 grid, bool vec,
                      cudaStream_t stream) {
  if (vec)
    small_m_kernel<T, MT, true><<<grid, kThreads, 0, stream>>>(a, b, ws, m,
                                                              n, k, ks);
  else
    small_m_kernel<T, MT, false><<<grid, kThreads, 0, stream>>>(a, b, ws, m,
                                                               n, k, ks);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* a_, const void* b_, const void* bias_, void* c_,
           void* ws, int64_t m, int64_t n, int64_t k, int64_t splits,
           int64_t ks, float lo, float hi, cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  const Raw* a = static_cast<const Raw*>(a_);
  const Raw* b = static_cast<const Raw*>(b_);
  constexpr int BN = 32 * Vec<T>::V;
  const int64_t gx = (n + BN - 1) / BN;
  if (m > 16 || k < 0 || splits < 1 || splits > 65535 || ks < 0 ||
      splits * ks < k || gx > repro_cuda::kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(splits));
  const bool vec = n % Vec<T>::V == 0 && aligned16(b);
  float* w = static_cast<float*>(ws);
  const int mi = static_cast<int>(m);
  cudaError_t err =
      m <= 4 ? launch_mt<T, 4>(a, b, w, mi, n, k, ks, grid, vec, stream)
      : m <= 8 ? launch_mt<T, 8>(a, b, w, mi, n, k, ks, grid, vec, stream)
               : launch_mt<T, 16>(a, b, w, mi, n, k, ks, grid, vec, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mn = m * n;
  splitk_reduce<T><<<repro_cuda::blocks_for(mn, 256), 256, 0, stream>>>(
      w, static_cast<const Raw*>(bias_), static_cast<Raw*>(c_), mn, n,
      static_cast<int>(splits), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace small

// ---------------------------------------------------------------------------
// (b) large M, bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace mma {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 3, kThreads = 256;
constexpr int kRowBytes = BK * 2;            // one 128-byte swizzle row
constexpr int kATile = BM * kRowBytes;       // 16 KB: A, K-major
constexpr int kBPanel = BK * 128;            // 8 KB: 64 columns of B
constexpr int kBTile = (BN / 64) * kBPanel;  // 16 KB: B, N-major
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack

using u16 = unsigned short;

// The 128-byte swizzle of wgmma and TMA: in each 8-row x 128-byte atom,
// 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 2-D box of `map` at (inner, outer) into shared memory at dst; the
// barrier counts its bytes.  Elements past the tensor's end arrive as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int inner, int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(inner), "r"(outer),
      "r"(bar)
      : "memory");
}

// One 16-byte chunk of 8 elements starting at p, element e present when
// e < valid, the rest zero; stored as is.
__device__ __forceinline__ void st16(uint32_t dst, const u16* p, int valid) {
  u16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e] : u16(0);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0] | (uint32_t(v[1]) << 16)),
               "r"(v[2] | (uint32_t(v[3]) << 16)),
               "r"(v[4] | (uint32_t(v[5]) << 16)),
               "r"(v[6] | (uint32_t(v[7]) << 16))
               : "memory");
}

// Stage K tile [k0, k0 + BK) of A rows m0.. and B columns n0.. into the
// ring slot at (sa, sb) element by element, zeros past the ends, in the
// layout TMA writes: for operands whose rows TMA cannot describe (K or N
// not a multiple of 8, or a base off 16 bytes).
__device__ __forceinline__ void load_stage_scalar(uint32_t sa, uint32_t sb,
                                                  const u16* a, const u16* b,
                                                  int64_t m, int64_t n,
                                                  int64_t k, int64_t m0,
                                                  int64_t n0, int64_t k0) {
  for (int i = threadIdx.x; i < BM * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const int64_t gm = m0 + r, gk = k0 + c * 8;
    const int64_t left = gm < m && gk < k ? k - gk : 0;
    st16(sa + swz(r, c), left > 0 ? a + gm * k + gk : a,
         static_cast<int>(left < 8 ? left : 8));
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8), c = i % (BN / 8);
    const int64_t gk = k0 + r, gn = n0 + c * 8;
    const int64_t left = gk < k && gn < n ? n - gn : 0;
    st16(sb + (c >> 3) * kBPanel + swz(r, c & 7),
         left > 0 ? b + gk * n + gn : b,
         static_cast<int>(left < 8 ? left : 8));
  }
  // make the generic-proxy stores visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define REPRO_ACC8(i)                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),    \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 128 of this warpgroup) += A (64 x 16, K-major) @ B (16 x 128,
// N-major: transpose bit set), both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24),
        REPRO_ACC8(32), REPRO_ACC8(40), REPRO_ACC8(48), REPRO_ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef REPRO_ACC8

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Block (blockIdx.x, blockIdx.y): C rows m0 = 128 y .., columns n0 =
// 128 x ..; warpgroup wg computes rows m0 + 64 wg .. + 63.  K tiles go
// through a kStages ring: tile kt + kStages - 1 is requested when every
// warpgroup is done with tile kt - 1, whose slot it takes.  TMA: thread 0
// requests A's box and B's two 64-column panels, and a per-slot mbarrier
// counts their bytes; otherwise every thread stages the tile itself.
template <bool TMA>
__global__ void __launch_bounds__(kThreads, 2)
mma_kernel(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb, const u16* __restrict__ a,
           const u16* __restrict__ b, const u16* __restrict__ bias,
           u16* __restrict__ c, int64_t m, int64_t n, int64_t k, float lo,
           float hi) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int wg = threadIdx.x >> 7;           // warpgroup: rows wg*64..
  const int64_t ktiles = (k + BK - 1) / BK;
  auto slot_of = [&](int64_t t) {
    return base + static_cast<uint32_t>(t % kStages) * kStageBytes;
  };
  auto request = [&](int64_t t) {            // tile t into its slot
    const uint32_t slot = slot_of(t);
    if (TMA) {
      const uint32_t bar = smem_u32(&full[t % kStages]);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(kStageBytes)
          : "memory");
      const int kk = static_cast<int>(t * BK);
      tma_load(slot, ta, kk, static_cast<int>(m0), bar);
      tma_load(slot + kATile, tb, static_cast<int>(n0), kk, bar);
      tma_load(slot + kATile + kBPanel, tb, static_cast<int>(n0) + 64, kk,
               bar);
    } else {
      load_stage_scalar(slot, slot + kATile, a, b, m, n, k, m0, n0, t * BK);
    }
  };

  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!TMA || threadIdx.x == 0)
    for (int64_t t = 0; t < kStages - 1 && t < ktiles; ++t) request(t);

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int64_t kt = 0; kt < ktiles; ++kt) {
    __syncthreads();                         // tile kt - 1 is consumed
    const int64_t nxt = kt + kStages - 1;
    if (nxt < ktiles && (!TMA || threadIdx.x == 0)) request(nxt);
    if (TMA)
      mbar_wait(smem_u32(&full[kt % kStages]),
                static_cast<uint32_t>((kt / kStages) & 1));
    else
      __syncthreads();                       // tile kt is staged

    const uint32_t sa = slot_of(kt) + wg * 64 * kRowBytes;
    const uint32_t sb = slot_of(kt) + kATile;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: +32 bytes per 16 k inside the swizzled row, 8-row groups 1024
      // bytes apart; B: +16 rows per 16 k, 8-row groups 1024 bytes apart,
      // the two 64-column panels kBPanel apart
      wgmma_m64n128k16(d, desc(sa + kk * 32, 16, 1024),
                       desc(sb + kk * 16 * 128, kBPanel, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
  }

  // epilogue: register i of thread (warp w, lane l) of the warpgroup holds
  // row 16w + l/4 + 8((i/2)%2), column 8(i/4) + 2(l%4) + i%2
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int64_t row0 = m0 + wg * 64 + w * 16 + (lane >> 2);
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int64_t col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= n) continue;
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      b0 = Elem<__nv_bfloat16>::get(bias[col]);
      if (col + 1 < n) b1 = Elem<__nv_bfloat16>::get(bias[col + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + h * 8;
      if (row >= m) continue;
      float v0 = d[j * 4 + h * 2], v1 = d[j * 4 + h * 2 + 1];
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      const u16 o0 = Elem<__nv_bfloat16>::put(clip(v0, lo, hi));
      const u16 o1 = Elem<__nv_bfloat16>::put(clip(v1, lo, hi));
      u16* p = c + row * n + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(p) = o0 | (uint32_t(o1) << 16);
      } else {
        p[0] = o0;
        if (col + 1 < n) p[1] = o1;
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so
// that the library needs no -lcuda; null if the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (outer, inner) bf16 matrix, read in boxes of (box_outer,
// box_inner) with the 128-byte swizzle, zeros past its edges.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
            uint64_t inner, uint64_t outer, uint32_t box_inner,
            uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TMA>
cudaError_t launch_tma(const CUtensorMap& ta, const CUtensorMap& tb,
                       const u16* a, const u16* b, const u16* bias, u16* c,
                       int64_t m, int64_t n, int64_t k, float lo, float hi,
                       dim3 grid, cudaStream_t stream) {
  static bool attr = false;              // set once per instantiation
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_kernel<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  mma_kernel<TMA><<<grid, kThreads, kSmem, stream>>>(ta, tb, a, b, bias, c,
                                                      m, n, k, lo, hi);
  return cudaGetLastError();
}

int launch(const void* a, const void* b, const void* bias, void* c,
           int64_t m, int64_t n, int64_t k, float lo, float hi,
           cudaStream_t stream) {
  const int64_t gx = (n + BN - 1) / BN, gy = (m + BM - 1) / BM;
  if (k < 0 || gx > repro_cuda::kMaxBlocks || gy > 65535 ||
      k >= (int64_t(1) << 31) || n >= (int64_t(1) << 31) ||
      m >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  // TMA takes rows that start on 16 bytes: K and N multiples of 8
  const bool tma = k > 0 && k % 8 == 0 && n % 8 == 0 && aligned16(a) &&
                   aligned16(b);
  CUtensorMap ta{}, tb{};
  if (tma) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if (!encode(fn, &ta, a, k, m, BK, BM) ||
        !encode(fn, &tb, b, n, k, 64, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const u16* ua = static_cast<const u16*>(a);
  const u16* ub = static_cast<const u16*>(b);
  const u16* ubias = static_cast<const u16*>(bias);
  u16* uc = static_cast<u16*>(c);
  return static_cast<int>(
      tma ? launch_tma<true>(ta, tb, ua, ub, ubias, uc, m, n, k, lo, hi,
                             grid, stream)
          : launch_tma<false>(ta, tb, ua, ub, ubias, uc, m, n, k, lo, hi,
                              grid, stream));
}

}  // namespace mma

}  // namespace

// Plain C entry points, bound from Python with ctypes: row-major a (m, k),
// b (k, n), bias (n,) or NULL, c (m, n), all of one dtype.  The small-M
// and SIMT kernels also take an fp32 workspace of splits * m * n elements
// (SIMT: NULL where splits is 1) and the slice length ks (splits * ks >=
// k); the SIMT kernel also its block tile bm x bn.  Each returns cudaGetLastError()
// after its launches (0 = launched).
extern "C" {

int repro_gemm_simt_f32(const void* a, const void* b, const void* bias,
                        void* c, void* ws, int64_t m, int64_t n, int64_t k,
                        int64_t bm, int64_t bn, int64_t splits, int64_t ks,
                        float lo, float hi, void* s) {
  if (m <= 0 || n <= 0) return 0;
  namespace simt = repro_cuda::simt;
  return simt::launch<float>(
      static_cast<const float*>(a), simt::DenseA{k},
      static_cast<const float*>(b), static_cast<const float*>(bias),
      static_cast<float*>(c), static_cast<float*>(ws), m, n, k, bm, bn,
      splits, ks, lo, hi, static_cast<cudaStream_t>(s));
}

int repro_gemm_mma_bf16(const void* a, const void* b, const void* bias,
                        void* c, int64_t m, int64_t n, int64_t k, float lo,
                        float hi, void* s) {
  if (m <= 0 || n <= 0) return 0;
  return mma::launch(a, b, bias, c, m, n, k, lo, hi,
                     static_cast<cudaStream_t>(s));
}

#define REPRO_SMALL_M_ENTRY(SUFFIX, T)                                       \
  int repro_gemm_small_m_##SUFFIX(const void* a, const void* b,             \
                                  const void* bias, void* c, void* ws,      \
                                  int64_t m, int64_t n, int64_t k,          \
                                  int64_t splits, int64_t ks, float lo,     \
                                  float hi, void* s) {                      \
    if (m <= 0 || n <= 0) return 0;                                          \
    return small::launch<T>(a, b, bias, c, ws, m, n, k, splits, ks, lo, hi, \
                            static_cast<cudaStream_t>(s));                  \
  }
REPRO_SMALL_M_ENTRY(f32, float)
REPRO_SMALL_M_ENTRY(bf16, __nv_bfloat16)
#undef REPRO_SMALL_M_ENTRY

}  // extern "C"
