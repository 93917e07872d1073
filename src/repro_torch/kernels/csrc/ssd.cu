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
// p 64, g 2, n 64, L 128, bf16) 4.3 GFLOP against 21 MB, so the bytes bound
// it at the bf16 tensor-core rate (6 us of bytes against 4.4 us of
// operations), and fp32 FMA would take 64 us.
//
// The first design (one block per (batch, head) walking the chunks, fp32
// FMA with both operands in shared memory, a one-thread cumsum) reached
// 1.2% of that bound: 256 blocks of 16 warps in two waves, idle threads
// above the diagonal, no tensor cores.  This one:
//
//   * is parallel over chunks of kL = 128 rows, in two launches: 1024
//     blocks at zamba2's prefill, not 256.  (Chunks of 64 rows halved the
//     work above the diagonal but doubled the start states each block
//     reads, 16 KB a chunk against 8 KB of x, and ran slower.)
//     ssd_state_kernel, one block per
//     (batch, head, chunk) of every chunk but the last, computes the
//     chunk's state change dS_c = (w∘x)ᵀ B, w_j = exp(la_L - la_j) dt_j,
//     and its end decay la_L; the last of a (batch, head)'s blocks to
//     finish (an atomic count, after a __threadfence) chains them in chunk
//     order, S_{c+1} = exp(la_L,c) S_c + dS_c, so the sum is the same in
//     every run: no float atomics.  It writes each start state already
//     split into the two bf16 planes the next kernel multiplies.
//     ssd_out_kernel, one block per (batch, head, chunk), then computes
//     the chunk's output from its inputs and its start state S_c:
//         y_i = exp(la_i) C_i·S_cᵀ + Σ_{j ≤ i} (C_i·B_j) exp(la_i - la_j) dt_j x_j;
//   * stages its operands with cp.async, 16 bytes a copy, all of a block's
//     copies in flight at once while the log-decay is computed, and writes
//     y through shared memory in 16-byte row pieces (load-then-store
//     staging loops and 2-byte scattered stores of y each cost more than
//     the arithmetic);
//   * runs every product on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 sums), with fragments read by ldmatrix as the flash kernel reads
//     them.  bf16 x, B and C go in as they are.  An fp32 operand (the
//     masked decay matrix, the state, w∘x, and x, B, C of an fp32 call) is
//     split into two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), which
//     carry v to 2^-17 of itself; each product takes the terms whose
//     order sums to at most one (hi·hi, hi·lo, lo·hi), so the result stays
//     near fp32 rounding, where one bf16 rounding of the decay matrix
//     (2^-9) could cross the serving logit limit with no fault;
//   * keeps the masked decay matrix in registers, 16 rows a warp, as the
//     flash kernel keeps P: the C Bᵀ accumulators of 16 columns at a time
//     are decayed, masked *before* exp (for i < j, la_i - la_j > 0 can
//     overflow, and inf·0 would be NaN), split, and fed straight back as
//     the A fragments of the product with x;
//   * takes the log-decay cumsum as a warp scan (kL / 32 values a lane,
//     then shuffles) in one fixed order, in log2 units, so that each decay
//     is one exp2f;
//   * adds the skip term D_h x_i before it rounds y, where the reference
//     adds it outside its kernel (on this card four torch ops that moved
//     more bytes than the kernel does).
//
// Rows past the sequence load as zero (dt = 0 is a no-op step: the TPU
// kernel's padding, without a copy); B and C are read from group
// h / (h/g), not repeated in memory.  Columns are padded to 16 in shared
// memory (zeros), rows to LD = 16k + 8 elements so that ldmatrix rows
// spread over the banks.  p is at most 128 (the output accumulators live in
// registers); the shared memory of both kernels must fit a block
// (kernels/ssd.py: smem_bytes).
#include "common.cuh"

namespace {

using repro_cuda::Elem;
using repro_cuda::smem_u32;
using u16 = unsigned short;

constexpr int kL = 128;                 // chunk rows
constexpr int kWarps = kL / 16;         // 16 rows of a chunk a warp
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Ssd {
  int64_t b, s, h, p, g, n;
  int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg;
};

// bf16 inputs are exact as one bf16 term; fp32 inputs take two
template <typename T> struct Terms { static constexpr int k = 1; };
template <> struct Terms<float> { static constexpr int k = 2; };

__host__ __device__ inline int pad16(int64_t v) {
  return static_cast<int>((v + 15) / 16 * 16);
}

// Shared memory of each kernel, in bytes (kernels/ssd.py: smem_bytes).
// state: w∘x (2 terms, kL x LDP), B (terms x kL x LDN), la, dt, w.
// out: C and B (terms x kL x LDN each), x (terms x kL x LDP), the start
// state (2 terms, PP x LDN), la, dt.
inline size_t state_smem(int64_t p, int64_t n, int terms) {
  const size_t ldp = pad16(p) + 8, ldn = pad16(n) + 8;
  return 2 * (2 * kL * ldp + terms * kL * ldn) + 3 * sizeof(float) * kL;
}
inline size_t out_smem(int64_t p, int64_t n, int terms) {
  const size_t ldp = pad16(p) + 8, ldn = pad16(n) + 8;
  return 2 * (terms * (2 * kL * ldn + kL * ldp) + 2 * pad16(p) * ldn) +
         2 * sizeof(float) * kL;
}

__device__ __forceinline__ void ldsm_x4(const u16* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const u16* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(u16 lo, u16 hi) {
  return uint32_t(lo) | (uint32_t(hi) << 16);
}

// 16 bytes global -> shared, zeros where !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v = hi + lo to 2^-17 of v: hi = bf16(v), lo = bf16(v - hi) (v - hi is
// exact in fp32)
__device__ __forceinline__ void split(float v, u16& hi, u16& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(h)));
}

// Rows [0, kL) of a chunk of one (batch, head or group), row stride rs
// elements, columns [0, cols) contiguous, into shared rows of ld elements,
// zeros past `left` rows and `cols` columns up to colsp (a multiple of
// 16).  vec (bf16, 16-byte aligned rows, cols a multiple of 8): by
// cp.async, the caller waits.  Otherwise element by element, into TERMS
// bf16 planes `plane` elements apart.
template <typename T, int TERMS>
__device__ __forceinline__ void stage(u16* dst, int plane, int ld,
                                      const typename Elem<T>::Raw* src,
                                      int64_t rs, int64_t left, int cols,
                                      int colsp, bool vec) {
  if (vec) {
    const u16* s16 = reinterpret_cast<const u16*>(src);
    const int cc = colsp / 8;
    for (int i = threadIdx.x; i < kL * cc; i += kThreads) {
      const int r = i / cc, c = (i - r * cc) * 8;
      const bool ok = r < left && c < cols;
      cp16(dst + r * ld + c, ok ? s16 + r * rs + c : s16, ok);
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < kL * colsp; i += kThreads) {
    const int r = i / colsp, c = i - r * colsp;
    const float v =
        (r < left && c < cols) ? Elem<T>::get(src[r * rs + c]) : 0.0f;
    u16 hi, lo;
    split(v, hi, lo);
    dst[r * ld + c] = hi;
    if (TERMS > 1) dst[plane + r * ld + c] = lo;
  }
}

// w∘x of a chunk (w per row) into two bf16 planes: every load of a thread
// is issued before any is used (vec: 8 bf16 a load).
template <typename T>
__device__ __forceinline__ void stage_wx(u16* dst, int plane, int ld,
                                         const typename Elem<T>::Raw* src,
                                         int64_t rs, int64_t left, int cols,
                                         int colsp, const float* w, bool vec) {
  if (vec) {
    union Pack { uint4 v; u16 e[8]; };
    const u16* s16 = reinterpret_cast<const u16*>(src);
    const int cc = colsp / 8;
    constexpr int kMax = kL * 128 / 8 / kThreads;   // colsp <= 128
    Pack in[kMax];
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / cc, c = (i - r * cc) * 8;
      in[u].v = make_uint4(0, 0, 0, 0);
      if (i < kL * cc && r < left && c < cols)
        in[u].v = *reinterpret_cast<const uint4*>(s16 + r * rs + c);
    }
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i >= kL * cc) break;
      const int r = i / cc, c = (i - r * cc) * 8;
      Pack hi, lo;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        split(Elem<__nv_bfloat16>::get(in[u].e[k]) * w[r], hi.e[k], lo.e[k]);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = hi.v;
      *reinterpret_cast<uint4*>(dst + plane + r * ld + c) = lo.v;
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < kL * colsp; i += kThreads) {
    const int r = i / colsp, c = i - r * colsp;
    const float v =
        (r < left && c < cols) ? Elem<T>::get(src[r * rs + c]) * w[r] : 0.0f;
    u16 hi, lo;
    split(v, hi, lo);
    dst[r * ld + c] = hi;
    dst[plane + r * ld + c] = lo;
  }
}

// dt of the chunk's rows (0 past the sequence), then (warp 0) the
// inclusive log-decay in log2 units, la_i = Σ_{j ≤ i} dt_j A log2(e), so
// that each decay is one exp2f: kL / 32 rows a lane in order, then an
// inclusive scan of the lanes' sums by shuffles.  Ends synchronized.
__device__ __forceinline__ void log_decay(const float* dt, const Ssd& a,
                                          int64_t b0, int64_t hh, int64_t c0,
                                          int64_t left, float av, float* dts,
                                          float* la) {
  for (int i = threadIdx.x; i < kL; i += kThreads)
    dts[i] = i < left ? dt[b0 * a.db + (c0 + i) * a.ds + hh * a.dh] : 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[kL / 32], run = 0.0f;
#pragma unroll
    for (int k = 0; k < kL / 32; ++k) {
      run += dts[lane * (kL / 32) + k] * av;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int k = 0; k < kL / 32; ++k) la[lane * (kL / 32) + k] = excl + v[k];
  }
  __syncthreads();
}

// ds (fp32): b·h·(chunks - 1) slots of PP x NP, each chunk's state change
// (zeros in the padding); st (bf16 planes): the same slots as [2][PP][NP],
// hi then lo, slot c the state at the start of chunk c + 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const typename Elem<T>::Raw* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const typename Elem<T>::Raw* __restrict__ B,
                 float* __restrict__ ds, u16* __restrict__ st,
                 float* __restrict__ decay, int* __restrict__ count, Ssd a,
                 int vec) {
  constexpr int TERMS = Terms<T>::k;
  extern __shared__ __align__(16) u16 sm[];
  __shared__ int last;
  const int p = static_cast<int>(a.p), n = static_cast<int>(a.n);
  const int PP = pad16(p), NP = pad16(n), LDP = PP + 8, LDN = NP + 8;
  u16* wx = sm;                          // 2 x kL x LDP
  u16* bsm = wx + 2 * kL * LDP;          // TERMS x kL x LDN
  float* la = reinterpret_cast<float*>(bsm + TERMS * kL * LDN);
  float* dts = la + kL;
  float* wj = dts + kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t hh = blockIdx.x, c = blockIdx.y, b0 = blockIdx.z;
  const int64_t nch1 = gridDim.y;        // every chunk but the last
  const int64_t gg = hh / (a.h / a.g);
  const int64_t c0 = c * kL, left = a.s - c0;
  const int64_t bh = b0 * a.h + hh;

  stage<T, TERMS>(bsm, kL * LDN, LDN, B + b0 * a.bb + c0 * a.bs + gg * a.bg,
                  a.bs, left, n, NP, vec != 0);
  log_decay(dt, a, b0, hh, c0, left, A[hh] * kLog2e, dts, la);
  const float la_end = la[kL - 1];
  for (int i = tid; i < kL; i += kThreads)
    wj[i] = exp2f(la_end - la[i]) * dts[i];
  __syncthreads();
  stage_wx<T>(wx, kL * LDP, LDP, x + b0 * a.xb + c0 * a.xs + hh * a.xh,
              a.xs, left, p, PP, wj, vec != 0);
  cp_wait_all();
  __syncthreads();

  // dS (p x n) = (w∘x)ᵀ B in 16 x 16 tiles, a warp each in turn
  const int64_t plane = static_cast<int64_t>(PP) * NP;
  float* out = ds + (bh * nch1 + c) * plane;
  const int nnb = NP / 16, tiles = (PP / 16) * nnb;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int q0 = (tile / nnb) * 16, n0 = (tile % nnb) * 16;
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int j0 = 0; j0 < kL; j0 += 16) {
      uint32_t bf[TERMS][4];
#pragma unroll
      for (int tb = 0; tb < TERMS; ++tb)
        ldsm_x4_t(bsm + tb * kL * LDN +
                      (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + n0 +
                      (lane >> 4) * 8,
                  bf[tb]);
#pragma unroll
      for (int ta = 0; ta < 2; ++ta) {
        // A = (w∘x)ᵀ from its j-major rows: ldmatrix.trans of the 8 x 8
        // blocks (j0, q0), (j0, q0 + 8), (j0 + 8, q0), (j0 + 8, q0 + 8)
        uint32_t af[4];
        ldsm_x4_t(wx + ta * kL * LDP +
                      (j0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDP + q0 +
                      ((lane >> 3) & 1) * 8,
                  af);
#pragma unroll
        for (int tb = 0; tb < TERMS; ++tb) {
          if (ta + tb > 1) continue;
          mma(acc[0], af, bf[tb][0], bf[tb][1]);
          mma(acc[1], af, bf[tb][2], bf[tb][3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + g + 8 * (e >> 1), k = n0 + 8 * nt + 2 * t + (e & 1);
        out[q * NP + k] = acc[nt][e];
      }
  }
  if (tid == 0) decay[bh * nch1 + c] = la_end;

  // The last block of this (batch, head) to get here chains the states in
  // chunk order: slot c of st becomes the state at the start of chunk
  // c + 1, split into its bf16 planes (zeros in the padding).  The other
  // blocks' writes are seen through L2 after their fence.  Each thread
  // walks kE elements at once, so that their loads are in flight together.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + bh, 1) == nch1 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kE = 8;
  const float* dsb = ds + bh * nch1 * plane;
  u16* stb = st + bh * nch1 * 2 * plane;
  const float* dec = decay + bh * nch1;
  for (int e0 = tid; e0 < plane; e0 += kE * kThreads) {
    float run[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) run[k] = 0.0f;
    for (int64_t cc = 0; cc < nch1; ++cc) {
      const float d = exp2f(__ldcg(dec + cc));
      float v[kE];
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int e = e0 + k * kThreads;
        v[k] = e < plane ? __ldcg(dsb + cc * plane + e) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int e = e0 + k * kThreads;
        run[k] = fmaf(d, run[k], v[k]);
        if (e < plane) {
          u16 hi, lo;
          split(run[k], hi, lo);
          stb[(cc * 2) * plane + e] = hi;
          stb[(cc * 2 + 1) * plane + e] = lo;
        }
      }
    }
  }
}

template <typename T, int PMAX>
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const typename Elem<T>::Raw* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ A,
               const typename Elem<T>::Raw* __restrict__ B,
               const typename Elem<T>::Raw* __restrict__ C,
               const float* __restrict__ D, const u16* __restrict__ st,
               typename Elem<T>::Raw* __restrict__ y, Ssd a, int vec) {
  constexpr int TERMS = Terms<T>::k;
  extern __shared__ __align__(16) u16 sm[];
  const int p = static_cast<int>(a.p), n = static_cast<int>(a.n);
  const int PP = pad16(p), NP = pad16(n), LDP = PP + 8, LDN = NP + 8;
  u16* csm = sm;                         // TERMS x kL x LDN
  u16* bsm = csm + TERMS * kL * LDN;     // TERMS x kL x LDN
  u16* xsm = bsm + TERMS * kL * LDN;     // TERMS x kL x LDP
  u16* ssm = xsm + TERMS * kL * LDP;     // 2 x PP x LDN
  float* la = reinterpret_cast<float*>(ssm + 2 * PP * LDN);
  float* dts = la + kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t hh = blockIdx.x, c = blockIdx.y, b0 = blockIdx.z;
  const int64_t nch1 = gridDim.y - 1;
  const int64_t gg = hh / (a.h / a.g);
  const int64_t c0 = c * kL, left = a.s - c0;
  const int64_t bh = b0 * a.h + hh;

  // copies first, then the log-decay while they are in flight
  stage<T, TERMS>(csm, kL * LDN, LDN, C + b0 * a.cb + c0 * a.cs + gg * a.cg,
                  a.cs, left, n, NP, vec != 0);
  stage<T, TERMS>(bsm, kL * LDN, LDN, B + b0 * a.bb + c0 * a.bs + gg * a.bg,
                  a.bs, left, n, NP, vec != 0);
  stage<T, TERMS>(xsm, kL * LDP, LDP, x + b0 * a.xb + c0 * a.xs + hh * a.xh,
                  a.xs, left, p, PP, vec != 0);
  if (c > 0) {                           // the state at the chunk's start
    const u16* sp = st + (bh * nch1 + c - 1) * 2 * PP * NP;
    const int cc = NP / 8;
    for (int i = tid; i < 2 * PP * cc; i += kThreads) {
      const int r = i / cc, k = (i - r * cc) * 8;
      cp16(ssm + r * LDN + k, sp + r * NP + k, true);
    }
  }
  log_decay(dt, a, b0, hh, c0, left, A[hh] * kLog2e, dts, la);
  cp_wait_all();
  __syncthreads();

  const int i0 = warp * 16;
  const int npb = PP / 16, nkk = NP / 16;
  const int ri[2] = {i0 + g, i0 + g + 8};
  const float lai[2] = {la[ri[0]], la[ri[1]]};
  float acc[PMAX / 8][4];
#pragma unroll
  for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // inter-chunk: acc = exp(la_i) C_i·Sᵀ (rows wholly past the sequence
  // are skipped)
  if (c > 0 && i0 < left) {
    for (int kk = 0; kk < nkk; ++kk) {
      uint32_t ca[TERMS][4];
#pragma unroll
      for (int ta = 0; ta < TERMS; ++ta)
        ldsm_x4(csm + ta * kL * LDN + (i0 + (lane & 15)) * LDN + kk * 16 +
                    (lane >> 4) * 8,
                ca[ta]);
#pragma unroll
      for (int np = 0; np < PMAX / 16; ++np) {
        if (np >= npb) break;
#pragma unroll
        for (int ts = 0; ts < 2; ++ts) {
          uint32_t sf[4];
          ldsm_x4(ssm + ts * PP * LDN +
                      (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDN +
                      kk * 16 + ((lane >> 3) & 1) * 8,
                  sf);
#pragma unroll
          for (int ta = 0; ta < TERMS; ++ta) {
            if (ta + ts > 1) continue;
            mma(acc[2 * np], ca[ta], sf[0], sf[1]);
            mma(acc[2 * np + 1], ca[ta], sf[2], sf[3]);
          }
        }
      }
    }
    const float e0 = exp2f(lai[0]), e1 = exp2f(lai[1]);
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }

  // intra-chunk, 16 columns j at a time up to the diagonal block
  for (int j0 = 0; j0 <= (i0 < left ? i0 : -1); j0 += 16) {
    float sg[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sg[j][e] = 0.0f;
    for (int kk = 0; kk < nkk; ++kk) {   // G = C_i·B_j over n
      uint32_t ca[TERMS][4], bf[TERMS][4];
#pragma unroll
      for (int tr = 0; tr < TERMS; ++tr) {
        ldsm_x4(csm + tr * kL * LDN + (i0 + (lane & 15)) * LDN + kk * 16 +
                    (lane >> 4) * 8,
                ca[tr]);
        ldsm_x4(bsm + tr * kL * LDN +
                    (j0 + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 +
                    ((lane >> 3) & 1) * 8,
                bf[tr]);
      }
#pragma unroll
      for (int ta = 0; ta < TERMS; ++ta)
#pragma unroll
        for (int tb = 0; tb < TERMS; ++tb) {
          if (ta + tb > 1) continue;
          mma(sg[0], ca[ta], bf[tb][0], bf[tb][1]);
          mma(sg[1], ca[ta], bf[tb][2], bf[tb][3]);
        }
    }
    // M_ij = G_ij exp(la_i - la_j) dt_j for j <= i, else 0, the decay
    // masked before exp; split into the A fragments of M·x: element e of
    // column tile jt is row ri[e / 2], column j0 + 8 jt + 2t + e % 2
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        u16 hi[2], lo[2];
#pragma unroll
        for (int xk = 0; xk < 2; ++xk) {
          const int j = j0 + 8 * jt + 2 * t + xk;
          const bool in = j <= ri[hr];
          const float diff = in ? lai[hr] - la[j] : 0.0f;
          const float m = in ? sg[jt][2 * hr + xk] * (exp2f(diff) * dts[j])
                             : 0.0f;
          split(m, hi[xk], lo[xk]);
        }
        ph[jt * 2 + hr] = pack(hi[0], hi[1]);
        pl[jt * 2 + hr] = pack(lo[0], lo[1]);
      }
#pragma unroll
    for (int np = 0; np < PMAX / 16; ++np) {
      if (np >= npb) break;
#pragma unroll
      for (int tx = 0; tx < TERMS; ++tx) {
        uint32_t vf[4];
        ldsm_x4_t(xsm + tx * kL * LDP +
                      (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                      np * 16 + (lane >> 4) * 8,
                  vf);
        mma(acc[2 * np], ph, vf[0], vf[1]);
        mma(acc[2 * np + 1], ph, vf[2], vf[3]);
        if (tx == 0) {
          mma(acc[2 * np], pl, vf[0], vf[1]);
          mma(acc[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
  }

  // the skip term D_h x_i: bf16 x from shared memory, where it is exact;
  // fp32 x from global memory, as it is (shared memory holds two terms)
  if (D != nullptr) {
    const float dh = D[hh];
    const typename Elem<T>::Raw* xb = x + b0 * a.xb + c0 * a.xs + hh * a.xh;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (ri[hr] >= left) continue;
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
        for (int xk = 0; xk < 2; ++xk) {
          const int q = 8 * j + 2 * t + xk;
          if (q >= p) continue;
          const float xv =
              TERMS == 1
                  ? Elem<__nv_bfloat16>::get(xsm[ri[hr] * LDP + q])
                  : Elem<T>::get(xb[ri[hr] * a.xs + q]);
          acc[j][2 * hr + xk] += dh * xv;
        }
    }
  }

  // y through shared memory (x's rows, free once every warp is done), then
  // out in 16-byte row pieces where a row is a whole number of them
  using Raw = typename Elem<T>::Raw;
  Raw* ys = reinterpret_cast<Raw*>(xsm);  // kL x LDP
  __syncthreads();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
      for (int xk = 0; xk < 2; ++xk) {
        const int q = 8 * j + 2 * t + xk;
        if (q < PP) ys[ri[hr] * LDP + q] = Elem<T>::put(acc[j][2 * hr + xk]);
      }
  __syncthreads();
  const int rows = left < kL ? static_cast<int>(left) : kL;
  Raw* yb = y + ((b0 * a.s + c0) * a.h + hh) * a.p;
  const int64_t yrs = a.h * a.p;         // elements from one row to the next
  constexpr int kV = 16 / sizeof(Raw);
  if ((p % kV) == 0) {
    const int cpr = p / kV;
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, q = (i - r * cpr) * kV;
      *reinterpret_cast<uint4*>(yb + r * yrs + q) =
          *reinterpret_cast<const uint4*>(ys + r * LDP + q);
    }
  } else {
    for (int i = tid; i < rows * p; i += kThreads) {
      const int r = i / p, q = i - r * p;
      yb[r * yrs + q] = ys[r * LDP + q];
    }
  }
}

inline bool bad_shape(const Ssd& a) {
  return a.g <= 0 || a.h % a.g != 0 || a.p > 128 || a.h > 2147483647 ||
         a.b > 65535 || (a.s + kL - 1) / kL > 65535;
}

template <typename T>
int launch_state(const void* x, const void* dt, const void* A, const void* B,
                 void* ds, void* st, void* decay, void* count, const Ssd& a,
                 int vec, void* stream) {
  using Raw = typename Elem<T>::Raw;
  const int64_t nch = (a.s + kL - 1) / kL;
  if (a.b <= 0 || a.h <= 0 || nch < 2 || a.p <= 0 || a.n <= 0)
    return static_cast<int>(cudaSuccess);
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = state_smem(a.p, a.n, Terms<T>::k);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(a.h), static_cast<unsigned>(nch - 1),
            static_cast<unsigned>(a.b));
  ssd_state_kernel<T><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const Raw*>(B),
      static_cast<float*>(ds), static_cast<u16*>(st),
      static_cast<float*>(decay), static_cast<int*>(count), a, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PMAX>
cudaError_t launch_out_p(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, const void* D,
                         const void* st, void* y, const Ssd& a, int vec,
                         dim3 grid, size_t smem, cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_out_kernel<T, PMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_out_kernel<T, PMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const Raw*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const Raw*>(B),
      static_cast<const Raw*>(C), static_cast<const float*>(D),
      static_cast<const u16*>(st), static_cast<Raw*>(y), a, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_out(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, const void* st, void* y,
               const Ssd& a, int vec, void* stream) {
  if (a.b <= 0 || a.h <= 0 || a.s <= 0 || a.p <= 0 || a.n <= 0)
    return static_cast<int>(cudaSuccess);
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nch = (a.s + kL - 1) / kL;
  const size_t smem = out_smem(a.p, a.n, Terms<T>::k);
  dim3 grid(static_cast<unsigned>(a.h), static_cast<unsigned>(nch),
            static_cast<unsigned>(a.b));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      a.p <= 64
          ? launch_out_p<T, 64>(x, dt, A, B, C, D, st, y, a, vec, grid, smem,
                                s)
          : launch_out_p<T, 128>(x, dt, A, B, C, D, st, y, a, vec, grid,
                                 smem, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  x (b, s, h, p),
// B and C (b, s, g, n) in x's dtype, each with strides (batch, position,
// head or group) in elements and a contiguous last axis; dt (b, s, h) with
// its three strides and A (h,), float32; D (h,) float32 or NULL; y
// contiguous (b, s, h, p) in x's dtype, with the D term where D is given.
// With chunks = ceil(s / 128) and PP, NP = p, n rounded up to 16: ds
// holds b·h·(chunks - 1)·PP·NP floats, st b·h·(chunks - 1)·2·PP·NP bf16
// (16-byte aligned), decay b·h·(chunks - 1) floats, count b·h int32
// zeros.  vec: bf16 operands with 16-byte aligned
// rows and p, n multiples of 8.  repro_ssd_state_* launches nothing for
// one chunk.  Each returns cudaGetLastError() after its launch (0 =
// launched).
#define REPRO_SSD_ENTRY(SUFFIX, T)                                           \
  int repro_ssd_state_##SUFFIX(                                              \
      const void* x, const void* dt, const void* A, const void* B, void* ds, \
      void* st, void* decay, void* count, int64_t b, int64_t s, int64_t h,   \
      int64_t p, int64_t g, int64_t n, int64_t xb, int64_t xs, int64_t xh,   \
      int64_t db, int64_t ds_, int64_t dh, int64_t bb, int64_t bs,          \
      int64_t bg, int64_t cb, int64_t cs, int64_t cg, int vec,               \
      void* stream) {                                                        \
    const Ssd a = {b, s, h, p, g, n, xb, xs, xh, db, ds_, dh,               \
                   bb, bs, bg, cb, cs, cg};                                  \
    return launch_state<T>(x, dt, A, B, ds, st, decay, count, a, vec,        \
                           stream);                                          \
  }                                                                          \
  int repro_ssd_out_##SUFFIX(                                                \
      const void* x, const void* dt, const void* A, const void* B,           \
      const void* C, const void* D, const void* st, void* y, int64_t b,      \
      int64_t s,                                                             \
      int64_t h, int64_t p, int64_t g, int64_t n, int64_t xb, int64_t xs,    \
      int64_t xh, int64_t db, int64_t ds_, int64_t dh, int64_t bb,          \
      int64_t bs, int64_t bg, int64_t cb, int64_t cs, int64_t cg, int vec,   \
      void* stream) {                                                        \
    const Ssd a = {b, s, h, p, g, n, xb, xs, xh, db, ds_, dh,               \
                   bb, bs, bg, cb, cs, cg};                                  \
    return launch_out<T>(x, dt, A, B, C, D, st, y, a, vec, stream);          \
  }

extern "C" {
REPRO_SSD_ENTRY(f32, float)
REPRO_SSD_ENTRY(bf16, __nv_bfloat16)
}  // extern "C"
