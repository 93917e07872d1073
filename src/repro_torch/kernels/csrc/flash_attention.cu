// Flash attention and flash decode for the NVIDIA H100 (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
// flash_attention (:96, launched at :113, body _flash_body :35) and
// decode_attention (:196, launched at :212, body _decode_body :146).  Both
// keep the online-softmax statistics m, l and the fp32 accumulator on the
// chip across a sequential kv grid axis, skip kv blocks that are wholly
// masked, and pad D to 128 lanes and the sequences to their blocks.
//
// Bound on this card.  Prefill attention does 4·B·H·Sq·Sk·D operations
// (halved under causal order) against (2·B·Sq·H + 2·B·Sk·Hkv)·D elements
// moved: at zamba2's prefill (B 4, H 32, S 512, D 128, bf16, causal)
// 4.3 GFLOP of visible pairs against 67 MB, so the bytes bound it: 20 us
// at 3.35 TB/s, against 4.4 us of operations at the bf16 tensor-core
// rate.  Decode reads the valid prefix of the cache once per step and does
// 4 operations per cached element: the bytes bound it (at B 4, 528 valid
// of S 544 slots, Hkv 32, D 128, bf16: 34.6 MB, 10.3 us at the 3.35 TB/s
// of the H100 SXM data sheet, 700 W).
//
// Design for those bounds:
//  * flash, bfloat16: tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    sums), FlashAttention-2's shape.  One block per (b, h, 64 query
//    rows), four warps of 16 rows.  Q (64 x D) and a double-buffered ring
//    of 32-key K and V tiles stay bf16 in shared memory, filled by
//    cp.async (16-byte chunks, rows past the end zero-filled) while the
//    previous tile is multiplied; rows are padded by 16 bytes so ldmatrix
//    reads hit distinct banks.  D is padded with zeros to its bucket (64,
//    128 or 256; the kernel is templated on it to hold registers), so
//    every D <= 256 goes through the tensor cores; k-steps that lie
//    wholly in the padding are skipped.  S = Q Kᵀ comes out in mma
//    accumulator fragments, where the scale, the softcap, the causal and
//    window masks (-1e30, on the tiles that cross a mask's edge only) and
//    the online max and sum (quad shuffles) are applied in log2 units
//    (exp2f); P is rounded to bf16 in registers as the A operand of P·V;
//    O stays an fp32 accumulator in registers.  mma.sync rather than
//    wgmma: its 16-row fragments keep the D buckets, the masked strided
//    loads and the per-row softmax simple; wgmma is later work.
//  * flash, float32: fp32 FMA (SIMT), kept so that fp32 stays fp32 (the
//    tensor cores would round it to TF32).  One block per (b, h, 32 query
//    rows), eight warps of four rows; kv tiles of 32 keys staged in
//    shared memory as fp32 (K rows padded by one float, so the 32 lanes
//    that read 32 different keys hit 32 banks).  Lane j scores key j
//    against the warp's four rows at once, the warp reduces max and sum
//    by shuffles, and p·V runs over lanes along D.
//  * Both flash kernels visit only the kv tiles the causal order and the
//    window leave visible; the rest are never loaded.
//  * decode: flash-decoding.  The host's plan (decode_plan) cuts each
//    row's S slots into splits from the shapes alone, so that b * h *
//    splits blocks put about two on each SM.  A block clips its split
//    to the row's valid range [max(0, len - window), len), with len read
//    from device memory (no scalar prefetch), and reads no key outside
//    it.  K and V rows come in as 16-byte vectors: the lanes of a key's
//    row (16 for a 256-byte bf16 row, so two keys a warp instruction)
//    each hold one chunk (two of a 1024-byte fp32 row), and a dot ends
//    in a butterfly over those lanes only, U keys' side by side.  The next tile's K and V
//    loads are issued together before this tile's dots and softmax, so
//    V never waits on the softmax.  Each lane group keeps its own online
//    softmax; the groups merge in shared memory and the split's (m, l,
//    acc) goes in fp32 to a workspace; a second kernel merges the splits
//    in split order and rounds once, so two runs agree bitwise.  Rows
//    that are not whole 16-byte chunks on 16 bytes are read element by
//    element in the same layout.
// Masked logits are -1e30 and their probabilities exactly 0, a zero row
// sum divides by 1, as in the TPU kernels; every division is IEEE and the
// fp32 SIMT flash kernel's exp too (no fast math); the tensor-core flash
// and decode use exp2f (2 ulp) in log2 units.
#include <type_traits>

#include "common.cuh"

namespace {

using repro_cuda::Elem;

constexpr float kNeg = -1e30f;
constexpr int kMaxChunks = 8;          // D <= 256: eight lanes-wide chunks
constexpr unsigned kFull = 0xffffffffu;

// flash
constexpr int kWarps = 8;
constexpr int kRows = 4;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile, one per lane

struct Strides {
  int64_t b, s, h;
};

struct Attn {
  int64_t b, h, hkv, sq, sk, d;
  Strides q, k, v;
  int causal;
  int64_t window;                      // < 0: none
  int has_softcap;
  float softcap, scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float logit(float dot, const Attn& a) {
  float s = dot * a.scale;
  return a.has_softcap ? a.softcap * tanhf(s / a.softcap) : s;
}

inline size_t flash_smem_bytes(int64_t d) {
  return sizeof(float) * static_cast<size_t>(kBQ * d + kBK * (d + 1) +
                                             kBK * d);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const typename Elem<T>::Raw* __restrict__ q,
             const typename Elem<T>::Raw* __restrict__ k,
             const typename Elem<T>::Raw* __restrict__ v,
             typename Elem<T>::Raw* __restrict__ o, Attn a) {
  extern __shared__ float smem[];
  const int d = static_cast<int>(a.d);
  float* qs = smem;                    // kBQ x d
  float* ks = qs + kBQ * d;            // kBK x (d + 1)
  float* vs = ks + kBK * (d + 1);      // kBK x d
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kh = hh / (a.h / a.hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t q_off = a.sk - a.sq;   // query i sits at position q_off + i
  const int nc = (d + 31) / 32;

  for (int i = tid; i < kBQ * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int64_t qi = q0 + r;
    qs[i] = qi < a.sq ? Elem<T>::get(q[bb * a.q.b + qi * a.q.s +
                                       hh * a.q.h + c])
                      : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kMaxChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[r][c] = 0.0f;
  }

  // keys this block can see: [kbeg, kend)
  const int64_t last = (q0 + kBQ < a.sq ? q0 + kBQ : a.sq) - 1;
  int64_t kend = a.sk;
  if (a.causal && q_off + last + 1 < kend) kend = q_off + last + 1;
  int64_t kbeg = 0;
  if (a.window >= 0 && q_off + q0 - a.window + 1 > 0)
    kbeg = q_off + q0 - a.window + 1;

  for (int64_t k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < kBK * d; i += blockDim.x) {
      const int j = i / d, c = i - j * d;
      const int64_t kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < a.sk) {
        kv = Elem<T>::get(k[bb * a.k.b + kj * a.k.s + kh * a.k.h + c]);
        vv = Elem<T>::get(v[bb * a.v.b + kj * a.v.s + kh * a.v.h + c]);
      }
      ks[j * (d + 1) + c] = kv;
      vs[j * d + c] = vv;
    }
    __syncthreads();

    // lane scores key k0 + lane against the warp's rows
    float dot[kRows] = {};
    const float* krow = ks + lane * (d + 1);
    const float* qrow = qs + warp * kRows * d;
    for (int c = 0; c < d; ++c) {
      const float kv = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot[r] = fmaf(qrow[r * d + c], kv,
                                                     dot[r]);
    }
    const int64_t kj = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t qpos = q_off + q0 + warp * kRows + r;
      bool ok = kj < a.sk;
      if (a.causal) ok = ok && qpos >= kj;
      if (a.window >= 0) ok = ok && qpos - kj < a.window;
      const float s = ok ? logit(dot[r], a) : kNeg;
      const float m_new = fmaxf(m[r], warp_max(s));
      p[r] = ok ? expf(s - m_new) : 0.0f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      float vv[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int dd = c * 32 + lane;
        vv[c] = (c < nc && dd < d) ? vs[j * d + dd] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) acc[r][c] = fmaf(pj, vv[c],
                                                              acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t qi = q0 + warp * kRows + r;
    if (qi >= a.sq) continue;
    const float div = l[r] == 0.0f ? 1.0f : l[r];
    typename Elem<T>::Raw* orow = o + ((bb * a.sq + qi) * a.h + hh) * d;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int dd = c * 32 + lane;
      if (c < nc && dd < d) orow[dd] = Elem<T>::put(acc[r][c] / div);
    }
  }
}

// ---------------------------------------------------------------------------
// decode, split across blocks (flash-decoding)
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of a K or V row, kept raw until used: 4 fp32 or 8 bf16
// elements.  gather reads the first `valid` one by one (zeros after), for
// rows that are not whole 16-byte chunks on 16 bytes.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ uint4 gather(const float* p, int valid) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = i < valid ? __float_as_uint(p[i]) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void cvt(uint4 u, float (&o)[N]) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ uint4 gather(const unsigned short* p,
                                                 int valid) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < valid ? unsigned(p[2 * i]) : 0u) |
             (2 * i + 1 < valid ? unsigned(p[2 * i + 1]) << 16 : 0u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void cvt(uint4 u, float (&o)[N]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // bf16 -> fp32 is exact: shift
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// A row bucket of RB bytes (D * itemsize rounded up to 128, 256, 512 or
// 1024) is C = RB / 16 chunks: LPK = min(C, 32) lanes hold one key's row,
// CPL = C / LPK chunks each, so a warp covers KPW = 32 / LPK keys a load
// instruction, and U such loads of K and of V are issued at once.
template <typename T, int RB>
struct Shape {
  static constexpr int C = RB / 16;
  static constexpr int LPK = C < 32 ? C : 32;
  static constexpr int CPL = C / LPK;
  static constexpr int KPW = 32 / LPK;
  static constexpr int EPC = Chunk<T>::N;
  static constexpr int U = CPL == 1 ? 4 : 2;
  static constexpr int kTile = kWarps * KPW * U;  // keys a block tile
  static constexpr int kGroups = kWarps * KPW;    // online softmaxes
  static constexpr int kCols = C * EPC;           // row elements
};

// The partial state of split s of row (b, h) in ws: m (log2 units), l,
// then acc[0..d), for splits in order.
template <typename F>
__device__ __forceinline__ F* partial(F* ws, int64_t bh, int64_t splits,
                                      int64_t s, int d) {
  return ws + (bh * splits + s) * (d + 2);
}

// Block (s, h, b): slots [s ks, (s + 1) ks) of row b's cache, clipped to
// its valid range [max(0, len - window), len) with len read from device
// memory; no key outside it is read.  Lane group g (LPK lanes) of warp w
// takes key t0 + (u kWarps + w) KPW + g of each tile t0 with its own
// online softmax, the lanes along the row; the next tile's K and V loads
// are issued before this tile's dots and softmax.  The groups merge in
// shared memory in a fixed order and the split's (m, l, acc) goes to ws;
// an empty split writes m = -1e30, l = 0, acc = 0.  VEC: rows of whole
// 16-byte chunks on 16 bytes; otherwise element by element.
template <typename T, int RB, bool VEC>
__global__ void __launch_bounds__(kThreads)
split_kernel(const typename Elem<T>::Raw* __restrict__ q,
             const typename Elem<T>::Raw* __restrict__ k,
             const typename Elem<T>::Raw* __restrict__ v,
             const int* __restrict__ lengths, float* __restrict__ ws, Attn a,
             int64_t ks) {
  using S = Shape<T, RB>;
  using Raw = typename Elem<T>::Raw;
  constexpr int U = S::U, CPL = S::CPL, EPC = S::EPC;
  __shared__ float gm[S::kGroups], gl[S::kGroups];
  __shared__ float gacc[S::kGroups][S::kCols];
  const int d = static_cast<int>(a.d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / S::LPK, li = lane % S::LPK;
  const int64_t sp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kh = hh / (a.h / a.hkv);

  int64_t hi = lengths[bb];
  hi = hi < 0 ? 0 : (hi > a.sk ? a.sk : hi);
  int64_t lo = 0;
  if (a.window >= 0 && hi - a.window > 0) lo = hi - a.window;
  const int64_t s_lo = sp * ks;
  const int64_t r_lo = lo > s_lo ? lo : s_lo;
  const int64_t r_hi = hi < s_lo + ks ? hi : s_lo + ks;

  // this lane's elements: chunk li + c LPK of the row, c < CPL
  float qv[CPL][EPC];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const int col = (li + c * S::LPK) * EPC + e;
      qv[c][e] = col < d ? Elem<T>::get(q[bb * a.q.b + hh * a.q.h + col])
                         : 0.0f;
    }
  const Raw* kb = k + bb * a.k.b + kh * a.k.h;
  const Raw* vb = v + bb * a.v.b + kh * a.v.h;
  const int chunks = (d + EPC - 1) / EPC;

  // K and V of tile t0 for this lane: zeros past r_hi (never loaded)
  auto load = [&](int64_t t0, uint4 (&kr)[U][CPL], uint4 (&vr)[U][CPL]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = t0 + (u * kWarps + warp) * S::KPW + grp;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = li + c * S::LPK;
        kr[u][c] = vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        if (j >= r_hi || ch >= chunks) continue;
        const Raw* kp = kb + j * a.k.s + ch * EPC;
        const Raw* vp = vb + j * a.v.s + ch * EPC;
        if (VEC) {
          kr[u][c] = __ldg(reinterpret_cast<const uint4*>(kp));
          vr[u][c] = __ldg(reinterpret_cast<const uint4*>(vp));
        } else {
          const int valid = d - ch * EPC;
          kr[u][c] = Chunk<T>::gather(kp, valid);
          vr[u][c] = Chunk<T>::gather(vp, valid);
        }
      }
    }
  };

  float m = kNeg, l = 0.0f, acc[CPL][EPC];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[c][e] = 0.0f;
  uint4 kr[U][CPL], vr[U][CPL];
  load(r_lo, kr, vr);
  for (int64_t t0 = r_lo; t0 < r_hi; t0 += S::kTile) {
    uint4 kn[U][CPL], vn[U][CPL];
    load(t0 + S::kTile, kn, vn);       // in flight during this tile
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float kf[EPC];
        Chunk<T>::cvt(kr[u][c], kf);
#pragma unroll
        for (int e = 0; e < EPC; ++e) dot = fmaf(qv[c][e], kf[e], dot);
      }
      s[u] = dot;
    }
    // each dot over its key's LPK lanes: U independent butterflies
#pragma unroll
    for (int o = S::LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(kFull, s[u], o);
    float mt = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = t0 + (u * kWarps + warp) * S::KPW + grp;
      s[u] = j < r_hi ? logit(s[u], a) * kLog2e : kNeg;
      mt = fmaxf(mt, s[u]);
    }
    const float alpha = exp2f(m - mt);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[c][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = t0 + (u * kWarps + warp) * S::KPW + grp;
      if (j >= r_hi) continue;
      const float p = exp2f(s[u] - mt);
      l += p;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float vf[EPC];
        Chunk<T>::cvt(vr[u][c], vf);
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[c][e] = fmaf(p, vf[e], acc[c][e]);
      }
    }
    m = mt;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        kr[u][c] = kn[u][c];
        vr[u][c] = vn[u][c];
      }
  }

  // merge the groups in group order
  const int g = warp * S::KPW + grp;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < EPC; ++e) gacc[g][(li + c * S::LPK) * EPC + e] =
        acc[c][e];
  if (li == 0) {
    gm[g] = m;
    gl[g] = l;
  }
  __syncthreads();
  float mx = kNeg;
  for (int i = 0; i < S::kGroups; ++i) mx = fmaxf(mx, gm[i]);
  float* out = partial(ws, bb * a.h + hh, gridDim.x, sp, d);
  if (threadIdx.x == 0) {
    float lsum = 0.0f;
    for (int i = 0; i < S::kGroups; ++i) lsum += gl[i] * exp2f(gm[i] - mx);
    out[0] = mx;
    out[1] = lsum;
  }
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float sum = 0.0f;
    for (int i = 0; i < S::kGroups; ++i)
      sum += gacc[i][col] * exp2f(gm[i] - mx);
    out[2 + col] = sum;
  }
}

// Block (h, b): the row's splits merged in split order, divided by the
// weight sum (by 1 where it is 0: a row with no valid key gives 0) and
// rounded once into o (b, 1, h, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, typename Elem<T>::Raw* o,
               int64_t splits, int d) {
  const int64_t bh = static_cast<int64_t>(blockIdx.y) * gridDim.x +
                     blockIdx.x;
  float mx = kNeg;
  for (int64_t s = 0; s < splits; ++s)
    mx = fmaxf(mx, partial(ws, bh, splits, s, d)[0]);
  float lsum = 0.0f;
  for (int64_t s = 0; s < splits; ++s) {
    const float* w = partial(ws, bh, splits, s, d);
    lsum += w[1] * exp2f(w[0] - mx);
  }
  const float div = lsum == 0.0f ? 1.0f : lsum;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float sum = 0.0f;
    for (int64_t s = 0; s < splits; ++s) {
      const float* w = partial(ws, bh, splits, s, d);
      sum += w[2 + col] * exp2f(w[0] - mx);
    }
    o[bh * d + col] = Elem<T>::put(sum / div);
  }
}

template <typename T, int RB>
cudaError_t launch_rb(const void* q, const void* k, const void* v,
                      const int* lengths, void* o, float* ws, const Attn& a,
                      int64_t splits, int64_t ks, bool vec,
                      cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(a.h),
                  static_cast<unsigned>(a.b));
  const Raw* rq = static_cast<const Raw*>(q);
  const Raw* rk = static_cast<const Raw*>(k);
  const Raw* rv = static_cast<const Raw*>(v);
  if (vec)
    split_kernel<T, RB, true><<<grid, kThreads, 0, stream>>>(rq, rk, rv,
                                                            lengths, ws, a, ks);
  else
    split_kernel<T, RB, false><<<grid, kThreads, 0, stream>>>(
        rq, rk, rv, lengths, ws, a, ks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<dim3(static_cast<unsigned>(a.h),
                           static_cast<unsigned>(a.b)),
                      kThreads, 0, stream>>>(ws, static_cast<Raw*>(o), splits,
                                             static_cast<int>(a.d));
  return cudaGetLastError();
}

// K and V rows are whole 16-byte chunks that start on 16 bytes
bool kv_aligned(const void* k, const void* v, const Attn& a, int itemsize) {
  const int64_t epc = 16 / itemsize;
  const int64_t st[6] = {a.k.b, a.k.s, a.k.h, a.v.b, a.v.s, a.v.h};
  bool ok = a.d % epc == 0;
  for (int64_t s : st) ok = ok && s % epc == 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  return ok && (bits & 15u) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* ws, const Attn& a, int64_t splits, int64_t ks,
           cudaStream_t stream) {
  constexpr int item = sizeof(typename Elem<T>::Raw);
  if (splits < 1 || splits > repro_cuda::kMaxBlocks || ks < 0 ||
      splits * ks < a.sk || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = kv_aligned(k, v, a, item);
  const int* lens = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  const int64_t rb = a.d * item;
  cudaError_t err;
  if (rb <= 128)
    err = launch_rb<T, 128>(q, k, v, lens, o, w, a, splits, ks, vec, stream);
  else if (rb <= 256)
    err = launch_rb<T, 256>(q, k, v, lens, o, w, a, splits, ks, vec, stream);
  else if (rb <= 512)
    err = launch_rb<T, 512>(q, k, v, lens, o, w, a, splits, ks, vec, stream);
  else if constexpr (item == 4)
    err = launch_rb<T, 1024>(q, k, v, lens, o, w, a, splits, ks, vec, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// flash, bfloat16, on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using u16 = unsigned short;
using bf16 = Elem<__nv_bfloat16>;

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;       // query rows per block, 16 a warp
constexpr int kThreads = 32 * kWarps;
// K/V tiles in the ring: a deeper ring costs blocks per SM (shared
// memory), which at zamba2's prefill cost more than the deeper prefetch
// gained
constexpr int kStages = 2;

constexpr float kLog2e = 1.4426950408889634f;

// 32-key tiles: 52 KB of shared memory at D 128 lets four blocks share an
// SM (64-key tiles: two, which ran slower at zamba2's prefill)
template <int DP>
struct Shape {
  static constexpr int BKV = 32;                  // keys per tile
  static constexpr int LD = DP + 8;               // shared row, elements
  static constexpr int kSmem = (kBQ + 2 * kStages * BKV) * LD * 2;  // Q, K, V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp16(u16* dst, const u16* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Stage rows [r0, r0 + R) of one head (row stride `ss` elements, D
// contiguous) into shared rows of LD elements; rows at or past `rows` are
// zeros.  VEC (D % 8 == 0, 16-byte-aligned rows): 16-byte chunks of
// columns [0, D) by cp.async, each thread the same chunks of every tile
// (the index arithmetic is shifts, the loop unrolled); columns [D, DP)
// were zeroed once.  Otherwise element by element, zeros from D to DP.
template <int DP, int R, bool VEC>
__device__ __forceinline__ void load_rows(u16* dst, const u16* src,
                                          int64_t ss, int64_t r0,
                                          int64_t rows, int d) {
  constexpr int LD = Shape<DP>::LD;
  if (VEC) {
    constexpr int kC = DP / 8;         // chunks of a padded row
    static_assert(R * kC % kThreads == 0, "whole passes");
    const u16* base = src + r0 * ss;
    const int chunks = d >> 3;
#pragma unroll
    for (int j = 0; j < R * kC / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kC, c = i % kC;
      if (c >= chunks) continue;       // the padding, zeroed once
      const bool in = r0 + r < rows;
      cp16(dst + r * LD + c * 8, in ? base + r * ss + c * 8 : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] =
          (r0 + r < rows && c < d) ? src[(r0 + r) * ss + c] : u16(0);
    }
  }
}

// One tile's scores to probabilities, for this thread's elements: e of
// tile j is row g + 8(e/2), key k0 + 8j + 2t + e%2.  The logits (scale,
// softcap) go to log2 units; where MASK, keys outside the causal order,
// the window or the sequence get -1e30 and probability 0 (interior tiles
// need no mask).  The rows' running max m (quad-reduced) gives alpha, the
// factor for the earlier sums, and p = 2^(s - m), rounded to bf16 into
// the A fragments of P·V and summed into lsum as rounded, so the
// normalisation divides by the weights that were multiplied.
template <int BKV, bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BKV / 8][4], const Attn& a, int k0, const int (&qpos)[2],
    int t, float (&m_run)[2], float (&alpha)[2], float (&lsum)[2],
    uint32_t (&pa)[BKV / 16][4]) {
  uint32_t ok_bits = 0xffffffffu;
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = logit(s[j][e], a) * kLog2e;
      if (MASK) {
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        bool ok = kj < a.sk;
        if (a.causal) ok = ok && qpos[h] >= kj;
        if (a.window >= 0) ok = ok && qpos[h] - kj < a.window;
        if (!ok) {
          x = kNeg;
          ok_bits &= ~(1u << (j * 4 + e));
        }
      }
      s[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    alpha[h] = exp2f(m_run[h] - mx[h]);
    m_run[h] = mx[h];
    lsum[h] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int h = e >> 1;
      u16 pb[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float p = (ok_bits >> (j * 4 + e + x)) & 1u
                            ? exp2f(s[j][e + x] - mx[h])
                            : 0.0f;
        pb[x] = bf16::put(p);
        lsum[h] += bf16::get(pb[x]);
      }
      // A fragment of k-step j/2: (row g, keys 2t..) in regs 0 and 2,
      // (row g + 8) in 1 and 3; odd tiles hold keys 8.. of the step
      pa[j >> 1][(j & 1) * 2 + h] = pack(pb[0], pb[1]);
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const u16* __restrict__ q, const u16* __restrict__ k,
                 const u16* __restrict__ v, u16* __restrict__ o, Attn a) {
  constexpr int BKV = Shape<DP>::BKV, LD = Shape<DP>::LD;
  extern __shared__ __align__(16) u16 sm[];
  u16* qs = sm;                        // kBQ x LD
  u16* ks = qs + kBQ * LD;             // kStages x BKV x LD
  u16* vs = ks + kStages * BKV * LD;   // kStages x BKV x LD
  const int d = static_cast<int>(a.d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kh = hh / (a.h / a.hkv);
  // positions fit in int (the launch checks sq and sk < 2^30)
  const int q0 = blockIdx.x * kBQ;
  const int sq = static_cast<int>(a.sq), sk = static_cast<int>(a.sk);
  const int q_off = sk - sq;           // query i sits at position q_off + i
  const u16* qb = q + bb * a.q.b + hh * a.q.h;
  const u16* kb = k + bb * a.k.b + kh * a.k.h;
  const u16* vb = v + bb * a.v.b + kh * a.v.h;

  // keys this block can see: [kbeg, kend), walked from a tile boundary
  const int last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  int kend = sk;
  if (a.causal && q_off + last + 1 < kend) kend = q_off + last + 1;
  int kbeg = 0;
  if (a.window >= 0 && q_off + q0 - a.window + 1 > 0)
    kbeg = static_cast<int>(q_off + q0 - a.window + 1);
  const int kstart = (kbeg / BKV) * BKV;

  if (VEC && d < DP) {                 // the zero padding of every row
    const int c0 = d >> 3, cn = DP / 8 - c0;
    for (int i = tid; i < (kBQ + 2 * kStages * BKV) * cn; i += kThreads) {
      const int r = i / cn, c = c0 + i % cn;
      *reinterpret_cast<uint4*>(sm + r * LD + c * 8) = make_uint4(0, 0, 0, 0);
    }
  }
  // Q with the first tile, then the ring's other slots but one, a group
  // each
  load_rows<DP, kBQ, VEC>(qs, qb, a.q.s, q0, a.sq, d);
  auto request = [&](int t0) {         // the tile at key t0, into its slot
    const int slot = (t0 - kstart) / BKV % kStages;
    if (t0 < kend) {
      load_rows<DP, BKV, VEC>(ks + slot * BKV * LD, kb, a.k.s, t0, a.sk, d);
      load_rows<DP, BKV, VEC>(vs + slot * BKV * LD, vb, a.v.s, t0, a.sk, d);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) request(kstart + i * BKV);

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.0f, 0.0f};
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = q_off + q0 + warp * 16 + g + 8 * h;

  for (int k0 = kstart; k0 < kend; k0 += BKV) {
    // the tile kStages - 1 ahead, into the slot of the tile before this
    // one (free: the block passed the barrier at that tile's end)
    request(k0 + (kStages - 1) * BKV);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    const int slot = (k0 - kstart) / BKV % kStages;
    const u16* kt = ks + slot * BKV * LD;
    const u16* vt = vs + slot * BKV * LD;

    // S = Q Kᵀ: 16 rows x BKV keys per warp
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 >= d) break;         // the rest is zero padding
      uint32_t qa[4];
      ldsm_x4(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8,
              qa);
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4(kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                    ((lane >> 3) & 1) * 8,
                kf);
        mma(s[2 * np], qa, kf[0], kf[1]);
        mma(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // a tile that every row of the block sees whole needs no mask
    const bool edge = k0 + BKV > sk ||
                      (a.causal && k0 + BKV - 1 > q_off + q0) ||
                      (a.window >= 0 &&
                       q_off + q0 + kBQ - 1 - k0 >= a.window);
    float alpha[2], lsum[2];
    uint32_t pa[BKV / 16][4];
    if (edge)
      softmax_tile<BKV, true>(s, a, k0, qpos, t, m_run, alpha, lsum, pa);
    else
      softmax_tile<BKV, false>(s, a, k0, qpos, t, m_run, alpha, lsum, pa);
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = alpha[h] * l_run[h] + lsum[h];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        if (dp * 16 >= d) break;
        uint32_t vf[4];
        ldsm_x4_t(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      dp * 16 + (lane >> 4) * 8,
                  vf);
        mma(acc[2 * dp], pa[kk], vf[0], vf[1]);
        mma(acc[2 * dp + 1], pa[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();                   // this slot is free again
  }

  // the row sums over their quads; a zero sum divides by 1
  float div[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    div[h] = l == 0.0f ? 1.0f : l;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    if (qi >= sq) continue;
    u16* orow = o + ((bb * a.sq + qi) * a.h + hh) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= d) break;
      const u16 y0 = bf16::put(acc[j][2 * h] / div[h]);
      const u16 y1 = bf16::put(acc[j][2 * h + 1] / div[h]);
      if ((d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack(y0, y1);
      } else {
        orow[c] = y0;
        if (c + 1 < d) orow[c + 1] = y1;
      }
    }
  }
}

template <int DP, bool VEC>
cudaError_t launch_dp(const u16* q, const u16* k, const u16* v, u16* o,
                      const Attn& a, dim3 grid, cudaStream_t stream) {
  static bool attr = false;            // set once per instantiation
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DP, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<DP>::kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  flash_mma_kernel<DP, VEC><<<grid, kThreads, Shape<DP>::kSmem, stream>>>(
      q, k, v, o, a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_vec(const u16* q, const u16* k, const u16* v, u16* o,
                       const Attn& a, dim3 grid, bool vec,
                       cudaStream_t stream) {
  return vec ? launch_dp<DP, true>(q, k, v, o, a, grid, stream)
             : launch_dp<DP, false>(q, k, v, o, a, grid, stream);
}

// Every row of q, k and v starts on 16 bytes and D is whole chunks
bool rows_aligned(const void* q, const void* k, const void* v,
                  const Attn& a) {
  const int64_t st[9] = {a.q.b, a.q.s, a.q.h, a.k.b, a.k.s,
                         a.k.h, a.v.b, a.v.s, a.v.h};
  bool ok = a.d % 8 == 0;
  for (int64_t s : st) ok = ok && s % 8 == 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  return ok && (bits & 15u) == 0;
}

int launch(const void* q_, const void* k_, const void* v_, void* o_,
           const Attn& a, cudaStream_t stream) {
  const int64_t tiles = (a.sq + kBQ - 1) / kBQ;
  if (a.sq >= (1 << 30) || a.sk >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(a.h),
                  static_cast<unsigned>(a.b));
  const bool vec = rows_aligned(q_, k_, v_, a);
  const u16* q = static_cast<const u16*>(q_);
  const u16* k = static_cast<const u16*>(k_);
  const u16* v = static_cast<const u16*>(v_);
  u16* o = static_cast<u16*>(o_);
  const cudaError_t err =
      a.d <= 64    ? launch_vec<64>(q, k, v, o, a, grid, vec, stream)
      : a.d <= 128 ? launch_vec<128>(q, k, v, o, a, grid, vec, stream)
                   : launch_vec<256>(q, k, v, o, a, grid, vec, stream);
  return static_cast<int>(err);
}

}  // namespace tc

Attn make_args(int64_t b, int64_t h, int64_t hkv, int64_t sq, int64_t sk,
               int64_t d, const int64_t* st, int causal, int64_t window,
               int has_softcap, float softcap, float scale) {
  Attn a;
  a.b = b; a.h = h; a.hkv = hkv; a.sq = sq; a.sk = sk; a.d = d;
  a.q = {st[0], st[1], st[2]};
  a.k = {st[3], st[4], st[5]};
  a.v = {st[6], st[7], st[8]};
  a.causal = causal; a.window = window;
  a.has_softcap = has_softcap; a.softcap = softcap; a.scale = scale;
  return a;
}

bool bad_shape(const Attn& a) {
  return a.b <= 0 || a.h <= 0 || a.hkv <= 0 || a.h % a.hkv != 0 ||
         a.d <= 0 || a.d > 32 * kMaxChunks || a.h > 65535 || a.b > 65535;
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const Attn& a, void* stream) {
  using Raw = typename Elem<T>::Raw;
  if (a.sq <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (a.sq + kBQ - 1) / kBQ;
  if (bad_shape(a) || a.sk < 0 || tiles > repro_cuda::kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!std::is_same<T, float>::value) {
    // bf16: the tensor-core kernel
    return tc::launch(q, k, v, o, a, static_cast<cudaStream_t>(stream));
  } else {
    const size_t smem = flash_smem_bytes(a.d);
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(a.h),
              static_cast<unsigned>(a.b));
    flash_kernel<T><<<grid, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Raw*>(q), static_cast<const Raw*>(k),
        static_cast<const Raw*>(v), static_cast<Raw*>(o), a);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  q (b, sq, h, d),
// k and v (b, sk, hkv, d), each with strides (batch, position, head) in
// elements and a contiguous last axis; o contiguous (b, sq, h, d); decode
// lengths (b,) int32 on the device, an fp32 workspace ws of b * h * splits
// * (d + 2) elements, and the cache cut into splits slices of ks slots
// (splits * ks >= sk).  window < 0 means none.  Each returns
// cudaGetLastError() after its launch (0 = launched).
#define REPRO_ATTN_ENTRY(SUFFIX, T)                                          \
  int repro_flash_attention_##SUFFIX(                                        \
      const void* q, const void* k, const void* v, void* o, int64_t b,       \
      int64_t h, int64_t hkv, int64_t sq, int64_t sk, int64_t d,             \
      int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,       \
      int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int causal,        \
      int64_t window, int has_softcap, float softcap, float scale,           \
      void* stream) {                                                        \
    const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};     \
    return launch_flash<T>(q, k, v, o,                                       \
                           make_args(b, h, hkv, sq, sk, d, st, causal,       \
                                     window, has_softcap, softcap, scale),   \
                           stream);                                          \
  }                                                                          \
  int repro_decode_attention_##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* lengths,      \
      void* o, void* ws, int64_t b, int64_t h, int64_t hkv, int64_t sq,      \
      int64_t sk, int64_t d, int64_t qsb, int64_t qss, int64_t qsh,          \
      int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,       \
      int64_t vsh, int64_t window, int has_softcap, float softcap,           \
      float scale, int64_t splits, int64_t ks, void* stream) {               \
    const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};     \
    const Attn a = make_args(b, h, hkv, sq, sk, d, st, 0, window,            \
                             has_softcap, softcap, scale);                   \
    if (bad_shape(a) || a.sq != 1 || a.sk < 0)                               \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return dec::launch<T>(q, k, v, lengths, o, ws, a, splits, ks,            \
                          static_cast<cudaStream_t>(stream));                \
  }

extern "C" {
REPRO_ATTN_ENTRY(f32, float)
REPRO_ATTN_ENTRY(bf16, __nv_bfloat16)
}  // extern "C"
