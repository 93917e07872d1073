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
// moved: at zamba2's prefill (B 4, H 32, S 512, D 128, bf16) 2.2 GFLOP
// against 34 MB, so the operations bound it, 2.2 us at the bf16 tensor-core
// rate.  Decode reads the valid prefix of the cache once per step and does
// 4 operations per cached element: the bytes bound it (at B 4, S 544,
// Hkv 32, D 128, bf16: 36 MB, 11 us).
//
// Design for those bounds, simple first (no tensor cores yet, fp32 FMA):
//  * flash: one block per (b, h, 32 query rows), eight warps of four rows;
//    kv tiles of 32 keys staged in shared memory as fp32 (K rows padded by
//    one float, so the 32 lanes that read 32 different keys hit 32 banks).
//    Lane j scores key j against the warp's four rows at once (one K load
//    feeds four FMAs), the warp reduces max and sum by shuffles, and p·V
//    runs over lanes along D, each lane holding D/32 accumulators per row
//    in registers.  Only the kv tiles the causal order and the window
//    leave visible are visited; the rest are never loaded.
//  * decode: one block per (b, h); eight warps take interleaved batches of
//    eight keys from the valid range [max(0, len - window), len), lanes
//    along D (eight independent loads in flight per lane), each warp with
//    its own online softmax; the eight states merge in shared memory.
//    The row's length comes from device memory (no scalar prefetch), and
//    no key outside the valid range is read.
// Masked logits are -1e30 and their probabilities exactly 0, a zero row
// sum divides by 1, exp and division are IEEE (no fast math), as in the
// TPU kernels.  Tensor cores (wgmma) and split-K decode are later work.
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
// decode
constexpr int kDecWarps = 8;
constexpr int kDecBatch = 8;           // keys per warp per step

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

template <typename T>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_kernel(const typename Elem<T>::Raw* __restrict__ q,
              const typename Elem<T>::Raw* __restrict__ k,
              const typename Elem<T>::Raw* __restrict__ v,
              const int* __restrict__ lengths,
              typename Elem<T>::Raw* __restrict__ o, Attn a) {
  __shared__ float part[kDecWarps][32 * kMaxChunks];
  __shared__ float wm[kDecWarps], wl[kDecWarps];
  const int d = static_cast<int>(a.d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t hh = blockIdx.x, bb = blockIdx.y;
  const int64_t kh = hh / (a.h / a.hkv);
  const int nc = (d + 31) / 32;

  int64_t hi = lengths[bb];
  hi = hi < 0 ? 0 : (hi > a.sk ? a.sk : hi);
  int64_t lo = 0;
  if (a.window >= 0 && hi - a.window > 0) lo = hi - a.window;

  float qv[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int dd = c * 32 + lane;
    qv[c] = (c < nc && dd < d)
                ? Elem<T>::get(q[bb * a.q.b + hh * a.q.h + dd])
                : 0.0f;
  }
  float m = kNeg, l = 0.0f, acc[kMaxChunks] = {};
  const typename Elem<T>::Raw* kb = k + bb * a.k.b + kh * a.k.h;
  const typename Elem<T>::Raw* vb = v + bb * a.v.b + kh * a.v.h;

  for (int64_t j0 = lo + static_cast<int64_t>(warp) * kDecBatch; j0 < hi;
       j0 += kDecWarps * kDecBatch) {
    float s[kDecBatch];
#pragma unroll
    for (int t = 0; t < kDecBatch; ++t) {
      const int64_t j = j0 + t;
      float dot = 0.0f;
      if (j < hi) {
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int dd = c * 32 + lane;
          if (c < nc && dd < d)
            dot = fmaf(qv[c], Elem<T>::get(kb[j * a.k.s + dd]), dot);
        }
      }
      s[t] = warp_sum(dot);
    }
    float mt = kNeg;
#pragma unroll
    for (int t = 0; t < kDecBatch; ++t) {
      s[t] = j0 + t < hi ? logit(s[t], a) : kNeg;
      mt = fmaxf(mt, s[t]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[c] *= alpha;
#pragma unroll
    for (int t = 0; t < kDecBatch; ++t) {
      const int64_t j = j0 + t;
      if (j >= hi) continue;
      const float p = expf(s[t] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int dd = c * 32 + lane;
        if (c < nc && dd < d)
          acc[c] = fmaf(p, Elem<T>::get(vb[j * a.v.s + dd]), acc[c]);
      }
    }
    l = alpha * l + psum;
    m = m_new;
  }

  // merge the warps' (m, l, acc)
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) part[warp][c * 32 + lane] = acc[c];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  float mx = kNeg;
  for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, wm[w]);
  float lsum = 0.0f;
  for (int w = 0; w < kDecWarps; ++w) lsum += wl[w] * expf(wm[w] - mx);
  const float div = lsum == 0.0f ? 1.0f : lsum;
  typename Elem<T>::Raw* orow = o + (bb * a.h + hh) * d;
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < kDecWarps; ++w)
      sum += part[w][dd] * expf(wm[w] - mx);
    orow[dd] = Elem<T>::put(sum / div);
  }
}

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

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lengths, void* o, const Attn& a,
                  void* stream) {
  using Raw = typename Elem<T>::Raw;
  if (bad_shape(a) || a.sq != 1 || a.sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(a.h), static_cast<unsigned>(a.b));
  decode_kernel<T><<<grid, kDecWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(k),
      static_cast<const Raw*>(v), static_cast<const int*>(lengths),
      static_cast<Raw*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  q (b, sq, h, d),
// k and v (b, sk, hkv, d), each with strides (batch, position, head) in
// elements and a contiguous last axis; o contiguous (b, sq, h, d); decode
// lengths (b,) int32 on the device.  window < 0 means none.  Each returns
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
      void* o, int64_t b, int64_t h, int64_t hkv, int64_t sq, int64_t sk,    \
      int64_t d, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,         \
      int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,       \
      int64_t window, int has_softcap, float softcap, float scale,           \
      void* stream) {                                                        \
    const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};     \
    return launch_decode<T>(q, k, v, lengths, o,                             \
                            make_args(b, h, hkv, sq, sk, d, st, 0, window,   \
                                      has_softcap, softcap, scale),          \
                            stream);                                         \
  }

extern "C" {
REPRO_ATTN_ENTRY(f32, float)
REPRO_ATTN_ENTRY(bf16, __nv_bfloat16)
}  // extern "C"
