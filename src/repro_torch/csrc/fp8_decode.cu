// Split-S (Flash-Decoding) GQA decode attention over a contiguous FP8 (or
// bf16) KV cache (kernel 6).
//
// Replaces `fp8_decode_attention` (repro/kernels/fp8_kv_attention.py:169,
// body `_decode_attn_kernel` :110).  q (B, KVH, G, D) bf16 attends over
// one layer's cache (B, S, KVH, D) — a base pointer plus the batch and
// sequence strides of the tensor, so a layer view of the stacked
// (R, B, S, KVH, D) cache needs no copy — masked by `lengths` (B,), with
// one f32 scale for K and one for V.  Dequantization is the TPU kernel's:
// `payload * scale` in f32, with no bf16 rounding (kernels 4 and 5 round
// like `_deq`; this one does not).  Scores are f32 dots times sm_scale,
// taken after the dot; the softmax is online, and a row of length 0 comes
// out as exact zeros.  The output is rounded to bf16 once.
//
// What bounds it on the H100: bytes.  Each live K/V element is read once
// (1 B at fp8) for 4 * G flop, far below the ridge; at B 1, S 524288,
// KVH 8, D 128 one layer reads 1.07 GB, 0.32 ms at 3.35 TB/s.  The TPU
// grid (B, KVH, S / BS) walks S in order on one core; on 132 SMs that
// would be B * KVH = 8 blocks.  So the S axis is split (Flash-Decoding):
// the grid is (B * KVH, n_split), and block (bh, s) walks keys
// [s * span, min((s + 1) * span, len)), reading `len` from the device
// (no host sync); a block whose span starts at or past `len` exits at
// once.  `n_split` and `span` come from the host, from S and the SM count
// only (never from the data), so a row's sum order is fixed for a given
// cache shape.
//
// Inside a block, each half-warp is one online-softmax stream: 16 lanes
// share a key, a lane owning kE = D / 16 consecutive elements of the head
// dim, loaded as one vector (a 128-byte row per key at D 128 fp8), so a
// score is kE FMAs and a 4-step shuffle sum per query row.  The eight
// streams of a block take kKeys consecutive keys each in turn, and load
// the next step's keys while they compute this one.  Loads are predicated
// on the key index, so a byte at or past `len` is never read (NaN there
// cannot reach the output).  Scores are kept in the log2 domain (dot *
// sm_scale * log2 e), so each exponential is one exp2.  The two streams
// of a warp merge by shuffles, the four warps in shared memory, and the
// block writes one partial (m, l, acc) per query row to a workspace; a
// second kernel merges the live splits of each row in split order and
// divides.  Offsets are 64-bit throughout: one layer at B 8, S 524288
// holds 4.3e9 elements.  No tensor cores or TMA yet.
#include "fp8_common.cuh"

namespace fp8rl {
namespace {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kLanesPerKey = 16;
constexpr int kStreams = kDecThreads / kLanesPerKey;   // online-softmax streams per block
constexpr float kDecNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int kKV> struct KVSize;
template <> struct KVSize<kE4M3> { static constexpr int kBytes = 1; };
template <> struct KVSize<kBF16> { static constexpr int kBytes = 2; };

// kE consecutive cache elements of one lane, loaded as one vector (two
// 16-byte loads at D 256 bf16)
template <int kBytes> struct alignas(kBytes > 16 ? 16 : kBytes) RawVec { uint8_t b[kBytes]; };

template <int kKV> __device__ __forceinline__ float raw_to_f32(const uint8_t* b, int e);
template <> __device__ __forceinline__ float raw_to_f32<kE4M3>(const uint8_t* b, int e) {
  return fp8_to_f32<kE4M3>(b[e]);
}
template <> __device__ __forceinline__ float raw_to_f32<kBF16>(const uint8_t* b, int e) {
  const uint32_t bits = static_cast<uint32_t>(b[2 * e]) | (static_cast<uint32_t>(b[2 * e + 1]) << 8);
  return __uint_as_float(bits << 16);
}

// sum over the 16 lanes of a half-warp (every lane of the warp calls it)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = kLanesPerKey / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// workspace layout: m (rows,) in the log2 domain, l (rows,), acc (rows, D);
// row = (bh * n_split + split) * G + g
struct Workspace {
  float* m;
  float* l;
  float* acc;
  __host__ __device__ Workspace(float* ws, int64_t rows) : m(ws), l(ws + rows), acc(ws + 2 * rows) {}
};

// keys per stream step: 4 for G <= 2, else 2, so that a step's scores
// (kKeys x G floats a lane) stay within 8
template <int kG> constexpr int kKeysFor = kG <= 2 ? 4 : 2;
// q and acc take 2 * G * kE floats a lane: small tiles are held to 128
// registers (4 blocks, 16 warps per SM to hide the loads' latency)
template <int kE, int kG> constexpr int kMinBlocksFor = kG * kE <= 32 ? 4 : (kG * kE <= 64 ? 2 : 1);

template <int kKV, int kE, int kG>
__global__ void __launch_bounds__(kDecThreads, (kMinBlocksFor<kE, kG>)) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_cache,
    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ lengths, float* ws_base,
    int64_t ws_rows, int s_max, int kvh, int g, int d, int64_t stride_b, int64_t stride_s,
    int n_split, int span, float sm_scale) {
  constexpr int kKeys = kKeysFor<kG>;
  constexpr int kElt = KVSize<kKV>::kBytes;
  constexpr int kStep = kStreams * kKeys;   // keys a block walks per step
  using Vec = RawVec<kE * kElt>;
  __shared__ float m_w[kDecWarps][kG], l_w[kDecWarps][kG];
  __shared__ float acc_w[kDecWarps][kG][kLanesPerKey * kE];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / kvh, h = bh % kvh;
  const int len = min(max(lengths[b], 0), s_max);
  const int s0 = split * span;
  if (s0 >= len) return;                 // the combine pass reads live splits only
  const int s1 = min(s0 + span, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int half = lane / kLanesPerKey, sub = lane % kLanesPerKey;
  const bool active = sub * kE < d;      // D % kE == 0: an active lane owns kE elements
  const float ks = *k_scale, vs = *v_scale;
  const float score_scale = sm_scale * kLog2e;

  float qr[kG][kE], acc[kG][kE], m[kG], l[kG];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    m[gi] = kDecNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      acc[gi][e] = 0.0f;
      qr[gi][e] = (gi < g && active)
          ? __bfloat162float(q[(static_cast<int64_t>(bh) * g + gi) * d + sub * kE + e])
          : 0.0f;
    }
  }

  // byte offset of this lane's elements of key 0 of head h, batch row b
  const int64_t lane0 = (static_cast<int64_t>(b) * stride_b + static_cast<int64_t>(h) * d +
                         sub * kE) * kElt;
  const int64_t key_bytes = stride_s * kElt;
  // a step of the warp covers keys [tw, tw + 2 * kKeys): half 0 the first
  // kKeys, half 1 the next.  The loop is warp-uniform (the shuffles need
  // all 32 lanes); a key at or past s1 is never loaded and weighs 0.
  const int first = half * kKeys;
  Vec kn[kKeys], vn[kKeys];
  auto load = [&](int tw) {
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int key = tw + first + j;
      if (key < s1 && active) {
        const int64_t off = lane0 + static_cast<int64_t>(key) * key_bytes;
        kn[j] = *reinterpret_cast<const Vec*>(k_cache + off);
        vn[j] = *reinterpret_cast<const Vec*>(v_cache + off);
      } else {
#pragma unroll
        for (int i = 0; i < kE * kElt; ++i) kn[j].b[i] = vn[j].b[i] = 0;
      }
    }
  };
  const int tw0 = s0 + warp * 2 * kKeys;
  load(tw0);
  for (int tw = tw0; tw < s1; tw += kStep) {
    const int nv = min(max(s1 - (tw + first), 0), kKeys);   // this half's valid keys
    Vec kr[kKeys], vr[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      kr[j] = kn[j];
      vr[j] = vn[j];
    }
    load(tw + kStep);                    // the next step's loads fly during this one
    float p[kKeys][kG];                  // scores, then probabilities
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float kf[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) kf[e] = __fmul_rn(raw_to_f32<kKV>(kr[j].b, e), ks);
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(qr[gi][e], kf[e], dot);
        p[j][gi] = half_warp_sum(dot) * score_scale;
      }
    }
    // online-softmax update over this half's nv valid keys: rescale acc
    // by alpha, then add each key's V row once (dequantized once)
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      float m_cur = kDecNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        if (j < nv) m_cur = fmaxf(m_cur, p[j][gi]);
      const float m_new = fmaxf(m[gi], m_cur);
      const float alpha = exp2f(m[gi] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        p[j][gi] = j < nv ? exp2f(p[j][gi] - m_new) : 0.0f;
        sum += p[j][gi];
      }
      l[gi] = l[gi] * alpha + sum;
      m[gi] = m_new;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[gi][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float vf = __fmul_rn(raw_to_f32<kKV>(vr[j].b, e), vs);
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) acc[gi][e] = fmaf(p[j][gi], vf, acc[gi][e]);
      }
    }
  }

  // merge the warp's two streams (half 0 keeps the result), then the four
  // warps.  A stream that saw no key holds m = -1e30, l = 0, acc = 0 and
  // weighs exp2(-1e30 - M) = 0; warp 0's first stream always saw one
  // (s0 < len).
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m[gi], kLanesPerKey);
    const float l_o = __shfl_xor_sync(0xffffffffu, l[gi], kLanesPerKey);
    const float mx = fmaxf(m[gi], m_o);
    const float a = exp2f(m[gi] - mx), a_o = exp2f(m_o - mx);
    l[gi] = l[gi] * a + l_o * a_o;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[gi][e], kLanesPerKey);
      acc[gi][e] = acc[gi][e] * a + acc_o * a_o;
    }
    m[gi] = mx;
  }
  if (half == 0) {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      if (sub == 0) {
        m_w[warp][gi] = m[gi];
        l_w[warp][gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) acc_w[warp][gi][sub * kE + e] = acc[gi][e];
    }
  }
  __syncthreads();
  Workspace ws(ws_base, ws_rows);
  const int64_t row0 = (static_cast<int64_t>(bh) * n_split + split) * g;
  for (int i = threadIdx.x; i < g * d; i += kDecThreads) {
    const int gi = i / d, dd = i % d;
    float mx = kDecNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_w[w][gi]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = exp2f(m_w[w][gi] - mx);
      a += acc_w[w][gi][dd] * wt;
      lsum += l_w[w][gi] * wt;
    }
    ws.acc[(row0 + gi) * d + dd] = a;
    if (dd == 0) {
      ws.m[row0 + gi] = mx;
      ws.l[row0 + gi] = lsum;
    }
  }
}

// out[bh, g, :] = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30)
// over the live splits s < ceil(len / span), summed in split order; no
// live split (len 0) gives exact zeros.  One block per (bh, g): the
// splits' weights go to shared memory once, then each thread sums one
// head-dim column over the splits with its loads unrolled (independent
// loads in flight, the sum still in split order).
__global__ void __launch_bounds__(kDecThreads) decode_combine_kernel(
    const float* ws_base, int64_t ws_rows, const int32_t* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int s_max, int kvh, int g, int d, int n_split, int span) {
  extern __shared__ float smem[];
  float* m_s = smem;                     // (n_split,) the splits' maxima
  float* w_s = smem + n_split;           // (n_split,) their weights 2^(m_s - M)
  float* l_s = smem + 2 * n_split;       // (n_split,) their denominators
  const int bh = blockIdx.x, gi = blockIdx.y, b = bh / kvh;
  const int len = min(max(lengths[b], 0), s_max);
  const int n_live = min(n_split, (len + span - 1) / span);
  Workspace ws(const_cast<float*>(ws_base), ws_rows);
  const int64_t row0 = static_cast<int64_t>(bh) * n_split * g + gi;   // split s: row0 + s * g
  for (int s = threadIdx.x; s < n_live; s += kDecThreads) {
    m_s[s] = ws.m[row0 + static_cast<int64_t>(s) * g];
    l_s[s] = ws.l[row0 + static_cast<int64_t>(s) * g];
  }
  __syncthreads();
  float mx = kDecNegInf;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, m_s[s]);
  for (int s = threadIdx.x; s < n_live; s += kDecThreads) w_s[s] = exp2f(m_s[s] - mx);
  __syncthreads();
  float lsum = 0.0f;
  for (int s = 0; s < n_live; ++s) lsum += l_s[s] * w_s[s];
  const float denom = fmaxf(lsum, 1e-30f);
  for (int dd = threadIdx.x; dd < d; dd += kDecThreads) {
    float a = 0.0f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) a += ws.acc[(row0 + static_cast<int64_t>(s) * g) * d + dd] * w_s[s];
    out[(static_cast<int64_t>(bh) * g + gi) * d + dd] = __float2bfloat16_rn(a / denom);
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths;
  void *out, *ws;
  int b, s_max, kvh, g, d;
  int64_t stride_b, stride_s;
  int n_split, span;
  float sm_scale;
  cudaStream_t stream;
};

template <int kKV, int kE, int kG>
int launch(const Args& a) {
  if constexpr (kG * kE > 128) {
    return static_cast<int>(cudaErrorInvalidValue);   // the wrapper refuses these
  } else {
    const int64_t rows = static_cast<int64_t>(a.b) * a.kvh * a.n_split * a.g;
    decode_split_kernel<kKV, kE, kG><<<dim3(a.b * a.kvh, a.n_split), kDecThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const uint8_t*>(a.k),
        static_cast<const uint8_t*>(a.v), static_cast<const float*>(a.k_scale),
        static_cast<const float*>(a.v_scale), static_cast<const int32_t*>(a.lengths),
        static_cast<float*>(a.ws), rows, a.s_max, a.kvh, a.g, a.d, a.stride_b, a.stride_s,
        a.n_split, a.span, a.sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_combine_kernel<<<dim3(a.b * a.kvh, a.g), kDecThreads,
                            3 * sizeof(float) * a.n_split, a.stream>>>(
        static_cast<const float*>(a.ws), rows, static_cast<const int32_t*>(a.lengths),
        static_cast<__nv_bfloat16*>(a.out), a.s_max, a.kvh, a.g, a.d, a.n_split, a.span);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int kKV, int kE>
int dispatch_g(const Args& a) {
  if (a.g <= 1) return launch<kKV, kE, 1>(a);
  if (a.g <= 2) return launch<kKV, kE, 2>(a);
  if (a.g <= 4) return launch<kKV, kE, 4>(a);
  if (a.g <= 8) return launch<kKV, kE, 8>(a);
  return launch<kKV, kE, 16>(a);
}

template <int kKV>
int dispatch_d(const Args& a) {
  if (a.d <= 16) return dispatch_g<kKV, 1>(a);
  if (a.d <= 32) return dispatch_g<kKV, 2>(a);
  if (a.d <= 64) return dispatch_g<kKV, 4>(a);
  if (a.d <= 128) return dispatch_g<kKV, 8>(a);
  return dispatch_g<kKV, 16>(a);
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// q (B, KVH, G, D) bf16; k/v one layer (B, S, KVH, D) e4m3|bf16 with
// element strides stride_b, stride_s (KVH and D dense), 16-byte aligned;
// scales () f32; lengths (B,) i32; ws f32 of B*KVH*n_split*G*(D+2) ->
// out (B, KVH, G, D) bf16.  G <= 16, D <= 256, D % 16 == 0,
// bucket(G) * ceil(D / 16) <= 128 (the wrapper checks); n_split is at most
// the SM count (`decode_splits`), so the combine's 3 floats per split fit in
// shared memory.  Two kernels, one call: the split pass, then the combine.
extern "C" int fp8rl_decode(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale, const void* lengths,
                            void* out, void* ws, int b, int s_max, int kvh, int g, int d,
                            int64_t stride_b, int64_t stride_s, int n_split, int span,
                            int kv_dtype, float sm_scale, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k_cache, v_cache, k_scale, v_scale, lengths, out, ws, b, s_max, kvh, g, d,
               stride_b, stride_s, n_split, span, sm_scale, static_cast<cudaStream_t>(stream)};
  if (kv_dtype == kE4M3) return dispatch_d<kE4M3>(a);
  return dispatch_d<kBF16>(a);
}
