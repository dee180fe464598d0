// Paged GQA decode attention over an FP8 (or bf16) KV pool (kernel 4).
//
// Replaces `fp8_paged_decode_attention` (repro/kernels/fp8_kv_attention.py
// :285, body `_paged_decode_attn_kernel` :236 with `_live_block_counts`
// :228, `_clamped_kv_map` :81, `_flash_update` :89 and `_deq` :73).
// q (B, KVH, G, D) bf16 attends over pools (N+1, BS, KVH, D) through
// per-slot tables (B, W) of physical rows, masked by `lengths` (B,), with
// one f32 scale per pool for K and for V.  Only the live table entries
// w < nb = clip(ceil(len / BS), 1, W) are ever read, so stale ids past a
// slot's context cannot reach the output.  An idle slot (len 0) outputs
// exact zeros.
//
// What bounds it on the H100: bytes — each live K/V row is read once
// (1 B/elt at fp8) for 4 * G flop per element, far below the ridge.  The
// design: one block per (slot, kv-head) loads its own table row and walks
// only its live blocks, dequantizing each K/V tile into shared memory the
// way `_deq` does (f32 multiply, then a bf16 rounding); the G query rows
// share every tile (GQA), and the online softmax state stays in f32.
// Split-KV (more blocks per slot for small B) is left for the PR that makes
// it fast.
#include "fp8_common.cuh"

namespace fp8rl {
namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;         // query rows per kv-head
constexpr int kMaxDPerThread = 2; // D <= 256
constexpr float kNegInf = -1e30f;

template <int kKV> __device__ __forceinline__ float kv_load(const void* p, int64_t i);
template <> __device__ __forceinline__ float kv_load<kE4M3>(const void* p, int64_t i) {
  return fp8_to_f32<kE4M3>(static_cast<const uint8_t*>(p)[i]);
}
template <> __device__ __forceinline__ float kv_load<kBF16>(const void* p, int64_t i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// `_deq`: (tile * scale) in f32, rounded to bf16, used as f32
__device__ __forceinline__ float deq(float v, float scale) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, scale)));
}

template <int kKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int kvh, int g, int d, int bs, int w, float sm_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // (G, D)
  float* k_s = q_s + g * d;          // (BS, D)
  float* v_s = k_s + bs * d;         // (BS, D)
  float* p_s = v_s + bs * d;         // (G, BS) scores, then probabilities
  float* m_s = p_s + g * bs;         // (G,) running max
  float* l_s = m_s + g;              // (G,) running denominator
  float* a_s = l_s + g;              // (G,) rescale factor of this tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int nwarps = blockDim.x / 32;
  const int b = blockIdx.x / kvh, h = blockIdx.x % kvh;
  const int len = lengths[b];
  const int nb = min(max((len + bs - 1) / bs, 1), w);   // `_live_block_counts`
  const float ks = *k_scale, vs = *v_scale;
  const int64_t q_off = (static_cast<int64_t>(b) * kvh + h) * g * d;

  for (int i = tid; i < g * d; i += blockDim.x) q_s[i] = __bfloat162float(q[q_off + i]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxG][kMaxDPerThread];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) acc[gi][j] = 0.0f;

  for (int blk = 0; blk < nb; ++blk) {
    const int64_t row = tables[static_cast<int64_t>(b) * w + blk];
    __syncthreads();  // previous tile fully consumed (and q/m/l initialized)
    for (int i = tid; i < bs * d; i += blockDim.x) {
      const int s = i / d, dd = i % d;
      const int64_t src = ((row * bs + s) * kvh + h) * d + dd;
      k_s[i] = deq(kv_load<kKV>(k_pool, src), ks);
      v_s[i] = deq(kv_load<kKV>(v_pool, src), vs);
    }
    __syncthreads();
    // scores (G, BS): one warp per (g, s) pair, lanes split D
    for (int pair = warp; pair < g * bs; pair += nwarps) {
      const int gi = pair / bs, s = pair % bs;
      float dot = 0.0f;
      for (int dd = lane; dd < d; dd += 32) dot += q_s[gi * d + dd] * k_s[s * d + dd];
      dot = warp_sum(dot);
      if (lane == 0) {
        const bool valid = blk * bs + s < len;
        p_s[pair] = valid ? dot * sm_scale : kNegInf;
      }
    }
    __syncthreads();
    // online-softmax update per query row (`_flash_update`)
    if (tid < g) {
      const int gi = tid;
      const float m_prev = m_s[gi];
      float m_cur = kNegInf;
      for (int s = 0; s < bs; ++s) m_cur = fmaxf(m_cur, p_s[gi * bs + s]);
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int s = 0; s < bs; ++s) {
        const bool valid = blk * bs + s < len;
        const float p = valid ? expf(p_s[gi * bs + s] - m_new) : 0.0f;
        p_s[gi * bs + s] = p;
        sum += p;
      }
      l_s[gi] = l_s[gi] * alpha + sum;
      m_s[gi] = m_new;
      a_s[gi] = alpha;
    }
    __syncthreads();
    // acc (G, D) = acc * alpha + P @ V; thread owns columns tid, tid + 128
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) {
      const int dd = tid + j * kThreads;
      if (dd < d) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            float pv = 0.0f;
            for (int s = 0; s < bs; ++s) pv += p_s[gi * bs + s] * v_s[s * d + dd];
            acc[gi][j] = acc[gi][j] * a_s[gi] + pv;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxDPerThread; ++j) {
    const int dd = tid + j * kThreads;
    if (dd < d) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g)
          out[q_off + gi * d + dd] = __float2bfloat16_rn(acc[gi][j] / fmaxf(l_s[gi], 1e-30f));
    }
  }
}

template <int kKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths, void* out, int b,
           int kvh, int g, int d, int bs, int w, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(g) * d + 2 * bs * d + g * bs + 3 * g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<kKV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_decode_kernel<kKV><<<b * kvh, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lengths),
      static_cast<__nv_bfloat16*>(out), kvh, g, d, bs, w, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// q (B, KVH, G, D) bf16; pools (N+1, BS, KVH, D) e4m3|bf16; scales () f32;
// tables (B, W) i32 physical rows; lengths (B,) i32 -> out (B, KVH, G, D)
// bf16.  G <= 16, D <= 256 (the wrapper checks).
extern "C" int fp8rl_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale, const void* tables,
                                  const void* lengths, void* out, int b, int kvh, int g, int d,
                                  int bs, int w, int kv_dtype, float sm_scale, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kE4M3)
    return launch<kE4M3>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, b, kvh, g,
                         d, bs, w, sm_scale, st);
  return launch<kBF16>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, b, kvh, g, d,
                       bs, w, sm_scale, st);
}
