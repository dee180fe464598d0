// The block body shared by the two paged-attention kernels: kernel 4
// (`fp8_paged_decode.cu`) and kernel 5 (`fp8_paged_prefill.cu`).
//
// One 128-thread block attends up to kAttnMaxRows query rows, all of one
// (slot, kv-head), over that slot's live pool blocks: table entries
// w < nb only, so stale ids past the live region are never dereferenced.
// Row r counts the keys at positions k_pos < limit[r] (decode: the slot's
// length; chunked prefill: q_pos + 1 while q_pos < lengths, else 0).
// Each pool block is walked in shared-memory tiles of at most kAttnTile
// keys; a tile is dequantized the way the TPU kernels' `_deq` does (f32
// multiply, then a bf16 rounding), scores and P @ V accumulate in f32, and
// the online softmax is the TPU kernels' masked `_flash_update`: masked
// scores are -1e30, masked probabilities exact zeros, the denominator
// max(l, 1e-30) — so a row with no valid key comes out as exact zeros.
//
// Every row's arithmetic is independent of which other rows share its
// block, and the same in both kernels: a chunk row at position T over
// keys [0, T] computes bit for bit what a decode step at length T + 1
// computes.  Tiles past a row's last valid key change nothing (alpha is
// exp(0) = 1, every p is 0), so the extra tiles a chunk walks for its
// later rows leave its earlier rows exact.  That is what keeps greedy
// speculative decoding (verify through kernel 5) bit-equal to plain
// decoding (kernel 4).
#pragma once

#include "fp8_common.cuh"

namespace fp8rl {

constexpr int kAttnThreads = 128;
constexpr int kAttnMaxRows = 16;        // query rows per block
constexpr int kAttnMaxDPerThread = 2;   // D <= 256
constexpr int kAttnTile = 16;           // keys per shared-memory tile
constexpr float kAttnNegInf = -1e30f;

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

// shared-memory floats the body needs for `rows` rows of width d
__host__ __device__ inline size_t paged_attn_smem_floats(int rows, int d) {
  return static_cast<size_t>(rows) * d + 2 * kAttnTile * d + rows * kAttnTile + 3 * rows;
}

// q and out rows start at element offsets row_off[r]; limit[r] as above.
// row_off and limit live in shared memory, written before the call and
// followed by a barrier.
template <int kKV>
__device__ void paged_attn_rows(const __nv_bfloat16* __restrict__ q,
                                __nv_bfloat16* __restrict__ out,
                                const int64_t* row_off, const int* limit, int rows,
                                const void* __restrict__ k_pool,
                                const void* __restrict__ v_pool, float ks, float vs,
                                const int32_t* __restrict__ table, int nb, int kvh, int h,
                                int d, int bs, float sm_scale, float* smem) {
  float* q_s = smem;                   // (rows, D)
  float* k_s = q_s + rows * d;         // (kAttnTile, D)
  float* v_s = k_s + kAttnTile * d;    // (kAttnTile, D)
  float* p_s = v_s + kAttnTile * d;    // (rows, nt) scores, then probabilities
  float* m_s = p_s + rows * kAttnTile; // (rows,) running max
  float* l_s = m_s + rows;             // (rows,) running denominator
  float* a_s = l_s + rows;             // (rows,) rescale factor of this tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int nwarps = blockDim.x / 32;

  for (int i = tid; i < rows * d; i += blockDim.x)
    q_s[i] = __bfloat162float(q[row_off[i / d] + i % d]);
  if (tid < rows) {
    m_s[tid] = kAttnNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[kAttnMaxRows][kAttnMaxDPerThread];
#pragma unroll
  for (int r = 0; r < kAttnMaxRows; ++r)
#pragma unroll
    for (int j = 0; j < kAttnMaxDPerThread; ++j) acc[r][j] = 0.0f;

  for (int blk = 0; blk < nb; ++blk) {
    const int64_t row = table[blk];
    for (int t0 = 0; t0 < bs; t0 += kAttnTile) {
      const int nt = min(kAttnTile, bs - t0);
      const int kpos0 = blk * bs + t0;
      __syncthreads();  // previous tile fully consumed (and q/m/l initialized)
      for (int i = tid; i < nt * d; i += blockDim.x) {
        const int s = i / d, dd = i % d;
        const int64_t src = ((row * bs + t0 + s) * kvh + h) * d + dd;
        k_s[i] = deq(kv_load<kKV>(k_pool, src), ks);
        v_s[i] = deq(kv_load<kKV>(v_pool, src), vs);
      }
      __syncthreads();
      // scores (rows, nt): one warp per (row, key) pair, lanes split D
      for (int pair = warp; pair < rows * nt; pair += nwarps) {
        const int r = pair / nt, s = pair % nt;
        float dot = 0.0f;
        for (int dd = lane; dd < d; dd += 32) dot += q_s[r * d + dd] * k_s[s * d + dd];
        dot = warp_sum(dot);
        if (lane == 0) p_s[pair] = kpos0 + s < limit[r] ? dot * sm_scale : kAttnNegInf;
      }
      __syncthreads();
      // online-softmax update per query row (`_flash_update`)
      if (tid < rows) {
        const int r = tid;
        const float m_prev = m_s[r];
        float m_cur = kAttnNegInf;
        for (int s = 0; s < nt; ++s) m_cur = fmaxf(m_cur, p_s[r * nt + s]);
        const float m_new = fmaxf(m_prev, m_cur);
        const float alpha = expf(m_prev - m_new);
        float sum = 0.0f;
        for (int s = 0; s < nt; ++s) {
          const float p = kpos0 + s < limit[r] ? expf(p_s[r * nt + s] - m_new) : 0.0f;
          p_s[r * nt + s] = p;
          sum += p;
        }
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
      __syncthreads();
      // acc (rows, D) = acc * alpha + P @ V; thread owns columns tid, tid + 128
#pragma unroll
      for (int j = 0; j < kAttnMaxDPerThread; ++j) {
        const int dd = tid + j * kAttnThreads;
        if (dd < d) {
#pragma unroll
          for (int r = 0; r < kAttnMaxRows; ++r) {
            if (r < rows) {
              float pv = 0.0f;
              for (int s = 0; s < nt; ++s) pv += p_s[r * nt + s] * v_s[s * d + dd];
              acc[r][j] = acc[r][j] * a_s[r] + pv;
            }
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAttnMaxDPerThread; ++j) {
    const int dd = tid + j * kAttnThreads;
    if (dd < d) {
#pragma unroll
      for (int r = 0; r < kAttnMaxRows; ++r)
        if (r < rows)
          out[row_off[r] + dd] = __float2bfloat16_rn(acc[r][j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed; returns
// a cudaError_t as int (0 on success).
template <typename Kernel>
inline int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace fp8rl
