// Paged chunked-prefill attention over an FP8 (or bf16) KV pool (kernel 5).
//
// Replaces `fp8_paged_prefill_attention` (repro/kernels/fp8_kv_attention.py
// :402, body `_paged_prefill_attn_kernel` :349 with `_live_block_counts`
// :228, `_clamped_kv_map` :81, `_flash_update` :89 and `_deq` :73).
// q (B, C, KVH, G, D) bf16 holds one chunk of C roped queries per slot at
// absolute positions [start, start + C); they attend over the pools
// (N+1, BS, KVH, D) through per-slot tables (B, W) of physical rows — the
// chunk's own K/V was scattered into the pool just before.  Row (c, g) at
// q_pos = start + c counts key k_pos when k_pos <= q_pos and
// q_pos < lengths (the slot's valid tokens after the chunk), so rows of a
// ragged final chunk come out as exact zeros.  Only table entries
// w < nb = clip(ceil(min(start + C, lengths) / BS), 1, W) are read.
//
// The design: grid (B * KVH, ceil(C * G / 64)); a block of 4 warps takes
// 64 consecutive (c, g) rows of one (slot, kv-head) and runs the
// tensor-core block body it shares with kernel 4 (`paged_attn_rows`,
// fp8_paged_attn.cuh, which says what bounds it and why).  Where the TPU
// kernel holds all C * G rows of a (slot, kv-head) in one grid step, the
// rows here are split over blocks; each block walks key tiles only up to
// its last valid row's position (the causal early exit), and the row
// blocks with the most keys are scheduled first.  At the engine's chunk
// (B 1, KVH 8, C 128, G 4) that is 64 blocks: the body is bound by the
// latency of each warp's instruction stream, and 4 warps sharing a tile's
// staging beat twice the blocks of 2 warps (see PERF.md).
#include "fp8_paged_attn.cuh"

namespace fp8rl {
namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;

template <int kKV, int kD>
__global__ void __launch_bounds__(32 * kWarps) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ start, const int32_t* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int c, int kvh, int g, int d, int bs, int w,
    float sm_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int64_t row_off[kRows];
  __shared__ int limit[kRows];
  const int b = blockIdx.x / kvh, h = blockIdx.x % kvh;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // most keys first
  const int rows = min(kRows, c * g - r0);
  const int st = start[b], len = lengths[b];
  const int ctx = min(st + c, len);
  const int nb = min(max((ctx + bs - 1) / bs, 1), w);   // `_live_block_counts`
  if (threadIdx.x < kRows) {
    const int r = r0 + threadIdx.x, ci = r / g, gi = r % g;
    const int q_pos = st + ci;
    row_off[threadIdx.x] =
        (((static_cast<int64_t>(b) * c + ci) * kvh + h) * g + gi) * d;
    limit[threadIdx.x] =
        threadIdx.x < rows && q_pos < len ? min(q_pos + 1, nb * bs) : 0;
  }
  // the largest limit: that of the block's last row before `len`
  const int first = st + r0 / g, last = min(st + (r0 + rows - 1) / g, len - 1);
  const int kv_end = last >= first ? min(last + 1, nb * bs) : 0;
  __syncthreads();
  paged_attn_rows<kKV, kD, kWarps>(q, out, row_off, limit, rows, kv_end, k_pool, v_pool, *k_scale,
                                   *v_scale, tables + static_cast<int64_t>(b) * w, nb, kvh,
                                   h, d, bs, sm_scale, smem);
}

template <int kKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* start, const void* lengths,
           void* out, int b, int c, int kvh, int g, int d, int bs, int w, float sm_scale,
           cudaStream_t stream) {
  return with_head_width(d, [&](auto width) {
    constexpr int kD = decltype(width)::value;
    const size_t smem = PagedAttnShape<kKV, kD, kWarps>::kSmemBytes;
    const int err = set_smem(paged_prefill_kernel<kKV, kD>, smem);
    if (err != 0) return err;
    const dim3 grid(b * kvh, (c * g + kRows - 1) / kRows);
    paged_prefill_kernel<kKV, kD><<<grid, 32 * kWarps, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
        static_cast<const int32_t*>(tables), static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(lengths), static_cast<__nv_bfloat16*>(out), c, kvh, g, d,
        bs, w, sm_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// q (B, C, KVH, G, D) bf16; pools (N+1, BS, KVH, D) e4m3|bf16; scales ()
// f32; tables (B, W) i32 physical rows; start, lengths (B,) i32 -> out
// (B, C, KVH, G, D) bf16.  G <= 16, D % 16 == 0, D <= 256, q and the pools
// 16-byte aligned (the wrapper checks).
extern "C" int fp8rl_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* tables, const void* start, const void* lengths,
                                   void* out, int b, int c, int kvh, int g, int d, int bs,
                                   int w, int kv_dtype, float sm_scale, void* stream) {
  if (b == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kE4M3)
    return launch<kE4M3>(q, k_pool, v_pool, k_scale, v_scale, tables, start, lengths, out, b,
                         c, kvh, g, d, bs, w, sm_scale, st);
  return launch<kBF16>(q, k_pool, v_pool, k_scale, v_scale, tables, start, lengths, out, b, c,
                       kvh, g, d, bs, w, sm_scale, st);
}
