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
// only its live key tiles with the tensor-core block body it shares with
// kernel 5 (`paged_attn_rows`, fp8_paged_attn.cuh): the G <= 16 query rows
// sit in the first rows of one warp's 16-row mma tile (the other rows are
// idle), both warps of the block stage the shared K/V tiles, and a row
// computes bit for bit what kernel 5 computes for a chunk row at the same
// context.  Split-KV (more blocks per slot for small B) is left for the PR
// that makes this kernel fast.
#include "fp8_paged_attn.cuh"

namespace fp8rl {
namespace {

constexpr int kWarps = 2;   // one computes (G <= 16 rows); both stage K/V
constexpr int kRows = 16 * kWarps;

template <int kKV, int kD>
__global__ void __launch_bounds__(32 * kWarps) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int kvh, int g, int d, int bs, int w, float sm_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int64_t row_off[kRows];
  __shared__ int limit[kRows];
  const int b = blockIdx.x / kvh, h = blockIdx.x % kvh;
  const int len = lengths[b];
  const int nb = min(max((len + bs - 1) / bs, 1), w);   // `_live_block_counts`
  const int kv_end = max(min(len, nb * bs), 0);
  if (threadIdx.x < kRows) {
    row_off[threadIdx.x] = ((static_cast<int64_t>(b) * kvh + h) * g + threadIdx.x) * d;
    limit[threadIdx.x] = threadIdx.x < g ? kv_end : 0;
  }
  __syncthreads();
  paged_attn_rows<kKV, kD, kWarps>(q, out, row_off, limit, g, kv_end, k_pool, v_pool,
                                   *k_scale, *v_scale, tables + static_cast<int64_t>(b) * w,
                                   nb, kvh, h, d, bs, sm_scale, smem);
}

template <int kKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths, void* out, int b,
           int kvh, int g, int d, int bs, int w, float sm_scale, cudaStream_t stream) {
  return with_head_width(d, [&](auto width) {
    constexpr int kD = decltype(width)::value;
    const size_t smem = PagedAttnShape<kKV, kD, kWarps>::kSmemBytes;
    const int err = set_smem(paged_decode_kernel<kKV, kD>, smem);
    if (err != 0) return err;
    paged_decode_kernel<kKV, kD><<<b * kvh, 32 * kWarps, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
        static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lengths),
        static_cast<__nv_bfloat16*>(out), kvh, g, d, bs, w, sm_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// q (B, KVH, G, D) bf16; pools (N+1, BS, KVH, D) e4m3|bf16; scales () f32;
// tables (B, W) i32 physical rows; lengths (B,) i32 -> out (B, KVH, G, D)
// bf16.  G <= 16, D % 16 == 0, D <= 256, q and the pools 16-byte aligned
// (the wrapper checks).
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
