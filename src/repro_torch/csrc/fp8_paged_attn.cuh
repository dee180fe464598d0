// The block body shared by the two paged-attention kernels: kernel 4
// (`fp8_paged_decode.cu`) and kernel 5 (`fp8_paged_prefill.cu`).
//
// It computes what the TPU kernels' shared pieces compute
// (repro/kernels/fp8_kv_attention.py: `_deq` :73, `_flash_update` :89,
// the clamped table walk `_clamped_kv_map` :81): K/V dequantized as an f32
// multiply by the scale, then a bf16 rounding; the masked online softmax
// (masked scores -1e30, masked probabilities exact zeros, denominator
// max(l, 1e-30), so a row with no valid key comes out as exact zeros);
// and only table entries w < nb read.
//
// What bounds it on the H100: at the engine's chunk (C 128, G 4, D 128,
// 640 tokens) ~1.3 GFLOP against ~3.4 MB, so the bf16 tensor cores and the
// bytes bound it about equally (~1 us each); at decode the bytes.  What
// the design does about it:
// - Tensor cores.  A block has kWarps warps; each owns 16 query rows,
//   the M of `mma.sync.m16n8k16` bf16 -> f32.  S = Q K^T and O += P V run
//   on the tensor cores.  Q is bf16 already and the dequantized K/V are
//   bf16 values, so they enter exactly; P enters as two bf16 terms (hi
//   and lo, ~16 bits), so P V stays within the plain version's f32 band
//   even at |V| in the hundreds.  The softmax state lives in registers,
//   reduced across a fragment's quad by shuffles in a fixed order.
// - Key tiles are kKeys logical positions aligned from position 0 and
//   gathered through the table, so every block size works.  Positions in
//   pool blocks at or past nb are zero-filled in shared memory and never
//   dereferenced.  The warps of a block share each tile.
// - Staging.  A tile's raw fp8 (or bf16) bytes arrive as 16-byte cp.async
//   copies into a two-stage ring, so tile t + 1 is in flight while tile t
//   is computed; each tile is then dequantized in shared memory into bf16
//   (rows padded by 16 bytes, so the ldmatrix reads are conflict-free).
// - A block walks tiles only up to its rows' largest limit (the causal
//   early exit of kernel 5's early row blocks).
//
// Row r counts keys at positions k_pos < limit[r].  A row's arithmetic
// depends on its q, its limit and the keys only: not on which fragment
// row or warp it lands in, nor on the other rows or the warp count.  Tiles past a row's
// last valid key change nothing (alpha is exp(0) = 1, every p is 0, and
// 0 x a finite V adds exact zeros), so a chunk row at position T over keys
// [0, T] equals bit for bit a decode step at length T + 1, however many
// tiles each walks.  That keeps greedy speculative decoding (verify
// through kernel 5) bit-equal to plain decoding (kernel 4).
#pragma once

#include "fp8_mma.cuh"

namespace fp8rl {

constexpr float kAttnNegInf = -1e30f;

// Block and tile geometry for kWarps warps and head width kD (a multiple
// of 16, <= 256); a smaller head width runs in the next larger kD,
// zero-padded.
template <int kKV, int kD, int kWarps>
struct PagedAttnShape {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;            // query rows per block
  static constexpr int kKeys = kD <= 128 ? 64 : 32;    // keys per tile
  static constexpr int kStride = kD + 8;               // bf16 per smem row
  static constexpr int kEsz = kKV == kE4M3 ? 1 : 2;    // pool element bytes
  static constexpr int kChunks = kD * kEsz / 16;       // 16-B chunks per key
  static constexpr int kRawBytes = kKeys * kD * kEsz;  // one raw K (or V) tile
  static constexpr size_t kSmemBytes =
      2 * (static_cast<size_t>(kRows + 2 * kKeys) * kStride) + 2 * 2 * kRawBytes;
};

// `_deq` of one 16-byte chunk of a raw tile into bf16 (f32 multiply by
// the scale, then a round to nearest): 16 e4m3 or 8 bf16 values
template <int kKV>
__device__ __forceinline__ void deq_chunk(__nv_bfloat16* dst, const uint8_t* src, float scale);
template <>
__device__ __forceinline__ void deq_chunk<kE4M3>(__nv_bfloat16* dst, const uint8_t* src,
                                                 float scale) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint16_t* pairs = reinterpret_cast<const uint16_t*>(&raw);
  uint4 o[2];
  uint32_t* w = reinterpret_cast<uint32_t*>(o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E4M3)));
    w[i] = pack_bf16(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
  }
  reinterpret_cast<uint4*>(dst)[0] = o[0];
  reinterpret_cast<uint4*>(dst)[1] = o[1];
}
template <>
__device__ __forceinline__ void deq_chunk<kBF16>(__nv_bfloat16* dst, const uint8_t* src,
                                                 float scale) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 o;
  uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(in[i]);
    w[i] = pack_bf16(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
  }
  *reinterpret_cast<uint4*>(dst) = o;
}

// The block's S::kRows rows: q and out rows start at element offsets
// row_off[r]; row r counts keys k_pos < limit[r] (0 for r >= rows, and
// never past nb * bs); kv_end is the largest limit.  row_off and limit
// live in shared memory, written before the call and followed by a
// barrier.  d % 16 == 0 and d <= kD; pointers 16-byte aligned.
template <int kKV, int kD, int kWarps>
__device__ void paged_attn_rows(const __nv_bfloat16* __restrict__ q,
                                __nv_bfloat16* __restrict__ out, const int64_t* row_off,
                                const int* limit, int rows, int kv_end,
                                const void* __restrict__ k_pool,
                                const void* __restrict__ v_pool, float ks, float vs,
                                const int32_t* __restrict__ table, int nb, int kvh, int h,
                                int d, int bs, float sm_scale, uint8_t* smem) {
  using S = PagedAttnShape<kKV, kD, kWarps>;
  constexpr int kThreads = S::kThreads, kRows = S::kRows;
  constexpr int kKeys = S::kKeys, kStride = S::kStride, kEsz = S::kEsz;
  constexpr int kChunks = S::kChunks;
  // 16-byte chunks of a K (or V) tile and of q_s, and their rounds per thread
  constexpr int kKvChunks = kKeys * kChunks, kQChunks = kRows * (kD / 8);
  constexpr int kKvIters = (kKvChunks + kThreads - 1) / kThreads;
  constexpr int kQIters = (kQChunks + kThreads - 1) / kThreads;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);   // (kRows, kStride)
  __nv_bfloat16* k_s = q_s + kRows * kStride;                     // (kKeys, kStride)
  __nv_bfloat16* v_s = k_s + kKeys * kStride;                     // (kKeys, kStride)
  uint8_t* raw = reinterpret_cast<uint8_t*>(v_s + kKeys * kStride);  // [slot][K, V]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int kv_stop = nb * bs;             // positions past it are never read
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const uint8_t* kp = static_cast<const uint8_t*>(k_pool);
  const uint8_t* vp = static_cast<const uint8_t*>(v_pool);

  // the raw K and V bytes of `tile` into ring slot tile % 2: one group
  auto stage_tile = [&](int tile) {
    if (tile < n_tiles) {
      uint8_t* kr = raw + (tile & 1) * 2 * S::kRawBytes;
      uint8_t* vr = kr + S::kRawBytes;
#pragma unroll
      for (int i = 0; i < kKvIters; ++i) {
        const int c = tid + i * kThreads, key = c / kChunks, part = c % kChunks;
        if (c >= kKvChunks) break;
        if (part * 16 >= d * kEsz) continue;
        const int pos = tile * kKeys + key;
        const bool live = pos < kv_stop;
        int64_t off = 0;
        if (live) {
          const int64_t row = table[pos / bs];
          off = ((row * bs + pos % bs) * kvh + h) * static_cast<int64_t>(d) * kEsz + part * 16;
        }
        cp_async16(kr + c * 16, kp + off, live);
        cp_async16(vr + c * 16, vp + off, live);
      }
    }
    cp_async_commit();
  };
  stage_tile(0);
  stage_tile(1);

  // q rows (zero past `rows` and past d); the pad columns of K and V
#pragma unroll
  for (int i = 0; i < kQIters; ++i) {
    const int c = tid + i * kThreads, r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    if (c >= kQChunks) break;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && col < d) v = *reinterpret_cast<const uint4*>(q + row_off[r] + col);
    *reinterpret_cast<uint4*>(q_s + r * kStride + col) = v;
  }
  if (d < kD) {
    for (int c = tid; c < kKeys * ((kD - d) / 8); c += kThreads) {
      const int key = c / ((kD - d) / 8), col = d + (c % ((kD - d) / 8)) * 8;
      *reinterpret_cast<uint4*>(k_s + key * kStride + col) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(v_s + key * kStride + col) = make_uint4(0, 0, 0, 0);
    }
  }

  const bool active = warp * 16 < rows;   // warp-uniform
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int lim0 = limit[r0], lim1 = limit[r1];
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.0f;
  float m0 = kAttnNegInf, m1 = kAttnNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();   // this thread's copies of `tile` have landed
    __syncthreads();      // everyone's have; the previous tile is consumed
    {
      const uint8_t* kr = raw + (tile & 1) * 2 * S::kRawBytes;
      const uint8_t* vr = kr + S::kRawBytes;
#pragma unroll
      for (int i = 0; i < kKvIters; ++i) {
        const int c = tid + i * kThreads, key = c / kChunks, part = c % kChunks;
        if (c >= kKvChunks) break;
        if (part * 16 >= d * kEsz) continue;
        const int col = part * 16 / kEsz;
        deq_chunk<kKV>(k_s + key * kStride + col, kr + c * 16, ks);
        deq_chunk<kKV>(v_s + key * kStride + col, vr + c * 16, vs);
      }
    }
    __syncthreads();      // the K/V tile is ready; its ring slot is free
    stage_tile(tile + 2);
    if (!active) continue;

    // S (16 rows x kKeys) = Q K^T
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < kD / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + kd * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kd * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // masked online softmax (`_flash_update`) for rows r0 (s[.][0..1])
    // and r1 (s[.][2..3]); this thread holds keys 8n + 2t, 8n + 2t + 1
    const int kpos0 = tile * kKeys + 2 * t;
    float mc0 = kAttnNegInf, mc1 = kAttnNegInf;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kpos0 + 8 * n + j;
        s[n][j] = key < lim0 ? __fmul_rn(s[n][j], sm_scale) : kAttnNegInf;
        s[n][2 + j] = key < lim1 ? __fmul_rn(s[n][2 + j], sm_scale) : kAttnNegInf;
        mc0 = fmaxf(mc0, s[n][j]);
        mc1 = fmaxf(mc1, s[n][2 + j]);
      }
    mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, 1));
    mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, 2));
    mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, 1));
    mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, 2));
    const float mn0 = fmaxf(m0, mc0), mn1 = fmaxf(m1, mc1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kpos0 + 8 * n + j;
        s[n][j] = key < lim0 ? expf(s[n][j] - mn0) : 0.0f;
        s[n][2 + j] = key < lim1 ? expf(s[n][2 + j] - mn1) : 0.0f;
        sum0 = __fadd_rn(sum0, s[n][j]);
        sum1 = __fadd_rn(sum1, s[n][2 + j]);
      }
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, 1));
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, 2));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, 1));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, 2));
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), sum0);
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), sum1);
    m0 = mn0;
    m1 = mn1;

    // O = O * alpha + P V.  P enters the tensor cores as two bf16 terms,
    // hi = bf16(p) and lo = bf16(p - hi), so it keeps ~16 bits: a lone
    // bf16 P is off by up to 2^-9 of |V| (0.9 at the |V| ~ 448 of a bf16
    // pool), far outside the 1e-2 that holds the kernel to its plain
    // version.  The S fragments of two key octets are the A fragment of
    // one 16-key step.
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] = __fmul_rn(o[n][0], alpha0);
      o[n][1] = __fmul_rn(o[n][1], alpha0);
      o[n][2] = __fmul_rn(o[n][2], alpha1);
      o[n][3] = __fmul_rn(o[n][3], alpha1);
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(hi[0], lo[0], s[2 * kk][0], s[2 * kk][1]);
      split_bf16(hi[1], lo[1], s[2 * kk][2], s[2 * kk][3]);
      split_bf16(hi[2], lo[2], s[2 * kk + 1][0], s[2 * kk + 1][1]);
      split_bf16(hi[3], lo[3], s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                             dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }

  if (!active) return;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col < d && r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + row_off[r0] + col) =
          __floats2bfloat162_rn(o[n][0] / den0, o[n][1] / den0);
    if (col < d && r1 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + row_off[r1] + col) =
          __floats2bfloat162_rn(o[n][2] / den1, o[n][3] / den1);
  }
}

}  // namespace fp8rl
