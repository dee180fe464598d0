// Split-S (Flash-Decoding) GQA decode attention over a contiguous FP8 (or
// bf16) KV cache (kernel 6), on the tensor cores.
//
// Replaces `fp8_decode_attention` (repro/kernels/fp8_kv_attention.py:169,
// body `_decode_attn_kernel` :110).  q (B, KVH, G, D) bf16 attends over
// one layer's cache (B, S, KVH, D) — a base pointer plus the batch and
// sequence strides of the tensor, so a layer view of the stacked
// (R, B, S, KVH, D) cache needs no copy — masked by `lengths` (B,), with
// one f32 scale for K and one for V.  The function is the TPU kernel's:
// K and V dequantized as payload x scale with no bf16 rounding (kernels 4
// and 5 round like `_deq`; this one does not), scores times sm_scale, an
// online softmax, a row of length 0 out as exact zeros, the output
// rounded to bf16 once.  Only the place of the f32 roundings differs: the
// scales are factored out of the products,
//   score = (q . payload_k) x (k_scale x sm_scale x log2 e),
//   out   = (sum_j p_j payload_v[j]) x v_scale / l,
// and the payload enters the tensor cores exactly (e4m3 -> bf16 is exact;
// a bf16 cache enters as it is).
//
// What bounds it on the H100: bytes.  Each live K/V element is read once
// (1 B at fp8) for 4 G flop; at B 1, S 524288, KVH 8, D 128 one layer
// reads 1.07 GB, 0.32 ms at 3.35 TB/s.  The design:
// - Split S.  The grid is (B * KVH, n_split); block (bh, s) walks keys
//   [s * span, min((s + 1) * span, len)), reading `len` from the device
//   (no host sync), and a block whose span starts at or past `len` exits
//   at once.  `n_split` and `span` come from the host, from S and the SM
//   count only (never from the data), so a row's sum order is fixed for
//   a given cache shape.  A second kernel merges the live splits of each
//   row in split order.
// - Bytes in flight.  A tile of kTileKeys consecutive keys of one
//   (b, kv-head) arrives as 16-byte cp.async copies of its raw K and V
//   rows into a ring of kStages tiles in shared memory, kStages - 1 of
//   them in flight while one is computed (at e4m3, D 128: 32 KB in
//   flight per block, four blocks per SM).  A copy past the split's last key is
//   zero-filled and reads nothing, so a byte at or past `len` never
//   reaches the output (NaN stored there included).  The 16-byte chunks
//   of odd keys are stored XOR-swizzled, so the fragment loads below are
//   free of bank conflicts.
// - Tensor cores.  Each warp takes kWarpKeys keys of every tile and keeps
//   its own online-softmax state for the G query rows, padded to the 16
//   rows of `mma.sync.m16n8k16` bf16 -> f32 (rows 8-15 are dropped when
//   G <= 8).  S = Q K^T: a lane loads 16 head-dim elements of one key
//   (one 16-byte chunk at e4m3) and converts them into four k-steps of
//   B fragments at once; the head-dim order within a k-step is permuted
//   (lane t of a quad takes elements 16t + 4i .. 16t + 4i + 3 of k-step
//   i of each 64-wide group) and q's A fragments are loaded in the same
//   order, which changes nothing in the dot.  O += P V: V's raw rows give
//   the same per-lane pairs, which `movmatrix.trans` turns into B
//   fragments (keys along k), so no tile is staged twice; P enters as
//   hi + lo bf16 (a lone bf16 P misses the 1e-2 bound at |V| ~ 448).  The
//   softmax state stays in registers, in the log2 domain (one exp2 per
//   score), reduced across a quad by shuffles; O is rescaled only when a
//   row's maximum moved.
// - The block's warps merge in warp order through shared memory and
//   write one partial (m, l, acc) per query row to a workspace.  Offsets
//   are 64-bit throughout: one layer at B 8, S 524288 holds 4.3e9
//   elements.
#include "fp8_mma.cuh"

namespace fp8rl {
namespace {

constexpr float kDecNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCombineThreads = 128;

// Block geometry: warps per block, keys per warp per tile (a multiple of
// 16), ring stages, and the most blocks per SM the registers are held to
// (3 when both row halves are live).  A ring never takes more than
// kRingCap bytes; rows wider than 256 bytes (bf16 at D 256) take 16 keys
// a warp.  On the H100 at e4m3, D 128, G 4 (PERF.md §6): 3 stages of 64
// keys, 4 warps, 48 KB a block, registers held to 4 blocks an SM.
constexpr int kDecWarps = 4;
constexpr int kDecWarpKeys = 16;
constexpr int kDecStages = 3;
constexpr int kDecMinBlocks = 4;
constexpr int kRingCap = 200 * 1024;
constexpr int kSmemPerSM = 227 * 1024;

template <int kKV, int kD, int kHalves>
struct DecodeShape {
  static constexpr int kEsz = kKV == kE4M3 ? 1 : 2;
  static constexpr int kRowBytes = kD * kEsz;      // one key's raw K (or V) row
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kWarps = kDecWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpKeys = kRowBytes > 256 ? 16 : kDecWarpKeys;
  static constexpr int kTileKeys = kWarps * kWarpKeys;
  static constexpr int kTileBytes = kTileKeys * kRowBytes;     // K (or V) of one tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages =
      kDecStages * kStageBytes <= kRingCap ? kDecStages : kRingCap / kStageBytes;
  static_assert(kStages >= 2, "the ring needs two stages");
  // 16-byte chunk index of an odd key XORed with kSwz: within a phase of
  // eight lanes (two keys, four lanes each) the loads then hit 32 banks
  static constexpr int kSwz = kRowBytes >= 128 ? (kEsz == 1 ? 4 : 1) : 0;
  static constexpr int kGroups = (kD + 63) / 64;   // a lane holds 16 elements of each
  static constexpr size_t kMergeBytes = static_cast<size_t>(kWarps) * 16 * (kD + 2) * 4;
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kStages) * kStageBytes > kMergeBytes
          ? static_cast<size_t>(kStages) * kStageBytes : kMergeBytes;
  // blocks per SM: as many as the shared memory admits, up to the cap
  static constexpr int kSmemBlocks = static_cast<int>(kSmemPerSM / kSmemBytes);
  static constexpr int kBlockCap =
      kHalves == 1 || kDecMinBlocks < 3 ? kDecMinBlocks : 3;
  static constexpr int kMinBlocks =
      kSmemBlocks < 1 ? 1 : (kSmemBlocks < kBlockCap ? kSmemBlocks : kBlockCap);
};

// workspace layout: m (rows,) in the log2 domain, l (rows,), acc (rows, D);
// row = (bh * n_split + split) * G + g
struct Workspace {
  float* m;
  float* l;
  float* acc;
  __host__ __device__ Workspace(float* ws, int64_t rows) : m(ws), l(ws + rows), acc(ws + 2 * rows) {}
};

// elements 16u .. 16u + 15 of one raw key row as eight bf16 pairs (pair p
// = elements 16u + 2p, 2p + 1); zeros when !live.  e4m3 -> bf16 is exact.
template <int kKV, int kSwz>
__device__ __forceinline__ void load_unit(uint32_t (&w)[8], const uint8_t* row, int key, int u,
                                          bool live) {
  const int swz = (key & 1) * kSwz;
  if (!live) {
#pragma unroll
    for (int p = 0; p < 8; ++p) w[p] = 0u;
    return;
  }
  if constexpr (kKV == kE4M3) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + ((u ^ swz) * 16));
    const uint16_t* pairs = reinterpret_cast<const uint16_t*>(&raw);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pairs[p], __NV_E4M3)));
      w[p] = pack_bf16(f.x, f.y);
    }
  } else {
    const uint4 lo = *reinterpret_cast<const uint4*>(row + (((2 * u) ^ swz) * 16));
    const uint4 hi = *reinterpret_cast<const uint4*>(row + (((2 * u + 1) ^ swz) * 16));
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
  }
}

// acc (rows g, and g + 8 when kHalves == 2) += a b: the m16n8k16 product
// with the unused half's accumulators dropped
template <int kHalves>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * kHalves], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float c[4] = {acc[0], acc[1], 0.0f, 0.0f};
  if constexpr (kHalves == 2) {
    c[2] = acc[2];
    c[3] = acc[3];
  }
  mma_bf16(c, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 2 * kHalves; ++i) acc[i] = c[i];
}

template <int kKV, int kD, int kHalves>
__global__ void __launch_bounds__(DecodeShape<kKV, kD, kHalves>::kThreads,
                                   DecodeShape<kKV, kD, kHalves>::kMinBlocks)
decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_cache,
    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ lengths, float* ws_base,
    int64_t ws_rows, int s_max, int kvh, int g, int d, int64_t stride_b, int64_t stride_s,
    int n_split, int span, float sm_scale) {
  using S = DecodeShape<kKV, kD, kHalves>;
  constexpr int kWarpKeys = S::kWarpKeys, kRowBytes = S::kRowBytes, kGroups = S::kGroups;
  extern __shared__ __align__(128) uint8_t smem[];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / kvh, h = bh % kvh;
  const int len = min(max(lengths[b], 0), s_max);
  const int s0 = split * span;
  if (s0 >= len) return;                 // the combine pass reads live splits only
  const int s1 = min(s0 + span, len);
  const int n_tiles = (s1 - s0 + S::kTileKeys - 1) / S::kTileKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int live_chunks = d * S::kEsz / 16;
  const int64_t row0_bytes =
      (static_cast<int64_t>(b) * stride_b + static_cast<int64_t>(h) * d) * S::kEsz;
  const int64_t key_bytes = stride_s * S::kEsz;

  // the raw K and V rows of `tile` into ring slot tile % kStages: one group
  auto stage_tile = [&](int tile) {
    if (tile < n_tiles) {
      uint8_t* kt = smem + (tile % S::kStages) * S::kStageBytes;
      uint8_t* vt = kt + S::kTileBytes;
      const int key0 = s0 + tile * S::kTileKeys;
      constexpr int kChunks = S::kTileKeys * S::kRowChunks;
#pragma unroll
      for (int i = 0; i < (kChunks + S::kThreads - 1) / S::kThreads; ++i) {
        const int c = tid + i * S::kThreads, kk = c / S::kRowChunks, part = c % S::kRowChunks;
        if (c >= kChunks) break;
        if (part >= live_chunks) continue;
        const bool live = key0 + kk < s1;
        const int64_t off = live ? row0_bytes + (key0 + kk) * key_bytes + part * 16 : 0;
        const int dst = kk * kRowBytes + ((part ^ ((kk & 1) * S::kSwz)) * 16);
        cp_async16(kt + dst, k_cache + off, live);
        cp_async16(vt + dst, v_cache + off, live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) stage_tile(i);

  // q's A fragments, head-dim order permuted as K's B fragments are:
  // qa[hf][j][2i] holds elements 64j + 16t + 4i, +1 of row gr + 8 hf and
  // qa[hf][j][2i + 1] elements +2, +3 (zero past g and d)
  uint32_t qa[kHalves][kGroups][8];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int row = gr + 8 * hf, u = 4 * j + t;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (row < g && 16 * u < d) {
        const __nv_bfloat16* src = q + (static_cast<int64_t>(bh) * g + row) * d + 16 * u;
        lo = reinterpret_cast<const uint4*>(src)[0];
        hi = reinterpret_cast<const uint4*>(src)[1];
      }
      qa[hf][j][0] = lo.x; qa[hf][j][1] = lo.y; qa[hf][j][2] = lo.z; qa[hf][j][3] = lo.w;
      qa[hf][j][4] = hi.x; qa[hf][j][5] = hi.y; qa[hf][j][6] = hi.z; qa[hf][j][7] = hi.w;
    }

  // O fragments: o[j][p] holds elements 64j + 16t + 2p, +1 of rows gr
  // (and gr + 8)
  float o[kGroups][8][2 * kHalves];
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int e = 0; e < 2 * kHalves; ++e) o[j][p][e] = 0.0f;
  float m[kHalves], l[kHalves];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    m[hf] = kDecNegInf;
    l[hf] = 0.0f;
  }
  const float score_scale = *k_scale * sm_scale * kLog2e;
  const int wk0 = warp * kWarpKeys;      // this warp's first key within a tile

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<S::kStages - 2>();     // this thread's copies of `tile` have landed
    __syncthreads();                     // everyone's have; tile - 1's slot is free
    stage_tile(tile + S::kStages - 1);
    const int key_base = s0 + tile * S::kTileKeys + wk0;
    if (key_base >= s1) continue;        // warp-uniform: no key of this warp is live
    const uint8_t* kt = smem + (tile % S::kStages) * S::kStageBytes;
    const uint8_t* vt = kt + S::kTileBytes;

    // S = Q K^T over the warp's keys, an n-tile of 8 keys at a time
    float sc[kWarpKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kWarpKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
      const int kk = wk0 + 8 * nt + gr;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        uint32_t kb[8];
        load_unit<kKV, S::kSwz>(kb, kt + kk * kRowBytes, kk, 4 * j + t, 16 * (4 * j + t) < d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a[4] = {qa[0][j][2 * i], kHalves == 2 ? qa[kHalves - 1][j][2 * i] : 0u,
                                 qa[0][j][2 * i + 1],
                                 kHalves == 2 ? qa[kHalves - 1][j][2 * i + 1] : 0u};
          mma_bf16(sc[nt], a, kb[2 * i], kb[2 * i + 1]);
        }
      }
    }

    // online softmax in the log2 domain; this lane holds keys
    // key_base + 8 nt + 2t + {0, 1} of rows gr (sc[.][0..1]) and gr + 8
    // (sc[.][2..3])
    bool moved = false;
    float alpha[kHalves];
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      float mc = kDecNegInf;
#pragma unroll
      for (int nt = 0; nt < kWarpKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = key_base + 8 * nt + 2 * t + e < s1;
          float& x = sc[nt][2 * hf + e];
          x = valid ? x * score_scale : kDecNegInf;
          mc = fmaxf(mc, x);
        }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[hf], mc);
      alpha[hf] = exp2f(m[hf] - mn);
      moved |= alpha[hf] != 1.0f;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kWarpKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = key_base + 8 * nt + 2 * t + e < s1;
          float& x = sc[nt][2 * hf + e];
          x = valid ? exp2f(x - mn) : 0.0f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hf] = l[hf] * alpha[hf] + sum;
      m[hf] = mn;
    }
    if (__any_sync(0xffffffffu, moved)) {   // multiplying by 1 changes nothing
#pragma unroll
      for (int j = 0; j < kGroups; ++j)
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int e = 0; e < 2 * kHalves; ++e) o[j][p][e] *= alpha[e / 2];
    }

    // O += P V, 16 keys (two n-tiles of S) per k-step
#pragma unroll
    for (int ks = 0; ks < kWarpKeys / 16; ++ks) {
      uint32_t hi[4], lo[4];
      split_bf16(hi[0], lo[0], sc[2 * ks][0], sc[2 * ks][1]);
      split_bf16(hi[2], lo[2], sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
      if constexpr (kHalves == 2) {
        split_bf16(hi[1], lo[1], sc[2 * ks][2], sc[2 * ks][3]);
        split_bf16(hi[3], lo[3], sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
      } else {
        hi[1] = lo[1] = hi[3] = lo[3] = 0u;
      }
      const int k0 = wk0 + 16 * ks + gr, k1 = k0 + 8;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int u = 4 * j + t;
        uint32_t v0[8], v1[8];
        load_unit<kKV, S::kSwz>(v0, vt + k0 * kRowBytes, k0, u, 16 * u < d);
        load_unit<kKV, S::kSwz>(v1, vt + k1 * kRowBytes, k1, u, 16 * u < d);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const uint32_t b0 = movmatrix_trans(v0[p]), b1 = movmatrix_trans(v1[p]);
          mma_rows<kHalves>(o[j][p], hi, b0, b1);
          mma_rows<kHalves>(o[j][p], lo, b0, b1);
        }
      }
    }
  }

  // merge the warps in warp order.  A warp that saw no live key holds
  // m = -1e30, l = 0, o = 0 and weighs exp2(-1e30 - M) = 0; warp 0 saw key
  // s0 < len.
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free
  float* o_s = reinterpret_cast<float*>(smem);             // (kWarps, 16, kD)
  float* m_s = o_s + S::kWarps * 16 * kD;                  // (kWarps, 16)
  float* l_s = m_s + S::kWarps * 16;                       // (kWarps, 16)
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    const int row = gr + 8 * hf;
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int p = 0; p < 8; ++p)
        if (16 * (4 * j + t) < d)
          *reinterpret_cast<float2*>(o_s + (warp * 16 + row) * kD + 64 * j + 16 * t + 2 * p) =
              make_float2(o[j][p][2 * hf], o[j][p][2 * hf + 1]);
    if (t == 0) {
      m_s[warp * 16 + row] = m[hf];
      l_s[warp * 16 + row] = l[hf];
    }
  }
  __syncthreads();
  Workspace ws(ws_base, ws_rows);
  const float vs = *v_scale;
  const int64_t out0 = (static_cast<int64_t>(bh) * n_split + split) * g;
  for (int i = tid; i < g * d; i += S::kThreads) {
    const int gi = i / d, dd = i % d;
    float mx = kDecNegInf;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) mx = fmaxf(mx, m_s[w * 16 + gi]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) {
      const float wt = exp2f(m_s[w * 16 + gi] - mx);
      a += o_s[(w * 16 + gi) * kD + dd] * wt;
      lsum += l_s[w * 16 + gi] * wt;
    }
    ws.acc[(out0 + gi) * d + dd] = a * vs;
    if (dd == 0) {
      ws.m[out0 + gi] = mx;
      ws.l[out0 + gi] = lsum;
    }
  }
}

// out[bh, g, :] = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30)
// over the live splits s < ceil(len / span), summed in split order; no
// live split (len 0) gives exact zeros.  One block per (bh, g): the
// splits' weights go to shared memory once, then each thread sums one
// head-dim column over the splits with its loads unrolled (independent
// loads in flight, the sum still in split order).
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* ws_base, int64_t ws_rows, const int32_t* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int s_max, int kvh, int g, int d, int n_split, int span) {
  extern __shared__ float cmb[];
  float* m_s = cmb;                      // (n_split,) the splits' maxima
  float* w_s = cmb + n_split;            // (n_split,) their weights 2^(m_s - M)
  float* l_s = cmb + 2 * n_split;        // (n_split,) their denominators
  const int bh = blockIdx.x, gi = blockIdx.y, b = bh / kvh;
  const int len = min(max(lengths[b], 0), s_max);
  const int n_live = min(n_split, (len + span - 1) / span);
  Workspace ws(const_cast<float*>(ws_base), ws_rows);
  const int64_t row0 = static_cast<int64_t>(bh) * n_split * g + gi;   // split s: row0 + s * g
  for (int s = threadIdx.x; s < n_live; s += kCombineThreads) {
    m_s[s] = ws.m[row0 + static_cast<int64_t>(s) * g];
    l_s[s] = ws.l[row0 + static_cast<int64_t>(s) * g];
  }
  __syncthreads();
  float mx = kDecNegInf;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, m_s[s]);
  for (int s = threadIdx.x; s < n_live; s += kCombineThreads) w_s[s] = exp2f(m_s[s] - mx);
  __syncthreads();
  float lsum = 0.0f;
  for (int s = 0; s < n_live; ++s) lsum += l_s[s] * w_s[s];
  const float denom = fmaxf(lsum, 1e-30f);
  for (int dd = threadIdx.x; dd < d; dd += kCombineThreads) {
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

template <int kKV, int kD, int kHalves>
int launch(const Args& a) {
  using S = DecodeShape<kKV, kD, kHalves>;
  const auto kernel = decode_split_kernel<kKV, kD, kHalves>;
  const int err = set_smem(kernel, S::kSmemBytes);
  if (err != 0) return err;
  const int64_t rows = static_cast<int64_t>(a.b) * a.kvh * a.n_split * a.g;
  kernel<<<dim3(a.b * a.kvh, a.n_split), S::kThreads, S::kSmemBytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const uint8_t*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int32_t*>(a.lengths),
      static_cast<float*>(a.ws), rows, a.s_max, a.kvh, a.g, a.d, a.stride_b, a.stride_s,
      a.n_split, a.span, a.sm_scale);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  decode_combine_kernel<<<dim3(a.b * a.kvh, a.g), kCombineThreads,
                          3 * sizeof(float) * a.n_split, a.stream>>>(
      static_cast<const float*>(a.ws), rows, static_cast<const int32_t*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.s_max, a.kvh, a.g, a.d, a.n_split, a.span);
  return static_cast<int>(cudaGetLastError());
}

// fn(integral_constant kD, integral_constant kHalves) for head width d and
// group size g (g <= 8: one half of the 16 mma rows)
template <typename Fn>
int with_shape(int d, int g, Fn fn) {
  return with_head_width(d, [&](auto width) {
    if (g <= 8) return fn(width, std::integral_constant<int, 1>());
    return fn(width, std::integral_constant<int, 2>());
  });
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// q (B, KVH, G, D) bf16, 16-byte aligned; k/v one layer (B, S, KVH, D)
// e4m3|bf16 with element strides stride_b, stride_s (KVH and D dense),
// 16-byte aligned with both strides a multiple of 16 bytes; scales () f32;
// lengths (B,) i32; ws f32 of B*KVH*n_split*G*(D+2) -> out (B, KVH, G, D)
// bf16.  G <= 16, D <= 256, D % 16 == 0 (the wrapper checks); n_split is
// at most the SM count (`decode_splits`), so the combine's 3 floats per
// split fit in shared memory.  Two kernels, one call: the split pass, then
// the combine.
extern "C" int fp8rl_decode(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale, const void* lengths,
                            void* out, void* ws, int b, int s_max, int kvh, int g, int d,
                            int64_t stride_b, int64_t stride_s, int n_split, int span,
                            int kv_dtype, float sm_scale, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (g < 1 || g > 16) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, k_scale, v_scale, lengths, out, ws, b, s_max, kvh, g, d,
               stride_b, stride_s, n_split, span, sm_scale, static_cast<cudaStream_t>(stream)};
  auto run = [&](auto width, auto halves) {
    constexpr int kD = decltype(width)::value, kHalves = decltype(halves)::value;
    return kv_dtype == kE4M3 ? launch<kE4M3, kD, kHalves>(a) : launch<kBF16, kD, kHalves>(a);
  };
  return with_shape(d, g, run);
}

// The split pass's geometry at head width d, group size g and cache dtype
// kv_dtype: out = {ring stages, keys per tile, warps per block, dynamic
// shared memory bytes per block, blocks per SM the registers are held to}.
extern "C" int fp8rl_decode_geometry(int d, int g, int kv_dtype, int* out) {
  auto geometry = [&](auto width, auto halves) {
    constexpr int kD = decltype(width)::value, kHalves = decltype(halves)::value;
    auto fill = [&](auto shape) {
      using S = decltype(shape);
      out[0] = S::kStages;
      out[1] = S::kTileKeys;
      out[2] = S::kWarps;
      out[3] = static_cast<int>(S::kSmemBytes);
      out[4] = S::kMinBlocks;
      return 0;
    };
    return kv_dtype == kE4M3 ? fill(DecodeShape<kE4M3, kD, kHalves>())
                             : fill(DecodeShape<kBF16, kD, kHalves>());
  };
  return with_shape(d, g, geometry);
}
