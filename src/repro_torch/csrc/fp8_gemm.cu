// Blockwise-scaled FP8 GEMM (kernel 3 of the port).
//
// Replaces `fp8_gemm` (repro/kernels/fp8_gemm.py:72, body `_fp8_gemm_kernel`
// :42): out (M, N) bf16 = sum over 128-wide K slabs kb, in slab order, of
// (A_kb @ W_kb) * (a_s[m, kb] * w_s[kb, n / 128]), accumulated in f32.  A
// (M, K) e4m3 holds 1x128-tile-scaled activations, W (K, N) e4m3 holds
// 128x128-block-scaled weights, stored K-major by the weight sync (row n
// of the storage is W[:, n], `ldw` bytes apart).
//
// What bounds it on the H100: at decode (M 1-40) the weight bytes — a
// weight stream at ~2M flop per byte, far below the ~590 fp8 flop/byte
// ridge; at prefill (M 1024) the tensor cores.  The design:
//   * swap-AB: the tensor cores compute out^T.  W's n-rows are the 16-row
//     side of `mma.sync.m16n8k32` e4m3 (f32 accumulate) and the
//     activations' m-rows its 8-wide side, so an M-8 call wastes no
//     tensor rows (a 64-row activation tile wasted 87-98% at M <= 8);
//   * K-major weights: a fragment's four k-bytes are one 32-bit word, so
//     tiles go from device memory to shared memory by 16-byte `cp.async`
//     and into fragments by `ldmatrix`, with no transpose;
//   * a ring of stages in flight per block, each one cp.async group of
//     kU K slabs (W tile, activation tile and the slabs' scales), so a
//     block keeps loading while it multiplies;
//   * up to M 64 the slabs of a stage are split between warp groups,
//     which write their scaled partials to shared memory for group 0 to
//     add in slab order: a warp walking every slab itself is
//     latency-bound at ~0.4 us a slab, hot in L2 or cold, whatever N;
//   * narrow weight tiles up to M 64 (16 or 32 n-rows a block), so
//     every qwen3-8b shape but (4096, 1024) launches >= 128 blocks
//     without split-K; M 33-64 (the engine's spec verify) runs the
//     32 x 32 tile over two row blocks, which beat a 16 x 64 tile and
//     the 32 x 128 one at M 40; 32 x 128 tiles at the engine's chunk
//     (M <= 128) and 128 x 128 above, where the tensor cores bound it;
//   * a programmatic dependent launch behind kernel 1 or the previous
//     GEMM (q, k, v; gate, up): the first stage's weights stream before
//     `griddepcontrol.wait`, and each block lets the next GEMM launch
//     once its last stage is issued.
// The expert-batched form (the reference vmaps its GEMM over an MoE
// layer's experts, which gives the Pallas call a batch grid axis) is the
// same launch with blockIdx.z as the expert: A, W, a_s, w_s and out each
// advance by a 64-bit stride per expert and nothing else changes, so
// expert e's rows are bit-equal to the 2-D launch on expert e alone.
// One block body serves every M; the four tile shapes differ only in how
// many 16x8 output fragments a warp and a block hold and in their rings.
// Each output element's arithmetic is the same in all of them: four k32
// `mma` steps from zero per slab into a fresh f32 partial, then acc = acc
// + partial * (a_s * w_s) with unfused __fmul_rn / __fadd_rn, slab by
// slab, rounded to bf16 once.  So a row's bits never depend on M, on the
// tile shape or on which rows share the call.  Rows past M are
// zero-filled in shared memory and never stored; K and N must be
// multiples of 128 (the weight sync pads them).
#include "fp8_mma.cuh"

namespace fp8rl {
namespace {

constexpr int BK = 128;  // one K slab per scale
// ring geometry of each tile shape: K slabs a stage holds, stages, and
// the warp groups that split a stage's slabs between them
constexpr int kSmallSlabs = 8;  // M <= 8
constexpr int kSmallStages = 3;
constexpr int kSmallSplit = 8;
constexpr int kMidSlabs = 4;    // M <= 64 (two row blocks past M 32)
constexpr int kMidStages = 2;
constexpr int kMidSplit = 4;
constexpr int kMidWN = 2;       // warps across the weight's rows, 16 each
constexpr int kChunkSlabs = 1;  // M <= 128
constexpr int kChunkStages = 4;
constexpr int kChunkSplit = 1;
constexpr int kLargeSlabs = 1;  // M > 128
constexpr int kLargeStages = 4;
// the large tile's warp grid (n x m) and fragments per warp (n x m)
constexpr int kLargeWN = 2;
constexpr int kLargeWM = 4;
constexpr int kLargeNT = 4;
constexpr int kLargeMT = 4;

__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes global -> shared; zero-filled (the source is not read) when
// !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// A group of kWN x kWM warps covers the block's output, each warp kNT
// 16-row weight fragments by kMT 8-row activation fragments; a stage
// holds kU K slabs, split between kSplit such groups (group g multiplies
// slabs g, g + kSplit, ...).  With kSplit > 1 each group writes its
// slabs' scaled partials to shared memory and group 0 adds them in slab
// order: the same roundings as one group adding its own, with the
// slabs' mma chains run by several warps at once (a warp walking every
// slab itself is latency-bound at ~0.4 us a slab, hot in L2 or cold).
template <int kWN_, int kWM_, int kNT_, int kMT_, int kU_, int kStages_, int kSplit_ = 1>
struct Tile {
  static constexpr int kWN = kWN_, kWM = kWM_, kNT = kNT_, kMT = kMT_, kU = kU_;
  static constexpr int kStages = kStages_, kSplit = kSplit_;
  static constexpr int kGroupWarps = kWN * kWM;
  static constexpr int kThreads = 32 * kGroupWarps * kSplit;
  static constexpr int BN = kWN * kNT * 16, BM = kWM * kMT * 8;
  // shared row bytes: 16-B aligned; 4 mod 32 words, so the 8 rows of an
  // ldmatrix phase hit 32 distinct banks
  static constexpr int kRow = kU * BK + 16;
  static constexpr int kWBytes = BN * kRow, kABytes = BM * kRow;
  // a stage: W tile, activation tile, a_s [slab][row], then w_s [slab]
  static constexpr int kStageBytes = kWBytes + kABytes + (BM + 4) * kU * 4;
  // after the ring, with kSplit > 1: the scaled partials of a stage,
  // [slab][warp of the group][fragment value][lane]
  static constexpr int kFrag = kNT * kMT * 4;
  static constexpr int kTermBytes = kSplit > 1 ? kU * kGroupWarps * kFrag * 32 * 4 : 0;
  static constexpr int kOutRow = BN + 8;  // bf16 staging row of the store
  static constexpr int kRing = kStages * kStageBytes + kTermBytes;
  static constexpr int kSmem = kRing > BM * kOutRow * 2 ? kRing : BM * kOutRow * 2;
  static_assert(BN <= 128 && 128 % BN == 0, "a block's columns share one w_s column");
  static_assert(kStages >= 2 && kU <= 8 && kU % kSplit == 0,
                "a ring of two stages or more, <= 8 slabs each, split evenly");
  static_assert(BN * 8 * kU % kThreads == 0 && BM * 8 * kU % kThreads == 0,
                "whole 16-byte chunks per thread");
};

// n x m outputs a block
using SmallTile = Tile<1, 1, 1, 1, kSmallSlabs, kSmallStages, kSmallSplit>;  // 16 x 8
using MidTile = Tile<kMidWN, 1, 1, 4, kMidSlabs, kMidStages, kMidSplit>;     // 32 x 32
using ChunkTile = Tile<2, 4, 1, 4, kChunkSlabs, kChunkStages, kChunkSplit>;  // 32 x 128
using LargeTile = Tile<kLargeWN, kLargeWM, kLargeNT, kLargeMT, kLargeSlabs,
                       kLargeStages>;                                        // 128 x 128

// issue the cp.async copies of stage q (slabs q kU .. q kU + kU - 1 that
// exist) into `st`, in two halves: the weight's (W tile and w_s), which
// may run before the grid-dependency wait, and the activation's (A tile
// and a_s), which may not.  A stage's group is committed after both.
template <typename T>
__device__ __forceinline__ void load_stage_w(uint8_t* st, const uint8_t* __restrict__ W,
                                             const float* __restrict__ w_s, int64_t n0,
                                             int64_t n, int64_t k, int64_t ldw, int64_t q,
                                             int tid) {
  constexpr int kChunks = 8 * T::kU;  // 16-byte chunks of a row in a stage
  const int64_t k0 = q * T::kU * BK, nkb = k / BK;
#pragma unroll
  for (int it = 0; it < T::BN * kChunks / T::kThreads; ++it) {
    const int i = tid + it * T::kThreads, r = i / kChunks, c = i % kChunks;
    const bool valid = T::kU == 1 || k0 + c * 16 < k;  // a last stage may be short
    cp_async16(st + r * T::kRow + c * 16, valid ? W + (n0 + r) * ldw + k0 + c * 16 : W,
               valid);
  }
  float* scales = reinterpret_cast<float*>(st + T::kWBytes + T::kABytes);
  for (int u = tid; u < T::kU; u += T::kThreads) {
    const int64_t kb = q * T::kU + u;
    const bool valid = kb < nkb;
    cp_async4(scales + T::kU * T::BM + u, valid ? w_s + kb * (n / 128) + n0 / 128 : w_s,
              valid);
  }
}

template <typename T>
__device__ __forceinline__ void load_stage_a(uint8_t* st, const uint8_t* __restrict__ A,
                                             const float* __restrict__ a_s, int64_t m0,
                                             int64_t m, int64_t k, int64_t q, int tid) {
  constexpr int kChunks = 8 * T::kU;
  const int64_t k0 = q * T::kU * BK, nkb = k / BK;
#pragma unroll
  for (int it = 0; it < T::BM * kChunks / T::kThreads; ++it) {
    const int i = tid + it * T::kThreads, r = i / kChunks, c = i % kChunks;
    const bool valid = m0 + r < m && (T::kU == 1 || k0 + c * 16 < k);
    cp_async16(st + T::kWBytes + r * T::kRow + c * 16,
               valid ? A + (m0 + r) * k + k0 + c * 16 : A, valid);
  }
  float* scales = reinterpret_cast<float*>(st + T::kWBytes + T::kABytes);
  for (int i = tid; i < T::BM * T::kU; i += T::kThreads) {
    const int u = i / T::BM, r = i % T::BM;
    const int64_t kb = q * T::kU + u;
    const bool valid = m0 + r < m && kb < nkb;
    cp_async4(scales + u * T::BM + r, valid ? a_s + (m0 + r) * nkb + kb : a_s, valid);
  }
}

template <typename T>
__global__ void __launch_bounds__(T::kThreads) fp8_gemm_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ W,
    const float* __restrict__ a_s, const float* __restrict__ w_s,
    __nv_bfloat16* __restrict__ out, int64_t m, int64_t n, int64_t k, int64_t ldw,
    int64_t stride_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  {  // this block's expert (0 for the 2-D launch)
    const int64_t e = blockIdx.z;
    A += e * m * k;
    W += e * stride_w;
    a_s += e * m * (k / BK);
    w_s += e * (k / BK) * (n / 128);
    out += e * m * n;
  }
  constexpr int kNT = T::kNT, kMT = T::kMT, kU = T::kU, S = T::kStages;
  constexpr int kSplit = T::kSplit, kUG = kU / kSplit;  // slabs per group and stage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  // this warp's group and its place in it (compile-time 0 and warp when
  // one group does all)
  const int grp = kSplit == 1 ? 0 : warp / T::kGroupWarps;
  const int gw = kSplit == 1 ? warp : warp % T::kGroupWarps;
  const int wn = gw % T::kWN, wm = gw / T::kWN;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * T::BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * T::BM;
  const int64_t nkb = k / BK, nst = (nkb + kU - 1) / kU;
  // ldmatrix row addresses of this lane: W (A operand) x4 = rows 0-15 by
  // k bytes 0-31 of a k32 step; activations (B operand) x4 = rows 0-7 by
  // k bytes 0-63 (two k32 steps)
  const int w_off = ((wn * kNT) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::kRow
                    + (lane >> 4) * 16;
  const int a_off =
      T::kWBytes + ((wm * kMT) * 8 + (lane & 7)) * T::kRow + (lane >> 3) * 16;
  float* terms = reinterpret_cast<float*>(smem + S * T::kStageBytes);

  float acc[kNT][kMT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int j = 0; j < kMT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  // Under a programmatic dependent launch the kernel before this one
  // (kernel 1 or the previous GEMM) may still run: the first stage's
  // weight half streams before the grid-dependency wait (until it the
  // kernel reads only W and w_s, which only the weight sync writes, and
  // writes nothing); the activation halves and the later stages follow
  // it.  Each stage stays one cp.async group (weight + activation): with
  // the second stage's weights also ahead of the wait, group 0 held both
  // stages and the first refill waited for them (+0.16-0.2 ms of kernel 3
  // a decode step).
  if (nst > 0) load_stage_w<T>(smem, W, w_s, n0, n, k, ldw, 0, tid);
  grid_dependency_wait();
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) {
      if (s > 0) load_stage_w<T>(smem + s * T::kStageBytes, W, w_s, n0, n, k, ldw, s, tid);
      load_stage_a<T>(smem + s * T::kStageBytes, A, a_s, m0, m, k, s, tid);
    }
    cp_async_commit();
  }
  if (nst <= S - 1) launch_dependents();  // every stage issued: the next GEMM may start

  for (int64_t q = 0; q < nst; ++q) {
    cp_async_wait<S - 2>();  // stage q has landed (this thread's copies)
    __syncthreads();         // ... everyone's; stage q - 1's buffers are free
    const int64_t next = q + S - 1;
    if (next < nst) {
      uint8_t* st = smem + (next % S) * T::kStageBytes;
      load_stage_w<T>(st, W, w_s, n0, n, k, ldw, next, tid);
      load_stage_a<T>(st, A, a_s, m0, m, k, next, tid);
      if (next == nst - 1) launch_dependents();
    }
    cp_async_commit();

    // each of this group's slabs into a fresh f32 partial: four k32 steps
    // from zero (independent chains)
    const uint8_t* st = smem + (q % S) * T::kStageBytes;
    float part[kUG][kNT][kMT][4];
#pragma unroll
    for (int p = 0; p < kUG; ++p)
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < kMT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[p][i][j][c] = 0.0f;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {  // k bytes [64 kh, 64 kh + 64) of each slab
#pragma unroll
      for (int p = 0; p < kUG; ++p) {
        const int ub = (grp + kSplit * p) * BK + kh * 64;
        uint32_t bf[kMT][4];
#pragma unroll
        for (int j = 0; j < kMT; ++j) ldsm_x4(bf[j], st + a_off + j * 8 * T::kRow + ub);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t af[kNT][4];
#pragma unroll
          for (int i = 0; i < kNT; ++i)
            ldsm_x4(af[i], st + w_off + i * 16 * T::kRow + ub + ks * 32);
#pragma unroll
          for (int i = 0; i < kNT; ++i)
#pragma unroll
            for (int j = 0; j < kMT; ++j)
              mma_e4m3(part[p][i][j], af[i], bf[j][2 * ks], bf[j][2 * ks + 1]);
        }
      }
    }

    // acc += partial * (a_s * w_s), unfused, slab by slab in the
    // reference's order; fragment c0, c1 at (n g, m 2t, 2t + 1), c2, c3 at
    // (n g + 8, same m)
    const float* scales = reinterpret_cast<const float*>(st + T::kWBytes + T::kABytes);
#pragma unroll
    for (int p = 0; p < kUG; ++p) {
      const int u = grp + kSplit * p;
      if (kU > 1 && q * kU + u >= nkb) break;  // the last stage may hold fewer slabs
      const float ws = scales[kU * T::BM + u];
      float* tu = terms + ((u * T::kGroupWarps + gw) * T::kFrag) * 32 + lane;
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int c = u * T::BM + (wm * kMT + j) * 8 + 2 * t;
        const float sc[2] = {__fmul_rn(scales[c], ws), __fmul_rn(scales[c + 1], ws)};
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float term = __fmul_rn(part[p][i][j][e], sc[e & 1]);
            if (kSplit == 1)
              acc[i][j][e] = __fadd_rn(acc[i][j][e], term);
            else
              tu[((i * kMT + j) * 4 + e) * 32] = term;
          }
      }
    }
    if (kSplit > 1) {
      __syncthreads();  // every group's terms of stage q are in
      if (grp == 0) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (q * kU + u >= nkb) break;
          const float* tu = terms + ((u * T::kGroupWarps + gw) * T::kFrag) * 32 + lane;
#pragma unroll
          for (int i = 0; i < kNT; ++i)
#pragma unroll
            for (int j = 0; j < kMT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][j][e] = __fadd_rn(acc[i][j][e], tu[((i * kMT + j) * 4 + e) * 32]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the bf16 tile for 16-byte stores

  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][kOutRow]
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int nl = (wn * kNT + i) * 16 + g, ml = (wm * kMT + j) * 8 + 2 * t;
        tile[ml * T::kOutRow + nl] = __float2bfloat16_rn(acc[i][j][0]);
        tile[(ml + 1) * T::kOutRow + nl] = __float2bfloat16_rn(acc[i][j][1]);
        tile[ml * T::kOutRow + nl + 8] = __float2bfloat16_rn(acc[i][j][2]);
        tile[(ml + 1) * T::kOutRow + nl + 8] = __float2bfloat16_rn(acc[i][j][3]);
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = T::BN / 8;  // 16-byte chunks of an output row
  for (int i = tid; i < T::BM * kChunks; i += T::kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (m0 + r < m)
      *reinterpret_cast<uint4*>(out + (m0 + r) * n + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * T::kOutRow + c * 8);
  }
}

template <typename T>
int launch_gemm(const void* a, const void* w, const void* a_s, const void* w_s, void* out,
                int64_t batch, int64_t m, int64_t n, int64_t k, int64_t ldw, int64_t stride_w,
                int pdl, cudaStream_t stream) {
  const int err = set_smem(fp8_gemm_kernel<T>, T::kSmem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n / T::BN),
                     static_cast<unsigned>((m + T::BM - 1) / T::BM),
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, fp8_gemm_kernel<T>, static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(a_s), static_cast<const float*>(w_s),
      static_cast<__nv_bfloat16*>(out), m, n, k, ldw, stride_w);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// a (M, K) e4m3, w (K, N) e4m3 K-major (element (k, n) at w[n * ldw + k]),
// a_s (M, K/128) f32, w_s (K/128, N/128) f32 -> out (M, N) bf16;
// K % 128 == 0, N % 128 == 0, ldw >= K and ldw % 16 == 0.  With batch > 1
// each of the `batch` experts e has its own contiguous a (M, K), a_s, w_s
// and out (M, N) one after the other, and its weight at w + e * stride_w
// (stride_w % 16 == 0; a layer slice of the sync's (L, E, N_pad, K_pad)
// storage); batch <= 65535.  The tile shape follows M; every shape
// computes each element alike.  pdl != 0 launches it as a programmatic
// dependent of the kernel before it in the stream, which must not write
// W or w_s.
extern "C" int fp8rl_gemm(const void* a, const void* w, const void* a_s, const void* w_s,
                          void* out, int64_t batch, int64_t m, int64_t n, int64_t k,
                          int64_t ldw, int64_t stride_w, int pdl, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= SmallTile::BM)
    return launch_gemm<SmallTile>(a, w, a_s, w_s, out, batch, m, n, k, ldw, stride_w, pdl, s);
  if (m <= 2 * MidTile::BM)
    return launch_gemm<MidTile>(a, w, a_s, w_s, out, batch, m, n, k, ldw, stride_w, pdl, s);
  if (m <= ChunkTile::BM)
    return launch_gemm<ChunkTile>(a, w, a_s, w_s, out, batch, m, n, k, ldw, stride_w, pdl, s);
  return launch_gemm<LargeTile>(a, w, a_s, w_s, out, batch, m, n, k, ldw, stride_w, pdl, s);
}
