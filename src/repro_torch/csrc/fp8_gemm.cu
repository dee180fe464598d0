// Blockwise-scaled FP8 GEMM (kernel 3 of the port).
//
// Replaces `fp8_gemm` (repro/kernels/fp8_gemm.py:72, body `_fp8_gemm_kernel`
// :42): out (M, N) bf16 = sum over 128-wide K slabs kb of
// (A_kb @ W_kb) * (a_s[m, kb] * w_s[kb, n / 128]), accumulated in f32 in
// that order.  A (M, K) e4m3 holds 1x128-tile-scaled activations, W (K, N)
// e4m3 holds 128x128-block-scaled weights (the reference's (K, N) layout).
//
// What bounds it on the H100: at decode (M = 8) the weight bytes — the
// GEMM is a weight stream at ~2 flop per byte, far below the ~590 fp8
// flop/byte ridge; at prefill (M = 1024) the tensor-core rate.  This first
// version is simple and exact in structure: a 64x64 output tile per
// 128-thread block, one K step per 128-wide scale slab, fp8 tensor-core
// products (mma.sync m16n8k32 e4m3, f32 accumulate) for each slab kept in a
// separate f32 partial that is scaled once and added to the accumulator,
// exactly as the reference does.  The weight tile is transposed into
// shared memory on the way in (mma wants B K-major).  No TMA, no wgmma, no
// pipelining, no split-K: those are for the PR that makes it fast.
// Rows past M are masked in the kernel (decode's M = 8 needs no padded
// copy); K and N must be multiples of 128 (the wrapper pads).
#include "fp8_common.cuh"

namespace fp8rl {
namespace {

constexpr int BM = 64, BN = 64, BK = 128;
constexpr int kThreads = 128;
constexpr int kStride = BK + 16;  // smem row bytes: 16-B aligned, no bank conflicts

__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) fp8_gemm_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ W,
    const float* __restrict__ a_s, const float* __restrict__ w_s,
    __nv_bfloat16* __restrict__ out, int64_t m, int64_t n, int64_t k) {
  __shared__ __align__(16) uint8_t As[BM][kStride];
  __shared__ __align__(16) uint8_t Bs[BN][kStride];  // Bs[n][k]: W tile transposed
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // this warp's 32x32
  const int64_t nkb = k / BK, nnb = n / 128;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;

  for (int64_t kb = 0; kb < nkb; ++kb) {
    // A slab: 64 rows x 128 B = 512 16-B chunks, 4 per thread; rows >= M are 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads, row = idx / 8, c16 = idx % 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < m)
        v = *reinterpret_cast<const uint4*>(A + (m0 + row) * k + kb * BK + c16 * 16);
      *reinterpret_cast<uint4*>(&As[row][c16 * 16]) = v;
    }
    // W slab: 128 k-rows x 64 n-cols = 512 16-B chunks, stored transposed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads, krow = idx / 4, c16 = idx % 4;
      const uint4 v = *reinterpret_cast<const uint4*>(W + (kb * BK + krow) * n + n0 + c16 * 16);
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[c16 * 16 + j][krow] = bytes[j];
    }
    __syncthreads();

    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mi][ni][c] = 0.0f;

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t * 4]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t * 4]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + t * 4]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + t * 4]);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_e4m3(part[mi][ni], af[mi], bf[ni]);
    }

    // acc += partial * (a_s * w_s), unfused, in the reference's order
    const float ws = w_s[kb * nnb + n0 / 128];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int64_t r0 = m0 + wm + mi * 16 + g, r1 = r0 + 8;
      const float s0 = r0 < m ? __fmul_rn(a_s[r0 * nkb + kb], ws) : 0.0f;
      const float s1 = r1 < m ? __fmul_rn(a_s[r1 * nkb + kb], ws) : 0.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][0] = __fadd_rn(acc[mi][ni][0], __fmul_rn(part[mi][ni][0], s0));
        acc[mi][ni][1] = __fadd_rn(acc[mi][ni][1], __fmul_rn(part[mi][ni][1], s0));
        acc[mi][ni][2] = __fadd_rn(acc[mi][ni][2], __fmul_rn(part[mi][ni][2], s1));
        acc[mi][ni][3] = __fadd_rn(acc[mi][ni][3], __fmul_rn(part[mi][ni][3], s1));
      }
    }
    __syncthreads();  // the next slab overwrites As/Bs
  }

  // accumulator fragment: c0,c1 at (g, 2t..2t+1), c2,c3 at (g+8, 2t..2t+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int64_t r0 = m0 + wm + mi * 16 + g;
      const int64_t col = n0 + wn + ni * 8 + t * 2;
      if (r0 < m)
        *reinterpret_cast<__nv_bfloat162*>(out + r0 * n + col) =
            __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      if (r0 + 8 < m)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * n + col) =
            __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// a (M, K) e4m3, w (K, N) e4m3, a_s (M, K/128) f32, w_s (K/128, N/128) f32
// -> out (M, N) bf16; K % 128 == 0 and N % 128 == 0
extern "C" int fp8rl_gemm(const void* a, const void* w, const void* a_s, const void* w_s,
                          void* out, int64_t m, int64_t n, int64_t k, void* stream) {
  if (m > 0) {
    const dim3 grid(static_cast<unsigned>(n / BN), static_cast<unsigned>((m + BM - 1) / BM));
    fp8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
        static_cast<const float*>(a_s), static_cast<const float*>(w_s),
        static_cast<__nv_bfloat16*>(out), m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
