// Blockwise FP8 quantizers (kernels 1 and 2 of the port).
//
// Replace `quantize_activation_kernel` (repro/kernels/fp8_quant.py:55,
// body `_quant_act_kernel` :30) and `quantize_weight_kernel` (:90, body
// `_quant_weight_kernel` :42).  Both are bound by bytes on the H100: one
// read of the source (2 B/elt bf16) and one write of the payload (1 B/elt)
// plus a scale per 128 elements (act) or 128x128 elements (weight); the
// arithmetic per element (abs, max, divide, clip, cvt) is far below the
// card's rate.  So the design reads every element exactly once into
// registers, reduces the amax there (warp shuffles, one shared-memory step
// for the weight block) and writes the payload packed four bytes at a time
// (act) or, through a shared tile, as 16-byte K-major rows (weight).
#include "fp8_common.cuh"

namespace fp8rl {
namespace {

// One warp per (row, 128-column tile); lane i holds columns 4i..4i+3.
template <typename T, int kFmt>
__global__ void quant_act_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                                 float* __restrict__ s, int64_t m, int64_t k, int pow2) {
  const int64_t nkb = k / 128;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= m * nkb) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int64_t base = (tile / nkb) * k + (tile % nkb) * 128 + lane * 4;
  float v[4];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = to_f32(x[base + i]);
    amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float scale = amax_to_scale<kFmt>(amax, pow2 != 0);
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) packed |= quantize_one<kFmt>(v[i], scale) << (8 * i);
  *reinterpret_cast<uint32_t*>(q + base) = packed;
  if (lane == 0) s[tile] = scale;  // scales (M, K/128): index row*nkb + kb
}

// One 256-thread block per 128x128 tile of one layer slice (grid z).
// Writes q K-major, (L, N, K): the layout kernel 3 streams.  Warp w holds
// rows w, w+8, ..., w+120; lane i columns i, i+32, i+64, i+96 (64-byte
// coalesced reads).  The fp8 bytes go through a shared tile [column][row]
// (rows 132 bytes apart: the byte stores of a warp and the word reads of
// a row hit 32 distinct banks) and leave as 16-byte K-major rows.
template <typename T, int kFmt>
__global__ void __launch_bounds__(256) quant_weight_kernel(
    const T* __restrict__ w, uint8_t* __restrict__ q, float* __restrict__ s,
    int64_t kdim, int64_t n, int pow2) {
  constexpr int kTRow = 132;
  __shared__ __align__(16) uint8_t tile[128 * kTRow];
  __shared__ float red[8];
  const int64_t nb = n / 128, kb = kdim / 128;
  const int64_t layer = blockIdx.z;
  const T* wl = w + layer * kdim * n;
  uint8_t* ql = q + layer * kdim * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * 128;
  const int64_t krow0 = static_cast<int64_t>(blockIdx.y) * 128;
  float v[16][4];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[i][j] = to_f32(wl[(krow0 + warp + 8 * i) * n + col0 + lane + 32 * j]);
      amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float a = lane < 8 ? red[lane] : 0.0f;
    a = warp_max(a);
    if (lane == 0) red[0] = a;
  }
  __syncthreads();
  const float scale = amax_to_scale<kFmt>(red[0], pow2 != 0);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tile[(lane + 32 * j) * kTRow + warp + 8 * i] =
          static_cast<uint8_t>(quantize_one<kFmt>(v[i][j], scale));
  __syncthreads();
#pragma unroll
  for (int it = 0; it < 4; ++it) {  // 128 columns x 8 chunks of 16 bytes
    const int idx = threadIdx.x + it * 256, c = idx >> 3, chunk = idx & 7;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(tile + c * kTRow + chunk * 16);
    *reinterpret_cast<uint4*>(ql + (col0 + c) * kdim + krow0 + chunk * 16) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
  if (threadIdx.x == 0) s[(layer * kb + blockIdx.y) * nb + blockIdx.x] = scale;
}

template <typename T>
void launch_act(const void* x, void* q, void* s, int64_t m, int64_t k, int out_dtype,
                int pow2, cudaStream_t stream) {
  const int64_t tiles = m * (k / 128);
  const int warps = 8;
  const unsigned grid = static_cast<unsigned>((tiles + warps - 1) / warps);
  if (out_dtype == kE4M3)
    quant_act_kernel<T, kE4M3><<<grid, warps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s), m, k, pow2);
  else
    quant_act_kernel<T, kE5M2><<<grid, warps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s), m, k, pow2);
}

template <typename T, int kFmt>
void launch_weight_fmt(const void* w, void* q, void* s, int64_t layers, int64_t kdim,
                       int64_t n, int pow2, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n / 128), static_cast<unsigned>(kdim / 128),
                  static_cast<unsigned>(layers));
  quant_weight_kernel<T, kFmt><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<uint8_t*>(q), static_cast<float*>(s), kdim, n, pow2);
}

template <typename T>
void launch_weight(const void* w, void* q, void* s, int64_t layers, int64_t kdim, int64_t n,
                   int out_dtype, int pow2, cudaStream_t stream) {
  if (out_dtype == kE4M3)
    launch_weight_fmt<T, kE4M3>(w, q, s, layers, kdim, n, pow2, stream);
  else
    launch_weight_fmt<T, kE5M2>(w, q, s, layers, kdim, n, pow2, stream);
}

}  // namespace
}  // namespace fp8rl

using namespace fp8rl;

// x (M, K) f32|bf16 with K % 128 == 0 -> q (M, K) fp8, s (M, K/128) f32
extern "C" int fp8rl_quant_act(const void* x, void* q, void* s, int64_t m, int64_t k,
                               int in_dtype, int out_dtype, int pow2, void* stream) {
  if (m > 0) {
    auto st = static_cast<cudaStream_t>(stream);
    if (in_dtype == kBF16)
      launch_act<__nv_bfloat16>(x, q, s, m, k, out_dtype, pow2, st);
    else
      launch_act<float>(x, q, s, m, k, out_dtype, pow2, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// w (L, K, N) f32|bf16 with K, N % 128 == 0 -> q fp8 stored K-major,
// (L, N, K); s (L, K/128, N/128) f32
extern "C" int fp8rl_quant_weight(const void* w, void* q, void* s, int64_t layers, int64_t kdim,
                                  int64_t n, int in_dtype, int out_dtype, int pow2,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16)
    launch_weight<__nv_bfloat16>(w, q, s, layers, kdim, n, out_dtype, pow2, st);
  else
    launch_weight<float>(w, q, s, layers, kdim, n, out_dtype, pow2, st);
  return static_cast<int>(cudaGetLastError());
}
