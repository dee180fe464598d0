// Blockwise FP8 quantizers (kernels 1 and 2 of the port).
//
// Replace `quantize_activation_kernel` (repro/kernels/fp8_quant.py:55,
// body `_quant_act_kernel` :30) and `quantize_weight_kernel` (:90, body
// `_quant_weight_kernel` :42).  Both are bound by bytes on the H100: one
// read of the source (2 B/elt bf16) and one write of the payload (1 B/elt)
// plus a scale per 128 elements (act) or 128x128 elements (weight); the
// arithmetic per element (abs, max, divide, clip, cvt) is far below the
// card's rate.  So the design reads every element exactly once into
// registers, reduces the amax there (shuffles, one shared-memory step for
// the weight block) and writes the payload packed (act) or, through a
// shared tile, as 16-byte K-major rows (weight).
//
// Kernel 1 at decode (8 x 4096 values, 98 KB) costs its launch, not its
// bytes, and runs once per distinct linear input (`core.fp8_linear.
// linears`); at prefill (M 1024-16384) it streams: 16-byte loads, several
// tiles' loads in flight per lane before any arithmetic, a grid of a few
// blocks per SM that walks the tiles.  Each block lets the GEMM behind it
// launch at once (`launch_dependents`): kernel 3 streams its weights
// while this kernel runs and waits for it only to read the activation.
#include "fp8_common.cuh"

namespace fp8rl {
namespace {

// Kernel 1's geometry: tiles whose 16-byte loads a lane issues before any
// arithmetic, threads a block, and the blocks per SM the grid is held to
// (the grid walks the tiles when they outnumber it).
constexpr int kQuantUnroll = 4;
constexpr int kQuantThreads = 256;
constexpr int kQuantBlocksPerSm = 4;

// 16 bytes a lane: 8 bf16 or 4 f32 values, so a 1x128 tile is 16 lanes
// (a warp holds two tiles) or 32 lanes (one)
template <typename T>
struct ActVec {
  static constexpr int kVals = 16 / sizeof(T);
  static constexpr int kLanes = 128 / kVals;        // lanes a tile
  static constexpr int kTiles = 32 / kLanes;        // tiles a warp
};

// the values of one 16-byte load, exactly (bf16 -> f32 is a shift)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float (&v)[ActVec<T>::kVals]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      v[i] = __uint_as_float(w[i]);
    }
  }
}

// x (M, K) contiguous is `tiles` 1x128 tiles back to back (K % 128 == 0):
// tile t is x[128 t, 128 t + 128) and its scale s[t].  A warp's slot is
// kTiles adjacent tiles; the grid's warps walk the slots, each first
// issuing the loads of kQuantUnroll slots (a grid's width apart), then
// quantizing them: amax by shuffles inside the tile's lane group, scale
// and payload by `amax_to_scale` / `quantize_one`, the payload stored
// packed (8 bytes a lane from bf16, 4 from f32).
template <typename T, int kFmt>
__global__ void __launch_bounds__(kQuantThreads) quant_act_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s, int64_t tiles,
    int pow2) {
  using V = ActVec<T>;
  launch_dependents();  // kernel 3 may start streaming its weights now
  const int lane = threadIdx.x & 31;
  const int sub = lane / V::kLanes, part = lane % V::kLanes;  // tile of the slot, 16 B of it
  const int64_t slots = (tiles + V::kTiles - 1) / V::kTiles;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kQuantThreads / 32);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * (kQuantThreads / 32) + threadIdx.x / 32;
  for (int64_t base = warp; base < slots; base += warps * kQuantUnroll) {
    uint4 raw[kQuantUnroll];
#pragma unroll
    for (int u = 0; u < kQuantUnroll; ++u) {
      const int64_t t = (base + u * warps) * V::kTiles + sub;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t < tiles) raw[u] = __ldg(reinterpret_cast<const uint4*>(x + t * 128) + part);
    }
#pragma unroll
    for (int u = 0; u < kQuantUnroll; ++u) {
      if (base + u * warps >= slots) break;  // whole warps leave together
      const int64_t t = (base + u * warps) * V::kTiles + sub;
      float v[V::kVals];
      unpack16<T>(raw[u], v);
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < V::kVals; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
      for (int off = V::kLanes / 2; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = amax_to_scale<kFmt>(amax, pow2 != 0);
      if (t >= tiles) continue;  // the lone last tile's other half-warp
      uint32_t packed[V::kVals / 4];
#pragma unroll
      for (int w = 0; w < V::kVals / 4; ++w) {
        packed[w] = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) packed[w] |= quantize_one<kFmt>(v[4 * w + i], scale) << (8 * i);
      }
      uint8_t* dst = q + t * 128 + part * V::kVals;
      if constexpr (V::kVals == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = packed[0];
      if (part == 0) s[t] = scale;  // scales (M, K/128): index row*nkb + kb
    }
  }
}

// the SM count of the current device (read once per device)
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0, uncached = 0;
  cudaGetDevice(&dev);
  int& count = dev < 64 ? counts[dev] : uncached;
  if (count == 0) cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count;
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
  using V = ActVec<T>;
  const int64_t tiles = m * (k / 128);
  const int64_t slots = (tiles + V::kTiles - 1) / V::kTiles;
  constexpr int kWarps = kQuantThreads / 32;
  const int64_t cap = static_cast<int64_t>(kQuantBlocksPerSm) * sm_count();
  const int64_t want = (slots + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  if (out_dtype == kE4M3)
    quant_act_kernel<T, kE4M3><<<grid, kQuantThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s), tiles,
        pow2);
  else
    quant_act_kernel<T, kE5M2><<<grid, kQuantThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s), tiles,
        pow2);
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
