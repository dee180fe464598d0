// Shared helpers of the port's FP8 kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fp8rl {

// dtype codes passed from Python (kernels/build.py)
enum DType : int { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int kFmt> struct Fp8Format;
template <> struct Fp8Format<kE4M3> {
  static constexpr float kMax = 448.0f;
  static constexpr __nv_fp8_interpretation_t kInterp = __NV_E4M3;
};
template <> struct Fp8Format<kE5M2> {
  static constexpr float kMax = 57344.0f;
  static constexpr __nv_fp8_interpretation_t kInterp = __NV_E5M2;
};

// fp8 byte -> f32 (exact)
template <int kFmt>
__device__ __forceinline__ float fp8_to_f32(uint8_t v) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v),
                                         Fp8Format<kFmt>::kInterp);
  return __half2float(__half(h));
}

// scale = max(amax, 1e-12) * f32(1 / fp8_max): the compiled reference folds
// its division by the constant fp8_max into this multiply.  UE8M0 rounds it
// up to "2^ceil(log2 s)" computed as the reference computes exp2:
// exp(f32(ln 2) * e), which is not always an exact power of two.
template <int kFmt>
__device__ __forceinline__ float amax_to_scale(float amax, bool pow2) {
  constexpr float kRecip = 1.0f / Fp8Format<kFmt>::kMax;
  float s = __fmul_rn(fmaxf(amax, 1e-12f), kRecip);
  if (pow2) s = expf(__fmul_rn(0.693147182f, ceilf(log2f(s))));
  return s;
}

// clip(x / scale) then a round-to-nearest-even cast (IEEE divide, no
// reciprocal: the payload must match the reference bit for bit)
template <int kFmt>
__device__ __forceinline__ uint32_t quantize_one(float x, float scale) {
  const float m = Fp8Format<kFmt>::kMax;
  const float q = fminf(fmaxf(__fdiv_rn(x, scale), -m), m);
  return static_cast<uint32_t>(
      __nv_cvt_float_to_fp8(q, __NV_SATFINITE, Fp8Format<kFmt>::kInterp));
}

// Programmatic dependent launch (Hopper).  A kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it in the stream still runs: `grid_dependency_wait`
// blocks until that kernel has completed and its writes are visible, and
// `launch_dependents` lets the next such kernel start early.  Both are
// no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace fp8rl
