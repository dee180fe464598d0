// Tensor-core and staging helpers shared by the attention bodies: the
// paged one of kernels 4 and 5 (`fp8_paged_attn.cuh`) and kernel 6's
// contiguous one (`fp8_decode.cu`).  `mma.sync.m16n8k16` bf16 -> f32,
// `ldmatrix` / `movmatrix` fragment moves, 16-byte `cp.async` copies and
// the bf16 packing of f32 pairs.
#pragma once

#include <type_traits>

#include "fp8_common.cuh"

namespace fp8rl {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the transpose of an 8x8 b16 matrix held one 32-bit pair per lane (lane
// l holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1), in the same
// fragment layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; zero-filled (the source is not read) when
// !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending groups (the newest) are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y); the
// differences are exact in f32
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
}

// fn(std::integral_constant<int, kD>()) for the least kD in {16, 32, 64,
// 128, 256} with d <= kD: the instantiated head widths
template <typename Fn>
int with_head_width(int d, Fn fn) {
  if (d <= 16) return fn(std::integral_constant<int, 16>());
  if (d <= 32) return fn(std::integral_constant<int, 32>());
  if (d <= 64) return fn(std::integral_constant<int, 64>());
  if (d <= 128) return fn(std::integral_constant<int, 128>());
  if (d <= 256) return fn(std::integral_constant<int, 256>());
  return static_cast<int>(cudaErrorInvalidValue);
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
