// What the bfloat16 kernels share: the bfloat16 tensor-core product
// mma.sync.m16n8k16 (float32 accumulation), the packing of two float32
// values into one bf16x2 operand register, ldmatrix for the transposed
// B operand, a 16-byte cp.async of untyped tiles, and 4-wide loads and
// stores that read or write float32 or bfloat16 and compute in float32.
// attention_fwd_tc.cuh (the bfloat16 instance of K2 and K3),
// attention_bwd_tc.cuh (that of K2b and K3b), attention_rel.cu (kernels R,
// Q and C) and ln_window.cu (K4, K4b) include it.
//
// bfloat16 -> float32 is exact (the top 16 bits of the float); float32 ->
// bfloat16 rounds to nearest even (__float2bfloat16_rn), as XLA's convert.
// The product of two bfloat16 values is exact in float32, so a bfloat16
// MMA differs from a float32 sum of the same products only in the order
// and rounding of its additions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// c += A.B on m16n8k16: A (m16 x k16, row-major) in four bf16x2 registers,
// B (k16 x n8, column-major) in two, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bfloat16, lo in the low half (the lower k or column index)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x / y rounded to nearest, as the Pallas kernels' p / denom, from inv =
// 1 / y rounded to nearest: the product x inv and one FMA correction of its
// residual (Markstein's), so that a row's probabilities share one
// reciprocal and no division is formed a probability
__device__ __forceinline__ float div_rn(float x, float y, float inv) {
  const float q = x * inv;
  return fmaf(fmaf(-y, q, x), inv, q);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane t gives the
// address of row t % 8 of matrix t / 8 (16 bytes each); register i then
// holds, in lane (g, tq), elements (2 tq, g) and (2 tq + 1, g) of matrix i
// as stored, which is the B fragment of a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes global -> shared; when !valid, src is not read and dst gets zeros
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element through the read-only cache, as float32
__device__ __forceinline__ float ldg_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_float(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// Four consecutive elements (16-byte aligned float32, 8-byte aligned bfloat16) as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

}  // namespace
