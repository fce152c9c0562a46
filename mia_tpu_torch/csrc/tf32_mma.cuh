// What the two tensor-core attention templates share: 3xTF32 products on
// mma.sync.m16n8k8, the cp.async tile copies that feed them and the opt-in
// to large dynamic shared memory.
// attention_fwd_tc.cuh (K2, K3, K6, K7) and attention_bwd_tc.cuh (K2b, K3b,
// K6b, K8b) include it; their comments describe how each uses these pieces.
//
// 3xTF32: a float32 operand x is split when its fragment is loaded, big = x
// rounded to TF32 (cvt.rna's rounding in two integer operations), small =
// x - big (exact; the tensor core reads its top 19 bits), and each product
// is three MMAs, small.big + big.small + big.big, the small.small term
// dropped: the result keeps float32 accuracy (~2^-21 relative per product),
// where one TF32 pass keeps ~2^-11 (tests/test_torch_attention_3xtf32.py
// emulates both).
//
// 32-bit operands have no ldmatrix; fragments are read from shared tiles
// whose rows are padded to D + 4 floats, so the 32 lanes of a fragment load
// (8 rows x 4 columns, or 4 row pairs x 8 columns) fall in 32 banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTcTile = 64;     // rows a block owns (and the backward's streamed tiles)
constexpr int kTcThreads = 128; // 4 warps of 16 rows

// cvt.rna.tf32.f32 for finite x: round the low 13 mantissa bits to nearest,
// ties away from zero
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The same, recomputed wherever it stands: a fragment that stays in
// registers across the tile loop is split at every use, so it holds 4
// float32 registers and not 8 split ones (the volatile asm is not hoisted).
__device__ __forceinline__ uint32_t tf32_round_here(float x) {
  uint32_t r;
  asm volatile("{\n\t.reg .b32 t;\n\tadd.u32 t, %1, 4096;\n\tand.b32 %0, t, 0xFFFFE000;\n\t}"
               : "=r"(r)
               : "r"(__float_as_uint(x)));
  return r;
}

// x = big + small: big is x rounded to TF32, small the exact remainder,
// whose low 13 bits the tensor core drops (it reads the top 19 bits of a
// TF32 operand), so small is truncated to TF32 as in CUTLASS's 3xTF32
// (OpMultiplyAddFastF32); the product error stays near 2^-21 relative.
template <bool kHere = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = kHere ? tf32_round_here(x) : tf32_round(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (m16 x k8, row-major) of four float32 values, split
// (kHere: at this point, for a fragment held in registers across the loop).
struct FragA {
  uint32_t big[4], small[4];
  template <bool kHere = false>
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split_tf32<kHere>(x0, big[0], small[0]);
    split_tf32<kHere>(x1, big[1], small[1]);
    split_tf32<kHere>(x2, big[2], small[2]);
    split_tf32<kHere>(x3, big[3], small[3]);
  }
};

// c += A.B in 3xTF32, B (k8 x n8, column-major) given by its two float32 values
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, a.small, bb0, bb1);
  mma_tf32(c, a.big, bs0, bs1);
  mma_tf32(c, a.big, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

// The same with zero-fill: when !valid, src is not read and dst gets 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Rows row0 .. row0+kRows-1 of one operand into a tile with rows of D + 4
// floats; rows past n are zero-filled.
template <int D, int kRows = kTcTile>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* __restrict__ base,
                                                long long stride, int row0, int n) {
  constexpr int kC = D / 4;
  for (int i = threadIdx.x; i < kRows * kC; i += kTcThreads) {
    const int r = i / kC;
    const int c = i - r * kC;
    const bool valid = row0 + r < n;
    cp_async16(dst + r * (D + 4) + 4 * c, valid ? base + (row0 + r) * stride + 4 * c : base, valid);
  }
}

// Where a tile's rel rows lie in shared memory: rel_h[q, y] at
// R[q * hs + y], rel_w[q, x] at R[woff + q * ws + x]. K3 and K3b keep the
// two input blocks apart ({kh, 64 kh, kw}); K2 and K2b keep kernel R's
// (n, kh + kw) rows ({ka, kh, ka}). Either takes 64 (kh + kw) floats.
struct RelView {
  int hs, woff, ws;
  __device__ __forceinline__ float bias(const float* R, int q, int y, int x) const {
    return R[q * hs + y] + R[woff + q * ws + x];
  }
};

template <bool kTables>
__device__ __forceinline__ RelView rel_view(int kh, int kw) {
  if constexpr (kTables) return RelView{kh + kw, kh, kh + kw};
  return RelView{kh, kTcTile * kh, kw};
}

// The rel rows of query rows q0 .. q0+rows-1 (rows <= 64) of (image, head)
// bh into R (laid out as rel_view), as 4-byte asynchronous copies of
// contiguous runs.
template <bool kTables>
__device__ __forceinline__ void copy_rel_async(float* R, const float* __restrict__ rel_h,
                                               const float* __restrict__ rel_w, long long bh,
                                               int n, int kh, int kw, int q0, int rows) {
  if constexpr (kTables) {  // one (bh, n, kh + kw) buffer
    const int ka = kh + kw;
    const float* src = rel_h + (bh * n + q0) * ka;
    for (int i = threadIdx.x; i < rows * ka; i += kTcThreads) cp_async4(R + i, src + i);
  } else {
    const float* src_h = rel_h + (bh * n + q0) * kh;
    const float* src_w = rel_w + (bh * n + q0) * kw;
    for (int i = threadIdx.x; i < rows * kh; i += kTcThreads) cp_async4(R + i, src_h + i);
    for (int i = threadIdx.x; i < rows * kw; i += kTcThreads)
      cp_async4(R + kTcTile * kh + i, src_w + i);
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
