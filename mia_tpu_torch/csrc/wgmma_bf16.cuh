// The warpgroup building blocks that the bfloat16 attention kernels on
// Hopper's wgmma share: the forward of K3 and K6 (attention_fwd_wgmma.cuh)
// and their backward K3b and K6b (attention_bwd_wgmma.cuh), at head dim 64.
//
//   - wgmma.mma_async m64nNk16 with float32 accumulators: SS (both operands
//     in shared memory, K-major) and RS (A in registers as an
//     accumulator-shaped bfloat16 fragment, B read MN-major through the
//     descriptor's transpose bit), their fences, commit and wait;
//   - mbarriers and TMA boxes (8 columns x 64 rows) from 2D tensor maps
//     (tile_map below builds them on the host, zeros past the last row), and
//     boxes of a window's tokens from 4D maps over the token grid (grid_map);
//   - the folded rel-pos operands of the Pallas kernels
//     (mia_tpu/ops/attention.py, _attn_rel_packed_kernel):
//       q_aug = [q * scale | rel_h | rel_w | 0]   against   k_aug = [k | E_h | E_w | 0],
//     kAug = 64 + kh + kw rounded up to 96 or 128 columns, E_h[key, y] =
//     (key / kw == y) and E_w[key, x] = (key % kw == x) one-hot columns, so
//     that S = q_aug . k_aug^T carries the rel bias in the product.
//
// Shared tiles use wgmma's no-swizzle layout: 8 x 8 core matrices of 128
// contiguous bytes, element (row r, column f) of a 64-row tile at
// ((f / 8) * 64 + r) * 8 + f % 8. One tile serves K-major (columns reduced:
// LBO = the next 8 columns, 1 KB; SBO = the next 8 rows, 128 B) and MN-major
// (rows reduced: LBO = 128 B, SBO = 1 KB), and a 16-byte box of 8 columns x
// 64 rows lands there as one TMA copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWgRows = 64;      // rows of a warpgroup product (wgmma's M) and of every tile
constexpr int kWgThreads = 128;  // one warpgroup a block
constexpr int kWgD = 64;         // the head dim of this instance

// element (r, f) of a 64-row tile in the no-swizzle core-matrix layout
__device__ __forceinline__ int core_off(int r, int f) {
  return ((f >> 3) * kWgRows + r) * 8 + (f & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor of the no-swizzle layout: start address,
// LBO and SBO in 16-byte units; base offset 0, layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t wg_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

constexpr uint32_t kCoreBytes = 128;                 // 8 rows of one 8-column chunk
constexpr uint32_t kChunkBytes = kWgRows * 16;       // one 8-column chunk of 64 rows

// Columns reduced (A, or B K-major): the k16 step kk of a tile
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return wg_desc(tile + kk * 2 * kWgRows * 8, kChunkBytes, kCoreBytes);
}

// Rows reduced (B MN-major): rows 16 kk .. 16 kk + 15, columns from f0 (a multiple of 8)
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int f0, int kk) {
  return wg_desc(tile + (f0 / 8) * kWgRows * 8 + kk * 16 * 8, kCoreBytes, kChunkBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous product reads or writes, so the
// compiler neither reads an accumulator before the wait nor reuses an
// operand register before it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Generic-proxy writes to shared memory (threads, cp.async) made visible to
// the async proxy that wgmma reads through; a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, float32) = or += A . B^T, A and B K-major in shared memory (acc 0: overwrite)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A . B, A (64 x 16) in registers as an accumulator-shaped
// bfloat16 fragment, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// the one arrival of a phase, expecting `bytes` from TMA copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of `parity` completes; a copy that never lands (a
// bad tensor map) traps after ~2^34 cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 8-column x 64-row box of a 2D tensor map (column c0, row r0) into dst
__device__ __forceinline__ void tma_box(bf16* dst, const CUtensorMap* map, int c0, int r0,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 4D tensor map (coordinates c0 .. c3, innermost first) into dst
__device__ __forceinline__ void tma_box4(bf16* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Columns 0 .. D-1 of a 64-row tile: D / 8 boxes from column c0
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int c0, int r0,
                                         uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < kWgD / 8; ++c) tma_box(dst + c * kWgRows * 8, map, c0 + 8 * c, r0, bar);
}

constexpr uint32_t kTileDBytes = kWgRows * kWgD * sizeof(bf16);  // one TMA tile of q, k, v or g

// Columns kWgD .. kAug-1 of k_aug for keys key0 .. key0+63: E_h at kWgD + y,
// E_w at kWgD + kh + x, zeros elsewhere and for keys past n; one 16-byte
// store per 8 columns of a row.
template <int kAug>
__device__ __forceinline__ void build_onehot(bf16* K, int key0, int n, int kh, int kw) {
  constexpr int kChunks = (kAug - kWgD) / 8;
  for (int i = threadIdx.x; i < kWgRows * kChunks; i += kWgThreads) {
    const int r = i & (kWgRows - 1);
    const int c = i >> 6;
    const int key = key0 + r;
    const bool valid = key < n;
    const int y = valid ? key / kw : 0;
    const int hx = kh + (key - y * kw);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = 8 * c + 2 * e;  // column - kWgD
      w[e] = pack_bf16x2(valid && (f == y || f == hx) ? 1.f : 0.f,
                         valid && (f + 1 == y || f + 1 == hx) ? 1.f : 0.f);
    }
    *reinterpret_cast<uint4*>(K + core_off(r, kWgD + 8 * c)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Columns kWgD .. kAug-1 of q_aug for query rows q0 .. q0+63 of (image, head)
// bh: rel_h | rel_w | 0, zeros for rows past n. kAsync (kh and kw even):
// 4-byte cp.async pairs (rows past n zero-filled; the pad columns must
// already be zero); else plain loads of element pairs, pad columns included.
template <int kAug, bool kAsync>
__device__ __forceinline__ void stage_rel_rows(bf16* Q, const bf16* __restrict__ rel_h,
                                               const bf16* __restrict__ rel_w, long long bh, int n,
                                               int kh, int kw, int q0) {
  const int ka = kh + kw;
  if constexpr (kAsync) {
    const int pairs = ka / 2;
    for (int i = threadIdx.x; i < kWgRows * pairs; i += kWgThreads) {
      const int r = i / pairs;
      const int j = 2 * (i - r * pairs);
      const bool valid = q0 + r < n;
      const long long row = bh * n + (valid ? q0 + r : 0);
      const bf16* src = j < kh ? rel_h + row * kh + j : rel_w + row * kw + (j - kh);
      cp_async4(reinterpret_cast<float*>(Q + core_off(r, kWgD + j)),
                reinterpret_cast<const float*>(src), valid);
    }
  } else {
    constexpr int kPairs = (kAug - kWgD) / 2;
    for (int i = threadIdx.x; i < kWgRows * kPairs; i += kWgThreads) {
      const int r = i / kPairs;
      const int j = 2 * (i - r * kPairs);
      float v[2] = {0.f, 0.f};
      if (q0 + r < n) {
        const long long row = bh * n + q0 + r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = j + e;
          if (f < kh) {
            v[e] = __bfloat162float(rel_h[row * kh + f]);
          } else if (f < ka) {
            v[e] = __bfloat162float(rel_w[row * kw + f - kh]);
          }
        }
      }
      *reinterpret_cast<uint32_t*>(Q + core_off(r, kWgD + j)) = pack_bf16x2(v[0], v[1]);
    }
  }
}

// Columns kWgD + kh + kw .. kAug-1 of a q_aug tile set to zero
template <int kAug>
__device__ __forceinline__ void zero_pad_columns(bf16* Q, int ka) {
  const int pad = kAug - kWgD - ka;
  for (int i = threadIdx.x; i < kWgRows * pad; i += kWgThreads) {
    const int r = i / pad;
    Q[core_off(r, kWgD + ka + (i - r * pad))] = __float2bfloat16_rn(0.f);
  }
}

// Columns 0 .. kWgD-1 of a q_aug tile scaled in place by sc (bfloat16), rounded once
__device__ __forceinline__ void scale_q_tile(bf16* Q, float sc) {
  for (int i = threadIdx.x; i < kWgRows * kWgD / 8; i += kWgThreads) {
    uint4* p = reinterpret_cast<uint4*>(Q) + i;
    uint4 u = *p;
    u.x = pack_bf16x2(bf16_lo(u.x) * sc, bf16_hi(u.x) * sc);
    u.y = pack_bf16x2(bf16_lo(u.y) * sc, bf16_hi(u.y) * sc);
    u.z = pack_bf16x2(bf16_lo(u.z) * sc, bf16_hi(u.z) * sc);
    u.w = pack_bf16x2(bf16_lo(u.w) * sc, bf16_hi(u.w) * sc);
    *p = u;
  }
}

// The bfloat16 A fragment of k16 step kk from accumulator-shaped values v
// (columns 16 kk .. 16 kk + 15), rounded to bfloat16
__device__ __forceinline__ void pack_frag(uint32_t (&a)[4], const float* v, int kk) {
  a[0] = pack_bf16x2(v[8 * kk + 0], v[8 * kk + 1]);
  a[1] = pack_bf16x2(v[8 * kk + 2], v[8 * kk + 3]);
  a[2] = pack_bf16x2(v[8 * kk + 4], v[8 * kk + 5]);
  a[3] = pack_bf16x2(v[8 * kk + 6], v[8 * kk + 7]);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPointByVersion: no link against libcuda); null if the
// installed CUDA library lacks it.
using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// A 2D map over `rows` rows of `cols` bfloat16 elements, `stride` elements
// apart: boxes of box_cols columns x box_rows rows in `swizzle`'s layout,
// zeros past the last row.
bool tile_map(CUtensorMap* m, const void* base, long long cols, long long rows,
              long long stride, int box_cols = 8, int box_rows = kWgRows,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride * sizeof(bf16))};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4D map over a (batch, hg, wg) grid of token rows `stride` elements apart,
// `cols` bfloat16 elements of each: boxes of box_c columns x box_w columns x
// box_h rows of the grid x 1 image in `swizzle`'s layout (the forward's: 64
// columns in the 128-byte swizzle), zeros past the grid's edges. A box lands
// its tokens in row-major order, one row of box_c columns each: a ws x ws
// box at (wx ws, wy ws) is a window's slots in slot order.
bool grid_map(CUtensorMap* m, const void* base, long long cols, long long stride, int wg, int hg,
              int batch, int box_w, int box_h, int box_c = 64,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(stride * sizeof(bf16));
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(wg),
                              static_cast<cuuint64_t>(hg), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * wg, row * wg * hg};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory above 48 KB, and the largest carve-out, so three blocks fit an SM
template <typename Kernel>
cudaError_t allow_wg_smem(Kernel kernel, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace
