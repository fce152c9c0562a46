// K10 and K10b on Hopper: the k=2/s=2 transposed convolution (2x upsample)
// and its backward, float32 in and out, or bfloat16 in and out with a
// float32 bias (the bfloat16 instances, K10.bf16 and K10b.bf16).
//
// Replaces the TPU kernels mia_tpu/ops/upsample2x.py::conv_transpose2x_p
// (_fwd_impl/_fwd_kernel) and ::_bwd_impl (_bwd_kernel). For x (B, H, W, Cin),
// w (2, 2, Cin, Cout) (taps not reversed) and bias (Cout,)
//
//   y[b, 2i+di, 2j+dj, :] = x[b, i, j, :] . w[di, dj] + bias
//
// A k2/s2 transposed convolution gives every output pixel exactly one tap, so
// the whole function is one matrix product of the (B*H*W, Cin) pixels with
// the (Cin, 4*Cout) taps. What the TPU kernel is about is the layout: the
// output is written directly as (B, H, 2, W, 2*Cout), which is row-major
// (B, 2H, 2W, Cout), so no interleaved copy of the upsampled tensor is ever
// made, and the backward reads the cotangent in the same layout. The TPU
// kernel walks row bands on a sequential grid and carries dw/db in scratch
// from step to step; here blocks are independent:
//
//   forward  out(pixel, tap*Cout+co)  = sum_ci  x(pixel, ci) w(tap, ci, co) + bias(co)
//   dx       dx(pixel, ci)            = sum_tap,co dy(pixel, tap, co) w(tap, ci, co)
//   dw       part(chunk, ci, tap, co) = sum over the chunk's pixels x(pixel, ci) dy(pixel, tap, co)
//
// Each is one instance of a tile product; the instances differ in how a tile
// is fetched (x rows, the 5-D layout, or the tap matrix, each along its
// contiguous axis) and in where the result goes. dw splits the pixels into
// chunks, one per blockIdx.z, and a second kernel adds the chunks' partials
// in a fixed order; db rides along as the column sums of the dy tiles. No
// atomics, so two launches agree bit for bit.
//
// Two tile products, picked per product by what bounds it (route_tc()):
//
// * Tensor cores, 3xTF32 (conv_transpose2x_tc_kernel), where the product's
//   float32 time is set by operations (2*M*N*K at 67 TFLOP/s at least its
//   operands and result once at 3.35 TB/s): every product of the UNet
//   decoder, of SAM's upscaler and of the prompt-large stages 1-2.
//   mma.sync.m16n8k8 TF32 on the helpers of tf32_mma.cuh: every operand x =
//   big + small, split when its fragment is read from shared memory, three
//   MMAs a product. The operand tiles stream global -> shared by 16-byte
//   cp.async into a ring of three 32-deep stages; rows are padded (+4 floats
//   for [m][k] / [n][k] tiles, +8 for [k][m] / [k][n] ones) so the 32 lanes
//   of a fragment read hit 32 banks, and the ragged edges (pixels, Cin 48 or
//   520, 4*Cout 80) are zero-filled by the copies. Each 32-deep chain of
//   MMAs starts from zero and is added to a float32 accumulator by one
//   rounded add: the tensor core truncates each sum into its accumulator, so
//   a chain through the whole depth (512-3072) reads 12-67x further from
//   float64 (as K3 found, attention_fwd_tc.cuh; tests/test_torch_upsample2x_3xtf32.py
//   emulates both). Blocks of 4 warps, each a 64 x 32 piece of a 128 x 64
//   tile (64 x 128 for dw with Cin <= 64): ~215 registers, two blocks an SM,
//   which beat one 128 x 128 block of 8 warps (its barriers stall all 8).
//   The result is staged through shared memory so that it leaves as 16-byte
//   stores along each pixel's 2*Cout runs (an mma accumulator holds 8-byte
//   pairs). dw takes about one wave of blocks (tiles x chunks <= SMs x 2)
//   and spreads db's column sums over all threads of the first row of blocks.
//   mma.sync rather than wgmma: TF32 wgmma wants both operands K-major in
//   shared memory, which only the forward's x tile and dx's operands are;
//   dw's x tile and the forward's taps are not, and 3xTF32 would need the
//   big and small halves of both as separate tiles.
//   Bound at the 3xTF32 rate (495/3 TFLOP/s): UNet stage 1 (3072 pixels,
//   512 -> 4*256) 19.5 us forward, against 48.1 on the CUDA cores. What
//   holds the tile back is latency at 8 warps an SM (the fold's second
//   accumulator costs 64 registers a thread).
//
// * CUDA cores, float32 (conv_transpose2x_gemm_kernel), for the thin stages
//   (Cin, Cout 16-32: prompt-large 3-4), whose time is set by the bytes of
//   the (B, 2H, 2W, Cout) tensor and where this tile beats the tensor cores:
//   256 threads, a BM x BN tile of the result in registers, 16-deep slices
//   staged through shared memory, the tile picked by the width of the result
//   so a thin stage does not compute padding.
//
// bfloat16 (the Pallas kernel on bfloat16 operands: x, w and dy bfloat16, the
// bias float32; every product summed in float32, the float32 bias added and
// each output rounded once: y and dx to bfloat16, dw to bfloat16 from its
// float32 chunk partials, db float32). Channel counts are multiples of 8
// (16 bytes). The same three products, the same layouts and the same rule:
//
// * Tensor cores (conv_transpose2x_bf16_tc_kernel): bfloat16 mma.sync.m16n8k16
//   with float32 accumulators (bf16_mma.cuh), one MMA a product: a product of
//   two bfloat16 values is exact in float32, so no split. The TF32 kernel's
//   ring (three 32-deep stages by 16-byte cp.async, zero-filled edges), tiles
//   (128 x 64, or 64 x 128 for dw with Cin <= 64, by warps of 64 x 32), fold
//   (each 32-deep chain, two k16 MMAs, added to a float32 accumulator: the
//   tensor core truncates into its accumulator) and staged result (float32
//   in shared memory, then 16-byte stores of 8 bfloat16 along each pixel's
//   2*Cout run, the bias added before the one rounding). Rows are padded by
//   8 elements (16 bytes): a [m][k] / [n][k] row of 40 elements puts the 8
//   rows x 4 words of a fragment read in 32 banks, and the fragments of the
//   [k][m] / [k][n] tiles (dw's x; the forward's taps and dw's dy) are read
//   transposed by ldmatrix.trans from rows 16-byte aligned.
// * CUDA cores (conv_transpose2x_gemm_kernel<__nv_bfloat16, ...>): the float32
//   tile on bfloat16 loads (4 elements, 8 bytes), float32 FMA, and one rounding
//   on the store.
// * The one pass (conv_transpose2x_bwd_onepass_kernel, below): the backward's
//   dx, dw and db from one read of x and dy, as the Pallas kernel makes them,
//   where route_onepass() takes a stage (Cin <= 64, Cout <= 32: prompt-large
//   2-4, UNet 4, SAM 2); then the reduce of dw and that of db.
//
// route_tc() keeps one rule for both types, with the bytes counted at the
// operands' width: the tensor cores wherever the product's time on the CUDA
// cores (float32 FMA at 67 TFLOP/s) would exceed its operands and result
// crossing device memory once (3.35 TB/s), i.e. at 20 flops a byte. In
// bfloat16 a product has half the bytes, so prompt-large stage 3 (12 x 128 x
// 128, 32 -> 16: 21 flops a byte) moves to the tensor cores; stage 4 (13
// flops a byte) stays on the CUDA cores. Both routes are bound by bytes there.
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // depth of one shared-memory slice of the SIMT tile
constexpr int kSms = 132;  // the H100's SMs: what dw's chunk counts are sized for
enum { kFwd = 0, kDx = 1, kDw = 2 };

// Offset of (pixel m, column n = tap*Cout + co) in the (B, H, 2, W, 2*Cout)
// layout; m = (b*H + i)*W + j, tap = 2*di + dj. A run of four columns that
// starts at a multiple of 4 stays inside one tap (Cout is a multiple of 4).
__device__ __forceinline__ long long div_w(long long m, int W) {  // m / W, in 32 bits where it fits
  return m <= 0xffffffffLL ? static_cast<long long>(static_cast<unsigned>(m) / static_cast<unsigned>(W))
                           : m / W;
}

__device__ __forceinline__ long long y5_offset(long long m, int n, int W, int Cout) {
  const long long t = div_w(m, W);
  const int j = static_cast<int>(m - t * W);
  const int di = n >= 2 * Cout ? 1 : 0;
  return ((2 * t + di) * W + j) * (2LL * Cout) + (n - di * 2 * Cout);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The product (M x N, depth K) of each mode: forward pixels x 4*Cout over
// Cin, dx pixels x Cin over 4*Cout, dw Cin x 4*Cout over the pixels.
__host__ __device__ __forceinline__ void product_dims(int mode, long long pixels, int Cin,
                                                      int Cout, long long* M, long long* N,
                                                      long long* K) {
  const long long c4 = 4LL * Cout;
  *M = mode == kDw ? Cin : pixels;
  *N = mode == kDx ? Cin : c4;
  *K = mode == kFwd ? Cin : mode == kDx ? c4 : pixels;
}

// What a block of mode MODE computes: rows M, columns N, depth k_begin ..
// k_end (dw: the pixels of chunk blockIdx.z).
struct Product {
  long long M, k_begin, k_end;
  int N;
};

template <int MODE>
__device__ __forceinline__ Product product_of(long long pixels, int Cin, int Cout,
                                              long long chunk_len) {
  long long M, N, K;
  product_dims(MODE, pixels, Cin, Cout, &M, &N, &K);
  long long k_begin = 0;
  if (MODE == kDw) {
    k_begin = static_cast<long long>(blockIdx.z) * chunk_len;
    K = k_begin + chunk_len < pixels ? k_begin + chunk_len : pixels;
  }
  return {M, k_begin, K, static_cast<int>(N)};
}

// ---------------------------------------------------------------------------
// Tensor-core tile product (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kTcBK = 32;   // depth of a stage of the cp.async ring
constexpr int kStages = 3;  // stages of the ring
constexpr int kFold = 32;   // depth of each MMA chain before its fold into float32

// Shared-memory layout of one instance. A is [m][k] (forward: x rows; dx: dy
// rows) or, for dw, [k][m] (x rows are pixels); B is [k][n] (forward: the
// taps; dw: dy rows) or, for dx, [n][k] (the taps read along co).
template <int MODE, int BM, int BN>
struct TcLayout {
  static constexpr bool kAkm = MODE == kDw;
  static constexpr bool kBnk = MODE == kDx;
  static constexpr int kALd = kAkm ? BM + 8 : kTcBK + 4;
  static constexpr int kBLd = kBnk ? kTcBK + 4 : BN + 8;
  static constexpr int kASize = kAkm ? kTcBK * kALd : BM * kALd;
  static constexpr int kBSize = kBnk ? BN * kBLd : kTcBK * kBLd;
  static constexpr int kStage = kASize + kBSize;
  static constexpr int kCLd = BN + 8;  // the staged result tile
  static constexpr int kFloats =
      kStages * kStage > BM * kCLd ? kStages * kStage : BM * kCLd;
  static constexpr size_t kBytes = sizeof(float) * kFloats + sizeof(long long) * BM;

  __device__ static __forceinline__ float a(const float* As, int m, int k) {
    return kAkm ? As[k * kALd + m] : As[m * kALd + k];
  }
  __device__ static __forceinline__ float b(const float* Bs, int k, int n) {
    return kBnk ? Bs[n * kBLd + k] : Bs[k * kBLd + n];
  }
};

// One BM x BN tile of (M, N as product_of)
//   kFwd: out = x . taps + bias    kDx: dx = dy . taps^T    kDw: part[z] = x^T . dy
// by WM x WN warps, each a (BM / WM) x (BN / WN) piece of 16 x 8 fragments.
template <int MODE, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) conv_transpose2x_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ dy,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ col_sums,
    long long pixels, int W, int Cin, int Cout, long long chunk_len) {
  using L = TcLayout<MODE, BM, BN>;
  constexpr int kT = WM * WN * 32;
  constexpr int kMI = BM / WM / 16;  // 16-row fragments of a warp
  constexpr int kNJ = BN / WN / 8;   // 8-column fragments of a warp
  static_assert(kMI >= 1 && kNJ >= 1 && kT % BN == 0 && kT % 8 == 0,
                "tile does not match the block");
  extern __shared__ float4 tc_smem4[];
  float* smem = reinterpret_cast<float*>(tc_smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in group
  const int wm0 = (warp / WN) * (BM / WM);
  const int wn0 = (warp % WN) * (BN / WN);
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const Product p = product_of<MODE>(pixels, Cin, Cout, chunk_len);
  const long long slices = (p.k_end - p.k_begin + kTcBK - 1) / kTcBK;
  const long long row5 = 2LL * W * Cout;  // floats between output rows 2i and 2i+1

  // What stays fixed for a thread across stages: the A rows or B columns it copies.
  // [m][k] tiles: row tid / kQ + i * (kT / kQ), column quad tid % kQ.
  constexpr int kQ = kTcBK / 4;
  constexpr int kRowsA = BM * kQ / kT;
  long long a_row[L::kAkm ? 1 : kRowsA];  // offset of the row's column 0, -1 past M
  if constexpr (!L::kAkm) {
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const long long m = m0 + tid / kQ + i * (kT / kQ);
      if (m >= p.M) {
        a_row[i] = -1;
      } else if (MODE == kFwd) {
        a_row[i] = m * Cin;
      } else {  // the tap row di = 0 of pixel m in dy's (B, H, 2, W, 2*Cout) layout
        const long long t = div_w(m, W);
        a_row[i] = (2 * t * W + (m - t * W)) * (2LL * Cout);
      }
    }
  }
  // [k][n] tiles: column quad tid % (BN / 4), row tid / (BN / 4) + i * (kT / (BN / 4))
  const int bq = tid % (BN / 4);
  const int bn = n0 + 4 * bq;
  long long b_col = -1;  // forward: offset of the taps' column; dw: dy's column in the 5-D row
  if (!L::kBnk && bn < p.N) {
    const int tap = bn / Cout;
    const int co = bn - tap * Cout;
    b_col = MODE == kFwd ? static_cast<long long>(tap) * Cin * Cout + co
                         : (tap >> 1) * row5 + (tap & 1) * Cout + co;
  }

  auto load = [&](int stage, long long k0) {
    float* As = smem + stage * L::kStage;
    float* Bs = As + L::kASize;
    if constexpr (L::kAkm) {  // dw: x(pixel k, ci m), contiguous along m
      for (int i = tid; i < kTcBK * (BM / 4); i += kT) {
        const int k = i / (BM / 4);
        const int q = i - k * (BM / 4);
        const long long pix = k0 + k;
        const long long m = m0 + 4 * q;
        const bool ok = pix < p.k_end && m < p.M;
        cp_async16(As + k * L::kALd + 4 * q, ok ? x + pix * Cin + m : x, ok);
      }
    } else {  // x(pixel m, ci k) or dy(pixel m, column k): contiguous along k
      const int q = tid % kQ;
      const long long k = k0 + 4 * q;
      const bool k_ok = k < p.k_end;
      long long col = k;
      if (MODE == kDx) {
        const int di = k >= 2 * Cout ? 1 : 0;
        col = di * row5 + (k - di * 2 * Cout);
      }
      const float* base = MODE == kFwd ? x : dy;
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const bool ok = k_ok && a_row[i] >= 0;
        cp_async16(As + (tid / kQ + i * (kT / kQ)) * L::kALd + 4 * q,
                   ok ? base + a_row[i] + col : base, ok);
      }
    }
    if constexpr (L::kBnk) {  // dx: w(tap, ci n, co) with k = tap*Cout + co: contiguous along k
      const int q = tid % kQ;
      const long long k = k0 + 4 * q;
      const int tap = static_cast<int>(k / Cout);
      const long long col = static_cast<long long>(tap) * Cin * Cout + (k - tap * Cout);
      for (int r = tid / kQ; r < BN; r += kT / kQ) {
        const int n = n0 + r;
        const bool ok = k < p.k_end && n < p.N;
        cp_async16(Bs + r * L::kBLd + 4 * q, ok ? w + col + static_cast<long long>(n) * Cout : w,
                   ok);
      }
    } else {  // w(tap, ci k, co) or dy(pixel k, column n): contiguous along n
      for (int r = tid / (BN / 4); r < kTcBK; r += kT / (BN / 4)) {
        const long long k = k0 + r;
        const bool ok = k < p.k_end && b_col >= 0;
        const float* src = w;
        if (ok) {
          if (MODE == kFwd) {
            src = w + b_col + k * Cout;
          } else {
            const long long t = div_w(k, W);
            src = dy + (2 * t * W + (k - t * W)) * (2LL * Cout) + b_col;
          }
        }
        cp_async16(Bs + r * L::kBLd + 4 * bq, src, ok);
      }
    }
  };

  float acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  // dw, first row of blocks: this thread's share of the column sums of dy
  // (db), column tid % BN over kSumRows rows of each stage from row group tid / BN
  constexpr int kSumRows = kTcBK * BN / kT;
  float bsum = 0.f;
  const bool sums = MODE == kDw && blockIdx.x == 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s, p.k_begin + static_cast<long long>(s) * kTcBK);
    cp_async_commit();
  }
  for (long long it = 0; it < slices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for every thread; stage it - 1 is free
    const long long next = it + kStages - 1;
    if (next < slices) load(static_cast<int>(next % kStages), p.k_begin + next * kTcBK);
    cp_async_commit();

    const float* As = smem + static_cast<int>(it % kStages) * L::kStage;
    const float* Bs = As + L::kASize;
    if (sums) {
#pragma unroll 8
      for (int k = 0; k < kSumRows; ++k) bsum += L::b(Bs, (tid / BN) * kSumRows + k, tid % BN);
    }
#pragma unroll
    for (int f = 0; f < kTcBK; f += kFold) {
      float part[kMI][kNJ][4];  // this chain, from zero
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
      }
#pragma unroll
      for (int kk = f; kk < f + kFold; kk += 8) {
        uint32_t bb[kNJ][2], bs[kNJ][2];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = wn0 + 8 * j + g;
          split_tf32(L::b(Bs, kk + tq, n), bb[j][0], bs[j][0]);
          split_tf32(L::b(Bs, kk + tq + 4, n), bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          const int m = wm0 + 16 * i + g;
          FragA fa;
          fa.set(L::a(As, m, kk + tq), L::a(As, m + 8, kk + tq), L::a(As, m, kk + tq + 4),
                 L::a(As, m + 8, kk + tq + 4));
          // small.big, big.small, big.big, each over the warp's columns, so
          // that kNJ independent MMAs stand between two into one accumulator
#pragma unroll
          for (int j = 0; j < kNJ; ++j) mma_tf32(part[i][j], fa.small, bb[j][0], bb[j][1]);
#pragma unroll
          for (int j = 0; j < kNJ; ++j) mma_tf32(part[i][j], fa.big, bs[j][0], bs[j][1]);
#pragma unroll
          for (int j = 0; j < kNJ; ++j) mma_tf32(part[i][j], fa.big, bb[j][0], bb[j][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
        }
      }
    }
  }

  // ---- the result, staged through shared memory as Cs[m][n] ----
  cp_async_wait<0>();
  __syncthreads();  // every stage consumed
  float* Cs = smem;
  long long* rowoff = reinterpret_cast<long long*>(smem + L::kFloats);
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      float* c = Cs + (wm0 + 16 * i + g) * L::kCLd + wn0 + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + 8 * L::kCLd) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  for (int r = tid; r < BM; r += kT) {  // offset of each row's column 0
    const long long m = m0 + r;
    if (MODE == kFwd) {  // tap row di = 0 of the (B, H, 2, W, 2*Cout) output
      const long long t = div_w(m, W);
      rowoff[r] = (2 * t * W + (m - t * W)) * (2LL * Cout);
    } else if (MODE == kDx) {
      rowoff[r] = m * Cin;
    } else {
      rowoff[r] = (static_cast<long long>(blockIdx.z) * p.M + m) * p.N;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * (BN / 4); idx += kT) {
    const int r = idx / (BN / 4);
    const int c = 4 * (idx - r * (BN / 4));
    const int n = n0 + c;
    if (m0 + r >= p.M || n >= p.N) continue;
    float4 v = *reinterpret_cast<const float4*>(Cs + r * L::kCLd + c);
    long long off = rowoff[r] + n;
    if (MODE == kFwd) {
      const int di = n >= 2 * Cout ? 1 : 0;
      const int n2 = n - di * 2 * Cout;  // dj*Cout + co
      const float4 bv = ldg4(bias + (n2 >= Cout ? n2 - Cout : n2));
      v.x += bv.x;
      v.y += bv.y;
      v.z += bv.z;
      v.w += bv.w;
      off = rowoff[r] + di * row5 + n2;
    }
    *reinterpret_cast<float4*>(out + off) = v;
  }
  if (sums) {  // the row groups' sums of each column, added in order
    __syncthreads();  // the staged tile read
    smem[tid] = bsum;
    __syncthreads();
    if (tid < BN && n0 + tid < p.N) {
      float total = 0.f;
#pragma unroll
      for (int h = 0; h < kT / BN; ++h) total += smem[h * BN + tid];
      col_sums[static_cast<long long>(blockIdx.z) * p.N + n0 + tid] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core tile product (bfloat16)
// ---------------------------------------------------------------------------

// Shared-memory layout of one bfloat16 instance, in elements: A and B as
// TcLayout's (A [m][k] or, for dw, [k][m]; B [k][n] or, for dx, [n][k]),
// every row padded by 8 elements (16 bytes); the result is staged in float32.
template <int MODE, int BM, int BN>
struct Bf16Layout {
  static constexpr bool kAkm = MODE == kDw;
  static constexpr bool kBnk = MODE == kDx;
  static constexpr int kALd = kAkm ? BM + 8 : kTcBK + 8;
  static constexpr int kBLd = kBnk ? kTcBK + 8 : BN + 8;
  static constexpr int kASize = kAkm ? kTcBK * kALd : BM * kALd;
  static constexpr int kBSize = kBnk ? BN * kBLd : kTcBK * kBLd;
  static constexpr int kStage = kASize + kBSize;
  static constexpr int kCLd = BN + 8;  // the staged result tile, floats
  static constexpr size_t kRing = sizeof(bf16) * kStages * kStage;
  static constexpr size_t kTile = sizeof(float) * BM * kCLd;
  static constexpr size_t kBody = kRing > kTile ? kRing : kTile;
  static constexpr size_t kBytes = kBody + sizeof(long long) * BM;
};

__device__ __forceinline__ uint32_t ld_bf16x2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Eight consecutive outputs from float32: 16 bytes of bfloat16 or 32 of float32
__device__ __forceinline__ void store8(bf16* p, float4 a, float4 b) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                 pack_bf16x2(b.z, b.w));
}
__device__ __forceinline__ void store8(float* p, float4 a, float4 b) {
  *reinterpret_cast<float4*>(p) = a;
  *reinterpret_cast<float4*>(p + 4) = b;
}

// One BM x BN tile of (M, N as product_of) from bfloat16 operands
//   kFwd: out = x . taps + bias    kDx: dx = dy . taps^T    kDw: part[z] = x^T . dy
// out is bfloat16 (forward, dx) or the float32 partials (dw); by WM x WN
// warps, each a (BM / WM) x (BN / WN) piece of 16 x 8 fragments.
template <int MODE, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) conv_transpose2x_bf16_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ dy,
    const float* __restrict__ bias, void* __restrict__ out_v, float* __restrict__ col_sums,
    long long pixels, int W, int Cin, int Cout, long long chunk_len) {
  using L = Bf16Layout<MODE, BM, BN>;
  using Out = std::conditional_t<MODE == kDw, float, bf16>;
  Out* out = static_cast<Out*>(out_v);
  constexpr int kT = WM * WN * 32;
  constexpr int kMI = BM / WM / 16;  // 16-row fragments of a warp
  constexpr int kNJ = BN / WN / 8;   // 8-column fragments of a warp, in pairs
  static_assert(kMI >= 1 && kNJ % 2 == 0 && kT % BN == 0 && kTcBK == kFold,
                "tile does not match the block");
  extern __shared__ float4 bf_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(bf_smem4);
  float* smem = reinterpret_cast<float*>(bf_smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in group
  const int wm0 = (warp / WN) * (BM / WM);
  const int wn0 = (warp % WN) * (BN / WN);
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const Product p = product_of<MODE>(pixels, Cin, Cout, chunk_len);
  const long long slices = (p.k_end - p.k_begin + kTcBK - 1) / kTcBK;
  const long long row5 = 2LL * W * Cout;  // elements between output rows 2i and 2i+1

  // What stays fixed for a thread across stages: the A rows or B columns it
  // copies, in 16-byte chunks of 8 elements. [m][k] tiles: row tid / kQ +
  // i * (kT / kQ), chunk tid % kQ.
  constexpr int kQ = kTcBK / 8;
  constexpr int kRowsA = BM * kQ / kT;
  long long a_row[L::kAkm ? 1 : kRowsA];  // offset of the row's column 0, -1 past M
  if constexpr (!L::kAkm) {
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const long long m = m0 + tid / kQ + i * (kT / kQ);
      if (m >= p.M) {
        a_row[i] = -1;
      } else if (MODE == kFwd) {
        a_row[i] = m * Cin;
      } else {  // the tap row di = 0 of pixel m in dy's (B, H, 2, W, 2*Cout) layout
        const long long t = div_w(m, W);
        a_row[i] = (2 * t * W + (m - t * W)) * (2LL * Cout);
      }
    }
  }
  // [k][n] tiles: chunk tid % (BN / 8), row tid / (BN / 8) + i * (kT / (BN / 8))
  const int bq = tid % (BN / 8);
  const int bn = n0 + 8 * bq;
  long long b_col = -1;  // forward: offset of the taps' column; dw: dy's column in the 5-D row
  if (!L::kBnk && bn < p.N) {
    const int tap = bn / Cout;
    const int co = bn - tap * Cout;
    b_col = MODE == kFwd ? static_cast<long long>(tap) * Cin * Cout + co
                         : (tap >> 1) * row5 + (tap & 1) * Cout + co;
  }

  auto load = [&](int stage, long long k0) {
    bf16* As = ring + stage * L::kStage;
    bf16* Bs = As + L::kASize;
    if constexpr (L::kAkm) {  // dw: x(pixel k, ci m), contiguous along m
      for (int i = tid; i < kTcBK * (BM / 8); i += kT) {
        const int k = i / (BM / 8);
        const int q = i - k * (BM / 8);
        const long long pix = k0 + k;
        const long long m = m0 + 8 * q;
        const bool ok = pix < p.k_end && m < p.M;
        cp_async16_bytes(As + k * L::kALd + 8 * q, ok ? x + pix * Cin + m : x, ok);
      }
    } else {  // x(pixel m, ci k) or dy(pixel m, column k): contiguous along k
      const int q = tid % kQ;
      const long long k = k0 + 8 * q;
      const bool k_ok = k < p.k_end;
      long long col = k;
      if (MODE == kDx) {
        const int di = k >= 2 * Cout ? 1 : 0;
        col = di * row5 + (k - di * 2 * Cout);
      }
      const bf16* base = MODE == kFwd ? x : dy;
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const bool ok = k_ok && a_row[i] >= 0;
        cp_async16_bytes(As + (tid / kQ + i * (kT / kQ)) * L::kALd + 8 * q,
                         ok ? base + a_row[i] + col : base, ok);
      }
    }
    if constexpr (L::kBnk) {  // dx: w(tap, ci n, co) with k = tap*Cout + co: contiguous along k
      const int q = tid % kQ;
      const long long k = k0 + 8 * q;
      const int tap = static_cast<int>(k / Cout);
      const long long col = static_cast<long long>(tap) * Cin * Cout + (k - tap * Cout);
      for (int r = tid / kQ; r < BN; r += kT / kQ) {
        const int n = n0 + r;
        const bool ok = k < p.k_end && n < p.N;
        cp_async16_bytes(Bs + r * L::kBLd + 8 * q,
                         ok ? w + col + static_cast<long long>(n) * Cout : w, ok);
      }
    } else {  // w(tap, ci k, co) or dy(pixel k, column n): contiguous along n
      for (int r = tid / (BN / 8); r < kTcBK; r += kT / (BN / 8)) {
        const long long k = k0 + r;
        const bool ok = k < p.k_end && b_col >= 0;
        const bf16* src = w;
        if (ok) {
          if (MODE == kFwd) {
            src = w + b_col + k * Cout;
          } else {
            const long long t = div_w(k, W);
            src = dy + (2 * t * W + (k - t * W)) * (2LL * Cout) + b_col;
          }
        }
        cp_async16_bytes(Bs + r * L::kBLd + 8 * bq, src, ok);
      }
    }
  };

  float acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  // dw, first row of blocks: this thread's share of the column sums of dy
  // (db), column tid % BN over kSumRows rows of each stage from row group tid / BN
  constexpr int kSumRows = kTcBK * BN / kT;
  float bsum = 0.f;
  const bool sums = MODE == kDw && blockIdx.x == 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s, p.k_begin + static_cast<long long>(s) * kTcBK);
    cp_async_commit();
  }
  for (long long it = 0; it < slices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for every thread; stage it - 1 is free
    const long long next = it + kStages - 1;
    if (next < slices) load(static_cast<int>(next % kStages), p.k_begin + next * kTcBK);
    cp_async_commit();

    const bf16* As = ring + static_cast<int>(it % kStages) * L::kStage;
    const bf16* Bs = As + L::kASize;
    if (sums) {
#pragma unroll 8
      for (int k = 0; k < kSumRows; ++k)
        bsum += __bfloat162float(Bs[((tid / BN) * kSumRows + k) * L::kBLd + tid % BN]);
    }
    // the stage is one 32-deep chain (two k16 MMAs), from zero
    float part[kMI][kNJ][4];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t bfr[kNJ][2];
      if constexpr (L::kBnk) {  // [n][k]: a register is two neighbours along k
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const bf16* r = Bs + (wn0 + 8 * j + g) * L::kBLd + kk + 2 * tq;
          bfr[j][0] = ld_bf16x2(r);
          bfr[j][1] = ld_bf16x2(r + 8);
        }
      } else {  // [k][n]: two 8-column fragments a transposed load
#pragma unroll
        for (int j = 0; j < kNJ; j += 2) {
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, Bs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kBLd + wn0 +
                                    8 * j + (lane >> 4) * 8);
          bfr[j][0] = b4[0];
          bfr[j][1] = b4[1];
          bfr[j + 1][0] = b4[2];
          bfr[j + 1][1] = b4[3];
        }
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        uint32_t a[4];
        if constexpr (L::kAkm) {  // [k][m]: matrices (k 0-7, m 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
          ldmatrix_x4_trans(a, As + (kk + (lane & 7) + ((lane >> 4) << 3)) * L::kALd + wm0 +
                                   16 * i + ((lane >> 3) & 1) * 8);
        } else {  // [m][k]: rows g and g + 8, k 2 tq and 2 tq + 8
          const bf16* r0 = As + (wm0 + 16 * i + g) * L::kALd + kk + 2 * tq;
          const bf16* r1 = r0 + 8 * L::kALd;
          a[0] = ld_bf16x2(r0);
          a[1] = ld_bf16x2(r1);
          a[2] = ld_bf16x2(r0 + 8);
          a[3] = ld_bf16x2(r1 + 8);
        }
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma_bf16(part[i][j], a, bfr[j][0], bfr[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
    }
  }

  // ---- the result, staged through shared memory as Cs[m][n] in float32 ----
  cp_async_wait<0>();
  __syncthreads();  // every stage consumed
  float* Cs = smem;
  long long* rowoff = reinterpret_cast<long long*>(reinterpret_cast<unsigned char*>(smem) + L::kBody);
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      float* c = Cs + (wm0 + 16 * i + g) * L::kCLd + wn0 + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + 8 * L::kCLd) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  for (int r = tid; r < BM; r += kT) {  // offset of each row's column 0
    const long long m = m0 + r;
    if (MODE == kFwd) {  // tap row di = 0 of the (B, H, 2, W, 2*Cout) output
      const long long t = div_w(m, W);
      rowoff[r] = (2 * t * W + (m - t * W)) * (2LL * Cout);
    } else if (MODE == kDx) {
      rowoff[r] = m * Cin;
    } else {
      rowoff[r] = (static_cast<long long>(blockIdx.z) * p.M + m) * p.N;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * (BN / 8); idx += kT) {  // runs of 8 outputs
    const int r = idx / (BN / 8);
    const int c = 8 * (idx - r * (BN / 8));
    const int n = n0 + c;
    if (m0 + r >= p.M || n >= p.N) continue;
    float4 v0 = *reinterpret_cast<const float4*>(Cs + r * L::kCLd + c);
    float4 v1 = *reinterpret_cast<const float4*>(Cs + r * L::kCLd + c + 4);
    long long off = rowoff[r] + n;
    if (MODE == kFwd) {  // + the float32 bias, then the one rounding
      const int di = n >= 2 * Cout ? 1 : 0;
      const int n2 = n - di * 2 * Cout;  // dj*Cout + co
      const float* b = bias + (n2 >= Cout ? n2 - Cout : n2);
      const float4 b0 = ldg4(b), b1 = ldg4(b + 4);
      v0 = make_float4(v0.x + b0.x, v0.y + b0.y, v0.z + b0.z, v0.w + b0.w);
      v1 = make_float4(v1.x + b1.x, v1.y + b1.y, v1.z + b1.z, v1.w + b1.w);
      off = rowoff[r] + di * row5 + n2;
    }
    store8(out + off, v0, v1);
  }
  if (sums) {  // the row groups' sums of each column, added in order
    __syncthreads();  // the staged tile read
    smem[tid] = bsum;
    __syncthreads();
    if (tid < BN && n0 + tid < p.N) {
      float total = 0.f;
#pragma unroll
      for (int h = 0; h < kT / BN; ++h) total += smem[h * BN + tid];
      col_sums[static_cast<long long>(blockIdx.z) * p.N + n0 + tid] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core tile product (float32 FMA), for the thin stages
// ---------------------------------------------------------------------------

// One BM x BN tile of the product (modes as above) from operands of type T
// (float32 or bfloat16), summed in float32; out is T (forward, dx) or the
// float32 partials (dw). Thread (ty, tx) of TY x TX = 256 owns rows
// ty*TM .. +TM and the TN/4 column quads (g*TX + tx)*4, so a row of the tile
// is written as neighbouring runs of four.
template <typename T, int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads) conv_transpose2x_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
    const float* __restrict__ bias, void* __restrict__ out_v, float* __restrict__ col_sums,
    long long pixels, int W, int Cin, int Cout, long long chunk_len) {
  using Out = std::conditional_t<MODE == kDw, float, T>;
  Out* out = static_cast<Out*>(out_v);
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile does not match the block");
  static_assert(TN % 4 == 0 && BM % 4 == 0 && BN % 4 == 0, "float4 granularity");
  constexpr int TX = BN / TN;
  constexpr int NG = TN / 4;
  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const Product p = product_of<MODE>(pixels, Cin, Cout, chunk_len);
  const long long M = p.M, k_begin = p.k_begin, k_end = p.k_end;
  const int N = p.N;

  float acc[TM][TN];
  float bsum[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) bsum[j] = 0.f;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k0 = k_begin; k0 < k_end; k0 += kBK) {
    // ---- the A slice, As[k][m] ----
    if (MODE == kDw) {  // x(pixel k, ci m): contiguous along m
      for (int idx = tid; idx < kBK * (BM / 4); idx += kThreads) {
        const int k = idx / (BM / 4);
        const int mq = idx % (BM / 4);
        const long long pix = k0 + k;
        const long long m = m0 + mq * 4;
        float4 v = zero4;
        if (pix < k_end && m < M) v = load4(x + pix * Cin + m);
        *reinterpret_cast<float4*>(&As[k][mq * 4]) = v;
      }
    } else {  // x(pixel m, ci k) or dy(pixel m, column k): contiguous along k
      for (int idx = tid; idx < BM * (kBK / 4); idx += kThreads) {
        const int ml = idx / (kBK / 4);
        const int kq = idx % (kBK / 4);
        const long long m = m0 + ml;
        const long long k = k0 + kq * 4;
        float4 v = zero4;
        if (m < M && k < k_end) {
          if (MODE == kFwd) {
            v = load4(x + m * Cin + k);
          } else {
            v = load4(dy + y5_offset(m, static_cast<int>(k), W, Cout));
          }
        }
        As[kq * 4 + 0][ml] = v.x;
        As[kq * 4 + 1][ml] = v.y;
        As[kq * 4 + 2][ml] = v.z;
        As[kq * 4 + 3][ml] = v.w;
      }
    }
    // ---- the B slice, Bs[k][n] ----
    if (MODE == kDx) {  // w(tap, ci n, co) with k = tap*Cout + co: contiguous along k
      for (int idx = tid; idx < BN * (kBK / 4); idx += kThreads) {
        const int nl = idx / (kBK / 4);
        const int kq = idx % (kBK / 4);
        const int n = n0 + nl;
        const int k = static_cast<int>(k0) + kq * 4;
        float4 v = zero4;
        if (n < N && k < k_end) {
          const int tap = k / Cout;
          const int co = k - tap * Cout;
          v = load4(w + (static_cast<long long>(tap) * Cin + n) * Cout + co);
        }
        Bs[kq * 4 + 0][nl] = v.x;
        Bs[kq * 4 + 1][nl] = v.y;
        Bs[kq * 4 + 2][nl] = v.z;
        Bs[kq * 4 + 3][nl] = v.w;
      }
    } else {  // w(tap, ci k, co) or dy(pixel k, column n): contiguous along n
      for (int idx = tid; idx < kBK * (BN / 4); idx += kThreads) {
        const int kl = idx / (BN / 4);
        const int nq = idx % (BN / 4);
        const int n = n0 + nq * 4;
        const long long k = k0 + kl;
        float4 v = zero4;
        if (n < N && k < k_end) {
          if (MODE == kFwd) {
            const int tap = n / Cout;
            const int co = n - tap * Cout;
            v = load4(w + (static_cast<long long>(tap) * Cin + k) * Cout + co);
          } else {
            v = load4(dy + y5_offset(k, n, W, Cout));
          }
        }
        *reinterpret_cast<float4*>(&Bs[kl][nq * 4]) = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[k][(g * TX + tx) * 4]);
        b[g * 4 + 0] = v.x;
        b[g * 4 + 1] = v.y;
        b[g * 4 + 2] = v.z;
        b[g * 4 + 3] = v.w;
      }
      if (MODE == kDw) {
#pragma unroll
        for (int j = 0; j < TN; ++j) bsum[j] += b[j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // ---- the result ----
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    long long row;  // offset of the row's column 0
    if (MODE == kFwd) {
      const long long t = div_w(m, W);
      const int j = static_cast<int>(m - t * W);
      row = (2 * t * W + j) * (2LL * Cout);  // tap row di = 0; di = 1 lies 2*W*Cout further
    } else if (MODE == kDx) {
      row = m * Cin;
    } else {
      row = (static_cast<long long>(blockIdx.z) * M + m) * N;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int n = n0 + (g * TX + tx) * 4;
      if (n >= N) continue;
      float4 v = make_float4(acc[i][g * 4 + 0], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                             acc[i][g * 4 + 3]);
      long long off = row + n;
      if (MODE == kFwd) {
        const int di = n >= 2 * Cout ? 1 : 0;
        const int n2 = n - di * 2 * Cout;       // dj*Cout + co
        const int co = n2 >= Cout ? n2 - Cout : n2;
        const float4 bv = ldg4(bias + co);
        v.x += bv.x;
        v.y += bv.y;
        v.z += bv.z;
        v.w += bv.w;
        off = row + static_cast<long long>(di) * W * (2LL * Cout) + n2;
      }
      store4(out + off, v);
    }
  }
  if (MODE == kDw) {
    if (blockIdx.x == 0 && ty == 0) {  // db: column sums of this chunk's dy tiles
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int n = n0 + (g * TX + tx) * 4;
        if (n >= N) continue;
        *reinterpret_cast<float4*>(col_sums + static_cast<long long>(blockIdx.z) * N + n) =
            make_float4(bsum[g * 4 + 0], bsum[g * 4 + 1], bsum[g * 4 + 2], bsum[g * 4 + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dw and db from the chunks' partials, in a fixed order
// ---------------------------------------------------------------------------

// kDb false: dw(tap, ci, co) = sum over chunks of part(chunk, ci, tap*Cout + co)
// kDb true:  db(co) = sum over chunks and taps of part(chunk, tap*Cout + co)
// A block of 32 x kLanes threads takes 32 runs of four outputs at a time;
// lane c adds chunks c, c + kLanes, ... in order, and lane 0 adds the lanes'
// sums in order. The grid strides, so a few waves of blocks cover any size.
// The float32 sums are stored as OutT: dw rounded once to bfloat16 in the
// bfloat16 instance, db float32 in both.
template <bool kDb, int kLanes, typename OutT>
__global__ void __launch_bounds__(32 * kLanes) conv_transpose2x_reduce_kernel(
    const float* __restrict__ part, OutT* __restrict__ dst, int chunks, int Cin, int Cout) {
  __shared__ float4 lanes[kLanes][32];
  const int N4 = 4 * Cout;
  const long long total = kDb ? Cout : static_cast<long long>(Cin) * N4;
  const long long stride = kDb ? N4 : total;  // between chunks
  const long long runs = total / 4;
  const int e = threadIdx.x & 31;
  const int c = threadIdx.x >> 5;
  for (long long r0 = static_cast<long long>(blockIdx.x) * 32; r0 < runs;
       r0 += static_cast<long long>(gridDim.x) * 32) {
    const long long idx = 4 * (r0 + e);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < total) {
      for (int z = c; z < chunks; z += kLanes) {
        const float* src = part + z * stride + idx;
#pragma unroll
        for (int tap = 0; tap < (kDb ? 4 : 1); ++tap) {
          const float4 v = ldg4(src + tap * Cout);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
      }
    }
    lanes[c][e] = s;
    __syncthreads();
    if (c == 0 && idx < total) {
#pragma unroll
      for (int l = 1; l < kLanes; ++l) {
        const float4 v = lanes[l][e];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      long long off = idx;
      if (!kDb) {
        const int ci = static_cast<int>(idx / N4);
        const int n = static_cast<int>(idx - static_cast<long long>(ci) * N4);
        const int tap = n / Cout;
        off = (static_cast<long long>(tap) * Cin + ci) * Cout + (n - tap * Cout);
      }
      store4(dst + off, s);
    }
    __syncthreads();
  }
}

// 8 chunk lanes, or 32 where there are many chunks (the thin stages' dw)
template <bool kDb, typename OutT>
cudaError_t launch_reduce(const float* part, OutT* dst, int chunks, int Cin, int Cout,
                          cudaStream_t s) {
  const long long runs = (kDb ? Cout : static_cast<long long>(Cin) * 4 * Cout) / 4;
  long long blocks = (runs + 31) / 32;
  if (blocks > 8LL * kSms) blocks = 8LL * kSms;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (chunks >= 64) {
    conv_transpose2x_reduce_kernel<kDb, 32, OutT><<<grid, 32 * 32, 0, s>>>(part, dst, chunks, Cin,
                                                                           Cout);
  } else {
    conv_transpose2x_reduce_kernel<kDb, 8, OutT><<<grid, 32 * 8, 0, s>>>(part, dst, chunks, Cin,
                                                                         Cout);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10b.bf16 in one pass over dy (the thin stages)
// ---------------------------------------------------------------------------
//
// What _bwd_kernel computes (mia_tpu/ops/upsample2x.py): each grid cell
// reads its band of x and of dy once and produces dx, and a float32 dw / db
// partial. Here a persistent grid of blocks, sized from the shape alone
// (one block per 128-pixel stage, at most two an SM: so two launches are
// bit-identical), walks the pixels (b, i, j) in stages of kP, each block
// taking stages blockIdx.x, blockIdx.x + gridDim.x, ...; a stage's x rows
// (kP x Cin) and dy taps (kP x 4*Cout: a pixel's tap rows di = 0 and 1 of
// the (B, H, 2, W, 2*Cout) layout, 2*Cout each) arrive by 16-byte cp.async
// into a ring of kStages stages (about 100 KB an SM in flight), and every
// product runs on bfloat16 mma.sync.m16n8k16 with float32 accumulators:
//
//   dx(pixel, ci)  = sum over 4*Cout of dy(pixel, k) wT(k, ci)   warps by 16 pixels
//   dwT(k, ci)    += sum over the stage's pixels of dy(pixel, k) x(pixel, ci)
//   db(k)         += sum over the stage's pixels of dy(pixel, k)
//
// dx is each pixel's 4*Cout-deep float32 sum (32-deep MMA chains, each from
// zero, added to it in float32: the tensor core truncates into its
// accumulator), rounded once to bfloat16. dwT is held in registers for the
// block's whole walk, each element by one warp (an m16 x n8 fragment of the
// (4*Cout, Cin) product), a 32-pixel chain at a time added into it; db is
// the CUDA cores' float32 sum of the same dy fragments (the warp that holds
// an m16 row block's first fragment). Each block writes one float32 dw / db
// partial; conv_transpose2x_reduce_kernel adds them in block order (dw's,
// rounded once, then db's). Three launches (this kernel, the two reduces)
// where the tile products take four, no atomics. x and dy are read once: the bound is
// their bytes and dx's (prompt-large 4: 151 MB, 45.07 us at 3.35 TB/s).
//
// Staged rows are swizzled by 16-byte chunk (swz below), so that the eight
// rows an ldmatrix reads at one chunk fall in eight distinct 16-byte bank
// groups whatever the row's width (32 bytes at Cin 16 would conflict two
// ways unswizzled, 128 bytes eight ways). Instances by padded channel
// counts: kCin (Cin rounded up to 16: 16, 32, 64) and kN4 (4*Cout rounded up
// to 64: 64, 128); ci past Cin and k past 4*Cout are zero-filled, never
// read, and not written.

constexpr int kOpThreads = 256;                 // 8 warps
constexpr size_t kOpBudget = 112 * 1024;        // shared memory a block: two blocks an SM
constexpr int kOpBlocksPerSm = 2;

template <int kCin, int kN4>
struct OnePass {
  static constexpr int kP = kCin + kN4 > 128 ? 64 : 128;  // pixels a stage
  static constexpr int kXC = kCin / 8;                    // 16-byte chunks of a staged x row
  static constexpr int kYC = kN4 / 8;                     // ... of a staged dy row
  static constexpr int kStageElems = kP * (kCin + kN4);
  static constexpr int kWLd = kN4 + 8;                    // wT rows [ci][k], padded by 16 bytes
  static constexpr size_t kWBytes = sizeof(bf16) * kCin * kWLd;
  static constexpr size_t kStageBytes = sizeof(bf16) * kStageElems;
  static constexpr int kStages = 4 * kStageBytes + kWBytes <= kOpBudget   ? 4
                                 : 3 * kStageBytes + kWBytes <= kOpBudget ? 3
                                                                          : 2;
  static constexpr size_t kBytes = kStages * kStageBytes + kWBytes;
  // dx: warps by (16-pixel row block, n8 group)
  static constexpr int kMRows = kP / 16;           // m16 blocks of a stage
  static constexpr int kDxWarps = 8 / kMRows;      // warps an m16 block
  static constexpr int kNT = kCin / 8;             // n8 tiles of Cin
  static constexpr int kDxNT = kNT / kDxWarps;     // n8 tiles a warp
  // dwT: (kN4 / 16) x (Cin / 8) fragments, kDwPer a warp in one m16 row block
  static constexpr int kMT = kN4 / 16;
  static constexpr int kDwPer = kMT * kNT / 8;
  static constexpr int kDwGroups = kNT / kDwPer;   // warps an m16 row block
  static_assert(kDxWarps * kMRows == 8 && kDxNT * kDxWarps == kNT,
                "dx does not split over 8 warps");
  static_assert(kDwPer >= 1 && kDwGroups * kDwPer == kNT && kMT == 8 / kDwGroups,
                "dwT does not split over 8 warps");
  static_assert(kBytes <= kOpBudget, "a stage ring does not fit");
};

// The 16-byte chunk where chunk c of staged row p lands, in a tile of rows
// of nc chunks: c XOR the row's place among the rows that share a 128-byte
// line group, so that eight rows at one chunk hit eight bank groups.
template <int nc>
__device__ __forceinline__ int swz(int p, int c) {
  constexpr int kLine = nc >= 8 ? 1 : 8 / nc;  // rows a 128-byte line
  constexpr int kMask = nc >= 8 ? 7 : nc - 1;
  return c ^ ((p / kLine) & kMask);
}

// Four 8 x 8 bf16 matrices from shared memory as stored: lane t gives the
// address of row t % 8 of matrix t / 8; register i holds, in lane (g, tq),
// elements (g, 2 tq) and (g, 2 tq + 1) of matrix i, the A fragment of a
// row-major [m][k] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// x (pixels, Cin), w (2, 2, Cin, Cout), dy (B, 2H, 2W, Cout) viewed (B, H,
// 2, W, 2*Cout) -> dx (pixels, Cin) when not null; part (gridDim.x, Cin,
// 4*Cout) and sums (gridDim.x, 4*Cout), this block's float32 dw / db
// partials, when part is not null.
template <int kCin, int kN4>
__global__ void __launch_bounds__(kOpThreads, kOpBlocksPerSm) conv_transpose2x_bwd_onepass_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, float* __restrict__ part, float* __restrict__ sums, long long pixels,
    int W, int Cin, int Cout) {
  using L = OnePass<kCin, kN4>;
  constexpr int kP = L::kP;
  extern __shared__ float4 op_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(op_smem4);  // [stage]: x rows [kP][kCin], dy rows [kP][kN4]
  bf16* Wt = ring + L::kStages * L::kStageElems;   // [ci][kWLd]: wT(k, ci) at Wt[ci * kWLd + k]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int N4 = 4 * Cout;
  const int row2 = 2 * Cout;  // elements of one tap row of a pixel
  const bool want_dx = dx != nullptr;
  const bool want_dw = part != nullptr;
  const long long nst = (pixels + kP - 1) / kP;
  const long long mine = (nst - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's stages

  // wT, zero past Cin and past 4*Cout (plain 16-byte loads, once a block)
  for (int i = tid; i < kCin * L::kYC; i += kOpThreads) {
    const int ci = i / L::kYC;
    const int k = 8 * (i - ci * L::kYC);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ci < Cin && k < N4) {
      const int tap = k / Cout;
      v = __ldg(reinterpret_cast<const uint4*>(w + (static_cast<long long>(tap) * Cin + ci) * Cout +
                                               (k - tap * Cout)));
    }
    *reinterpret_cast<uint4*>(Wt + ci * L::kWLd + k) = v;
  }

  auto load = [&](int slot, long long st) {
    bf16* Xs = ring + slot * L::kStageElems;
    bf16* Ys = Xs + kP * kCin;
    const long long p0 = st * kP;
    if (want_dw) {
      for (int i = tid; i < kP * L::kXC; i += kOpThreads) {
        const int p = i / L::kXC;
        const int c = i - p * L::kXC;
        const long long gp = p0 + p;
        const bool ok = gp < pixels && 8 * c < Cin;
        cp_async16_bytes(Xs + p * kCin + 8 * swz<L::kXC>(p, c), ok ? x + gp * Cin + 8 * c : x, ok);
      }
    }
    for (int i = tid; i < kP * L::kYC; i += kOpThreads) {
      const int p = i / L::kYC;
      const int c = i - p * L::kYC;
      const long long gp = p0 + p;
      const int k = 8 * c;
      const bool ok = gp < pixels && k < N4;
      const bf16* src = dy;
      if (ok) {
        const long long t = div_w(gp, W);
        const int di = k >= row2 ? 1 : 0;
        src = dy + ((2 * t + di) * W + (gp - t * W)) * row2 + (k - di * row2);
      }
      cp_async16_bytes(Ys + p * kN4 + 8 * swz<L::kYC>(p, c), src, ok);
    }
  };

  // dx: the warp's 16 pixels (row block warp % kMRows) by its n8 tiles
  const int dx_m0 = 16 * (warp % L::kMRows);
  const int dx_n0 = (warp / L::kMRows) * L::kDxNT;
  // dwT: the warp's m16 row block and n8 tiles; the first group's warp also sums db
  const int dw_mi = warp / L::kDwGroups;
  const int dw_n0 = (warp % L::kDwGroups) * L::kDwPer;
  const bool db_warp = warp % L::kDwGroups == 0;
  float dwa[L::kDwPer][4];
#pragma unroll
  for (int j = 0; j < L::kDwPer; ++j) dwa[j][0] = dwa[j][1] = dwa[j][2] = dwa[j][3] = 0.f;
  float dbs0 = 0.f, dbs1 = 0.f;  // db of rows 16 dw_mi + g and + 8, this thread's pixels

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < mine) load(s, blockIdx.x + static_cast<long long>(s) * gridDim.x);
    cp_async_commit();
  }
  for (long long it = 0; it < mine; ++it) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // stage `it` landed for every thread (and wT, the first time); it - 1 is free
    const long long next = it + L::kStages - 1;
    if (next < mine) load(static_cast<int>(next % L::kStages), blockIdx.x + next * gridDim.x);
    cp_async_commit();
    const bf16* Xs = ring + static_cast<int>(it % L::kStages) * L::kStageElems;
    const bf16* Ys = Xs + kP * kCin;
    const long long p0 = (blockIdx.x + it * gridDim.x) * kP;

    if (want_dx) {
      float acc[L::kDxNT][4];
#pragma unroll
      for (int j = 0; j < L::kDxNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kN4 / 32; ++kc) {  // 32-deep chains, each from zero
        float pt[L::kDxNT][4];
#pragma unroll
        for (int j = 0; j < L::kDxNT; ++j) pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = 2 * kc + h;
          const int p = dx_m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
          uint32_t a[4];
          ldmatrix_x4(a, Ys + p * kN4 + 8 * swz<L::kYC>(p, 2 * kk + (lane >> 4)));
#pragma unroll
          for (int j = 0; j < L::kDxNT; ++j) {
            const bf16* b = Wt + (8 * (dx_n0 + j) + g) * L::kWLd + 16 * kk + 2 * tq;
            mma_bf16(pt[j], a, ld_bf16x2(b), ld_bf16x2(b + 8));
          }
        }
#pragma unroll
        for (int j = 0; j < L::kDxNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += pt[j][e];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long gp = p0 + dx_m0 + g + 8 * half;
        if (gp >= pixels) continue;
#pragma unroll
        for (int j = 0; j < L::kDxNT; ++j) {
          const int col = 8 * (dx_n0 + j) + 2 * tq;
          if (col < Cin)
            *reinterpret_cast<uint32_t*>(dx + gp * Cin + col) =
                pack_bf16x2(acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    }

    if (want_dw) {
#pragma unroll
      for (int pc = 0; pc < kP / 32; ++pc) {  // 32-pixel chains, each from zero
        uint32_t a[2][4];  // dyT(k, pixel) fragments of the chain's two k16 steps
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 32 * pc + 16 * h + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4_trans(a[h], Ys + p * kN4 + 8 * swz<L::kYC>(p, 2 * dw_mi + ((lane >> 3) & 1)));
        }
        if (db_warp) {  // rows g (registers 0, 2) and g + 8 (1, 3): pixels 2 tq, 2 tq + 1, + 8, + 9
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dbs0 += ((bf16_lo(a[h][0]) + bf16_hi(a[h][0])) + bf16_lo(a[h][2])) + bf16_hi(a[h][2]);
            dbs1 += ((bf16_lo(a[h][1]) + bf16_hi(a[h][1])) + bf16_lo(a[h][3])) + bf16_hi(a[h][3]);
          }
        }
        // the warp's n8 tiles by pairs (one tile: the pair that holds it)
#pragma unroll
        for (int q = 0; q < (L::kDwPer + 1) / 2; ++q) {
          const int jp = L::kDwPer == 1 ? dw_n0 >> 1 : dw_n0 / 2 + q;
          // x(pixel, ci) as B fragments: [h][tile 2 jp: 0, 1; tile 2 jp + 1: 2, 3]
          uint32_t b[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 32 * pc + 16 * h + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(b[h], Xs + p * kCin + 8 * swz<L::kXC>(p, 2 * jp + (lane >> 4)));
          }
          if constexpr (L::kDwPer == 1) {
            // the pair's half that holds the tile, by a select of values: an
            // index into b that is not known at compile time puts b in local
            // memory (prompt-large 4 measured 123.84 us so, 70.75 us without)
            const bool odd = dw_n0 & 1;
            float pt[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(pt, a[0], odd ? b[0][2] : b[0][0], odd ? b[0][3] : b[0][1]);
            mma_bf16(pt, a[1], odd ? b[1][2] : b[1][0], odd ? b[1][3] : b[1][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) dwa[0][e] += pt[e];
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float pt[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(pt, a[0], b[0][2 * u], b[0][2 * u + 1]);
              mma_bf16(pt, a[1], b[1][2 * u], b[1][2 * u + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) dwa[2 * q + u][e] += pt[e];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!want_dw) return;
  // this block's partials: dwT(k, ci) at part[(block, ci, k)], db(k) at sums[(block, k)]
  float* my_part = part + static_cast<long long>(blockIdx.x) * Cin * N4;
#pragma unroll
  for (int j = 0; j < L::kDwPer; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * dw_mi + g + (e >= 2 ? 8 : 0);
      const int ci = 8 * (dw_n0 + j) + 2 * tq + (e & 1);
      if (k < N4 && ci < Cin) my_part[static_cast<long long>(ci) * N4 + k] = dwa[j][e];
    }
  }
  // db: the four threads of a row group hold its 16 pixels of each k16 step
  dbs0 += __shfl_xor_sync(0xffffffffu, dbs0, 1);
  dbs1 += __shfl_xor_sync(0xffffffffu, dbs1, 1);
  dbs0 += __shfl_xor_sync(0xffffffffu, dbs0, 2);
  dbs1 += __shfl_xor_sync(0xffffffffu, dbs1, 2);
  if (db_warp && tq == 0) {
    float* my_sums = sums + static_cast<long long>(blockIdx.x) * N4;
    const int k = 16 * dw_mi + g;
    if (k < N4) my_sums[k] = dbs0;
    if (k + 8 < N4) my_sums[k + 8] = dbs1;
  }
}

// ---------------------------------------------------------------------------
// Routes, tiles, chunks and launches
// ---------------------------------------------------------------------------

// The route of a product whose operands are `elem` bytes an element (4
// float32, 2 bfloat16): the tensor cores where its time on the CUDA cores
// (2*M*N*K at 67 TFLOP/s of float32 FMA) would exceed its operands and result
// crossing device memory once at 3.35 TB/s, i.e. at 20 flops a byte or more;
// the CUDA cores where bytes set it either way.
bool route_tc(int mode, long long pixels, int Cin, int Cout, int elem) {
  long long M, N, K;
  product_dims(mode, pixels, Cin, Cout, &M, &N, &K);
  const double flops = 2.0 * M * N * K;
  const double bytes = static_cast<double>(elem) * (static_cast<double>(M) * K +
                                                    static_cast<double>(K) * N +
                                                    static_cast<double>(M) * N);
  return flops >= 20.0 * bytes;
}

// The one pass's instances: Cin <= 64, Cout <= 32 (its dwT fragments stay in
// registers over the walk).
bool onepass_fits(int Cin, int Cout) { return Cin <= 64 && Cout <= 32; }

// K10b.bf16's third route: the one pass wherever an instance fits. It
// started as the stages where route_tc sends both backward products to the
// CUDA cores (prompt-large 4); timed on the card against the tile products
// it was ahead wherever it fits, the tensor-core tiles included
// (prompt-large 2 and 3, UNet 4, SAM 2, the ragged 5 x 12: PERF.md §6),
// so the rule is the instances'. Elsewhere (Cin > 64 or Cout > 32: UNet 1-3,
// SAM 1, prompt-large 1) the tile product of each.
bool route_onepass(long long pixels, int Cin, int Cout) {
  return pixels > 0 && onepass_fits(Cin, Cout);
}

// A tensor-core tile: rows x cols of the result, by warps of 64 x 32. At
// about 215 registers a thread an SM holds 8 such warps whatever the tile;
// blocks of 4 warps, two an SM, were faster on every UNet stage than one
// block of 8, whose barriers stall all 8 (PERF.md §6). The bfloat16 instance
// takes the same tiles.
struct TcTile {
  int rows, cols;
  int blocks_per_sm() const { return 8 * 64 * 32 / (rows * cols); }
};

template <int MODE>
TcTile tc_tile(long long pixels, int Cin, int Cout) {
  long long M, N, K;
  product_dims(MODE, pixels, Cin, Cout, &M, &N, &K);
  if (MODE == kDw && M <= 64) return {64, 128};
  return {128, 64};
}

// dw's tile for the SIMT route: Cin rows (16 .. 512) by 4*Cout columns (64 .. 1024)
void dw_tile(int Cin, int Cout, int* bm, int* bn) {
  const int N4 = 4 * Cout;
  *bm = Cin >= 128 ? 128 : Cin >= 64 ? 64 : Cin >= 32 ? 32 : 16;
  *bn = (*bm == 64) ? 64 : (N4 >= 128 ? 128 : 64);
}

// Pixel chunks of dw. Tensor cores: about one wave of blocks on the card
// (tiles x chunks <= SMs x blocks an SM), each chunk a multiple of the stage
// depth and at least four stages. SIMT: four waves, each chunk a multiple of
// the slice depth and at least 64 pixels.
void dw_chunks(long long pixels, int Cin, int Cout, int elem, long long* chunk_len, int* chunks) {
  long long tiles, want, least, depth;
  if (route_tc(kDw, pixels, Cin, Cout, elem)) {
    const TcTile t = tc_tile<kDw>(pixels, Cin, Cout);
    tiles = static_cast<long long>((Cin + t.rows - 1) / t.rows) * ((4 * Cout + t.cols - 1) / t.cols);
    want = kSms * t.blocks_per_sm() / tiles;
    least = 4 * kTcBK;
    depth = kTcBK;
  } else {
    int bm, bn;
    dw_tile(Cin, Cout, &bm, &bn);
    tiles = static_cast<long long>((Cin + bm - 1) / bm) * ((4 * Cout + bn - 1) / bn);
    want = 4 * kSms / tiles;
    least = 64;
    depth = kBK;
  }
  if (want < 1) want = 1;
  const long long most = pixels / least > 1 ? pixels / least : 1;
  if (want > most) want = most;
  long long len = (pixels + want - 1) / want;
  len = (len + depth - 1) / depth * depth;
  *chunk_len = len;
  *chunks = static_cast<int>((pixels + len - 1) / len);
  if (*chunks < 1) *chunks = 1;
}

// Operands of one product; x, w, dy and out are of the instance's type
// (out: float32 partials for dw)
struct LaunchArgs {
  const void *x, *w, *dy;
  const float* bias;
  void* out;
  float* col_sums;
  long long pixels;
  int W, Cin, Cout;
  long long chunk_len;
  int chunks;
  cudaStream_t s;
};

template <typename T, int MODE, int BM, int BN, int WM, int WN>
cudaError_t launch_tc(const LaunchArgs& a) {
  long long M, N, K;
  product_dims(MODE, a.pixels, a.Cin, a.Cout, &M, &N, &K);
  const long long mt = (M + BM - 1) / BM;
  const long long nt = (N + BN - 1) / BN;
  if (mt > 0x7fffffffLL || nt > 65535 || a.chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt),
                  static_cast<unsigned>(a.chunks));
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* dy = static_cast<const T*>(a.dy);
  if constexpr (std::is_same_v<T, float>) {
    auto kernel = conv_transpose2x_tc_kernel<MODE, BM, BN, WM, WN>;
    constexpr size_t smem = TcLayout<MODE, BM, BN>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, WM * WN * 32, smem, a.s>>>(x, w, dy, a.bias, static_cast<float*>(a.out),
                                              a.col_sums, a.pixels, a.W, a.Cin, a.Cout,
                                              a.chunk_len);
  } else {
    auto kernel = conv_transpose2x_bf16_tc_kernel<MODE, BM, BN, WM, WN>;
    constexpr size_t smem = Bf16Layout<MODE, BM, BN>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, WM * WN * 32, smem, a.s>>>(x, w, dy, a.bias, a.out, a.col_sums, a.pixels,
                                              a.W, a.Cin, a.Cout, a.chunk_len);
  }
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_tc_tiles(const LaunchArgs& a) {
  const TcTile t = tc_tile<MODE>(a.pixels, a.Cin, a.Cout);
  if (t.rows == 64) return launch_tc<T, MODE, 64, 128, 1, 4>(a);
  return launch_tc<T, MODE, 128, 64, 2, 2>(a);
}

template <typename T, int MODE, int BM, int BN, int TM, int TN>
cudaError_t launch_gemm(const LaunchArgs& a) {
  long long M, N, K;
  product_dims(MODE, a.pixels, a.Cin, a.Cout, &M, &N, &K);
  const long long mt = (M + BM - 1) / BM;
  const long long nt = (N + BN - 1) / BN;
  if (mt > 0x7fffffffLL || nt > 65535 || a.chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt),
                  static_cast<unsigned>(a.chunks));
  conv_transpose2x_gemm_kernel<T, MODE, BM, BN, TM, TN><<<grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<const T*>(a.dy),
      a.bias, a.out, a.col_sums, a.pixels, a.W, a.Cin, a.Cout, a.chunk_len);
  return cudaGetLastError();
}

// forward and dx on the SIMT route: many pixels down, N columns across; the
// tile is as wide as N allows
template <typename T, int MODE>
cudaError_t launch_by_width(const LaunchArgs& a) {
  const int N = MODE == kFwd ? 4 * a.Cout : a.Cin;
  if (N >= 128) return launch_gemm<T, MODE, 128, 128, 8, 8>(a);
  if (N >= 64) return launch_gemm<T, MODE, 128, 64, 8, 4>(a);
  if (N >= 32) return launch_gemm<T, MODE, 128, 32, 4, 4>(a);
  return launch_gemm<T, MODE, 256, 16, 4, 4>(a);
}

// dw on the SIMT route: the tile of dw_tile()
template <typename T>
cudaError_t launch_dw_gemm(const LaunchArgs& a) {
  int bm, bn;
  dw_tile(a.Cin, a.Cout, &bm, &bn);
  if (bm == 128 && bn == 128) return launch_gemm<T, kDw, 128, 128, 8, 8>(a);
  if (bm == 128) return launch_gemm<T, kDw, 128, 64, 8, 4>(a);
  if (bm == 64) return launch_gemm<T, kDw, 64, 64, 4, 4>(a);
  if (bm == 32 && bn == 128) return launch_gemm<T, kDw, 32, 128, 4, 4>(a);
  if (bm == 32) return launch_gemm<T, kDw, 32, 64, 2, 4>(a);
  if (bn == 128) return launch_gemm<T, kDw, 16, 128, 2, 4>(a);
  return launch_gemm<T, kDw, 16, 64, 1, 4>(a);
}

template <typename T, int MODE>
cudaError_t launch_product(const LaunchArgs& a) {
  if (route_tc(MODE, a.pixels, a.Cin, a.Cout, sizeof(T))) return launch_tc_tiles<T, MODE>(a);
  if constexpr (MODE == kDw) {
    return launch_dw_gemm<T>(a);
  } else {
    return launch_by_width<T, MODE>(a);
  }
}

// Channel counts multiples of 16 bytes of T: 4 float32, 8 bfloat16
template <typename T>
bool sizes_ok(int batch, int H, int W, int Cin, int Cout) {
  constexpr int kMultiple = 16 / static_cast<int>(sizeof(T));
  return batch >= 0 && H >= 0 && W >= 0 && Cin > 0 && Cout > 0 && Cin % kMultiple == 0 &&
         Cout % kMultiple == 0;
}

template <typename T>
int forward(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W,
            int Cin, int Cout, void* stream) {
  if (!sizes_ok<T>(batch, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * H * W;
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  const LaunchArgs a{x, w, nullptr, static_cast<const float*>(bias), out, nullptr, pixels, W,
                     Cin, Cout, 0, 1, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_product<T, kFwd>(a));
}

// The one pass's operands; with launch false onepass() gives the block count
// alone, which is the partials' chunk count.
struct OnePassArgs {
  const bf16 *x, *w, *dy;
  bf16* dx;
  float *part, *sums;
  long long pixels;
  int W, Cin, Cout;
  cudaStream_t s;
};

template <int kCin, int kN4>
cudaError_t onepass_instance(const OnePassArgs& a, bool launch, int* blocks) {
  using L = OnePass<kCin, kN4>;
  const long long stages = (a.pixels + L::kP - 1) / L::kP;
  const long long most = static_cast<long long>(kSms) * kOpBlocksPerSm;
  *blocks = static_cast<int>(stages < most ? stages : most);
  if (!launch) return cudaSuccess;
  auto kernel = conv_transpose2x_bwd_onepass_kernel<kCin, kN4>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  kernel<<<*blocks, kOpThreads, L::kBytes, a.s>>>(a.x, a.w, a.dy, a.dx, a.part, a.sums, a.pixels,
                                                  a.W, a.Cin, a.Cout);
  return cudaGetLastError();
}

// kCin: Cin rounded up to 16, 32 or 64; kN4: 4*Cout rounded up to 64 or 128
cudaError_t onepass(const OnePassArgs& a, bool launch, int* blocks) {
  if (!onepass_fits(a.Cin, a.Cout) || a.pixels <= 0) return cudaErrorInvalidValue;
  const bool wide = 4 * a.Cout > 64;
  if (a.Cin <= 16) return wide ? onepass_instance<16, 128>(a, launch, blocks)
                               : onepass_instance<16, 64>(a, launch, blocks);
  if (a.Cin <= 32) return wide ? onepass_instance<32, 128>(a, launch, blocks)
                               : onepass_instance<32, 64>(a, launch, blocks);
  return wide ? onepass_instance<64, 128>(a, launch, blocks)
              : onepass_instance<64, 64>(a, launch, blocks);
}

template <typename T>
int route(int batch, int H, int W, int Cin, int Cout, int product) {
  if (!sizes_ok<T>(batch, H, W, Cin, Cout) || product < kFwd || product > kDw) return -1;
  const long long pixels = static_cast<long long>(batch) * H * W;
  if (std::is_same_v<T, bf16> && product != kFwd && route_onepass(pixels, Cin, Cout)) return 2;
  return route_tc(product, pixels, Cin, Cout, sizeof(T)) ? 1 : 0;
}

template <typename T>
long long bwd_chunks(int batch, int H, int W, int Cin, int Cout) {
  if (!sizes_ok<T>(batch, H, W, Cin, Cout)) return 0;
  const long long pixels = static_cast<long long>(batch) * H * W;
  if (pixels == 0) return 1;
  if constexpr (std::is_same_v<T, bf16>) {
    if (route_onepass(pixels, Cin, Cout)) {
      const OnePassArgs o{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, pixels, W, Cin,
                          Cout, nullptr};
      int blocks = 0;
      return onepass(o, false, &blocks) == cudaSuccess ? blocks : 0;
    }
  }
  long long len;
  int chunks;
  dw_chunks(pixels, Cin, Cout, sizeof(T), &len, &chunks);
  return chunks;
}

template <typename T>
int backward(const void* x, const void* w, const void* dy, void* dx, void* dw, void* db,
             void* part, void* col_sums, int batch, int H, int W, int Cin, int Cout,
             void* stream) {
  if (!sizes_ok<T>(batch, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, bf16>) {
    if (route_onepass(pixels, Cin, Cout)) {
      if (dx == nullptr && dw == nullptr) return static_cast<int>(cudaSuccess);
      const OnePassArgs o{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                          static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
                          dw == nullptr ? nullptr : static_cast<float*>(part),
                          static_cast<float*>(col_sums), pixels, W, Cin, Cout, s};
      int blocks = 0;
      cudaError_t err = onepass(o, true, &blocks);
      if (err != cudaSuccess || dw == nullptr) return static_cast<int>(err);
      err = launch_reduce<false>(o.part, static_cast<bf16*>(dw), blocks, Cin, Cout, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(
          launch_reduce<true>(o.sums, static_cast<float*>(db), blocks, Cin, Cout, s));
    }
  }
  LaunchArgs a{x, w, dy, nullptr, dx, nullptr, pixels, W, Cin, Cout, 0, 1, s};
  if (dx != nullptr && pixels > 0) {
    const cudaError_t err = launch_product<T, kDx>(a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dw == nullptr) return static_cast<int>(cudaSuccess);
  a.out = part;
  a.col_sums = static_cast<float*>(col_sums);
  a.chunk_len = kTcBK;  // no pixels: one empty chunk, dw and db zero
  if (pixels > 0) dw_chunks(pixels, Cin, Cout, sizeof(T), &a.chunk_len, &a.chunks);
  cudaError_t err = launch_product<T, kDw>(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_reduce<false>(static_cast<const float*>(part), static_cast<T*>(dw), a.chunks, Cin,
                             Cout, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce<true>(static_cast<const float*>(col_sums),
                                              static_cast<float*>(db), a.chunks, Cin, Cout, s));
}

}  // namespace

// x (batch, H, W, Cin), w (2, 2, Cin, Cout), bias (Cout,) -> out (batch, 2H, 2W, Cout),
// all contiguous float32; Cin and Cout multiples of 4. out may not alias an input.
extern "C" int mia_conv_transpose2x_f32(const void* x, const void* w, const void* bias, void* out,
                                        int batch, int H, int W, int Cin, int Cout, void* stream) {
  return forward<float>(x, w, bias, out, batch, H, W, Cin, Cout, stream);
}

// The same with x, w and out bfloat16 and bias float32; Cin and Cout multiples of 8.
extern "C" int mia_conv_transpose2x_bf16(const void* x, const void* w, const void* bias,
                                         void* out, int batch, int H, int W, int Cin, int Cout,
                                         void* stream) {
  return forward<bf16>(x, w, bias, out, batch, H, W, Cin, Cout, stream);
}

// The route each product of a stage takes: 1 the tensor cores, 0 the CUDA
// cores, 2 (bfloat16 dx and dw) the one pass; product 0 the forward, 1 dx,
// 2 dw (and db). -1 for sizes the instance does not take.
extern "C" int mia_conv_transpose2x_route_f32(int batch, int H, int W, int Cin, int Cout,
                                              int product) {
  return route<float>(batch, H, W, Cin, Cout, product);
}

extern "C" int mia_conv_transpose2x_route_bf16(int batch, int H, int W, int Cin, int Cout,
                                               int product) {
  return route<bf16>(batch, H, W, Cin, Cout, product);
}

// Number of pixel chunks the backward splits dw into: the caller allocates
// part (chunks * Cin * 4*Cout floats) and col_sums (chunks * 4*Cout floats).
extern "C" long long mia_conv_transpose2x_bwd_chunks_f32(int batch, int H, int W, int Cin,
                                                         int Cout) {
  return bwd_chunks<float>(batch, H, W, Cin, Cout);
}

extern "C" long long mia_conv_transpose2x_bwd_chunks_bf16(int batch, int H, int W, int Cin,
                                                          int Cout) {
  return bwd_chunks<bf16>(batch, H, W, Cin, Cout);
}

// Backward: x (batch, H, W, Cin), w (2, 2, Cin, Cout), dy (batch, 2H, 2W, Cout) ->
// dx (batch, H, W, Cin) when not null; dw (2, 2, Cin, Cout) and db (Cout,) when dw
// is not null, with part and col_sums (float32) as scratch. No output may alias an input.
extern "C" int mia_conv_transpose2x_bwd_f32(const void* x, const void* w, const void* dy, void* dx,
                                            void* dw, void* db, void* part, void* col_sums,
                                            int batch, int H, int W, int Cin, int Cout,
                                            void* stream) {
  return backward<float>(x, w, dy, dx, dw, db, part, col_sums, batch, H, W, Cin, Cout, stream);
}

// The same with x, w, dy, dx and dw bfloat16 (dw rounded once from its float32
// sums) and db float32; Cin and Cout multiples of 8.
extern "C" int mia_conv_transpose2x_bwd_bf16(const void* x, const void* w, const void* dy,
                                             void* dx, void* dw, void* db, void* part,
                                             void* col_sums, int batch, int H, int W, int Cin,
                                             int Cout, void* stream) {
  return backward<bf16>(x, w, dy, dx, dw, db, part, col_sums, batch, H, W, Cin, Cout, stream);
}

