// The bfloat16 attention forwards on Hopper's warpgroup products at head
// dim 64: K3, K6 (rel terms, kh + kw <= 64), K2 (the rel terms computed here
// from the two gathered tables), K7 (a float32 dense bias) and K8 (windows
// carved from the unpartitioned token grid by the slot map), redesigned
// from the bfloat16 mma.sync instance of attention_fwd_tc.cuh. The C entries
// of attention_fwd_wgmma.cu build the tensor maps and launch these kernels;
// attention_rel.cu's bfloat16 forward entries (K2, K3, K6) and
// attention_routes.cu's (K7, K8) call them for the calls their rules take.
//
// Replaces the TPU forward kernels of mia_tpu/ops/attention.py
//   K3  fused_attention_rel_packed     (_attn_rel_packed_kernel), global blocks, packed qkv
//   K6  fused_attention_rel            (_attn_rel_kernel), the head-major route
//   K2  fused_attention_rel_packed_ik  (_attn_rel_packed_ik_kernel), windows, packed qkv
//   K7  fused_attention                (_attn_kernel), head-major, dense float32 bias
//   K8  fused_attention_rel_win        (_attn_rel_win_kernel), windows of the token grid
// on bfloat16 operands. Head dim 80 (ViT-H), key grids with kh + kw > 64 (a
// 64 x 64 global grid at 1024 pixels), K2 windows past 200 tokens or whose
// tables do not fit the staging below, and K7 with n % 4 != 0 stay on the
// mma.sync instance attention_fwd_bf16_kernel<D, kBias, 64>, whose two
// walks round P where these kernels do.
//
// What they compute, with the Pallas kernels' roundings:
//   K3, K6, K2: q * scale rounded to bfloat16 with the scale rounded first;
//     S = q_aug . k_aug^T, one float32 product with the rel terms folded in
//     as the Pallas kernels fold them ([q * scale | rel_h | rel_w | 0]
//     against [k | E_h | E_w | 0], kAug = 96 or 128 columns,
//     wgmma_bf16.cuh). K2's rel terms are the Pallas kernel's candidate
//     product: rel_h[r, j] = q_r . rh[y_r kh + j], rel_w[r, j] = q_r .
//     rw[x_r kw + j] from the UNSCALED q (y_r, x_r = divmod(r, kw)), a
//     float32 sum of the exact products rounded once to bfloat16, formed
//     here before q is scaled (rel_terms_sw128; the sum in kernel R's order,
//     so the terms equal kernel R's bit for bit);
//   K8: K3's fold over a window's ws x ws slots (kAug 96): a slot with a
//     token takes that token's q, k, v and rel rows; a pad slot (past the
//     grid's edge) is a real key whose k and v are bias_kv's rows, with zero
//     rel rows and q (it is no query); the one-hot columns go by slot
//     position, pad slots included;
//   K7: S = (q . k^T) * scale + bias in float32, _attn_kernel's order: the
//     scale multiplies the float32 product (q is not scaled in bfloat16),
//     the float32 bias is added to it; -inf keys are guarded as in the
//     mma.sync instance (a row whose maximum is still -inf takes 0 as its
//     reference point);
// then the softmax's maximum m and sum l in float32; p = exp(S - m) / l,
// the normalised probabilities, rounded to bfloat16 where the Pallas kernels
// round (p / denom).astype(v.dtype); O = P . V a float32 sum rounded once to
// bfloat16; lse = m + log l (not K7; K8 writes out and lse by token, and
// nothing for a pad query slot).
//
// One block a 64-query tile of one (image, head): one warpgroup (128
// threads), two blocks an SM. Tiles are in the 128-byte swizzle (below),
// each copy one TMA box. q_aug is staged in shared memory once: q by TMA,
// the rel rows and the zero columns by the threads, the scale applied in
// place (K7: q alone, 64 columns, as it landed).
//
// Two walks (attention_fwd_wgmma_kernel: K3, K6, and K2 and K7 past 200
// keys). Keys stream 128 a step (S is one m64n128 product a k16 step): k
// (and v) by TMA through two stages on mbarriers, the next step's copy in
// flight while one is computed; the step's one-hot block (128 keys x the rel
// columns) written by the threads, one key a thread, during the step before
// (K7: the step's float32 bias tile by cp.async into one buffer, the next
// step's copy issued once every thread has added this one):
//   pass 1 (the statistics): k alone (no V is loaded); S as SS wgmma
//     m64n128k16, depth kAug; the rows' maximum and sum online in float32,
//     a 64-key tile at a time (each thread's share of a row's sum, added
//     over the row's four threads at the end of the walk);
//   pass 2: k and V; S again; p = exp(S - m) / l (div_rn: one reciprocal a
//     row) packed from the accumulator into the register A operand of RS
//     wgmma m64n64k16 against V, V read MN-major through the descriptor's
//     transpose bit (no transposed copy); each 64-key tile's P . V starts
//     from zero and is added to O in float32, tile by tile (the tensor
//     cores' sums are not rounded to nearest), with no rescale (m and l are
//     final).
// One walk (attention_fwd_wgmma_window_kernel<kBias>, a trace names K2 <0>,
// K7 <2>, K8 <3>: windows of up to 200 keys, 196 in every SAM encoder): the
// window's k (200 rows) and v (208) land by TMA once (K8: one 4D box each
// over the token grid, the window's slots in slot order in 128-byte rows,
// zeros past the grid's edge, then the threads write bias_kv's rows over
// the pad slots' zeros and zero v's rows past n; q is gathered by the slot
// map, 16-byte cp.async, since a 64-slot tile spans up to six grid rows;
// tiles past the window's last query slot exit), and S is one m64n200k16
// product a k16 step, 100 float32 values a thread: the rows' exact maximum,
// then e = exp(S - m) in place and l its sum, then p = bf16(e / l), and P .
// V in the same 64-key tiles added to O in float32 (keys 196 .. 207 at p =
// 0). The S product, its copy of k and K7's bias are read once where two
// walks read them twice, and each pair takes one exponential where two walks
// take two. So both walk the CPU models' tile order
// (tests/test_torch_bf16_fwd_fold.py, tests/test_torch_bf16_fwd_fold_k2k7.py,
// tests/test_torch_bf16_fwd_fold_k8.py). Each product group is waited for
// before its results are read. Keys past n score -inf; rows past n (the
// next image's tokens, or zeros past the tensor) are computed and not
// written. No atomics: two launches are bit-identical. The exponentials are
// expf, as the plain versions' softmax on the card: __expf's error (its
// argument's rounding times log2 e) moves p by up to ~1e-6 of itself,
// enough to round a large p the other way and move an output by several
// ulps.
//
// Why these choices (measured on the card, PERF.md): the backward's layout
// (wgmma_bf16.cuh: no swizzle, 8-column boxes, a copy request each 16
// bytes) left the copies the bottleneck; deeper rings (3, 4 stages) bought
// nothing at one block an SM and cost blocks at B=8; 128 keys a step halve
// the steps' fixed costs (barriers, waits, copies). A lone block still runs
// S, the exponentials and P . V one after another, and two warpgroups an SM
// hide part of it. K2's terms: the tile's table rows (at most 280, 40 KB)
// are staged in shared memory where the one-hot block goes next, rw's
// transposed so that the rows a warp reads at once fall in distinct banks;
// read straight from L1 a warp would touch up to 14 lines an access. The
// one walk's shared memory (K2 110, K7 113, K8 94 KB) still fits two
// blocks an SM. K8's blocks of a grid of whole windows go first (blockIdx.z
// = window * batch + image): a 32 x 32 grid's edge windows hold 3 or 1 of a
// window's 4 query tiles, and its last window row fills the tail wave.
//
// Against what held the mma.sync instance (ROADMAP, PERF.md): one wave of
// 4-warp blocks each walking its key tiles with m16n8k16 chains, and the
// factored rel bias added per score on the CUDA cores (about a third of
// its time), K2's terms from kernel R in a launch and a scratch of their
// own, K7's bias tile read in both walks.
//
// Work: the statistics pass and the fold make 640 flops (S twice at depth
// 128, P.V once) and 2 exponentials a (query, key) pair; K2's one walk at
// depth 96 (and K8's) makes 320 and 1, K7's 256 and 1 (S at depth 64), over
// 64-row tiles, 200 keys in S and 208 in P.V; the function's own work is 4 D
// = 256 flops a pair. Bound (chip_smoke.py computes it): the function's 4 D
// flops a pair at 989 TFLOP/s dense bfloat16, or the bytes (qkv, the rel
// terms or tables or K7's float32 bias, K8's bias_kv, out once) at 3.35
// TB/s, whichever is larger.

#pragma once

#include "attention_fwd_tc.cuh"
#include "wgmma_bf16.cuh"

namespace {

// Tiles here use the 128-byte swizzle, as TMA's CU_TENSOR_MAP_SWIZZLE_128B
// writes them: a tile of 64 bfloat16 columns (a "block", 64 or 128 rows)
// holds row r at r * 128 bytes with its 16-byte chunk c at chunk c ^ (r %
// 8). q_aug is two 64-row blocks, columns 0-63 (q, one 64 x 64 TMA box) and
// 64-127 (the rel rows and zeros, written by the threads); k_aug is k's
// 128-row block (one 64 x 128 box) and the one-hot block (written by the
// threads). One box lands a whole tile in 128-byte rows: the 8-column boxes
// of the no-swizzle layout (wgmma_bf16.cuh, the backward's) take a copy
// request each 16 bytes. Blocks start 1024-byte aligned, as the swizzle
// requires.
constexpr int kBlock = kWgRows * 64;  // elements of one 64 x 64 block

// element (r, f) of a block, f < 64
__device__ __forceinline__ int sw128_off(int r, int f) {
  return r * 64 + (((f >> 3) ^ (r & 7)) << 3) + (f & 7);
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled block: start
// address, LBO 16 bytes (unused: one block spans the 64 columns of either
// operand's contiguous dimension), SBO 1024 bytes (the next 8 rows),
// layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major (columns reduced, A or B): the k16 step kk of a two-block tile
__device__ __forceinline__ uint64_t sw128_desc_k(const bf16* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kBlock + (kk & 3) * 16);
}

// MN-major (rows reduced, B): rows 16 kk .. 16 kk + 15 of one block
__device__ __forceinline__ uint64_t sw128_desc_mn(const bf16* block, int kk) {
  return sw128_desc(block + kk * 16 * 64);
}

// Columns 0 .. kAug-65 of q_aug's second block for query row r =
// threadIdx.x % 64: rel_h | rel_w | 0 from row `row` of the (.., kh) and (..,
// kw) rel terms, zeros where row < 0 (past n, or not a query slot). Two
// threads a row, alternate 16-byte chunks.
template <int kAug>
__device__ __forceinline__ void stage_rel_rows_sw128(bf16* Q1, const bf16* __restrict__ rel_h,
                                                     const bf16* __restrict__ rel_w, long long row,
                                                     int kh, int kw) {
  constexpr int kChunks = (kAug - kWgD) / 8;
  const int r = threadIdx.x & (kWgRows - 1);
  const bool valid = row >= 0;
  for (int c = threadIdx.x >> 6; c < kChunks; c += kWgThreads / kWgRows) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = 8 * c + e;
      v[e] = !valid ? 0.f
             : f < kh ? __bfloat162float(rel_h[row * kh + f])
             : f < kh + kw ? __bfloat162float(rel_w[row * kw + f - kh])
             : 0.f;
    }
    *reinterpret_cast<uint4*>(Q1 + sw128_off(r, 8 * c)) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  }
}

// d (64 x 128, float32) = or += A . B^T, A and B K-major in shared memory
// (acc 0: overwrite)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 200, float32) = or += A . B^T, A and B K-major in shared memory (acc 0:
// overwrite): the one S product of a window of up to 200 keys
__device__ __forceinline__ void wgmma_ss_n200(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99}, "
      "%100, %101, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(acc));
}

constexpr int kKeyTile = 128;           // keys a step: S is one m64n128 product
constexpr int kKBlock = kKeyTile * 64;  // elements of a 128-row block
static_assert(kWgThreads == kKeyTile, "build_onehot_sw128 writes one key a thread");

// Columns 0 .. kAug-65 of k_aug's one-hot block for keys key0 .. key0+127:
// E_h at y, E_w at kh + x, zeros elsewhere and for keys past n. Each thread
// writes one key's 16-byte chunks; its row y = key / kw is taken as
// (key + 1/2) * (1 / kw) rounded down, exact while key < 2^20 (the quotient
// then lies at least 1 / (2 kw) from an integer, far beyond float32's error).
template <int kAug>
__device__ __forceinline__ void build_onehot_sw128(bf16* E, int key0, int n, int kh, int kw,
                                                   float inv_kw) {
  constexpr int kChunks = (kAug - kWgD) / 8;
  const int r = threadIdx.x;  // kWgThreads == kKeyTile: one key a thread
  const int key = key0 + r;
  const int yk = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_kw);
  const bool valid = key < n;
  const int y = valid ? yk : -1;
  const int hx = valid ? kh + key - yk * kw : -1;
  // the bfloat16 bits of 1 at column y and at hx, as integer selects (no
  // conversions): word f / 2 of the row, half f % 2
  constexpr uint32_t kOne = 0x3F80u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = 8 * c + 2 * e;
      w[e] = (y == f || hx == f ? kOne : 0u) | (y == f + 1 || hx == f + 1 ? kOne << 16 : 0u);
    }
    *reinterpret_cast<uint4*>(E + sw128_off(r, 8 * c)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// q_aug (two 64-row blocks; K7: q's one), the one-hot block (not K7), two
// stages of k and of v (one 128-row block each), K7's bias tile [64][128 +
// kBiasPad] float32, three barriers, and 1 KB to align the first block
template <bool kDense>
constexpr size_t wg_fwd_smem_bytes() {
  return sizeof(bf16) * ((kDense ? 1 : 2) * kBlock + (kDense ? 4 : 5) * kKBlock) +
         (kDense ? sizeof(float) * kWgRows * (kKeyTile + kBiasPad) : 0) + sizeof(uint64_t) * 3 +
         1024;
}

// One step of the row statistics over the 64 keys of accumulator columns
// 64 h .. 64 h + 63 (a 64-key tile of the CPU model): the new maxima, the
// rescale of what came before, this thread's share of the sums. kGuard
// (K7, whose bias may be -inf): while a row's maximum is -inf the reference
// point is 0, so that exp(-inf - -inf) is never formed
template <bool kGuard>
__device__ __forceinline__ void row_stats(const float* s, float& m0, float& m1, float& l0,
                                          float& l1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  quad_max(mx0, mx1);
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  const float ms0 = kGuard && mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = kGuard && mn1 == -INFINITY ? 0.f : mn1;
  l0 *= expf(m0 - ms0);
  l1 *= expf(m1 - ms1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    l0 += expf(s[4 * j] - ms0) + expf(s[4 * j + 1] - ms0);
    l1 += expf(s[4 * j + 2] - ms1) + expf(s[4 * j + 3] - ms1);
  }
}

// K7: s = s * scale + bias in float32, _attn_kernel's order, over the nj
// 8-key groups of a thread's accumulator; keys past n score -inf. Bs: the
// bias tile, rows of kBRow floats (the rows' stride puts a warp's float2
// reads in 32 banks a half-warp); k0: the key of accumulator column 0
template <int nj, int kBRow>
__device__ __forceinline__ void scale_add_bias(float* s, const float* Bs, int lr0, int tq, int k0,
                                               int n, float scale) {
#pragma unroll
  for (int j = 0; j < nj; ++j) {
    const float2 b0 = *reinterpret_cast<const float2*>(Bs + lr0 * kBRow + 8 * j + 2 * tq);
    const float2 b1 = *reinterpret_cast<const float2*>(Bs + (lr0 + 8) * kBRow + 8 * j + 2 * tq);
    const int key = k0 + 8 * j + 2 * tq;
    const bool in0 = key < n;
    const bool in1 = key + 1 < n;
    s[4 * j] = in0 ? __fadd_rn(__fmul_rn(s[4 * j], scale), b0.x) : -INFINITY;
    s[4 * j + 1] = in1 ? __fadd_rn(__fmul_rn(s[4 * j + 1], scale), b0.y) : -INFINITY;
    s[4 * j + 2] = in0 ? __fadd_rn(__fmul_rn(s[4 * j + 2], scale), b1.x) : -INFINITY;
    s[4 * j + 3] = in1 ? __fadd_rn(__fmul_rn(s[4 * j + 3], scale), b1.y) : -INFINITY;
  }
}

// out = O rounded to bfloat16 (rows q and q + 8 of the thread's fragment,
// columns col .. of each 8-column group) and lse = m + log l, each row's
// once, at tokens tr0 and tr1 of the image whose token 0 is tok0 (lse: at
// lse0 + token); a row whose token is < 0 is not written, nor the lse where
// a.lse is null
__device__ __forceinline__ void store_rows(const Bf16FwdArgs& a, const float* o, float m0,
                                           float m1, float l0, float l1, long long tok0,
                                           long long lse0, int tr0, int tr1, int col, int tq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tr1 : tr0;
    if (r < 0) continue;
    bf16* dst = a.out + (tok0 + r) * a.out_stride + col;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16x2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    if (a.lse != nullptr && tq == 0) a.lse[lse0 + r] = (half ? m1 : m0) + logf(half ? l1 : l0);
  }
}

// store_rows for query rows q and q + 8 of (image, head) bh, rows past n not written
__device__ __forceinline__ void store_out_lse(const Bf16FwdArgs& a, const float* o, float m0,
                                              float m1, float l0, float l1, long long tok0,
                                              long long bh, int q, int col, int tq, int n) {
  store_rows(a, o, m0, m1, l0, l1, tok0, bh * n, q < n ? q : -1, q + 8 < n ? q + 8 : -1, col, tq);
}

// The two walks. kDense: K7 (kAug 64, q alone, the float32 bias tile);
// else K3 / K6 (kAug 96 or 128, the rel terms folded in)
template <int kAug, bool kDense>
__global__ void __launch_bounds__(kWgThreads, 2)
    attention_fwd_wgmma_kernel(const Bf16FwdArgs a,
                               const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v) {
  static_assert(!kDense || kAug == kWgD, "K7 folds nothing into q");
  constexpr int D = kWgD;
  constexpr int kBRow = kKeyTile + kBiasPad;  // K7: floats a row of the bias tile
  extern __shared__ unsigned char wg_smem[];
  bf16* Qa = reinterpret_cast<bf16*>(wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023));
  // the one-hot block of a step's keys (k_aug's columns 64-)
  bf16* E = Qa + (kDense ? 1 : 2) * kBlock;
  bf16* Kt = E + (kDense ? 0 : kKBlock);     // [stage]: k of the streamed keys
  bf16* Vt = Kt + 2 * kKBlock;  // [stage]: their v (pass 2)
  float* Bs = reinterpret_cast<float*>(Vt + 2 * kKBlock);  // K7: the step's bias tile [64][kBRow]
  // [0]: Qa; [1 + stage]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + (kDense ? kWgRows * kBRow : 0));
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const long long img = blockIdx.z;
  const long long tok0 = img * n;
  const long long bh = img * heads + head;
  const int row0 = blockIdx.x * kWgRows;
  const int ntiles = (n + kKeyTile - 1) / kKeyTile;
  const int nsteps = 2 * ntiles;  // pass 1: steps 0 .. ntiles-1; pass 2: ntiles .. 2 ntiles-1
  const int hcol = head * D;

  if (t == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init(bar + 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int step) {  // one thread: k (and in pass 2 v) of step `step`'s keys
    const int st = step & 1;
    const bool pv = step >= ntiles;
    const int r0 = static_cast<int>(tok0) + (pv ? step - ntiles : step) * kKeyTile;
    mbar_expect_tx(bar + 1 + st, (pv ? 4 : 2) * kTileDBytes);
    tma_box(Kt + st * kKBlock, &tm_k, hcol, r0, bar + 1 + st);
    if (pv) tma_box(Vt + st * kKBlock, &tm_v, hcol, r0, bar + 1 + st);
  };
  if (t == 0) {
    mbar_expect_tx(bar, kTileDBytes);
    tma_box(Qa, &tm_q, hcol, static_cast<int>(tok0) + row0, bar);
    issue(0);
  }
  const float inv_kw = kDense ? 0.f : 1.f / kw;
  if constexpr (kDense) {  // the first step's bias tile; q is read as it lands
    copy_bias_async<kKeyTile>(Bs, a.bias, bh, n, row0, 0, true);
    cp_async_commit();
    mbar_wait(bar, 0);
  } else {
    // the rel rows and the zero columns beside q (plain loads: once a block),
    // and the first step's one-hot block
    const int r = row0 + (t & (kWgRows - 1));
    stage_rel_rows_sw128<kAug>(Qa + kBlock, a.rel_a, a.rel_b, r < n ? bh * n + r : -1, kh, kw);
    build_onehot_sw128<kAug>(E, 0, n, kh, kw, inv_kw);
    mbar_wait(bar, 0);
    scale_q_tile(Qa, __bfloat162float(__float2bfloat16_rn(a.scale)));  // every element of block 0
    fence_proxy_async();
  }
  __syncthreads();

  // this thread's rows lr0 = 16 warp + g and lr0 + 8 of the accumulators
  const int lr0 = warp * 16 + g;
  float m0 = -INFINITY, m1 = -INFINITY;  // the rows' maxima
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums, then the sums
  float inv0 = 0.f, inv1 = 0.f;          // 1 / l
  float o[32];                           // O: 64 rows x 64 columns, 8-column groups of 4
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    const int st = step & 1;
    const bool pv = step >= ntiles;
    // into the stage step - 1 read, which every thread is done with
    if (t == 0 && step + 1 < nsteps) issue(step + 1);
    const bf16* K = Kt + st * kKBlock;
    const bf16* V = Vt + st * kKBlock;
    const int k0 = (pv ? step - ntiles : step) * kKeyTile;
    mbar_wait(bar + 1 + st, (step >> 1) & 1);
    __syncthreads();  // the step's k (v) and one-hot block in place for the products

    // S = q_aug . [k | E]^T over the step's 128 keys: one m64n128 product of depth kAug
    float s[64];
    fence_regs<64>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAug / 16; ++kk)
      wgmma_ss_n128(s, sw128_desc_k(Qa, kk), sw128_desc(kk < 4 ? K + kk * 16 : E + (kk - 4) * 16),
                    kk);
    wgmma_commit();
    if constexpr (kDense) {  // the step's bias tile in place, while the product runs
      cp_async_wait<0>();
      __syncthreads();
    }
    wgmma_wait0();
    fence_regs<64>(s);
    if constexpr (kDense) {
      scale_add_bias<16, kBRow>(s, Bs, lr0, tq, k0, n, a.scale);
      __syncthreads();  // every thread has read the tile: the next step's copy goes in
      if (step + 1 < nsteps) {
        const int next = step + 1 < ntiles ? step + 1 : step + 1 - ntiles;
        copy_bias_async<kKeyTile>(Bs, a.bias, bh, n, row0, next * kKeyTile, true);
        cp_async_commit();
      }
    } else if (k0 + kKeyTile > n) {  // the last step: keys past n score -inf
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * tq + (e & 1) >= n) s[4 * j + e] = -INFINITY;
      }
    }
    // the next step's one-hot block, once every warp's S product has read
    // this one
    auto next_onehot = [&] {
      if constexpr (!kDense) {
        __syncthreads();
        if (step + 1 < nsteps) {
          const int next = step + 1 < ntiles ? step + 1 : step + 1 - ntiles;
          build_onehot_sw128<kAug>(E, next * kKeyTile, n, kh, kw, inv_kw);
          fence_proxy_async();
        }
      }
    };

    if (!pv) {  // pass 1: the online maximum and sum, a 64-key tile at a time
      next_onehot();
      row_stats<kDense>(s, m0, m1, l0, l1);
      if (k0 + kWgRows < n) row_stats<kDense>(s + 32, m0, m1, l0, l1);
      if (step == ntiles - 1) {  // the rows' sums over their four threads
        quad_sum(l0, l1);
        inv0 = 1.f / l0;
        inv1 = 1.f / l1;
      }
    } else {  // pass 2: P = bf16(exp(S - m) / l), O += P . V
      // K7: a row with no finite key has l = 0 and gives 0 / 0, as the plain softmax
      const float ms0 = kDense && m0 == -INFINITY ? 0.f : m0;
      const float ms1 = kDense && m1 == -INFINITY ? 0.f : m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = div_rn(expf(s[4 * j] - ms0), l0, inv0);
        s[4 * j + 1] = div_rn(expf(s[4 * j + 1] - ms0), l0, inv0);
        s[4 * j + 2] = div_rn(expf(s[4 * j + 2] - ms1), l1, inv1);
        s[4 * j + 3] = div_rn(expf(s[4 * j + 3] - ms1), l1, inv1);
      }
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pack_frag(pa[kk], s, kk);
      // each 64-key tile's P . V (keys reduced, V MN-major) from zero, as two
      // independent chains, then added to O in float32 tile by tile
      float pva[32], pvb[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pva[i] = pvb[i] = 0.f;
      fence_regs<32>(pva);
      fence_regs<32>(pvb);
      fence_regs<32>(&pa[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64(pva, pa[kk], sw128_desc_mn(V, kk));
        wgmma_rs_n64(pvb, pa[4 + kk], sw128_desc_mn(V, 4 + kk));
      }
      wgmma_commit();
      next_onehot();  // while the tensor cores run P . V
      wgmma_wait0();
      fence_regs<32>(pva);
      fence_regs<32>(pvb);
      fence_regs<32>(&pa[0][0]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += pva[i];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += pvb[i];
    }
    __syncthreads();  // stage and one-hot block consumed; the next one-hot block written
  }

  // out = O rounded to bfloat16, lse = m + log l, each row's once
  store_out_lse(a, o, m0, m1, l0, l1, tok0, bh, row0 + lr0, hcol + 2 * tq, tq, n);
}

// ---------------------------------------------------------------------------
// The one walk over a window of up to 200 keys (K2 and K7)
// ---------------------------------------------------------------------------

constexpr int kWinKeys = 200;   // keys of the window's S product (m64n200k16)
constexpr int kWinVRows = 208;  // rows of v: 13 k16 steps of P . V, keys 200 .. 207 at p = 0
constexpr int kStageRows = 280; // K2: table rows a tile stages (14 x 14 windows: 6 x 14 + 196)
constexpr int kStageRow = 72;   // K2: elements a staged row (64 and 8 of padding: 144 bytes)

// K2: the table rows a 64-query tile reads, at most: the rows of rh_flat of
// each row y of the window its queries lie in (at most 63 / kw + 2 of them,
// and q_h), and the whole of rw_flat (kw x kw)
__host__ __device__ constexpr int k2_stage_rows(int n, int kh, int kw) {
  return (n / kw < 63 / kw + 2 ? n / kw : 63 / kw + 2) * kh + kw * kw;
}

// K2: the table rows query rows row0 .. row0+63 read, by cp.async into T
// (rows of kStageRow elements): rh_flat's rows y kh + j for the tile's rows
// y = y_lo .. y_hi at (y - y_lo) kh + j, then rw_flat's row x kw + j at
// h_rows + j kw + x (transposed: the 14 rows a warp of w-terms reads at one
// j are consecutive, so they fall in distinct banks). Returns h_rows.
__device__ __forceinline__ int stage_table_rows(bf16* T, const bf16* __restrict__ rh,
                                                const bf16* __restrict__ rw, int n, int kh, int kw,
                                                int row0) {
  const int y_lo = row0 / kw;
  const int y_hi = (min(row0 + kWgRows, n) - 1) / kw;
  const int h_rows = (y_hi - y_lo + 1) * kh;
  const int rows = h_rows + kw * kw;
  for (int i = threadIdx.x; i < rows * (kWgD / 8); i += kWgThreads) {
    const int r = i >> 3;
    const int c = i & 7;
    const bf16* src;
    int dst;
    if (r < h_rows) {
      src = rh + static_cast<long long>(y_lo * kh + r) * kWgD;
      dst = r;
    } else {
      const int w = r - h_rows;
      const int x = w / kw;
      src = rw + static_cast<long long>(w) * kWgD;
      dst = h_rows + (w - x * kw) * kw + x;
    }
    cp_async16_bytes(T + dst * kStageRow + 8 * c, src + 8 * c, true);
  }
  return h_rows;
}

// K2: columns 0 .. 31 of q_aug's second block Q1 for query rows row0 ..
// row0+63: rel_h | rel_w | 0 from the unscaled q (Q0) and the staged table
// rows T, each term a float32 sum over 64 in kernel R's order (16 chunks of
// 4, in turn) rounded once to bfloat16; zeros for rows past n. Two threads a
// row: the h terms (threads 0-63), the w terms and the zero columns (64-127).
template <int kAug>
__device__ __forceinline__ void rel_terms_sw128(bf16* Q1, const bf16* Q0, const bf16* T,
                                                int h_rows, int n, int kh, int kw, int row0) {
  const int r = threadIdx.x & (kWgRows - 1);
  const bool w_half = threadIdx.x >= kWgRows;
  const int tok = row0 + r;
  const int col0 = w_half ? kh : 0;
  const int count = w_half ? kw : kh;
  const int end = w_half ? kAug - kWgD : kh;  // the columns this thread writes
  int f = col0;
  if (tok < n) {
    const int y = tok / kw;
    const int x = tok - y * kw;
    float4 q[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(Q0 + sw128_off(r, 8 * c));
      q[2 * c] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
      q[2 * c + 1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w));
    }
    // term j's row: (y - y_lo) kh + j, or h_rows + j kw + x
    const bf16* row = w_half ? T + (h_rows + x) * kStageRow : T + (y - row0 / kw) * kh * kStageRow;
    const int next = w_half ? kw * kStageRow : kStageRow;
    for (int j = 0; j < count; ++j, row += next, ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * c);
        acc += dot4(q[2 * c], make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y)));
        acc += dot4(q[2 * c + 1],
                    make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)));
      }
      Q1[sw128_off(r, f)] = __float2bfloat16_rn(acc);
    }
  }
  for (; f < end; ++f) Q1[sw128_off(r, f)] = __float2bfloat16_rn(0.f);
}

// K8: rows r0 .. r1-1 of a 128-byte-swizzled tile, which no box fills, set
// to zero (v's past n: p = 0 there, and 0 . NaN would be NaN)
__device__ __forceinline__ void zero_rows_sw128(bf16* T, int r0, int r1) {
  for (int i = r0 * 8 + threadIdx.x; i < r1 * 8; i += kWgThreads)
    reinterpret_cast<uint4*>(T)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// K8: query slots q0 .. q0+63 into q_aug's first block Q0 by the slot map: a
// slot with a token copies the token's 64 columns (base: the head's first
// column of the image's token 0, rows `stride` elements apart), any other
// slot zeros. 16-byte cp.async, eight threads a row.
__device__ __forceinline__ void gather_q_slots_sw128(bf16* Q0, const bf16* __restrict__ base,
                                                     long long stride, const int* tok_s, int q0) {
  for (int i = threadIdx.x; i < kWgRows * 8; i += kWgThreads) {
    const int r = i >> 3;
    const int c = i & 7;
    const int tok = tok_s[q0 + r];
    cp_async16_bytes(Q0 + sw128_off(r, 8 * c), tok >= 0 ? base + tok * stride + 8 * c : base,
                     tok >= 0);
  }
}

// K8: the pad slots' rows (token -1) among slots 0 .. n-1 of a k or v tile
// (128-byte swizzle) set to `pad`, the head's 64 columns of bias_kv's k or
// v row, over the zeros the box left there. Eight threads a row.
__device__ __forceinline__ void fill_pad_rows_sw128(bf16* T, const bf16* __restrict__ pad,
                                                    const int* tok_s, int n) {
  const int c = threadIdx.x & 7;
  const uint4 p = *reinterpret_cast<const uint4*>(pad + 8 * c);
  for (int s = threadIdx.x >> 3; s < n; s += kWgThreads / 8)
    if (tok_s[s] == -1) *reinterpret_cast<uint4*>(T + sw128_off(s, 8 * c)) = p;
}

constexpr int kSlotMap = 4 * kWgRows;  // K8: slots of a window's query tiles (n <= 200)

// q_aug (K2, K8: two blocks; K7: q's one), k (200 rows), v (208 rows), then
// K2's staged table rows, which the one-hot block of 200 keys overlays
// next, K7's bias tile [64][200] float32, or K8's one-hot block and its
// slot map; three barriers and 1 KB to align the first block
static_assert(kStageRows * kStageRow >= kWinKeys * kWgD, "the one-hot block fits the staging");
template <int kBias>
__host__ __device__ constexpr size_t wg_win_x_bytes() {
  return kBias == kRelTables ? sizeof(bf16) * kStageRows * kStageRow
         : kBias == kDense   ? sizeof(float) * kWgRows * kWinKeys
                             : sizeof(bf16) * kWinKeys * kWgD + sizeof(int) * kSlotMap;
}
template <int kBias>
constexpr size_t wg_win_smem_bytes() {
  return sizeof(bf16) * ((kBias == kDense ? 1 : 2) * kBlock + (kWinKeys + kWinVRows) * kWgD) +
         wg_win_x_bytes<kBias>() + sizeof(uint64_t) * 3 + 1024;
}

// kBias: kRelTables K2 (kAug 96, the rel terms from the tables rh_flat =
// a.rel_a, rw_flat = a.rel_b); kDense K7 (kAug 64, the float32 bias
// a.bias); kRelWindow K8 (kAug 96: the window `win` of image `img` carved
// from the token grid by the slot map, its rel terms a.rel_a, a.rel_b by
// token, pad slots' k and v from a.pad_kv; blockIdx.z = win * batch + img,
// so that every image's whole windows come before the windows of the
// grid's last window row, which hold one or two query tiles)
template <int kBias>
__global__ void __launch_bounds__(kWgThreads, 2)
    attention_fwd_wgmma_window_kernel(const Bf16FwdArgs a,
                                      const __grid_constant__ CUtensorMap tm_q,
                                      const __grid_constant__ CUtensorMap tm_k,
                                      const __grid_constant__ CUtensorMap tm_v) {
  constexpr bool kTables = kBias == kRelTables;
  constexpr bool kDenseBias = kBias == kDense;
  constexpr bool kSlots = kBias == kRelWindow;
  static_assert(kTables || kDenseBias || kSlots, "K2, K7 or K8");
  constexpr int D = kWgD;
  constexpr int kAug = kDenseBias ? 64 : 96;
  constexpr int kJ = kWinKeys / 8;  // 8-key groups of a thread's accumulator
  extern __shared__ unsigned char wg_smem[];
  bf16* Qa = reinterpret_cast<bf16*>(wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023));
  bf16* K = Qa + (kDenseBias ? 1 : 2) * kBlock;
  bf16* V = K + kWinKeys * D;
  bf16* E = V + kWinVRows * D;  // K2, K8: the one-hot block (K2: the staged table rows before it)
  float* Bs = reinterpret_cast<float*>(E);        // K7: the bias tile [64][200]
  int* tok_s = reinterpret_cast<int*>(E + kWinKeys * D);  // K8: the window's slot -> token map
  uint64_t* bar = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(E) +
                                              wg_win_x_bytes<kBias>());  // q, k, v
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const int row0 = blockIdx.x * kWgRows;
  long long img = blockIdx.z;
  long long tokens = n;  // tokens an image
  int win = 0;
  if constexpr (kSlots) {
    const int batch = gridDim.z / a.nwin;
    win = blockIdx.z / batch;
    img = blockIdx.z - static_cast<long long>(win) * batch;
    // no slot of this tile is a query: nothing to compute or write
    if (row0 >= window_queries(a, win)) return;
    tokens = static_cast<long long>(a.hg) * a.wg;
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int hcol = head * D;

  if (t == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init(bar + 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kSlots) stage_slot_tokens(tok_s, a, win, kSlotMap);
  __syncthreads();
  if (t == 0) {
    if constexpr (kSlots) {  // the window's k and v: one box each, its slots in slot order
      const int wy = win / a.nwx;
      const int x0 = (win - wy * a.nwx) * kw;
      mbar_expect_tx(bar + 1, n * D * sizeof(bf16));
      tma_box4(K, &tm_k, hcol, x0, wy * kw, static_cast<int>(img), bar + 1);
      mbar_expect_tx(bar + 2, n * D * sizeof(bf16));
      tma_box4(V, &tm_v, hcol, x0, wy * kw, static_cast<int>(img), bar + 2);
    } else {  // q, the window's k and v: each one box
      mbar_expect_tx(bar, kTileDBytes);
      tma_box(Qa, &tm_q, hcol, static_cast<int>(tok0) + row0, bar);
      mbar_expect_tx(bar + 1, kWinKeys * D * sizeof(bf16));
      tma_box(K, &tm_k, hcol, static_cast<int>(tok0), bar + 1);
      mbar_expect_tx(bar + 2, kWinVRows * D * sizeof(bf16));
      tma_box(V, &tm_v, hcol, static_cast<int>(tok0), bar + 2);
    }
  }
  const float inv_kw = 1.f / kw;
  if constexpr (kTables) {
    // the rel terms from the unscaled q and the staged table rows, then the
    // one-hot block over them, then q scaled in place
    const int h_rows = stage_table_rows(E, a.rel_a, a.rel_b, n, kh, kw, row0);
    cp_async_commit();
    cp_async_wait<0>();
    mbar_wait(bar, 0);
    __syncthreads();  // q and every staged row in place
    rel_terms_sw128<kAug>(Qa + kBlock, Qa, E, h_rows, n, kh, kw, row0);
    __syncthreads();  // the staged rows and q read
    build_onehot_sw128<kAug>(E, 0, n, kh, kw, inv_kw);
    if (t < kWinKeys - kKeyTile)
      build_onehot_sw128<kAug>(E + kKeyTile * D, kKeyTile, n, kh, kw, inv_kw);
    scale_q_tile(Qa, __bfloat162float(__float2bfloat16_rn(a.scale)));  // every element of block 0
    fence_proxy_async();
    __syncthreads();
  } else if constexpr (kSlots) {
    // q by the slot map and the rel rows beside it, the one-hot block by
    // slot position (pad slots too), v's rows past n zeroed (k's score
    // -inf), then q scaled in place and the pad slots' k over the box's zeros
    gather_q_slots_sw128(Qa, a.q + tok0 * a.in_stride + hcol, a.in_stride, tok_s, row0);
    cp_async_commit();
    const int tok = tok_s[row0 + (t & (kWgRows - 1))];
    stage_rel_rows_sw128<kAug>(Qa + kBlock, a.rel_a, a.rel_b, tok >= 0 ? bh * tokens + tok : -1,
                               kh, kw);
    build_onehot_sw128<kAug>(E, 0, n, kh, kw, inv_kw);
    if (t < kWinKeys - kKeyTile)
      build_onehot_sw128<kAug>(E + kKeyTile * D, kKeyTile, n, kh, kw, inv_kw);
    zero_rows_sw128(V, n, kWinVRows);
    cp_async_wait<0>();
    __syncthreads();  // q in place for every thread
    scale_q_tile(Qa, __bfloat162float(__float2bfloat16_rn(a.scale)));  // every element of block 0
    mbar_wait(bar + 1, 0);
    fill_pad_rows_sw128(K, a.pad_kv + (heads + head) * D, tok_s, n);
    fence_proxy_async();
    __syncthreads();
  } else {  // the bias tile; q is read as it lands
    copy_bias_async<kWinKeys, kWinKeys>(Bs, a.bias, bh, n, row0, 0, true);
    cp_async_commit();
    mbar_wait(bar, 0);
  }

  // S = q_aug . [k | E]^T over the window's keys: one m64n200 product of depth kAug
  const int lr0 = warp * 16 + g;
  float s[4 * kJ];
  if constexpr (!kSlots) mbar_wait(bar + 1, 0);
  fence_regs<4 * kJ>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kAug / 16; ++kk)
    wgmma_ss_n200(s, sw128_desc_k(Qa, kk), sw128_desc(kk < 4 ? K + kk * 16 : E + (kk - 4) * 16),
                  kk);
  wgmma_commit();
  if constexpr (kDenseBias) {  // the bias tile in place, while the product runs
    cp_async_wait<0>();
    __syncthreads();
  } else if constexpr (kSlots) {  // the pad slots' v over the box's zeros, while it runs
    mbar_wait(bar + 2, 0);
    fill_pad_rows_sw128(V, a.pad_kv + (2 * heads + head) * D, tok_s, n);
    fence_proxy_async();
    __syncthreads();
  }
  wgmma_wait0();
  fence_regs<4 * kJ>(s);
  if constexpr (kDenseBias) {
    scale_add_bias<kJ, kWinKeys>(s, Bs, lr0, tq, 0, n, a.scale);
  } else {  // keys past n score -inf
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * tq + (e & 1) >= n) s[4 * j + e] = -INFINITY;
    }
  }

  // the rows' exact maxima, e = exp(S - m) in place and their sums, then p =
  // bf16(e / l). K7: a row with no finite key takes 0 as its reference
  // point and gives 0 / 0, as the plain softmax
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
    m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  quad_max(m0, m1);
  const float ms0 = kDenseBias && m0 == -INFINITY ? 0.f : m0;
  const float ms1 = kDenseBias && m1 == -INFINITY ? 0.f : m1;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    s[4 * j] = expf(s[4 * j] - ms0);
    s[4 * j + 1] = expf(s[4 * j + 1] - ms0);
    s[4 * j + 2] = expf(s[4 * j + 2] - ms1);
    s[4 * j + 3] = expf(s[4 * j + 3] - ms1);
    l0 += s[4 * j] + s[4 * j + 1];
    l1 += s[4 * j + 2] + s[4 * j + 3];
  }
  quad_sum(l0, l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    s[4 * j] = div_rn(s[4 * j], l0, inv0);
    s[4 * j + 1] = div_rn(s[4 * j + 1], l0, inv0);
    s[4 * j + 2] = div_rn(s[4 * j + 2], l1, inv1);
    s[4 * j + 3] = div_rn(s[4 * j + 3], l1, inv1);
  }
  // P as the A fragments of P . V's 13 k16 steps: the last holds keys 192 ..
  // 199 and zeros for keys 200 .. 207
  uint32_t pa[13][4];
#pragma unroll
  for (int kk = 0; kk < 12; ++kk) pack_frag(pa[kk], s, kk);
  pa[12][0] = pack_bf16x2(s[96], s[97]);
  pa[12][1] = pack_bf16x2(s[98], s[99]);
  pa[12][2] = pa[12][3] = 0u;

  // O += P . V in the 64-key tiles, each from zero and added to O in float32
  // tile by tile: tiles 0 and 1 as two chains, then tiles 2 and 3
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  if constexpr (!kSlots) mbar_wait(bar + 2, 0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float pva[32], pvb[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pva[i] = pvb[i] = 0.f;
    fence_regs<32>(pva);
    fence_regs<32>(pvb);
    fence_regs<52>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64(pva, pa[8 * half + kk], sw128_desc_mn(V, 8 * half + kk));
#pragma unroll
    for (int kk = 0; kk < (half ? 1 : 4); ++kk)
      wgmma_rs_n64(pvb, pa[8 * half + 4 + kk], sw128_desc_mn(V, 8 * half + 4 + kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(pva);
    fence_regs<32>(pvb);
    fence_regs<52>(&pa[0][0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += pva[i];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += pvb[i];
  }

  if constexpr (kSlots) {  // by token; a pad query slot writes nothing
    store_rows(a, o, m0, m1, l0, l1, tok0, bh * tokens, tok_s[row0 + lr0], tok_s[row0 + lr0 + 8],
               hcol + 2 * tq, tq);
  } else {
    store_out_lse(a, o, m0, m1, l0, l1, tok0, bh, row0 + lr0, hcol + 2 * tq, tq, n);
  }
}

}  // namespace
