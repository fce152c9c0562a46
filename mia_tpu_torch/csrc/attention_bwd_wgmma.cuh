// K3b and K6b in bfloat16 on Hopper's warpgroup products: the backward of
// the rel-pos attention at head dim 64 with kh + kw <= 64, redesigned from
// the bfloat16 mma.sync instance of attention_bwd_tc.cuh. attention_rel.cu's
// bfloat16 backward entries (packed and head-major layouts) call the C entry
// of attention_bwd_wgmma.cu, which builds the tensor maps and launches these
// kernels.
//
// Replaces the TPU backward kernels of mia_tpu/ops/attention.py
//   K3b  _rel_packed_bwd  (_rel_packed_bwd_kernel), global blocks, packed qkv
//   K6b  _rel_bwd         (_rel_bwd_kernel), the head-major route
// on bfloat16 operands, and K8b on windows (the window instance at the end of
// this file). Head dim 80 (ViT-H) and key grids with kh + kw > 64 (a 64 x 64
// global grid at 1024 pixels) stay on the mma.sync instance
// attention_bwd_bf16_{dq,dkv}_kernel<D, false, false>, as K2b does: the
// folded products below are sized for a 64-wide head and at most 64 rel
// columns (dq_aug's accumulator is 64 registers a thread at 128 columns).
//
// What it computes, with the Pallas kernel's roundings (as the instance it
// replaces): q * scale rounded to bfloat16 with the scale rounded first;
// p = exp(S - lse) in float32 from the forward's log-sum-exp; delta =
// rowsum(g * o) a float32 sum; P and dS = p (dP - delta) rounded to bfloat16
// where the Pallas kernel rounds p_lo and ds_lo; dq = (dS . K) * scale, dk =
// dS^T . (scale Q), dv = P^T . G float32 sums rounded once; drel_h / drel_w
// float32 sums of the rounded dS over a key row / column, rounded once.
//
// The rel terms are folded into the products as the Pallas kernel folds them
// (mia_tpu/ops/attention.py, _rel_packed_bwd_kernel): a 64-row tile of
//   q_aug = [q * scale | rel_h | rel_w | 0]   against   k_aug = [k | E_h | E_w | 0],
// kAug = 64 + kh + kw rounded up to 96 or 128 columns, where E_h[key, y] =
// (key / kw == y) and E_w[key, x] = (key % kw == x) are one-hot columns, so
//   S = q_aug . k_aug^T = (scale q) . k + rel_h[q, y] + rel_w[q, x]
// comes out of one product of depth kAug, and
//   dq_aug = dS . k_aug = [dS . k | drel_h | drel_w | 0]
// out of one product of width kAug. E_h is not sliced to the tile's key
// rows: a 64-key tile of the 32 x 32 grid would drop 16 of 128 columns, and
// a 14 x 14 window's tile spans 6 key rows (16 columns), as many as E_h.
//
// Two passes that write disjoint outputs (no atomics: two launches are
// bit-identical), each block one warpgroup (128 threads) of 64 rows, three
// blocks an SM (launch bounds: at most 168 registers; ~74 KB of shared
// memory a block at kAug 128, the largest carve-out), so three consumer
// warpgroups share an SM and one's CUDA-core work (exp, dS, the one-hot
// columns) overlaps the others' products:
//   pass A, a 64-query tile: q_aug and G stay in shared memory; it streams
//     64-key tiles of k_aug and V: S = q_aug . k_aug^T (SS, depth kAug), dP =
//     G . V^T (SS, depth 64), dS from the accumulators, then dq_aug += dS .
//     k_aug with dS as the register A operand (the accumulator reused as
//     FlashAttention-3 does) and k_aug read MN-major (the transpose bit), so
//     no transposed copy exists. Each row's drel is written once from its
//     registers; it also writes delta for pass B.
//   pass B, a 64-key tile: k_aug and V stay; it streams 64-query tiles of
//     q_aug, G, lse and delta: S^T = k_aug . q_aug^T, dP^T = V . G^T, then dv
//     += P^T . G and dk += dS^T . (scale Q), P^T and dS^T from registers, G
//     and the q part of q_aug MN-major.
// Every product is wgmma.mma_async m64nNk16 (N = 64, or 32 for the last
// columns of a 96-wide dq_aug) with float32 accumulators; a tile's products
// are committed as one group and waited for before their results are read.
// A 64-key tile's products add into dq_aug's accumulator, as the mma.sync
// instance adds into its fragments (the chains stay 4 k-steps a tile; the
// card's hold is 2^-7 of max |plain|, tests/test_torch_cuda.py).
//
// Shared tiles use wgmma's no-swizzle layout, one tile K-major and MN-major
// alike; that layout, the products, the mbarriers, the TMA boxes and the
// staging of the folded operands are wgmma_bf16.cuh's, which the forward of
// K3 and K6 (attention_fwd_wgmma.cuh) shares.
//
// Copies: q, k, v and g tiles are TMA boxes (8 columns x 64 rows, tensor
// maps over the packed qkv / g, or the head-major q, k, v, g, with rows past
// the tensor zero-filled) completing on an mbarrier per stage. Pass B's
// streamed rel rows are TMA boxes too when kh and kw are multiples of 8 (the
// 32 x 32 global grid); else their columns start anywhere in the layout and
// they come by 4-byte cp.async pairs (kh, kw even: 14 x 14 windows) or plain
// loads, as do lse and delta (cp.async) and pass A's rel rows (plain loads,
// once a block). Two stages: the next tile is in flight while one is
// computed. With a power-of-two scale (1/8 at head dim 64) pass B scales its
// block's k once instead of every streamed q tile (exact, see pass B). The
// one-hot columns of a key tile are written by the threads (one 16-byte
// store per 8 columns of a row), once per key tile: pass B builds its
// block's once, pass A each streamed tile's (the pattern moves with the tile).
// Rows past n: keys score p = 0 and queries get dS = 0 by selection, so
// whatever the neighbouring rows hold never reaches an output.
//
// Against the causes that held the mma.sync instance at 5.7% of its bound
// (PERF.md): the products are 64 x 64 x 16 warpgroup products instead of
// m16n8k16 chains; the rel bias is in the S product, not added per score on
// the CUDA cores; drel comes out of the dq_aug product in registers instead
// of shared-memory read-modify-writes. Still seven products' worth of work
// (S and dP in both passes), deeper S and wider dq_aug by the fold: 40
// m64n64k16 products a (64-query, 64-key) tile pair at kAug 128 where the
// VJP needs 20. Each product group is waited for before its results are
// read (letting a tile's gradient products run across the next tile's
// start measured 2-4% slower on the card, PERF.md), so the card's tensor
// cores idle while a warpgroup computes dS; three warpgroups an SM hide part
// of it.
//
// Bound (chip_smoke.py computes it; unchanged by the fold): operations, the
// VJP's 10 D flops a (query, key) pair at 989 TFLOP/s dense bfloat16, or
// bytes (qkv, the rel terms, out and g read once, dqkv and drel written
// once) at 3.35 TB/s, whichever is larger: K3b at (144, 1024, 64) 97.71 us;
// K6b's 14 x 14 windows (B * 108, 196, 64) are bound by bytes.

#pragma once

#include "attention_bwd_tc.cuh"
#include "wgmma_bf16.cuh"

namespace {

template <int kAug>
constexpr size_t wg_dq_smem_bytes() {
  return sizeof(bf16) * (3 * kWgRows * kAug + 3 * kWgRows * kWgD) + sizeof(float) * 2 * kWgRows +
         sizeof(uint64_t) * 3;
}

template <int kAug>
constexpr size_t wg_dkv_smem_bytes() {
  return sizeof(bf16) * (3 * kWgRows * kAug + 3 * kWgRows * kWgD) + sizeof(float) * 4 * kWgRows +
         sizeof(uint64_t) * 3;
}

// Pass A: dq, drel_h, drel_w and delta of one 64-query tile.
template <int kAug>
__global__ void __launch_bounds__(kWgThreads, 3)
    attention_bwd_wgmma_dq_kernel(const Bf16BwdArgs a,
                                  const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_g) {
  constexpr int D = kWgD;
  constexpr int kTileAug = kWgRows * kAug;
  constexpr int kTileD = kWgRows * D;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Qa = reinterpret_cast<bf16*>(wg_smem);  // q_aug of the block's queries
  bf16* Gt = Qa + kTileAug;                      // their g
  bf16* Ka = Gt + kTileD;                        // [stage]: k_aug of the streamed keys
  bf16* Vt = Ka + 2 * kTileAug;                  // [stage]: their v
  float* Lse = reinterpret_cast<float*>(Vt + 2 * kTileD);
  float* Dlt = Lse + kWgRows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Dlt + kWgRows);  // [0]: Qa, Gt; [1 + stage]
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw, ka = kh + kw;
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
  const int ntiles = (n + kWgRows - 1) / kWgRows;
  const int hcol = head * D;

  if (t == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init(bar + 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int tile) {  // one thread: k and v of key tile `tile`
    const int st = tile & 1;
    mbar_expect_tx(bar + 1 + st, 2 * kTileDBytes);
    tma_tile(Ka + st * kTileAug, &tm_k, hcol, static_cast<int>(tok0) + tile * kWgRows,
             bar + 1 + st);
    tma_tile(Vt + st * kTileD, &tm_v, hcol, static_cast<int>(tok0) + tile * kWgRows,
             bar + 1 + st);
  };
  if (t == 0) {
    mbar_expect_tx(bar, 2 * kTileDBytes);
    tma_tile(Qa, &tm_q, hcol, static_cast<int>(tok0) + row0, bar);
    tma_tile(Gt, &tm_g, hcol, static_cast<int>(tok0) + row0, bar);
    issue(0);
  }
  // the rel rows beside q (plain loads: once a block), lse and delta =
  // rowsum(g * o) of the block's rows (two threads a row)
  stage_rel_rows<kAug, false>(Qa, a.rel_a, a.rel_b, bh, n, kh, kw, row0);
  {
    const int r = t >> 1;
    const int half = t & 1;
    const bool valid = row0 + r < n;
    float dl = 0.f;
    if (valid) {
      const long long off = (tok0 + row0 + r) * a.out_stride + hcol + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(a.g + off + c));
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(a.out + off + c));
        dl = fmaf(bf16_lo(gv.x), bf16_lo(ov.x), dl);
        dl = fmaf(bf16_hi(gv.x), bf16_hi(ov.x), dl);
        dl = fmaf(bf16_lo(gv.y), bf16_lo(ov.y), dl);
        dl = fmaf(bf16_hi(gv.y), bf16_hi(ov.y), dl);
        dl = fmaf(bf16_lo(gv.z), bf16_lo(ov.z), dl);
        dl = fmaf(bf16_hi(gv.z), bf16_hi(ov.z), dl);
        dl = fmaf(bf16_lo(gv.w), bf16_lo(ov.w), dl);
        dl = fmaf(bf16_hi(gv.w), bf16_hi(ov.w), dl);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {
      Dlt[r] = dl;
      Lse[r] = valid ? __ldg(a.lse + bh * n + row0 + r) : 0.f;
      if (valid) a.delta[bh * n + row0 + r] = dl;
    }
  }
  mbar_wait(bar, 0);
  scale_q_tile(Qa, round_bf16(a.scale));
  fence_proxy_async();
  __syncthreads();

  // this thread's rows lr0 = 16 warp + g and lr0 + 8 of the accumulators
  const int lr0 = warp * 16 + g;
  const bool ok0 = row0 + lr0 < n;
  const bool ok1 = row0 + lr0 + 8 < n;
  const float lse0 = Lse[lr0], lse1 = Lse[lr0 + 8];
  const float dl0 = Dlt[lr0], dl1 = Dlt[lr0 + 8];

  float dqa[kAug / 2];  // dq_aug: [dS.k | drel_h | drel_w | 0], 8-column groups of 4
#pragma unroll
  for (int i = 0; i < kAug / 2; ++i) dqa[i] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (t == 0 && tile + 1 < ntiles) issue(tile + 1);
    bf16* K = Ka + st * kTileAug;
    const bf16* V = Vt + st * kTileD;
    const int k0 = tile * kWgRows;
    build_onehot<kAug>(K, k0, n, kh, kw);
    fence_proxy_async();
    mbar_wait(bar + 1 + st, (tile >> 1) & 1);
    __syncthreads();  // the tile's k, v and one-hot columns in place for the products

    float s[32], dp[32];
    fence_regs<32>(s);
    fence_regs<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAug / 16; ++kk) wgmma_ss_n64(s, desc_k(Qa, kk), desc_k(K, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dp, desc_k(Gt, kk), desc_k(V, kk), kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // ds = p (dp - delta), p = exp(S - lse); keys past n and rows past n give 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = key < n && (hi ? ok1 : ok0);
        const float p = ok ? __expf(s[4 * j + e] - (hi ? lse1 : lse0)) : 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - (hi ? dl1 : dl0));
      }
    }
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_frag(af[kk], s, kk);

    // dq_aug += dS . k_aug: keys reduced, k_aug MN-major, 64 columns a product
    fence_regs<kAug / 2>(dqa);
    fence_regs<16>(&af[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c + 64 <= kAug; c += 64) wgmma_rs_n64(dqa + c / 2, af[kk], desc_mn(K, c, kk));
      if constexpr (kAug % 64 == 32)
        wgmma_rs_n32(dqa + (kAug - 32) / 2, af[kk], desc_mn(K, kAug - 32, kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<kAug / 2>(dqa);
    fence_regs<16>(&af[0][0]);
    __syncthreads();  // stage consumed before the tile after next is copied into it
  }

  // dq = scale * dS.k rounded once; drel_h, drel_w rounded once, each row's once
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    const int q = row0 + lr0 + 8 * half;
    bf16* dq = a.dq + (tok0 + q) * a.in_stride + hcol;
    bf16* drh = a.drel_a + (bh * n + q) * kh;
    bf16* drw = a.drel_b + (bh * n + q) * kw;
#pragma unroll
    for (int j = 0; j < kAug / 8; ++j) {
      const int f = 8 * j + 2 * tq;
      const float v0 = dqa[4 * j + 2 * half], v1 = dqa[4 * j + 2 * half + 1];
      if (f < D) {
        *reinterpret_cast<uint32_t*>(dq + f) = pack_bf16x2(v0 * a.scale, v1 * a.scale);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = f + e - D;
          const bf16 v = __float2bfloat16_rn(e ? v1 : v0);
          if (c < kh) {
            drh[c] = v;
          } else if (c < ka) {
            drw[c - kh] = v;
          }
        }
      }
    }
  }
}

// How pass B stages a streamed tile's rel rows beside q (pass A stages its
// block's once, by plain loads): TMA boxes when kh and kw are multiples of 8
// (each 8-column run is a box of rel_h or rel_w), 4-byte cp.async pairs when
// both are even, else plain loads.
enum WgRelCopy { kRelPlain = 0, kRelPairs = 1, kRelBoxes = 2 };

// Pass B: dk and dv of one 64-key tile, streaming the query tiles. With a
// power-of-two scale (head dim 64: 1/8), the block's k is scaled once in
// place of every streamed q tile: (scale k) . q = k . (scale q) and dS^T .
// (scale q) = scale (dS^T . q), both exactly, so the result is the same.
template <int kAug, int kRel>
__global__ void __launch_bounds__(kWgThreads, 3)
    attention_bwd_wgmma_dkv_kernel(const Bf16BwdArgs a,
                                   const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_g,
                                   const __grid_constant__ CUtensorMap tm_rh,
                                   const __grid_constant__ CUtensorMap tm_rw) {
  constexpr int D = kWgD;
  constexpr int kTileAug = kWgRows * kAug;
  constexpr int kTileD = kWgRows * D;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Ka = reinterpret_cast<bf16*>(wg_smem);  // k_aug of the block's keys
  bf16* Vt = Ka + kTileAug;                      // their v
  bf16* Qa = Vt + kTileD;                        // [stage]: q_aug of the streamed queries
  bf16* Gt = Qa + 2 * kTileAug;                  // [stage]: their g
  float* LD = reinterpret_cast<float*>(Gt + 2 * kTileD);  // [stage][lse | delta][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(LD + 4 * kWgRows);  // [0]: Ka, Vt; [1 + stage]
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw, ka = kh + kw;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const long long img = blockIdx.z;
  const long long tok0 = img * n;
  const long long bh = img * heads + head;
  const int key0 = blockIdx.x * kWgRows;
  const int ntiles = (n + kWgRows - 1) / kWgRows;
  const int hcol = head * D;
  const float sc = round_bf16(a.scale);
  const bool pow2 = (__float_as_uint(sc) & 0x807FFFFFu) == 0u;  // a positive power of two

  if (t == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init(bar + 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad columns of both q_aug stages stay zero (nothing else writes them)
  if constexpr (kRel != kRelPlain) {
    zero_pad_columns<kAug>(Qa, ka);
    zero_pad_columns<kAug>(Qa + kTileAug, ka);
  }
  __syncthreads();
  auto issue_tma = [&](int tile) {  // one thread: q, g (and the rel rows) of query tile `tile`
    const int st = tile & 1;
    const int r0 = static_cast<int>(tok0) + tile * kWgRows;
    bf16* Q = Qa + st * kTileAug;
    mbar_expect_tx(bar + 1 + st,
                   2 * kTileDBytes + (kRel == kRelBoxes ? (ka / 8) * kWgRows * 16 : 0));
    tma_tile(Q, &tm_q, hcol, r0, bar + 1 + st);
    tma_tile(Gt + st * kTileD, &tm_g, hcol, r0, bar + 1 + st);
    if constexpr (kRel == kRelBoxes) {
      const int rr0 = static_cast<int>(bh * n) + tile * kWgRows;
      for (int c = 0; c < kh / 8; ++c)
        tma_box(Q + core_off(0, D + 8 * c), &tm_rh, 8 * c, rr0, bar + 1 + st);
      for (int c = 0; c < kw / 8; ++c)
        tma_box(Q + core_off(0, D + kh + 8 * c), &tm_rw, 8 * c, rr0, bar + 1 + st);
    }
  };
  auto issue_async = [&](int tile) {  // every thread: lse, delta (and the rel rows if pairs)
    const int st = tile & 1;
    const int q0 = tile * kWgRows;
    float* ld = LD + st * 2 * kWgRows;
    if (t < kWgRows) {
      const bool valid = q0 + t < n;
      const long long i = bh * n + (valid ? q0 + t : 0);
      cp_async4(ld + t, a.lse + i, valid);
      cp_async4(ld + kWgRows + t, a.delta + i, valid);
    }
    if constexpr (kRel == kRelPairs)
      stage_rel_rows<kAug, true>(Qa + st * kTileAug, a.rel_a, a.rel_b, bh, n, kh, kw, q0);
    cp_async_commit();
  };
  if (t == 0) {
    mbar_expect_tx(bar, 2 * kTileDBytes);
    tma_tile(Ka, &tm_k, hcol, static_cast<int>(tok0) + key0, bar);
    tma_tile(Vt, &tm_v, hcol, static_cast<int>(tok0) + key0, bar);
    issue_tma(0);
  }
  issue_async(0);
  build_onehot<kAug>(Ka, key0, n, kh, kw);

  // this thread's keys lr0 = 16 warp + g and lr0 + 8 of the accumulators
  const int lr0 = warp * 16 + g;
  const bool ok0 = key0 + lr0 < n;
  const bool ok1 = key0 + lr0 + 8 < n;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(bar, 0);
  if (pow2) scale_q_tile(Ka, sc);  // scale k once instead of every q tile

  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < ntiles) {
      if (t == 0) issue_tma(tile + 1);
      issue_async(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    bf16* Q = Qa + st * kTileAug;
    const bf16* G = Gt + st * kTileD;
    const float* lse_s = LD + st * 2 * kWgRows;
    const float* delta_s = lse_s + kWgRows;
    const int q0 = tile * kWgRows;
    if constexpr (kRel == kRelPlain)
      stage_rel_rows<kAug, false>(Q, a.rel_a, a.rel_b, bh, n, kh, kw, q0);
    mbar_wait(bar + 1 + st, (tile >> 1) & 1);
    if (!pow2) scale_q_tile(Q, sc);
    fence_proxy_async();
    __syncthreads();  // the tile's q_aug, g, lse and delta in place

    float s[32], dp[32];
    fence_regs<32>(s);
    fence_regs<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAug / 16; ++kk) wgmma_ss_n64(s, desc_k(Ka, kk), desc_k(Q, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dp, desc_k(Vt, kk), desc_k(G, kk), kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // p^T into s, ds^T into dp (rounded by the packing); queries and keys
    // past n give 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        const int q = 8 * j + 2 * tq + (e & 1);
        const bool ok = (hi ? ok1 : ok0) && q0 + q < n;
        const float p = ok ? __expf(s[4 * j + e] - lse_s[q]) : 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - (ok ? delta_s[q] : 0.f));
      }
    }
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_frag(pf[kk], s, kk);
      pack_frag(sf[kk], dp, kk);
    }

    // dv += P^T . G, dk += dS^T . (scale Q): queries reduced, G and Q MN-major
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    fence_regs<16>(&pf[0][0]);
    fence_regs<16>(&sf[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(dv, pf[kk], desc_mn(G, 0, kk));
      wgmma_rs_n64(dk, sf[kk], desc_mn(Q, 0, kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    fence_regs<16>(&pf[0][0]);
    fence_regs<16>(&sf[0][0]);
    __syncthreads();  // stage consumed before the tile after next is copied into it
  }

  // dk (times the scale when q went in unscaled), dv of the thread's keys, rounded once
  const float dk_scale = pow2 ? sc : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    const long long row = (tok0 + key0 + lr0 + 8 * half) * a.in_stride + hcol + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(a.dk + row + 8 * j) =
          pack_bf16x2(dk[4 * j + 2 * half] * dk_scale, dk[4 * j + 2 * half + 1] * dk_scale);
      *reinterpret_cast<uint32_t*>(a.dv + row + 8 * j) =
          pack_bf16x2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K8b: the window instance of passes A and B
// ---------------------------------------------------------------------------
//
// Replaces the TPU backward kernel mia_tpu/ops/attention.py::_rel_win_bwd
// (_attn_rel_win_bwd_kernel) on bfloat16 operands at head dim 64 on ws x ws
// windows of at most 200 slots (every SAM encoder's 14 x 14), from the
// mma.sync instance attention_bwd_bf16_{dq,dkv}_kernel<64, false, true>,
// which keeps head dim 80. K6b's windows case of the passes above (kh = kw
// = ws, kAug 96, the same products, roundings and selections) on windows
// carved from the unpartitioned (B, hg, wg, 3 H D) qkv grid by the slot map
// (attention_window.cuh), as the forward attention_fwd_wgmma_window_kernel<3>
// carves them; blockIdx.z = window * batch + image, so the windows of the
// grid's last window row (fewer query tiles) run last.
//
// A block holds its whole window on one side: pass A (a 64-query tile) the
// window's k_aug and v, pass B (a 64-key tile) its q_aug and g, as tiles of
// kWinSlots = 256 rows (the window's four 64-slot tiles: slots past ws * ws
// are zero rows and score p = 0 by selection, never by a multiply: 0 . NaN);
// the other side is the block's own 64 slots, gathered by the slot map. The
// window side lands by 4D TMA boxes of 8 columns over the token grid
// (grid_map: ws x ws tokens of one image, zeros past the grid's edge), eight
// boxes an operand, in the no-swizzle layout of the passes above with 256-row
// columns of core matrices (tall_off): the descriptors keep the 8 x 8 core
// matrices and step 4 KB between 8-column chunks (desc_k_tall, desc_mn_tall).
// That layout, not the forward's 128-byte swizzle, because the passes' RS
// products read k_aug's last 32 columns (the one-hot block) MN-major at n32,
// which the no-swizzle layout takes as it does for K6b; and because the
// window is copied once a block, 16 boxes, where K3b and K6b stream two
// 8-column boxes a tile and 16 bytes a request. A pad slot is a real key:
// the threads write bias_kv's k and v rows over the box's zeros once it has
// landed. A pad query slot is no query: its dS is 0 by selection, and
// nothing is written for it. dq, dk, dv go by token into the three column
// blocks of dqkv, drel_h and drel_w by token into (B H, hg, wg, ws), lse
// and delta are read and written by token; the pad keys' float32 dk | dv go
// to dpad, one partial row a (window, 64-key tile), which
// attention_bwd_pad_reduce_kernel (attention_routes.cu) sums in a fixed order.
// No atomics: two launches are bit-identical.

// rows of a window's tiles: four 64-slot tiles (ws * ws <= 200)
constexpr int kWinSlots = 4 * kWgRows;
constexpr int kWinAug = 96;             // q_aug / k_aug columns: 64 + 2 ws <= 96
constexpr uint32_t kTallChunkBytes = kWinSlots * 16;  // one 8-column chunk of a window tile

// element (r, f) of a kWinSlots-row tile in the no-swizzle core-matrix layout
__device__ __forceinline__ int tall_off(int r, int f) {
  return ((f >> 3) * kWinSlots + r) * 8 + (f & 7);
}

// Columns reduced (A, or B K-major): the k16 step kk of rows r0 .. r0+63 of a window tile
__device__ __forceinline__ uint64_t desc_k_tall(const bf16* tile, int r0, int kk) {
  return wg_desc(tile + kk * 2 * kWinSlots * 8 + r0 * 8, kTallChunkBytes, kCoreBytes);
}

// Rows reduced (B MN-major): rows r0 .. r0+15 of a window tile, columns from f0 (a multiple of 8)
__device__ __forceinline__ uint64_t desc_mn_tall(const bf16* tile, int f0, int r0) {
  return wg_desc(tile + (f0 / 8) * kWinSlots * 8 + r0 * 8, kCoreBytes, kTallChunkBytes);
}

// Slots slot0 .. slot0+63 of one operand into columns 0 .. 63 of a 64-row
// tile by the slot map: a slot with a token copies the token's row, a pad
// slot pad_row (k, v) or zeros (pad_row null: q, g), a slot past n zeros.
// 16-byte cp.async, two threads a 32-byte run.
__device__ __forceinline__ void gather_slots(bf16* T, const bf16* __restrict__ base,
                                             long long stride, const int* tok_s, int slot0,
                                             const bf16* __restrict__ pad_row) {
  for (int i = threadIdx.x; i < kWgRows * 8; i += kWgThreads) {
    const int r = (i >> 1) & (kWgRows - 1);
    const int c = ((i >> 7) << 1) | (i & 1);
    const int tok = tok_s[slot0 + r];
    const bool valid = tok >= 0 || (tok == -1 && pad_row != nullptr);
    const bf16* src = tok >= 0 ? base + tok * stride : pad_row;
    cp_async16_bytes(T + core_off(r, 8 * c), valid ? src + 8 * c : base, valid);
  }
}

// Columns 64 .. 95 of q_aug for kRows slots from slot0 (a 64-row tile, or a
// window tile at kRows = kWinSlots) by the slot map: rel_h | rel_w | 0 from
// row row_base + token of the (.., ws) rel terms, zeros for a slot without a
// token. Even ws (every SAM encoder's 14): 4-byte cp.async of element
// pairs, zero-filled for a slot without a token (the caller commits and
// waits); odd ws: one thread a (slot, 16 columns), 16 predicated loads, then
// two 16-byte stores.
template <int kRows>
__device__ __forceinline__ void stage_rel_slots(bf16* Q, const bf16* __restrict__ rel_h,
                                                const bf16* __restrict__ rel_w, long long row_base,
                                                const int* tok_s, int slot0, int ws) {
  if (ws % 2 == 0) {
    constexpr int kPairs = (kWinAug - kWgD) / 2;
    for (int i = threadIdx.x; i < kRows * kPairs; i += kWgThreads) {
      const int r = i & (kRows - 1);
      const int j = 2 * (i / kRows);  // column - 64
      const int f = kWgD + j;
      uint32_t* dst = reinterpret_cast<uint32_t*>(Q + ((f >> 3) * kRows + r) * 8 + (f & 7));
      if (j >= 2 * ws) {
        *dst = 0u;
        continue;
      }
      const int tok = tok_s[slot0 + r];
      const long long row = row_base + (tok >= 0 ? tok : 0);
      const bf16* src = j < ws ? rel_h + row * ws + j : rel_w + row * ws + (j - ws);
      cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), tok >= 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * kRows; i += kWgThreads) {
    const int r = i & (kRows - 1);
    const int half = i / kRows;
    const int tok = tok_s[slot0 + r];
    const long long row = row_base + tok;
    float v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int f = 16 * half + e;
      v[e] = tok < 0     ? 0.f
             : f < ws    ? __bfloat162float(rel_h[row * ws + f])
             : f < 2 * ws ? __bfloat162float(rel_w[row * ws + f - ws])
                          : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int f = kWgD + 16 * half + 8 * c;
      *reinterpret_cast<uint4*>(Q + ((f >> 3) * kRows + r) * 8) =
          make_uint4(pack_bf16x2(v[8 * c], v[8 * c + 1]), pack_bf16x2(v[8 * c + 2], v[8 * c + 3]),
                     pack_bf16x2(v[8 * c + 4], v[8 * c + 5]),
                     pack_bf16x2(v[8 * c + 6], v[8 * c + 7]));
    }
  }
}

// Rows n .. kWinSlots-1 of columns 0 .. 63 of a window tile (which no box
// fills) set to zero
__device__ __forceinline__ void zero_tall_rows(bf16* T, int n) {
  const int rows = kWinSlots - n;
  for (int i = threadIdx.x; i < 8 * rows; i += kWgThreads) {
    const int c = i / rows;
    *reinterpret_cast<uint4*>(T + tall_off(n + (i - c * rows), 8 * c)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Columns 64 .. 95 of a window's k_aug: E_h at 64 + y, E_w at 64 + ws + x
// for slot y ws + x < n (pad slots too), zeros elsewhere
__device__ __forceinline__ void build_onehot_tall(bf16* K, int n, int ws) {
  constexpr int kChunks = (kWinAug - kWgD) / 8;
  for (int i = threadIdx.x; i < kWinSlots * kChunks; i += kWgThreads) {
    const int r = i & (kWinSlots - 1);
    const int c = i / kWinSlots;
    const bool valid = r < n;
    const int y = valid ? r / ws : 0;
    const int hx = ws + (r - y * ws);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = 8 * c + 2 * e;  // column - 64
      w[e] = pack_bf16x2(valid && (f == y || f == hx) ? 1.f : 0.f,
                         valid && (f + 1 == y || f + 1 == hx) ? 1.f : 0.f);
    }
    *reinterpret_cast<uint4*>(K + tall_off(r, kWgD + 8 * c)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The pad slots' rows (token -1) among slots 0 .. n-1 of a window tile set to
// `pad`, the head's 64 columns of bias_kv's k or v row, over the box's zeros
__device__ __forceinline__ void fill_pad_rows_tall(bf16* T, const bf16* __restrict__ pad,
                                                   const int* tok_s, int n) {
  for (int i = threadIdx.x; i < 8 * n; i += kWgThreads) {
    const int s = i >> 3;
    const int c = i & 7;
    if (tok_s[s] == -1)
      *reinterpret_cast<uint4*>(T + tall_off(s, 8 * c)) =
          *reinterpret_cast<const uint4*>(pad + 8 * c);
  }
}

// Columns 0 .. 63 of the first `rows` rows of a no-swizzle tile of kRows rows
// scaled in place by sc, rounded once
template <int kRows>
__device__ __forceinline__ void scale_rows(bf16* Q, float sc) {
  for (int i = threadIdx.x; i < kRows * kWgD / 8; i += kWgThreads) {
    uint4* p = reinterpret_cast<uint4*>(Q) + i;
    uint4 u = *p;
    u.x = pack_bf16x2(bf16_lo(u.x) * sc, bf16_hi(u.x) * sc);
    u.y = pack_bf16x2(bf16_lo(u.y) * sc, bf16_hi(u.y) * sc);
    u.z = pack_bf16x2(bf16_lo(u.z) * sc, bf16_hi(u.z) * sc);
    u.w = pack_bf16x2(bf16_lo(u.w) * sc, bf16_hi(u.w) * sc);
    *p = u;
  }
}

// The window of block z (window * batch + image) and its geometry
struct WinBlock {
  int win, ws, n;
  long long img, tok0, bh, tokens;
};

__device__ __forceinline__ WinBlock win_block(const Bf16BwdArgs& a) {
  WinBlock w;
  const int batch = gridDim.z / a.nwin;
  w.win = blockIdx.z / batch;
  w.img = blockIdx.z - static_cast<long long>(w.win) * batch;
  w.ws = a.kw;
  w.n = a.n;
  w.tokens = static_cast<long long>(a.hg) * a.wg;
  w.tok0 = w.img * w.tokens;
  w.bh = w.img * a.heads + blockIdx.y;
  return w;
}

// One thread: the window's 8-column boxes of one operand (map over the token
// grid) into the columns 0 .. 63 of a window tile
__device__ __forceinline__ void tma_window(bf16* T, const CUtensorMap* map, const Bf16BwdArgs& a,
                                           const WinBlock& w, int hcol, uint64_t* bar) {
  const int wy = w.win / a.nwx;
  const int x0 = (w.win - wy * a.nwx) * w.ws;
#pragma unroll
  for (int c = 0; c < kWgD / 8; ++c)
    tma_box4(T + c * kWinSlots * 8, map, hcol + 8 * c, x0, wy * w.ws, static_cast<int>(w.img), bar);
}

constexpr size_t wg_win_dq_smem_bytes() {
  return sizeof(bf16) * (kWgRows * (kWinAug + kWgD) + kWinSlots * (kWinAug + kWgD)) +
         sizeof(float) * 2 * kWgRows + sizeof(int) * kWinSlots + sizeof(uint64_t);
}

constexpr size_t wg_win_dkv_smem_bytes() {
  return sizeof(bf16) * (kWgRows * (kWinAug + kWgD) + kWinSlots * (kWinAug + kWgD)) +
         sizeof(float) * 2 * kWinSlots + sizeof(int) * kWinSlots + sizeof(uint64_t);
}

// Pass A of the window instance: dq, drel_h, drel_w and delta of one 64-slot
// query tile; the window's k_aug and v stay in shared memory.
__global__ void __launch_bounds__(kWgThreads, 2)
    attention_bwd_wgmma_win_dq_kernel(const Bf16BwdArgs a,
                                      const __grid_constant__ CUtensorMap tm_k,
                                      const __grid_constant__ CUtensorMap tm_v) {
  constexpr int D = kWgD;
  constexpr int kAug = kWinAug;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Qa = reinterpret_cast<bf16*>(wg_smem);  // q_aug of the block's query slots
  bf16* Gt = Qa + kWgRows * kAug;                // their g
  bf16* Ka = Gt + kWgRows * D;                   // the window's k_aug, kWinSlots rows
  bf16* Vt = Ka + kWinSlots * kAug;              // its v
  float* Lse = reinterpret_cast<float*>(Vt + kWinSlots * D);
  float* Dlt = Lse + kWgRows;
  int* tok_s = reinterpret_cast<int*>(Dlt + kWgRows);  // the window's slot -> token map
  uint64_t* bar = reinterpret_cast<uint64_t*>(tok_s + kWinSlots);  // k and v
  const WinBlock w = win_block(a);
  const int n = w.n, ws = w.ws;
  const int row0 = blockIdx.x * kWgRows;
  // no slot of this tile is a query: nothing to compute or write
  if (row0 >= window_queries(a, w.win)) return;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const int hcol = head * D;
  const int heads = a.heads;

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_slot_tokens(tok_s, a, w.win, kWinSlots);
  __syncthreads();
  if (t == 0) {  // the window's k and v: eight 8-column boxes each
    mbar_expect_tx(bar, 2 * (D / 8) * n * 16);
    tma_window(Ka, &tm_k, a, w, hcol, bar);
    tma_window(Vt, &tm_v, a, w, hcol, bar);
  }
  // q and g of the block's slots by the map, their rel rows, the window's
  // one-hot columns by slot position, k's and v's rows past n zeroed
  gather_slots(Qa, a.q + w.tok0 * a.in_stride + hcol, a.in_stride, tok_s, row0, nullptr);
  gather_slots(Gt, a.g + w.tok0 * a.out_stride + hcol, a.out_stride, tok_s, row0, nullptr);
  stage_rel_slots<kWgRows>(Qa, a.rel_a, a.rel_b, w.bh * w.tokens, tok_s, row0, ws);
  cp_async_commit();
  build_onehot_tall(Ka, n, ws);
  zero_tall_rows(Ka, n);
  zero_tall_rows(Vt, n);
  // lse and delta = rowsum(g * o) of the block's query slots, by token (two threads a row)
  {
    const int r = t >> 1;
    const int half = t & 1;
    const int tok = tok_s[row0 + r];
    float dl = 0.f;
    if (tok >= 0) {
      const long long off = (w.tok0 + tok) * a.out_stride + hcol + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(a.g + off + c));
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(a.out + off + c));
        dl = fmaf(bf16_lo(gv.x), bf16_lo(ov.x), dl);
        dl = fmaf(bf16_hi(gv.x), bf16_hi(ov.x), dl);
        dl = fmaf(bf16_lo(gv.y), bf16_lo(ov.y), dl);
        dl = fmaf(bf16_hi(gv.y), bf16_hi(ov.y), dl);
        dl = fmaf(bf16_lo(gv.z), bf16_lo(ov.z), dl);
        dl = fmaf(bf16_hi(gv.z), bf16_hi(ov.z), dl);
        dl = fmaf(bf16_lo(gv.w), bf16_lo(ov.w), dl);
        dl = fmaf(bf16_hi(gv.w), bf16_hi(ov.w), dl);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {
      Dlt[r] = dl;
      Lse[r] = tok >= 0 ? __ldg(a.lse + w.bh * w.tokens + tok) : 0.f;
      if (tok >= 0) a.delta[w.bh * w.tokens + tok] = dl;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // q, g and the rel rows landed for every thread
  scale_rows<kWgRows>(Qa, round_bf16(a.scale));
  mbar_wait(bar, 0);
  fill_pad_rows_tall(Ka, a.pad_kv + (heads + head) * D, tok_s, n);
  fill_pad_rows_tall(Vt, a.pad_kv + (2 * heads + head) * D, tok_s, n);
  fence_proxy_async();
  __syncthreads();

  // this thread's rows lr0 = 16 warp + g and lr0 + 8 of the accumulators
  const int lr0 = warp * 16 + g;
  const int tk0 = tok_s[row0 + lr0], tk1 = tok_s[row0 + lr0 + 8];
  const bool ok0 = tk0 >= 0, ok1 = tk1 >= 0;  // query slots
  const float lse0 = Lse[lr0], lse1 = Lse[lr0 + 8];
  const float dl0 = Dlt[lr0], dl1 = Dlt[lr0 + 8];

  float dqa[kAug / 2];  // dq_aug: [dS.k | drel_h | drel_w | 0], 8-column groups of 4
#pragma unroll
  for (int i = 0; i < kAug / 2; ++i) dqa[i] = 0.f;

  const int ntiles = (n + kWgRows - 1) / kWgRows;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * kWgRows;
    float s[32], dp[32];
    fence_regs<32>(s);
    fence_regs<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAug / 16; ++kk)
      wgmma_ss_n64(s, desc_k(Qa, kk), desc_k_tall(Ka, k0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(Gt, kk), desc_k_tall(Vt, k0, kk), kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // ds = p (dp - delta), p = exp(S - lse); keys past n and slots that are no query give 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = key < n && (hi ? ok1 : ok0);
        const float p = ok ? __expf(s[4 * j + e] - (hi ? lse1 : lse0)) : 0.f;
        s[4 * j + e] = ok ? p * (dp[4 * j + e] - (hi ? dl1 : dl0)) : 0.f;
      }
    }
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_frag(af[kk], s, kk);

    // dq_aug += dS . k_aug: keys reduced, k_aug MN-major
    fence_regs<kAug / 2>(dqa);
    fence_regs<16>(&af[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(dqa, af[kk], desc_mn_tall(Ka, 0, k0 + 16 * kk));
      wgmma_rs_n32(dqa + 32, af[kk], desc_mn_tall(Ka, 64, k0 + 16 * kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<kAug / 2>(dqa);
    fence_regs<16>(&af[0][0]);
  }

  // dq = scale * dS.k rounded once at the token; drel_h, drel_w rounded once, each row's once
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = half ? tk1 : tk0;
    if (tok < 0) continue;
    bf16* dq = a.dq + (w.tok0 + tok) * a.in_stride + hcol;
    bf16* drh = a.drel_a + (w.bh * w.tokens + tok) * ws;
    bf16* drw = a.drel_b + (w.bh * w.tokens + tok) * ws;
#pragma unroll
    for (int j = 0; j < kAug / 8; ++j) {
      const int f = 8 * j + 2 * tq;
      const float v0 = dqa[4 * j + 2 * half], v1 = dqa[4 * j + 2 * half + 1];
      if (f < D) {
        *reinterpret_cast<uint32_t*>(dq + f) = pack_bf16x2(v0 * a.scale, v1 * a.scale);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = f + e - D;
          const bf16 v = __float2bfloat16_rn(e ? v1 : v0);
          if (c < ws) {
            drh[c] = v;
          } else if (c < 2 * ws) {
            drw[c - ws] = v;
          }
        }
      }
    }
  }
}

// Pass B of the window instance: dk and dv of one 64-slot key tile, and the
// tile's pad keys' float32 dk | dv into its dpad row; the window's q_aug and
// g stay in shared memory. With a power-of-two scale the block's k is scaled
// once instead of the window's q (exact, as in pass B above).
__global__ void __launch_bounds__(kWgThreads, 2)
    attention_bwd_wgmma_win_dkv_kernel(const Bf16BwdArgs a,
                                       const __grid_constant__ CUtensorMap tm_q,
                                       const __grid_constant__ CUtensorMap tm_g) {
  constexpr int D = kWgD;
  constexpr int kAug = kWinAug;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Ka = reinterpret_cast<bf16*>(wg_smem);  // k_aug of the block's key slots
  bf16* Vt = Ka + kWgRows * kAug;                // their v
  bf16* Qa = Vt + kWgRows * D;                   // the window's q_aug, kWinSlots rows
  bf16* Gt = Qa + kWinSlots * kAug;              // its g
  float* Lse = reinterpret_cast<float*>(Gt + kWinSlots * D);
  float* Dlt = Lse + kWinSlots;
  int* tok_s = reinterpret_cast<int*>(Dlt + kWinSlots);  // the window's slot -> token map
  uint64_t* bar = reinterpret_cast<uint64_t*>(tok_s + kWinSlots);  // q and g
  const WinBlock w = win_block(a);
  const int n = w.n, ws = w.ws;
  const int nq_all = window_queries(a, w.win);  // one past the last query slot
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const int hcol = head * D;
  const int heads = a.heads;
  const int key0 = blockIdx.x * kWgRows;
  const float sc = round_bf16(a.scale);
  const bool pow2 = (__float_as_uint(sc) & 0x807FFFFFu) == 0u;  // a positive power of two

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_slot_tokens(tok_s, a, w.win, kWinSlots);
  __syncthreads();
  if (t == 0) {  // the window's q and g: eight 8-column boxes each
    mbar_expect_tx(bar, 2 * (D / 8) * n * 16);
    tma_window(Qa, &tm_q, a, w, hcol, bar);
    tma_window(Gt, &tm_g, a, w, hcol, bar);
  }
  // k and v of the block's slots by the map (pad slots from bias_kv), their
  // one-hot columns by slot position, the window's rel rows, lse and delta
  // by token, q's and g's rows past n zeroed
  gather_slots(Ka, a.k + w.tok0 * a.in_stride + hcol, a.in_stride, tok_s, key0,
               a.pad_kv + (heads + head) * D);
  gather_slots(Vt, a.v + w.tok0 * a.in_stride + hcol, a.in_stride, tok_s, key0,
               a.pad_kv + (2 * heads + head) * D);
  stage_rel_slots<kWinSlots>(Qa, a.rel_a, a.rel_b, w.bh * w.tokens, tok_s, 0, ws);
  for (int i = t; i < kWinSlots; i += kWgThreads) {  // zero-filled for a slot without a token
    const int tok = tok_s[i];
    const long long at = w.bh * w.tokens + (tok >= 0 ? tok : 0);
    cp_async4(Lse + i, a.lse + at, tok >= 0);
    cp_async4(Dlt + i, a.delta + at, tok >= 0);
  }
  cp_async_commit();
  build_onehot<kAug>(Ka, key0, n, ws, ws);
  zero_tall_rows(Qa, n);
  zero_tall_rows(Gt, n);
  cp_async_wait<0>();
  __syncthreads();  // k, v, the rel rows, lse and delta landed for every thread
  if (pow2) scale_rows<kWgRows>(Ka, sc);  // scale k once instead of the window's q
  mbar_wait(bar, 0);
  if (!pow2) {
    __syncthreads();  // every thread's rows past n zeroed
    scale_rows<kWinSlots>(Qa, sc);
  }
  fence_proxy_async();
  __syncthreads();

  // this thread's keys lr0 = 16 warp + g and lr0 + 8 of the accumulators (pad slots are keys)
  const int lr0 = warp * 16 + g;
  const bool ok0 = key0 + lr0 < n;
  const bool ok1 = key0 + lr0 + 8 < n;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  const int ntiles = (nq_all + kWgRows - 1) / kWgRows;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kWgRows;
    float s[32], dp[32];
    fence_regs<32>(s);
    fence_regs<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAug / 16; ++kk)
      wgmma_ss_n64(s, desc_k(Ka, kk), desc_k_tall(Qa, q0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(Vt, kk), desc_k_tall(Gt, q0, kk), kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // p^T into s, ds^T into dp (rounded by the packing); slots that are no
    // query and keys past n give 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        const int q = q0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = (hi ? ok1 : ok0) && tok_s[q] >= 0;
        const float p = ok ? __expf(s[4 * j + e] - Lse[q]) : 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = ok ? p * (dp[4 * j + e] - Dlt[q]) : 0.f;
      }
    }
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_frag(pf[kk], s, kk);
      pack_frag(sf[kk], dp, kk);
    }

    // dv += P^T . G, dk += dS^T . Q: queries reduced, G and Q MN-major
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    fence_regs<16>(&pf[0][0]);
    fence_regs<16>(&sf[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(dv, pf[kk], desc_mn_tall(Gt, 0, q0 + 16 * kk));
      wgmma_rs_n64(dk, sf[kk], desc_mn_tall(Qa, 0, q0 + 16 * kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    fence_regs<16>(&pf[0][0]);
    fence_regs<16>(&sf[0][0]);
  }

  // dk (times the scale when q went in unscaled), dv of the keys with a token,
  // rounded once, at the token
  const float dk_scale = pow2 ? sc : 1.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] *= dk_scale;
  const int tk0 = tok_s[key0 + lr0], tk1 = tok_s[key0 + lr0 + 8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = half ? tk1 : tk0;
    if (tok < 0) continue;
    const long long row = (w.tok0 + tok) * a.in_stride + hcol + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(a.dk + row + 8 * j) =
          pack_bf16x2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + row + 8 * j) =
          pack_bf16x2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
  // the pad keys' float32 dk | dv summed into this (window, key tile)'s
  // partial row: over each warp's 16 keys by shuffles across the row groups,
  // then the four warps in order through shared memory (the window's q tile
  // is consumed); a tile without a pad key writes zeros
  const bool pad0 = tk0 == -1, pad1 = tk1 == -1;
  const long long hd = static_cast<long long>(heads) * D;
  float* part =
      a.dpad + (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * hd + hcol;
  float* P = reinterpret_cast<float*>(Qa);  // [warp][dk | dv][D]
  if (__syncthreads_or(pad0 || pad1)) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sk = (pad0 ? dk[4 * j + e] : 0.f) + (pad1 ? dk[4 * j + 2 + e] : 0.f);
        float sv = (pad0 ? dv[4 * j + e] : 0.f) + (pad1 ? dv[4 * j + 2 + e] : 0.f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sk += __shfl_xor_sync(0xffffffffu, sk, off);
          sv += __shfl_xor_sync(0xffffffffu, sv, off);
        }
        if (g == 0) {
          P[warp * 2 * D + 8 * j + 2 * tq + e] = sk;
          P[warp * 2 * D + D + 8 * j + 2 * tq + e] = sv;
        }
      }
    }
    __syncthreads();
    for (int i = t; i < 2 * D; i += kWgThreads)
      part[i < D ? i : hd + i - D] = ((P[i] + P[2 * D + i]) + P[4 * D + i]) + P[6 * D + i];
  } else {
    for (int i = t; i < 2 * D; i += kWgThreads) part[i < D ? i : hd + i - D] = 0.f;
  }
}

}  // namespace
