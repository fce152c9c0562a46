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
// on bfloat16 operands. Head dim 80 (ViT-H) and key grids with kh + kw > 64
// (a 64 x 64 global grid at 1024 pixels) stay on the mma.sync instance
// attention_bwd_bf16_{dq,dkv}_kernel<D, false, false>, as K2b and K8b do: the
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

}  // namespace
