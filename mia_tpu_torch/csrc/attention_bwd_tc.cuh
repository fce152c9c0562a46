// The backward attention template of the port: FlashAttention-2 style from
// the forward's per-row log-sum-exp, on token-major operands with runtime
// strides, every product in 3xTF32 on Hopper's tensor cores. Its instances:
//   attention_rel.cu     K3b (kTables false: the rel terms rel_h (B*H, n, kh),
//                        rel_w (B*H, n, kw) are inputs; packed qkv) and K2b
//                        (kTables true: kernel R of attention_rel.cu computes
//                        them from the two tables into one (B*H, n, kh + kw)
//                        buffer). K6b runs K3b's instance on head-major
//                        operands: heads = 1, in_stride = out_stride = D,
//                        every (batch, head) pair a batch element; every
//                        offset below (tok0 * stride + head * D for the rows,
//                        bh * n for lse, delta and the rel rows) reduces to
//                        that layout, and any n = kh * kw is taken.
//   attention_routes.cu  K8b (kWindow true): windows carved from the
//                        unpartitioned (B, hg, wg) token grid, below.
//
// Replaces the TPU backward kernels of mia_tpu/ops/attention.py
//   K3b  _rel_packed_bwd      (_rel_packed_bwd_kernel)
//   K2b  _rel_packed_ik_bwd   (_rel_packed_ik_bwd_kernel)
//   K6b  _rel_bwd             (_rel_bwd_kernel)
//   K8b  _rel_win_bwd         (_attn_rel_win_bwd_kernel)
// which hold every key of a query block at once and recompute the whole
// softmax row on the MXU (K6b also accumulates dk and dv across query blocks
// by revisiting one output block, which only a sequential grid allows). Here the forward's log-sum-exp gives the
// probabilities directly, p = exp(s * scale + rel_h[n, k / kw] +
// rel_w[n, k % kw] - lse), and the work splits in two passes that write
// disjoint outputs, so there are no atomics and two launches are
// bit-identical:
//
//   pass A, one block per 64-query tile (4 warps, 16 rows each), streams
//     64-key tiles: S = Q.K^T, dP = G.V^T, ds = p (dp - delta), dq += ds.K,
//     and drel_h[n, y] / drel_w[n, x], the sums of ds over the keys of row
//     y / column x of the key grid. It also writes delta = rowsum(g * o)
//     for pass B. (K2b: kernel Q of attention_rel.cu then routes drel back
//     into dq through the tables.)
//   pass B, one block per 64-key tile (4 warps, 16 keys each), streams
//     64-query tiles: S^T = K.Q^T, dP^T = V.G^T, then dv += P^T.G and
//     dk += dS^T.Q.
// Both passes recompute S and dP: 7 products of N^2 D per (batch, head)
// where the VJP needs 5. That is the price of determinism: a one-pass
// scheme needs atomics on dq, or a dq partial per key tile (600 MB at K3b's
// ViT-B/512 training shape).
//
// Tensor cores, 3xTF32 (the helpers of tf32_mma.cuh): every product runs on
// mma.sync.m16n8k8 in TF32 with a float32 accumulator, three MMAs a product
// on operands split into TF32 big + small parts, which keeps float32
// accuracy. P and dS are formed in float32 from the accumulators and split
// for the products that consume them. mma.sync rather than wgmma: TF32
// wgmma wants both operands K-major in shared memory, so P^T.G and dS^T.Q
// would need P and dS written out and transposed, and Q, G fragments could
// not stay in registers. With mma.sync the accumulator of S (or S^T) is
// reused as the A operand of the next product in registers: the m16n8
// accumulator holds columns 2t, 2t+1 where the m16n8k8 A operand wants
// columns t, t+4, so the reduction index is relabelled (k = t <-> key 2t,
// k = t + 4 <-> key 2t+1) in A and B alike. Shared tiles have rows padded to
// D + 4 floats, so fragment loads hit 32 banks.
//
// Asynchronous copies: the next K/V tile (pass A) or Q/G tile with its rel
// rows, lse and delta (pass B) is copied with cp.async into the other of
// two stages while the current one is computed. Rows past n are zero-filled
// by the copy; pad queries get no gradient and keys past n score nothing.
// The query (pass A) or key (pass B) fragments of the block's own rows stay
// in registers as float32 for the whole pass. Each streamed tile is
// computed in two sub-tiles of 32 rows to keep the score accumulators at 16
// registers; a warp whose 16 rows hold no query skips its products, and
// 8-row groups of streamed keys or queries past the last one are skipped,
// so a 196-token window computes 208 query rows and 200 keys (6% and 2% pad).
//
// Layout kWindow (K8b): blockIdx.z is a window of an image (batch * nwin of
// them), the block's n = ws * ws rows are the window's slots, and slot (i, j)
// of window (wy, wx) is grid token (wy ws + i, wx ws + j) (slot_token of
// attention_window.cuh, shared with K8), or a pad slot outside the grid. Each block stages its
// window's slot -> token map in shared memory once, so no copy divides an
// index. Copies go by that map (copy_slots_async): a pad slot is a real key
// whose k and v are the rows of pad_kv (the qkv Linear's output for a zero
// token) and whose rel bias is the query's for the slot position; it is no
// query, so its q and g rows are zero-filled, its rel rows too, and pass B
// gives it lse = +inf and delta = 0, so p = exp(0 + 0 - inf) = 0 exactly and
// no 0 * inf reaches dk or dv. lse, delta and the rel rows are read by token
// from the grid layouts (B*H, hg*wg) and (B*H, hg, wg, ws); dq, dk, dv and
// drel of a slot with a token are written at the token's place. A window's
// queries lie in its first (hr - 1) ws + wr slots (hr x wr of its slots are
// in the grid), so pass A skips the query tiles past them and pass B
// streams only the tiles before them: the bottom windows of a 32 x 32 grid
// with ws 14 hold 56 or 46 queries, one tile of four. The pad keys' dk and
// dv belong to pad_kv: pass B sums them over the pad keys of its tile (quad
// shuffles, then the four warps in order through shared memory) into one
// partial row per (window, key tile) of dpad, and the caller reduces the
// partials in a fixed order; no atomics, so two launches are bit-identical.
//
// Bound: operations. 7 x 2 x D flops per (query, key) pair at 495/3 TFLOP/s
// (the card's dense TF32 rate, three MMAs per product); the copies are
// ~2.3 KB per (query tile, key tile) pair against ~2 MFLOP of MMAs. At K6b's
// and K3b's B=12 global shape (144 x 1024 tokens, D = 64) the VJP's 10 x D
// flops a pair (chip_smoke.py's count) take 586 us at that rate, against
// 1442 us in float32 on the CUDA cores.
//
// The bfloat16 instance (attention_bwd_bf16_{dq,dkv}_kernel below: every
// layout of this template, for a bfloat16 encoder) is described before it.
//
// The kernels allocate nothing and do not synchronise; the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#pragma once

#include <math.h>

#include <type_traits>

#include "attention_fwd_tc.cuh"
#include "attention_window.cuh"
#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

struct BwdArgs {
  const float* q;       // first head's columns of token 0
  const float* k;
  const float* v;
  const float* rel_a;   // kTables false: rel_h; true: rh_flat (q_h*kh, D)
  const float* rel_b;   // kTables false: rel_w; true: rw_flat (kw*kw, D)
  const float* pad_kv;  // kWindow: (3, heads*D) q, k, v rows of a pad slot
  const float* out;     // the forward's output
  const float* g;       // its cotangent
  const float* lse;     // the forward's log-sum-exp (B*H, tokens)
  float* dq;            // same strides as q, k, v
  float* dk;
  float* dv;
  float* delta;         // scratch (B*H, tokens): rowsum(g * o), pass A -> B
  float* rel_out;       // kTables (K2b): scratch (B*H, n, kh+kw), kernel R's rel terms
  float* drel_a;        // kTables false: drel_h; true: drel (B*H, n, kh+kw) or null
  float* drel_b;        // kTables false: drel_w
  float* dpad;          // kWindow: (windows * key tiles, 2, heads*D) pad-slot dk | dv partials
  long long in_stride;  // floats per token row of q, k, v, dq, dk, dv
  long long out_stride; // floats per token row of out and g
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw
  int hg, wg;           // kWindow: the token grid
  int nwx, nwin;        // kWindow: windows per grid row, windows per image
  float scale;
};

constexpr int kTcSub = 32;  // streamed rows per register sub-tile

// The rel gradients of a warp's 16 rows from its ds sub-tile s (the C
// fragments of the keys key0 .. key0 + nks - 1, four 8-key groups), added to
// the block's DRel rows ([ka + 1]: drel_h | drel_w). A full sub-tile inside one
// key-grid row y (K3b: kw a multiple of 32) adds its row sums (quad shuffles)
// to drel_h[., y] and each ds to its own column of drel_w; otherwise the ds
// tile goes through the warp's shared Sw ([16][kTcSub + 1]) and lanes 0-15 add
// the runs of one key-grid row (drel_h), lanes 16-31 the columns (drel_w).
// ok0, ok1: the thread's rows (16 warp + g, + 8) are queries; lane_row_ok: row
// 16 warp + (lane & 15) lies below n. Rows that are no query hold ds = 0.
template <bool kFull>
__device__ __forceinline__ void add_drel(const float (&s)[4][4], float* DRel, float* Sw, int kh,
                                         int kw, int key0, int nks, int warp, int lane, bool ok0,
                                         bool ok1, bool lane_row_ok) {
  constexpr int kSubRow = kTcSub + 1;
  const int ka = kh + kw;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int lr0 = warp * 16 + g;
  const int y_sub = key0 / kw;
  const int x_sub = key0 - y_sub * kw;
  if (kFull && x_sub + kTcSub <= kw) {
    float h0 = 0.f, h1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h0 += s[j][0] + s[j][1];
      h1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      h0 += __shfl_xor_sync(0xffffffffu, h0, off);
      h1 += __shfl_xor_sync(0xffffffffu, h1, off);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? ok1 : ok0)) continue;
      float* dr = DRel + (lr0 + 8 * half) * (ka + 1);
      if (tq == 0) dr[y_sub] += half ? h1 : h0;
      dr += kh + x_sub + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dr[8 * j] += s[j][2 * half];
        dr[8 * j + 1] += s[j][2 * half + 1];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Sw[(g + ((e & 2) ? 8 : 0)) * kSubRow + 8 * j + 2 * tq + (e & 1)] = s[j][e];
    __syncwarp();
    const int lr = lane & 15;
    if (lane_row_ok) {
      const float* srow = Sw + lr * kSubRow;
      float* dr = DRel + (warp * 16 + lr) * (ka + 1);
      int y = y_sub;
      int x = x_sub;
      if (lane < 16) {
        float acc = 0.f;
        for (int c = 0; c < nks; ++c) {
          acc += srow[c];
          if (++x == kw) {
            dr[y] += acc;
            acc = 0.f;
            x = 0;
            ++y;
          }
        }
        if (x != 0) dr[y] += acc;
      } else if (kw >= 8) {  // 8 consecutive keys fall in 8 distinct columns
        dr += kh;
        int c = 0;
        for (; c + 8 <= nks; c += 8) {
          int xs[8];
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            xs[i] = x;
            v[i] = dr[x] + srow[c + i];
            if (++x == kw) x = 0;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) dr[xs[i]] = v[i];
        }
        for (; c < nks; ++c) {
          dr[x] += srow[c];
          if (++x == kw) x = 0;
        }
      } else {
        dr += kh;
        for (int c = 0; c < nks; ++c) {
          dr[x] += srow[c];
          if (++x == kw) x = 0;
        }
      }
    }
  }
  __syncwarp();
}

// Pass A: dq, delta and the rel gradients of one 64-query tile.
template <int D, bool kTables, bool kWindow = false>
__global__ void __launch_bounds__(kTcThreads, 2) attention_bwd_tc_dq_kernel(const BwdArgs a) {
  static_assert(!(kTables && kWindow), "K8b's rel terms are inputs");
  constexpr int kRow = D + 4;
  constexpr int kK = D / 8;  // k-steps (and n8 tiles) over the head dim
  constexpr int kSubRow = kTcSub + 1;
  extern __shared__ float4 smem4[];
  float* KV = reinterpret_cast<float*>(smem4);  // [stage][K | V][64][kRow]
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw, ka = kh + kw;
  float* Rel = KV + 4 * kTcTile * kRow;        // the tile's rel rows, rel_view
  float* DRel = Rel + kTcTile * ka;            // [64][ka + 1]: drel_h | drel_w
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // thread in group
  float* Sw = DRel + kTcTile * (ka + 1) + warp * 16 * kSubRow;  // this warp's ds sub-tile
  // kWindow: the window's slot -> token map, after the four warps' Sw
  [[maybe_unused]] int* tok_s =
      reinterpret_cast<int*>(DRel + kTcTile * (ka + 1) + 4 * 16 * kSubRow);
  const int head = blockIdx.y;
  long long img = blockIdx.z;  // batch element, or the image of this window
  int tokens = n;              // tokens per batch element / image
  if constexpr (kWindow) {
    img = blockIdx.z / a.nwin;
    const int win = static_cast<int>(blockIdx.z - img * a.nwin);
    // no slot of this tile is a query: nothing to compute or write
    if (static_cast<int>(blockIdx.x) * kTcTile >= window_queries(a, win)) return;
    tokens = a.hg * a.wg;
    stage_slot_tokens(tok_s, a, win, gridDim.x * kTcTile);
    __syncthreads();
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int row0 = blockIdx.x * kTcTile;
  const int rows = min(kTcTile, n - row0);
  const long long stride = a.in_stride;
  const long long ostride = a.out_stride;
  const float* q_base = a.q + tok0 * stride + head * D;
  const float* k_base = a.k + tok0 * stride + head * D;
  const float* v_base = a.v + tok0 * stride + head * D;
  const float* g_base = a.g + tok0 * ostride + head * D;
  const float* o_base = a.out + tok0 * ostride + head * D;
  const RelView rv = rel_view<kTables>(kh, kw);
  const int ntiles = (n + kTcTile - 1) / kTcTile;

  auto issue = [&](int tile) {
    float* st = KV + (tile & 1) * 2 * kTcTile * kRow;
    if constexpr (kWindow) {
      copy_slots_async<D>(st, k_base, stride, tok_s, tile * kTcTile,
                          a.pad_kv + (heads + head) * D);
      copy_slots_async<D>(st + kTcTile * kRow, v_base, stride, tok_s, tile * kTcTile,
                          a.pad_kv + (2 * heads + head) * D);
    } else {
      copy_rows_async<D>(st, k_base, stride, tile * kTcTile, n);
      copy_rows_async<D>(st + kTcTile * kRow, v_base, stride, tile * kTcTile, n);
    }
    cp_async_commit();
  };
  if constexpr (kWindow) {
    copy_rel_slots_async(Rel, a.rel_a, a.rel_b, bh * tokens, tok_s, kh, kw, row0);
  } else {
    copy_rel_async<kTables>(Rel, kTables ? a.rel_out : a.rel_a, kTables ? a.rel_out : a.rel_b,
                            bh, n, kh, kw, row0, rows);  // lands with tile 0
  }
  issue(0);

  for (int i = t; i < kTcTile * (ka + 1); i += kTcThreads) DRel[i] = 0.f;

  // this warp's rows lr0 = 16 warp + g and lr0 + 8: q and g fragments in
  // registers, lse, delta = rowsum(g * o) (quad shuffles over the columns).
  // tr0, tr1: their token rows, which are queries when below n (kWindow:
  // when the slot has a token)
  const int lr0 = warp * 16 + g;
  const int r0 = row0 + lr0;
  const int r1 = r0 + 8;
  int tr0 = r0, tr1 = r1;
  bool active = row0 + warp * 16 < n;
  if constexpr (kWindow) {
    tr0 = tok_s[r0];
    tr1 = tok_s[r1];
    active = __any_sync(0xffffffffu, tr0 >= 0 || tr1 >= 0);
  }
  auto query = [&](int tr) { return kWindow ? tr >= 0 : tr < n; };
  float qa[kK][4], ga[kK][4];
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? tr1 : tr0;
      const int c = 8 * kk + tq + ((e & 2) ? 4 : 0);
      const bool ok = query(r);
      qa[kk][e] = ok ? __ldg(q_base + r * stride + c) : 0.f;
      ga[kk][e] = ok ? __ldg(g_base + r * ostride + c) : 0.f;
      const float o = ok ? __ldg(o_base + r * ostride + c) : 0.f;
      if (e & 1) {
        dl1 = fmaf(ga[kk][e], o, dl1);
      } else {
        dl0 = fmaf(ga[kk][e], o, dl0);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
  }
  if (tq == 0) {
    if (query(tr0)) a.delta[bh * tokens + tr0] = dl0;
    if (query(tr1)) a.delta[bh * tokens + tr1] = dl1;
  }
  const float lse0 = query(tr0) ? __ldg(a.lse + bh * tokens + tr0) : 0.f;
  const float lse1 = query(tr1) ? __ldg(a.lse + bh * tokens + tr1) : 0.f;

  float dq[kK][4];
#pragma unroll
  for (int i = 0; i < kK; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile landed for every thread (the first with the rel rows)
    const float* Ks = KV + (tile & 1) * 2 * kTcTile * kRow;
    const float* Vs = Ks + kTcTile * kRow;
    const int k0 = tile * kTcTile;
    const int nk = min(kTcTile, n - k0);
    if (active) {
      // one sub-tile; kFull: all 32 rows present, no per-group branches
      auto sub_tile = [&](const int sub, const int nks, auto full) {
        constexpr bool kFull = decltype(full)::value;
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        // S = Q.K^T, dP = G.V^T over this sub-tile's 8-key groups
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          FragA fq, fg;
          fq.set<true>(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
          fg.set<true>(ga[kk][0], ga[kk][1], ga[kk][2], ga[kk][3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kFull || 8 * j < nks) {
              const int kr = (sub + 8 * j + g) * kRow + 8 * kk + tq;
              mma3(s[j], fq, Ks[kr], Ks[kr + 4]);
              mma3(dp[j], fg, Vs[kr], Vs[kr + 4]);
            }
          }
        }
        // ds = p (dp - delta), p from the lse; keys past n and rows that are
        // no query give 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kb = k0 + sub + 8 * j + 2 * tq;
          const int yb = kb / kw;
          const int xb = kb - yb * kw;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + (e & 1);
            int y = yb, x = xb + (e & 1);
            if (x == kw) {
              x = 0;
              ++y;
            }
            const bool hi = e & 2;
            const bool ok = key < n && query(hi ? tr1 : tr0);
            const int lr = hi ? lr0 + 8 : lr0;
            const float p = ok ? __expf(s[j][e] * a.scale + rv.bias(Rel, lr, y, x) -
                                        (hi ? lse1 : lse0))
                               : 0.f;
            s[j][e] = p * (dp[j][e] - (hi ? dl1 : dl0));
          }
        }
        add_drel<kFull>(s, DRel, Sw, kh, kw, k0 + sub, nks, warp, lane, query(tr0), query(tr1),
                        row0 + warp * 16 + (lane & 15) < n);
        // dq += ds . K: the accumulator of key group j is the A operand, its
        // reduction index relabelled (k = tq <-> key 2tq, k = tq+4 <-> key 2tq+1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kFull || 8 * j < nks) {
            FragA fs;
            fs.set(s[j][0], s[j][2], s[j][1], s[j][3]);
            const float* kr = Ks + (sub + 8 * j + 2 * tq) * kRow + g;
#pragma unroll
            for (int nd = 0; nd < kK; ++nd) mma3(dq[nd], fs, kr[8 * nd], kr[kRow + 8 * nd]);
          }
        }
      };
#pragma unroll 1
      for (int sub = 0; sub < nk; sub += kTcSub) {
        const int nks = min(kTcSub, nk - sub);
        if (nks == kTcSub) {
          sub_tile(sub, nks, std::true_type{});
        } else {
          sub_tile(sub, nks, std::false_type{});
        }
      }
    }
    __syncthreads();  // stage consumed before the next tile but one is copied into it
  }

  // dq = scale * ds.K (K2b: kernel Q then adds drel routed through the tables)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tr1 : tr0;
    if (!query(r)) continue;
    float* dst = a.dq + (tok0 + r) * stride + head * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < kK; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd) =
          make_float2(dq[nd][2 * half] * a.scale, dq[nd][2 * half + 1] * a.scale);
  }
  __syncthreads();  // DRel complete for the block-wide stores
  if constexpr (kWindow) {  // one warp a row with a token, one lane a column
    for (int r = warp; r < rows; r += kTcThreads / 32) {
      const int tok = tok_s[row0 + r];
      if (tok < 0) continue;
      const long long row = bh * tokens + tok;
      for (int j = lane; j < ka; j += 32) {
        const float v = DRel[r * (ka + 1) + j];
        if (j < kh) {
          a.drel_a[row * kh + j] = v;
        } else {
          a.drel_b[row * kw + j - kh] = v;
        }
      }
    }
  } else if constexpr (kTables) {
    for (int i = t; i < rows * ka; i += kTcThreads)
      a.drel_a[(bh * n + row0) * ka + i] = DRel[(i / ka) * (ka + 1) + i % ka];
  } else {
    for (int i = t; i < rows * kh; i += kTcThreads)
      a.drel_a[(bh * n + row0) * kh + i] = DRel[(i / kh) * (ka + 1) + i % kh];
    for (int i = t; i < rows * kw; i += kTcThreads)
      a.drel_b[(bh * n + row0) * kw + i] = DRel[(i / kw) * (ka + 1) + kh + i % kw];
  }
}

// Pass B: dk and dv of one 64-key tile, streaming the query tiles. The rel
// rows come from rel_h / rel_w (K3b, K8b: the inputs; K2b: kernel R's
// rel_out as one (BH, n, kh+kw) buffer).
template <int D, bool kTables, bool kWindow = false>
__global__ void __launch_bounds__(kTcThreads, 2) attention_bwd_tc_dkv_kernel(
    const BwdArgs a, const float* __restrict__ rel_h, const float* __restrict__ rel_w) {
  static_assert(!(kTables && kWindow), "K8b's rel terms are inputs");
  constexpr int kRow = D + 4;
  constexpr int kK = D / 8;
  extern __shared__ float4 smem4[];
  float* QG = reinterpret_cast<float*>(smem4);  // [stage][Q | G][64][kRow]
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw, ka = kh + kw;
  float* RelS = QG + 4 * kTcTile * kRow;      // [stage][64 * ka], rel_view
  float* LD = RelS + 2 * kTcTile * ka;        // [stage][lse | delta][64]
  [[maybe_unused]] int* tok_s = reinterpret_cast<int*>(LD + 4 * kTcTile);  // kWindow: the slot map
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  long long img = blockIdx.z;
  int tokens = n;
  int nq_all = n;  // one past the last query row
  if constexpr (kWindow) {
    img = blockIdx.z / a.nwin;
    const int win = static_cast<int>(blockIdx.z - img * a.nwin);
    tokens = a.hg * a.wg;
    nq_all = window_queries(a, win);
    stage_slot_tokens(tok_s, a, win, gridDim.x * kTcTile);
    __syncthreads();
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int key0 = blockIdx.x * kTcTile;
  const long long stride = a.in_stride;
  const long long ostride = a.out_stride;
  const float* q_base = a.q + tok0 * stride + head * D;
  const float* k_base = a.k + tok0 * stride + head * D;
  const float* v_base = a.v + tok0 * stride + head * D;
  const float* g_base = a.g + tok0 * ostride + head * D;
  const RelView rv = rel_view<kTables>(kh, kw);
  const int ntiles = (nq_all + kTcTile - 1) / kTcTile;

  auto issue = [&](int tile) {
    const int st = tile & 1;
    const int q0 = tile * kTcTile;
    float* dst = QG + st * 2 * kTcTile * kRow;
    float* ld = LD + st * 2 * kTcTile;
    if constexpr (kWindow) {
      copy_slots_async<D>(dst, q_base, stride, tok_s, q0, nullptr);
      copy_slots_async<D>(dst + kTcTile * kRow, g_base, ostride, tok_s, q0, nullptr);
      copy_rel_slots_async(RelS + st * kTcTile * ka, rel_h, rel_w, bh * tokens, tok_s, kh, kw, q0);
      for (int i = t; i < kTcTile; i += kTcThreads) {
        const int tok = tok_s[q0 + i];
        if (tok >= 0) {
          cp_async4(ld + i, a.lse + bh * tokens + tok);
          cp_async4(ld + kTcTile + i, a.delta + bh * tokens + tok);
        } else {  // no query: p = exp(s + 0 - inf) = 0, ds = 0
          ld[i] = INFINITY;
          ld[kTcTile + i] = 0.f;
        }
      }
    } else {
      const int rows = min(kTcTile, n - q0);
      copy_rows_async<D>(dst, q_base, stride, q0, n);
      copy_rows_async<D>(dst + kTcTile * kRow, g_base, ostride, q0, n);
      copy_rel_async<kTables>(RelS + st * kTcTile * ka, rel_h, rel_w, bh, n, kh, kw, q0, rows);
      for (int i = t; i < rows; i += kTcThreads) {
        cp_async4(ld + i, a.lse + bh * n + q0 + i);
        cp_async4(ld + kTcTile + i, a.delta + bh * n + q0 + i);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // this warp's keys kr0 = key0 + 16 warp + g and kr0 + 8: k and v fragments
  // in registers (kWindow: a pad slot's from pad_kv), their key-grid row and
  // column
  const int kr0 = key0 + warp * 16 + g;
  const int kr1 = kr0 + 8;
  const bool active = key0 + warp * 16 < n;
  float ka_[kK][4], va_[kK][4];
  if constexpr (kWindow) {
    const int tk0 = tok_s[kr0], tk1 = tok_s[kr1];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = (e & 1) ? tk1 : tk0;
        const int c = 8 * kk + tq + ((e & 2) ? 4 : 0);
        const float* kp = tok >= 0 ? k_base + tok * stride : a.pad_kv + (heads + head) * D;
        const float* vp = tok >= 0 ? v_base + tok * stride : a.pad_kv + (2 * heads + head) * D;
        ka_[kk][e] = tok != kNoToken ? __ldg(kp + c) : 0.f;
        va_[kk][e] = tok != kNoToken ? __ldg(vp + c) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e & 1) ? kr1 : kr0;
        const int c = 8 * kk + tq + ((e & 2) ? 4 : 0);
        ka_[kk][e] = r < n ? __ldg(k_base + r * stride + c) : 0.f;
        va_[kk][e] = r < n ? __ldg(v_base + r * stride + c) : 0.f;
      }
    }
  }
  const int y0 = kr0 / kw, x0 = kr0 - (kr0 / kw) * kw;
  const int y1 = kr1 / kw, x1 = kr1 - (kr1 / kw) * kw;

  float dk[kK][4], dv[kK][4];
#pragma unroll
  for (int i = 0; i < kK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = tile & 1;
    const float* Qs = QG + st * 2 * kTcTile * kRow;
    const float* Gs = Qs + kTcTile * kRow;
    const float* R = RelS + st * kTcTile * ka;
    const float* lse_s = LD + st * 2 * kTcTile;
    const float* delta_s = lse_s + kTcTile;
    const int q0 = tile * kTcTile;
    const int nq = min(kTcTile, nq_all - q0);
    if (active) {
      // one sub-tile; kFull: all 32 rows present, no per-group branches
      auto sub_tile = [&](const int sub, const int nqs, auto full) {
        constexpr bool kFull = decltype(full)::value;
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        // S^T = K.Q^T, dP^T = V.G^T over this sub-tile's 8-query groups
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          FragA fk, fv;
          fk.set<true>(ka_[kk][0], ka_[kk][1], ka_[kk][2], ka_[kk][3]);
          fv.set<true>(va_[kk][0], va_[kk][1], va_[kk][2], va_[kk][3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kFull || 8 * j < nqs) {
              const int qr = (sub + 8 * j + g) * kRow + 8 * kk + tq;
              mma3(s[j], fk, Qs[qr], Qs[qr + 4]);
              mma3(dp[j], fv, Gs[qr], Gs[qr + 4]);
            }
          }
        }
        // p into s, ds into dp; queries past the last one and keys past n
        // give 0 (kWindow: pad queries too, through their lse of +inf)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 2;
            const int q = sub + 8 * j + 2 * tq + (e & 1);
            const bool ok = (hi ? kr1 : kr0) < n && q0 + q < nq_all;
            const float p = ok ? __expf(s[j][e] * a.scale +
                                        rv.bias(R, q, hi ? y1 : y0, hi ? x1 : x0) - lse_s[q])
                               : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - (ok ? delta_s[q] : 0.f));
          }
        }
        // dv += P^T.G, dk += dS^T.Q with the relabelled reduction index
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kFull || 8 * j < nqs) {
            FragA fp, fs;
            fp.set(s[j][0], s[j][2], s[j][1], s[j][3]);
            fs.set(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
            const int qr = (sub + 8 * j + 2 * tq) * kRow + g;
#pragma unroll
            for (int nd = 0; nd < kK; ++nd) {
              mma3(dv[nd], fp, Gs[qr + 8 * nd], Gs[qr + kRow + 8 * nd]);
              mma3(dk[nd], fs, Qs[qr + 8 * nd], Qs[qr + kRow + 8 * nd]);
            }
          }
        }
      };
#pragma unroll 1
      for (int sub = 0; sub < nq; sub += kTcSub) {
        const int nqs = min(kTcSub, nq - sub);
        if (nqs == kTcSub) {
          sub_tile(sub, nqs, std::true_type{});
        } else {
          sub_tile(sub, nqs, std::false_type{});
        }
      }
    }
    __syncthreads();
  }

  // the keys' rows (kWindow: slots with a token, at the token)
  int tk0 = kr0, tk1 = kr1;
  if constexpr (kWindow) {
    tk0 = tok_s[kr0];
    tk1 = tok_s[kr1];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tk1 : tk0;
    if (kWindow ? r < 0 : r >= n) continue;
    float* dkr = a.dk + (tok0 + r) * stride + head * D + 2 * tq;
    float* dvr = a.dv + (tok0 + r) * stride + head * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < kK; ++nd) {
      *reinterpret_cast<float2*>(dkr + 8 * nd) =
          make_float2(dk[nd][2 * half] * a.scale, dk[nd][2 * half + 1] * a.scale);
      *reinterpret_cast<float2*>(dvr + 8 * nd) =
          make_float2(dv[nd][2 * half], dv[nd][2 * half + 1]);
    }
  }
  if constexpr (kWindow) {
    // the pad keys' dk | dv summed into this (window, key tile)'s partial row:
    // over each warp's 16 keys by shuffles across the row groups, then the
    // four warps in order through shared memory (the streamed stages are
    // consumed); a tile without a pad key writes zeros
    const bool pad0 = tk0 == -1, pad1 = tk1 == -1;
    const long long hd = static_cast<long long>(heads) * D;
    float* part = a.dpad + (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * hd +
                  head * D;
    float* P = QG;  // [warp][dk | dv][D]
    if (__syncthreads_or(pad0 || pad1)) {
#pragma unroll
      for (int nd = 0; nd < kK; ++nd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sk = (pad0 ? dk[nd][e] : 0.f) + (pad1 ? dk[nd][2 + e] : 0.f);
          float sv = (pad0 ? dv[nd][e] : 0.f) + (pad1 ? dv[nd][2 + e] : 0.f);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sk += __shfl_xor_sync(0xffffffffu, sk, off);
            sv += __shfl_xor_sync(0xffffffffu, sv, off);
          }
          if (g == 0) {
            P[warp * 2 * D + 8 * nd + 2 * tq + e] = sk * a.scale;
            P[warp * 2 * D + D + 8 * nd + 2 * tq + e] = sv;
          }
        }
      }
      __syncthreads();
      for (int i = t; i < 2 * D; i += kTcThreads)
        part[i < D ? i : hd + i - D] = ((P[i] + P[2 * D + i]) + P[4 * D + i]) + P[6 * D + i];
    } else {
      for (int i = t; i < 2 * D; i += kTcThreads) part[i < D ? i : hd + i - D] = 0.f;
    }
  }
}

template <int D>
size_t tc_dq_smem_bytes(int ka) {
  return sizeof(float) *
         (4 * kTcTile * (D + 4) + kTcTile * ka + kTcTile * (ka + 1) + 4 * 16 * (kTcSub + 1));
}

template <int D>
size_t tc_dkv_smem_bytes(int ka) {
  return sizeof(float) * (4 * kTcTile * (D + 4) + 2 * kTcTile * ka + 4 * kTcTile);
}

// Passes A and B over `batch` images (kWindow: windows of all images);
// returns the first launch error.
template <int D, bool kTables, bool kWindow>
int launch_tc_bwd(const BwdArgs& a, int batch, cudaStream_t s) {
  const int ka = a.kh + a.kw;
  const dim3 grid((a.n + kTcTile - 1) / kTcTile, a.heads, batch);
  // kWindow: the slot -> token map of the window's grid.x * 64 slots
  const size_t slot_map = kWindow ? sizeof(int) * grid.x * kTcTile : 0;
  const size_t smem_a = tc_dq_smem_bytes<D>(ka) + slot_map;
  const size_t smem_b = tc_dkv_smem_bytes<D>(ka) + slot_map;
  auto ka_kernel = attention_bwd_tc_dq_kernel<D, kTables, kWindow>;
  auto kb_kernel = attention_bwd_tc_dkv_kernel<D, kTables, kWindow>;
  cudaError_t err = allow_smem(ka_kernel, smem_a);
  if (err == cudaSuccess) err = allow_smem(kb_kernel, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_kernel<<<grid, kTcThreads, smem_a, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* rel_h = kTables ? a.rel_out : a.rel_a;
  const float* rel_w = kTables ? a.rel_out : a.rel_b;
  kb_kernel<<<grid, kTcThreads, smem_b, s>>>(a, rel_h, rel_w);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the head dim (64: ViT-B and ViT-L; 80: ViT-H).
template <bool kTables, bool kWindow = false>
int dispatch_tc_bwd(const BwdArgs& a, int batch, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_tc_bwd<64, kTables, kWindow>(a, batch, s);
    case 80: return launch_tc_bwd<80, kTables, kWindow>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 instance: attention_bwd_bf16_{dq,dkv}_kernel<D, kTables,
// kWindow>, the float32 template's layouts on bfloat16 operands, the TPU
// kernels' fast path ("gradient matmuls in the input dtype",
// mia_tpu/ops/attention.py): K3b (kTables false) and K2b (kTables true,
// between kernel R's and kernel Q's bfloat16 instances in attention_rel.cu)
// on bfloat16 packed qkv, rel terms, out, g and dqkv; K6b on head-major
// strides (C entry beside K3b's, as for float32) — K3b and K6b only at head
// dim 80 or kh + kw > 64: at head dim 64 they run the warpgroup kernels of
// attention_bwd_wgmma.cuh; K8b (kWindow) on windows
// carved from the bfloat16 qkv grid by the slot map, dbias_kv from float32
// partials (attention_routes.cu). The two passes, blocks, warps, stages and
// sub-tiles of the float32 template above, with one bfloat16
// mma.sync.m16n8k16 (float32 accumulator) where 3xTF32 takes three m16n8k8,
// and the Pallas kernels' roundings:
//   - q * scale is rounded to bfloat16 with the scale rounded first, as in
//     the forward (attention_fwd_bf16_kernel): pass A keeps it as the A
//     fragments of S = (scale Q).K^T, pass B rounds the streamed Q tile in
//     shared memory once it lands, for S^T and for dk = dS^T.(scale Q)
//     (exact at head dim 64, whose scale is 1/8); so S needs no scale and
//     dk none either;
//   - p = exp(S + rel_h + rel_w - lse) in float32 from the forward's
//     log-sum-exp (the Pallas kernel normalises its own max and sum);
//     delta = rowsum(g * o) is a float32 sum of the bfloat16 g and o;
//   - P and dS = p (dP - delta) are rounded to bfloat16 where the Pallas
//     kernel rounds p_lo and ds_lo: packed two to a register straight from
//     the m16n8 accumulators (columns 2t, 2t+1 are the pair an A register
//     holds), they feed dv += P^T.G, dq += dS.K and dk += dS^T.(scale Q) as
//     A fragments, the FlashAttention-2 way; the B fragments of G, K and
//     scale Q, whose reduction axis (the token) runs down the rows of their
//     shared tiles, come from ldmatrix.trans, as V's in the forward;
//   - dq, dk and dv are float32 sums over all key (pass A) or query (pass
//     B) tiles, rounded once: dq = (dS.K) * scale to bfloat16 (K3b, K6b,
//     K8b) or, for K2b, to a float32 scratch that kernel Q adds the routed
//     rel cotangent to before its one rounding; drel_h / drel_w are float32
//     sums of the rounded dS over a key row / column, rounded to bfloat16;
//     K8b's pad keys' dk and dv, float32, are summed into one partial row
//     per (window, key tile), which the caller reduces in a fixed order and
//     rounds once.
// Tiles are bfloat16 in shared memory, rows padded to D + 8 elements (16
// bytes), so the 32-bit fragment reads of a row group and ldmatrix's row
// reads fall in distinct banks; the rel rows stay bfloat16 there too (4-byte
// asynchronous copies of element pairs where every run starts and ends on a
// pair, as at kh, kw even; plain loads otherwise; K8b's by the slot map,
// plain loads). K8b's window layout is the float32 kWindow instance's: pad
// queries have zero q and g rows, lse = +inf and delta = 0 in pass B, so p
// = 0 exactly. As in the float32 template, two launches are bit-identical.
//
// Bound: operations, 10 D flops a (query, key) pair at 989 TFLOP/s dense
// bfloat16 (the VJP's five products; the passes compute seven), or bytes
// (qkv, the rel terms, out and g read once, dqkv and the rel gradients
// written once) at 3.35 TB/s, whichever is larger (chip_smoke.py computes
// both).

struct Bf16BwdArgs {
  const bf16* q;        // first head's columns of token 0
  const bf16* k;
  const bf16* v;
  const bf16* rel_a;    // kTables false: rel_h; true: kernel R's terms (B*H, n, kh + kw)
  const bf16* rel_b;    // kTables false: rel_w; true: kernel R's terms again
  const bf16* pad_kv;   // kWindow: (3, heads*D) q, k, v rows of a pad slot
  const bf16* out;      // the forward's output
  const bf16* g;        // its cotangent
  const float* lse;     // the forward's log-sum-exp (B*H, tokens)
  bf16* dq;             // same strides as q, k, v (K2b: kernel Q writes dq)
  bf16* dk;
  bf16* dv;
  float* dq32;          // K2b: (batch, n, heads * D), dq before the routed rel cotangent
  float* delta;         // scratch (B*H, tokens): rowsum(g * o), pass A -> B
  bf16* drel_a;         // kTables false: drel_h; true: drel (B*H, n, kh + kw)
  bf16* drel_b;         // kTables false: drel_w
  float* dpad;          // kWindow: (windows * key tiles, 2, heads*D) pad-slot dk | dv partials
  long long in_stride;  // elements per token row of q, k, v, dq, dk, dv
  long long out_stride; // elements per token row of out and g (and K2b's dq32)
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw
  int hg, wg;           // kWindow: the token grid
  int nwx, nwin;        // kWindow: windows per grid row, windows per image
  float scale;
};

__device__ __forceinline__ uint32_t ld_bf16x2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rel_h[q, y] + rel_w[q, x] of rel rows kept in bfloat16 (laid out as RelView)
__device__ __forceinline__ float rel_bias_bf16(const RelView& rv, const bf16* R, int q, int y,
                                               int x) {
  return __bfloat162float(R[q * rv.hs + y]) + __bfloat162float(R[rv.woff + q * rv.ws + x]);
}

// count bfloat16 values from src to the shared dst: 4-byte asynchronous
// copies of pairs when both start on a pair and count is even, else plain
// loads (visible after the __syncthreads that follows the stage's wait)
__device__ __forceinline__ void copy_bf16_run(bf16* dst, const bf16* __restrict__ src, int count) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 3) == 0 &&
      (count & 1) == 0) {
    for (int i = threadIdx.x; i < count / 2; i += kTcThreads)
      cp_async4(reinterpret_cast<float*>(dst) + i, reinterpret_cast<const float*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < count; i += kTcThreads) dst[i] = src[i];
  }
}

// The rel rows of query rows q0 .. q0+rows-1 of (image, head) bh into R
// (bfloat16, laid out as rel_view<kTables>)
template <bool kTables>
__device__ __forceinline__ void copy_rel_bf16(bf16* R, const bf16* __restrict__ rel_a,
                                              const bf16* __restrict__ rel_b, long long bh, int n,
                                              int kh, int kw, int q0, int rows) {
  if constexpr (kTables) {
    copy_bf16_run(R, rel_a + (bh * n + q0) * (kh + kw), rows * (kh + kw));
  } else {
    copy_bf16_run(R, rel_a + (bh * n + q0) * kh, rows * kh);
    copy_bf16_run(R + kTcTile * kh, rel_b + (bh * n + q0) * kw, rows * kw);
  }
}

// The rel rows of slots q0 .. q0+63 into R (bfloat16, laid out as
// rel_view<false>) by the slot map: rows row_base + token of rel_h and rel_w
// for a slot with a token, zeros for any other slot; plain loads (visible
// after the __syncthreads that follows the stage's wait)
__device__ __forceinline__ void copy_rel_slots_bf16(bf16* R, const bf16* __restrict__ rel_h,
                                                    const bf16* __restrict__ rel_w,
                                                    long long row_base, const int* tok_s, int kh,
                                                    int kw, int q0) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kTcTile; r += kTcThreads / 32) {
    const int tok = tok_s[q0 + r];
    const long long row = row_base + tok;
    for (int j = lane; j < kh + kw; j += 32) {
      const bool h = j < kh;
      bf16* dst = h ? R + r * kh + j : R + kTcTile * kh + r * kw + (j - kh);
      *dst = tok >= 0 ? (h ? rel_h[row * kh + j] : rel_w[row * kw + (j - kh)])
                      : __float2bfloat16_rn(0.f);
    }
  }
}

// Pass A: dq, delta and the rel gradients of one 64-query tile.
template <int D, bool kTables, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 2) attention_bwd_bf16_dq_kernel(const Bf16BwdArgs a) {
  static_assert(!(kTables && kWindow), "K8b's rel terms are inputs");
  constexpr int kRow = D + 8;   // padded K/V row, bf16 elements
  constexpr int kK = D / 16;    // k16 steps of S and dP over the head dim
  constexpr int kN = D / 8;     // n8 tiles of dq
  constexpr int kSubRow = kTcSub + 1;
  constexpr int kStage = 2 * kTcTile * kRow;  // [K | V][64][kRow]
  extern __shared__ float4 smem4[];
  bf16* KV = reinterpret_cast<bf16*>(smem4);  // [stage][kStage]
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw, ka = kh + kw;
  float* DRel = reinterpret_cast<float*>(KV + 2 * kStage);  // [64][ka + 1]: drel_h | drel_w
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  float* Sw = DRel + kTcTile * (ka + 1) + warp * 16 * kSubRow;  // this warp's ds sub-tile
  bf16* Rel = reinterpret_cast<bf16*>(DRel + kTcTile * (ka + 1) + 4 * 16 * kSubRow);
  // kWindow: the window's slot -> token map, after the rel rows
  [[maybe_unused]] int* tok_s = reinterpret_cast<int*>(Rel + kTcTile * ka);
  const int head = blockIdx.y;
  long long img = blockIdx.z;  // batch element, or the image of this window
  int tokens = n;              // tokens per batch element / image
  if constexpr (kWindow) {
    img = blockIdx.z / a.nwin;
    const int win = static_cast<int>(blockIdx.z - img * a.nwin);
    // no slot of this tile is a query: nothing to compute or write
    if (static_cast<int>(blockIdx.x) * kTcTile >= window_queries(a, win)) return;
    tokens = a.hg * a.wg;
    stage_slot_tokens(tok_s, a, win, gridDim.x * kTcTile);
    __syncthreads();
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int row0 = blockIdx.x * kTcTile;
  const int rows = min(kTcTile, n - row0);
  const long long stride = a.in_stride;
  const long long ostride = a.out_stride;
  const bf16* q_base = a.q + tok0 * stride + head * D;
  const bf16* k_base = a.k + tok0 * stride + head * D;
  const bf16* v_base = a.v + tok0 * stride + head * D;
  const bf16* g_base = a.g + tok0 * ostride + head * D;
  const bf16* o_base = a.out + tok0 * ostride + head * D;
  const RelView rv = rel_view<kTables>(kh, kw);
  const int ntiles = (n + kTcTile - 1) / kTcTile;

  auto issue = [&](int tile) {
    bf16* st = KV + (tile & 1) * kStage;
    if constexpr (kWindow) {
      copy_slots_bf16_async<D>(st, k_base, stride, tok_s, tile * kTcTile,
                               a.pad_kv + (heads + head) * D);
      copy_slots_bf16_async<D>(st + kTcTile * kRow, v_base, stride, tok_s, tile * kTcTile,
                               a.pad_kv + (2 * heads + head) * D);
    } else {
      copy_rows_bf16_async<D, kTcTile>(st, k_base, stride, tile * kTcTile, n);
      copy_rows_bf16_async<D, kTcTile>(st + kTcTile * kRow, v_base, stride, tile * kTcTile, n);
    }
    cp_async_commit();
  };
  if constexpr (kWindow) {  // lands with tile 0
    copy_rel_slots_bf16(Rel, a.rel_a, a.rel_b, bh * tokens, tok_s, kh, kw, row0);
  } else {
    copy_rel_bf16<kTables>(Rel, a.rel_a, a.rel_b, bh, n, kh, kw, row0, rows);
  }
  issue(0);

  for (int i = t; i < kTcTile * (ka + 1); i += kTcThreads) DRel[i] = 0.f;

  // this warp's rows lr0 = 16 warp + g and lr0 + 8: (scale q) rounded to
  // bfloat16 and g as A fragments, lse, delta = rowsum(g * o). tr0, tr1:
  // their token rows, which are queries when below n (kWindow: when the
  // slot has a token)
  const int lr0 = warp * 16 + g;
  const int r0 = row0 + lr0;
  const int r1 = r0 + 8;
  int tr0 = r0, tr1 = r1;
  bool active = row0 + warp * 16 < n;
  if constexpr (kWindow) {
    tr0 = tok_s[r0];
    tr1 = tok_s[r1];
    active = __any_sync(0xffffffffu, tr0 >= 0 || tr1 >= 0);
  }
  auto query = [&](int tr) { return kWindow ? tr >= 0 : tr < n; };
  const float sc = round_bf16(a.scale);
  uint32_t qa[kK][4], ga[kK][4];
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? tr1 : tr0;
      const int c = 16 * kk + 2 * tq + ((e & 2) ? 8 : 0);
      uint32_t qv = 0u, gv = 0u, ov = 0u;
      if (query(r)) {
        qv = __ldg(reinterpret_cast<const unsigned*>(q_base + r * stride + c));
        gv = __ldg(reinterpret_cast<const unsigned*>(g_base + r * ostride + c));
        ov = __ldg(reinterpret_cast<const unsigned*>(o_base + r * ostride + c));
      }
      qa[kk][e] = pack_bf16x2(bf16_lo(qv) * sc, bf16_hi(qv) * sc);
      ga[kk][e] = gv;
      const float d2 = fmaf(bf16_lo(gv), bf16_lo(ov), bf16_hi(gv) * bf16_hi(ov));
      if (e & 1) {
        dl1 += d2;
      } else {
        dl0 += d2;
      }
    }
  }
  quad_sum(dl0, dl1);
  if (tq == 0) {
    if (query(tr0)) a.delta[bh * tokens + tr0] = dl0;
    if (query(tr1)) a.delta[bh * tokens + tr1] = dl1;
  }
  const float lse0 = query(tr0) ? __ldg(a.lse + bh * tokens + tr0) : 0.f;
  const float lse1 = query(tr1) ? __ldg(a.lse + bh * tokens + tr1) : 0.f;

  float dq[kN][4];
#pragma unroll
  for (int i = 0; i < kN; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile landed for every thread (the first with the rel rows)
    const bf16* Ks = KV + (tile & 1) * kStage;
    const bf16* Vs = Ks + kTcTile * kRow;
    const int k0 = tile * kTcTile;
    const int nk = min(kTcTile, n - k0);
    if (active) {
      // one sub-tile of 32 keys; kFull: all 32 present, no per-group branches
      auto sub_tile = [&](const int sub, const int nks, auto full) {
        constexpr bool kFull = decltype(full)::value;
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        // S = (scale Q).K^T, dP = G.V^T over this sub-tile's 8-key groups
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kFull || 8 * j < nks) {
              const int off = (sub + 8 * j + g) * kRow + 16 * kk + 2 * tq;
              mma_bf16(s[j], qa[kk], ld_bf16x2(Ks + off), ld_bf16x2(Ks + off + 8));
              mma_bf16(dp[j], ga[kk], ld_bf16x2(Vs + off), ld_bf16x2(Vs + off + 8));
            }
          }
        }
        // ds = p (dp - delta) rounded to bfloat16, p from the lse; keys past n
        // and rows that are no query give 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kb = k0 + sub + 8 * j + 2 * tq;
          const int yb = kb / kw;
          const int xb = kb - yb * kw;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + (e & 1);
            int y = yb, x = xb + (e & 1);
            if (x == kw) {
              x = 0;
              ++y;
            }
            const bool hi = e & 2;
            const bool ok = key < n && query(hi ? tr1 : tr0);
            const int lr = hi ? lr0 + 8 : lr0;
            const float p =
                ok ? __expf(s[j][e] + rel_bias_bf16(rv, Rel, lr, y, x) - (hi ? lse1 : lse0)) : 0.f;
            s[j][e] = round_bf16(p * (dp[j][e] - (hi ? dl1 : dl0)));
          }
        }
        // drel: float32 sums of the rounded ds
        add_drel<kFull>(s, DRel, Sw, kh, kw, k0 + sub, nks, warp, lane, query(tr0), query(tr1),
                        row0 + warp * 16 + (lane & 15) < n);
        // dq += dS.K: key groups 2jj, 2jj + 1 are the k16 step jj of the A
        // fragment; K's B fragments by ldmatrix.trans, two n8 tiles a load
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (kFull || 16 * jj < nks) {
            const uint32_t af[4] = {pack_bf16x2(s[2 * jj][0], s[2 * jj][1]),
                                    pack_bf16x2(s[2 * jj][2], s[2 * jj][3]),
                                    pack_bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                    pack_bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
            const bf16* krow =
                Ks + (sub + 16 * jj + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRow + (lane >> 4) * 8;
#pragma unroll
            for (int nd = 0; nd < kN; nd += 2) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, krow + 8 * nd);
              mma_bf16(dq[nd], af, b[0], b[1]);
              mma_bf16(dq[nd + 1], af, b[2], b[3]);
            }
          }
        }
      };
#pragma unroll 1
      for (int sub = 0; sub < nk; sub += kTcSub) {
        const int nks = min(kTcSub, nk - sub);
        if (nks == kTcSub) {
          sub_tile(sub, nks, std::true_type{});
        } else {
          sub_tile(sub, nks, std::false_type{});
        }
      }
    }
    __syncthreads();  // stage consumed before the next tile but one is copied into it
  }

  // dq = scale * dS.K: bfloat16 into dq (K3b, K6b, K8b: at the token row),
  // float32 into the scratch (K2b)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tr1 : tr0;
    if (!query(r)) continue;
    if constexpr (kTables) {
      float* dst = a.dq32 + (tok0 + r) * ostride + head * D + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < kN; ++nd)
        *reinterpret_cast<float2*>(dst + 8 * nd) =
            make_float2(dq[nd][2 * half] * a.scale, dq[nd][2 * half + 1] * a.scale);
    } else {
      bf16* dst = a.dq + (tok0 + r) * stride + head * D + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < kN; ++nd)
        *reinterpret_cast<uint32_t*>(dst + 8 * nd) =
            pack_bf16x2(dq[nd][2 * half] * a.scale, dq[nd][2 * half + 1] * a.scale);
    }
  }
  __syncthreads();  // DRel complete for the block-wide stores
  if constexpr (kWindow) {  // one warp a row with a token, one lane a column
    for (int r = warp; r < rows; r += kTcThreads / 32) {
      const int tok = tok_s[row0 + r];
      if (tok < 0) continue;
      const long long row = bh * tokens + tok;
      for (int j = lane; j < ka; j += 32) {
        const bf16 v = __float2bfloat16_rn(DRel[r * (ka + 1) + j]);
        if (j < kh) {
          a.drel_a[row * kh + j] = v;
        } else {
          a.drel_b[row * kw + j - kh] = v;
        }
      }
    }
  } else if constexpr (kTables) {
    for (int i = t; i < rows * ka; i += kTcThreads)
      a.drel_a[(bh * n + row0) * ka + i] = __float2bfloat16_rn(DRel[(i / ka) * (ka + 1) + i % ka]);
  } else {
    for (int i = t; i < rows * kh; i += kTcThreads)
      a.drel_a[(bh * n + row0) * kh + i] = __float2bfloat16_rn(DRel[(i / kh) * (ka + 1) + i % kh]);
    for (int i = t; i < rows * kw; i += kTcThreads)
      a.drel_b[(bh * n + row0) * kw + i] =
          __float2bfloat16_rn(DRel[(i / kw) * (ka + 1) + kh + i % kw]);
  }
}

// Pass B: dk and dv of one 64-key tile, streaming the query tiles.
template <int D, bool kTables, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 2) attention_bwd_bf16_dkv_kernel(const Bf16BwdArgs a) {
  static_assert(!(kTables && kWindow), "K8b's rel terms are inputs");
  constexpr int kRow = D + 8;
  constexpr int kK = D / 16;
  constexpr int kN = D / 8;
  constexpr int kStage = 2 * kTcTile * kRow;  // [Q | G][64][kRow]
  extern __shared__ float4 smem4[];
  bf16* QG = reinterpret_cast<bf16*>(smem4);                // [stage][kStage]
  float* LD = reinterpret_cast<float*>(QG + 2 * kStage);    // [stage][lse | delta][64]
  bf16* RelS = reinterpret_cast<bf16*>(LD + 4 * kTcTile);   // [stage][64 * ka], rel_view
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw, ka = kh + kw;
  // kWindow: the window's slot -> token map, after the rel rows
  [[maybe_unused]] int* tok_s = reinterpret_cast<int*>(RelS + 2 * kTcTile * ka);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  long long img = blockIdx.z;
  int tokens = n;
  int nq_all = n;  // one past the last query row
  if constexpr (kWindow) {
    img = blockIdx.z / a.nwin;
    const int win = static_cast<int>(blockIdx.z - img * a.nwin);
    tokens = a.hg * a.wg;
    nq_all = window_queries(a, win);
    stage_slot_tokens(tok_s, a, win, gridDim.x * kTcTile);
    __syncthreads();
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int key0 = blockIdx.x * kTcTile;
  const long long stride = a.in_stride;
  const long long ostride = a.out_stride;
  const bf16* q_base = a.q + tok0 * stride + head * D;
  const bf16* k_base = a.k + tok0 * stride + head * D;
  const bf16* v_base = a.v + tok0 * stride + head * D;
  const bf16* g_base = a.g + tok0 * ostride + head * D;
  const RelView rv = rel_view<kTables>(kh, kw);
  const int ntiles = (nq_all + kTcTile - 1) / kTcTile;
  const float sc = round_bf16(a.scale);

  auto issue = [&](int tile) {
    const int st = tile & 1;
    const int q0 = tile * kTcTile;
    bf16* dst = QG + st * kStage;
    float* ld = LD + st * 2 * kTcTile;
    bf16* rel = RelS + st * kTcTile * ka;
    if constexpr (kWindow) {
      copy_slots_bf16_async<D>(dst, q_base, stride, tok_s, q0, nullptr);
      copy_slots_bf16_async<D>(dst + kTcTile * kRow, g_base, ostride, tok_s, q0, nullptr);
      copy_rel_slots_bf16(rel, a.rel_a, a.rel_b, bh * tokens, tok_s, kh, kw, q0);
      for (int i = t; i < kTcTile; i += kTcThreads) {
        const int tok = tok_s[q0 + i];
        if (tok >= 0) {
          cp_async4(ld + i, a.lse + bh * tokens + tok);
          cp_async4(ld + kTcTile + i, a.delta + bh * tokens + tok);
        } else {  // no query: p = exp(s + 0 - inf) = 0, ds = 0
          ld[i] = INFINITY;
          ld[kTcTile + i] = 0.f;
        }
      }
    } else {
      const int rows = min(kTcTile, n - q0);
      copy_rows_bf16_async<D, kTcTile>(dst, q_base, stride, q0, n);
      copy_rows_bf16_async<D, kTcTile>(dst + kTcTile * kRow, g_base, ostride, q0, n);
      copy_rel_bf16<kTables>(rel, a.rel_a, a.rel_b, bh, n, kh, kw, q0, rows);
      for (int i = t; i < rows; i += kTcThreads) {
        cp_async4(ld + i, a.lse + bh * n + q0 + i);
        cp_async4(ld + kTcTile + i, a.delta + bh * n + q0 + i);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // this warp's keys kr0 = key0 + 16 warp + g and kr1 = kr0 + 8: k and v as
  // A fragments (kWindow: a pad slot's from pad_kv), their key-grid row and
  // column
  const int kr0 = key0 + warp * 16 + g;
  const int kr1 = kr0 + 8;
  const bool active = key0 + warp * 16 < n;
  uint32_t ka_[kK][4], va_[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? kr1 : kr0;
      const int c = 16 * kk + 2 * tq + ((e & 2) ? 8 : 0);
      const bf16* kp = k_base + r * stride;
      const bf16* vp = v_base + r * stride;
      bool ok = r < n;
      if constexpr (kWindow) {
        const int tok = tok_s[r];
        kp = tok >= 0 ? k_base + tok * stride : a.pad_kv + (heads + head) * D;
        vp = tok >= 0 ? v_base + tok * stride : a.pad_kv + (2 * heads + head) * D;
        ok = tok != kNoToken;
      }
      ka_[kk][e] = ok ? __ldg(reinterpret_cast<const unsigned*>(kp + c)) : 0u;
      va_[kk][e] = ok ? __ldg(reinterpret_cast<const unsigned*>(vp + c)) : 0u;
    }
  }
  const int y0 = kr0 / kw, x0 = kr0 - (kr0 / kw) * kw;
  const int y1 = kr1 / kw, x1 = kr1 - (kr1 / kw) * kw;

  float dk[kN][4], dv[kN][4];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = tile & 1;
    bf16* Qs = QG + st * kStage;
    const bf16* Gs = Qs + kTcTile * kRow;
    const bf16* R = RelS + st * kTcTile * ka;
    const float* lse_s = LD + st * 2 * kTcTile;
    const float* delta_s = lse_s + kTcTile;
    // the landed Q tile as (scale q) rounded to bfloat16, in place (zero rows stay zero)
    for (int i = t; i < kTcTile * (D / 2); i += kTcThreads) {
      const int r = i / (D / 2);
      uint32_t* p = reinterpret_cast<uint32_t*>(Qs + r * kRow) + (i - r * (D / 2));
      const uint32_t u = *p;
      *p = pack_bf16x2(bf16_lo(u) * sc, bf16_hi(u) * sc);
    }
    __syncthreads();
    const int q0 = tile * kTcTile;
    const int nq = min(kTcTile, nq_all - q0);
    if (active) {
      auto sub_tile = [&](const int sub, const int nqs, auto full) {
        constexpr bool kFull = decltype(full)::value;
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        // S^T = K.(scale Q)^T, dP^T = V.G^T over this sub-tile's 8-query groups
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kFull || 8 * j < nqs) {
              const int off = (sub + 8 * j + g) * kRow + 16 * kk + 2 * tq;
              mma_bf16(s[j], ka_[kk], ld_bf16x2(Qs + off), ld_bf16x2(Qs + off + 8));
              mma_bf16(dp[j], va_[kk], ld_bf16x2(Gs + off), ld_bf16x2(Gs + off + 8));
            }
          }
        }
        // p into s (float32), ds into dp rounded to bfloat16; queries past
        // the last one and keys past n give 0 (kWindow: pad queries too,
        // through their lse of +inf)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 2;
            const int q = sub + 8 * j + 2 * tq + (e & 1);
            const bool ok = (hi ? kr1 : kr0) < n && q0 + q < nq_all;
            const float p =
                ok ? __expf(s[j][e] + rel_bias_bf16(rv, R, q, hi ? y1 : y0, hi ? x1 : x0) -
                            lse_s[q])
                   : 0.f;
            s[j][e] = p;
            dp[j][e] = round_bf16(p * (dp[j][e] - (ok ? delta_s[q] : 0.f)));
          }
        }
        // dv += P^T.G, dk += dS^T.(scale Q): query groups 2jj, 2jj + 1 are the
        // k16 step jj; G's and Q's B fragments by ldmatrix.trans
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (kFull || 16 * jj < nqs) {
            const uint32_t pf[4] = {pack_bf16x2(s[2 * jj][0], s[2 * jj][1]),
                                    pack_bf16x2(s[2 * jj][2], s[2 * jj][3]),
                                    pack_bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                    pack_bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
            const uint32_t sf[4] = {pack_bf16x2(dp[2 * jj][0], dp[2 * jj][1]),
                                    pack_bf16x2(dp[2 * jj][2], dp[2 * jj][3]),
                                    pack_bf16x2(dp[2 * jj + 1][0], dp[2 * jj + 1][1]),
                                    pack_bf16x2(dp[2 * jj + 1][2], dp[2 * jj + 1][3])};
            const int roff =
                (sub + 16 * jj + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRow + (lane >> 4) * 8;
#pragma unroll
            for (int nd = 0; nd < kN; nd += 2) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, Gs + roff + 8 * nd);
              mma_bf16(dv[nd], pf, b[0], b[1]);
              mma_bf16(dv[nd + 1], pf, b[2], b[3]);
              ldmatrix_x4_trans(b, Qs + roff + 8 * nd);
              mma_bf16(dk[nd], sf, b[0], b[1]);
              mma_bf16(dk[nd + 1], sf, b[2], b[3]);
            }
          }
        }
      };
#pragma unroll 1
      for (int sub = 0; sub < nq; sub += kTcSub) {
        const int nqs = min(kTcSub, nq - sub);
        if (nqs == kTcSub) {
          sub_tile(sub, nqs, std::true_type{});
        } else {
          sub_tile(sub, nqs, std::false_type{});
        }
      }
    }
    __syncthreads();
  }

  // dk, dv of the warp's keys (kWindow: slots with a token, at the token),
  // rounded once to bfloat16
  int tk0 = kr0, tk1 = kr1;
  if constexpr (kWindow) {
    tk0 = tok_s[kr0];
    tk1 = tok_s[kr1];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tk1 : tk0;
    if (kWindow ? r < 0 : r >= n) continue;
    bf16* dkr = a.dk + (tok0 + r) * stride + head * D + 2 * tq;
    bf16* dvr = a.dv + (tok0 + r) * stride + head * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < kN; ++nd) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * nd) =
          pack_bf16x2(dk[nd][2 * half], dk[nd][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * nd) =
          pack_bf16x2(dv[nd][2 * half], dv[nd][2 * half + 1]);
    }
  }
  if constexpr (kWindow) {
    // the pad keys' float32 dk | dv summed into this (window, key tile)'s
    // partial row: over each warp's 16 keys by shuffles across the row
    // groups, then the four warps in order through shared memory (the
    // streamed stages are consumed); a tile without a pad key writes zeros
    const bool pad0 = tk0 == -1, pad1 = tk1 == -1;
    const long long hd = static_cast<long long>(heads) * D;
    float* part = a.dpad + (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * hd +
                  head * D;
    float* P = reinterpret_cast<float*>(QG);  // [warp][dk | dv][D]
    if (__syncthreads_or(pad0 || pad1)) {
#pragma unroll
      for (int nd = 0; nd < kN; ++nd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sk = (pad0 ? dk[nd][e] : 0.f) + (pad1 ? dk[nd][2 + e] : 0.f);
          float sv = (pad0 ? dv[nd][e] : 0.f) + (pad1 ? dv[nd][2 + e] : 0.f);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sk += __shfl_xor_sync(0xffffffffu, sk, off);
            sv += __shfl_xor_sync(0xffffffffu, sv, off);
          }
          if (g == 0) {
            P[warp * 2 * D + 8 * nd + 2 * tq + e] = sk;
            P[warp * 2 * D + D + 8 * nd + 2 * tq + e] = sv;
          }
        }
      }
      __syncthreads();
      for (int i = t; i < 2 * D; i += kTcThreads)
        part[i < D ? i : hd + i - D] = ((P[i] + P[2 * D + i]) + P[4 * D + i]) + P[6 * D + i];
    } else {
      for (int i = t; i < 2 * D; i += kTcThreads) part[i < D ? i : hd + i - D] = 0.f;
    }
  }
}

// Passes A and B of the bfloat16 instance over `batch` images (kWindow:
// windows of all images); returns the first launch error.
template <int D, bool kTables, bool kWindow>
int launch_bwd_bf16(const Bf16BwdArgs& a, int batch, cudaStream_t s) {
  const int ka = a.kh + a.kw;
  const dim3 grid((a.n + kTcTile - 1) / kTcTile, a.heads, batch);
  // kWindow: the slot -> token map of the window's grid.x * 64 slots
  const size_t slot_map = kWindow ? sizeof(int) * grid.x * kTcTile : 0;
  const size_t tiles = sizeof(bf16) * 4 * kTcTile * (D + 8);  // two stages of two tiles
  const size_t smem_a = tiles + sizeof(float) * (kTcTile * (ka + 1) + 4 * 16 * (kTcSub + 1)) +
                        sizeof(bf16) * kTcTile * ka + slot_map;
  const size_t smem_b =
      tiles + sizeof(float) * 4 * kTcTile + sizeof(bf16) * 2 * kTcTile * ka + slot_map;
  auto ka_kernel = attention_bwd_bf16_dq_kernel<D, kTables, kWindow>;
  auto kb_kernel = attention_bwd_bf16_dkv_kernel<D, kTables, kWindow>;
  cudaError_t err = allow_smem(ka_kernel, smem_a);
  if (err == cudaSuccess) err = allow_smem(kb_kernel, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_kernel<<<grid, kTcThreads, smem_a, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_kernel<<<grid, kTcThreads, smem_b, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the head dim (64: ViT-B and ViT-L; 80: ViT-H).
template <bool kTables, bool kWindow = false>
int dispatch_bwd_bf16(const Bf16BwdArgs& a, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 64: return launch_bwd_bf16<64, kTables, kWindow>(a, batch, s);
    case 80: return launch_bwd_bf16<80, kTables, kWindow>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
