// The SIMT backward attention template of the port, in float32:
// FlashAttention-2 style from the forward's per-row log-sum-exp, beside the
// forward template in attention_fwd.cuh. attention_routes.cu instantiates it
// once, for K8b (windows carved from the unpartitioned token grid). K2b, K3b
// (packed qkv) and K6b (head-major) run the tensor-core template of
// attention_bwd_tc.cuh, which also takes BwdArgs from here.
//
// Replaces the TPU backward kernel of mia_tpu/ops/attention.py
//   K8b  _rel_win_bwd         (_attn_rel_win_bwd_kernel)
// which holds every key of a query block at once and recomputes the whole
// softmax row. Here the forward's log-sum-exp gives the probabilities directly,
// p = exp(s - lse), and the work splits in two passes that write disjoint
// outputs, so there are no atomics and the result is deterministic:
//
//   kernel A, one block per 32-query tile: delta = rowsum(g * o),
//     ds = p (dp - delta) with dp = g . v, dq = scale * ds . k, and the rel
//     gradients drel_h[n, j] = sum_{k / kw == j} ds[n, k] (drel_w likewise
//     over k % kw). A also stores delta for kernel B.
//   kernel B, one block per 32-key tile: loops over the query tiles for
//     dk = scale * ds^T . q and dv = p^T . g.
//
// Operands are token-major with runtime strides, as in the forward: row
// `tok` of q lies at q + tok * in_stride + h * D (likewise k, v, dq, dk, dv),
// row `tok` of out and g at + tok * out_stride + h * D; K8b passes the
// column blocks of one qkv (and one dqkv) grid.
//
// Layout kGrid (K8b): the block's n = ws*ws rows are the slots of one window
// of a (B, hg, wg) token grid, mapped to tokens by slot_token as in the
// forward. A window is seven 32-row tiles, so dq, dk, dv and drel of a real
// token are complete within its window and are written at the token's place
// in the grid layout. Pad slots are real keys (k and v from pad_kv, the
// query's rel bias for the slot position); pad queries are never computed
// and get no gradient. The dk and dv of the pad slots belong to pad_kv:
// kernel B sums them over the pad keys of its tile with warp shuffles and
// writes one partial row per (window, key tile), and the caller reduces the
// partials in a fixed order.
//
// Tiles of q, g, k, v live in shared memory with rows padded by 4 floats
// (float4 reads of 8 lanes at once fall in different banks); the 32 x 32
// score tile is recomputed in both passes and never leaves the block, so no
// (N, N) tensor exists.
//
// Bound: operations. Each (query, key) pair costs ~7 x D FMAs over the two
// passes, all on the FP32 pipe and the shared-memory load slots; moving K8b
// onto the tensor-core template of attention_bwd_tc.cuh is later work.

#pragma once

#include "attention_fwd.cuh"

namespace {

struct BwdArgs {
  const float* q;       // first head's columns of token 0
  const float* k;
  const float* v;
  const float* rel_a;   // kRelTerms: rel_h; kRelTables: rh_flat (q_h*kh, D)
  const float* rel_b;   // kRelTerms: rel_w; kRelTables: rw_flat (kw*kw, D)
  const float* pad_kv;  // kGrid: (3, heads*D) q, k, v rows of a pad slot
  const float* out;     // the forward's output
  const float* g;       // its cotangent
  const float* lse;     // the forward's log-sum-exp (B*H, tokens)
  float* dq;            // same strides as q, k, v
  float* dk;
  float* dv;
  float* delta;         // scratch (B*H, tokens): rowsum(g * o), kernel A -> B
  float* rel_out;       // kRelTables (K2b): scratch (B*H, n, kh+kw), kernel R's rel terms
  float* drel_a;        // kRelTerms: drel_h; kRelTables: drel (B*H, n, kh+kw) or null
  float* drel_b;        // kRelTerms: drel_w
  float* dpad;          // kGrid: (windows * key tiles, 2, heads*D) pad-slot dk | dv partials
  long long in_stride;  // floats per token row of q, k, v, dq, dk, dv
  long long out_stride; // floats per token row of out and g
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw
  int hg, wg;           // kGrid: the token grid
  int nwx, nwin;        // kGrid: windows per grid row, windows per image
  float scale;
};

constexpr int kBT = 32;             // query rows (A) or key rows (B) per tile
constexpr int kBwdThreads = 128;    // 4 warps: warp w scores rows w*8 .. w*8+7
constexpr int kRowsPerWarp = kBT / (kBwdThreads / 32);
constexpr int kTS = kBT + 1;        // score tile row stride

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

// Rows (slots) slot0 .. slot0+31 of one operand into a padded shared tile.
// `base` is the head's columns of the image's token 0. A slot past n, or a
// pad slot when pad_row is null, becomes zeros; a pad slot otherwise pad_row.
template <int D, bool kWindow>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ base,
                                          long long stride, int slot0, const BwdArgs& a, int win,
                                          const float* __restrict__ pad_row) {
  for (int i = threadIdx.x; i < kBT * (D / 4); i += kBwdThreads) {
    const int r = i / (D / 4);
    const int c = i - r * (D / 4);
    const int slot = slot0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (slot < a.n) {
      const int tok = slot_token<kWindow>(a, slot, win);
      if (tok >= 0) {
        v = __ldg(reinterpret_cast<const float4*>(base + tok * stride) + c);
      } else if (pad_row != nullptr) {
        v = __ldg(reinterpret_cast<const float4*>(pad_row) + c);
      }
    }
    reinterpret_cast<float4*>(dst + r * (D + 4))[c] = v;
  }
}

// The score tile of one thread: key `kk` (its lane) against rows warp*8 ..
// warp*8+7: s = q . k (unscaled) and dp = g . v.
template <int D>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Gs, const float* Ks,
                                           const float* Vs, int kk, int warp,
                                           float (&s)[kRowsPerWarp],
                                           float (&dp)[kRowsPerWarp]) {
  constexpr int kRow = D + 4;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(Ks + kk * kRow);
  const float4* v4 = reinterpret_cast<const float4*>(Vs + kk * kRow);
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    const float4 kv = k4[c];
    const float4 vv = v4[c];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      s[i] += dot4(reinterpret_cast<const float4*>(Qs + r * kRow)[c], kv);
      dp[i] += dot4(reinterpret_cast<const float4*>(Gs + r * kRow)[c], vv);
    }
  }
}

// Rel rows of the query tile at slot0 into shared memory (row stride rs):
// columns [0, kh) from rel_h (row stride sh), [kh, kh+kw) from rel_w (row
// stride sw); row_base is the first rel row of this (image, head). Rows of
// pad slots and slots past n are left alone (their scores are never used).
template <bool kWindow>
__device__ __forceinline__ void load_rel(float* Rel, int rs, const float* __restrict__ rel_h,
                                         int sh, const float* __restrict__ rel_w, int sw,
                                         long long row_base, int slot0, const BwdArgs& a,
                                         int win) {
  const int kh = a.kh, kw = a.kw;
  for (int i = threadIdx.x; i < kBT * kh; i += kBwdThreads) {
    const int r = i / kh;
    const int j = i - r * kh;
    const int tok = slot0 + r < a.n ? slot_token<kWindow>(a, slot0 + r, win) : -1;
    if (tok >= 0) Rel[r * rs + j] = __ldg(rel_h + (row_base + tok) * sh + j);
  }
  for (int i = threadIdx.x; i < kBT * kw; i += kBwdThreads) {
    const int r = i / kw;
    const int j = i - r * kw;
    const int tok = slot0 + r < a.n ? slot_token<kWindow>(a, slot0 + r, win) : -1;
    if (tok >= 0) Rel[r * rs + kh + j] = __ldg(rel_w + (row_base + tok) * sw + j);
  }
}

// Kernel A: dq, delta and the rel-term gradients. (kBias and kLayout name
// the instance in a trace: K8b is <D, kRelTerms, kGrid>.)
template <int D, int kBias, int kLayout>
__global__ void __launch_bounds__(kBwdThreads) attention_bwd_dq_kernel(const BwdArgs a) {
  constexpr bool kWindow = kLayout == kGrid;
  static_assert(kBias == kRelTerms, "the rel terms are inputs");
  constexpr int kRow = D + 4;
  constexpr int kDQ = D / 4;  // dq columns per thread (a quarter of the head)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBT * kRow;
  float* Ks = Gs + kBT * kRow;
  float* Vs = Ks + kBT * kRow;
  float* Ss = Vs + kBT * kRow;  // kBT x kTS: ds
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw;
  const int rs = kh + kw + 1;
  float* Rel = Ss + kBT * kTS;   // kBT x rs
  float* DRel = Rel + kBT * rs;  // kBT x rs
  float* lse_s = DRel + kBT * rs;
  float* delta_s = lse_s + kBT;
  int* tok_s = reinterpret_cast<int*>(delta_s + kBT);  // the row's token, -1: not a query

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int head = blockIdx.y;
  long long img = blockIdx.z;  // batch element, or the image of this window
  int win = 0;
  int tokens = n;              // tokens per batch element / image
  if constexpr (kWindow) {
    img = blockIdx.z / a.nwin;
    win = blockIdx.z - static_cast<int>(img) * a.nwin;
    tokens = a.hg * a.wg;
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int row0 = blockIdx.x * kBT;
  const int rows = min(kBT, n - row0);
  const long long stride = a.in_stride;
  const long long ostride = a.out_stride;
  const float* q_base = a.q + tok0 * stride + head * D;
  const float* k_base = a.k + tok0 * stride + head * D;
  const float* v_base = a.v + tok0 * stride + head * D;
  const float* g_base = a.g + tok0 * ostride + head * D;
  const float* o_base = a.out + tok0 * ostride + head * D;
  const float* pad_k = kWindow ? a.pad_kv + (heads + head) * D : nullptr;
  const float* pad_v = kWindow ? a.pad_kv + (2 * heads + head) * D : nullptr;

  load_rows<D, kWindow>(Qs, q_base, stride, row0, a, win, nullptr);
  load_rows<D, kWindow>(Gs, g_base, ostride, row0, a, win, nullptr);
  for (int i = t; i < kBT * rs; i += kBwdThreads) DRel[i] = 0.f;
  load_rel<kWindow>(Rel, rs, a.rel_a, kh, a.rel_b, kw, bh * tokens, row0, a, win);
  __syncthreads();

  // delta = rowsum(g * o), one warp per row
  for (int r = warp; r < kBT; r += kBwdThreads / 32) {
    const int tok = r < rows ? slot_token<kWindow>(a, row0 + r, win) : -1;
    float acc = 0.f;
    if (tok >= 0) {
      const float* o = o_base + tok * ostride;
      for (int c = lane; c < D; c += 32) acc += Gs[r * kRow + c] * __ldg(o + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = tok >= 0 ? __ldg(a.lse + bh * tokens + tok) : 0.f;
      tok_s[r] = tok;
      if (tok >= 0) a.delta[bh * tokens + tok] = acc;
    }
  }

  float dq[kDQ];
#pragma unroll
  for (int i = 0; i < kDQ; ++i) dq[i] = 0.f;
  const int qd0 = warp * kDQ;  // this thread's dq columns: row `lane`, [qd0, qd0 + kDQ)

  for (int k0 = 0; k0 < n; k0 += kBT) {
    const int nk = min(kBT, n - k0);
    __syncthreads();  // previous tile consumed (first pass: Rel, delta, tok_s written)
    load_rows<D, kWindow>(Ks, k_base, stride, k0, a, win, pad_k);
    load_rows<D, kWindow>(Vs, v_base, stride, k0, a, win, pad_v);
    __syncthreads();

    const int kk = lane;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_tile<D>(Qs, Gs, Ks, Vs, kk, warp, s, dp);
    const int yk = (k0 + kk) / kw;
    const int xk = (k0 + kk) - yk * kw;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const bool query = kWindow ? tok_s[r] >= 0 : r < rows;
      float ds = 0.f;
      if (kk < nk && query) {
        const float p = expf(s[i] * a.scale + Rel[r * rs + yk] + Rel[r * rs + kh + xk] - lse_s[r]);
        ds = p * (dp[i] - delta_s[r]);
      }
      Ss[r * kTS + kk] = ds;
    }
    __syncthreads();

    // dq[row lane] += ds[lane, k] * k_k over this tile
    for (int k = 0; k < nk; ++k) {
      const float w = Ss[lane * kTS + k];
      const float4* k4 = reinterpret_cast<const float4*>(Ks + k * kRow + qd0);
#pragma unroll
      for (int c = 0; c < kDQ / 4; ++c) {
        const float4 kv = k4[c];
        dq[4 * c + 0] = fmaf(w, kv.x, dq[4 * c + 0]);
        dq[4 * c + 1] = fmaf(w, kv.y, dq[4 * c + 1]);
        dq[4 * c + 2] = fmaf(w, kv.z, dq[4 * c + 2]);
        dq[4 * c + 3] = fmaf(w, kv.w, dq[4 * c + 3]);
      }
    }
    // drel: warp 0 sums the h terms, warp 1 the w terms, one row per lane
    if (warp < 2) {
      float* dr = DRel + lane * rs + (warp == 0 ? 0 : kh);
      int y = k0 / kw;
      int x = k0 - y * kw;
      for (int k = 0; k < nk; ++k) {
        dr[warp == 0 ? y : x] += Ss[lane * kTS + k];
        if (++x == kw) {
          x = 0;
          ++y;
        }
      }
    }
  }
  __syncthreads();  // DRel complete

  const int my_tok = tok_s[lane];
  if (my_tok >= 0) {
#pragma unroll
    for (int i = 0; i < kDQ; ++i) dq[i] *= a.scale;
    float4* dst = reinterpret_cast<float4*>(a.dq + (tok0 + my_tok) * stride + head * D + qd0);
#pragma unroll
    for (int c = 0; c < kDQ / 4; ++c)
      dst[c] = make_float4(dq[4 * c + 0], dq[4 * c + 1], dq[4 * c + 2], dq[4 * c + 3]);
  }
  // the rel gradients of the tile
  for (int i = t; i < kBT * kh; i += kBwdThreads) {
    const int r = i / kh;
    const int j = i - r * kh;
    if (tok_s[r] >= 0) a.drel_a[(bh * tokens + tok_s[r]) * kh + j] = DRel[r * rs + j];
  }
  for (int i = t; i < kBT * kw; i += kBwdThreads) {
    const int r = i / kw;
    const int j = i - r * kw;
    if (tok_s[r] >= 0) a.drel_b[(bh * tokens + tok_s[r]) * kw + j] = DRel[r * rs + kh + j];
  }
}

// Kernel B: dk and dv of one 32-key tile, looping over all query tiles.
template <int D, int kLayout>
__global__ void __launch_bounds__(kBwdThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  constexpr bool kWindow = kLayout == kGrid;
  constexpr int kRow = D + 4;
  constexpr int kDK = D / 4;  // dk and dv columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBT * kRow;
  float* Ks = Gs + kBT * kRow;
  float* Vs = Ks + kBT * kRow;
  float* Ss = Vs + kBT * kRow;  // ds
  float* Ps = Ss + kBT * kTS;   // p
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw;
  const int rs = kh + kw + 1;
  float* Rel = Ps + kBT * kTS;
  float* lse_s = Rel + kBT * rs;
  float* delta_s = lse_s + kBT;
  int* tok_s = reinterpret_cast<int*>(delta_s + kBT);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int head = blockIdx.y;
  long long img = blockIdx.z;
  int win = 0;
  int tokens = n;
  if constexpr (kWindow) {
    img = blockIdx.z / a.nwin;
    win = blockIdx.z - static_cast<int>(img) * a.nwin;
    tokens = a.hg * a.wg;
  }
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int key0 = blockIdx.x * kBT;
  const int nkeys = min(kBT, n - key0);
  const long long stride = a.in_stride;
  const long long ostride = a.out_stride;
  const float* q_base = a.q + tok0 * stride + head * D;
  const float* k_base = a.k + tok0 * stride + head * D;
  const float* v_base = a.v + tok0 * stride + head * D;
  const float* g_base = a.g + tok0 * ostride + head * D;
  const float* pad_k = kWindow ? a.pad_kv + (heads + head) * D : nullptr;
  const float* pad_v = kWindow ? a.pad_kv + (2 * heads + head) * D : nullptr;

  load_rows<D, kWindow>(Ks, k_base, stride, key0, a, win, pad_k);
  load_rows<D, kWindow>(Vs, v_base, stride, key0, a, win, pad_v);

  const int kk = lane;
  const int yk = (key0 + kk) / kw;
  const int xk = (key0 + kk) - yk * kw;
  const int d0 = warp * kDK;  // this thread's dk/dv columns: key `lane`, [d0, d0 + kDK)
  float dk[kDK], dv[kDK];
#pragma unroll
  for (int i = 0; i < kDK; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kBT) {
    const int rows = min(kBT, n - q0);
    __syncthreads();  // previous query tile consumed
    load_rows<D, kWindow>(Qs, q_base, stride, q0, a, win, nullptr);
    load_rows<D, kWindow>(Gs, g_base, ostride, q0, a, win, nullptr);
    load_rel<kWindow>(Rel, rs, a.rel_a, kh, a.rel_b, kw, bh * tokens, q0, a, win);
    for (int i = t; i < kBT; i += kBwdThreads) {
      const int tok = i < rows ? slot_token<kWindow>(a, q0 + i, win) : -1;
      tok_s[i] = tok;
      lse_s[i] = tok >= 0 ? __ldg(a.lse + bh * tokens + tok) : 0.f;
      delta_s[i] = tok >= 0 ? __ldg(a.delta + bh * tokens + tok) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_tile<D>(Qs, Gs, Ks, Vs, kk, warp, s, dp);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const bool query = kWindow ? tok_s[r] >= 0 : r < rows;
      float p = 0.f, ds = 0.f;
      if (kk < nkeys && query) {
        p = expf(s[i] * a.scale + Rel[r * rs + yk] + Rel[r * rs + kh + xk] - lse_s[r]);
        ds = p * (dp[i] - delta_s[r]);
      }
      Ps[r * kTS + kk] = p;
      Ss[r * kTS + kk] = ds;
    }
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      const float ws_ = Ss[r * kTS + kk];
      const float wp = Ps[r * kTS + kk];
      const float4* q4 = reinterpret_cast<const float4*>(Qs + r * kRow + d0);
      const float4* g4 = reinterpret_cast<const float4*>(Gs + r * kRow + d0);
#pragma unroll
      for (int c = 0; c < kDK / 4; ++c) {
        const float4 qv = q4[c];
        const float4 gv = g4[c];
        dk[4 * c + 0] = fmaf(ws_, qv.x, dk[4 * c + 0]);
        dk[4 * c + 1] = fmaf(ws_, qv.y, dk[4 * c + 1]);
        dk[4 * c + 2] = fmaf(ws_, qv.z, dk[4 * c + 2]);
        dk[4 * c + 3] = fmaf(ws_, qv.w, dk[4 * c + 3]);
        dv[4 * c + 0] = fmaf(wp, gv.x, dv[4 * c + 0]);
        dv[4 * c + 1] = fmaf(wp, gv.y, dv[4 * c + 1]);
        dv[4 * c + 2] = fmaf(wp, gv.z, dv[4 * c + 2]);
        dv[4 * c + 3] = fmaf(wp, gv.w, dv[4 * c + 3]);
      }
    }
  }

  const int key_tok = kk < nkeys ? slot_token<kWindow>(a, key0 + kk, win) : -1;
  if (key_tok >= 0) {
    float4* dk4 = reinterpret_cast<float4*>(a.dk + (tok0 + key_tok) * stride + head * D + d0);
    float4* dv4 = reinterpret_cast<float4*>(a.dv + (tok0 + key_tok) * stride + head * D + d0);
#pragma unroll
    for (int c = 0; c < kDK / 4; ++c) {
      dk4[c] = make_float4(dk[4 * c + 0] * a.scale, dk[4 * c + 1] * a.scale,
                           dk[4 * c + 2] * a.scale, dk[4 * c + 3] * a.scale);
      dv4[c] = make_float4(dv[4 * c + 0], dv[4 * c + 1], dv[4 * c + 2], dv[4 * c + 3]);
    }
  }
  if constexpr (kWindow) {
    // the pad slots' dk and dv of this tile, summed over its keys (the warp's
    // lanes; every warp holds other columns) in the fixed order of the shuffles
    const bool pad = kk < nkeys && key_tok < 0;
    const bool any_pad = __any_sync(0xffffffffu, pad);
    const long long hd = static_cast<long long>(heads) * D;
    float* part = a.dpad + (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * hd +
                  head * D + d0;
#pragma unroll
    for (int i = 0; i < kDK; ++i) {
      float sk = pad ? dk[i] * a.scale : 0.f;
      float sv = pad ? dv[i] : 0.f;
      if (any_pad) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sk += __shfl_xor_sync(0xffffffffu, sk, off);
          sv += __shfl_xor_sync(0xffffffffu, sv, off);
        }
      }
      if (lane == 0) {
        part[i] = sk;
        part[hd + i] = sv;
      }
    }
  }
}

template <int D>
size_t bwd_smem_bytes(int kh, int kw) {
  const int rs = kh + kw + 1;
  return sizeof(float) * (4 * kBT * (D + 4) + 2 * kBT * kTS + 2 * kBT * rs + 3 * kBT);
}

// Kernels A and B over blocks_z batch elements (or, kGrid, windows of all
// images); returns the first launch error.
template <int D, int kBias, int kLayout>
int launch_bwd_passes(const BwdArgs& a, int blocks_z, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<D>(a.kh, a.kw);
  const dim3 grid((a.n + kBT - 1) / kBT, a.heads, blocks_z);
  auto ka = attention_bwd_dq_kernel<D, kBias, kLayout>;
  auto kb = attention_bwd_dkv_kernel<D, kLayout>;
  cudaError_t err = allow_smem(ka, smem);
  if (err == cudaSuccess) err = allow_smem(kb, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka<<<grid, kBwdThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<grid, kBwdThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the head dim (64: ViT-B and ViT-L; 80: ViT-H).
template <int kBias, int kLayout>
int dispatch_bwd_passes(const BwdArgs& a, int blocks_z, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_bwd_passes<64, kBias, kLayout>(a, blocks_z, s);
    case 80: return launch_bwd_passes<80, kBias, kLayout>(a, blocks_z, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
