// The tensor-core forward attention template of the port: FlashAttention-2
// style, both products in 3xTF32 on Hopper's tensor cores (the helpers of
// tf32_mma.cuh), on token-major operands with runtime strides (FwdArgs
// below). The bias kind (BiasKind) is a template parameter:
//   kRelTables  K2 (attention_rel.cu): kernel R of attention_rel.cu first
//               computes the rel terms from the two gathered tables into
//               one (B*H, n, kh + kw) buffer; packed qkv;
//   kRelTerms   K3 (attention_rel.cu): the rel terms rel_h (B*H, n, kh),
//               rel_w (B*H, n, kw) are inputs; packed qkv. K6 (C entry in
//               attention_rel.cu beside K3's, so the instance is built once)
//               runs it on head-major operands (head_major_args: heads = 1,
//               strides D, every (batch, head) pair a batch element; any
//               n = kh * kw);
//   kDense      K7 (attention_routes.cu): a dense (B*H, n, n) additive bias
//               on head-major operands;
//   kRelWindow  K8 (attention_routes.cu): kRelTerms' bias on windows carved
//               from the unpartitioned (B, hg, wg, 3*H*D) qkv grid (the
//               window layout of attention_window.cuh), rel terms in grid
//               layout (B*H, hg, wg, ws).
// The backward counterpart is attention_bwd_tc.cuh.
//
// Replaces the TPU forward kernels of mia_tpu/ops/attention.py
//   K3  fused_attention_rel_packed     (_attn_rel_packed_kernel)
//   K2  fused_attention_rel_packed_ik  (_attn_rel_packed_ik_kernel)
//   K6  fused_attention_rel            (_attn_rel_kernel)
//   K7  fused_attention                (_attn_kernel)
//   K8  fused_attention_rel_win        (_attn_rel_win_kernel)
// K2, K3 and K6 fold the rel terms into one MXU product of [q*s | rel_h |
// rel_w] against [k | E_h | E_w] over key blocks padded to 128 rows; K7 pads
// N to 128 and masks the pad keys with -1e30; K8 walks window-row bands of
// the grid and concatenates the carved tiles. Per (batch element or window b,
// head h, query n), with q, k, v the rows of b at head h:
//
//   out[b, n, h*D:(h+1)*D] = softmax_k(q_n.k_k * scale + bias[n, k]) . v
//   bias[n, k]             = rel_h[n, k / kw] + rel_w[n, k % kw]   (K2, K3, K8)
//                          = bias[b, n, k]                          (K7)
//   lse[b*H + h, n]        = the row's log-sum-exp (when lse is not null;
//                            K8: by token, (B*H, hg*wg))
//
// Design: one block of 4 warps per (64-query tile, head, b); each warp owns
// 16 query rows, whose Q fragments (times scale) stay in registers as
// float32 for the whole key loop and are split into TF32 big + small at
// each use. K and V stream in tiles of kKeys rows by
// cp.async into two stages (the next tile lands while this one is
// computed); rows past n are zero-filled by the copy and score -inf. A
// tile's scores S = Q.K^T are m16n8k8 accumulators (kKeys / 8 of them a
// warp); the bias is added, then the online softmax of rows g and g + 8
// (tile maxima by quad shuffles). K2's and K3's rel rows are staged once in
// shared memory and each score adds two of them. K7's bias is the kernel's
// largest stream (4 bytes a (query, key) pair: 50 MB against 12.6 MB of q,
// k, v and out at 12 x 1024 tokens), so its (64 queries x kKeys keys) tile
// is a third part of each cp.async stage, beside K and V, and lands with
// them: every bias element is read from device memory once, while the
// previous tile's MMAs run. Its rows are padded to kKeys + 8 floats, so the
// float2 reads of a warp (rows g, columns 2tq, 2tq + 1) fall in 32 banks
// per half-warp; 16-byte copies when n % 4 == 0, else 4-byte ones. A dense
// bias may hold -inf (the reference masks padded keys with it): while a
// row's running maximum is -inf, the update rescales by 0 and subtracts 0
// (FlashAttention-2's guard), so a row whose first key tiles are all masked
// gets no NaN and matches the plain softmax once a finite key arrives; a
// row with no finite key is 0 / 0, as in the plain softmax. The factored
// rel bias is finite, so K2 and K3 go without the guard.
// P = exp(S - m) is formed in float32 in the same registers and
// is the A operand of the tile's P.V with the reduction index relabelled
// (k = t <-> key 2t, k = t + 4 <-> key 2t + 1), as pass A of the backward
// does for dS.K. P.V starts from zero in every tile and is folded into the
// output as O = c O + P.V, one rounded fmaf (c the rescale to the new
// maximum): the tensor core truncates each sum into its accumulator, and an
// accumulator carried through the MMAs of all 16 tiles of a 1024-key row
// lands ~1e-5 of max |out| off (measured on the card, and reproduced by
// the round-toward-zero emulation of tests/test_torch_attention_3xtf32.py),
// where one tile's chain keeps ~1e-6. The epilogue writes O / l and
// m + log l. A warp whose 16 rows are all past n computes nothing; 8-key
// groups past n are skipped. Window pad tokens are real keys, as in the
// reference (see attention_rel.cu). No atomics: two launches are
// bit-identical.
//
// Layout kRelWindow (K8): blockIdx.z is a window of an image (batch * nwin
// of them) and the block's n = ws * ws rows are its slots. The block stages
// the window's slot -> token map in shared memory once
// (attention_window.cuh), then copies by it: K and V rows of a slot with a
// token from the token's row of qkv, of a pad slot from the pad_kv rows
// (heads + h) D and (2 heads + h) D (a pad slot is a real key), of a slot
// past n zeros (it scores -inf, as in every instance); each query slot's
// rel rows from row bh * hg * wg + token of the grid layout, zeros for a
// pad slot. Q fragments are loaded by token (zero for a pad query), out and
// lse are written by token at stride H*D, nothing for a pad query. A
// window's queries lie in its first window_queries slots, so a block whose
// query tile lies past them exits and a warp whose 16 rows lie past them
// computes nothing; pad queries inside that prefix (a right-edge window's
// rows hold 4 real columns of 14 on a 32 x 32 grid) are computed and
// dropped by the epilogue. No partitioned copy of qkv exists anywhere.
//
// mma.sync rather than wgmma: Q stays in registers for the whole pass and
// P is reused from the S accumulator; TF32 wgmma would want P in shared
// memory (K-major) and both operands there.
//
// Bound: 2 x 2 x D flops per (query, key) pair at 495/3 TFLOP/s (the
// card's dense TF32 rate, three MMAs a product). K2 and K3 are bound by
// operations: a K/V tile is 2 kKeys (D + 4) floats for 256 kKeys D flops of
// MMAs. K7 adds 4 bytes of bias a pair (64 flops a byte at D = 64, against
// the card's ~49 at 165 TFLOP/s over 3.35 TB/s) besides q, k, v and out:
// about even at 12 x 1024 tokens (19.5 us of MMAs, 18.8 us of bytes), bound
// by bytes at 108 windows of 196 tokens (11.4 us against 6.4 us of MMAs),
// which is why the bias copy has to overlap the MMAs. K8 computes only its
// real queries' rows against the ws * ws slots of their window, and with
// qkv, the rel terms, pad_kv and out read or written once it is bound by
// bytes at B=1 (13.97 MB: 4.17 us against 3.74 us of MMAs).
//
// The bfloat16 instance (attention_fwd_bf16_kernel below: every bias kind
// and layout of this template, for a bfloat16 encoder) is described before
// it.
//
// The kernels allocate nothing and do not synchronise; the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#pragma once

#include <math.h>

#include <type_traits>

#include "attention_window.cuh"
#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBiasPad = 8;  // floats of padding a row of K7's staged bias tile

// One chunk of a rel term's float32 dot. Kernel R (attention_rel.cu) and the
// warpgroup K2 (attention_fwd_wgmma.cuh) sum every term as 16 of these in
// turn: on bfloat16 values the products are exact in float32, so any
// contraction gives the same bits, and their terms agree bit for bit.
__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

// The bias of the template and its layout (see the header).
enum BiasKind { kRelTables = 0, kRelTerms = 1, kDense = 2, kRelWindow = 3 };

struct FwdArgs {
  const float* q;       // first head's columns of token 0
  const float* k;
  const float* v;
  const float* rel_a;   // see BiasKind
  const float* rel_b;
  const float* pad_kv;  // kRelWindow: (3, heads*D) q, k, v rows of a pad slot
  float* out;
  float* lse;           // optional per-row log-sum-exp (B*H, n); kRelWindow: (B*H, hg*wg) by token
  long long in_stride;  // floats per token row of q, k, v
  long long out_stride; // floats per token row of out
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw (unused by kDense)
  int hg, wg;           // kRelWindow: the token grid
  int nwx, nwin;        // kRelWindow: windows per grid row, windows per image
  float scale;
};

// Head-major operands (K6, K7): q, k, v, out (bh, n, d), bh batch elements of
// one head each.
inline FwdArgs head_major_args(const void* q, const void* k, const void* v, void* out, int n,
                               int d, float scale) {
  FwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.in_stride = d;
  a.out_stride = d;
  a.n = n;
  a.heads = 1;
  a.scale = scale;
  return a;
}

// One tile of K7's dense bias: rows row0 .. row0+63 and keys key0 ..
// key0+kKeys-1 of (image, head) bh into a [64][kBRow] tile (rows of kKeys +
// kBiasPad floats unless said); entries past n are zero-filled (they are
// masked, never read as a bias). vec4: 16-byte copies, which need n % 4 ==
// 0 (every run of 4 keys then lies inside one row and starts 16-byte
// aligned).
template <int kKeys, int kBRow = kKeys + kBiasPad>
__device__ __forceinline__ void copy_bias_async(float* dst, const float* __restrict__ bias,
                                                long long bh, int n, int row0, int key0,
                                                bool vec4) {
  const float* src = bias + (bh * n + row0) * n + key0;
  if (vec4) {
    constexpr int kC = kKeys / 4;
    for (int i = threadIdx.x; i < kTcTile * kC; i += kTcThreads) {
      const int r = i / kC;
      const int c = i - r * kC;
      const bool valid = row0 + r < n && key0 + 4 * c < n;
      cp_async16(dst + r * kBRow + 4 * c, valid ? src + static_cast<long long>(r) * n + 4 * c : bias,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < kTcTile * kKeys; i += kTcThreads) {
      const int r = i / kKeys;
      const int c = i - r * kKeys;
      const bool valid = row0 + r < n && key0 + c < n;
      cp_async4(dst + r * kBRow + c, valid ? src + static_cast<long long>(r) * n + c : bias, valid);
    }
  }
}

// a0, a1 reduced over the four threads of a fragment row group
__device__ __forceinline__ void quad_max(float& a0, float& a1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, off));
    a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, off));
  }
}

__device__ __forceinline__ void quad_sum(float& a0, float& a1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
  }
}

// The score step both forward kernels share: + rel_h[row, y] + rel_w[row,
// x] on this thread's scores s of keys k0 + 8j + 2tq (+1) in block rows lr0
// and lr0 + 8; keys past n score -inf (kFull: every key of the tile is
// present); the rows' maxima over the quad into mx0, mx1.
template <int kJ, bool kFull>
__device__ __forceinline__ void add_rel_bias_max(float (&s)[kJ][4], const RelView& rv,
                                                 const float* Rel, int lr0, int k0, int tq, int n,
                                                 int kw, float& mx0, float& mx1) {
  int y = (k0 + 2 * tq) / kw;
  int x = k0 + 2 * tq - y * kw;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    int y1 = y, x1 = x + 1;  // the odd key's place
    if (x1 == kw) {
      x1 = 0;
      ++y1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      const bool hi = e & 2;
      const int key = k0 + 8 * j + 2 * tq + (odd ? 1 : 0);
      const float v = (kFull || key < n)
                          ? s[j][e] + rv.bias(Rel, hi ? lr0 + 8 : lr0, odd ? y1 : y, odd ? x1 : x)
                          : -INFINITY;
      s[j][e] = v;
      if (hi) {
        mx1 = fmaxf(mx1, v);
      } else {
        mx0 = fmaxf(mx0, v);
      }
    }
    x += 8;
    while (x >= kw) {
      x -= kw;
      ++y;
    }
  }
  quad_max(mx0, mx1);
}

// A block of kTcThreads (4 warps of 16 query rows) per 64-query tile;
// kKeys 64: 2 blocks an SM (~205 registers; 86 KB of shared memory at K3's
// head dim 64, 104 KB with K7's bias tiles); kKeys 32: 3 (168 registers,
// 51 KB; K7 53 KB). K7 at head dim 80 with 64-key tiles takes 120 KB: one
// block an SM. K8 adds its window's slot map (1 KB at ws 14).
template <int D, int kBias, int kKeys>
__global__ void __launch_bounds__(kTcThreads, kKeys == 32 ? 3 : 2)
    attention_fwd_tc_kernel(const FwdArgs a) {
  constexpr bool kTables = kBias == kRelTables;
  constexpr bool kDenseBias = kBias == kDense;
  constexpr bool kWindow = kBias == kRelWindow;
  constexpr int kRow = D + 4;    // padded K/V row
  constexpr int kK = D / 8;      // k-steps of S = Q.K^T, n8 tiles of O
  constexpr int kJ = kKeys / 8;  // 8-key groups of a streamed tile
  constexpr int kBRow = kKeys + kBiasPad;
  // a stage: [K | V][kKeys][kRow], then (K7) the bias tile [64][kBRow]
  constexpr int kStage = 2 * kKeys * kRow + (kDenseBias ? kTcTile * kBRow : 0);
  extern __shared__ float4 smem4[];
  float* KV = reinterpret_cast<float*>(smem4);  // [stage][kStage]
  float* Rel = KV + 2 * kStage;                 // K2, K3, K8: the block's rel rows, rel_view
  const int n = a.n, kw = a.kw;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // thread in group
  const int head = blockIdx.y;
  long long img = blockIdx.z;  // batch element, or (K8) the image of this window
  int tokens = n;              // tokens per batch element / image
  int queries = n;             // K8: the window's query slots are 0 .. queries-1
  int* tok_s = nullptr;        // K8: the window's slot -> token map, after the rel rows
  if constexpr (kWindow) {
    tok_s = reinterpret_cast<int*>(Rel + kTcTile * (a.kh + kw));
    img = blockIdx.z / a.nwin;
    const int win = static_cast<int>(blockIdx.z - img * a.nwin);
    queries = window_queries(a, win);
    // no slot of this tile is a query: nothing to compute or write
    if (static_cast<int>(blockIdx.x) * kTcTile >= queries) return;
    tokens = a.hg * a.wg;
    stage_slot_tokens(tok_s, a, win, gridDim.x * kTcTile);
    __syncthreads();
  }
  const long long tok0 = img * tokens;
  const long long bh = img * a.heads + head;
  const int row0 = blockIdx.x * kTcTile;
  const long long stride = a.in_stride;
  const float* q_base = a.q + tok0 * stride + head * D;
  const float* k_base = a.k + tok0 * stride + head * D;
  const float* v_base = a.v + tok0 * stride + head * D;
  const RelView rv = rel_view<kTables>(a.kh, kw);
  const int ntiles = (n + kKeys - 1) / kKeys;
  const bool bias_vec4 = (n & 3) == 0;

  auto issue = [&](int tile) {
    float* st = KV + (tile & 1) * kStage;
    if constexpr (kWindow) {  // by the slot map; a pad slot's k and v from pad_kv
      copy_slots_async<D, kKeys>(st, k_base, stride, tok_s, tile * kKeys,
                                 a.pad_kv + (a.heads + head) * D);
      copy_slots_async<D, kKeys>(st + kKeys * kRow, v_base, stride, tok_s, tile * kKeys,
                                 a.pad_kv + (2 * a.heads + head) * D);
    } else {
      copy_rows_async<D, kKeys>(st, k_base, stride, tile * kKeys, n);
      copy_rows_async<D, kKeys>(st + kKeys * kRow, v_base, stride, tile * kKeys, n);
    }
    if constexpr (kDenseBias)
      copy_bias_async<kKeys>(st + 2 * kKeys * kRow, a.rel_a, bh, n, row0, tile * kKeys, bias_vec4);
    cp_async_commit();
  };
  if constexpr (kWindow) {  // rows bh * tokens + token of the grid layout; lands with tile 0
    copy_rel_slots_async(Rel, a.rel_a, a.rel_b, bh * tokens, tok_s, a.kh, kw, row0);
  } else if constexpr (!kDenseBias) {
    copy_rel_async<kTables>(Rel, a.rel_a, a.rel_b, bh, n, a.kh, kw, row0,
                            min(kTcTile, n - row0));  // lands with tile 0
  }
  issue(0);

  // this warp's rows r0 = row0 + 16 warp + g and r0 + 8: scale * q fragments.
  // tr0, tr1: their token rows, which are queries when below n (K8: when the
  // slot has a token)
  const int lr0 = warp * 16 + g;
  const int r0 = row0 + lr0;
  const int r1 = r0 + 8;
  const bool active = row0 + warp * 16 < queries;
  int tr0 = r0, tr1 = r1;
  if constexpr (kWindow) {
    tr0 = tok_s[r0];
    tr1 = tok_s[r1];
  }
  float qa[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? tr1 : tr0;
      const int c = 8 * kk + tq + ((e & 2) ? 4 : 0);
      qa[kk][e] = (kWindow ? r >= 0 : r < n) ? __ldg(q_base + r * stride + c) * a.scale : 0.f;
    }
  }

  float o[kK][4];
#pragma unroll
  for (int i = 0; i < kK; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile landed for every thread (the first with the rel rows)
    const float* Ks = KV + (tile & 1) * kStage;
    const float* Vs = Ks + kKeys * kRow;
    const float* Bs = Vs + kKeys * kRow;  // K7: this tile's bias
    const int k0 = tile * kKeys;
    const int nk = min(kKeys, n - k0);
    // one tile; kFull: all kKeys keys present, no per-group branches
    auto step = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      float s[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = (scale Q).K^T over the tile's 8-key groups
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        FragA fq;
        fq.set<true>(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (kFull || 8 * j < nk) {
            const int kr = (8 * j + g) * kRow + 8 * kk + tq;
            mma3(s[j], fq, Ks[kr], Ks[kr + 4]);
          }
        }
      }
      // + the bias of key k0 + 8j + 2tq (+1); keys past n score -inf; the
      // tile's row maxima
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if constexpr (kDenseBias) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const float2 b0 = *reinterpret_cast<const float2*>(Bs + lr0 * kBRow + 8 * j + 2 * tq);
          const float2 b1 =
              *reinterpret_cast<const float2*>(Bs + (lr0 + 8) * kBRow + 8 * j + 2 * tq);
          const int key = k0 + 8 * j + 2 * tq;
          const bool in0 = kFull || key < n;
          const bool in1 = kFull || key + 1 < n;
          s[j][0] = in0 ? s[j][0] + b0.x : -INFINITY;
          s[j][1] = in1 ? s[j][1] + b0.y : -INFINITY;
          s[j][2] = in0 ? s[j][2] + b1.x : -INFINITY;
          s[j][3] = in1 ? s[j][3] + b1.y : -INFINITY;
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        quad_max(mx0, mx1);
      } else {
        add_rel_bias_max<kJ, kFull>(s, rv, Rel, lr0, k0, tq, n, kw, mx0, mx1);
      }
      // online softmax: the new maxima, the rescale of what came before
      // (0 while m = -inf); K7: the reference point 0 while the new maximum
      // is still -inf, so that exp(-inf - -inf) is never formed
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float ms0 = kDenseBias && mn0 == -INFINITY ? 0.f : mn0;
      const float ms1 = kDenseBias && mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = __expf(m0 - ms0);
      const float c1 = __expf(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float p0 = __expf(s[j][0] - ms0), p1 = __expf(s[j][1] - ms0);
        const float p2 = __expf(s[j][2] - ms1), p3 = __expf(s[j][3] - ms1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        s[j][0] = p0;
        s[j][1] = p1;
        s[j][2] = p2;
        s[j][3] = p3;
      }
      // P.V of this tile: the accumulator of key group j is the A operand,
      // its reduction index relabelled (k = tq <-> key 2tq, k = tq+4 <-> key
      // 2tq+1). It starts from zero, and O = c O + P.V is one rounded fmaf:
      // the tensor core truncates each sum into its accumulator, so a chain
      // of MMAs across every tile would lose float32 accuracy.
      float ot[kK][4];
#pragma unroll
      for (int nd = 0; nd < kK; ++nd) ot[nd][0] = ot[nd][1] = ot[nd][2] = ot[nd][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (kFull || 8 * j < nk) {
          FragA fp;
          fp.set(s[j][0], s[j][2], s[j][1], s[j][3]);
          const float* vr = Vs + (8 * j + 2 * tq) * kRow + g;
#pragma unroll
          for (int nd = 0; nd < kK; ++nd) mma3(ot[nd], fp, vr[8 * nd], vr[kRow + 8 * nd]);
        }
      }
#pragma unroll
      for (int nd = 0; nd < kK; ++nd) {
        o[nd][0] = fmaf(o[nd][0], c0, ot[nd][0]);
        o[nd][1] = fmaf(o[nd][1], c0, ot[nd][1]);
        o[nd][2] = fmaf(o[nd][2], c1, ot[nd][2]);
        o[nd][3] = fmaf(o[nd][3], c1, ot[nd][3]);
      }
    };
    if (active) {
      if (nk == kKeys) {
        step(std::true_type{});
      } else {
        step(std::false_type{});
      }
    }
    __syncthreads();  // stage consumed before the next tile but one is copied into it
  }

  // the rows' sums over the quad; out = O / l, lse = m + log l
  quad_sum(l0, l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tr1 : tr0;
    if (kWindow ? r < 0 : r >= n) continue;
    const float l = half ? l1 : l0;
    const float inv = 1.f / l;
    float* dst = a.out + (tok0 + r) * a.out_stride + head * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < kK; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd) =
          make_float2(o[nd][2 * half] * inv, o[nd][2 * half + 1] * inv);
    if (a.lse != nullptr && tq == 0) a.lse[bh * tokens + r] = (half ? m1 : m0) + logf(l);
  }
}

// Two stages of K, V (and K7's bias tile), then K2's, K3's and K8's rel
// rows, then K8's slot map (a slot for each row of the window's query tiles).
template <int D, int kBias, int kKeys>
size_t fwd_tc_smem_bytes(const FwdArgs& a) {
  if constexpr (kBias == kDense)
    return sizeof(float) * 2 * (2 * kKeys * (D + 4) + kTcTile * (kKeys + kBiasPad));
  const size_t slot_map =
      kBias == kRelWindow ? sizeof(int) * ((a.n + kTcTile - 1) / kTcTile) * kTcTile : 0;
  return sizeof(float) * (4 * kKeys * (D + 4) + kTcTile * (a.kh + a.kw)) + slot_map;
}

// One launch over `batch` images (K8: windows of all images), kKeys keys a
// streamed tile.
template <int D, int kBias, int kKeys>
int launch_fwd_tc_tiles(const FwdArgs& a, int batch, cudaStream_t s) {
  const size_t smem = fwd_tc_smem_bytes<D, kBias, kKeys>(a);
  auto kernel = attention_fwd_tc_kernel<D, kBias, kKeys>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + kTcTile - 1) / kTcTile, a.heads, batch);
  kernel<<<grid, kTcThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 32-key tiles where the grid gives every SM three blocks (they fit three
// an SM and hide each other's latency); below that, 64-key tiles, half the
// syncs and softmax passes a key. On an H100 80GB HBM3 at 700 W: K2 at
// batch 12 (1296 windows x heads) 534 us against 690 with 64-key tiles, K3
// at B=1 (192 blocks) 113 us against 123 with 32-key ones.
template <int D, int kBias>
int launch_fwd_tc(const FwdArgs& a, int batch, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((a.n + kTcTile - 1) / kTcTile) * a.heads * batch;
  if (blocks >= 3LL * sms) return launch_fwd_tc_tiles<D, kBias, 32>(a, batch, s);
  return launch_fwd_tc_tiles<D, kBias, 64>(a, batch, s);
}

// Dispatch on the head dim (64: ViT-B and ViT-L; 80: ViT-H).
template <int kBias>
int dispatch_fwd_tc(const FwdArgs& a, int batch, int d, void* stream) {
  if (batch == 0 || a.n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_fwd_tc<64, kBias>(a, batch, s);
    case 80: return launch_fwd_tc<80, kBias>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 instance: attention_fwd_bf16_kernel<D, kBias, kKeys>, the
// float32 template's bias kinds and layouts (BiasKind above) on bfloat16
// operands, the TPU kernels' fast path ("dots in the input dtype, float32
// accumulation", mia_tpu/ops/attention.py): K2 (kRelTables, after the
// bfloat16 instance of kernel R) and K3 (kRelTerms) on packed qkv, K6
// (kRelTerms on head-major strides), K7 (kDense: bfloat16 q, k, v and the
// float32 (B*H, n, n) bias the JAX encoder hands its kernel) and K8
// (kRelWindow: windows carved from the bfloat16 qkv grid by the slot map of
// attention_window.cuh, pad slots from the bfloat16 pad_kv rows, lse by
// token). K3 and K6 at head dim 64 with kh + kw <= 64, K2 at head dim 64 on
// windows of at most 200 tokens, K7 at head dim 64 with n % 4 == 0 and K8 at
// head dim 64 on windows of at most 200 slots run the warpgroup kernels of
// attention_fwd_wgmma.cuh instead (the rules are attention_fwd_wgmma.cu's
// mia_attention_{rel,rel_ik,dense,rel_win}_fwd_wgmma_takes); this instance
// keeps head dim 80, larger key grids (the 64 x 64 grid of 4096 tokens) and
// K7's odd n (the smoke's 35). Same block and
// warp layout as the float32 template (64 queries a block, 16 a warp, key
// tiles of kKeys keys in two cp.async stages; K7's bias tile a third part of
// each stage), with one bfloat16 mma.sync.m16n8k16 where 3xTF32 takes three
// m16n8k8, and two walks over the key tiles, so that P is rounded where the
// Pallas kernels round it, (p / denom).astype(v.dtype):
//   - q * scale is rounded to bfloat16 with the scale itself rounded to
//     bfloat16 first, as the Pallas kernels' bf16 multiply (exact at head
//     dim 64, whose scale is 1/8); the A fragments stay in registers as
//     bf16x2 for both walks. K7's Pallas kernel scales the float32 score
//     instead (q.k^T * scale, then + bias): there q goes in as it is and
//     each score is multiplied by the float32 scale;
//   - K and V tiles land in shared memory at half the float32 bytes, rows
//     padded to D + 8 elements (16 bytes), so the 32-bit B-fragment reads
//     of K (row g, columns 2tq + {0, 1, 8, 9}) and the ldmatrix row reads
//     of V fall in distinct banks;
//   - S accumulates in float32; the rel rows (read once, bfloat16 values
//     widened into float32 shared memory; K8 by the slot map, zeros for a
//     pad slot) are a float32 add per score, K7's float32 bias tile as in
//     the float32 template, with its -inf guard in both walks;
//   - pass 1 (the statistics) walks the key tiles for S alone, K (and K7's
//     bias) copied, no V: the rows' maximum m and sum l of exp(S - m),
//     online in float32;
//   - pass 2 walks them again, K, V (and the bias again): S once more, then
//     p = exp(S - m) / l (div_rn: one reciprocal a row), rounded to
//     bfloat16 as it is packed straight from the S accumulators (the C
//     fragments of two adjacent n8 key tiles are the A fragment of one k16
//     step of P.V, FlashAttention-2); V's B fragments come from
//     ldmatrix.trans. O accumulates in float32 with no rescale (m and l are
//     final); the epilogue writes O rounded to bfloat16 and m + log l in
//     float32.
// The second walk repeats S = Q.K^T and the bias: 6 D flops a (query, key)
// pair where one walk takes 4, and K (and K7's bias) read twice. Rounding
// exp(S - m) at the running maximum in one walk instead lands 9-15 bfloat16
// ulps from the Pallas kernels with about half the elements bit-equal
// (tests/test_torch_bf16_fwd_fold.py models both orders).
//
// Bound: operations, 4 D flops a (query, key) pair at 989 TFLOP/s dense
// bfloat16, or bytes (q, k, v, the rel terms or K7's float32 bias, and out
// once) at 3.35 TB/s, whichever is larger (chip_smoke.py computes both);
// K7's bias is 4 bytes a pair against 0.5 flops a byte at D = 64, so K7 is
// bound by bytes.

struct Bf16FwdArgs {
  const bf16* q;        // first head's columns of token 0
  const bf16* k;
  const bf16* v;
  const bf16* rel_a;    // kRelTables: kernel R's terms (B*H, n, kh + kw); else rel_h
  const bf16* rel_b;    // rel_w (kRelTables: the terms again)
  const float* bias;    // kDense: (B*H, n, n) float32
  const bf16* pad_kv;   // kRelWindow: (3, heads*D) q, k, v rows of a pad slot
  bf16* out;
  float* lse;           // optional per-row log-sum-exp (B*H, n); kRelWindow: (B*H, hg*wg) by token
  long long in_stride;  // elements per token row of q, k, v
  long long out_stride; // elements per token row of out
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw (unused by kDense)
  int hg, wg;           // kRelWindow: the token grid
  int nwx, nwin;        // kRelWindow: windows per grid row, windows per image
  float scale;
};

// The packed layout (K2, K3, K8): q, k, v are column blocks of one
// (.., 3*heads*d) tensor, the context is (.., heads*d).
inline Bf16FwdArgs packed_bf16_args(const void* qkv, void* out, void* lse, int heads, int d,
                                    float scale) {
  const bf16* base = static_cast<const bf16*>(qkv);
  Bf16FwdArgs a{};
  a.q = base;
  a.k = base + static_cast<long long>(heads) * d;
  a.v = base + 2LL * heads * d;
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.in_stride = 3LL * heads * d;
  a.out_stride = static_cast<long long>(heads) * d;
  a.heads = heads;
  a.scale = scale;
  return a;
}

// Head-major operands (K6, K7): q, k, v, out (bh, n, d), bh batch elements
// of one head each.
inline Bf16FwdArgs head_major_bf16_args(const void* q, const void* k, const void* v, void* out,
                                        int n, int d, float scale) {
  Bf16FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.in_stride = d;
  a.out_stride = d;
  a.n = n;
  a.heads = 1;
  a.scale = scale;
  return a;
}

// Rows row0 .. row0+kRows-1 of one bfloat16 operand into a tile of rows of
// D + 8 elements; rows past n are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void copy_rows_bf16_async(bf16* dst, const bf16* __restrict__ base,
                                                     long long stride, int row0, int n) {
  constexpr int kC = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kRows * kC; i += kTcThreads) {
    const int r = i / kC;
    const int c = i - r * kC;
    const bool valid = row0 + r < n;
    cp_async16_bytes(dst + r * (D + 8) + 8 * c, valid ? base + (row0 + r) * stride + 8 * c : base,
                     valid);
  }
}

// Slots slot0 .. slot0+kRows-1 of one bfloat16 operand into a tile of rows
// of D + 8 elements, by the slot map: a slot with a token copies the
// token's row, a pad slot pad_row (K, V) or zeros (pad_row null: Q, G), a
// slot past n zeros (copy_slots_async's bfloat16 twin).
template <int D, int kRows = kTcTile>
__device__ __forceinline__ void copy_slots_bf16_async(bf16* dst, const bf16* __restrict__ base,
                                                      long long stride, const int* tok_s,
                                                      int slot0, const bf16* __restrict__ pad_row) {
  constexpr int kC = D / 8;
  for (int i = threadIdx.x; i < kRows * kC; i += kTcThreads) {
    const int r = i / kC;
    const int c = i - r * kC;
    const int tok = tok_s[slot0 + r];
    const bool valid = tok >= 0 || (tok == -1 && pad_row != nullptr);
    const bf16* src = tok >= 0 ? base + tok * stride : pad_row;
    cp_async16_bytes(dst + r * (D + 8) + 8 * c, valid ? src + 8 * c : base, valid);
  }
}

// The rel rows of query rows q0 .. q0+rows-1 of (image, head) bh, widened
// to float32 into R (laid out as rel_view<kTables>).
template <bool kTables>
__device__ __forceinline__ void load_rel_bf16(float* R, const bf16* __restrict__ rel_a,
                                              const bf16* __restrict__ rel_b, long long bh, int n,
                                              int kh, int kw, int q0, int rows) {
  if constexpr (kTables) {
    const int ka = kh + kw;
    const bf16* src = rel_a + (bh * n + q0) * ka;
    for (int i = threadIdx.x; i < rows * ka; i += kTcThreads) R[i] = to_float(src[i]);
  } else {
    const bf16* src_h = rel_a + (bh * n + q0) * kh;
    const bf16* src_w = rel_b + (bh * n + q0) * kw;
    for (int i = threadIdx.x; i < rows * kh; i += kTcThreads) R[i] = to_float(src_h[i]);
    for (int i = threadIdx.x; i < rows * kw; i += kTcThreads)
      R[kTcTile * kh + i] = to_float(src_w[i]);
  }
}

// The rel rows of slots q0 .. q0+63, widened to float32 into R (laid out as
// rel_view<false>) by the slot map: a slot with a token reads rows
// row_base + token of rel_h and rel_w, any other slot gets zeros. One warp
// a slot, one lane a column (copy_rel_slots_async's bfloat16 twin).
__device__ __forceinline__ void load_rel_slots_bf16(float* R, const bf16* __restrict__ rel_h,
                                                    const bf16* __restrict__ rel_w,
                                                    long long row_base, const int* tok_s, int kh,
                                                    int kw, int q0) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kTcTile; r += kTcThreads / 32) {
    const int tok = tok_s[q0 + r];
    const long long row = row_base + tok;
    for (int j = lane; j < kh + kw; j += 32) {
      const bool h = j < kh;
      float* dst = h ? R + r * kh + j : R + kTcTile * kh + r * kw + (j - kh);
      *dst = tok >= 0 ? to_float(h ? rel_h[row * kh + j] : rel_w[row * kw + (j - kh)]) : 0.f;
    }
  }
}

template <int D, int kBias, int kKeys>
__global__ void __launch_bounds__(kTcThreads, 2) attention_fwd_bf16_kernel(const Bf16FwdArgs a) {
  constexpr bool kTables = kBias == kRelTables;
  constexpr bool kDenseBias = kBias == kDense;
  constexpr bool kWindow = kBias == kRelWindow;
  constexpr int kRow = D + 8;     // padded K/V row, bf16 elements
  constexpr int kK = D / 16;      // k16 steps of S = Q.K^T
  constexpr int kN = D / 8;       // n8 tiles of O
  constexpr int kJ = kKeys / 8;   // 8-key groups of a streamed tile
  constexpr int kBRow = kKeys + kBiasPad;
  // a stage: [K | V][kKeys][kRow] bf16, then (K7) the float32 bias tile [64][kBRow]
  constexpr int kKVBytes = 2 * kKeys * kRow * static_cast<int>(sizeof(bf16));
  constexpr int kStageBytes = kKVBytes + (kDenseBias ? kTcTile * kBRow * 4 : 0);
  extern __shared__ float4 smem4[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(smem4);
  float* Rel = reinterpret_cast<float*>(stages + 2 * kStageBytes);  // the rel rows, float32
  const int n = a.n, kw = a.kw;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  long long img = blockIdx.z;  // batch element, or (K8) the image of this window
  int tokens = n;              // tokens per batch element / image
  int queries = n;             // K8: the window's query slots are 0 .. queries-1
  int* tok_s = nullptr;        // K8: the window's slot -> token map, after the rel rows
  if constexpr (kWindow) {
    tok_s = reinterpret_cast<int*>(Rel + kTcTile * (a.kh + kw));
    img = blockIdx.z / a.nwin;
    const int win = static_cast<int>(blockIdx.z - img * a.nwin);
    queries = window_queries(a, win);
    // no slot of this tile is a query: nothing to compute or write
    if (static_cast<int>(blockIdx.x) * kTcTile >= queries) return;
    tokens = a.hg * a.wg;
    stage_slot_tokens(tok_s, a, win, gridDim.x * kTcTile);
    __syncthreads();
  }
  const long long tok0 = img * tokens;
  const long long bh = img * a.heads + head;
  const int row0 = blockIdx.x * kTcTile;
  const long long stride = a.in_stride;
  const bf16* q_base = a.q + tok0 * stride + head * D;
  const bf16* k_base = a.k + tok0 * stride + head * D;
  const bf16* v_base = a.v + tok0 * stride + head * D;
  const RelView rv = rel_view<kTables>(a.kh, kw);
  const int ntiles = (n + kKeys - 1) / kKeys;
  const int nsteps = 2 * ntiles;  // pass 1: steps 0 .. ntiles-1; pass 2: ntiles .. 2 ntiles-1
  const bool bias_vec4 = (n & 3) == 0;

  // step `step`'s tile into stage step % 2: K (and K7's bias tile) in pass
  // 1, K and V (and the bias again) in pass 2
  auto issue = [&](int step) {
    const bool pv = step >= ntiles;
    const int key0 = (pv ? step - ntiles : step) * kKeys;
    unsigned char* st = stages + (step & 1) * kStageBytes;
    bf16* kv = reinterpret_cast<bf16*>(st);
    if constexpr (kWindow) {  // by the slot map; a pad slot's k and v from pad_kv
      copy_slots_bf16_async<D, kKeys>(kv, k_base, stride, tok_s, key0,
                                      a.pad_kv + (a.heads + head) * D);
      if (pv)
        copy_slots_bf16_async<D, kKeys>(kv + kKeys * kRow, v_base, stride, tok_s, key0,
                                        a.pad_kv + (2 * a.heads + head) * D);
    } else {
      copy_rows_bf16_async<D, kKeys>(kv, k_base, stride, key0, n);
      if (pv) copy_rows_bf16_async<D, kKeys>(kv + kKeys * kRow, v_base, stride, key0, n);
    }
    if constexpr (kDenseBias)
      copy_bias_async<kKeys>(reinterpret_cast<float*>(st + kKVBytes), a.bias, bh, n, row0, key0,
                             bias_vec4);
    cp_async_commit();
  };
  issue(0);
  // the rel rows, visible after the first tile's __syncthreads
  if constexpr (kWindow) {
    load_rel_slots_bf16(Rel, a.rel_a, a.rel_b, bh * tokens, tok_s, a.kh, kw, row0);
  } else if constexpr (!kDenseBias) {
    load_rel_bf16<kTables>(Rel, a.rel_a, a.rel_b, bh, n, a.kh, kw, row0, min(kTcTile, n - row0));
  }

  // this warp's rows r0 and r1 = r0 + 8: (scale q) rounded to bfloat16 (K7:
  // q as it is), as A fragments. tr0, tr1: their token rows, which are
  // queries when below n (K8: when the slot has a token)
  const int lr0 = warp * 16 + g;
  const int r0 = row0 + lr0;
  const int r1 = r0 + 8;
  const bool active = row0 + warp * 16 < queries;
  int tr0 = r0, tr1 = r1;
  if constexpr (kWindow) {
    tr0 = tok_s[r0];
    tr1 = tok_s[r1];
  }
  auto query = [&](int tr) { return kWindow ? tr >= 0 : tr < n; };
  const float sc = kDenseBias ? 1.f : __bfloat162float(__float2bfloat16_rn(a.scale));
  uint32_t qa[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? tr1 : tr0;
      const int c = 16 * kk + 2 * tq + ((e & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (query(r)) {
        const __nv_bfloat162 q2 = *reinterpret_cast<const __nv_bfloat162*>(q_base + r * stride + c);
        x0 = __low2float(q2) * sc;
        x1 = __high2float(q2) * sc;
      }
      qa[kk][e] = pack_bf16x2(x0, x1);
    }
  }

  // The scores of a tile: S = Q.K^T, + the bias; keys past n score -inf;
  // the tile's row maxima into mx0, mx1
  auto scores = [&](float (&s)[kJ][4], const bf16* Ks, const float* Bs, int k0, int nk,
                    float& mx0, float& mx1) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (8 * j < nk) {
          const bf16* kr = Ks + (8 * j + g) * kRow + 16 * kk + 2 * tq;
          mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    }
    mx0 = -INFINITY;
    mx1 = -INFINITY;
    if constexpr (kDenseBias) {  // s * scale in float32, then + bias (the Pallas order)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float2 b0 = *reinterpret_cast<const float2*>(Bs + lr0 * kBRow + 8 * j + 2 * tq);
        const float2 b1 =
            *reinterpret_cast<const float2*>(Bs + (lr0 + 8) * kBRow + 8 * j + 2 * tq);
        const int key = k0 + 8 * j + 2 * tq;
        const bool in0 = key < n;
        const bool in1 = key + 1 < n;
        s[j][0] = in0 ? __fadd_rn(__fmul_rn(s[j][0], a.scale), b0.x) : -INFINITY;
        s[j][1] = in1 ? __fadd_rn(__fmul_rn(s[j][1], a.scale), b0.y) : -INFINITY;
        s[j][2] = in0 ? __fadd_rn(__fmul_rn(s[j][2], a.scale), b1.x) : -INFINITY;
        s[j][3] = in1 ? __fadd_rn(__fmul_rn(s[j][3], a.scale), b1.y) : -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      quad_max(mx0, mx1);
    } else {
      add_rel_bias_max<kJ, false>(s, rv, Rel, lr0, k0, tq, n, kw, mx0, mx1);
    }
  };

  // one step of either pass: the stage in place (the next step's copy in
  // flight), then body(Ks, Vs, Bs, k0, nk) for an active warp
  auto walk = [&](int step, auto body) {
    if (step + 1 < nsteps) {
      issue(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile landed for every thread (the first with the rel rows)
    const unsigned char* st = stages + (step & 1) * kStageBytes;
    const bf16* Ks = reinterpret_cast<const bf16*>(st);
    const int k0 = (step < ntiles ? step : step - ntiles) * kKeys;
    if (active)
      body(Ks, Ks + kKeys * kRow, reinterpret_cast<const float*>(st + kKVBytes), k0,
           min(kKeys, n - k0));
    __syncthreads();  // stage consumed before the step after next is copied into it
  };

  // Pass 1 (the statistics): the rows' maxima m and sums l of exp(S - m) in
  // float32, online over the key tiles; no V, no P.V. K7: the reference
  // point 0 while the maximum is still -inf, so that exp(-inf - -inf) is
  // never formed (the rel bias is finite, so every row of the other kinds
  // has a finite key)
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the rows' sums
  for (int step = 0; step < ntiles; ++step) {
    walk(step, [&](const bf16* Ks, const bf16*, const float* Bs, int k0, int nk) {
      float s[kJ][4], mx0, mx1;
      scores(s, Ks, Bs, k0, nk, mx0, mx1);
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float ms0 = kDenseBias && mn0 == -INFINITY ? 0.f : mn0;
      const float ms1 = kDenseBias && mn1 == -INFINITY ? 0.f : mn1;
      l0 *= expf(m0 - ms0);
      l1 *= expf(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        l0 += expf(s[j][0] - ms0) + expf(s[j][1] - ms0);
        l1 += expf(s[j][2] - ms1) + expf(s[j][3] - ms1);
      }
    });
  }
  quad_sum(l0, l1);
  // Pass 2: p = exp(S - m) / l, the normalised probabilities rounded to
  // bfloat16 where the Pallas kernels round (p / denom).astype(v.dtype),
  // packed straight from the S accumulators as the A fragments of P.V; O
  // accumulates in float32 with no rescale (m and l are final). A K7 row
  // with no finite key has l = 0 and gives 0 / 0, as the plain softmax.
  const float ms0 = kDenseBias && m0 == -INFINITY ? 0.f : m0;
  const float ms1 = kDenseBias && m1 == -INFINITY ? 0.f : m1;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float o[kN][4];
#pragma unroll
  for (int i = 0; i < kN; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  for (int step = ntiles; step < nsteps; ++step) {
    walk(step, [&](const bf16* Ks, const bf16* Vs, const float* Bs, int k0, int nk) {
      float s[kJ][4], mx0, mx1;
      scores(s, Ks, Bs, k0, nk, mx0, mx1);
      uint32_t pa[kJ / 2][4];  // P as the A fragments of the k16 steps of P.V
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float p0 = div_rn(expf(s[j][0] - ms0), l0, inv0);
        const float p1 = div_rn(expf(s[j][1] - ms0), l0, inv0);
        const float p2 = div_rn(expf(s[j][2] - ms1), l1, inv1);
        const float p3 = div_rn(expf(s[j][3] - ms1), l1, inv1);
        // key group j is columns 8 (j % 2) .. of k16 step j / 2: registers
        // {0, 1} (rows g, g + 8) for the even group, {2, 3} for the odd one
        pa[j / 2][(j & 1) * 2] = pack_bf16x2(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
      }
      // O += P.V: V's rows 16 jj .. 16 jj + 15 by ldmatrix.trans, two n8 tiles a load
#pragma unroll
      for (int jj = 0; jj < kJ / 2; ++jj) {
        if (16 * jj < nk) {
          const bf16* vrow = Vs + (16 * jj + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRow +
                             (lane >> 4) * 8;
#pragma unroll
          for (int nd = 0; nd < kN; nd += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vrow + 8 * nd);
            mma_bf16(o[nd], pa[jj], b[0], b[1]);
            mma_bf16(o[nd + 1], pa[jj], b[2], b[3]);
          }
        }
      }
    });
  }

  // out = O rounded to bfloat16, lse = m + log l (K8: by token, nothing for
  // a pad query)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? tr1 : tr0;
    if (!query(r)) continue;
    bf16* dst = a.out + (tok0 + r) * a.out_stride + head * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < kN; ++nd)
      *reinterpret_cast<uint32_t*>(dst + 8 * nd) =
          pack_bf16x2(o[nd][2 * half], o[nd][2 * half + 1]);
    if (a.lse != nullptr && tq == 0)
      a.lse[bh * tokens + r] = (half ? m1 : m0) + logf(half ? l1 : l0);
  }
}

// Two stages of K, V (and K7's float32 bias tile), then the float32 rel rows
// (not K7), then K8's slot map (a slot for each row of the window's query
// tiles).
template <int D, int kBias, int kKeys>
size_t fwd_bf16_smem_bytes(const Bf16FwdArgs& a) {
  const size_t stage = sizeof(bf16) * 2 * kKeys * (D + 8) +
                       (kBias == kDense ? sizeof(float) * kTcTile * (kKeys + kBiasPad) : 0);
  const size_t rel = kBias == kDense ? 0 : sizeof(float) * kTcTile * (a.kh + a.kw);
  const size_t slot_map =
      kBias == kRelWindow ? sizeof(int) * ((a.n + kTcTile - 1) / kTcTile) * kTcTile : 0;
  return 2 * stage + rel + slot_map;
}

// One launch of the bfloat16 instance over `batch` images (K8: windows of
// all images): 64-key tiles.
template <int D, int kBias>
int launch_fwd_bf16(const Bf16FwdArgs& a, int batch, cudaStream_t s) {
  constexpr int kKeys = 64;
  const size_t smem = fwd_bf16_smem_bytes<D, kBias, kKeys>(a);
  auto kernel = attention_fwd_bf16_kernel<D, kBias, kKeys>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + kTcTile - 1) / kTcTile, a.heads, batch);
  kernel<<<grid, kTcThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the head dim (64: ViT-B and ViT-L; 80: ViT-H).
template <int kBias>
int dispatch_fwd_bf16(const Bf16FwdArgs& a, int batch, int d, void* stream) {
  if (batch == 0 || a.n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_fwd_bf16<64, kBias>(a, batch, s);
    case 80: return launch_fwd_bf16<80, kBias>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
