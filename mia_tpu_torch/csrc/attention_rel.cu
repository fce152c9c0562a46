// K2 and K3 on Hopper: rel-pos attention read straight from the packed qkv
// layout, in float32.
//
// Replaces the TPU kernels
//   K2  mia_tpu/ops/attention.py::fused_attention_rel_packed_ik
//       (_attn_rel_packed_ik_kernel): windowed blocks, rel terms computed in
//       the kernel from the two gathered (q_h*k_h, D) / (k_w*k_w, D) tables;
//   K3  mia_tpu/ops/attention.py::fused_attention_rel_packed
//       (_attn_rel_packed_kernel): global blocks, rel terms precomputed
//       head-major as (B*H, N, k_h) and (B*H, N, k_w).
// Both compute, per (batch or window b, head h, query n),
//
//   out[b, n, h*D:(h+1)*D] = softmax_k(q_n.k_k * scale + rel_h[n, k / k_w]
//                                      + rel_w[n, k % k_w]) . v
//
// with q, k, v read from qkv[b, n, :] at columns h*D, (H+h)*D, (2H+h)*D (the
// (3, heads, head_dim) order of the qkv Linear), and the rel terms taken
// from the UNSCALED q. In K2, rel_h[n, j] = q_n . rh[(y_n*k_h + j)] and
// rel_w[n, j] = q_n . rw[(x_n*k_w + j)] with y_n = n / k_w, x_n = n % k_w.
//
// The TPU kernels fold the rel terms into one MXU product by concatenating
// [q*s | rel_h | rel_w] against [k | E_h | E_w] and mask the key padding to
// 128-row blocks. Here the factored bias is added per score from a small
// shared-memory table, so the (N, N) bias never exists and no key padding
// is needed: the key loop is bounded by n. Window pad tokens (zeros after
// the LayerNorm + partition kernel, so their k and v are the qkv bias) are
// real keys, as in the reference, and are not masked.
//
// The forward is two instances of the template in attention_fwd.cuh (its
// design is described there): kRelTables for K2, kRelTerms for K3, both on
// the packed layout. At B=1 a global block has only 12 x 1024 query rows,
// too few warps to hide latency with one thread per row, hence the
// template's kSplit = 4 launch.
//
// Bound: at ViT-B/512 (D = 64) the kernel does 4*D flops per (query, key)
// pair and reads each K/V row from shared memory once per query tile, so it
// is bound by the FP32 pipe, shared-memory issue and latency, not by device
// memory (qkv is 1.8 MB per 196-token window batch). A wgmma/TMA version
// in bf16 is later work.
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "attention_fwd.cuh"

namespace {

// The packed layout: q, k, v are column blocks of one (batch, n, 3*heads*d)
// tensor, the context is (batch, n, heads*d).
template <int kBias>
int dispatch(const void* qkv, const void* rel_a, const void* rel_b, void* out, void* lse, int batch,
             int n, int heads, int d, int kh, int kw, float scale, void* stream) {
  const float* base = static_cast<const float*>(qkv);
  FwdArgs a{};
  a.q = base;
  a.k = base + static_cast<long long>(heads) * d;
  a.v = base + 2LL * heads * d;
  a.rel_a = static_cast<const float*>(rel_a);
  a.rel_b = static_cast<const float*>(rel_b);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.in_stride = 3LL * heads * d;
  a.out_stride = static_cast<long long>(heads) * d;
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  return dispatch_fwd<kBias, kPacked>(a, batch, d, stream);
}

// ---------------------------------------------------------------------------
// Backward (FlashAttention-2 style, float32)
//
// Replaces the TPU backward kernels
//   K3  mia_tpu/ops/attention.py::_rel_packed_bwd (_rel_packed_bwd_kernel)
//   K2  mia_tpu/ops/attention.py::_rel_packed_ik_bwd (_rel_packed_ik_bwd_kernel)
// which hold every key of a query block at once and recompute the whole
// softmax row. Here the forward's per-row log-sum-exp gives the
// probabilities directly, p = exp(s - lse), and the work splits in two
// passes that write disjoint outputs, so no atomics and a deterministic
// result:
//
//   kernel A, one block per 32-query tile: delta = rowsum(g * o),
//     ds = p (dp - delta) with dp = g . v, dq = scale * ds . k, and the rel
//     gradients drel_h[n, j] = sum_{k / kw == j} ds[n, k] (drel_w likewise).
//     K2 routes drel back into dq through the two tables and, only when the
//     tables need a gradient, stores drel for kernel C. A also stores delta
//     and (K2) the rel terms for kernel B.
//   kernel B, one block per 32-key tile: loops over the query tiles for
//     dk = scale * ds^T . q and dv = p^T . g.
//   kernel C (K2, tables only): dthw[(y, j)] = sum over windows, heads and
//     tokens of row y of drel_h[n, j] * q_n (and the w table likewise), one
//     block per table row, a fixed summation order.
//
// Tiles of q, g, k, v live in shared memory with rows padded by 4 floats
// (float4 reads of 8 lanes at once fall in different banks); the 32 x 32
// score tile is recomputed in both passes and never leaves the block, so no
// (N, N) tensor exists. Window pad tokens are real keys (their k and v are
// the qkv bias): their dk and dv are computed like any other key's.
//
// Bound: at ViT-B/512 training (batch 12) a global block has 144 x 1024^2
// query-key pairs, each costing ~7 x 64 FMAs over the two passes, all on
// the FP32 pipe and shared-memory issue; a tensor-core (wgmma) version is
// later work.
// ---------------------------------------------------------------------------

constexpr int kBT = 32;             // query rows (A) or key rows (B) per tile
constexpr int kBwdThreads = 128;    // 4 warps: warp w scores rows w*8 .. w*8+7
constexpr int kRowsPerWarp = kBT / (kBwdThreads / 32);
constexpr int kTS = kBT + 1;        // score tile row stride

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

// Copy `rows` rows of D floats at src + r * src_stride (plus col) into a
// padded shared tile; rows past `rows` become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long src_stride, int rows) {
  for (int i = threadIdx.x; i < kBT * (D / 4); i += kBwdThreads) {
    const int r = i / (D / 4);
    const int c = i - r * (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = __ldg(reinterpret_cast<const float4*>(src + r * src_stride) + c);
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

// Rel rows of a query tile into shared memory (row stride rs): columns
// [0, kh) from rel_h (row stride sh), [kh, kh+kw) from rel_w (row stride sw).
__device__ __forceinline__ void load_rel(float* Rel, int rs, const float* __restrict__ rel_h,
                                         int sh, const float* __restrict__ rel_w, int sw,
                                         long long row_base, int rows, int kh, int kw) {
  for (int i = threadIdx.x; i < rows * kh; i += kBwdThreads)
    Rel[(i / kh) * rs + i % kh] = __ldg(rel_h + (row_base + i / kh) * sh + i % kh);
  for (int i = threadIdx.x; i < rows * kw; i += kBwdThreads)
    Rel[(i / kw) * rs + kh + i % kw] = __ldg(rel_w + (row_base + i / kw) * sw + i % kw);
}

// Kernel A: dq, delta, the rel-term gradients (and, K2, the rel terms).
// K3 (kInKernelRel false): rel_a/rel_b = rel_h (BH, n, kh) / rel_w (BH, n, kw);
//   drel_a/drel_b = drel_h / drel_w outputs of the same shapes.
// K2 (kInKernelRel true): rel_a/rel_b = rh_flat (q_h*kh, D) / rw_flat (kw*kw, D);
//   rel_out (BH, n, kh+kw) receives the rel terms; drel_a, when not null,
//   receives drel in the same layout (for kernel C); drel_b is unused.
template <int D, bool kInKernelRel>
__global__ void __launch_bounds__(kBwdThreads) attention_rel_bwd_dq_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rel_a,
    const float* __restrict__ rel_b, const float* __restrict__ out,
    const float* __restrict__ g, const float* __restrict__ lse, float* __restrict__ dqkv,
    float* __restrict__ delta_out, float* __restrict__ rel_out, float* __restrict__ drel_a,
    float* __restrict__ drel_b, int n, int heads, int kh, int kw, float scale) {
  constexpr int kRow = D + 4;
  constexpr int kDQ = D / 4;  // dq columns per thread (a quarter of the head)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBT * kRow;
  float* Ks = Gs + kBT * kRow;
  float* Vs = Ks + kBT * kRow;
  float* Ss = Vs + kBT * kRow;  // kBT x kTS: ds
  const int rs = kh + kw + 1;
  float* Rel = Ss + kBT * kTS;   // kBT x rs
  float* DRel = Rel + kBT * rs;  // kBT x rs
  float* lse_s = DRel + kBT * rs;
  float* delta_s = lse_s + kBT;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int head = blockIdx.y;
  const long long b = blockIdx.z;
  const long long bh = b * heads + head;
  const int row0 = blockIdx.x * kBT;
  const int rows = min(kBT, n - row0);
  const long long stride = 3LL * heads * D;
  const long long hd = static_cast<long long>(heads) * D;
  const float* base = qkv + b * n * stride;

  load_tile<D>(Qs, base + row0 * stride + head * D, stride, rows);
  load_tile<D>(Gs, g + (b * n + row0) * hd + head * D, hd, rows);
  for (int i = t; i < kBT * rs; i += kBwdThreads) DRel[i] = 0.f;
  if (!kInKernelRel) load_rel(Rel, rs, rel_a, kh, rel_b, kw, bh * n + row0, rows, kh, kw);
  __syncthreads();

  // delta = rowsum(g * o), one warp per row
  for (int r = warp; r < kBT; r += kBwdThreads / 32) {
    float acc = 0.f;
    if (r < rows) {
      const float* o = out + (b * n + row0 + r) * hd + head * D;
      for (int c = lane; c < D; c += 32) acc += Gs[r * kRow + c] * __ldg(o + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = r < rows ? __ldg(lse + bh * n + row0 + r) : 0.f;
      if (r < rows) delta_out[bh * n + row0 + r] = acc;
    }
  }
  if (kInKernelRel) {  // rel_h[n, j] = q_n . rh[y_n*kh + j], rel_w from rw, unscaled q
    const int ka = kh + kw;
    for (int i = t; i < rows * ka; i += kBwdThreads) {
      const int r = i / ka;
      const int j = i - r * ka;
      const int y = (row0 + r) / kw;
      const int x = (row0 + r) - y * kw;
      const float* tab = j < kh ? rel_a + static_cast<long long>(y * kh + j) * D
                                : rel_b + static_cast<long long>(x * kw + (j - kh)) * D;
      const float4* q4 = reinterpret_cast<const float4*>(Qs + r * kRow);
      const float4* t4 = reinterpret_cast<const float4*>(tab);
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < D / 4; ++c) acc += dot4(q4[c], __ldg(t4 + c));
      Rel[r * rs + j] = acc;
      rel_out[(bh * n + row0 + r) * ka + j] = acc;
    }
  }

  float dq[kDQ];
#pragma unroll
  for (int i = 0; i < kDQ; ++i) dq[i] = 0.f;
  const int qd0 = warp * kDQ;  // this thread's dq columns: row `lane`, [qd0, qd0 + kDQ)

  for (int k0 = 0; k0 < n; k0 += kBT) {
    const int nk = min(kBT, n - k0);
    __syncthreads();  // previous tile consumed (first pass: Rel, delta written)
    load_tile<D>(Ks, base + k0 * stride + (heads + head) * D, stride, nk);
    load_tile<D>(Vs, base + k0 * stride + (2 * heads + head) * D, stride, nk);
    __syncthreads();

    const int kk = lane;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_tile<D>(Qs, Gs, Ks, Vs, kk, warp, s, dp);
    const int yk = (k0 + kk) / kw;
    const int xk = (k0 + kk) - yk * kw;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      float ds = 0.f;
      if (kk < nk && r < rows) {
        const float p = expf(s[i] * scale + Rel[r * rs + yk] + Rel[r * rs + kh + xk] - lse_s[r]);
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

  if (lane < rows) {
    const int r = lane;
    if (kInKernelRel) {  // dq += drel_h . rh[y_n*kh + :] + drel_w . rw[x_n*kw + :]
      const int y = (row0 + r) / kw;
      const int x = (row0 + r) - y * kw;
#pragma unroll
      for (int i = 0; i < kDQ; ++i) dq[i] *= scale;
      for (int j = 0; j < kh + kw; ++j) {
        const float w = DRel[r * rs + j];
        const float* tab = j < kh ? rel_a + static_cast<long long>(y * kh + j) * D
                                  : rel_b + static_cast<long long>(x * kw + (j - kh)) * D;
        const float4* t4 = reinterpret_cast<const float4*>(tab + qd0);
#pragma unroll
        for (int c = 0; c < kDQ / 4; ++c) {
          const float4 tv = __ldg(t4 + c);
          dq[4 * c + 0] = fmaf(w, tv.x, dq[4 * c + 0]);
          dq[4 * c + 1] = fmaf(w, tv.y, dq[4 * c + 1]);
          dq[4 * c + 2] = fmaf(w, tv.z, dq[4 * c + 2]);
          dq[4 * c + 3] = fmaf(w, tv.w, dq[4 * c + 3]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kDQ; ++i) dq[i] *= scale;
    }
    float4* dst = reinterpret_cast<float4*>(dqkv + (b * n + row0 + r) * stride + head * D + qd0);
#pragma unroll
    for (int c = 0; c < kDQ / 4; ++c)
      dst[c] = make_float4(dq[4 * c + 0], dq[4 * c + 1], dq[4 * c + 2], dq[4 * c + 3]);
  }
  // the rel gradients of the tile
  if (kInKernelRel) {
    if (drel_a != nullptr) {
      const int ka = kh + kw;
      for (int i = t; i < rows * ka; i += kBwdThreads)
        drel_a[(bh * n + row0) * ka + i] = DRel[(i / ka) * rs + i % ka];
    }
  } else {
    for (int i = t; i < rows * kh; i += kBwdThreads)
      drel_a[(bh * n + row0) * kh + i] = DRel[(i / kh) * rs + i % kh];
    for (int i = t; i < rows * kw; i += kBwdThreads)
      drel_b[(bh * n + row0) * kw + i] = DRel[(i / kw) * rs + kh + i % kw];
  }
}

// Kernel B: dk and dv of one 32-key tile, looping over all query tiles. The
// rel terms come from rel_h / rel_w with row strides sh / sw (K3: the
// inputs; K2: kernel A's rel_out, both views of one (BH, n, kh+kw) buffer).
template <int D>
__global__ void __launch_bounds__(kBwdThreads) attention_rel_bwd_dkv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rel_h, int sh,
    const float* __restrict__ rel_w, int sw, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dqkv,
    int n, int heads, int kh, int kw, float scale) {
  constexpr int kRow = D + 4;
  constexpr int kDK = D / 4;  // dk and dv columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBT * kRow;
  float* Ks = Gs + kBT * kRow;
  float* Vs = Ks + kBT * kRow;
  float* Ss = Vs + kBT * kRow;  // ds
  float* Ps = Ss + kBT * kTS;   // p
  const int rs = kh + kw + 1;
  float* Rel = Ps + kBT * kTS;
  float* lse_s = Rel + kBT * rs;
  float* delta_s = lse_s + kBT;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int head = blockIdx.y;
  const long long b = blockIdx.z;
  const long long bh = b * heads + head;
  const int key0 = blockIdx.x * kBT;
  const int nkeys = min(kBT, n - key0);
  const long long stride = 3LL * heads * D;
  const long long hd = static_cast<long long>(heads) * D;
  const float* base = qkv + b * n * stride;

  load_tile<D>(Ks, base + key0 * stride + (heads + head) * D, stride, nkeys);
  load_tile<D>(Vs, base + key0 * stride + (2 * heads + head) * D, stride, nkeys);

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
    load_tile<D>(Qs, base + q0 * stride + head * D, stride, rows);
    load_tile<D>(Gs, g + (b * n + q0) * hd + head * D, hd, rows);
    load_rel(Rel, rs, rel_h, sh, rel_w, sw, bh * n + q0, rows, kh, kw);
    for (int i = t; i < kBT; i += kBwdThreads) {
      lse_s[i] = i < rows ? __ldg(lse + bh * n + q0 + i) : 0.f;
      delta_s[i] = i < rows ? __ldg(delta + bh * n + q0 + i) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_tile<D>(Qs, Gs, Ks, Vs, kk, warp, s, dp);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      float p = 0.f, ds = 0.f;
      if (kk < nkeys && r < rows) {
        p = expf(s[i] * scale + Rel[r * rs + yk] + Rel[r * rs + kh + xk] - lse_s[r]);
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

  if (kk < nkeys) {
    float* row = dqkv + (b * n + key0 + kk) * stride;
    float4* dk4 = reinterpret_cast<float4*>(row + (heads + head) * D + d0);
    float4* dv4 = reinterpret_cast<float4*>(row + (2 * heads + head) * D + d0);
#pragma unroll
    for (int c = 0; c < kDK / 4; ++c) {
      dk4[c] = make_float4(dk[4 * c + 0] * scale, dk[4 * c + 1] * scale, dk[4 * c + 2] * scale,
                           dk[4 * c + 3] * scale);
      dv4[c] = make_float4(dv[4 * c + 0], dv[4 * c + 1], dv[4 * c + 2], dv[4 * c + 3]);
    }
  }
}

// Kernel C (K2): the gradient of the two gathered tables, one block of D
// threads per table row. Rows [0, q_h*kh) are rh_flat's (y, j): the sum over
// windows, heads and the kw tokens of row y of drel[., n, j] * q_n; rows
// [q_h*kh, q_h*kh + kw*kw) are rw_flat's (x, j) over the q_h tokens of column x.
template <int D>
__global__ void attention_rel_bwd_tables_kernel(const float* __restrict__ qkv,
                                                const float* __restrict__ drel,
                                                float* __restrict__ dthw, int batch, int n,
                                                int heads, int kh, int kw) {
  const int d = threadIdx.x;
  const int q_h = n / kw;
  const int row = blockIdx.x;
  const bool h_part = row < q_h * kh;
  const int r = h_part ? row : row - q_h * kh;
  const int pos = r / (h_part ? kh : kw);  // y (h part) or x (w part)
  const int j = r - pos * (h_part ? kh : kw);
  const int col = h_part ? j : kh + j;
  const int ka = kh + kw;
  const long long stride = 3LL * heads * D;
  const int count = h_part ? kw : q_h;
  float acc = 0.f;
  for (long long bh = 0; bh < static_cast<long long>(batch) * heads; ++bh) {
    const long long b = bh / heads;
    const int head = static_cast<int>(bh - b * heads);
    for (int i = 0; i < count; ++i) {
      const int tok = h_part ? pos * kw + i : i * kw + pos;
      acc += __ldg(drel + (bh * n + tok) * ka + col) *
             __ldg(qkv + (b * n + tok) * stride + head * D + d);
    }
  }
  dthw[static_cast<long long>(row) * D + d] = acc;
}

template <int D>
size_t bwd_smem_bytes(int kh, int kw) {
  const int rs = kh + kw + 1;
  return sizeof(float) * (4 * kBT * (D + 4) + 2 * kBT * kTS + 2 * kBT * rs + 2 * kBT);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, bool kInKernelRel>
int launch_bwd(const void* qkv, const void* rel_a, const void* rel_b, const void* out,
               const void* g, const void* lse, void* dqkv, void* delta, void* rel_out,
               void* drel_a, void* drel_b, void* dthw, int batch, int n, int heads, int kh,
               int kw, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes<D>(kh, kw);
  const dim3 grid((n + kBT - 1) / kBT, heads, batch);
  auto ka = attention_rel_bwd_dq_kernel<D, kInKernelRel>;
  auto kb = attention_rel_bwd_dkv_kernel<D>;
  cudaError_t err = allow_smem(ka, smem);
  if (err == cudaSuccess) err = allow_smem(kb, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* f_qkv = static_cast<const float*>(qkv);
  ka<<<grid, kBwdThreads, smem, s>>>(
      f_qkv, static_cast<const float*>(rel_a), static_cast<const float*>(rel_b),
      static_cast<const float*>(out), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<float*>(dqkv), static_cast<float*>(delta),
      static_cast<float*>(rel_out), static_cast<float*>(drel_a), static_cast<float*>(drel_b), n,
      heads, kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* rel_h = kInKernelRel ? static_cast<const float*>(rel_out)
                                    : static_cast<const float*>(rel_a);
  const float* rel_w = kInKernelRel ? static_cast<const float*>(rel_out) + kh
                                    : static_cast<const float*>(rel_b);
  const int sh = kInKernelRel ? kh + kw : kh;
  const int sw = kInKernelRel ? kh + kw : kw;
  kb<<<grid, kBwdThreads, smem, s>>>(f_qkv, rel_h, sh, rel_w, sw, static_cast<const float*>(g),
                                     static_cast<const float*>(lse),
                                     static_cast<const float*>(delta), static_cast<float*>(dqkv),
                                     n, heads, kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kInKernelRel || dthw == nullptr) return static_cast<int>(err);
  const int table_rows = (n / kw) * kh + kw * kw;
  attention_rel_bwd_tables_kernel<D><<<table_rows, D, 0, s>>>(
      f_qkv, static_cast<const float*>(drel_a), static_cast<float*>(dthw), batch, n, heads, kh,
      kw);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInKernelRel>
int dispatch_bwd(const void* qkv, const void* rel_a, const void* rel_b, const void* out,
                 const void* g, const void* lse, void* dqkv, void* delta, void* rel_out,
                 void* drel_a, void* drel_b, void* dthw, int batch, int n, int heads, int d,
                 int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (kInKernelRel && dthw != nullptr && drel_a == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return launch_bwd<64, kInKernelRel>(qkv, rel_a, rel_b, out, g, lse, dqkv, delta, rel_out,
                                          drel_a, drel_b, dthw, batch, n, heads, kh, kw, scale,
                                          stream);
    case 80:
      return launch_bwd<80, kInKernelRel>(qkv, rel_a, rel_b, out, g, lse, dqkv, delta, rel_out,
                                          drel_a, drel_b, dthw, batch, n, heads, kh, kw, scale,
                                          stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3: qkv (batch, n, 3*heads*d), rel_h (batch*heads, n, kh), rel_w
// (batch*heads, n, kw), out (batch, n, heads*d); n == kh*kw. lse, when not
// null, receives the per-row log-sum-exp (batch*heads, n) for the backward.
extern "C" int mia_attention_rel_packed_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                            void* out, void* lse, int batch, int n, int heads,
                                            int d, int kh, int kw, float scale, void* stream) {
  return dispatch<kRelTerms>(qkv, rel_h, rel_w, out, lse, batch, n, heads, d, kh, kw, scale, stream);
}

// K2: as K3, but with the gathered tables rh_flat ((n/kw)*kh, d) and rw_flat
// (kw*kw, d) in place of the per-token rel terms.
extern "C" int mia_attention_rel_packed_ik_f32(const void* qkv, const void* rh_flat,
                                               const void* rw_flat, void* out, void* lse,
                                               int batch, int n, int heads, int d, int kh, int kw,
                                               float scale, void* stream) {
  return dispatch<kRelTables>(qkv, rh_flat, rw_flat, out, lse, batch, n, heads, d, kh, kw, scale,
                        stream);
}

// K3 backward: from the forward's inputs, its output, its lse and the
// output cotangent g (batch, n, heads*d), writes dqkv (batch, n, 3*heads*d)
// and drel_h / drel_w (shapes of rel_h / rel_w). delta is scratch
// (batch*heads, n).
extern "C" int mia_attention_rel_packed_bwd_f32(const void* qkv, const void* rel_h,
                                                const void* rel_w, const void* out, const void* g,
                                                const void* lse, void* dqkv, void* delta,
                                                void* drel_h, void* drel_w, int batch, int n,
                                                int heads, int d, int kh, int kw, float scale,
                                                void* stream) {
  return dispatch_bwd<false>(qkv, rel_h, rel_w, out, g, lse, dqkv, delta, nullptr, drel_h, drel_w,
                             nullptr, batch, n, heads, d, kh, kw, scale, stream);
}

// K2 backward: writes dqkv; delta (batch*heads, n) and rel (batch*heads, n,
// kh+kw) are scratch. When dthw ((n/kw)*kh + kw*kw, d) is not null, the
// tables' gradient is written there, and drel (batch*heads, n, kh+kw) is
// the scratch it is reduced from.
extern "C" int mia_attention_rel_packed_ik_bwd_f32(const void* qkv, const void* rh_flat,
                                                   const void* rw_flat, const void* out,
                                                   const void* g, const void* lse, void* dqkv,
                                                   void* delta, void* rel, void* drel, void* dthw,
                                                   int batch, int n, int heads, int d, int kh,
                                                   int kw, float scale, void* stream) {
  return dispatch_bwd<true>(qkv, rh_flat, rw_flat, out, g, lse, dqkv, delta, rel, drel, nullptr,
                            dthw, batch, n, heads, d, kh, kw, scale, stream);
}
