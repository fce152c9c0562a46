// The forward attention template of the port, in float32: one flash-style
// kernel body (online softmax over 32-key tiles in shared memory) whose
// instances differ in where q, k, v come from and where the additive bias
// comes from. attention_rel.cu instantiates it for K2 and K3 (packed qkv),
// attention_routes.cu for K6 (head-major operands), K7 (dense bias) and K8
// (windows carved from the unpartitioned token grid). The backward template
// is attention_bwd.cuh.
//
// Every instance computes, per (batch element or window b, head h, query n),
//
//   out[n] = softmax_k(q_n.k_k * scale + bias[n, k]) . v
//
// Operands are token-major: row `tok` of q lies at q + tok * in_stride +
// h * D (likewise k, v), row `tok` of out at out + tok * out_stride + h * D.
// The packed layout passes q = qkv, k = qkv + H*D, v = qkv + 2*H*D with
// in_stride = 3*H*D; the head-major layout passes three tensors with
// in_stride = D and counts every (batch, head) pair as a batch element of
// one head.
//
// Bias (template parameter kBias):
//   kRelTables  rel_a = rh (q_h*k_h, D), rel_b = rw (k_w*k_w, D): the factored
//               rel terms are computed in the kernel from the unscaled q;
//   kRelTerms   rel_a = rel_h (.., k_h), rel_b = rel_w (.., k_w), one row per
//               query: bias[n, k] = rel_h[n, k / k_w] + rel_w[n, k % k_w];
//   kDense      rel_a = bias (B*H, n, n), staged tile by tile beside the k
//               tile; the ragged last tile is masked by the loop bounds.
// The factored bias is two shared-memory loads and an add per score; the
// (n, n) bias never exists unless the caller hands one in (kDense).
//
// Layout kGrid (kWindow in the body): the block's n = ws*ws rows are the
// slots of one window of a (B, hg, wg) token grid. Slot (i, j) of window (wy, wx) is grid token
// (wy*ws + i, wx*ws + j); a slot outside the grid is a pad slot. Pad slots
// are real keys whose k and v are the rows of pad_kv (the qkv Linear's
// output for a zero token) and which carry the query's rel bias for their
// slot position; pad queries are not computed and nothing is written for
// them. The rel terms are read from the grid layout (B*H, hg, wg, ws).
//
// Design: one block of kThreads threads per (query tile, head, b). Each
// query row has kSplit threads, adjacent lanes of one warp; each keeps q and
// its own output accumulator (D floats each) in registers and takes every
// kSplit-th key, with its own online softmax (running max and sum, one
// rescale per chunk of kChunk keys). K and V tiles of kBK rows are staged
// in shared memory with rows padded by 4 floats, so the kSplit rows read at
// once fall in different banks. At the end the kSplit partial softmaxes
// merge with warp shuffles. The launcher takes kSplit = 4 (32 query rows a
// block) when one wave of kSplit = 1 blocks (128 rows each) would not fill
// the card; with more rows it takes kSplit = 1, where each staged K/V tile
// serves four times the queries. All arithmetic is float32 on the CUDA
// cores: QK^T and PV are the kernel's own loops, no tensor cores and no
// library calls.
//
// The kernel allocates nothing and does not synchronise; the launchers
// return cudaGetLastError() so the wrapper can raise on a refused launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // per block: kThreads / kSplit query rows
constexpr int kBK = 32;        // key/value rows staged per shared-memory tile
constexpr int kChunk = 8;      // keys a thread scores before one online-softmax rescale
constexpr int kBlocksPerSM = 3;  // resident blocks at D = 64 (168 registers a thread)

enum BiasKind { kRelTables = 0, kRelTerms = 1, kDense = 2 };
// Where the rows come from. kPacked and kHeadMajor run the same code (the
// strides are runtime arguments); the parameter gives the head-major kernels
// instances, and so names in a trace, apart from the packed ones.
enum Layout { kPacked = 0, kHeadMajor = 1, kGrid = 2 };

struct FwdArgs {
  const float* q;       // first head's columns of token 0
  const float* k;
  const float* v;
  const float* rel_a;   // see BiasKind
  const float* rel_b;
  const float* pad_kv;  // kWindow: (3, heads*D) q, k, v rows of a pad slot
  float* out;
  float* lse;           // optional per-row log-sum-exp, (B*H, n), or kWindow: (B*H, hg*wg) by token
  long long in_stride;  // floats per token row of q, k, v
  long long out_stride; // floats per token row of out
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw (unused by kDense)
  int hg, wg;           // kWindow: the token grid
  int nwx, nwin;        // kWindow: windows per grid row, windows per image
  float scale;
};

// q . r for a row r in shared memory, or in read-only global memory (kGlobal)
template <int D, bool kGlobal = false>
__device__ __forceinline__ float dot_row(const float (&q)[D], const float* __restrict__ r) {
  const float4* r4 = reinterpret_cast<const float4*>(r);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    float4 v;
    if constexpr (kGlobal) {
      v = __ldg(r4 + i);
    } else {
      v = r4[i];
    }
    s0 = fmaf(q[4 * i + 0], v.x, s0);
    s1 = fmaf(q[4 * i + 1], v.y, s1);
    s2 = fmaf(q[4 * i + 2], v.z, s2);
    s3 = fmaf(q[4 * i + 3], v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// The token (within its image) that row/slot `s` of this block stands for,
// or -1 for a pad slot of a window.
template <bool kWindow, typename Args>
__device__ __forceinline__ int slot_token(const Args& a, int s, int win) {
  if constexpr (!kWindow) {
    return s;
  } else {
    const int ws = a.kw;
    const int i = s / ws;
    const int j = s - i * ws;
    const int gy = (win / a.nwx) * ws + i;
    const int gx = (win % a.nwx) * ws + j;
    return (gy < a.hg && gx < a.wg) ? gy * a.wg + gx : -1;
  }
}

template <int D, int kBias, int kLayout, int kSplit>
__global__ void __launch_bounds__(kThreads, D <= 64 ? kBlocksPerSM : 2)
    attention_fwd_kernel(const FwdArgs a) {
  constexpr bool kWindow = kLayout == kGrid;
  constexpr int kBQ = kThreads / kSplit;  // query rows per block
  constexpr int kRow = D + 4;  // padded K/V row: the kSplit rows read together use different banks
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBK x kRow
  float* vs = ks + kBK * kRow;                  // kBK x kRow
  float* rel = vs + kBK * kRow;                 // kBQ x rs
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw;
  // odd row stride: column reads hit 32 banks
  const int rs = kBias == kDense ? kBK + 1 : kh + kw + 1;

  const int t = threadIdx.x;
  const int q_local = t / kSplit;
  const int split = t % kSplit;
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
  const int row0 = blockIdx.x * kBQ;
  const int row = row0 + q_local;
  const int tok = row < n ? slot_token<kWindow>(a, row, win) : -1;
  const bool active = tok >= 0;
  const long long stride = a.in_stride;
  const float* q_base = a.q + head * D;
  const float* k_base = a.k + head * D;
  const float* v_base = a.v + head * D;

  float q[D];
  if (active) {
    const float4* src = reinterpret_cast<const float4*>(q_base + (tok0 + tok) * stride);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 v = __ldg(src + i);
      q[4 * i + 0] = v.x;
      q[4 * i + 1] = v.y;
      q[4 * i + 2] = v.z;
      q[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = 0.f;
  }

  // this tile's rel terms into shared memory
  float* my_rel = rel + q_local * rs;
  if constexpr (kBias == kRelTables) {  // from the unscaled q and the two tables
    if (active) {
      const int y = row / kw;
      const int x = row - y * kw;
      for (int j = split; j < kh; j += kSplit)
        my_rel[j] = dot_row<D, true>(q, a.rel_a + (long long)(y * kh + j) * D);
      for (int j = split; j < kw; j += kSplit)
        my_rel[kh + j] = dot_row<D, true>(q, a.rel_b + (long long)(x * kw + j) * D);
    }
  } else if constexpr (kBias == kRelTerms && kWindow) {  // this query's rows of the grid layout
    if (active) {
      const float* ra = a.rel_a + (bh * tokens + tok) * kh;
      const float* rb = a.rel_b + (bh * tokens + tok) * kw;
      for (int j = split; j < kh; j += kSplit) my_rel[j] = __ldg(ra + j);
      for (int j = split; j < kw; j += kSplit) my_rel[kh + j] = __ldg(rb + j);
    }
  } else if constexpr (kBias == kRelTerms) {  // the tile's rows are contiguous
    const int rows = min(kBQ, n - row0);
    const float* ra = a.rel_a + (bh * n + row0) * kh;
    const float* rb = a.rel_b + (bh * n + row0) * kw;
    for (int i = t; i < rows * kh; i += kThreads) rel[(i / kh) * rs + i % kh] = __ldg(ra + i);
    for (int i = t; i < rows * kw; i += kThreads) rel[(i / kw) * rs + kh + i % kw] = __ldg(rb + i);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] *= a.scale;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int nk = min(kBK, n - k0);
    __syncthreads();  // the previous tile is consumed (first pass: rel is written)
    for (int i = t; i < nk * (D / 4); i += kThreads) {
      const int r = i / (D / 4);
      const int c = i - r * (D / 4);
      const float* ksrc;
      const float* vsrc;
      if constexpr (kWindow) {
        const int kt = slot_token<true>(a, k0 + r, win);
        if (kt >= 0) {
          ksrc = k_base + (tok0 + kt) * stride;
          vsrc = v_base + (tok0 + kt) * stride;
        } else {  // a pad slot: the k and v of a zero token
          ksrc = a.pad_kv + (heads + head) * D;
          vsrc = a.pad_kv + (2 * heads + head) * D;
        }
      } else {
        const long long off = (tok0 + k0 + r) * stride;
        ksrc = k_base + off;
        vsrc = v_base + off;
      }
      reinterpret_cast<float4*>(ks + r * kRow)[c] = __ldg(reinterpret_cast<const float4*>(ksrc) + c);
      reinterpret_cast<float4*>(vs + r * kRow)[c] = __ldg(reinterpret_cast<const float4*>(vsrc) + c);
    }
    if constexpr (kBias == kDense) {  // the bias tile of these queries and keys
      const int rows = min(kBQ, n - row0);
      for (int i = t; i < rows * kBK; i += kThreads) {
        const int r = i / kBK;
        const int c = i - r * kBK;
        if (c < nk) rel[r * rs + c] = __ldg(a.rel_a + (bh * n + row0 + r) * n + k0 + c);
      }
    }
    __syncthreads();
    if (!active) continue;

    // this thread's keys of the tile, j = split + c * kSplit, in chunks
    int yk = 0, xk = 0;
    if constexpr (kBias != kDense) {
      yk = (k0 + split) / kw;
      xk = (k0 + split) - yk * kw;
    }
    for (int c0 = 0; c0 * kSplit < nk; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = split + (c0 + c) * kSplit;
        if (j < nk) {
          if constexpr (kBias == kDense) {
            s[c] = dot_row<D>(q, ks + j * kRow) + my_rel[j];
          } else {
            s[c] = dot_row<D>(q, ks + j * kRow) + my_rel[yk] + my_rel[kh + xk];
            xk += kSplit;
            while (xk >= kw) {
              xk -= kw;
              ++yk;
            }
          }
        } else {
          s[c] = -INFINITY;
        }
        cmax = fmaxf(cmax, s[c]);
      }
      if (cmax == -INFINITY) break;  // no key of this chunk (nor later) for this split
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);  // 0 while m = -inf
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = split + (c0 + c) * kSplit;
        if (j < nk) {
          const float p = expf(s[c] - m_new);
          l += p;
          const float4* v4 = reinterpret_cast<const float4*>(vs + j * kRow);
#pragma unroll
          for (int i = 0; i < D / 4; ++i) {
            const float4 v = v4[i];
            acc[4 * i + 0] = fmaf(p, v.x, acc[4 * i + 0]);
            acc[4 * i + 1] = fmaf(p, v.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(p, v.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(p, v.w, acc[4 * i + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  // merge the kSplit partial softmaxes of each row (adjacent lanes)
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float c_self = m == -INFINITY ? 0.f : expf(m - m_new);
    const float c_o = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * c_self + l_o * c_o;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * c_self + a_o * c_o;
    }
    m = m_new;
  }

  if (active) {  // every split holds the merged row; each stores a quarter
    const float inv = 1.f / l;
    if (a.lse != nullptr && split == 0) a.lse[bh * tokens + tok] = m + logf(l);
    float4* dst = reinterpret_cast<float4*>(a.out + (tok0 + tok) * a.out_stride + head * D);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      if (i % kSplit == split) {
        dst[i] = make_float4(acc[4 * i + 0] * inv, acc[4 * i + 1] * inv, acc[4 * i + 2] * inv,
                             acc[4 * i + 3] * inv);
      }
    }
  }
}

template <int D, int kBias, int kLayout, int kSplit>
int launch_fwd_split(const FwdArgs& a, int blocks_z, cudaStream_t stream) {
  constexpr int kBQ = kThreads / kSplit;
  const int rs = kBias == kDense ? kBK + 1 : a.kh + a.kw + 1;
  const size_t smem = sizeof(float) * (2 * kBK * (D + 4) + kBQ * rs);
  auto kernel = attention_fwd_kernel<D, kBias, kLayout, kSplit>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.n + kBQ - 1) / kBQ, a.heads, blocks_z);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// blocks_z: batch elements (or, kGrid, windows of all images)
template <int D, int kBias, int kLayout>
int launch_fwd(const FwdArgs& a, int blocks_z, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long whole_rows =
      static_cast<long long>((a.n + kThreads - 1) / kThreads) * a.heads * blocks_z;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole_rows < static_cast<long long>(sms) * kBlocksPerSM)
    return launch_fwd_split<D, kBias, kLayout, 4>(a, blocks_z, s);
  return launch_fwd_split<D, kBias, kLayout, 1>(a, blocks_z, s);
}

template <int kBias, int kLayout>
int dispatch_fwd(const FwdArgs& a, int blocks_z, int d, void* stream) {
  if (blocks_z == 0 || a.n == 0) return static_cast<int>(cudaSuccess);
  switch (d) {  // 64: ViT-B and ViT-L; 80: ViT-H
    case 64: return launch_fwd<64, kBias, kLayout>(a, blocks_z, stream);
    case 80: return launch_fwd<80, kBias, kLayout>(a, blocks_z, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
