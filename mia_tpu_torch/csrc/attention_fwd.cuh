// The float32 SIMT forward attention kernel of the port, K8: windowed
// attention carved from the unpartitioned (B, hg, wg) token grid, with the
// factored rel bias; one flash-style kernel body (online softmax over 32-key
// tiles in shared memory), instantiated by attention_routes.cu. K2, K3, K6
// and K7 run the tensor-core template of attention_fwd_tc.cuh, which takes
// FwdArgs, BiasKind, slot_token and allow_smem from here, as the backward
// template attention_bwd_tc.cuh does.
//
// Per (window b, head h, query slot n):
//
//   out[n] = softmax_k(q_n.k_k * scale + rel_h[n, k / k_w] + rel_w[n, k % k_w]) . v
//
// Operands are token-major: row `tok` of q lies at q + tok * in_stride +
// h * D (likewise k, v), row `tok` of out at out + tok * out_stride + h * D;
// K8 passes q = qkv, k = qkv + H*D, v = qkv + 2*H*D with in_stride = 3*H*D.
// The bias takes two shared-memory loads and an add per score; the (n, n)
// bias never exists.
//
// The block's n = ws*ws rows are the slots of one window of the grid. Slot
// (i, j) of window (wy, wx) is grid token (wy*ws + i, wx*ws + j); a slot
// outside the grid is a pad slot. Pad slots are real keys whose k and v are
// the rows of pad_kv (the qkv Linear's output for a zero token) and which
// carry the query's rel bias for their slot position; pad queries are not
// computed and nothing is written for them. The rel terms are read from the
// grid layout (B*H, hg, wg, ws).
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

// The bias of the tensor-core forward template (attention_fwd_tc.cuh):
// kRelTables: the rel terms from two gathered tables (K2); kRelTerms:
// rel_h, rel_w given (K3, K6); kDense: rel_a is a dense (B*H, n, n) bias (K7).
enum BiasKind { kRelTables = 0, kRelTerms = 1, kDense = 2 };

struct FwdArgs {
  const float* q;       // first head's columns of token 0
  const float* k;
  const float* v;
  const float* rel_a;   // see BiasKind
  const float* rel_b;
  const float* pad_kv;  // K8: (3, heads*D) q, k, v rows of a pad slot
  float* out;
  float* lse;           // optional per-row log-sum-exp, (B*H, n), or K8: (B*H, hg*wg) by token
  long long in_stride;  // floats per token row of q, k, v
  long long out_stride; // floats per token row of out
  int n;                // query rows = key rows per batch element (or slots per window)
  int heads;
  int kh, kw;           // key grid: n == kh * kw (unused by kDense)
  int hg, wg;           // K8: the token grid
  int nwx, nwin;        // K8: windows per grid row, windows per image
  float scale;
};

// q . r for a row r in shared memory
template <int D>
__device__ __forceinline__ float dot_row(const float (&q)[D], const float* __restrict__ r) {
  const float4* r4 = reinterpret_cast<const float4*>(r);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 v = r4[i];
    s0 = fmaf(q[4 * i + 0], v.x, s0);
    s1 = fmaf(q[4 * i + 1], v.y, s1);
    s2 = fmaf(q[4 * i + 2], v.z, s2);
    s3 = fmaf(q[4 * i + 3], v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// The token (within its image) that slot `s` of window `win` stands for,
// or -1 for a pad slot.
template <typename Args>
__device__ __forceinline__ int slot_token(const Args& a, int s, int win) {
  const int ws = a.kw;
  const int i = s / ws;
  const int j = s - i * ws;
  const int gy = (win / a.nwx) * ws + i;
  const int gx = (win % a.nwx) * ws + j;
  return (gy < a.hg && gx < a.wg) ? gy * a.wg + gx : -1;
}

template <int D, int kSplit>
__global__ void __launch_bounds__(kThreads, D <= 64 ? kBlocksPerSM : 2)
    attention_fwd_kernel(const FwdArgs a) {
  constexpr int kBQ = kThreads / kSplit;  // query rows per block
  constexpr int kRow = D + 4;  // padded K/V row: the kSplit rows read together use different banks
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBK x kRow
  float* vs = ks + kBK * kRow;                  // kBK x kRow
  float* rel = vs + kBK * kRow;                 // kBQ x rs
  const int n = a.n, heads = a.heads, kh = a.kh, kw = a.kw;
  const int rs = kh + kw + 1;  // odd row stride: column reads hit 32 banks

  const int t = threadIdx.x;
  const int q_local = t / kSplit;
  const int split = t % kSplit;
  const int head = blockIdx.y;
  const long long img = blockIdx.z / a.nwin;  // the image of this window
  const int win = blockIdx.z - static_cast<int>(img) * a.nwin;
  const int tokens = a.hg * a.wg;             // tokens per image
  const long long tok0 = img * tokens;
  const long long bh = img * heads + head;
  const int row0 = blockIdx.x * kBQ;
  const int row = row0 + q_local;
  const int tok = row < n ? slot_token(a, row, win) : -1;
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

  // this query's rel rows of the grid layout into shared memory
  float* my_rel = rel + q_local * rs;
  if (active) {
    const float* ra = a.rel_a + (bh * tokens + tok) * kh;
    const float* rb = a.rel_b + (bh * tokens + tok) * kw;
    for (int j = split; j < kh; j += kSplit) my_rel[j] = __ldg(ra + j);
    for (int j = split; j < kw; j += kSplit) my_rel[kh + j] = __ldg(rb + j);
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
      const int kt = slot_token(a, k0 + r, win);
      if (kt >= 0) {
        ksrc = k_base + (tok0 + kt) * stride;
        vsrc = v_base + (tok0 + kt) * stride;
      } else {  // a pad slot: the k and v of a zero token
        ksrc = a.pad_kv + (heads + head) * D;
        vsrc = a.pad_kv + (2 * heads + head) * D;
      }
      reinterpret_cast<float4*>(ks + r * kRow)[c] = __ldg(reinterpret_cast<const float4*>(ksrc) + c);
      reinterpret_cast<float4*>(vs + r * kRow)[c] = __ldg(reinterpret_cast<const float4*>(vsrc) + c);
    }
    __syncthreads();
    if (!active) continue;

    // this thread's keys of the tile, j = split + c * kSplit, in chunks
    int yk = (k0 + split) / kw;
    int xk = (k0 + split) - yk * kw;
    for (int c0 = 0; c0 * kSplit < nk; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = split + (c0 + c) * kSplit;
        if (j < nk) {
          s[c] = dot_row<D>(q, ks + j * kRow) + my_rel[yk] + my_rel[kh + xk];
          xk += kSplit;
          while (xk >= kw) {
            xk -= kw;
            ++yk;
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

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, int kSplit>
int launch_fwd_split(const FwdArgs& a, int windows, cudaStream_t stream) {
  constexpr int kBQ = kThreads / kSplit;
  const int rs = a.kh + a.kw + 1;
  const size_t smem = sizeof(float) * (2 * kBK * (D + 4) + kBQ * rs);
  auto kernel = attention_fwd_kernel<D, kSplit>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + kBQ - 1) / kBQ, a.heads, windows);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// windows: the windows of all images
template <int D>
int launch_fwd(const FwdArgs& a, int windows, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long whole_rows =
      static_cast<long long>((a.n + kThreads - 1) / kThreads) * a.heads * windows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole_rows < static_cast<long long>(sms) * kBlocksPerSM)
    return launch_fwd_split<D, 4>(a, windows, s);
  return launch_fwd_split<D, 1>(a, windows, s);
}

}  // namespace
