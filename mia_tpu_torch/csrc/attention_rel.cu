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
// Design: one block of kThreads threads per (query tile, head, b). Each
// query row has kSplit threads, adjacent lanes of one warp; each keeps q and
// its own output accumulator (D floats each) in registers and takes every
// kSplit-th key, with its own online softmax (running max and sum, one
// rescale per chunk of kChunk keys). K and V tiles of kBK rows are staged
// in shared memory with rows padded by 4 floats, so the kSplit rows read at
// once fall in different banks. At the end the kSplit partial softmaxes
// merge with warp shuffles. The launcher takes kSplit = 4 (32 query rows a
// block) when one wave of kSplit = 1 blocks (128 rows each) would not fill
// the card: at B=1 a global block has only 12 x 1024 query rows, too few
// warps to hide latency with one thread per row. With more rows it takes
// kSplit = 1, where each staged K/V tile serves four times the queries.
// All arithmetic is float32 on the CUDA cores: QK^T and PV are the
// kernel's own loops, no tensor cores and no library calls.
//
// Bound: at ViT-B/512 (D = 64) the kernel does 4*D flops per (query, key)
// pair and reads each K/V row from shared memory once per query tile, so it
// is bound by the FP32 pipe, shared-memory issue and latency, not by device
// memory (qkv is 1.8 MB per 196-token window batch). A wgmma/TMA version
// in bf16 is later work.
//
// The kernel allocates nothing and does not synchronise; each C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // per block: kThreads / kSplit query rows
constexpr int kBK = 32;        // key/value rows staged per shared-memory tile
constexpr int kChunk = 8;      // keys a thread scores before one online-softmax rescale
constexpr int kBlocksPerSM = 3;  // resident blocks at D = 64 (168 registers a thread)

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

// kInKernelRel (K2): rel_a = rh_flat (q_h*k_h, D), rel_b = rw_flat (k_w*k_w, D).
// otherwise   (K3): rel_a = rel_h (B*H, n, k_h),  rel_b = rel_w (B*H, n, k_w).
template <int D, bool kInKernelRel, int kSplit>
__global__ void __launch_bounds__(kThreads) attention_rel_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rel_a,
    const float* __restrict__ rel_b, float* __restrict__ out, int n, int heads,
    int kh, int kw, float scale) {
  constexpr int kBQ = kThreads / kSplit;  // query rows per block
  constexpr int kRow = D + 4;  // padded K/V row: the kSplit rows read together use different banks
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBK x kRow
  float* vs = ks + kBK * kRow;                  // kBK x kRow
  float* rel = vs + kBK * kRow;                 // kBQ x rs
  const int rs = kh + kw + 1;  // odd row stride: column reads hit 32 banks

  const int t = threadIdx.x;
  const int q_local = t / kSplit;
  const int split = t % kSplit;
  const int head = blockIdx.y;
  const long long b = blockIdx.z;
  const int row0 = blockIdx.x * kBQ;
  const int row = row0 + q_local;
  const bool active = row < n;
  const long long stride = 3LL * heads * D;  // floats per qkv token row
  const float* base = qkv + b * n * stride;
  const int k_off = (heads + head) * D;
  const int v_off = (2 * heads + head) * D;

  float q[D];
  if (active) {
    const float4* src = reinterpret_cast<const float4*>(base + row * stride + head * D);
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

  // this tile's rel terms, from the unscaled q, into shared memory
  float* my_rel = rel + q_local * rs;
  if (kInKernelRel) {
    if (active) {
      const int y = row / kw;
      const int x = row - y * kw;
      for (int j = split; j < kh; j += kSplit)
        my_rel[j] = dot_row<D, true>(q, rel_a + (long long)(y * kh + j) * D);
      for (int j = split; j < kw; j += kSplit)
        my_rel[kh + j] = dot_row<D, true>(q, rel_b + (long long)(x * kw + j) * D);
    }
  } else {
    const long long bh = b * heads + head;
    const int rows = min(kBQ, n - row0);
    const float* ra = rel_a + (bh * n + row0) * kh;
    const float* rb = rel_b + (bh * n + row0) * kw;
    for (int i = t; i < rows * kh; i += kThreads) rel[(i / kh) * rs + i % kh] = __ldg(ra + i);
    for (int i = t; i < rows * kw; i += kThreads) rel[(i / kw) * rs + kh + i % kw] = __ldg(rb + i);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] *= scale;

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
      const float* src = base + (long long)(k0 + r) * stride;
      reinterpret_cast<float4*>(ks + r * kRow)[c] = __ldg(reinterpret_cast<const float4*>(src + k_off) + c);
      reinterpret_cast<float4*>(vs + r * kRow)[c] = __ldg(reinterpret_cast<const float4*>(src + v_off) + c);
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
    float4* dst = reinterpret_cast<float4*>(out + (b * n + row) * (long long)(heads * D) + head * D);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      if (i % kSplit == split) {
        dst[i] = make_float4(acc[4 * i + 0] * inv, acc[4 * i + 1] * inv, acc[4 * i + 2] * inv,
                             acc[4 * i + 3] * inv);
      }
    }
  }
}

template <int D, bool kInKernelRel, int kSplit>
int launch_split(const void* qkv, const void* rel_a, const void* rel_b, void* out, int batch,
                 int n, int heads, int kh, int kw, float scale, cudaStream_t stream) {
  constexpr int kBQ = kThreads / kSplit;
  const size_t smem = sizeof(float) * (2 * kBK * (D + 4) + kBQ * (kh + kw + 1));
  auto kernel = attention_rel_kernel<D, kInKernelRel, kSplit>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_a),
      static_cast<const float*>(rel_b), static_cast<float*>(out), n, heads, kh, kw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kInKernelRel>
int launch(const void* qkv, const void* rel_a, const void* rel_b, void* out, int batch, int n,
           int heads, int kh, int kw, float scale, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long whole_rows = static_cast<long long>((n + kThreads - 1) / kThreads) * heads * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole_rows < static_cast<long long>(sms) * kBlocksPerSM)
    return launch_split<D, kInKernelRel, 4>(qkv, rel_a, rel_b, out, batch, n, heads, kh, kw, scale, s);
  return launch_split<D, kInKernelRel, 1>(qkv, rel_a, rel_b, out, batch, n, heads, kh, kw, scale, s);
}

template <bool kInKernelRel>
int dispatch(const void* qkv, const void* rel_a, const void* rel_b, void* out, int batch, int n,
             int heads, int d, int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  switch (d) {  // 64: ViT-B and ViT-L; 80: ViT-H
    case 64: return launch<64, kInKernelRel>(qkv, rel_a, rel_b, out, batch, n, heads, kh, kw, scale, stream);
    case 80: return launch<80, kInKernelRel>(qkv, rel_a, rel_b, out, batch, n, heads, kh, kw, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3: qkv (batch, n, 3*heads*d), rel_h (batch*heads, n, kh), rel_w
// (batch*heads, n, kw), out (batch, n, heads*d); n == kh*kw.
extern "C" int mia_attention_rel_packed_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                            void* out, int batch, int n, int heads, int d, int kh,
                                            int kw, float scale, void* stream) {
  return dispatch<false>(qkv, rel_h, rel_w, out, batch, n, heads, d, kh, kw, scale, stream);
}

// K2: as K3, but with the gathered tables rh_flat ((n/kw)*kh, d) and rw_flat
// (kw*kw, d) in place of the per-token rel terms.
extern "C" int mia_attention_rel_packed_ik_f32(const void* qkv, const void* rh_flat,
                                               const void* rw_flat, void* out, int batch, int n,
                                               int heads, int d, int kh, int kw, float scale,
                                               void* stream) {
  return dispatch<true>(qkv, rh_flat, rw_flat, out, batch, n, heads, d, kh, kw, scale, stream);
}
