// K9 on Hopper: window unpartition + residual add + LayerNorm, forward, in
// float32.
//
// Replaces the TPU kernel
// mia_tpu/ops/unpartition_residual.py::unpartition_add_ln (_fwd_kernel). For
// windows (B*nW, ws, ws, C) (the attention block's output, still
// partitioned; pad slots hold anything) and the residual stream shortcut
// (B, H, W, C) it writes both
//
//   x_new = shortcut + window_unpartition(windows)
//   y     = LayerNorm(x_new)      (norm2; flax's order, fast variance)
//
// as (B, H, W, C). The TPU kernel joins the window tiles of a row band with
// static slices and a concat because Mosaic cannot reshape a 14-row tile.
// Here each real token is one warp, as in K4 (ln_window.cu): it finds its
// window slot, adds the shortcut row, writes x_new, reduces sum and sum of
// squares over the C channels with warp shuffles and writes y. Pad slots
// are never read. The second pass adds the two rows again from L1 (the
// same float32 add, so y is the LayerNorm of exactly the x_new it wrote).
//
// Bound: bytes. At ViT-B/512 (B=1, 1024 tokens of 768 channels) it reads
// and writes 4 x 3.1 MB, about 3.8 us at 3.35 TB/s; launch overhead is of
// the same order.
//
// This is the forward kernel; the backward (the LayerNorm VJP carved into
// window tiles) comes with the slice that trains through this route. The
// kernel allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // tokens per block

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32) unpartition_add_ln_kernel(
    const float* __restrict__ windows, const float* __restrict__ shortcut,
    const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ x_new,
    float* __restrict__ y, long long tokens, int H, int W, int C, int ws, int nwx, int nw,
    float eps) {
  const int lane = threadIdx.x & 31;
  const long long token = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (token >= tokens) return;

  const long long hw = static_cast<long long>(H) * W;
  const long long b = token / hw;
  const int rem = static_cast<int>(token - b * hw);
  const int gy = rem / W;
  const int gx = rem - gy * W;
  const long long win = b * nw + (gy / ws) * nwx + gx / ws;
  const long long slot = win * ws * ws + (gy % ws) * ws + gx % ws;
  const float* a_row = windows + slot * C;
  const float* s_row = shortcut + token * C;
  float* x_row = x_new + token * C;
  float* y_row = y + token * C;

  float sum = 0.f, sq = 0.f;
  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(a_row + c));
      const float4 s = __ldg(reinterpret_cast<const float4*>(s_row + c));
      const float4 v = make_float4(s.x + a.x, s.y + a.y, s.z + a.z, s.w + a.w);
      *reinterpret_cast<float4*>(x_row + c) = v;
      sum += (v.x + v.y) + (v.z + v.w);
      sq += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = __ldg(s_row + c) + __ldg(a_row + c);
      x_row[c] = v;
      sum += v;
      sq += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mu = sum / C;
  const float var = fmaxf(sq / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);

  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(a_row + c));
      const float4 s = __ldg(reinterpret_cast<const float4*>(s_row + c));
      const float4 g = __ldg(reinterpret_cast<const float4*>(scale + c));
      const float4 o = __ldg(reinterpret_cast<const float4*>(bias + c));
      *reinterpret_cast<float4*>(y_row + c) = make_float4(
          ((s.x + a.x) - mu) * (rstd * g.x) + o.x, ((s.y + a.y) - mu) * (rstd * g.y) + o.y,
          ((s.z + a.z) - mu) * (rstd * g.z) + o.z, ((s.w + a.w) - mu) * (rstd * g.w) + o.w);
    }
  } else {
    for (int c = lane; c < C; c += 32)
      y_row[c] = ((__ldg(s_row + c) + __ldg(a_row + c)) - mu) * (rstd * scale[c]) + bias[c];
  }
}

}  // namespace

// windows (batch*nW, ws, ws, C), shortcut (batch, H, W, C), scale, bias (C,)
// -> x_new, y (batch, H, W, C). Neither output may alias an input.
extern "C" int mia_unpartition_add_ln_f32(const void* windows, const void* shortcut,
                                          const void* scale, const void* bias, void* x_new, void* y,
                                          int batch, int H, int W, int C, int ws, float eps,
                                          void* stream) {
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tokens = static_cast<long long>(batch) * H * W;
  if (tokens == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const int nwx = (W + ws - 1) / ws;
  const int nw = nwx * ((H + ws - 1) / ws);
  const unsigned blocks = static_cast<unsigned>((tokens + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* win = static_cast<const float*>(windows);
  const float* sc = static_cast<const float*>(shortcut);
  const float* g = static_cast<const float*>(scale);
  const float* o = static_cast<const float*>(bias);
  float* xn = static_cast<float*>(x_new);
  float* yo = static_cast<float*>(y);
  if (C % 4 == 0) {
    unpartition_add_ln_kernel<true><<<blocks, kWarps * 32, 0, s>>>(win, sc, g, o, xn, yo, tokens,
                                                                   H, W, C, ws, nwx, nw, eps);
  } else {
    unpartition_add_ln_kernel<false><<<blocks, kWarps * 32, 0, s>>>(win, sc, g, o, xn, yo, tokens,
                                                                    H, W, C, ws, nwx, nw, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
