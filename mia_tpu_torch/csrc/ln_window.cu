// K4 on Hopper: LayerNorm fused with the window partition, in float32.
//
// Replaces the TPU kernel mia_tpu/ops/ln_window.py::ln_window_partition
// (_fwd_kernel). For x (B, H, W, C) it writes the windowed tensor
// (B*nW, ws, ws, C), nW = ceil(H/ws) * ceil(W/ws), in window_partition's
// order, with each real token normalised the way flax's LayerNorm does it:
//
//   mu = E[x],  var = max(E[x^2] - mu^2, 0)          (fast variance)
//   y  = (x - mu) * (rsqrt(var + eps) * scale) + bias
//
// and pad slots (grid positions past H or W) written as exact zeros, which
// is what the reference's pad-after-LayerNorm partition produces; the
// attention kernels then see the pad tokens' k and v as the qkv bias.
//
// The TPU kernel reads window-row bands and carves tiles with static slices
// because Mosaic cannot reshape a 14-row tile. Here each output token is
// one warp: it gathers its source row (C floats, 16-byte loads), reduces
// sum and sum of squares with warp shuffles, and writes the normalised row.
// The second pass over the row reads it again from L1.
//
// Bound: memory. At ViT-B/512 (B=1, 32x32x768 -> 9x14x14x768) it reads
// 3.1 MB and writes 5.4 MB, about 2.5 us at 3.35 TB/s; launch overhead is of
// the same order.
//
// The kernel allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output tokens per block

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32) ln_window_partition_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ out, long long tokens, int H, int W,
    int C, int ws, int nwx, int nw, float eps) {
  const int lane = threadIdx.x & 31;
  const long long token = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (token >= tokens) return;

  const int per_win = ws * ws;
  const long long win = token / per_win;
  const int r = static_cast<int>(token - win * per_win);
  const int b = static_cast<int>(win / nw);
  const int wi = static_cast<int>(win - static_cast<long long>(b) * nw);
  const int y = (wi / nwx) * ws + r / ws;
  const int xx = (wi % nwx) * ws + r % ws;
  float* dst = out + token * C;

  if (y >= H || xx >= W) {  // pad slot
    if (kVec4) {
      for (int c = lane * 4; c < C; c += 128)
        *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    }
    return;
  }
  const float* src = x + ((static_cast<long long>(b) * H + y) * W + xx) * C;

  float sum = 0.f, sq = 0.f;
  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + c));
      sum += (v.x + v.y) + (v.z + v.w);
      sq += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = __ldg(src + c);
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
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + c));
      const float4 g = __ldg(reinterpret_cast<const float4*>(scale + c));
      const float4 o = __ldg(reinterpret_cast<const float4*>(bias + c));
      *reinterpret_cast<float4*>(dst + c) =
          make_float4((v.x - mu) * (rstd * g.x) + o.x, (v.y - mu) * (rstd * g.y) + o.y,
                      (v.z - mu) * (rstd * g.z) + o.z, (v.w - mu) * (rstd * g.w) + o.w);
    }
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = (__ldg(src + c) - mu) * (rstd * scale[c]) + bias[c];
  }
}

}  // namespace

// x (B, H, W, C) -> out (B*nW, ws, ws, C); scale and bias (C,).
extern "C" int mia_ln_window_partition_f32(const void* x, const void* scale, const void* bias,
                                           void* out, int B, int H, int W, int C, int ws,
                                           float eps, void* stream) {
  const int nwy = (H + ws - 1) / ws;
  const int nwx = (W + ws - 1) / ws;
  const long long tokens = static_cast<long long>(B) * nwy * nwx * ws * ws;
  if (tokens == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (tokens + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (vec4) {
    ln_window_partition_kernel<true><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        xf, sf, bf, of, tokens, H, W, C, ws, nwx, nwy * nwx, eps);
  } else {
    ln_window_partition_kernel<false><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        xf, sf, bf, of, tokens, H, W, C, ws, nwx, nwy * nwx, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
