// K4 on Hopper: LayerNorm fused with the window partition, for float32 or
// bfloat16 x and windows (float32 scale, bias, statistics and arithmetic).
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
// The bfloat16 instance (mia_ln_window_partition_bf16, the forward of a
// bfloat16 encoder) reads x in bfloat16, computes exactly the float32
// arithmetic above and rounds each output once to bfloat16, as the Pallas
// kernel's carve-and-cast; mu and rstd stay float32. Half the bytes of the
// float32 instance. Its backward, mia_ln_window_partition_bwd_bf16, is the
// backward kernel below with x, dy and dx in bfloat16.
//
// The kernel allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kWarps = 8;  // output tokens per block

template <bool kVec4, typename T>
__global__ void __launch_bounds__(kWarps * 32) ln_window_partition_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ mu_out,
    float* __restrict__ rstd_out, long long tokens, int H, int W, int C, int ws, int nwx, int nw,
    float eps) {
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
  T* dst = out + token * C;

  if (y >= H || xx >= W) {  // pad slot
    if (kVec4) {
      for (int c = lane * 4; c < C; c += 128) store4(dst + c, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = from_float<T>(0.f);
    }
    return;
  }
  const long long src_token = (static_cast<long long>(b) * H + y) * W + xx;
  const T* src = x + src_token * C;

  float sum = 0.f, sq = 0.f;
  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = load4(src + c);
      sum += (v.x + v.y) + (v.z + v.w);
      sq += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = to_float(__ldg(src + c));
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
  if (mu_out != nullptr && lane == 0) {  // the backward's statistics, (B, H, W)
    mu_out[src_token] = mu;
    rstd_out[src_token] = rstd;
  }

  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = load4(src + c);
      const float4 g = __ldg(reinterpret_cast<const float4*>(scale + c));
      const float4 o = __ldg(reinterpret_cast<const float4*>(bias + c));
      store4(dst + c,
             make_float4((v.x - mu) * (rstd * g.x) + o.x, (v.y - mu) * (rstd * g.y) + o.y,
                         (v.z - mu) * (rstd * g.z) + o.z, (v.w - mu) * (rstd * g.w) + o.w));
    }
  } else {
    for (int c = lane; c < C; c += 32)
      dst[c] = from_float<T>((to_float(__ldg(src + c)) - mu) * (rstd * scale[c]) + bias[c]);
  }
}

// One launch of the forward for x and out of element type T.
template <typename T>
int launch_ln_window_partition(const void* x, const void* scale, const void* bias, void* out,
                               void* mu, void* rstd, int B, int H, int W, int C, int ws,
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
  const T* xt = static_cast<const T*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  T* ot = static_cast<T*>(out);
  if (vec4) {
    ln_window_partition_kernel<true, T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        xt, sf, bf, ot, static_cast<float*>(mu), static_cast<float*>(rstd), tokens, H, W, C, ws,
        nwx, nwy * nwx, eps);
  } else {
    ln_window_partition_kernel<false, T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        xt, sf, bf, ot, static_cast<float*>(mu), static_cast<float*>(rstd), tokens, H, W, C, ws,
        nwx, nwy * nwx, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward. Replaces the TPU kernel mia_tpu/ops/ln_window.py::_bwd_impl
// (_bwd_kernel): from the saved per-token mu and rstd, the LayerNorm VJP
//
//   g = dy * scale,  xhat = (x - mu) * rstd,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
//
// with dy read from the token's window slot, so the pad slots' cotangents
// never reach dx. One warp per source token, as in the forward. dscale =
// sum(dy * xhat) and dbias = sum(dy) over tokens are a second, optional
// pass (the encoder's LayerNorms are frozen under LoRA): per-chunk partial
// sums over a fixed token range, one thread per channel, then a reduction
// of the partials in a fixed order, so the result is deterministic.
// Bound: memory, like the forward (x, dy and dx each cross device memory
// once per pass).
//
// The bfloat16 instance (T = __nv_bfloat16, the backward of a bfloat16
// encoder) reads x and dy in bfloat16, computes the same float32 arithmetic
// and rounds dx once to bfloat16, as the Pallas kernel's cast of its
// float32 dx; mu, rstd, scale, dscale and dbias stay float32, and the
// partial sums read the bfloat16 x and dy widened. Half the bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long window_slot(long long token, int H, int W, int ws, int nwx,
                                                 int nw) {
  const long long hw = static_cast<long long>(H) * W;
  const long long b = token / hw;
  const int rem = static_cast<int>(token - b * hw);
  const int y = rem / W;
  const int xx = rem - y * W;
  const long long win = b * nw + (y / ws) * nwx + xx / ws;
  return win * ws * ws + (y % ws) * ws + xx % ws;
}

template <bool kVec4, typename T>
__global__ void __launch_bounds__(kWarps * 32) ln_window_partition_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mu,
    const float* __restrict__ rstd, const float* __restrict__ scale, T* __restrict__ dx,
    long long tokens, int H, int W, int C, int ws, int nwx, int nw) {
  const int lane = threadIdx.x & 31;
  const long long token = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (token >= tokens) return;
  const T* xr = x + token * C;
  const T* dyr = dy + window_slot(token, H, W, ws, nwx, nw) * C;
  T* dxr = dx + token * C;
  const float m = __ldg(mu + token);
  const float r = __ldg(rstd + token);

  float sg = 0.f, sgx = 0.f;
  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = load4(xr + c);
      const float4 d = load4(dyr + c);
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + c));
      const float g0 = d.x * s.x, g1 = d.y * s.y, g2 = d.z * s.z, g3 = d.w * s.w;
      sg += (g0 + g1) + (g2 + g3);
      sgx += (g0 * ((v.x - m) * r) + g1 * ((v.y - m) * r)) +
             (g2 * ((v.z - m) * r) + g3 * ((v.w - m) * r));
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float g = ldg_float(dyr + c) * __ldg(scale + c);
      sg += g;
      sgx += g * ((ldg_float(xr + c) - m) * r);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sg += __shfl_xor_sync(0xffffffffu, sg, off);
    sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
  }
  const float m1 = sg / C;
  const float m2 = sgx / C;
  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = load4(xr + c);
      const float4 d = load4(dyr + c);
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + c));
      store4(dxr + c, make_float4(r * (d.x * s.x - m1 - (v.x - m) * r * m2),
                                  r * (d.y * s.y - m1 - (v.y - m) * r * m2),
                                  r * (d.z * s.z - m1 - (v.z - m) * r * m2),
                                  r * (d.w * s.w - m1 - (v.w - m) * r * m2)));
    }
  } else {
    for (int c = lane; c < C; c += 32)
      dxr[c] = from_float<T>(
          r * (ldg_float(dyr + c) * __ldg(scale + c) - m1 - (ldg_float(xr + c) - m) * r * m2));
  }
}

constexpr int kParamChunks = 256;  // token chunks of the dscale/dbias partial sums

// partial[chunk, c] = sum over the chunk's tokens of dy * xhat (and dy)
template <typename T>
__global__ void ln_window_partition_params_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mu,
    const float* __restrict__ rstd, float* __restrict__ part_scale, float* __restrict__ part_bias,
    long long tokens, int H, int W, int C, int ws, int nwx, int nw) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (c >= C) return;
  const long long per = (tokens + kParamChunks - 1) / kParamChunks;
  const long long t0 = chunk * per;
  const long long t1 = min(tokens, t0 + per);
  float ss = 0.f, sb = 0.f;
  for (long long tok = t0; tok < t1; ++tok) {
    const float d = ldg_float(dy + window_slot(tok, H, W, ws, nwx, nw) * C + c);
    ss += d * ((ldg_float(x + tok * C + c) - __ldg(mu + tok)) * __ldg(rstd + tok));
    sb += d;
  }
  part_scale[static_cast<long long>(chunk) * C + c] = ss;
  part_bias[static_cast<long long>(chunk) * C + c] = sb;
}

__global__ void ln_window_partition_params_reduce_kernel(const float* __restrict__ part_scale,
                                                         const float* __restrict__ part_bias,
                                                         float* __restrict__ dscale,
                                                         float* __restrict__ dbias, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float ss = 0.f, sb = 0.f;
  for (int k = 0; k < kParamChunks; ++k) {
    ss += part_scale[static_cast<long long>(k) * C + c];
    sb += part_bias[static_cast<long long>(k) * C + c];
  }
  dscale[c] = ss;
  dbias[c] = sb;
}

// One launch of the backward for x, dy and dx of element type T (see the
// C entries below).
template <typename T>
int launch_ln_window_partition_bwd(const void* x, const void* dy, const void* mu,
                                   const void* rstd, const void* scale, void* dx, void* dscale,
                                   void* dbias, void* part, int B, int H, int W, int C, int ws,
                                   void* stream) {
  const int nwy = (H + ws - 1) / ws;
  const int nwx = (W + ws - 1) / ws;
  const long long tokens = static_cast<long long>(B) * H * W;
  if (C == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* muf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  if (tokens > 0) {
    const long long blocks = (tokens + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(scale) % 16 == 0;
    if (vec4) {
      ln_window_partition_bwd_kernel<true, T>
          <<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
              xt, dyt, muf, rf, static_cast<const float*>(scale), static_cast<T*>(dx), tokens, H,
              W, C, ws, nwx, nwy * nwx);
    } else {
      ln_window_partition_bwd_kernel<false, T>
          <<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
              xt, dyt, muf, rf, static_cast<const float*>(scale), static_cast<T*>(dx), tokens, H,
              W, C, ws, nwx, nwy * nwx);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dscale == nullptr) return static_cast<int>(cudaSuccess);
  float* ps = static_cast<float*>(part);
  float* pb = ps + static_cast<long long>(kParamChunks) * C;
  const dim3 grid((C + 127) / 128, kParamChunks);
  ln_window_partition_params_partial_kernel<T><<<grid, 128, 0, s>>>(
      xt, dyt, muf, rf, ps, pb, tokens, H, W, C, ws, nwx, nwy * nwx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_window_partition_params_reduce_kernel<<<(C + 127) / 128, 128, 0, s>>>(
      ps, pb, static_cast<float*>(dscale), static_cast<float*>(dbias), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, C) -> out (B*nW, ws, ws, C); scale and bias (C,). mu and rstd,
// when not null, receive the per-token statistics (B, H, W) for the backward.
extern "C" int mia_ln_window_partition_f32(const void* x, const void* scale, const void* bias,
                                           void* out, void* mu, void* rstd, int B, int H, int W,
                                           int C, int ws, float eps, void* stream) {
  return launch_ln_window_partition<float>(x, scale, bias, out, mu, rstd, B, H, W, C, ws, eps,
                                           stream);
}

// The same with x and out in bfloat16 (scale, bias, mu and rstd float32).
extern "C" int mia_ln_window_partition_bf16(const void* x, const void* scale, const void* bias,
                                            void* out, void* mu, void* rstd, int B, int H, int W,
                                            int C, int ws, float eps, void* stream) {
  return launch_ln_window_partition<bf16>(x, scale, bias, out, mu, rstd, B, H, W, C, ws, eps,
                                          stream);
}

// Backward: x (B, H, W, C), dy (B*nW, ws, ws, C), mu and rstd (B, H, W),
// scale (C,) -> dx (B, H, W, C). When dscale is not null, dscale and dbias
// (C,) are written too, with part (2 * 256 * C floats) as scratch.
extern "C" int mia_ln_window_partition_bwd_f32(const void* x, const void* dy, const void* mu,
                                               const void* rstd, const void* scale, void* dx,
                                               void* dscale, void* dbias, void* part, int B, int H,
                                               int W, int C, int ws, void* stream) {
  return launch_ln_window_partition_bwd<float>(x, dy, mu, rstd, scale, dx, dscale, dbias, part, B,
                                               H, W, C, ws, stream);
}

// The same with x, dy and dx in bfloat16 (mu, rstd, scale, dscale, dbias
// and part float32).
extern "C" int mia_ln_window_partition_bwd_bf16(const void* x, const void* dy, const void* mu,
                                                const void* rstd, const void* scale, void* dx,
                                                void* dscale, void* dbias, void* part, int B,
                                                int H, int W, int C, int ws, void* stream) {
  return launch_ln_window_partition_bwd<bf16>(x, dy, mu, rstd, scale, dx, dscale, dbias, part, B,
                                              H, W, C, ws, stream);
}
