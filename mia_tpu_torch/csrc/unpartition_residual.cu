// K9 on Hopper: window unpartition + residual add + LayerNorm, forward and
// backward, in float32.
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
// The kernels allocate nothing and do not synchronise; each C entry point
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
    float* __restrict__ y, float* __restrict__ mu_out, float* __restrict__ rstd_out,
    long long tokens, int H, int W, int C, int ws, int nwx, int nw, float eps) {
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
  if (mu_out != nullptr && lane == 0) {  // the backward's statistics, (B, H, W)
    mu_out[token] = mu;
    rstd_out[token] = rstd;
  }

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

// ---------------------------------------------------------------------------
// Backward. Replaces the TPU kernel
// mia_tpu/ops/unpartition_residual.py::_bwd_impl (_bwd_kernel): from x_new
// and the saved per-token mu and rstd,
//
//   g = dy * scale,  xhat = (x_new - mu) * rstd,
//   total = dx_new + rstd * (g - mean(g) - xhat * mean(g * xhat))
//
// where dx_new is the residual stream's cotangent and dy that of the
// normalised output. total is written twice: in grid layout (the shortcut's
// cotangent) and carved into the window layout (the windows' cotangent),
// with exact zeros at the pad slots, which is what the unpartition's slice
// VJP gives. One warp per window slot, as K4's forward: a pad slot writes
// its zeros, a real slot reads its token's three rows and writes both
// copies. dscale = sum(dy * xhat) and dbias = sum(dy) over tokens are a
// second, optional pass (norm2 is frozen under LoRA): per-chunk partial sums
// over a fixed token range, one thread per channel, then a reduction of the
// partials in a fixed order, as K4b's.
// Bound: bytes. x_new, dx_new and dy are read once and total written once in
// each layout.
// ---------------------------------------------------------------------------

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32) unpartition_add_ln_bwd_kernel(
    const float* __restrict__ x_new, const float* __restrict__ dx_new,
    const float* __restrict__ dy, const float* __restrict__ mu, const float* __restrict__ rstd,
    const float* __restrict__ scale, float* __restrict__ dsc, float* __restrict__ dwin,
    long long slots, int H, int W, int C, int ws, int nwx, int nw) {
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (slot >= slots) return;

  const int per_win = ws * ws;
  const long long win = slot / per_win;
  const int r_in = static_cast<int>(slot - win * per_win);
  const int b = static_cast<int>(win / nw);
  const int wi = static_cast<int>(win - static_cast<long long>(b) * nw);
  const int gy = (wi / nwx) * ws + r_in / ws;
  const int gx = (wi % nwx) * ws + r_in % ws;
  float* wr = dwin + slot * C;

  if (gy >= H || gx >= W) {  // pad slot: the unpartition dropped it
    if (kVec4) {
      for (int c = lane * 4; c < C; c += 128)
        *reinterpret_cast<float4*>(wr + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = lane; c < C; c += 32) wr[c] = 0.f;
    }
    return;
  }
  const long long token = (static_cast<long long>(b) * H + gy) * W + gx;
  const float* xr = x_new + token * C;
  const float* dxr = dx_new + token * C;
  const float* dyr = dy + token * C;
  float* sr = dsc + token * C;
  const float m = __ldg(mu + token);
  const float r = __ldg(rstd + token);

  float sg = 0.f, sgx = 0.f;
  if (kVec4) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
      const float4 d = __ldg(reinterpret_cast<const float4*>(dyr + c));
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + c));
      const float g0 = d.x * s.x, g1 = d.y * s.y, g2 = d.z * s.z, g3 = d.w * s.w;
      sg += (g0 + g1) + (g2 + g3);
      sgx += (g0 * ((v.x - m) * r) + g1 * ((v.y - m) * r)) +
             (g2 * ((v.z - m) * r) + g3 * ((v.w - m) * r));
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float g = __ldg(dyr + c) * __ldg(scale + c);
      sg += g;
      sgx += g * ((__ldg(xr + c) - m) * r);
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
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
      const float4 d = __ldg(reinterpret_cast<const float4*>(dyr + c));
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + c));
      const float4 e = __ldg(reinterpret_cast<const float4*>(dxr + c));
      const float4 total = make_float4(e.x + r * (d.x * s.x - m1 - (v.x - m) * r * m2),
                                       e.y + r * (d.y * s.y - m1 - (v.y - m) * r * m2),
                                       e.z + r * (d.z * s.z - m1 - (v.z - m) * r * m2),
                                       e.w + r * (d.w * s.w - m1 - (v.w - m) * r * m2));
      *reinterpret_cast<float4*>(sr + c) = total;
      *reinterpret_cast<float4*>(wr + c) = total;
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float total = __ldg(dxr + c) + r * (__ldg(dyr + c) * __ldg(scale + c) - m1 -
                                                (__ldg(xr + c) - m) * r * m2);
      sr[c] = total;
      wr[c] = total;
    }
  }
}

constexpr int kParamChunks = 256;  // token chunks of the dscale/dbias partial sums

// partial[chunk, c] = sum over the chunk's tokens of dy * xhat (and dy)
__global__ void unpartition_add_ln_params_partial_kernel(
    const float* __restrict__ x_new, const float* __restrict__ dy, const float* __restrict__ mu,
    const float* __restrict__ rstd, float* __restrict__ part_scale, float* __restrict__ part_bias,
    long long tokens, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (c >= C) return;
  const long long per = (tokens + kParamChunks - 1) / kParamChunks;
  const long long t0 = chunk * per;
  const long long t1 = min(tokens, t0 + per);
  float ss = 0.f, sb = 0.f;
  for (long long tok = t0; tok < t1; ++tok) {
    const float d = __ldg(dy + tok * C + c);
    ss += d * ((__ldg(x_new + tok * C + c) - __ldg(mu + tok)) * __ldg(rstd + tok));
    sb += d;
  }
  part_scale[static_cast<long long>(chunk) * C + c] = ss;
  part_bias[static_cast<long long>(chunk) * C + c] = sb;
}

__global__ void unpartition_add_ln_params_reduce_kernel(const float* __restrict__ part_scale,
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

}  // namespace

// windows (batch*nW, ws, ws, C), shortcut (batch, H, W, C), scale, bias (C,)
// -> x_new, y (batch, H, W, C). Neither output may alias an input. mu and
// rstd, when not null, receive the per-token statistics (batch, H, W) for the
// backward.
extern "C" int mia_unpartition_add_ln_f32(const void* windows, const void* shortcut,
                                          const void* scale, const void* bias, void* x_new, void* y,
                                          void* mu, void* rstd, int batch, int H, int W, int C,
                                          int ws, float eps, void* stream) {
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
  float* mo = static_cast<float*>(mu);
  float* ro = static_cast<float*>(rstd);
  if (C % 4 == 0) {
    unpartition_add_ln_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        win, sc, g, o, xn, yo, mo, ro, tokens, H, W, C, ws, nwx, nw, eps);
  } else {
    unpartition_add_ln_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        win, sc, g, o, xn, yo, mo, ro, tokens, H, W, C, ws, nwx, nw, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: x_new, dx_new, dy (batch, H, W, C), mu and rstd (batch, H, W),
// scale (C,) -> dsc (batch, H, W, C), the shortcut's cotangent, and dwin
// (batch*nW, ws, ws, C), the windows' cotangent with zero pad slots. When
// dscale is not null, dscale and dbias (C,) are written too, with part
// (2 * 256 * C floats) as scratch. No output may alias an input.
extern "C" int mia_unpartition_add_ln_bwd_f32(const void* x_new, const void* dx_new,
                                              const void* dy, const void* mu, const void* rstd,
                                              const void* scale, void* dsc, void* dwin,
                                              void* dscale, void* dbias, void* part, int batch,
                                              int H, int W, int C, int ws, void* stream) {
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaSuccess);
  const int nwx = (W + ws - 1) / ws;
  const int nw = nwx * ((H + ws - 1) / ws);
  const long long tokens = static_cast<long long>(batch) * H * W;
  const long long slots = static_cast<long long>(batch) * nw * ws * ws;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x_new);
  const float* dyf = static_cast<const float*>(dy);
  const float* muf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  if (slots > 0) {
    const long long blocks = (slots + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const float* dxf = static_cast<const float*>(dx_new);
    const float* sf = static_cast<const float*>(scale);
    float* dscf = static_cast<float*>(dsc);
    float* dwf = static_cast<float*>(dwin);
    if (C % 4 == 0) {
      unpartition_add_ln_bwd_kernel<true><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
          xf, dxf, dyf, muf, rf, sf, dscf, dwf, slots, H, W, C, ws, nwx, nw);
    } else {
      unpartition_add_ln_bwd_kernel<false><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
          xf, dxf, dyf, muf, rf, sf, dscf, dwf, slots, H, W, C, ws, nwx, nw);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dscale == nullptr) return static_cast<int>(cudaSuccess);
  float* ps = static_cast<float*>(part);
  float* pb = ps + static_cast<long long>(kParamChunks) * C;
  const dim3 grid((C + 127) / 128, kParamChunks);
  unpartition_add_ln_params_partial_kernel<<<grid, 128, 0, s>>>(xf, dyf, muf, rf, ps, pb, tokens,
                                                                C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpartition_add_ln_params_reduce_kernel<<<(C + 127) / 128, 128, 0, s>>>(
      ps, pb, static_cast<float*>(dscale), static_cast<float*>(dbias), C);
  return static_cast<int>(cudaGetLastError());
}
