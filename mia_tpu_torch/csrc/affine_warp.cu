// K1 on Hopper: nearest affine warp with split rounding, as a direct gather.
//
// Replaces the TPU kernel mia_tpu/ops/warp.py::affine_warp_pallas
// (_warp_pallas_kernel). That kernel barrel-shifts rows and columns and
// applies shared one-hot matmuls because a TPU has no fast per-element
// gather. On Hopper the same semantics are one gather per output pixel:
//
//   r = m2[b,o] + us[b,x]          source row     (zero if r outside [0, H))
//   s = m1[b,x] + ts[b,r]          source column  (zero if s outside [0, W))
//   out[b,o,x,:] = img[b,r,s,:]
//
// with the four int32 index vectors computed once per sample by
// mia_tpu_torch/ops/warp.py::_warp_shift2pass_indices, shared with the plain
// PyTorch version, so kernel and plain version agree bit for bit.
//
// Bound: memory. One thread per output pixel (b, o, x) copies its C floats;
// at the FUGC train step (B=12, 256x256, C=3+1 image+label stack) that is
// 12.6 MB read and 12.6 MB written, about 8 us at 3.35 TB/s, so the launch
// dominates. C=4 moves as one 16-byte load and store per thread; other C
// take a scalar loop. Neighbouring threads own neighbouring x, so stores are
// coalesced and loads stay within a few source rows for the small rotations
// and scales of the FUGC recipe.
//
// The kernel allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kVec4>
__global__ void affine_warp_shift2pass_kernel(
    const float* __restrict__ img, const int32_t* __restrict__ ts,
    const int32_t* __restrict__ m1, const int32_t* __restrict__ us,
    const int32_t* __restrict__ m2, float* __restrict__ out, int B, int H,
    int W, int C) {
  const long long total = static_cast<long long>(B) * H * W;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < total; p += stride) {
    const int x = static_cast<int>(p % W);
    const long long bo = p / W;
    const int o = static_cast<int>(bo % H);
    const int b = static_cast<int>(bo / H);
    const long long row_base = static_cast<long long>(b) * H;
    const long long col_base = static_cast<long long>(b) * W;

    const int r = m2[row_base + o] + us[col_base + x];
    bool valid = r >= 0 && r < H;
    int s = 0;
    if (valid) {
      s = m1[col_base + x] + ts[row_base + r];
      valid = s >= 0 && s < W;
    }
    const long long src = (row_base + r) * W + s;  // pixel index, if valid

    if (kVec4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) v = reinterpret_cast<const float4*>(img)[src];
      reinterpret_cast<float4*>(out)[p] = v;
    } else {
      float* dst = out + p * C;
      if (valid) {
        const float* from = img + src * C;
        for (int c = 0; c < C; ++c) dst[c] = from[c];
      } else {
        for (int c = 0; c < C; ++c) dst[c] = 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int mia_affine_warp_shift2pass_f32(
    const void* img, const void* ts, const void* m1, const void* us,
    const void* m2, void* out, int B, int H, int W, int C, void* stream) {
  const long long total = static_cast<long long>(B) * H * W;
  if (total == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride loop covers the rest
  const bool vec4 = C == 4 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* img_f = static_cast<const float*>(img);
  const int32_t* ts_i = static_cast<const int32_t*>(ts);
  const int32_t* m1_i = static_cast<const int32_t*>(m1);
  const int32_t* us_i = static_cast<const int32_t*>(us);
  const int32_t* m2_i = static_cast<const int32_t*>(m2);
  float* out_f = static_cast<float*>(out);
  if (vec4) {
    affine_warp_shift2pass_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        img_f, ts_i, m1_i, us_i, m2_i, out_f, B, H, W, C);
  } else {
    affine_warp_shift2pass_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        img_f, ts_i, m1_i, us_i, m2_i, out_f, B, H, W, C);
  }
  return static_cast<int>(cudaGetLastError());
}
