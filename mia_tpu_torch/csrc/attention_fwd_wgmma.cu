// The C entry of the warpgroup forward of K3 and K6 in bfloat16
// (attention_fwd_wgmma.cuh): the tensor maps its TMA copies read, the
// launch, and the rule for which calls it takes. A source of its own, so
// that nvcc builds its kernel beside attention_rel.cu's, whose bfloat16
// forward entries call it.

#include "attention_fwd_wgmma.cuh"

namespace {

// maps: q, k, v
template <int kAug>
int launch_fwd_wgmma(const Bf16FwdArgs& a, const CUtensorMap (&maps)[3], int batch,
                     cudaStream_t s) {
  const dim3 grid((a.n + kWgRows - 1) / kWgRows, a.heads, batch);
  auto kernel = attention_fwd_wgmma_kernel<kAug>;
  constexpr size_t smem = wg_fwd_smem_bytes();
  const cudaError_t err = allow_wg_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kWgThreads, smem, s>>>(a, maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whether the warpgroup forward takes a bfloat16 K3 / K6 call: head dim 64
// and at most 64 rel columns (kh + kw), the backward's rule; others run
// attention_fwd_tc.cuh's bfloat16 instance.
extern "C" int mia_attention_rel_fwd_wgmma_takes(int d, int kh, int kw) {
  return d == kWgD && kh + kw <= 64;
}

// K3 / K6 in bfloat16 for a call the rule above takes. q, k, v: the first
// column of head 0's q, k and v (packed: qkv, qkv + heads*64, qkv +
// 2*heads*64; head-major: q, k, v with heads = 1), rows in_stride elements
// apart; out rows out_stride apart; rel_h (batch * heads, n, kh), rel_w
// (.., kw); lse (batch * heads, n) float32, or null. batch images of n =
// kh * kw tokens.
extern "C" int mia_attention_rel_fwd_wgmma_bf16(const void* q, const void* k, const void* v,
                                                const void* rel_h, const void* rel_w, void* out,
                                                void* lse, long long in_stride,
                                                long long out_stride, int batch, int n, int heads,
                                                int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (!mia_attention_rel_fwd_wgmma_takes(kWgD, kh, kw) || n != kh * kw)
    return static_cast<int>(cudaErrorInvalidValue);
  Bf16FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.rel_a = static_cast<const bf16*>(rel_h);
  a.rel_b = static_cast<const bf16*>(rel_w);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.in_stride = in_stride;
  a.out_stride = out_stride;
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  // q (64-row boxes), k, v (128-row boxes): 64-column boxes of heads * 64 columns, 128-byte swizzle
  CUtensorMap maps[3];
  const long long rows = static_cast<long long>(batch) * n;
  const long long hd = static_cast<long long>(heads) * kWgD;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tile_map(&maps[0], q, hd, rows, in_stride, 64, kWgRows, kSw) ||
      !tile_map(&maps[1], k, hd, rows, in_stride, 64, kKeyTile, kSw) ||
      !tile_map(&maps[2], v, hd, rows, in_stride, 64, kKeyTile, kSw))
    return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kh + kw <= 32 ? launch_fwd_wgmma<96>(a, maps, batch, s)
                       : launch_fwd_wgmma<128>(a, maps, batch, s);
}
