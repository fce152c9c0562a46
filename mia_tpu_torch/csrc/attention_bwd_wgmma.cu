// The C entries of the warpgroup backward in bfloat16
// (attention_bwd_wgmma.cuh): K3b and K6b, and K8b's window instance; the
// tensor maps their TMA copies read, the launches of passes A and B, and
// the rules for which calls they take. A source of its own, so that nvcc
// builds its kernels beside attention_rel.cu's and attention_routes.cu's,
// whose bfloat16 backward entries call it.

#include "attention_bwd_wgmma.cuh"

namespace {

// maps: q, k, v, g, rel_h, rel_w (the last two read only by kRelBoxes)
template <int kAug, int kRel>
int launch_bwd_wgmma(const Bf16BwdArgs& a, const CUtensorMap (&maps)[6], int batch,
                     cudaStream_t s) {
  const dim3 grid((a.n + kWgRows - 1) / kWgRows, a.heads, batch);
  auto ka_kernel = attention_bwd_wgmma_dq_kernel<kAug>;
  auto kb_kernel = attention_bwd_wgmma_dkv_kernel<kAug, kRel>;
  constexpr size_t smem_a = wg_dq_smem_bytes<kAug>();
  constexpr size_t smem_b = wg_dkv_smem_bytes<kAug>();
  cudaError_t err = allow_wg_smem(ka_kernel, smem_a);
  if (err == cudaSuccess) err = allow_wg_smem(kb_kernel, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_kernel<<<grid, kWgThreads, smem_a, s>>>(a, maps[0], maps[1], maps[2], maps[3]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_kernel<<<grid, kWgThreads, smem_b, s>>>(a, maps[0], maps[1], maps[2], maps[3], maps[4],
                                             maps[5]);
  return static_cast<int>(cudaGetLastError());
}

// Passes A and B over `batch` images of `a`. maps: q, k, v and g built by the
// caller; rel_h's and rel_w's are built here (batch * heads * n rows) when kh
// and kw are multiples of 8. kAug 96 for kh + kw <= 32, else 128.
int dispatch_bwd_wgmma(const Bf16BwdArgs& a, CUtensorMap (&maps)[6], int batch,
                       cudaStream_t s) {
  const int kh = a.kh, kw = a.kw;
  int mode = kh % 2 == 0 && kw % 2 == 0 ? kRelPairs : kRelPlain;
  if (kh % 8 == 0 && kw % 8 == 0) {
    const long long rows = static_cast<long long>(batch) * a.heads * a.n;
    if (!tile_map(&maps[4], a.rel_a, kh, rows, kh) || !tile_map(&maps[5], a.rel_b, kw, rows, kw))
      return static_cast<int>(cudaErrorNotSupported);
    mode = kRelBoxes;
  } else {
    maps[4] = maps[5] = maps[0];  // unread
  }
  if (kh + kw <= 32) {
    switch (mode) {
      case kRelBoxes: return launch_bwd_wgmma<96, kRelBoxes>(a, maps, batch, s);
      case kRelPairs: return launch_bwd_wgmma<96, kRelPairs>(a, maps, batch, s);
      default: return launch_bwd_wgmma<96, kRelPlain>(a, maps, batch, s);
    }
  }
  switch (mode) {
    case kRelBoxes: return launch_bwd_wgmma<128, kRelBoxes>(a, maps, batch, s);
    case kRelPairs: return launch_bwd_wgmma<128, kRelPairs>(a, maps, batch, s);
    default: return launch_bwd_wgmma<128, kRelPlain>(a, maps, batch, s);
  }
}

}  // namespace

// Whether the warpgroup backward takes a bfloat16 K3b / K6b call: head dim 64
// and at most 64 rel columns (kh + kw); others run attention_bwd_tc.cuh's
// bfloat16 instance.
extern "C" int mia_attention_rel_bwd_wgmma_takes(int d, int kh, int kw) {
  return d == kWgD && kh + kw <= 64;
}

// K3b / K6b in bfloat16 for a call the rule above takes. q, k, v: the first
// column of head 0's q, k and v (packed: qkv, qkv + heads*64, qkv +
// 2*heads*64; head-major: q, k, v with heads = 1), rows in_stride elements
// apart, as are dq, dk, dv; out and g rows out_stride apart; rel_h (batch *
// heads, n, kh), rel_w (.., kw) and their gradients; lse and the delta
// scratch (batch * heads, n) float32. batch images of n = kh * kw tokens.
extern "C" int mia_attention_rel_bwd_wgmma_bf16(
    const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
    const void* out, const void* g, const void* lse, void* dq, void* dk, void* dv, void* delta,
    void* drel_h, void* drel_w, long long in_stride, long long out_stride, int batch, int n,
    int heads, int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (!mia_attention_rel_bwd_wgmma_takes(kWgD, kh, kw) || n != kh * kw)
    return static_cast<int>(cudaErrorInvalidValue);
  Bf16BwdArgs a{};
  a.rel_a = static_cast<const bf16*>(rel_h);
  a.rel_b = static_cast<const bf16*>(rel_w);
  a.out = static_cast<const bf16*>(out);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.delta = static_cast<float*>(delta);
  a.drel_a = static_cast<bf16*>(drel_h);
  a.drel_b = static_cast<bf16*>(drel_w);
  a.in_stride = in_stride;
  a.out_stride = out_stride;
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  CUtensorMap maps[6];  // q, k, v, g (heads * 64 columns of their rows); rel_h, rel_w
  const long long rows = static_cast<long long>(batch) * n;
  const long long hd = static_cast<long long>(heads) * kWgD;
  if (!tile_map(&maps[0], q, hd, rows, in_stride) || !tile_map(&maps[1], k, hd, rows, in_stride) ||
      !tile_map(&maps[2], v, hd, rows, in_stride) || !tile_map(&maps[3], g, hd, rows, out_stride))
    return static_cast<int>(cudaErrorNotSupported);
  return dispatch_bwd_wgmma(a, maps, batch, static_cast<cudaStream_t>(stream));
}

// Whether the warpgroup backward takes a bfloat16 K8b call: head dim 64 and
// ws x ws windows of at most 200 slots (four 64-slot tiles, q_aug of 96
// columns: 2 ws <= 32), the forward's rule. Others (head dim 80) run
// attention_bwd_tc.cuh's bfloat16 window instance.
extern "C" int mia_attention_rel_win_bwd_wgmma_takes(int d, int ws) {
  return d == kWgD && ws > 0 && ws * ws <= 200 && 2 * ws <= kWinAug - kWgD;
}

// K8b in bfloat16 for a call the rule above takes, passes A and B (the pad
// reduce is the caller's): qkv (batch, hg, wg, 3*heads*64); rel_h, rel_w
// (batch*heads, hg, wg, ws) and their gradients; bias_kv (3, heads*64);
// out and g (batch, hg, wg, heads*64); lse and the delta scratch
// (batch*heads, hg*wg) float32; dqkv of qkv's shape; dpad (batch * windows
// * ceil(ws*ws / 64), 2, heads*64) float32, one partial row a (window, key
// tile). q, k, v and g land by 4D boxes of 8 columns over the token grid.
extern "C" int mia_attention_rel_win_bwd_wgmma_bf16(
    const void* qkv, const void* rel_h, const void* rel_w, const void* bias_kv, const void* out,
    const void* g, const void* lse, void* dqkv, void* delta, void* drel_h, void* drel_w,
    void* dpad, int batch, int hg, int wg, int heads, int ws, float scale, void* stream) {
  if (batch == 0 || hg == 0 || wg == 0) return static_cast<int>(cudaSuccess);
  if (!mia_attention_rel_win_bwd_wgmma_takes(kWgD, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hd = static_cast<long long>(heads) * kWgD;
  const bf16* base = static_cast<const bf16*>(qkv);
  bf16* dbase = static_cast<bf16*>(dqkv);
  Bf16BwdArgs a{};
  a.q = base;
  a.k = base + hd;
  a.v = base + 2 * hd;
  a.rel_a = static_cast<const bf16*>(rel_h);
  a.rel_b = static_cast<const bf16*>(rel_w);
  a.pad_kv = static_cast<const bf16*>(bias_kv);
  a.out = static_cast<const bf16*>(out);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.dq = dbase;
  a.dk = dbase + hd;
  a.dv = dbase + 2 * hd;
  a.delta = static_cast<float*>(delta);
  a.drel_a = static_cast<bf16*>(drel_h);
  a.drel_b = static_cast<bf16*>(drel_w);
  a.dpad = static_cast<float*>(dpad);
  a.in_stride = 3 * hd;
  a.out_stride = hd;
  a.heads = heads;
  set_grid(a, hg, wg, ws);
  a.scale = scale;
  CUtensorMap maps[4];  // q, k, v, g: 8-column boxes of a window's ws x ws tokens, no swizzle
  constexpr CUtensorMapSwizzle kNone = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!grid_map(&maps[0], a.q, hd, a.in_stride, wg, hg, batch, ws, ws, 8, kNone) ||
      !grid_map(&maps[1], a.k, hd, a.in_stride, wg, hg, batch, ws, ws, 8, kNone) ||
      !grid_map(&maps[2], a.v, hd, a.in_stride, wg, hg, batch, ws, ws, 8, kNone) ||
      !grid_map(&maps[3], a.g, hd, a.out_stride, wg, hg, batch, ws, ws, 8, kNone))
    return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((a.n + kWgRows - 1) / kWgRows, heads, batch * a.nwin);
  auto ka_kernel = attention_bwd_wgmma_win_dq_kernel;
  auto kb_kernel = attention_bwd_wgmma_win_dkv_kernel;
  constexpr size_t smem_a = wg_win_dq_smem_bytes();
  constexpr size_t smem_b = wg_win_dkv_smem_bytes();
  cudaError_t err = allow_wg_smem(ka_kernel, smem_a);
  if (err == cudaSuccess) err = allow_wg_smem(kb_kernel, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_kernel<<<grid, kWgThreads, smem_a, s>>>(a, maps[1], maps[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_kernel<<<grid, kWgThreads, smem_b, s>>>(a, maps[0], maps[3]);
  return static_cast<int>(cudaGetLastError());
}
