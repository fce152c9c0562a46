// The C entries of the warpgroup forwards in bfloat16 (attention_fwd_wgmma.cuh):
// K3 and K6 (rel terms), K2 (the gathered tables), K7 (a dense float32
// bias) and K8 (windows carved from the token grid), the tensor maps their
// TMA copies read, the launches, and the rules for which calls they take. A
// source of its own, so that nvcc builds its kernels beside
// attention_rel.cu's and attention_routes.cu's, whose bfloat16 forward
// entries call it.

#include "attention_fwd_wgmma.cuh"

namespace {

template <typename Kernel>
int launch_wgmma(Kernel kernel, size_t smem, const Bf16FwdArgs& a, const CUtensorMap (&maps)[3],
                 int batch, cudaStream_t s) {
  const dim3 grid((a.n + kWgRows - 1) / kWgRows, a.heads, batch);
  const cudaError_t err = allow_wg_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kWgThreads, smem, s>>>(a, maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
}

// maps: q (64-row boxes), k and v (key_rows, v_rows): 64-column boxes of heads * 64 columns,
// 128-byte swizzle, over batch * n rows in_stride elements apart
bool qkv_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v,
              long long in_stride, int batch, int n, int heads, int key_rows, int v_rows) {
  const long long rows = static_cast<long long>(batch) * n;
  const long long hd = static_cast<long long>(heads) * kWgD;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  return tile_map(&maps[0], q, hd, rows, in_stride, 64, kWgRows, kSw) &&
         tile_map(&maps[1], k, hd, rows, in_stride, 64, key_rows, kSw) &&
         tile_map(&maps[2], v, hd, rows, in_stride, 64, v_rows, kSw);
}

Bf16FwdArgs wgmma_args(const void* q, const void* k, const void* v, void* out, void* lse,
                       long long in_stride, long long out_stride, int n, int heads, int kh,
                       int kw, float scale) {
  Bf16FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.in_stride = in_stride;
  a.out_stride = out_stride;
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  return a;
}

}  // namespace

// Whether the warpgroup forward takes a bfloat16 K3 / K6 call: head dim 64
// and at most 64 rel columns (kh + kw), the backward's rule; others run
// attention_fwd_tc.cuh's bfloat16 instance.
extern "C" int mia_attention_rel_fwd_wgmma_takes(int d, int kh, int kw) {
  return d == kWgD && kh + kw <= 64;
}

// Whether it takes a bfloat16 K2 call: head dim 64, a window of at most 200
// tokens (the one walk) with at most 32 rel columns (kh + kw: q_aug of 96),
// whose 64-query tiles read at most 280 table rows (the staging; every
// square window up to 14 x 14). Others run kernel R and attention_fwd_tc.cuh's
// bfloat16 instance.
extern "C" int mia_attention_rel_ik_fwd_wgmma_takes(int d, int n, int kh, int kw) {
  return d == kWgD && kh > 0 && kw > 0 && n == kh * kw && n <= kWinKeys && kh + kw <= 32 &&
         k2_stage_rows(n, kh, kw) <= kStageRows;
}

// Whether it takes a bfloat16 K7 call: head dim 64 and n % 4 == 0 (a float32
// bias row then starts 16-byte aligned, for the 16-byte copies of its
// tiles); one walk at n <= 200, two walks past it.
extern "C" int mia_attention_dense_fwd_wgmma_takes(int d, int n) {
  return d == kWgD && n > 0 && n % 4 == 0;
}

// Whether it takes a bfloat16 K8 call: head dim 64 and ws x ws windows of at
// most 200 slots (the one walk) with at most 32 rel columns (2 ws: q_aug of
// 96). Others (head dim 80) run attention_fwd_tc.cuh's bfloat16 instance.
extern "C" int mia_attention_rel_win_fwd_wgmma_takes(int d, int ws) {
  return d == kWgD && ws > 0 && ws * ws <= kWinKeys && 2 * ws <= 32;
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
  Bf16FwdArgs a = wgmma_args(q, k, v, out, lse, in_stride, out_stride, n, heads, kh, kw, scale);
  a.rel_a = static_cast<const bf16*>(rel_h);
  a.rel_b = static_cast<const bf16*>(rel_w);
  CUtensorMap maps[3];
  if (!qkv_maps(maps, q, k, v, in_stride, batch, n, heads, kKeyTile, kKeyTile))
    return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr size_t smem = wg_fwd_smem_bytes<false>();
  return kh + kw <= 32
             ? launch_wgmma(attention_fwd_wgmma_kernel<96, false>, smem, a, maps, batch, s)
             : launch_wgmma(attention_fwd_wgmma_kernel<128, false>, smem, a, maps, batch, s);
}

// K2 in bfloat16 for a call the K2 rule takes, in one launch: the arguments
// of the K3 entry with the gathered tables rh_flat ((n / kw) * kh, 64) and
// rw_flat (kw * kw, 64) in place of the rel terms, which the kernel forms.
extern "C" int mia_attention_rel_ik_fwd_wgmma_bf16(const void* q, const void* k, const void* v,
                                                   const void* rh_flat, const void* rw_flat,
                                                   void* out, void* lse, long long in_stride,
                                                   long long out_stride, int batch, int n,
                                                   int heads, int kh, int kw, float scale,
                                                   void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (!mia_attention_rel_ik_fwd_wgmma_takes(kWgD, n, kh, kw))
    return static_cast<int>(cudaErrorInvalidValue);
  Bf16FwdArgs a = wgmma_args(q, k, v, out, lse, in_stride, out_stride, n, heads, kh, kw, scale);
  a.rel_a = static_cast<const bf16*>(rh_flat);
  a.rel_b = static_cast<const bf16*>(rw_flat);
  CUtensorMap maps[3];
  if (!qkv_maps(maps, q, k, v, in_stride, batch, n, heads, kWinKeys, kWinVRows))
    return static_cast<int>(cudaErrorNotSupported);
  return launch_wgmma(attention_fwd_wgmma_window_kernel<kRelTables>,
                      wg_win_smem_bytes<kRelTables>(), a, maps, batch,
                      static_cast<cudaStream_t>(stream));
}

// K7 in bfloat16 for a call the K7 rule takes: q, k, v, out (bh, n, 64)
// bfloat16, bias (bh, n, n) float32.
extern "C" int mia_attention_dense_fwd_wgmma_bf16(const void* q, const void* k, const void* v,
                                                  const void* bias, void* out, int bh, int n,
                                                  float scale, void* stream) {
  if (bh == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (!mia_attention_dense_fwd_wgmma_takes(kWgD, n)) return static_cast<int>(cudaErrorInvalidValue);
  Bf16FwdArgs a = wgmma_args(q, k, v, out, nullptr, kWgD, kWgD, n, 1, 0, 0, scale);
  a.bias = static_cast<const float*>(bias);
  const bool one_walk = n <= kWinKeys;
  CUtensorMap maps[3];
  if (!qkv_maps(maps, q, k, v, kWgD, bh, n, 1, one_walk ? kWinKeys : kKeyTile,
                one_walk ? kWinVRows : kKeyTile))
    return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return one_walk ? launch_wgmma(attention_fwd_wgmma_window_kernel<kDense>,
                                 wg_win_smem_bytes<kDense>(), a, maps, bh, s)
                  : launch_wgmma(attention_fwd_wgmma_kernel<kWgD, true>, wg_fwd_smem_bytes<true>(),
                                 a, maps, bh, s);
}

// K8 in bfloat16 for a call the K8 rule takes: qkv (batch, hg, wg,
// 3*heads*64); rel_h, rel_w (batch*heads, hg, wg, ws); bias_kv (3,
// heads*64); out (batch, hg, wg, heads*64); lse, when not null, the
// log-sum-exp of every real query by token (batch*heads, hg*wg). One block
// a (query tile, head, window): k and v land by one 4D box each over the
// token grid (grid_map), a window's slots in slot order.
extern "C" int mia_attention_rel_win_fwd_wgmma_bf16(const void* qkv, const void* rel_h,
                                                    const void* rel_w, const void* bias_kv,
                                                    void* out, void* lse, int batch, int hg,
                                                    int wg, int heads, int ws, float scale,
                                                    void* stream) {
  if (batch == 0 || hg == 0 || wg == 0) return static_cast<int>(cudaSuccess);
  if (!mia_attention_rel_win_fwd_wgmma_takes(kWgD, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  Bf16FwdArgs a = packed_bf16_args(qkv, out, lse, heads, kWgD, scale);
  a.rel_a = static_cast<const bf16*>(rel_h);
  a.rel_b = static_cast<const bf16*>(rel_w);
  a.pad_kv = static_cast<const bf16*>(bias_kv);
  set_grid(a, hg, wg, ws);
  const long long hd = static_cast<long long>(heads) * kWgD;
  CUtensorMap maps[3];
  if (!grid_map(&maps[1], a.k, hd, a.in_stride, wg, hg, batch, ws, ws) ||
      !grid_map(&maps[2], a.v, hd, a.in_stride, wg, hg, batch, ws, ws))
    return static_cast<int>(cudaErrorNotSupported);
  maps[0] = maps[1];  // q is gathered by the slot map, not boxed
  return launch_wgmma(attention_fwd_wgmma_window_kernel<kRelWindow>,
                      wg_win_smem_bytes<kRelWindow>(), a, maps, batch * a.nwin,
                      static_cast<cudaStream_t>(stream));
}
