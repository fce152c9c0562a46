// K7 and K8 on Hopper, and K8b: the encoder's other attention routes, in
// float32 and (the _bf16 entries at the end) bfloat16. Forward: K7 is the kDense and K8 the kRelWindow instance of the
// 3xTF32 tensor-core template in attention_fwd_tc.cuh, beside K2, K3 and K6
// (whose C entry is in attention_rel.cu: it runs K3's instance on
// head-major strides). Backward: K8b is the kWindow instance of the 3xTF32
// tensor-core template in attention_bwd_tc.cuh; K6b runs K3b's instance and
// its C entry is in attention_rel.cu; K7's backward is plain tensor code in
// the JAX package and here. K8 and K8b share the window layout of
// attention_window.cuh.
//
// Replaces the TPU kernels
//   K7  mia_tpu/ops/attention.py::fused_attention (_attn_kernel):
//       softmax(q.kT*s + bias).v with a dense (B*H, N, N) additive bias, any
//       N. The TPU form pads N to 128 and masks the pad keys with -1e30;
//       here the template streams the bias tile by tile beside K and V and
//       masks keys past N itself.
//   K8  mia_tpu/ops/attention.py::fused_attention_rel_win
//       (_attn_rel_win_kernel): windowed attention carved from the
//       unpartitioned (B, Hg, Wg, 3*H*D) qkv grid. The TPU kernel walks
//       window-row bands and concatenates carved tiles; here a block owns
//       one (query tile, head, window) and maps each slot to its grid
//       token, so no partitioned copy of qkv exists anywhere. Pad slots are real keys
//       (k, v from bias_kv, the query's rel bias for the slot position);
//       pad queries are dropped.
// Neither carries over the TPU kernels' K-axis concatenation with one-hot
// expanders, which exists to feed the matrix unit: K8's factored bias is two
// loads and an add per score (K8's bfloat16 warpgroup forward at head dim 64
// does fold them into its S product: attention_fwd_wgmma.cuh).
//
// Bound: K7 and K8 do 4*D flops per (query, key) pair in 3xTF32 on the
// tensor cores (495/3 TFLOP/s). K8 is bound by bytes at B=1 (qkv, the rel
// terms and out once: 4.17 us against 3.74 us of MMAs). K7 reads 4 bytes of
// bias a pair: at 12 x 1024 tokens 19.5 us of MMAs against 18.8 us
// of bytes, at 108 windows of 196 tokens 6.4 us against 11.4 us of bytes
// (see attention_fwd_tc.cuh).
//
// Replaces the TPU backward kernel
//   K8b mia_tpu/ops/attention.py::_rel_win_bwd (_attn_rel_win_bwd_kernel):
//       dqkv written in place into the three column blocks of one
//       (B, Hg, Wg, 3*H*D) tensor, drel_h and drel_w in grid layout, and
//       dbias_kv (3, H*D): row 0 zero, rows 1 and 2 the summed dk and dv of
//       every pad slot of every window. The forward writes the log-sum-exp
//       of every real query by token, (B*H, Hg*Wg), so the backward does not
//       recompute the 196-key softmax. Pass B of the template leaves one
//       partial row per (window, 64-key tile); the reduce kernel below sums
//       them in a fixed order (no float atomics). Bound: operations, 10 x D
//       flops per (real query, slot) pair at 495/3 TFLOP/s (the template's
//       header).
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError().

#include "attention_bwd_tc.cuh"
#include "attention_fwd_tc.cuh"

// attention_fwd_wgmma.cu: K7's and K8's bfloat16 forwards on warpgroup products
extern "C" int mia_attention_dense_fwd_wgmma_takes(int d, int n);
extern "C" int mia_attention_dense_fwd_wgmma_bf16(const void* q, const void* k, const void* v,
                                                  const void* bias, void* out, int bh, int n,
                                                  float scale, void* stream);
extern "C" int mia_attention_rel_win_fwd_wgmma_takes(int d, int ws);
extern "C" int mia_attention_rel_win_fwd_wgmma_bf16(const void* qkv, const void* rel_h,
                                                    const void* rel_w, const void* bias_kv,
                                                    void* out, void* lse, int batch, int hg,
                                                    int wg, int heads, int ws, float scale,
                                                    void* stream);
// attention_bwd_wgmma.cu: K8b's bfloat16 backward on warpgroup products
extern "C" int mia_attention_rel_win_bwd_wgmma_takes(int d, int ws);
extern "C" int mia_attention_rel_win_bwd_wgmma_bf16(
    const void* qkv, const void* rel_h, const void* rel_w, const void* bias_kv, const void* out,
    const void* g, const void* lse, void* dqkv, void* delta, void* drel_h, void* drel_w,
    void* dpad, int batch, int hg, int wg, int heads, int ws, float scale, void* stream);

namespace {

// dbias_kv (3, hd) from K8b's float32 partials dpad (rows, 2*hd): row 0
// zero, rows 1 and 2 the column sums, rounded once to T (float32, or
// bfloat16 for a bfloat16 bias_kv). A block of 32 x 8 threads owns 32
// columns; each thread sums every 8th row, then thread row 0 adds the 8
// sums in order.
template <typename T>
__global__ void attention_bwd_pad_reduce_kernel(const float* __restrict__ dpad,
                                                T* __restrict__ dbias_kv, int rows, int hd) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < 2 * hd) {
    for (int r = threadIdx.y; r < rows; r += 8) acc += dpad[static_cast<long long>(r) * 2 * hd + c];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < 2 * hd) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += part[i][threadIdx.x];
    dbias_kv[hd + c] = from_float<T>(sum);
    if (c < hd) dbias_kv[c] = from_float<T>(0.f);
  }
}

}  // namespace

// K7: q, k, v, out (bh, n, d); bias (bh, n, n).
extern "C" int mia_attention_dense_f32(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int bh, int n, int d,
                                       float scale, void* stream) {
  FwdArgs a = head_major_args(q, k, v, out, n, d, scale);
  a.rel_a = static_cast<const float*>(bias);
  return dispatch_fwd_tc<kDense>(a, bh, d, stream);
}

// K8: qkv (batch, hg, wg, 3*heads*d); rel_h, rel_w (batch*heads, hg, wg, ws);
// bias_kv (3, heads*d); out (batch, hg, wg, heads*d). lse, when not null,
// receives the log-sum-exp of every real query by token, (batch*heads, hg*wg).
extern "C" int mia_attention_rel_win_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                         const void* bias_kv, void* out, void* lse, int batch,
                                         int hg, int wg, int heads, int d, int ws, float scale,
                                         void* stream) {
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* base = static_cast<const float*>(qkv);
  FwdArgs a{};
  a.q = base;
  a.k = base + static_cast<long long>(heads) * d;
  a.v = base + 2LL * heads * d;
  a.rel_a = static_cast<const float*>(rel_h);
  a.rel_b = static_cast<const float*>(rel_w);
  a.pad_kv = static_cast<const float*>(bias_kv);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.in_stride = 3LL * heads * d;
  a.out_stride = static_cast<long long>(heads) * d;
  a.heads = heads;
  set_grid(a, hg, wg, ws);
  a.scale = scale;
  return dispatch_fwd_tc<kRelWindow>(a, batch * a.nwin, d, stream);
}

// K8b: from K8's inputs, its output (batch, hg, wg, heads*d), its lse and
// the output cotangent g, writes dqkv (shape of qkv; q, k, v cotangents in
// its three column blocks), drel_h / drel_w (shapes of rel_h / rel_w) and
// dbias_kv (3, heads*d). delta (batch*heads, hg*wg) and dpad
// (batch*nW*ceil(ws*ws/64), 2, heads*d) are scratch.
extern "C" int mia_attention_rel_win_bwd_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                             const void* bias_kv, const void* out, const void* g,
                                             const void* lse, void* dqkv, void* delta,
                                             void* drel_h, void* drel_w, void* dpad,
                                             void* dbias_kv, int batch, int hg, int wg, int heads,
                                             int d, int ws, float scale, void* stream) {
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long hd = static_cast<long long>(heads) * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || hg == 0 || wg == 0)
    return static_cast<int>(cudaMemsetAsync(dbias_kv, 0, sizeof(float) * 3 * hd, s));
  const float* base = static_cast<const float*>(qkv);
  float* dbase = static_cast<float*>(dqkv);
  BwdArgs a{};
  a.q = base;
  a.k = base + hd;
  a.v = base + 2 * hd;
  a.rel_a = static_cast<const float*>(rel_h);
  a.rel_b = static_cast<const float*>(rel_w);
  a.pad_kv = static_cast<const float*>(bias_kv);
  a.out = static_cast<const float*>(out);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.dq = dbase;
  a.dk = dbase + hd;
  a.dv = dbase + 2 * hd;
  a.delta = static_cast<float*>(delta);
  a.drel_a = static_cast<float*>(drel_h);
  a.drel_b = static_cast<float*>(drel_w);
  a.dpad = static_cast<float*>(dpad);
  a.in_stride = 3 * hd;
  a.out_stride = hd;
  a.heads = heads;
  set_grid(a, hg, wg, ws);
  a.scale = scale;
  const int windows = batch * a.nwin;
  const int err = dispatch_tc_bwd<false, true>(a, windows, d, stream);
  if (err != 0) return err;
  const int rows = windows * ((a.n + kTcTile - 1) / kTcTile);
  const int cols = static_cast<int>(2 * hd);
  attention_bwd_pad_reduce_kernel<float><<<(cols + 31) / 32, dim3(32, 8), 0, s>>>(
      a.dpad, static_cast<float*>(dbias_kv), rows, static_cast<int>(hd));
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 instances of K7, K8 and K8b (attention_fwd_bf16_kernel of
// attention_fwd_tc.cuh, kinds kDense and kRelWindow; the kWindow instance of
// attention_bwd_bf16_{dq,dkv}_kernel in attention_bwd_tc.cuh): q, k, v, qkv,
// the rel terms, bias_kv, out, g, dqkv, drel_h, drel_w and dbias_kv in
// bfloat16; K7's bias, lse, delta and dpad float32; otherwise the arguments
// of the float32 entries. K7 at head dim 64 with n % 4 == 0 runs the
// warpgroup forward instead (attention_fwd_wgmma.cu: one walk over windows
// of at most 200 tokens, two past them), and so does K8 at head dim 64 on
// windows of at most 200 slots (one walk, the windows carved by the slot
// map); head dim 80 keeps this file's mma.sync instance. K8b at head dim 64
// on windows of at most 200 slots runs the window instance of the warpgroup
// backward (attention_bwd_wgmma.cuh: passes A and B on windows carved by the
// slot map), then this file's pad reduce; head dim 80 keeps the mma.sync
// instance, by that rule.
extern "C" int mia_attention_dense_bf16(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, int bh, int n, int d,
                                        float scale, void* stream) {
  if (mia_attention_dense_fwd_wgmma_takes(d, n))
    return mia_attention_dense_fwd_wgmma_bf16(q, k, v, bias, out, bh, n, scale, stream);
  Bf16FwdArgs a = head_major_bf16_args(q, k, v, out, n, d, scale);
  a.bias = static_cast<const float*>(bias);
  return dispatch_fwd_bf16<kDense>(a, bh, d, stream);
}

extern "C" int mia_attention_rel_win_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                                          const void* bias_kv, void* out, void* lse, int batch,
                                          int hg, int wg, int heads, int d, int ws, float scale,
                                          void* stream) {
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mia_attention_rel_win_fwd_wgmma_takes(d, ws))
    return mia_attention_rel_win_fwd_wgmma_bf16(qkv, rel_h, rel_w, bias_kv, out, lse, batch, hg,
                                                wg, heads, ws, scale, stream);
  Bf16FwdArgs a = packed_bf16_args(qkv, out, lse, heads, d, scale);
  a.rel_a = static_cast<const bf16*>(rel_h);
  a.rel_b = static_cast<const bf16*>(rel_w);
  a.pad_kv = static_cast<const bf16*>(bias_kv);
  set_grid(a, hg, wg, ws);
  return dispatch_fwd_bf16<kRelWindow>(a, batch * a.nwin, d, stream);
}

extern "C" int mia_attention_rel_win_bwd_bf16(const void* qkv, const void* rel_h,
                                              const void* rel_w, const void* bias_kv,
                                              const void* out, const void* g, const void* lse,
                                              void* dqkv, void* delta, void* drel_h, void* drel_w,
                                              void* dpad, void* dbias_kv, int batch, int hg,
                                              int wg, int heads, int d, int ws, float scale,
                                              void* stream) {
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long hd = static_cast<long long>(heads) * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || hg == 0 || wg == 0)
    return static_cast<int>(cudaMemsetAsync(dbias_kv, 0, sizeof(bf16) * 3 * hd, s));
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
  const int windows = batch * a.nwin;
  const int err = mia_attention_rel_win_bwd_wgmma_takes(d, ws)
                      ? mia_attention_rel_win_bwd_wgmma_bf16(qkv, rel_h, rel_w, bias_kv, out, g,
                                                             lse, dqkv, delta, drel_h, drel_w,
                                                             dpad, batch, hg, wg, heads, ws,
                                                             scale, stream)
                      : dispatch_bwd_bf16<false, true>(a, windows, d, s);
  if (err != 0) return err;
  const int rows = windows * ((a.n + kTcTile - 1) / kTcTile);
  const int cols = static_cast<int>(2 * hd);
  attention_bwd_pad_reduce_kernel<bf16><<<(cols + 31) / 32, dim3(32, 8), 0, s>>>(
      a.dpad, static_cast<bf16*>(dbias_kv), rows, static_cast<int>(hd));
  return static_cast<int>(cudaGetLastError());
}
