// K6, K7 and K8 on Hopper: the encoder's other attention routes, forward,
// in float32. Three instances of the template in attention_fwd.cuh (whose
// header describes the kernel body), beside K2 and K3 in attention_rel.cu.
//
// Replaces the TPU kernels
//   K6  mia_tpu/ops/attention.py::fused_attention_rel (_attn_rel_kernel):
//       softmax(q.kT*s + rel_h (+) rel_w).v on head-major (B*H, N, D)
//       operands with per-query rel terms (B*H, N, k_h) / (B*H, N, k_w);
//       N = k_h*k_w, any N. Here: the kRelTerms bias of K3 with head-major
//       strides (every (batch, head) pair is a batch element of one head).
//   K7  mia_tpu/ops/attention.py::fused_attention (_attn_kernel):
//       softmax(q.kT*s + bias).v with a dense (B*H, N, N) additive bias. The
//       TPU form pads N to 128 and masks the pad keys with -1e30; here the
//       kDense instance stages the bias tile by tile beside the k tile and
//       the loop bounds mask the ragged last tile.
//   K8  mia_tpu/ops/attention.py::fused_attention_rel_win
//       (_attn_rel_win_kernel): windowed attention carved from the
//       unpartitioned (B, Hg, Wg, 3*H*D) qkv grid. The TPU kernel walks
//       window-row bands and concatenates carved tiles; here a block owns
//       one (image, head, window) and maps each slot to its grid token, so
//       no partitioned copy of qkv exists anywhere. Pad slots are real keys
//       (k, v from bias_kv, the query's rel bias for the slot position);
//       pad queries are dropped.
// None of them carries over the TPU kernels' K-axis concatenation with
// one-hot expanders, which exists to feed the matrix unit: the factored
// bias is two loads and an add per score.
//
// Bound: K6 and K8 do 4*D flops per (query, key) pair on the FP32 pipe out
// of shared memory, like K2 and K3, and are bound by operations. K7 adds 4
// bytes of bias per pair: at 1024 tokens the (12, 1024, 1024) bias is 50 MB
// against 9.4 MB of q, k, v and out, and at D = 64 the bias bytes (15 us at
// 3.35 TB/s) still stay below the 3.2 GFLOP of products (48 us at 67
// TFLOP/s), so it is bound by operations too, but it must stream the bias
// through every block's shared memory.
//
// These are forward kernels; their backward kernels come with the slice
// that trains through these routes. The kernels allocate nothing and do not
// synchronise; each C entry point returns cudaGetLastError().

#include "attention_fwd.cuh"

namespace {

// head-major operands: bh batch elements of one head each
FwdArgs head_major_args(const void* q, const void* k, const void* v, void* out, int n, int d,
                        float scale) {
  FwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.in_stride = d;
  a.out_stride = d;
  a.n = n;
  a.heads = 1;
  a.scale = scale;
  return a;
}

}  // namespace

// K6: q, k, v, out (bh, n, d); rel_h (bh, n, kh), rel_w (bh, n, kw); n == kh*kw.
extern "C" int mia_attention_rel_f32(const void* q, const void* k, const void* v,
                                     const void* rel_h, const void* rel_w, void* out, int bh,
                                     int n, int d, int kh, int kw, float scale, void* stream) {
  FwdArgs a = head_major_args(q, k, v, out, n, d, scale);
  a.rel_a = static_cast<const float*>(rel_h);
  a.rel_b = static_cast<const float*>(rel_w);
  a.kh = kh;
  a.kw = kw;
  return dispatch_fwd<kRelTerms, kHeadMajor>(a, bh, d, stream);
}

// K7: q, k, v, out (bh, n, d); bias (bh, n, n).
extern "C" int mia_attention_dense_f32(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int bh, int n, int d,
                                       float scale, void* stream) {
  FwdArgs a = head_major_args(q, k, v, out, n, d, scale);
  a.rel_a = static_cast<const float*>(bias);
  return dispatch_fwd<kDense, kHeadMajor>(a, bh, d, stream);
}

// K8: qkv (batch, hg, wg, 3*heads*d); rel_h, rel_w (batch*heads, hg, wg, ws);
// bias_kv (3, heads*d); out (batch, hg, wg, heads*d).
extern "C" int mia_attention_rel_win_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                         const void* bias_kv, void* out, int batch, int hg, int wg,
                                         int heads, int d, int ws, float scale, void* stream) {
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
  a.in_stride = 3LL * heads * d;
  a.out_stride = static_cast<long long>(heads) * d;
  a.n = ws * ws;
  a.heads = heads;
  a.kh = ws;
  a.kw = ws;
  a.hg = hg;
  a.wg = wg;
  a.nwx = (wg + ws - 1) / ws;
  a.nwin = a.nwx * ((hg + ws - 1) / ws);
  a.scale = scale;
  return dispatch_fwd<kRelTerms, kGrid>(a, batch * a.nwin, d, stream);
}
