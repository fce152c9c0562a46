// K6, K7 and K8 on Hopper: the encoder's other attention routes, in float32.
// Forward: three instances of the template in attention_fwd.cuh (whose
// header describes the kernel body), beside K2 and K3 in attention_rel.cu.
// Backward: K6b and K8b, two instances of the template in attention_bwd.cuh
// (K7's backward is plain tensor code in the JAX package and here).
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
// Replaces the TPU backward kernels
//   K6b mia_tpu/ops/attention.py::_rel_bwd (_rel_bwd_kernel): dq, dk, dv,
//       drel_h, drel_w of K6. Here: the kRelTerms backward of K3b with
//       head-major strides; any N, the loops are bounded by N.
//   K8b mia_tpu/ops/attention.py::_rel_win_bwd (_attn_rel_win_bwd_kernel):
//       dqkv written in place into the three column blocks of one
//       (B, Hg, Wg, 3*H*D) tensor, drel_h and drel_w in grid layout, and
//       dbias_kv (3, H*D): row 0 zero, rows 1 and 2 the summed dk and dv of
//       every pad slot of every window. The forward writes the log-sum-exp
//       of every real query by token, (B*H, Hg*Wg), so the backward does not
//       recompute the 196-key softmax. Kernel B leaves one partial row per
//       (window, key tile); the reduce kernel below sums them in a fixed
//       order (no float atomics).
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError().

#include "attention_bwd.cuh"

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

// the (nwx, nwin) window geometry of a (hg, wg) grid
template <typename Args>
void set_grid(Args& a, int hg, int wg, int ws) {
  a.n = ws * ws;
  a.kh = ws;
  a.kw = ws;
  a.hg = hg;
  a.wg = wg;
  a.nwx = (wg + ws - 1) / ws;
  a.nwin = a.nwx * ((hg + ws - 1) / ws);
}

// dbias_kv (3, hd) from K8b's partials dpad (rows, 2*hd): row 0 zero, rows 1
// and 2 the column sums. A block of 32 x 8 threads owns 32 columns; each
// thread sums every 8th row, then thread row 0 adds the 8 sums in order.
__global__ void attention_bwd_pad_reduce_kernel(const float* __restrict__ dpad,
                                                float* __restrict__ dbias_kv, int rows, int hd) {
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
    dbias_kv[hd + c] = sum;
    if (c < hd) dbias_kv[c] = 0.f;
  }
}

}  // namespace

// K6: q, k, v, out (bh, n, d); rel_h (bh, n, kh), rel_w (bh, n, kw); n == kh*kw.
// lse, when not null, receives the per-row log-sum-exp (bh, n) for the backward.
extern "C" int mia_attention_rel_f32(const void* q, const void* k, const void* v,
                                     const void* rel_h, const void* rel_w, void* out, void* lse,
                                     int bh, int n, int d, int kh, int kw, float scale,
                                     void* stream) {
  FwdArgs a = head_major_args(q, k, v, out, n, d, scale);
  a.lse = static_cast<float*>(lse);
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
  return dispatch_fwd<kRelTerms, kGrid>(a, batch * a.nwin, d, stream);
}

// K6b: from K6's inputs, its output, its lse and the output cotangent g
// (bh, n, d), writes dq, dk, dv (bh, n, d) and drel_h / drel_w (shapes of
// rel_h / rel_w). delta is scratch (bh, n).
extern "C" int mia_attention_rel_bwd_f32(const void* q, const void* k, const void* v,
                                         const void* rel_h, const void* rel_w, const void* out,
                                         const void* g, const void* lse, void* dq, void* dk,
                                         void* dv, void* delta, void* drel_h, void* drel_w, int bh,
                                         int n, int d, int kh, int kw, float scale, void* stream) {
  if (bh == 0 || n == 0) return static_cast<int>(cudaSuccess);
  BwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.rel_a = static_cast<const float*>(rel_h);
  a.rel_b = static_cast<const float*>(rel_w);
  a.out = static_cast<const float*>(out);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(delta);
  a.drel_a = static_cast<float*>(drel_h);
  a.drel_b = static_cast<float*>(drel_w);
  a.in_stride = d;
  a.out_stride = d;
  a.n = n;
  a.heads = 1;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  return dispatch_bwd_passes<kRelTerms, kHeadMajor>(a, bh, d, stream);
}

// K8b: from K8's inputs, its output (batch, hg, wg, heads*d), its lse and
// the output cotangent g, writes dqkv (shape of qkv; q, k, v cotangents in
// its three column blocks), drel_h / drel_w (shapes of rel_h / rel_w) and
// dbias_kv (3, heads*d). delta (batch*heads, hg*wg) and dpad
// (batch*nW*ceil(ws*ws/32), 2, heads*d) are scratch.
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
  const int err = dispatch_bwd_passes<kRelTerms, kGrid>(a, windows, d, stream);
  if (err != 0) return err;
  const int rows = windows * ((a.n + kBT - 1) / kBT);
  const int cols = static_cast<int>(2 * hd);
  attention_bwd_pad_reduce_kernel<<<(cols + 31) / 32, dim3(32, 8), 0, s>>>(
      a.dpad, static_cast<float*>(dbias_kv), rows, static_cast<int>(hd));
  return static_cast<int>(cudaGetLastError());
}
