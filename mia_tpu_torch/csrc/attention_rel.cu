// K2 and K3 on Hopper: rel-pos attention read straight from the packed qkv
// layout, in float32.
//
// Replaces the TPU kernels
//   K2  mia_tpu/ops/attention.py::fused_attention_rel_packed_ik
//       (_attn_rel_packed_ik_kernel): windowed blocks, rel terms computed in
//       the kernel from the two gathered (q_h*k_h, D) / (k_w*k_w, D) tables;
//   K3  mia_tpu/ops/attention.py::fused_attention_rel_packed
//       (_attn_rel_packed_kernel): global blocks, rel terms precomputed
//       head-major as (B*H, N, k_h) and (B*H, N, k_w).
// Both compute, per (batch or window b, head h, query n),
//
//   out[b, n, h*D:(h+1)*D] = softmax_k(q_n.k_k * scale + rel_h[n, k / k_w]
//                                      + rel_w[n, k % k_w]) . v
//
// with q, k, v read from qkv[b, n, :] at columns h*D, (H+h)*D, (2H+h)*D (the
// (3, heads, head_dim) order of the qkv Linear), and the rel terms taken
// from the UNSCALED q. In K2, rel_h[n, j] = q_n . rh[(y_n*k_h + j)] and
// rel_w[n, j] = q_n . rw[(x_n*k_w + j)] with y_n = n / k_w, x_n = n % k_w.
//
// The TPU kernels fold the rel terms into one MXU product by concatenating
// [q*s | rel_h | rel_w] against [k | E_h | E_w] and mask the key padding to
// 128-row blocks. Here the factored bias is added per score from a small
// shared-memory table, so the (N, N) bias never exists and no key padding
// is needed: the key loop is bounded by n. Window pad tokens (zeros after
// the LayerNorm + partition kernel, so their k and v are the qkv bias) are
// real keys, as in the reference, and are not masked.
//
// The forward is two instances of the template in attention_fwd.cuh (its
// design is described there): kRelTables for K2, kRelTerms for K3, both on
// the packed layout. At B=1 a global block has only 12 x 1024 query rows,
// too few warps to hide latency with one thread per row, hence the
// template's kSplit = 4 launch.
//
// Bound: at ViT-B/512 (D = 64) the kernel does 4*D flops per (query, key)
// pair and reads each K/V row from shared memory once per query tile, so it
// is bound by the FP32 pipe, shared-memory issue and latency, not by device
// memory (qkv is 1.8 MB per 196-token window batch). A wgmma/TMA version
// in bf16 is later work.
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "attention_bwd.cuh"

namespace {

// The packed layout: q, k, v are column blocks of one (batch, n, 3*heads*d)
// tensor, the context is (batch, n, heads*d).
template <int kBias>
int dispatch(const void* qkv, const void* rel_a, const void* rel_b, void* out, void* lse, int batch,
             int n, int heads, int d, int kh, int kw, float scale, void* stream) {
  const float* base = static_cast<const float*>(qkv);
  FwdArgs a{};
  a.q = base;
  a.k = base + static_cast<long long>(heads) * d;
  a.v = base + 2LL * heads * d;
  a.rel_a = static_cast<const float*>(rel_a);
  a.rel_b = static_cast<const float*>(rel_b);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.in_stride = 3LL * heads * d;
  a.out_stride = static_cast<long long>(heads) * d;
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  return dispatch_fwd<kBias, kPacked>(a, batch, d, stream);
}

// ---------------------------------------------------------------------------
// Backward: two instances of the template in attention_bwd.cuh (its design
// is described there), kRelTables for K2b and kRelTerms for K3b, both on the
// packed layout: q, k, v and dq, dk, dv are column blocks of qkv and dqkv.
// K2b adds kernel C below when the tables need a gradient:
//   dthw[(y, j)] = sum over windows, heads and tokens of row y of
//   drel_h[n, j] * q_n (and the w table likewise), one block per table row,
//   a fixed summation order.
// Window pad tokens are real keys (their k and v are the qkv bias): their dk
// and dv are computed like any other key's.
// ---------------------------------------------------------------------------

// Kernel C (K2): the gradient of the two gathered tables, one block of D
// threads per table row. Rows [0, q_h*kh) are rh_flat's (y, j): the sum over
// windows, heads and the kw tokens of row y of drel[., n, j] * q_n; rows
// [q_h*kh, q_h*kh + kw*kw) are rw_flat's (x, j) over the q_h tokens of column x.
template <int D>
__global__ void attention_rel_bwd_tables_kernel(const float* __restrict__ qkv,
                                                const float* __restrict__ drel,
                                                float* __restrict__ dthw, int batch, int n,
                                                int heads, int kh, int kw) {
  const int d = threadIdx.x;
  const int q_h = n / kw;
  const int row = blockIdx.x;
  const bool h_part = row < q_h * kh;
  const int r = h_part ? row : row - q_h * kh;
  const int pos = r / (h_part ? kh : kw);  // y (h part) or x (w part)
  const int j = r - pos * (h_part ? kh : kw);
  const int col = h_part ? j : kh + j;
  const int ka = kh + kw;
  const long long stride = 3LL * heads * D;
  const int count = h_part ? kw : q_h;
  float acc = 0.f;
  for (long long bh = 0; bh < static_cast<long long>(batch) * heads; ++bh) {
    const long long b = bh / heads;
    const int head = static_cast<int>(bh - b * heads);
    for (int i = 0; i < count; ++i) {
      const int tok = h_part ? pos * kw + i : i * kw + pos;
      acc += __ldg(drel + (bh * n + tok) * ka + col) *
             __ldg(qkv + (b * n + tok) * stride + head * D + d);
    }
  }
  dthw[static_cast<long long>(row) * D + d] = acc;
}

template <bool kInKernelRel>
int dispatch_bwd(const void* qkv, const void* rel_a, const void* rel_b, const void* out,
                 const void* g, const void* lse, void* dqkv, void* delta, void* rel_out,
                 void* drel_a, void* drel_b, void* dthw, int batch, int n, int heads, int d,
                 int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (kInKernelRel && dthw != nullptr && drel_a == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* base = static_cast<const float*>(qkv);
  float* dbase = static_cast<float*>(dqkv);
  const long long hd = static_cast<long long>(heads) * d;
  BwdArgs a{};
  a.q = base;
  a.k = base + hd;
  a.v = base + 2 * hd;
  a.rel_a = static_cast<const float*>(rel_a);
  a.rel_b = static_cast<const float*>(rel_b);
  a.out = static_cast<const float*>(out);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.dq = dbase;
  a.dk = dbase + hd;
  a.dv = dbase + 2 * hd;
  a.delta = static_cast<float*>(delta);
  a.rel_out = static_cast<float*>(rel_out);
  a.drel_a = static_cast<float*>(drel_a);
  a.drel_b = static_cast<float*>(drel_b);
  a.in_stride = 3 * hd;
  a.out_stride = hd;
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  const int err =
      dispatch_bwd_passes<kInKernelRel ? kRelTables : kRelTerms, kPacked>(a, batch, d, stream);
  if (err != 0 || !kInKernelRel || dthw == nullptr) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int table_rows = (n / kw) * kh + kw * kw;
  if (d == 64) {
    attention_rel_bwd_tables_kernel<64><<<table_rows, 64, 0, s>>>(
        base, a.drel_a, static_cast<float*>(dthw), batch, n, heads, kh, kw);
  } else {
    attention_rel_bwd_tables_kernel<80><<<table_rows, 80, 0, s>>>(
        base, a.drel_a, static_cast<float*>(dthw), batch, n, heads, kh, kw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: qkv (batch, n, 3*heads*d), rel_h (batch*heads, n, kh), rel_w
// (batch*heads, n, kw), out (batch, n, heads*d); n == kh*kw. lse, when not
// null, receives the per-row log-sum-exp (batch*heads, n) for the backward.
extern "C" int mia_attention_rel_packed_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                            void* out, void* lse, int batch, int n, int heads,
                                            int d, int kh, int kw, float scale, void* stream) {
  return dispatch<kRelTerms>(qkv, rel_h, rel_w, out, lse, batch, n, heads, d, kh, kw, scale, stream);
}

// K2: as K3, but with the gathered tables rh_flat ((n/kw)*kh, d) and rw_flat
// (kw*kw, d) in place of the per-token rel terms.
extern "C" int mia_attention_rel_packed_ik_f32(const void* qkv, const void* rh_flat,
                                               const void* rw_flat, void* out, void* lse,
                                               int batch, int n, int heads, int d, int kh, int kw,
                                               float scale, void* stream) {
  return dispatch<kRelTables>(qkv, rh_flat, rw_flat, out, lse, batch, n, heads, d, kh, kw, scale,
                        stream);
}

// K3 backward: from the forward's inputs, its output, its lse and the
// output cotangent g (batch, n, heads*d), writes dqkv (batch, n, 3*heads*d)
// and drel_h / drel_w (shapes of rel_h / rel_w). delta is scratch
// (batch*heads, n).
extern "C" int mia_attention_rel_packed_bwd_f32(const void* qkv, const void* rel_h,
                                                const void* rel_w, const void* out, const void* g,
                                                const void* lse, void* dqkv, void* delta,
                                                void* drel_h, void* drel_w, int batch, int n,
                                                int heads, int d, int kh, int kw, float scale,
                                                void* stream) {
  return dispatch_bwd<false>(qkv, rel_h, rel_w, out, g, lse, dqkv, delta, nullptr, drel_h, drel_w,
                             nullptr, batch, n, heads, d, kh, kw, scale, stream);
}

// K2 backward: writes dqkv; delta (batch*heads, n) and rel (batch*heads, n,
// kh+kw) are scratch. When dthw ((n/kw)*kh + kw*kw, d) is not null, the
// tables' gradient is written there, and drel (batch*heads, n, kh+kw) is
// the scratch it is reduced from.
extern "C" int mia_attention_rel_packed_ik_bwd_f32(const void* qkv, const void* rh_flat,
                                                   const void* rw_flat, const void* out,
                                                   const void* g, const void* lse, void* dqkv,
                                                   void* delta, void* rel, void* drel, void* dthw,
                                                   int batch, int n, int heads, int d, int kh,
                                                   int kw, float scale, void* stream) {
  return dispatch_bwd<true>(qkv, rh_flat, rw_flat, out, g, lse, dqkv, delta, rel, drel, nullptr,
                            dthw, batch, n, heads, d, kh, kw, scale, stream);
}
