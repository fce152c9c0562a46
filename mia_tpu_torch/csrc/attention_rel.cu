// K2 and K3 on Hopper, with their backward kernels K2b and K3b: rel-pos
// attention read straight from the packed qkv layout, to float32 accuracy;
// and K6 and K6b, whose arithmetic is K3's and K3b's on head-major operands.
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
// 128-row blocks. Here the factored bias is added per score from the
// block's rel rows in shared memory, so the (N, N) bias never exists and no
// key padding is needed: the key loop is bounded by n. Window pad tokens
// (zeros after the LayerNorm + partition kernel, so their k and v are the
// qkv bias) are real keys, as in the reference, and are not masked.
//
// The forward is two instances of the tensor-core template in
// attention_fwd_tc.cuh (its design is described there): bias kRelTerms for
// K3, kRelTables for K2, both on the packed layout. K6 (the forward of the
// head-major route) runs K3's instance: the head-major layout is the packed
// one with one head, strides D and every (batch, head) pair a batch element.
// Its C entry lives here so that the instance is built once; a trace names
// K6 as K3, attention_fwd_tc_kernel<D, 1, keys>. K2's rel terms are gathers
// from two tables that every (window, head) pair shares, so, as in the
// backward, kernel R below computes them first, one block per token
// position with the position's kh + kw table rows in shared memory, into a
// (B*H, n, kh + kw) scratch that the template reads like K3's inputs.
//
// Bound: operations. Q.K^T and P.V are 4 D flops per (query, key) pair, in
// 3xTF32 on mma.sync (three TF32 MMAs a product: the accuracy of float32;
// one TF32 pass misses the float32 tolerance). mma.sync and not wgmma: each
// warp keeps its Q fragments in registers for the whole key loop and feeds
// P to P.V straight from the S accumulator, where TF32 wgmma would want
// both operands K-major in shared memory and P written out there.
//
// bfloat16: mia_attention_rel_packed_bf16 and mia_attention_rel_packed_ik_bf16
// run the bfloat16 instance of the forward (bfloat16 mma.sync, described in
// attention_fwd_tc.cuh) for a bfloat16 encoder; K2's terms come from kernel
// R's bfloat16 instance. Their backward, mia_attention_rel_packed_bwd_bf16
// and mia_attention_rel_packed_ik_bwd_bf16, runs the bfloat16 instance of
// the backward template (attention_bwd_tc.cuh) and, for K2b, the bfloat16
// instances of kernels R, Q and C below.
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "attention_bwd_tc.cuh"
#include "attention_fwd_tc.cuh"

namespace {

// The packed layout: q, k, v are column blocks of one (batch, n, 3*heads*d)
// tensor, the context is (batch, n, heads*d).
FwdArgs packed_fwd_args(const void* qkv, const void* rel_a, const void* rel_b, void* out,
                        void* lse, int n, int heads, int d, int kh, int kw, float scale) {
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
  return a;
}

// ---------------------------------------------------------------------------
// Backward: two instances of the tensor-core template in attention_bwd_tc.cuh
// (3xTF32 on mma.sync; its design is described there), kTables true for K2b
// and false for K3b, both on the packed layout: q, k, v and dq, dk, dv are
// column blocks of qkv and dqkv. K6b (the backward of K6, the head-major
// route of attention_routes.cu) runs K3b's instance: the head-major layout
// is the packed one with one head, strides D and every (batch, head) pair a
// batch element, and the rel terms (B*H, n, kh) / (B*H, n, kw) are K3b's.
// Its C entry lives here so that the instance is built once; a trace names
// K6b's passes as K3b's, attention_bwd_tc_{dq,dkv}_kernel<D, false>.
// K2's and K2b's rel terms are gathers from two tables that every (window,
// head) pair shares, so they run outside the templates, one block per token
// position n and 128 pairs, with the position's kh + kw table rows
// T_n = [rh_flat[y*kh + j] | rw_flat[x*kw + j]] (y = n / kw, x = n % kw)
// copied to shared memory once (CUDA cores, ~3% of K2b's work):
//   kernel R, before the forward template (K2) and before passes A and B
//     (K2b): rel[bh, n, :] = q_{bh,n} . T_n^T, the rel terms they read;
//   kernel Q, after K2b's passes: dq_{bh,n} += drel[bh, n, :] . T_n, the rel
//     gradient (pass A's drel) routed back into dq.
// Inside the templates' (window, head) blocks the same gathers would read a
// table row from L2 for every query, ~460 KB a 64-query tile.
// K2b adds kernel C below when the tables need a gradient:
//   dthw[(y, j)] = sum over windows, heads and tokens of row y of
//   drel_h[n, j] * q_n (and the w table likewise), one block per table row,
//   a fixed summation order.
// Window pad tokens are real keys (their k and v are the qkv bias): their dk
// and dv are computed like any other key's.
// ---------------------------------------------------------------------------

constexpr int kRelThreads = 128;  // (window, head) pairs per block of kernels R and Q

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

// T_n of token position pos: kh + kw rows of D values, widened to float32.
template <int D, typename E>
__device__ __forceinline__ void copy_table_rows(float* T, const E* __restrict__ rh,
                                                const E* __restrict__ rw, int pos, int kh,
                                                int kw) {
  const int y = pos / kw;
  const int x = pos - y * kw;
  for (int i = threadIdx.x; i < (kh + kw) * (D / 4); i += kRelThreads) {
    const int j = i / (D / 4);
    const int c = i - j * (D / 4);
    const E* src = j < kh ? rh + static_cast<long long>(y * kh + j) * D
                          : rw + static_cast<long long>(x * kw + j - kh) * D;
    reinterpret_cast<float4*>(T)[i] = load4(src + 4 * c);
  }
}

// Kernel R: one thread a (window, head) pair; the rows go out through
// shared memory so that a warp writes runs of kh + kw values. E is the
// element type of qkv, the tables and the terms: float32 for K2 and K2b,
// bfloat16 for K2's bfloat16 instance, which sums the exact products in
// float32 and rounds each term once, as the Pallas kernel's candidate
// product.
template <int D, typename E>
__global__ void __launch_bounds__(kRelThreads) attention_rel_terms_kernel(
    const E* __restrict__ qkv, const E* __restrict__ rh, const E* __restrict__ rw,
    E* __restrict__ rel, long long pairs, int n, int heads, int kh, int kw) {
  extern __shared__ float4 smem4[];
  const int ka = kh + kw;
  float* T = reinterpret_cast<float*>(smem4);  // [ka][D]
  float* S = T + ka * D;                       // [kRelThreads][ka + 1]
  const int pos = blockIdx.x;
  copy_table_rows<D>(T, rh, rw, pos, kh, kw);
  __syncthreads();
  const long long bh0 = static_cast<long long>(blockIdx.y) * kRelThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kRelThreads), pairs - bh0));
  if (static_cast<int>(threadIdx.x) < rows) {
    const long long bh = bh0 + threadIdx.x;
    const long long img = bh / heads;
    const long long head = bh - img * heads;
    const E* qr = qkv + (img * n + pos) * (3LL * heads * D) + head * D;
    float4 q[D / 4];
#pragma unroll
    for (int c = 0; c < D / 4; ++c) q[c] = load4(qr + 4 * c);
    for (int j = 0; j < ka; ++j) {
      const float4* t4 = reinterpret_cast<const float4*>(T + j * D);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) acc += dot4(q[c], t4[c]);
      S[threadIdx.x * (ka + 1) + j] = acc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * ka; i += kRelThreads) {
    const int r = i / ka;
    rel[((bh0 + r) * n + pos) * ka + (i - r * ka)] = from_float<E>(S[r * (ka + 1) + (i - r * ka)]);
  }
}

// Kernel Q: one thread a (window, head) pair adds its drel row, read in
// runs through shared memory, times T_n to the float32 dq row at dq_in (rows
// in_stride floats apart) and writes the sum to its dq row of dqkv. float32
// (E = float): dq_in is dqkv's own dq, added to in place. bfloat16: dq_in is
// pass A's float32 scratch and the sum is rounded once to bfloat16, as the
// Pallas kernel adds the routed rel cotangent (already rounded to bfloat16)
// to dq before its one rounding.
template <int D, typename E>
__global__ void __launch_bounds__(kRelThreads) attention_rel_route_kernel(
    E* dqkv, const float* dq_in, long long in_stride, const E* __restrict__ drel,
    const E* __restrict__ rh, const E* __restrict__ rw, long long pairs, int n, int heads, int kh,
    int kw) {
  extern __shared__ float4 smem4[];
  const int ka = kh + kw;
  float* T = reinterpret_cast<float*>(smem4);  // [ka][D]
  float* S = T + ka * D;                       // [kRelThreads][ka + 1]
  const int pos = blockIdx.x;
  copy_table_rows<D>(T, rh, rw, pos, kh, kw);
  const long long bh0 = static_cast<long long>(blockIdx.y) * kRelThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kRelThreads), pairs - bh0));
  for (int i = threadIdx.x; i < rows * ka; i += kRelThreads) {
    const int r = i / ka;
    S[r * (ka + 1) + (i - r * ka)] = ldg_float(drel + ((bh0 + r) * n + pos) * ka + (i - r * ka));
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const long long bh = bh0 + threadIdx.x;
  const long long img = bh / heads;
  const long long head = bh - img * heads;
  const float4* src4 = reinterpret_cast<const float4*>(dq_in + (img * n + pos) * in_stride + head * D);
  E* dq = dqkv + (img * n + pos) * (3LL * heads * D) + head * D;
  float4 acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = src4[c];
  const float* w = S + threadIdx.x * (ka + 1);
  for (int j = 0; j < ka; ++j) {
    const float wj = w[j];
    const float4* t4 = reinterpret_cast<const float4*>(T + j * D);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 tv = t4[c];
      acc[c].x = fmaf(wj, tv.x, acc[c].x);
      acc[c].y = fmaf(wj, tv.y, acc[c].y);
      acc[c].z = fmaf(wj, tv.z, acc[c].z);
      acc[c].w = fmaf(wj, tv.w, acc[c].w);
    }
  }
#pragma unroll
  for (int c = 0; c < D / 4; ++c) store4(dq + 4 * c, acc[c]);
}

// What kernels R and Q read and write: the packed qkv (R reads q) or dqkv
// (Q writes dq), the two tables, the (pairs, n, kh + kw) rel terms (R
// writes them) or their cotangent drel (Q reads it), and the float32 dq Q
// adds to (dq_in, rows in_stride floats apart).
template <typename E>
struct RelGather {
  const E* qkv;
  E* dqkv;
  const E* rh;
  const E* rw;
  E* rel;
  long long pairs;  // (window, head) pairs
  int n, heads, kh, kw;
  const float* dq_in;
  long long in_stride;
};

// Kernel R over every (window, head) pair, elements of type E.
template <int D, typename E>
int launch_rel_terms(const E* qkv, const E* rh, const E* rw, E* rel, long long pairs, int n,
                     int heads, int kh, int kw, cudaStream_t s) {
  const int ka = kh + kw;
  const size_t smem = sizeof(float) * (ka * D + kRelThreads * (ka + 1));
  const dim3 grid(n, static_cast<unsigned>((pairs + kRelThreads - 1) / kRelThreads));
  const cudaError_t err = allow_smem(attention_rel_terms_kernel<D, E>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_rel_terms_kernel<D, E><<<grid, kRelThreads, smem, s>>>(qkv, rh, rw, rel, pairs, n,
                                                                    heads, kh, kw);
  return static_cast<int>(cudaGetLastError());
}

// Kernel R (route false) or Q (route true) over every (window, head) pair.
template <int D, typename E>
int launch_rel_gather(bool route, const RelGather<E>& r, cudaStream_t s) {
  if (!route)
    return launch_rel_terms<D, E>(r.qkv, r.rh, r.rw, r.rel, r.pairs, r.n, r.heads, r.kh, r.kw, s);
  const int ka = r.kh + r.kw;
  const size_t smem = sizeof(float) * (ka * D + kRelThreads * (ka + 1));
  const dim3 grid(r.n, static_cast<unsigned>((r.pairs + kRelThreads - 1) / kRelThreads));
  const cudaError_t err = allow_smem(attention_rel_route_kernel<D, E>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_rel_route_kernel<D, E><<<grid, kRelThreads, smem, s>>>(
      r.dqkv, r.dq_in, r.in_stride, r.rel, r.rh, r.rw, r.pairs, r.n, r.heads, r.kh, r.kw);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dispatch_rel_gather(bool route, const RelGather<E>& r, int d, cudaStream_t s) {
  switch (d) {
    case 64: return launch_rel_gather<64, E>(route, r, s);
    case 80: return launch_rel_gather<80, E>(route, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel C (K2): the gradient of the two gathered tables, one block of D
// threads per table row. Rows [0, q_h*kh) are rh_flat's (y, j): the sum over
// windows, heads and the kw tokens of row y of drel[., n, j] * q_n; rows
// [q_h*kh, q_h*kh + kw*kw) are rw_flat's (x, j) over the q_h tokens of column x.
// E: float32, or bfloat16 (float32 sums of the bfloat16 drel and q, rounded
// once to the tables' dtype, as the Pallas kernel's dthw).
template <int D, typename E>
__global__ void attention_rel_bwd_tables_kernel(const E* __restrict__ qkv,
                                                const E* __restrict__ drel,
                                                E* __restrict__ dthw, int batch, int n,
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
      acc += ldg_float(drel + (bh * n + tok) * ka + col) *
             ldg_float(qkv + (b * n + tok) * stride + head * D + d);
    }
  }
  dthw[static_cast<long long>(row) * D + d] = from_float<E>(acc);
}

// Kernel C over every table row.
template <typename E>
int launch_rel_tables(const E* qkv, const E* drel, E* dthw, int batch, int n, int heads, int d,
                      int kh, int kw, cudaStream_t s) {
  const int table_rows = (n / kw) * kh + kw * kw;
  switch (d) {
    case 64:
      attention_rel_bwd_tables_kernel<64, E><<<table_rows, 64, 0, s>>>(qkv, drel, dthw, batch, n,
                                                                       heads, kh, kw);
      break;
    case 80:
      attention_rel_bwd_tables_kernel<80, E><<<table_rows, 80, 0, s>>>(qkv, drel, dthw, batch, n,
                                                                       heads, kh, kw);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kTables>
int dispatch_bwd(const void* qkv, const void* rel_a, const void* rel_b, const void* out,
                 const void* g, const void* lse, void* dqkv, void* delta, void* rel_out,
                 void* drel_a, void* drel_b, void* dthw, int batch, int n, int heads, int d,
                 int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (kTables && (rel_out == nullptr || drel_a == nullptr))
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
  if (!kTables) return dispatch_tc_bwd<false>(a, batch, d, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pairs = static_cast<long long>(batch) * heads;
  int err = dispatch_rel_gather(
      false, RelGather<float>{base, nullptr, a.rel_a, a.rel_b, a.rel_out, pairs, n, heads, kh, kw},
      d, s);
  if (err == 0) err = dispatch_tc_bwd<true>(a, batch, d, stream);
  if (err == 0)
    err = dispatch_rel_gather(true, RelGather<float>{nullptr, dbase, a.rel_a, a.rel_b, a.drel_a,
                                                     pairs, n, heads, kh, kw, dbase, 3 * hd},
                              d, s);
  if (err != 0 || dthw == nullptr) return err;
  return launch_rel_tables(base, static_cast<const float*>(a.drel_a), static_cast<float*>(dthw),
                           batch, n, heads, d, kh, kw, s);
}

// The bfloat16 backward (K3b: kTables false; K2b: kTables true): kernel R's
// bfloat16 terms into rel, the template's bfloat16 passes (K2b: dq in
// float32 into dq32, drel in bfloat16), then kernel Q's and, when dthw is
// not null, kernel C's bfloat16 instances.
template <bool kTables>
int dispatch_bwd_bf16_entry(const void* qkv, const void* rel_a, const void* rel_b,
                            const void* out, const void* g, const void* lse, void* dqkv,
                            void* delta, void* rel, void* drel_a, void* drel_b, void* dq32,
                            void* dthw, int batch, int n, int heads, int d, int kh, int kw,
                            float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (kTables && (rel == nullptr || drel_a == nullptr || dq32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* base = static_cast<const bf16*>(qkv);
  bf16* dbase = static_cast<bf16*>(dqkv);
  const bf16* tab_h = static_cast<const bf16*>(rel_a);
  const bf16* tab_w = static_cast<const bf16*>(rel_b);
  bf16* terms = static_cast<bf16*>(rel);
  const long long pairs = static_cast<long long>(batch) * heads;
  Bf16BwdArgs a{};
  a.qkv = base;
  a.rel_a = kTables ? terms : tab_h;
  a.rel_b = kTables ? terms : tab_w;
  a.out = static_cast<const bf16*>(out);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.dqkv = dbase;
  a.dq32 = static_cast<float*>(dq32);
  a.delta = static_cast<float*>(delta);
  a.drel_a = static_cast<bf16*>(drel_a);
  a.drel_b = static_cast<bf16*>(drel_b);
  a.n = n;
  a.heads = heads;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  if (!kTables) return dispatch_bwd_bf16<false>(a, batch, d, s);
  int err = dispatch_rel_gather(
      false, RelGather<bf16>{base, nullptr, tab_h, tab_w, terms, pairs, n, heads, kh, kw}, d, s);
  if (err == 0) err = dispatch_bwd_bf16<true>(a, batch, d, s);
  if (err == 0)
    err = dispatch_rel_gather(
        true,
        RelGather<bf16>{nullptr, dbase, tab_h, tab_w, a.drel_a, pairs, n, heads, kh, kw, a.dq32,
                        static_cast<long long>(heads) * d},
        d, s);
  if (err != 0 || dthw == nullptr) return err;
  return launch_rel_tables(base, static_cast<const bf16*>(a.drel_a), static_cast<bf16*>(dthw),
                           batch, n, heads, d, kh, kw, s);
}

}  // namespace

// K3: qkv (batch, n, 3*heads*d), rel_h (batch*heads, n, kh), rel_w
// (batch*heads, n, kw), out (batch, n, heads*d); n == kh*kw. lse, when not
// null, receives the per-row log-sum-exp (batch*heads, n) for the backward.
extern "C" int mia_attention_rel_packed_f32(const void* qkv, const void* rel_h, const void* rel_w,
                                            void* out, void* lse, int batch, int n, int heads,
                                            int d, int kh, int kw, float scale, void* stream) {
  const FwdArgs a = packed_fwd_args(qkv, rel_h, rel_w, out, lse, n, heads, d, kh, kw, scale);
  return dispatch_fwd_tc<kRelTerms>(a, batch, d, stream);
}

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
  return dispatch_fwd_tc<kRelTerms>(a, bh, d, stream);
}

// K2: as K3, but with the gathered tables rh_flat ((n/kw)*kh, d) and rw_flat
// (kw*kw, d) in place of the per-token rel terms; rel (batch*heads, n,
// kh+kw) is scratch for kernel R's rel terms.
extern "C" int mia_attention_rel_packed_ik_f32(const void* qkv, const void* rh_flat,
                                               const void* rw_flat, void* out, void* lse,
                                               void* rel, int batch, int n, int heads, int d,
                                               int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (rel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* terms = static_cast<float*>(rel);
  const RelGather<float> r{static_cast<const float*>(qkv), nullptr,
                           static_cast<const float*>(rh_flat), static_cast<const float*>(rw_flat),
                           terms, static_cast<long long>(batch) * heads, n, heads, kh, kw};
  int err = dispatch_rel_gather(false, r, d, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const FwdArgs a = packed_fwd_args(qkv, terms, terms, out, lse, n, heads, d, kh, kw, scale);
  return dispatch_fwd_tc<kRelTables>(a, batch, d, stream);
}

// The bfloat16 instances of K3 and K2 (attention_fwd_bf16_kernel of
// attention_fwd_tc.cuh; K2's rel terms from kernel R's bfloat16 instance):
// qkv, the rel terms or tables, out and K2's rel scratch in bfloat16, lse
// float32; otherwise the arguments of the float32 entries.
extern "C" int mia_attention_rel_packed_bf16(const void* qkv, const void* rel_h,
                                             const void* rel_w, void* out, void* lse, int batch,
                                             int n, int heads, int d, int kh, int kw, float scale,
                                             void* stream) {
  const Bf16FwdArgs a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_h),
                      static_cast<const bf16*>(rel_w), static_cast<bf16*>(out),
                      static_cast<float*>(lse), n, heads, kh, kw, scale};
  return dispatch_fwd_bf16<false>(a, batch, d, stream);
}

extern "C" int mia_attention_rel_packed_ik_bf16(const void* qkv, const void* rh_flat,
                                                const void* rw_flat, void* out, void* lse,
                                                void* rel, int batch, int n, int heads, int d,
                                                int kh, int kw, float scale, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (rel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* terms = static_cast<bf16*>(rel);
  const RelGather<bf16> r{q, nullptr, static_cast<const bf16*>(rh_flat),
                          static_cast<const bf16*>(rw_flat), terms,
                          static_cast<long long>(batch) * heads, n, heads, kh, kw};
  const int err = dispatch_rel_gather(false, r, d, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const Bf16FwdArgs a{q, terms, terms, static_cast<bf16*>(out), static_cast<float*>(lse),
                      n, heads, kh, kw, scale};
  return dispatch_fwd_bf16<true>(a, batch, d, stream);
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

// K2 backward: writes dqkv; delta (batch*heads, n), rel and drel
// (batch*heads, n, kh+kw) are scratch. When dthw ((n/kw)*kh + kw*kw, d) is
// not null, the tables' gradient is written there, reduced from drel.
extern "C" int mia_attention_rel_packed_ik_bwd_f32(const void* qkv, const void* rh_flat,
                                                   const void* rw_flat, const void* out,
                                                   const void* g, const void* lse, void* dqkv,
                                                   void* delta, void* rel, void* drel, void* dthw,
                                                   int batch, int n, int heads, int d, int kh,
                                                   int kw, float scale, void* stream) {
  return dispatch_bwd<true>(qkv, rh_flat, rw_flat, out, g, lse, dqkv, delta, rel, drel, nullptr,
                            dthw, batch, n, heads, d, kh, kw, scale, stream);
}

// The bfloat16 instances of K3b and K2b: qkv, the rel terms or tables, out,
// g, dqkv, drel_h / drel_w, K2b's rel and drel scratch and dthw in bfloat16;
// lse and delta float32; K2b's dq32 (batch, n, heads*d) a float32 scratch.
// Otherwise the arguments of the float32 entries.
extern "C" int mia_attention_rel_packed_bwd_bf16(const void* qkv, const void* rel_h,
                                                 const void* rel_w, const void* out, const void* g,
                                                 const void* lse, void* dqkv, void* delta,
                                                 void* drel_h, void* drel_w, int batch, int n,
                                                 int heads, int d, int kh, int kw, float scale,
                                                 void* stream) {
  return dispatch_bwd_bf16_entry<false>(qkv, rel_h, rel_w, out, g, lse, dqkv, delta, nullptr,
                                        drel_h, drel_w, nullptr, nullptr, batch, n, heads, d, kh,
                                        kw, scale, stream);
}

extern "C" int mia_attention_rel_packed_ik_bwd_bf16(const void* qkv, const void* rh_flat,
                                                    const void* rw_flat, const void* out,
                                                    const void* g, const void* lse, void* dqkv,
                                                    void* delta, void* rel, void* drel, void* dq32,
                                                    void* dthw, int batch, int n, int heads, int d,
                                                    int kh, int kw, float scale, void* stream) {
  return dispatch_bwd_bf16_entry<true>(qkv, rh_flat, rw_flat, out, g, lse, dqkv, delta, rel, drel,
                                       nullptr, dq32, dthw, batch, n, heads, d, kh, kw, scale,
                                       stream);
}

// K6b: from K6's inputs q, k, v (bh, n, d), rel_h (bh, n, kh), rel_w (bh, n,
// kw), its output, its lse (bh, n) and the output cotangent g (bh, n, d),
// writes dq, dk, dv (bh, n, d) and drel_h / drel_w (shapes of rel_h /
// rel_w); n == kh*kw. delta is scratch (bh, n).
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
  return dispatch_tc_bwd<false>(a, bh, d, stream);
}
