// K10 and K10b on Hopper: the k=2/s=2 transposed convolution (2x upsample)
// and its backward, in float32.
//
// Replaces the TPU kernels mia_tpu/ops/upsample2x.py::conv_transpose2x_p
// (_fwd_impl/_fwd_kernel) and ::_bwd_impl (_bwd_kernel). For x (B, H, W, Cin),
// w (2, 2, Cin, Cout) (taps not reversed) and bias (Cout,)
//
//   y[b, 2i+di, 2j+dj, :] = x[b, i, j, :] . w[di, dj] + bias
//
// A k2/s2 transposed convolution gives every output pixel exactly one tap, so
// the whole function is one matrix product of the (B*H*W, Cin) pixels with
// the (Cin, 4*Cout) taps. What the TPU kernel is about is the layout: the
// output is written directly as (B, H, 2, W, 2*Cout), which is row-major
// (B, 2H, 2W, Cout), so no interleaved copy of the upsampled tensor is ever
// made, and the backward reads the cotangent in the same layout. The TPU
// kernel walks row bands on a sequential grid and carries dw/db in scratch
// from step to step; here blocks are independent:
//
//   forward  out(pixel, tap*Cout+co)  = sum_ci  x(pixel, ci) w(tap, ci, co) + bias(co)
//   dx       dx(pixel, ci)            = sum_tap,co dy(pixel, tap, co) w(tap, ci, co)
//   dw       part(chunk, ci, tap, co) = sum over the chunk's pixels x(pixel, ci) dy(pixel, tap, co)
//
// are three instances of one register-tiled float32 product (256 threads,
// a BM x BN tile of the result in registers, 16-deep slices of both operands
// staged through shared memory). The instances differ in how a tile is
// fetched (x rows, the 5-D layout, or the tap matrix, each as 16-byte loads
// along its contiguous axis) and in where the result goes: the forward
// scatters each pixel's 2*Cout runs to output rows 2i and 2i+1 (neighbouring
// threads write neighbouring 16 bytes). dw splits the pixels into chunks, one
// per blockIdx.z, and a second kernel adds the chunks' partials in a fixed
// order; db rides along as the column sums of the dy tiles. No atomics, so
// two launches agree bit for bit.
//
// Bound: the wide stages (Cin 256-512) by operations, 2*Cin*4*Cout a pixel
// on the CUDA cores; the thin stages (Cin, Cout 16-32) by bytes, the
// (B, 2H, 2W, Cout) tensor crossing device memory once. Tiles are picked by
// the width of the result so a thin stage does not compute padding.
//
// The kernels allocate nothing and do not synchronise; each C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // depth of one shared-memory slice
enum { kFwd = 0, kDx = 1, kDw = 2 };

// Offset of (pixel m, column n = tap*Cout + co) in the (B, H, 2, W, 2*Cout)
// layout; m = (b*H + i)*W + j, tap = 2*di + dj. A run of four columns that
// starts at a multiple of 4 stays inside one tap (Cout is a multiple of 4).
__device__ __forceinline__ long long y5_offset(long long m, int n, int W, int Cout) {
  const long long t = m / W;
  const int j = static_cast<int>(m - t * W);
  const int di = n >= 2 * Cout ? 1 : 0;
  return ((2 * t + di) * W + j) * (2LL * Cout) + (n - di * 2 * Cout);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// One BM x BN tile of
//   kFwd: out = x . taps + bias      M = pixels, N = 4*Cout, depth Cin
//   kDx:  dx  = dy . taps^T          M = pixels, N = Cin,    depth 4*Cout
//   kDw:  part[z] = x^T . dy         M = Cin,    N = 4*Cout, depth = pixels of chunk z
// Thread (ty, tx) of TY x TX = 256 owns rows ty*TM .. +TM and the TN/4 column
// quads (g*TX + tx)*4, so a row of the tile is written as neighbouring float4s.
template <int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads) conv_transpose2x_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ dy,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ col_sums,
    long long pixels, int W, int Cin, int Cout, long long chunk_len) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile does not match the block");
  static_assert(TN % 4 == 0 && BM % 4 == 0 && BN % 4 == 0, "float4 granularity");
  constexpr int TX = BN / TN;
  constexpr int NG = TN / 4;
  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int N4 = 4 * Cout;

  long long M, k_begin, k_end;
  int N;
  if (MODE == kFwd) {
    M = pixels; N = N4; k_begin = 0; k_end = Cin;
  } else if (MODE == kDx) {
    M = pixels; N = Cin; k_begin = 0; k_end = N4;
  } else {
    M = Cin; N = N4;
    k_begin = static_cast<long long>(blockIdx.z) * chunk_len;
    k_end = k_begin + chunk_len < pixels ? k_begin + chunk_len : pixels;
  }

  float acc[TM][TN];
  float bsum[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) bsum[j] = 0.f;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k0 = k_begin; k0 < k_end; k0 += kBK) {
    // ---- the A slice, As[k][m] ----
    if (MODE == kDw) {  // x(pixel k, ci m): contiguous along m
      for (int idx = tid; idx < kBK * (BM / 4); idx += kThreads) {
        const int k = idx / (BM / 4);
        const int mq = idx % (BM / 4);
        const long long p = k0 + k;
        const long long m = m0 + mq * 4;
        float4 v = zero4;
        if (p < k_end && m < M) v = ldg4(x + p * Cin + m);
        *reinterpret_cast<float4*>(&As[k][mq * 4]) = v;
      }
    } else {  // x(pixel m, ci k) or dy(pixel m, column k): contiguous along k
      for (int idx = tid; idx < BM * (kBK / 4); idx += kThreads) {
        const int ml = idx / (kBK / 4);
        const int kq = idx % (kBK / 4);
        const long long m = m0 + ml;
        const long long k = k0 + kq * 4;
        float4 v = zero4;
        if (m < M && k < k_end) {
          if (MODE == kFwd) {
            v = ldg4(x + m * Cin + k);
          } else {
            v = ldg4(dy + y5_offset(m, static_cast<int>(k), W, Cout));
          }
        }
        As[kq * 4 + 0][ml] = v.x;
        As[kq * 4 + 1][ml] = v.y;
        As[kq * 4 + 2][ml] = v.z;
        As[kq * 4 + 3][ml] = v.w;
      }
    }
    // ---- the B slice, Bs[k][n] ----
    if (MODE == kDx) {  // w(tap, ci n, co) with k = tap*Cout + co: contiguous along k
      for (int idx = tid; idx < BN * (kBK / 4); idx += kThreads) {
        const int nl = idx / (kBK / 4);
        const int kq = idx % (kBK / 4);
        const int n = n0 + nl;
        const int k = static_cast<int>(k0) + kq * 4;
        float4 v = zero4;
        if (n < N && k < k_end) {
          const int tap = k / Cout;
          const int co = k - tap * Cout;
          v = ldg4(w + (static_cast<long long>(tap) * Cin + n) * Cout + co);
        }
        Bs[kq * 4 + 0][nl] = v.x;
        Bs[kq * 4 + 1][nl] = v.y;
        Bs[kq * 4 + 2][nl] = v.z;
        Bs[kq * 4 + 3][nl] = v.w;
      }
    } else {  // w(tap, ci k, co) or dy(pixel k, column n): contiguous along n
      for (int idx = tid; idx < kBK * (BN / 4); idx += kThreads) {
        const int kl = idx / (BN / 4);
        const int nq = idx % (BN / 4);
        const int n = n0 + nq * 4;
        const long long k = k0 + kl;
        float4 v = zero4;
        if (n < N && k < k_end) {
          if (MODE == kFwd) {
            const int tap = n / Cout;
            const int co = n - tap * Cout;
            v = ldg4(w + (static_cast<long long>(tap) * Cin + k) * Cout + co);
          } else {
            v = ldg4(dy + y5_offset(k, n, W, Cout));
          }
        }
        *reinterpret_cast<float4*>(&Bs[kl][nq * 4]) = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[k][(g * TX + tx) * 4]);
        b[g * 4 + 0] = v.x;
        b[g * 4 + 1] = v.y;
        b[g * 4 + 2] = v.z;
        b[g * 4 + 3] = v.w;
      }
      if (MODE == kDw) {
#pragma unroll
        for (int j = 0; j < TN; ++j) bsum[j] += b[j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // ---- the result ----
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    long long row;  // offset of the row's column 0
    if (MODE == kFwd) {
      const long long t = m / W;
      const int j = static_cast<int>(m - t * W);
      row = (2 * t * W + j) * (2LL * Cout);  // tap row di = 0; di = 1 lies 2*W*Cout further
    } else if (MODE == kDx) {
      row = m * Cin;
    } else {
      row = (static_cast<long long>(blockIdx.z) * M + m) * N;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int n = n0 + (g * TX + tx) * 4;
      if (n >= N) continue;
      float4 v = make_float4(acc[i][g * 4 + 0], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                             acc[i][g * 4 + 3]);
      long long off = row + n;
      if (MODE == kFwd) {
        const int di = n >= 2 * Cout ? 1 : 0;
        const int n2 = n - di * 2 * Cout;       // dj*Cout + co
        const int co = n2 >= Cout ? n2 - Cout : n2;
        const float4 bv = ldg4(bias + co);
        v.x += bv.x;
        v.y += bv.y;
        v.z += bv.z;
        v.w += bv.w;
        off = row + static_cast<long long>(di) * W * (2LL * Cout) + n2;
      }
      *reinterpret_cast<float4*>(out + off) = v;
    }
  }
  if (MODE == kDw) {
    if (blockIdx.x == 0 && ty == 0) {  // db: column sums of this chunk's dy tiles
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int n = n0 + (g * TX + tx) * 4;
        if (n >= N) continue;
        *reinterpret_cast<float4*>(col_sums + static_cast<long long>(blockIdx.z) * N + n) =
            make_float4(bsum[g * 4 + 0], bsum[g * 4 + 1], bsum[g * 4 + 2], bsum[g * 4 + 3]);
      }
    }
  }
}

// dw(tap, ci, co) = sum over chunks, in order, of part(chunk, ci, tap*Cout + co)
__global__ void conv_transpose2x_dw_reduce_kernel(const float* __restrict__ part,
                                                  float* __restrict__ dw, int chunks, int Cin,
                                                  int Cout) {
  const int N4 = 4 * Cout;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(Cin) * N4;
  if (idx >= total) return;
  const int ci = static_cast<int>(idx / N4);
  const int n = static_cast<int>(idx - static_cast<long long>(ci) * N4);
  const int tap = n / Cout;
  const int co = n - tap * Cout;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[static_cast<long long>(z) * total + idx];
  dw[(static_cast<long long>(tap) * Cin + ci) * Cout + co] = s;
}

// db(co) = sum over chunks, then taps, in order, of col_sums(chunk, tap*Cout + co)
__global__ void conv_transpose2x_db_reduce_kernel(const float* __restrict__ col_sums,
                                                  float* __restrict__ db, int chunks, int Cout) {
  const int co = blockIdx.x * blockDim.x + threadIdx.x;
  if (co >= Cout) return;
  const int N4 = 4 * Cout;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) {
    for (int tap = 0; tap < 4; ++tap) s += col_sums[static_cast<long long>(z) * N4 + tap * Cout + co];
  }
  db[co] = s;
}

template <int MODE, int BM, int BN, int TM, int TN>
cudaError_t launch_gemm(const float* x, const float* w, const float* dy, const float* bias,
                        float* out, float* col_sums, long long pixels, int W, int Cin, int Cout,
                        long long M, int N, long long chunk_len, int chunks, cudaStream_t s) {
  const long long mt = (M + BM - 1) / BM;
  const int nt = (N + BN - 1) / BN;
  if (mt > 0x7fffffffLL || nt > 65535 || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt),
                  static_cast<unsigned>(chunks));
  conv_transpose2x_gemm_kernel<MODE, BM, BN, TM, TN><<<grid, kThreads, 0, s>>>(
      x, w, dy, bias, out, col_sums, pixels, W, Cin, Cout, chunk_len);
  return cudaGetLastError();
}

// forward and dx: many pixels down, N columns across; the tile is as wide as N allows
template <int MODE>
cudaError_t launch_by_width(const float* x, const float* w, const float* dy, const float* bias,
                            float* out, long long pixels, int W, int Cin, int Cout, int N,
                            cudaStream_t s) {
  if (N >= 128) {
    return launch_gemm<MODE, 128, 128, 8, 8>(x, w, dy, bias, out, nullptr, pixels, W, Cin, Cout,
                                             pixels, N, 0, 1, s);
  }
  if (N >= 64) {
    return launch_gemm<MODE, 128, 64, 8, 4>(x, w, dy, bias, out, nullptr, pixels, W, Cin, Cout,
                                            pixels, N, 0, 1, s);
  }
  if (N >= 32) {
    return launch_gemm<MODE, 128, 32, 4, 4>(x, w, dy, bias, out, nullptr, pixels, W, Cin, Cout,
                                            pixels, N, 0, 1, s);
  }
  return launch_gemm<MODE, 256, 16, 4, 4>(x, w, dy, bias, out, nullptr, pixels, W, Cin, Cout,
                                          pixels, N, 0, 1, s);
}

// dw's tile: Cin rows (16 .. 512) by 4*Cout columns (64 .. 1024)
void dw_tile(int Cin, int Cout, int* bm, int* bn) {
  const int N4 = 4 * Cout;
  *bm = Cin >= 128 ? 128 : Cin >= 64 ? 64 : Cin >= 32 ? 32 : 16;
  *bn = (*bm == 64) ? 64 : (N4 >= 128 ? 128 : 64);
}

// Pixel chunks of dw: enough blocks for four waves of the card's 132 SMs,
// each chunk a multiple of the slice depth and at least 64 pixels.
void dw_chunks(long long pixels, int Cin, int Cout, long long* chunk_len, int* chunks) {
  int bm, bn;
  dw_tile(Cin, Cout, &bm, &bn);
  const long long tiles =
      static_cast<long long>((Cin + bm - 1) / bm) * ((4 * Cout + bn - 1) / bn);
  long long want = 528 / tiles;
  if (want < 1) want = 1;
  const long long most = pixels / 64 > 1 ? pixels / 64 : 1;
  if (want > most) want = most;
  long long len = (pixels + want - 1) / want;
  len = (len + kBK - 1) / kBK * kBK;
  if (len < kBK) len = kBK;
  *chunk_len = len;
  *chunks = static_cast<int>((pixels + len - 1) / len);
  if (*chunks < 1) *chunks = 1;
}

bool sizes_ok(int batch, int H, int W, int Cin, int Cout) {
  return batch >= 0 && H >= 0 && W >= 0 && Cin > 0 && Cout > 0 && Cin % 4 == 0 && Cout % 4 == 0;
}

}  // namespace

// x (batch, H, W, Cin), w (2, 2, Cin, Cout), bias (Cout,) -> out (batch, 2H, 2W, Cout),
// all contiguous float32; Cin and Cout multiples of 4. out may not alias an input.
extern "C" int mia_conv_transpose2x_f32(const void* x, const void* w, const void* bias, void* out,
                                        int batch, int H, int W, int Cin, int Cout, void* stream) {
  if (!sizes_ok(batch, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * H * W;
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_by_width<kFwd>(
      static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
      static_cast<const float*>(bias), static_cast<float*>(out), pixels, W, Cin, Cout, 4 * Cout,
      static_cast<cudaStream_t>(stream)));
}

// Number of pixel chunks the backward splits dw into: the caller allocates
// part (chunks * Cin * 4*Cout floats) and col_sums (chunks * 4*Cout floats).
extern "C" long long mia_conv_transpose2x_bwd_chunks(int batch, int H, int W, int Cin, int Cout) {
  if (!sizes_ok(batch, H, W, Cin, Cout)) return 0;
  const long long pixels = static_cast<long long>(batch) * H * W;
  if (pixels == 0) return 1;
  long long len;
  int chunks;
  dw_chunks(pixels, Cin, Cout, &len, &chunks);
  return chunks;
}

// Backward: x (batch, H, W, Cin), w (2, 2, Cin, Cout), dy (batch, 2H, 2W, Cout) ->
// dx (batch, H, W, Cin) when not null; dw (2, 2, Cin, Cout) and db (Cout,) when dw
// is not null, with part and col_sums as scratch. No output may alias an input.
extern "C" int mia_conv_transpose2x_bwd_f32(const void* x, const void* w, const void* dy, void* dx,
                                            void* dw, void* db, void* part, void* col_sums,
                                            int batch, int H, int W, int Cin, int Cout,
                                            void* stream) {
  if (!sizes_ok(batch, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* dyf = static_cast<const float*>(dy);
  if (dx != nullptr && pixels > 0) {
    const cudaError_t err = launch_by_width<kDx>(nullptr, wf, dyf, nullptr, static_cast<float*>(dx),
                                                 pixels, W, Cin, Cout, Cin, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dw == nullptr) return static_cast<int>(cudaSuccess);
  float* pf = static_cast<float*>(part);
  float* cf = static_cast<float*>(col_sums);
  const int N4 = 4 * Cout;
  long long len = kBK;
  int chunks = 1;
  if (pixels > 0) dw_chunks(pixels, Cin, Cout, &len, &chunks);
  int bm, bn;
  dw_tile(Cin, Cout, &bm, &bn);
  cudaError_t err;
#define MIA_DW(BM_, BN_, TM_, TN_)                                                              \
  launch_gemm<kDw, BM_, BN_, TM_, TN_>(xf, nullptr, dyf, nullptr, pf, cf, pixels, W, Cin, Cout, \
                                       Cin, N4, len, chunks, s)
  if (bm == 128 && bn == 128) {
    err = MIA_DW(128, 128, 8, 8);
  } else if (bm == 128) {
    err = MIA_DW(128, 64, 8, 4);
  } else if (bm == 64) {
    err = MIA_DW(64, 64, 4, 4);
  } else if (bm == 32 && bn == 128) {
    err = MIA_DW(32, 128, 4, 4);
  } else if (bm == 32) {
    err = MIA_DW(32, 64, 2, 4);
  } else if (bn == 128) {
    err = MIA_DW(16, 128, 2, 4);
  } else {
    err = MIA_DW(16, 64, 1, 4);
  }
#undef MIA_DW
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(Cin) * N4;
  conv_transpose2x_dw_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      pf, static_cast<float*>(dw), chunks, Cin, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_transpose2x_db_reduce_kernel<<<(Cout + 127) / 128, 128, 0, s>>>(cf, static_cast<float*>(db),
                                                                      chunks, Cout);
  return static_cast<int>(cudaGetLastError());
}
