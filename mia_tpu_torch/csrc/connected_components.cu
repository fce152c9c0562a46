// K5 on Hopper: connected-component labels of a stack of binary masks.
//
// Replaces the TPU kernel mia_tpu/ops/morphology.py::connected_components_pallas
// (_cc_kernel). For each (H, W) mask every foreground pixel starts with its
// linear index and background with big = H*W; each sweep then runs, in this
// order,
//
//   1. a segmented min-scan along each row, forward then reverse
//      (background resets the running minimum);
//   2. the same along each column;
//   3. for 8-connectivity, a min over the four diagonal neighbours, all read
//      from one snapshot (so labels never chain across background),
//
// and exactly `iters` sweeps run. The output is the label, or -1 on
// background. The TPU kernel runs the scans as log-step Hillis-Steele
// shifts over the whole tile; here one thread walks one row (or column)
// sequentially. Min is associative, so both give the same labels after
// every scan, bit for bit, and with them the same labels after any number
// of sweeps, converged or not.
//
// Design: one block per mask, one thread per row (then per column). The
// labels live in shared memory, two (H, W+1) int32 buffers (the padded row
// stride keeps a row walk's lanes in different banks; the second buffer is
// the diagonal pass's output). At the default prompt-compute size 64 x 64
// that is 33 KB. A mask too large for shared memory (512 x 512 at native
// prompt resolution) runs the same code on a global-memory scratch buffer
// the wrapper allocates (mia_connected_components_scratch_elems).
//
// Bound: latency. Each sweep is 4 sequential walks of max(H, W) steps plus
// a barrier per phase; 144 masks of 64 x 64 are one wave of blocks.
//
// The kernel allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Background label inside the kernel. Any value above every pixel index
// works as the scans' reset marker and as min's identity, so it stands in
// for the reference's big = H*W, which never reaches the output (-1 there).
constexpr int kBg = 0x7fffffff;

// p[i * step], i in [0, count): segmented running min, forward then reverse
__device__ __forceinline__ void scan_line(int* p, int count, int step) {
  int run = kBg;
  for (int i = 0; i < count; ++i) {
    const int v = p[i * step];
    run = v == kBg ? kBg : min(run, v);
    p[i * step] = run;
  }
  run = kBg;
  for (int i = count - 1; i >= 0; --i) {
    const int v = p[i * step];
    run = v == kBg ? kBg : min(run, v);
    p[i * step] = run;
  }
}

template <bool kShared>
__global__ void connected_components_kernel(const int* __restrict__ mask, int* __restrict__ out,
                                            int* __restrict__ scratch, int H, int W, int iters,
                                            int connectivity) {
  extern __shared__ int smem_i[];
  const int P = W + 1;  // padded row stride
  const long long plane = static_cast<long long>(H) * P;
  int* cur = kShared ? smem_i : scratch + static_cast<long long>(blockIdx.x) * 2 * plane;
  int* nxt = cur + plane;
  const int hw = H * W;
  const int* m = mask + static_cast<long long>(blockIdx.x) * hw;
  int* o = out + static_cast<long long>(blockIdx.x) * hw;
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = t; i < hw; i += nt) cur[(i / W) * P + i % W] = m[i] > 0 ? i : kBg;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int y = t; y < H; y += nt) scan_line(cur + y * P, W, 1);
    __syncthreads();
    for (int x = t; x < W; x += nt) scan_line(cur + x, H, P);
    __syncthreads();
    if (connectivity == 2) {
      for (int i = t; i < hw; i += nt) {
        const int y = i / W;
        const int x = i - y * W;
        const int v = cur[y * P + x];
        int best = v;
        if (v != kBg) {
          if (y > 0 && x > 0) best = min(best, cur[(y - 1) * P + x - 1]);
          if (y > 0 && x + 1 < W) best = min(best, cur[(y - 1) * P + x + 1]);
          if (y + 1 < H && x > 0) best = min(best, cur[(y + 1) * P + x - 1]);
          if (y + 1 < H && x + 1 < W) best = min(best, cur[(y + 1) * P + x + 1]);
        }
        nxt[y * P + x] = best;
      }
      __syncthreads();
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  for (int i = t; i < hw; i += nt) {
    const int v = cur[(i / W) * P + i % W];
    o[i] = v == kBg ? -1 : v;
  }
}

int threads_for(int H, int W) {
  const int lines = H > W ? H : W;
  const int threads = ((lines + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

size_t smem_bytes(int H, int W) { return sizeof(int) * 2 * static_cast<size_t>(H) * (W + 1); }

bool fits_shared(int H, int W) {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return false;
  return smem_bytes(H, W) <= static_cast<size_t>(optin);
}

}  // namespace

// int32 scratch elements the kernel needs for n masks of (H, W): 0 when the
// labels fit in shared memory, else two padded planes per mask.
extern "C" long long mia_connected_components_scratch_elems(int n, int H, int W) {
  if (fits_shared(H, W)) return 0;
  return 2LL * n * H * (W + 1);
}

// mask (n, H, W) int32, nonzero = foreground -> out (n, H, W) int32 labels
// (-1 background) after `iters` sweeps; connectivity 1 (4-neighbours) or 2
// (8-neighbours). scratch: mia_connected_components_scratch_elems(n, H, W)
// int32 elements, or null when that is 0.
extern "C" int mia_connected_components_i32(const void* mask, void* out, void* scratch, int n,
                                            int H, int W, int iters, int connectivity,
                                            void* stream) {
  if (n == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(H) * W >= kBg || (connectivity != 1 && connectivity != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(H, W);
  const int* m = static_cast<const int*>(mask);
  int* o = static_cast<int*>(out);
  if (fits_shared(H, W)) {
    const size_t smem = smem_bytes(H, W);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          connected_components_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    connected_components_kernel<true><<<n, threads, smem, s>>>(m, o, nullptr, H, W, iters,
                                                               connectivity);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    connected_components_kernel<false><<<n, threads, 0, s>>>(m, o, static_cast<int*>(scratch), H,
                                                             W, iters, connectivity);
  }
  return static_cast<int>(cudaGetLastError());
}
