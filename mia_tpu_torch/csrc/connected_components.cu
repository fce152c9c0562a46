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
// for at most `iters` sweeps. The output is the label, or -1 on background.
// The TPU kernel runs the scans as log-step Hillis-Steele shifts over the
// whole tile.
//
// Design: after a forward and a reverse segmented min-scan, every
// foreground pixel of a line holds the minimum of its run, so steps 1 and 2
// are "each run takes its minimum", row by row and then column by column.
// One block owns a mask; kL lanes of a warp own a line, 32 / kL lines a
// warp at a time, and a lane holds kC adjacent pixels of the line in
// registers (kC x kL covers the longer side: 8 x 8 at 64 x 64). Two log-step
// segmented scans over the line's lanes, up and down (log2 kL shuffles
// each, a run's minimum and its stop packed in one word), bring each lane
// the minimum of the runs that reach it from the left and from the right;
// one pass over the lane's pixels then reads and writes each pixel once. A
// line longer than 512 pixels is scanned forward, then reverse, by a whole
// warp in chunks of 512, the running minimum carried from chunk to chunk.
// Min is associative, so the labels after every phase are those of the
// serial scans and of the TPU kernel's shifts, bit for bit. The diagonal
// step is elementwise, a warp a row. A sweep that changes no label is at
// its fixpoint, so every later sweep would change nothing: each mask's loop
// ends there (__syncthreads_or over the threads' change flags), and after
// `iters` sweeps at most. The labels are the same whether a mask converges
// or not.
//
// The labels live in shared memory, two (H, W+1) int32 buffers (the padded
// row stride spreads a column's lanes over the banks; the second buffer is
// the diagonal step's output). At the default prompt-compute size 64 x 64
// that is 33 KB, two blocks of 16 warps an SM; each warp takes four rows,
// then four columns. A mask too large for shared memory (512 x 512 at
// native prompt resolution) runs the same code on a global-memory scratch
// buffer the wrapper allocates (mia_connected_components_scratch_elems).
//
// Bound: latency and, where two masks share an SM (144 masks of 64 x 64 on
// 132 SMs), the integer issue of the line phases and the diagonal step: a
// sweep is two phases of one pass a warp, 8 shuffles a pass, and three
// barriers. The kernel's time is set by the mask that takes the most
// sweeps.
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;  // warps a block: 512 threads, two blocks an SM

// The lane scans carry a run's minimum and whether a background pixel
// stops it in one word: bit 31 the stop, bits 0-30 the minimum (every label
// and kBg fit in 31 bits), so each step is one shuffle.
constexpr unsigned kStop = 0x80000000u;

// The segmented inclusive scan of (minimum, stop) words over the kL lanes
// that hold one line (lane: the lane's place among them): what reaches the
// end of lane l from lanes 0 .. l (kDown: from lanes l .. kL-1), stopped by
// the first background pixel on the way.
template <bool kDown, int kL>
__device__ __forceinline__ unsigned lane_scan(unsigned w, int lane) {
#pragma unroll
  for (int d = 1; d < kL; d <<= 1) {
    unsigned o;
    if constexpr (kDown) {
      o = __shfl_down_sync(kFull, w, d, kL);
    } else {
      o = __shfl_up_sync(kFull, w, d, kL);
    }
    if ((kDown ? lane + d < kL : lane >= d) && !(w & kStop)) w = (o & kStop) | min(w, o & ~kStop);
  }
  return w;
}

// A line of at most kL kC pixels, p[i * step], held by kL lanes (lane: the
// lane's place among them; len 0 for lanes without a line): every
// foreground pixel takes the minimum of its run, in one pass. A lane holds
// pixels kC lane .. kC lane + kC - 1; the runs' minima from the left and
// from the right of the lane come from one scan each way over the line's
// lanes. Returns whether a pixel changed.
template <int kC, int kL>
__device__ __forceinline__ int run_min_line(int* p, int step, int len, int lane) {
  int x[kC];
  int left = kBg, right = kBg;  // the minimum of the lane's first and last runs
  unsigned stop = 0;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int i = lane * kC + c;
    x[c] = i < len ? p[i * step] : kBg;
    stop |= x[c] == kBg ? kStop : 0u;
    right = x[c] == kBg ? kBg : min(right, x[c]);
  }
#pragma unroll
  for (int c = kC - 1; c >= 0; --c) left = x[c] == kBg ? kBg : min(left, x[c]);
  // what enters the lane from the left and from the right
  const unsigned up = __shfl_up_sync(kFull, lane_scan<false, kL>(stop | right, lane), 1, kL);
  const unsigned down = __shfl_down_sync(kFull, lane_scan<true, kL>(stop | left, lane), 1, kL);
  int from_left = lane == 0 ? kBg : static_cast<int>(up & ~kStop);
  int from_right = lane == kL - 1 ? kBg : static_cast<int>(down & ~kStop);
  int y[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) y[c] = from_left = x[c] == kBg ? kBg : min(from_left, x[c]);
  int changed = 0;
#pragma unroll
  for (int c = kC - 1; c >= 0; --c) {
    from_right = y[c] == kBg ? kBg : min(from_right, y[c]);
    const int i = lane * kC + c;
    if (i < len && from_right != x[c]) {
      p[i * step] = from_right;
      changed = 1;
    }
  }
  return changed;
}

// A longer line, in chunks of 32 kC: the segmented running min in place,
// forward (kReverse: from the end), the minimum carried from chunk to
// chunk. Returns whether a pixel changed.
template <int kC, bool kReverse>
__device__ __forceinline__ int seg_scan_chunks(int* p, int step, int len, int lane) {
  constexpr int kChunk = 32 * kC;
  int carry = kBg;  // the running minimum that enters the chunk
  int changed = 0;
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    int x[kC];
    int run = kBg;
    unsigned stop = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int i = c0 + lane * kC + c;
      x[c] = i < len ? p[(kReverse ? len - 1 - i : i) * step] : kBg;
      stop |= x[c] == kBg ? kStop : 0u;
      run = x[c] == kBg ? kBg : min(run, x[c]);
    }
    const unsigned w = lane_scan<false, 32>(stop | run, lane);
    // what enters the lane: from the lanes before it, and the chunk's carry
    // where no background pixel stops it
    const unsigned up = __shfl_up_sync(kFull, w, 1);
    const unsigned enter = lane == 0 ? static_cast<unsigned>(kBg) : up;
    int in = enter & kStop ? static_cast<int>(enter & ~kStop) : min(carry, static_cast<int>(enter));
    const unsigned last = __shfl_sync(kFull, w, 31);
    carry = last & kStop ? static_cast<int>(last & ~kStop) : min(carry, static_cast<int>(last));
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int i = c0 + lane * kC + c;
      in = x[c] == kBg ? kBg : min(in, x[c]);
      if (i < len && in != x[c]) {
        p[(kReverse ? len - 1 - i : i) * step] = in;
        changed = 1;
      }
    }
  }
  return changed;
}

// Every foreground pixel of the lines p + l * stride (l in [0, lines)),
// pixels p[l * stride + i * step] (i in [0, len)), takes the minimum of its
// run (the segmented min-scan forward, then reverse): a warp takes 32 / kL
// lines at a time, kL lanes a line. Returns whether a pixel changed.
template <int kC, int kL>
__device__ __forceinline__ int run_min(int* p, int stride, int step, int lines, int len,
                                       int warp, int warps, int lane) {
  constexpr int kG = 32 / kL;  // lines a warp at a time
  int changed = 0;
  if constexpr (kL == 32) {
    if (len > 32 * kC) {  // in chunks, forward then reverse, a line a warp
      for (int l = warp; l < lines; l += warps) {
        changed |= seg_scan_chunks<kC, false>(p + l * stride, step, len, lane);
        __syncwarp();  // the reverse scan reads what other lanes wrote
        changed |= seg_scan_chunks<kC, true>(p + l * stride, step, len, lane);
        __syncwarp();
      }
      return changed;
    }
  }
  for (int l0 = warp * kG; l0 < lines; l0 += warps * kG) {
    const int l = l0 + lane / kL;
    changed |= run_min_line<kC, kL>(p + (l < lines ? l : 0) * stride, step, l < lines ? len : 0,
                                    lane & (kL - 1));
  }
  return changed;
}

template <int kC, int kL, bool kShared>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    connected_components_kernel(const int* __restrict__ mask, int* __restrict__ out,
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
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = nt >> 5;

  for (int i = t; i < hw; i += nt) cur[(i / W) * P + i % W] = m[i] > 0 ? i : kBg;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    int changed = 0;
    changed |= run_min<kC, kL>(cur, P, 1, H, W, warp, warps, lane);  // rows
    __syncthreads();
    changed |= run_min<kC, kL>(cur, 1, P, W, H, warp, warps, lane);  // columns
    __syncthreads();
    if (connectivity == 2) {  // a warp a row, a lane a column: no index divided
      for (int y = warp; y < H; y += warps) {
        for (int x = lane; x < W; x += 32) {
          const int v = cur[y * P + x];
          int best = v;
          if (v != kBg) {
            if (y > 0 && x > 0) best = min(best, cur[(y - 1) * P + x - 1]);
            if (y > 0 && x + 1 < W) best = min(best, cur[(y - 1) * P + x + 1]);
            if (y + 1 < H && x > 0) best = min(best, cur[(y + 1) * P + x - 1]);
            if (y + 1 < H && x + 1 < W) best = min(best, cur[(y + 1) * P + x + 1]);
          }
          nxt[y * P + x] = best;
          changed |= best != v;
        }
      }
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    // the barrier before the next sweep reads; no label changed: fixpoint
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = t; i < hw; i += nt) {
    const int v = cur[(i / W) * P + i % W];
    o[i] = v == kBg ? -1 : v;
  }
}

// Threads a block: a warp for each 32 / kL lines of the longer side, at
// most kMaxWarps warps.
int threads_for(int H, int W, int kL) {
  const int lines = H > W ? H : W;
  const int warps = (lines + 32 / kL - 1) / (32 / kL);
  return 32 * (warps < kMaxWarps ? warps : kMaxWarps);
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

template <int kC, int kL>
int launch(const int* m, int* o, int* scratch, int n, int H, int W, int iters, int connectivity,
           cudaStream_t s) {
  const int threads = threads_for(H, W, kL);
  if (fits_shared(H, W)) {
    const size_t smem = smem_bytes(H, W);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          connected_components_kernel<kC, kL, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    connected_components_kernel<kC, kL, true><<<n, threads, smem, s>>>(m, o, nullptr, H, W, iters,
                                                                   connectivity);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    connected_components_kernel<kC, kL, false><<<n, threads, 0, s>>>(m, o, scratch, H, W, iters,
                                                                 connectivity);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 scratch elements the kernel needs for n masks of (H, W): 0 when the
// labels fit in shared memory, else two padded planes per mask.
extern "C" long long mia_connected_components_scratch_elems(int n, int H, int W) {
  if (fits_shared(H, W)) return 0;
  return 2LL * n * H * (W + 1);
}

// mask (n, H, W) int32, nonzero = foreground -> out (n, H, W) int32 labels
// (-1 background) after at most `iters` sweeps (fewer where a sweep changes
// nothing); connectivity 1 (4-neighbours) or 2 (8-neighbours). scratch:
// mia_connected_components_scratch_elems(n, H, W) int32 elements, or null
// when that is 0.
extern "C" int mia_connected_components_i32(const void* mask, void* out, void* scratch, int n,
                                            int H, int W, int iters, int connectivity,
                                            void* stream) {
  if (n == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(H) * W >= kBg || (connectivity != 1 && connectivity != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(mask);
  int* o = static_cast<int*>(out);
  int* sc = static_cast<int*>(scratch);
  // kC pixels a lane, kL lanes a line, to cover the longer side; above 512
  // pixels a line is taken in chunks of 512
  const int len = H > W ? H : W;
  if (len <= 32) return launch<4, 8>(m, o, sc, n, H, W, iters, connectivity, s);
  if (len <= 64) return launch<8, 8>(m, o, sc, n, H, W, iters, connectivity, s);
  if (len <= 128) return launch<8, 16>(m, o, sc, n, H, W, iters, connectivity, s);
  if (len <= 256) return launch<8, 32>(m, o, sc, n, H, W, iters, connectivity, s);
  return launch<16, 32>(m, o, sc, n, H, W, iters, connectivity, s);
}
