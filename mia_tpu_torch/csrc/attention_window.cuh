// The window layout that K8 (the kRelWindow instances of attention_fwd_tc.cuh
// and, in bfloat16 at head dim 64, of attention_fwd_wgmma.cuh's window
// kernel) and K8b (the kWindow instance of attention_bwd_tc.cuh) share:
// windows of ws x ws slots carved from the unpartitioned (B, hg, wg) token
// grid, with no partitioned copy of any operand.
//
// blockIdx.z is a window of an image (batch * nwin of them); slot (i, j) of
// window (wy, wx) is grid token (wy ws + i, wx ws + j), or a pad slot when
// that lies outside the grid. Each block stages its window's slot -> token
// map in shared memory once (stage_slot_tokens), so no copy divides an
// index. A pad slot is a real key whose k and v are rows of pad_kv (the qkv
// Linear's output for a zero token) and whose rel bias is the query's for
// the slot position; it is no query. A window's queries lie in its first
// (hr - 1) ws + wr slots (window_queries), so query tiles past them have
// nothing to compute.

#pragma once

#include "tf32_mma.cuh"

namespace {

constexpr int kNoToken = -2;  // the slot map past n (slot_token gives -1 for a pad slot)

// The window geometry of a (hg, wg) grid of ws x ws windows: n = ws * ws
// slots, kh = kw = ws, nwx windows a grid row, nwin an image.
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

// The token (within its image) that slot `s` of window `win` stands for,
// or -1 for a pad slot.
template <typename Args>
__device__ __forceinline__ int slot_token(const Args& a, int s, int win) {
  const int ws = a.kw;
  const int i = s / ws;
  const int j = s - i * ws;
  const int gy = (win / a.nwx) * ws + i;
  const int gx = (win % a.nwx) * ws + j;
  return (gy < a.hg && gx < a.wg) ? gy * a.wg + gx : -1;
}

// One past the last slot of window `win` that holds a query. The window's
// hr x wr slots in the grid are its first rows and columns.
template <typename Args>
__device__ __forceinline__ int window_queries(const Args& a, int win) {
  const int ws = a.kw;
  const int wy = win / a.nwx;
  const int wx = win - wy * a.nwx;
  const int hr = min(ws, a.hg - wy * ws);
  const int wr = min(ws, a.wg - wx * ws);
  return (hr - 1) * ws + wr;
}

// The token of every slot 0 .. slots-1 of window `win`: a token >= 0, -1
// for a pad slot, kNoToken past n.
template <typename Args>
__device__ __forceinline__ void stage_slot_tokens(int* tok_s, const Args& a, int win, int slots) {
  for (int i = threadIdx.x; i < slots; i += kTcThreads)
    tok_s[i] = i < a.n ? slot_token(a, i, win) : kNoToken;
}

// Slots slot0 .. slot0+kRows-1 of one operand into a tile with rows of D + 4
// floats, by the slot map: a slot with a token copies the token's row, a
// pad slot pad_row (K, V) or zeros (pad_row null: Q, G), a slot past n zeros.
template <int D, int kRows = kTcTile>
__device__ __forceinline__ void copy_slots_async(float* dst, const float* __restrict__ base,
                                                 long long stride, const int* tok_s, int slot0,
                                                 const float* __restrict__ pad_row) {
  constexpr int kC = D / 4;
  for (int i = threadIdx.x; i < kRows * kC; i += kTcThreads) {
    const int r = i / kC;
    const int c = i - r * kC;
    const int tok = tok_s[slot0 + r];
    const bool valid = tok >= 0 || (tok == -1 && pad_row != nullptr);
    const float* src = tok >= 0 ? base + tok * stride : pad_row;
    cp_async16(dst + r * (D + 4) + 4 * c, valid ? src + 4 * c : base, valid);
  }
}

// The rel rows of slots q0 .. q0+63 into R (laid out as rel_view<false>) by
// the slot map: a slot with a token copies rows row_base + token of rel_h
// and rel_w, any other slot zeros. One warp a slot, one lane a column: no
// index is divided.
__device__ __forceinline__ void copy_rel_slots_async(float* R, const float* __restrict__ rel_h,
                                                     const float* __restrict__ rel_w,
                                                     long long row_base, const int* tok_s, int kh,
                                                     int kw, int q0) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kTcTile; r += kTcThreads / 32) {
    const int tok = tok_s[q0 + r];
    const long long row = row_base + tok;
    for (int j = lane; j < kh + kw; j += 32) {
      const bool h = j < kh;
      float* dst = h ? R + r * kh + j : R + kTcTile * kh + r * kw + (j - kh);
      const float* src = h ? rel_h + row * kh + j : rel_w + row * kw + (j - kh);
      cp_async4(dst, tok >= 0 ? src : rel_h, tok >= 0);
    }
  }
}

}  // namespace
