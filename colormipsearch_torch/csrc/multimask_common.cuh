// Shared parts of the exact multi-mask kernels (multimask_ratio.cu, the
// ratio predicate; multimask_words.cu, the packed-word predicate): tile
// geometry, the xy-shift ring, the staged window and its asynchronous
// copy, the window bins and the warp sums of the per-variant counters; and
// the device switch of every C entry point (op_chain.cu's too).
//
// Work split of both kernels. A launch row is a mask and a target; each
// row's live tiles make (row, tile) members. The wrapper sorts the members
// into bins by the target window they read, one bin per (target, tile
// position), in target order (cds/multimask.py:window_bins). Masks whose
// active tiles sit at the same place share a bin, so its window is staged
// once for all of them, where a block per row staged it once per row (an
// at-size partition restaged each window ~45 times, and that copy traffic
// from L2 bounded the kernel).
//
// One block per bin (an empty bin exits at once; the hardware schedules
// the blocks, so bins of any size balance). The block stages the window of
// the padded target planes that the shifts reach, for each direction
// (direct, mirrored) a member needs: rows cy+8-s .. cy+15+s and the 136
// columns from cx+124, a 16-byte aligned superset of the reference's
// (8+2s) x (128+2s) region, with cp.async. Several blocks are resident on
// an SM, so one block's copies are in flight while others compute. A
// window without an above-threshold target pixel (sel, bit 19 of a word,
// bit 3 of a flag byte) scores 0 for every query pixel, so the block skips
// it: exact.
//
// The warps take the bin's members in turn; a warp's lanes walk the member
// tile's compact list of selected query pixels (those that can match; host
// lists, pixel_active.compact_selected), one pixel per lane per pass with
// one register counter per variant, so work follows the selected pixels
// and a tile without any costs nothing. The warp then sums each counter
// (one REDUX per variant) and adds it to the row's counts with one atomic
// add per variant: integer adds, exact in any order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cms {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_PX = TILE_H * TILE_W;
// the staged window starts WIN_X0 columns left of the tile's shift-0
// column: cx + 128 - 4 is a multiple of 4 elements (16 bytes of f32/int32)
constexpr int WIN_X0 = 4;
constexpr int WIN_W = TILE_W + 2 * WIN_X0;  // 136 = 34 chunks of 4 elements
constexpr int CHUNKS_PER_ROW = WIN_W / 4;
// a member's entry: tile | directions << DIR_SHIFT (multimask.py)
constexpr int DIR_SHIFT = 29;
constexpr int TILE_MASK = (1 << DIR_SHIFT) - 1;
constexpr int POS_MASK = TILE_PX - 1;  // a compact entry's place in its tile

// Shift v of oracle.shift_ring_offsets(xy): v = 0 is (0, 0); then for each
// ring i = 2, 4, .. the 8 offsets (xx, yy) in {-i, 0, i}^2 without (0, 0),
// xx major. Returns (dx, dy) = (xx, yy).
__host__ __device__ constexpr int ring_dx(int v) {
  if (v == 0) return 0;
  const int i = 2 * ((v - 1) / 8 + 1);
  const int k = (v - 1) % 8;
  return k < 3 ? -i : (k < 5 ? 0 : i);
}

__host__ __device__ constexpr int ring_dy(int v) {
  if (v == 0) return 0;
  const int i = 2 * ((v - 1) / 8 + 1);
  const int k = (v - 1) % 8;
  const int pos = k < 3 ? k : (k == 3 ? 0 : (k == 4 ? 2 : k - 5));
  return pos == 0 ? -i : (pos == 1 ? 0 : i);
}

// Offset in a staged window of a query pixel's shift-0 target, from its
// place y * 128 + x in the tile.
template <int S>
__device__ __forceinline__ int window_base(int pos) {
  return ((pos >> 7) + S) * WIN_W + (pos & 127) + WIN_X0;
}

// ---- asynchronous copies (sm_80+) ------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  } else {
    static_assert(BYTES == 4, "4- or 16-byte chunks");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's most recent groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of a WH x WIN_W window of T (4-byte f32/int32 or 1-byte
// flags) from src (row pitch wp elements) into dst, in chunks of 4
// elements; each thread copies the chunks c = threadIdx.x + k * THREADS.
template <int WH, class T>
__device__ __forceinline__ void stage_window(T* dst, const T* src, int wp) {
  for (int c = threadIdx.x; c < WH * CHUNKS_PER_ROW; c += THREADS) {
    const int y = c / CHUNKS_PER_ROW;
    const int x = (c - y * CHUNKS_PER_ROW) * 4;
    const T* from = src + static_cast<long long>(y) * wp + x;
    cp_async<static_cast<int>(4 * sizeof(T))>(dst + y * WIN_W + x, from);
  }
}

// Whether this thread's chunks of a staged window (stage_window's split)
// hold a sel bit; valid once its copies have landed (cp_async_wait).
template <int WH, class T>
__device__ __forceinline__ int window_has_sel(const T* win) {
  int any = 0;
  for (int c = threadIdx.x; c < WH * CHUNKS_PER_ROW; c += THREADS) {
    const int y = c / CHUNKS_PER_ROW;
    const T* p = win + y * WIN_W + (c - y * CHUNKS_PER_ROW) * 4;
    if constexpr (sizeof(T) == 1) {  // flag bytes: sel is bit 3
      any |= (*reinterpret_cast<const uint32_t*>(p) & 0x08080808u) != 0;
    } else {  // words: sel is bit 19
      const int4 v = *reinterpret_cast<const int4*>(p);
      any |= ((v.x | v.y | v.z | v.w) >> 19) & 1;
    }
  }
  return any;
}

// The directions whose staged window holds a sel bit anywhere in the
// block, from each thread's own chunks (`mine`); its barriers also make
// every thread's copies visible. Uniform over the block.
__device__ __forceinline__ int block_live(int mine) {
  return (__syncthreads_or(mine & 1) ? 1 : 0)
         | (__syncthreads_or(mine & 2) ? 2 : 0);
}

// Add a warp's counters to its member row's counts (out_row: direct
// variants then mirrored): one warp sum per variant, then lane v adds
// variant v's, when it is not 0.
template <int NS>
__device__ __forceinline__ void warp_add(const int (&cnt_d)[NS],
                                         const int (&cnt_m)[NS],
                                         int32_t* __restrict__ out_row) {
  constexpr int NV = 2 * NS;
  const int lane = threadIdx.x & 31;
  int mine = 0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int s =
        __reduce_add_sync(0xffffffffu, v < NS ? cnt_d[v] : cnt_m[v - NS]);
    if (lane == v) mine = s;
  }
  if (lane < NV && mine != 0) atomicAdd(out_row + lane, mine);
}

// Offset in the padded planes (hp x wp per target; tiles on a gh x gw
// grid inside a one-tile ring) of the staged window of bin = target *
// gh * gw + ty * gw + tx, whose tile origin is (cy, cx) = (8 ty, 128 tx).
template <int S>
__device__ __forceinline__ long long window_offset(int bin, int hp, int wp) {
  const int gh = hp / TILE_H - 2;
  const int gw = wp / TILE_W - 2;
  const int t = bin / (gh * gw);
  const int pos = bin - t * (gh * gw);
  const int cy = (pos / gw) * TILE_H;
  const int cx = (pos - (pos / gw) * gw) * TILE_W;
  return (static_cast<long long>(t) * hp + cy + TILE_H - S) * wp + cx
         + TILE_W - WIN_X0;
}

// The directions the bin's members need, over the block (uniform).
__device__ __forceinline__ int bin_dirs(const int32_t* __restrict__ mem_tile,
                                        int m0, int m1, int mirror) {
  int u = 0;
  for (int m = m0 + threadIdx.x; m < m1; m += THREADS)
    u |= mem_tile[m] >> DIR_SHIFT;
  return block_live(u & (mirror ? 3 : 1));
}

// Run launch() with `device` current and restore the caller's device;
// returns the first error (0 on success).
template <class Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch();
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

}  // namespace cms
