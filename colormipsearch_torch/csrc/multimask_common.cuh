// Shared parts of the exact multi-mask kernels (multimask_ratio.cu, the
// ratio predicate; multimask_words.cu, the packed-word predicate): tile
// geometry, the xy-shift ring, the work split over threads, the staging
// of one (row, tile) region in shared memory and the block reduction of
// the per-variant counters; and the device switch of every C entry point
// (op_chain.cu's too).
//
// Work split of both kernels: one thread block per launch row (a mask and
// a target, given by the host table) walks the row's live-tile list
// tile_list[row_off[r] .. row_off[r+1]). No state carries across blocks.
// Per (row, tile) the block stages the (8+2s) x (128+2s) region of the
// padded frame that the shifts reach (origin (cy+8-s, cx+128-s)), direct
// and flipped; each of the 256 threads owns 4 query pixels (one column,
// rows r, r+2, r+4, r+6) and keeps one register counter per variant.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cms {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int TILE_PX = TILE_H * TILE_W;
constexpr int ROWS_PER_PASS = THREADS / TILE_W;     // 2
constexpr int PX_PER_THREAD = TILE_PX / THREADS;    // 4

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

// Stage the region of one (row, tile) at window origin (ry, rx) of the
// frame that starts at fbase: put(plane, e, word) stores element e of
// plane 0 (direct) or 1 (x-flipped, only when mirror). Returns, the same
// in every thread of the block, bit 0 set when the direct region holds an
// above-threshold target pixel (sel, bit 19 of a word) and bit 1 for the
// flipped one. A region without one scores 0 for every query pixel (both
// predicates AND the target's sel bit), so the caller skips it: exact.
template <int S, class Put>
__device__ __forceinline__ int stage_region(
    const int32_t* __restrict__ frames, const int32_t* __restrict__ flipped,
    long long fbase, int wp, int ry, int rx, int mirror, Put put) {
  constexpr int RW = TILE_W + 2 * S;
  constexpr int RN = (TILE_H + 2 * S) * RW;
  __syncthreads();  // the previous tile's readers are done
  int any_d = 0;
  int any_m = 0;
  for (int e = threadIdx.x; e < RN; e += THREADS) {
    const int y = e / RW;
    const int x = e - y * RW;
    const long long off = fbase + static_cast<long long>(ry + y) * wp
                          + (rx + x);
    const int wd = frames[off];
    put(0, e, wd);
    any_d |= (wd >> 19) & 1;
    if (mirror) {
      const int wm = flipped[off];
      put(1, e, wm);
      any_m |= (wm >> 19) & 1;
    }
  }
  any_d = __syncthreads_or(any_d);
  any_m = __syncthreads_or(any_m);
  return (any_d ? 1 : 0) | (any_m ? 2 : 0);
}

// Sum every variant's counter over the block and write the row's counts,
// direct variants then mirrored: warp shuffles, then one partial per warp
// in shared memory.
template <int NS>
__device__ __forceinline__ void reduce_write(const int (&cnt_d)[NS],
                                             const int (&cnt_m)[NS],
                                             int32_t* __restrict__ out_row) {
  constexpr int NV = 2 * NS;
  __shared__ int red_s[THREADS / 32][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    int x = v < NS ? cnt_d[v] : cnt_m[v - NS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red_s[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red_s[w][threadIdx.x];
    out_row[threadIdx.x] = s;
  }
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
