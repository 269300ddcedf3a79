// The exact launch's table for NVIDIA Hopper (sm_90a): each survivor row's
// live-tile list, built on the card from inputs that are already there, so
// that the sweep's host thread neither waits for the live tiles nor
// expands rows by tiles.
//
// Replaces a host build (a NumPy pass over every (row, listed tile)
// candidate; the JAX package builds its launch tables on the host too,
// colormipsearch_tpu/cds/multimask.py:529 `_build_launches`). Plain
// version: cds/multimask.py:launch_table_plain, which the kernel equals
// bit for bit; wrapper: multimask.py:launch_table.
//   1. codes_kernel: for each target and tile position on the mask tile
//      grid, the directions (bit 0 direct, bit 1 mirrored) in which a tile
//      there can score: the live-tile bitmaps and the target's signal
//      extents, the exact tests of multimask.py:direction_codes_plain;
//   2. count_kernel: one warp a row (engine, target); its lanes take the
//      engine's listed tiles 32 at a time and count those whose code is
//      not 0 (one ballot a step);
//   3. (the wrapper) row_off = the exclusive scan of the counts, on the
//      card;
//   4. write_kernel: the same walk; each kept tile goes to row_off[row] +
//      the kept tiles before it (the ballot's lower lanes), as
//      tile | code << DIR_SHIFT, so a row's tiles keep the engine's order.
// The host sizes tile_list by the candidate count (every row's listed
// tiles), which it knows from the survivors, so nothing waits for the
// card; the entries past row_off[R] stay 0.
// Bound: the bytes, each pass reading a candidate's grid position (4 B)
// and code (1 B), the write pass a kept tile's index (4 B) and its entry
// (4 B written), and the rows; the positions and codes of one engine's
// rows are shared, so most reads hit L2.

#include <algorithm>
#include <cstdint>

#include "multimask_common.cuh"  // cms::on_device, TILE_H, TILE_W, DIR_SHIFT

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 4096;  // grid-stride beyond

__global__ void __launch_bounds__(THREADS)
    codes_kernel(const int32_t* __restrict__ ext, int n_ext,
                 const uint8_t* __restrict__ live_d,
                 const uint8_t* __restrict__ live_m, int64_t n_codes,
                 int gh, int gw, int width, int reach_y, int reach_x,
                 int mirror, uint8_t* __restrict__ codes) {
  const int g = gh * gw;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n_codes; i += stride) {
    const int64_t t = i / g;
    const int p = static_cast<int>(i - t * g);
    const int ty = p / gw, tx = p - (p / gw) * gw;
    bool d = true, m = mirror != 0;
    if (live_d != nullptr) {
      d = d && live_d[i] != 0;
      m = m && live_m[i] != 0;
    }
    if (n_ext >= 2) {
      // a tile's shifts sample raw rows [cy - s, cy + 8 + s) and cols
      // [cx - sx, cx + 128 + sx); the mirror pass samples the x-flipped
      // raw plane, whose signal cols are the reflection of the target's
      const int32_t* e = ext + t * n_ext;
      const int cy = ty * cms::TILE_H;
      const bool rok = cy >= e[0] - cms::TILE_H - reach_y + 1 &&
                       cy <= e[1] + reach_y;
      d = d && rok;
      m = m && rok;
      if (n_ext >= 4) {
        const int cx = tx * cms::TILE_W, c0 = e[2], c1 = e[3];
        d = d && cx >= c0 - cms::TILE_W - reach_x + 1 && cx <= c1 + reach_x;
        m = m && cx >= width - 1 - c1 - cms::TILE_W - reach_x + 1 &&
            cx <= width - 1 - c0 + reach_x;
      }
    }
    codes[i] = static_cast<uint8_t>(d | (m << 1));
  }
}

__global__ void __launch_bounds__(THREADS)
    count_rows_kernel(const uint8_t* __restrict__ codes, int g,
                      const int32_t* __restrict__ rows, int n_rows,
                      const int32_t* __restrict__ listed_off,
                      const int32_t* __restrict__ listed_pos,
                      int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * WARPS;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < n_rows;
       r += n_warps) {
    const int e = rows[r];
    const uint8_t* c = codes + static_cast<int64_t>(rows[n_rows + r]) * g;
    const int a = listed_off[e], b = listed_off[e + 1];
    int n = 0;
    for (int j0 = a; j0 < b; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < b && c[listed_pos[j]] != 0;
      n += __popc(__ballot_sync(0xffffffffu, keep));
    }
    if (lane == 0) counts[r] = n;
  }
}

__global__ void __launch_bounds__(THREADS)
    write_rows_kernel(const uint8_t* __restrict__ codes, int g,
                      const int32_t* __restrict__ rows, int n_rows,
                      const int32_t* __restrict__ listed,
                      const int32_t* __restrict__ listed_off,
                      const int32_t* __restrict__ listed_pos,
                      const int32_t* __restrict__ row_off,
                      int32_t* __restrict__ tile_list) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n_warps = gridDim.x * WARPS;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < n_rows;
       r += n_warps) {
    const int e = rows[r];
    const uint8_t* c = codes + static_cast<int64_t>(rows[n_rows + r]) * g;
    const int a = listed_off[e], b = listed_off[e + 1];
    int out = row_off[r];
    for (int j0 = a; j0 < b; j0 += 32) {
      const int j = j0 + lane;
      const int code = j < b ? c[listed_pos[j]] : 0;
      const unsigned kept = __ballot_sync(0xffffffffu, code != 0);
      if (code != 0)
        tile_list[out + __popc(kept & below)] =
            listed[j] | (code << cms::DIR_SHIFT);
      out += __popc(kept);
    }
  }
}

int blocks_for(int64_t threads) {
  return static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>((threads + THREADS - 1) / THREADS, MAX_BLOCKS)));
}

}  // namespace

// Passes 1-2: the direction codes of n_targets x gh x gw tile positions
// into `codes` (u8 scratch), then each row's kept tiles into `counts`
// (int32 [n_rows]). ext: int32 [n_targets, n_ext] signal extents (n_ext 2:
// first and last row; 4: and first and last column), or null with n_ext
// 0; live_d, live_m: bool [n_targets, gh, gw] live-tile bitmaps, or both
// null; rows: int32 [2, n_rows], each row's engine, then its target;
// listed_off: int32 [engines + 1] and listed_pos: int32 [listed] each
// engine's listed tiles and their grid positions. Queued on `stream`.
extern "C" int cms_launch_table_count(
    const void* ext, int n_ext, const void* live_d, const void* live_m,
    int n_targets, int gh, int gw, int width, int reach_y, int reach_x,
    int mirror, const void* rows, int n_rows, const void* listed_off,
    const void* listed_pos, void* codes, void* counts, void* stream,
    int device) {
  if (n_rows < 0 || n_targets < 0 || gh <= 0 || gw <= 0 ||
      (n_ext != 0 && n_ext != 2 && n_ext != 4) ||
      ((live_d == nullptr) != (live_m == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_codes = static_cast<int64_t>(n_targets) * gh * gw;
  return cms::on_device(device, [&] {
    if (n_codes > 0)
      codes_kernel<<<blocks_for(n_codes), THREADS, 0, s>>>(
          static_cast<const int32_t*>(ext), ext == nullptr ? 0 : n_ext,
          static_cast<const uint8_t*>(live_d),
          static_cast<const uint8_t*>(live_m), n_codes, gh, gw, width,
          reach_y, reach_x, mirror, static_cast<uint8_t*>(codes));
    count_rows_kernel<<<blocks_for(static_cast<int64_t>(n_rows) * 32),
                        THREADS, 0, s>>>(
        static_cast<const uint8_t*>(codes), gh * gw,
        static_cast<const int32_t*>(rows), n_rows,
        static_cast<const int32_t*>(listed_off),
        static_cast<const int32_t*>(listed_pos),
        static_cast<int32_t*>(counts));
    return cudaGetLastError();
  });
}

// Pass 4: each row's kept tiles into tile_list from row_off[row] on
// (row_off: int32 [n_rows + 1], the exclusive scan of pass 2's counts);
// listed: int32 [listed] the stacked tile index of each listed tile; the
// other arguments as cms_launch_table_count's. Queued on `stream`.
extern "C" int cms_launch_table_write(
    const void* codes, int g, const void* rows, int n_rows,
    const void* listed, const void* listed_off, const void* listed_pos,
    const void* row_off, void* tile_list, void* stream, int device) {
  if (n_rows < 0 || g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    write_rows_kernel<<<blocks_for(static_cast<int64_t>(n_rows) * 32),
                        THREADS, 0, s>>>(
        static_cast<const uint8_t*>(codes), g,
        static_cast<const int32_t*>(rows), n_rows,
        static_cast<const int32_t*>(listed),
        static_cast<const int32_t*>(listed_off),
        static_cast<const int32_t*>(listed_pos),
        static_cast<const int32_t*>(row_off),
        static_cast<int32_t*>(tile_list));
    return cudaGetLastError();
  });
}
