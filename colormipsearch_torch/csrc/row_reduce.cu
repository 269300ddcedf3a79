// The sweep's collect for NVIDIA Hopper (sm_90a): each launch row's
// per-variant exact counts reduced on the card to its mask's score and
// mirrored flag, written into a dense [masks, targets] block that the host
// copies back in one piece.
//
// Replaces the host reduction (the JAX package's DeferredScore.finalize,
// colormipsearch_tpu/cds/pixel_pallas.py:995, a NumPy pass per mask over
// the counts copied to the host). Plain version:
// cds/multimask.py:row_reduce_plain; wrapper: multimask.py:row_reduce.
// The exact kernels (K1, K3a) add each row's counts from several window
// bins with warp sums and atomic adds, so a row's maxima exist only once
// they have ended: this is a second kernel, queued behind them on the same
// stream.
//
// Per row r, of engine e = eng[r] and target t = tgt[r], with S = nv / 2
// variants a direction:
//   direct = max(counts[r, :S]);
//   where e's flags hold MIRROR: mirror = max(counts[r, S:]), mirrored =
//     mirror > direct (strict: ties stay direct), best = max(direct,
//     mirror); otherwise best = direct and mirrored = 0 (a launch is
//     mirrored if any of its engines is);
//   where e's flags hold EMPTY (no query pixel): best = 0;
//   out[e, t] = best | mirrored << 31.
// The wrapper zeroes `out`, so a pair without a row (screened out) reads 0.
// Rows are distinct (engine, target) pairs: no two writes meet.
// Work split: a warp takes 32 consecutive rows, copies their 32 x nv
// counts into shared memory with coalesced 4-byte loads, and each lane then
// reduces one row. Bound: the bytes, a row's nv x 4 B of counts and 8 B of
// engine and target read and 4 B written (the wrapper zeroes the block, 4 B
// a pair, before the launch).

#include <algorithm>
#include <cstdint>

#include "multimask_common.cuh"  // cms::on_device

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NV_MAX = 32;        // shared memory: 32 KB a block
constexpr int MAX_BLOCKS = 4096;  // grid-stride beyond
constexpr uint8_t MIRROR = 1, EMPTY = 2;  // engine flags (multimask.py)

__global__ void __launch_bounds__(THREADS)
    row_reduce_kernel(const int32_t* __restrict__ counts, int n_rows,
                      int nv, const int32_t* __restrict__ eng,
                      const int32_t* __restrict__ tgt,
                      const uint8_t* __restrict__ flags, int n_targets,
                      int32_t* __restrict__ out) {
  extern __shared__ int32_t staged[];
  const int lane = threadIdx.x & 31;
  int32_t* mine = staged + (threadIdx.x >> 5) * 32 * nv;
  const int s = nv / 2;
  const int64_t step = static_cast<int64_t>(gridDim.x) * WARPS * 32;
  for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * WARPS +
                     (threadIdx.x >> 5)) * 32;
       r0 < n_rows; r0 += step) {
    const int n = n_rows - r0 < 32 ? static_cast<int>(n_rows - r0) : 32;
    const int32_t* src = counts + r0 * nv;
    for (int k = lane; k < n * nv; k += 32) mine[k] = src[k];
    __syncwarp();
    if (lane < n) {
      const int32_t* c = mine + lane * nv;
      int direct = c[0];
      for (int v = 1; v < s; ++v) direct = max(direct, c[v]);
      const int64_t r = r0 + lane;
      const int e = eng[r];
      const uint8_t f = flags[e];
      int best = direct;
      uint32_t mirrored = 0;
      if (f & MIRROR) {
        int mirror = c[s];
        for (int v = s + 1; v < nv; ++v) mirror = max(mirror, c[v]);
        if (mirror > direct) {
          best = mirror;
          mirrored = 1;
        }
      }
      if (f & EMPTY) best = 0;
      out[static_cast<int64_t>(e) * n_targets + tgt[r]] =
          static_cast<int32_t>(static_cast<uint32_t>(best) |
                               (mirrored << 31));
    }
    __syncwarp();
  }
}

}  // namespace

// counts: int32 [n_rows, nv] per-variant counts (direct variants, then
// mirrored); eng, tgt: int32 [n_rows] each row's engine and target; flags:
// uint8 [engines] each engine's MIRROR and EMPTY bits; out: int32
// [engines, n_targets], zeroed by the caller. Queued on `stream`.
extern "C" int cms_row_reduce(const void* counts, int n_rows, int nv,
                              const void* eng, const void* tgt,
                              const void* flags, int n_targets, void* out,
                              void* stream, int device) {
  if (n_rows < 0 || n_targets < 0 || nv < 2 || nv % 2 || nv > NV_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t warps = (static_cast<int64_t>(n_rows) + 31) / 32;
  const int blocks = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>((warps + WARPS - 1) / WARPS, MAX_BLOCKS)));
  const size_t smem = sizeof(int32_t) * WARPS * 32 * nv;
  return cms::on_device(device, [&] {
    row_reduce_kernel<<<blocks, THREADS, smem, st>>>(
        static_cast<const int32_t*>(counts), n_rows, nv,
        static_cast<const int32_t*>(eng), static_cast<const int32_t*>(tgt),
        static_cast<const uint8_t*>(flags), n_targets,
        static_cast<int32_t*>(out));
    return cudaGetLastError();
  });
}
