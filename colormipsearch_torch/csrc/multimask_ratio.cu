// Exact multi-mask colour-depth scorer for NVIDIA Hopper (sm_90a), ratio
// predicate.
//
// Replaces the two TPU (Pallas) kernels of the exact phase:
//   K1 colormipsearch_tpu/cds/multimask.py:_make_kernel (ratio=True,
//      acc2d=True), launched by _multimask_call_ratio;
//   K2 colormipsearch_tpu/cds/pixel_pallas.py:_make_kernel (ratio=True),
//      launched by _active_tile_call_ratio and _compact_call_ratio.
// Both compute the same function (K1 is K2's predicate and accumulator
// with another work layout, multimask.py:26-28), so this one kernel
// serves both: a K2 call is a launch whose rows all belong to one mask.
//
// What it computes: for each launch row (a mask m and a target t) and each
// variant of the xy-shift ring (oracle.shift_ring_offsets), direct and on
// the x-flipped frame, the number of m's query pixels over the row's live
// 8x128 tiles whose ratio predicate (_ratio_match, pixel_pallas.py:300-308)
// holds against the target pixel at that shift. Counts are int32 integers,
// so they are exact in any order.
//
// What bounds it on the card: per (row, tile, live direction) 9 predicate
// evaluations for each selected query pixel, ~21 SASS instructions each,
// ~16 of them on the ALU pipe (half the FP32 lane rate; chip_smoke.py
// phase 4 reads the pixel loop's SASS by pipe), against a 12 x 136 window
// of the two target planes (8.2 KB) read once per bin and 20 B of
// constants per selected pixel: the operations bound it.
//
// Design (work split, bins and staging: multimask_common.cuh), and what
// each part does about the first port's costs:
// - work follows the selected pixels: a warp's lanes take the entries of
//   a member tile's compact list (pixel_active.compact_selected: the
//   pixels whose three compare constants are not all sentinels, the
//   others never match), each entry's constant (q_cmp | place << 20) and
//   its four f32 bounds (one 16-byte load) read coalesced in list order;
//   a tile with no entry is never listed by the host;
// - targets are prepared once per partition, not per (row, tile): the f32
//   ratio plane a2/b2 (-1 where a2 == 0; the IEEE divide of _ratio_prep,
//   pixel_pallas.py:291-297) and the flag plane w >> 16 (uint8) are built
//   beside the padding (pixel_active.pad_ratio_planes), so staging is a
//   copy (16-byte cp.async chunks of the ratio plane, 4-byte chunks of the
//   flag plane), done once per window bin for every mask that reads it;
// - loads overlap compute across the blocks resident on an SM;
// - exact skips: a direction the host table marks dead (its window has no
//   target signal by the live-tile bitmaps or signal ranges) is neither
//   staged nor scored; a staged window without a sel bit is not scored.

#include "multimask_common.cuh"

namespace {

using namespace cms;

constexpr int POS_SHIFT = 20;  // pixel_active.POS_SHIFT["ratio"]

struct QConst {
  int sc, uc, dc;
  bool gup, gdn;
  float lo, hi, cup, cdn;
};

// All |S| shift variants of one query pixel against one staged plane pair.
// `base` is the pixel's (dx, dy) = (0, 0) position in the staged window.
template <int XY>
__device__ __forceinline__ void score_pixel(const float* __restrict__ rf,
                                            const uint8_t* __restrict__ fw,
                                            int base, const QConst& q,
                                            int (&cnt)[1 + 4 * XY]) {
  constexpr int NS = 1 + 4 * XY;
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    const int o = base + ring_dy(v) * WIN_W + ring_dx(v);
    const float r = rf[o];
    const int f = fw[o];
    const bool same_ok = ((f & 15) == q.sc) & (r >= q.lo) & (r <= q.hi);
    const bool up_ok = ((f & 31) == q.uc) & ((r <= q.cup) != q.gup);
    const bool dn_ok = ((f & 47) == q.dc) & ((r <= q.cdn) != q.gdn);
    cnt[v] += (same_ok | up_ok | dn_ok) ? 1 : 0;
  }
}

template <int XY>
__global__ void __launch_bounds__(THREADS)
multimask_ratio_kernel(const float* __restrict__ rf,
                       const uint8_t* __restrict__ fw,
                       const float* __restrict__ rf_m,
                       const uint8_t* __restrict__ fw_m, int hp, int wp,
                       const int32_t* __restrict__ sel_off,
                       const int32_t* __restrict__ sel_q,
                       const float4* __restrict__ sel_f32,
                       const int32_t* __restrict__ bin_off,
                       const int32_t* __restrict__ mem_row,
                       const int32_t* __restrict__ mem_tile, int mirror,
                       int32_t* __restrict__ out) {
  constexpr int S = XY;  // largest |dx|, |dy| of the ring
  constexpr int NS = 1 + 4 * XY;
  constexpr int NV = 2 * NS;
  constexpr int WH = TILE_H + 2 * S;
  constexpr int WN = WH * WIN_W;

  // [direction] windows of the ratio and flag planes
  __shared__ __align__(16) float rf_s[2][WN];
  __shared__ __align__(16) uint8_t fw_s[2][WN];

  const int m0 = bin_off[blockIdx.x];
  const int m1 = bin_off[blockIdx.x + 1];
  if (m0 == m1) return;  // uniform: an empty bin
  const int dirs = bin_dirs(mem_tile, m0, m1, mirror);
  if (dirs == 0) return;  // uniform: only rows that report 0
  const long long off = window_offset<S>(blockIdx.x, hp, wp);
  if (dirs & 1) {
    stage_window<WH>(rf_s[0], rf + off, wp);
    stage_window<WH>(fw_s[0], fw + off, wp);
  }
  if (dirs & 2) {
    stage_window<WH>(rf_s[1], rf_m + off, wp);
    stage_window<WH>(fw_s[1], fw_m + off, wp);
  }
  cp_async_commit();
  cp_async_wait<0>();
  const int live =
      block_live(((dirs & 1) ? window_has_sel<WH>(fw_s[0]) : 0)
                 | ((dirs & 2) ? 2 * window_has_sel<WH>(fw_s[1]) : 0));
  if (live == 0) return;  // uniform: no target signal in the window

  const int lane = threadIdx.x & 31;
  for (int m = m0 + (threadIdx.x >> 5); m < m1; m += WARPS) {
    const int e = mem_tile[m];
    const int d = (e >> DIR_SHIFT) & live;  // uniform over the warp
    if (d == 0) continue;
    const int tile = e & TILE_MASK;
    int cnt_d[NS];
    int cnt_m[NS];
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      cnt_d[v] = 0;
      cnt_m[v] = 0;
    }
    const int p1 = sel_off[tile + 1];
    for (int p = sel_off[tile] + lane; p < p1; p += 32) {
      const int qc = sel_q[p];
      const float4 qf = sel_f32[p];
      QConst q;
      q.sc = qc & 31;
      q.uc = (qc >> 5) & 31;
      q.dc = (qc >> 10) & 63;
      q.gup = ((qc >> 16) & 1) != 0;
      q.gdn = ((qc >> 17) & 1) != 0;
      q.lo = qf.x;
      q.hi = qf.y;
      q.cup = qf.z;
      q.cdn = qf.w;
      const int base = window_base<S>((qc >> POS_SHIFT) & POS_MASK);
      if (d & 1) score_pixel<XY>(rf_s[0], fw_s[0], base, q, cnt_d);
      if (d & 2) score_pixel<XY>(rf_s[1], fw_s[1], base, q, cnt_m);
    }
    warp_add<NS>(cnt_d, cnt_m, out + static_cast<long long>(mem_row[m]) * NV);
  }
}

template <int XY>
cudaError_t launch(const void* rf, const void* fw, const void* rf_m,
                   const void* fw_m, int hp, int wp, const void* sel_off,
                   const void* sel_q, const void* sel_f32, const void* bin_off,
                   int n_bins, const void* mem_row, const void* mem_tile,
                   int mirror, void* out, cudaStream_t stream) {
  multimask_ratio_kernel<XY><<<n_bins, THREADS, 0, stream>>>(
      static_cast<const float*>(rf), static_cast<const uint8_t*>(fw),
      static_cast<const float*>(rf_m), static_cast<const uint8_t*>(fw_m), hp,
      wp, static_cast<const int32_t*>(sel_off),
      static_cast<const int32_t*>(sel_q), static_cast<const float4*>(sel_f32),
      static_cast<const int32_t*>(bin_off),
      static_cast<const int32_t*>(mem_row),
      static_cast<const int32_t*>(mem_tile), mirror,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes by cds/kernels.py). `out` must
// hold zeros: the kernel adds each member's counts to its row. Launches
// on `stream` of card `device` and returns the first CUDA error of the
// launch (0 on success). The caller's current device is restored before
// return. Supported xy_shift: 0 and 2 (2|S| <= 32 variants, the
// reference's NV_PAD bound). The planes must be 16-byte aligned with wp a
// multiple of 16 (the wrapper checks both).
extern "C" int cms_multimask_ratio(
    const void* rf, const void* fw, const void* rf_m, const void* fw_m,
    int hp, int wp, const void* sel_off, const void* sel_q,
    const void* sel_f32, const void* bin_off, int n_bins,
    const void* mem_row, const void* mem_tile, int xy_shift, int mirror,
    void* out, void* stream, int device) {
  if (n_bins <= 0) return 0;
  if (xy_shift != 0 && xy_shift != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return xy_shift == 0
               ? launch<0>(rf, fw, rf_m, fw_m, hp, wp, sel_off, sel_q,
                           sel_f32, bin_off, n_bins, mem_row, mem_tile,
                           mirror, out, s)
               : launch<2>(rf, fw, rf_m, fw_m, hp, wp, sel_off, sel_q,
                           sel_f32, bin_off, n_bins, mem_row, mem_tile,
                           mirror, out, s);
  });
}
