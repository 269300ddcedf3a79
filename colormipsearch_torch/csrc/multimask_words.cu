// Exact multi-mask colour-depth scorer for NVIDIA Hopper (sm_90a),
// packed-word predicate.
//
// Replaces the TPU (Pallas) kernels of the exact phase under
// CMS_RATIO_PRED=0:
//   K3a colormipsearch_tpu/cds/multimask.py:_make_kernel (ratio=False,
//       word branch :198-212), launched by _multimask_call;
//   K3b colormipsearch_tpu/cds/pixel_pallas.py:_make_kernel (ratio=False,
//       word branch :505-534), launched by _active_tile_call and
//       _compact_call.
// As K1 and K2 (multimask_ratio.cu), K3b is K3a for one mask, so this one
// kernel serves both: a K3b call is a launch whose rows all belong to one
// mask.
//
// What it computes: K1's counts, through the exact staged-rational
// hue-gap test on the raw packed words (_match_predicate,
// pixel_pallas.py:57-260 and :311-320) instead of the f32 ratio bounds.
// The same scores, by integer arithmetic alone, so on the card it is an
// independent witness for the ratio kernel.
//
// What bounds it on the card: per (row, tile, live direction) 9
// evaluations of the staged-rational chain for each selected query pixel,
// ~80 SASS instructions each in the pixel loop's static body, ~54 of them
// on the ALU pipe (half the FP32 lane rate; chip_smoke.py phase 4 reads
// the loop by pipe), against a 12 x 136 window of target words (6.5 KB)
// read once per bin and 4 B per selected pixel: the operations bound it,
// ~4x K1's.
//
// Design (work split, bins and staging: multimask_common.cuh, as K1):
// - work follows the selected pixels: a warp's lanes take the entries of
//   a member tile's compact list (pixel_active.compact_selected: sel = 1
//   and one of the three cases' query-side preconditions holds, since the
//   predicate ANDs qsel & tsel, pixel_pallas.py:118, and each case needs
//   its precondition); an entry is the raw word with its place in the tile
//   at bit 22, read coalesced in list order;
// - staging is a copy of the raw target words (16-byte cp.async chunks),
//   once per window bin for every mask that reads it;
// - each lane keeps its query pixel's unpacked fields, and the three
//   constant triples the pixel can need, in registers: with the query
//   sector s1 fixed, the same-sector test uses triple 0, the "up" pair
//   (s2 == s1 + 1) uses lo = s1 and the "down" pair (s2 == s1 - 1) uses
//   lo = s1 - 1, so no per-variant table lookup remains; the six c9_split
//   triples (pixel_active.word_triples) arrive as kernel arguments, so one
//   code path serves every zt9;
// - exact skips as K1's: a direction the host table marks dead is neither
//   staged nor scored; a staged window without a sel bit is not scored.
// Mirror geometry is K1's: the flipped frame is the x-flip of the raw
// plane before the tile padding (pixel_active.pad_from_words), staged at
// the same window origin as the direct one.
//
// Per (pixel, variant) one staged chain runs (the reference's general
// form runs two; its packed-constant form, pixel_pallas.py:140, shows one
// suffices: same and adjacent are exclusive).

#include "multimask_common.cuh"

namespace {

using namespace cms;

constexpr int POS_SHIFT = 22;  // pixel_active.POS_SHIFT["words"]

// the six (Q, Rhi, Rlo) constants: index 0 the same-sector test, index
// lo = 1..5 the adjacent pair (lo, lo + 1)
struct Triples {
  int q[6], rh[6], rl[6];
};

// Exact u/v <= C (geq = 0) or u/v >= C (geq = 1) for
// C = (c.x * 1e6 + c.y * 64 + c.z) / 1e9 (pixel_pallas._leq_geq_chain;
// magnitudes in exact_ratio.py: u <= 130050, v <= 65025, Q <= 3000).
// Signed overflow is undefined in C++: e = d*15625 - Rhi*v would overflow
// int32 when d is out of its band, where the reference wraps and never
// reads e. So e is computed from d_in = in_d ? d : 0, which is exact and
// needs neither wrap nor int64 (|d_in*15625| <= 1.03e9, Rhi*v <= 1.02e9).
__device__ __forceinline__ bool staged_cmp(int u, int v, int4 c) {
  const int d = u * 1000 - c.x * v;
  const bool in_d = (d >= 0) & (d <= 65601);
  const int e = (in_d ? d : 0) * 15625 - c.y * v;
  const bool in_e = (e >= 0) & (e <= 65601);
  const int e_band = 64 * (in_e ? e : 0);
  const int rv = c.z * v;
  const bool leq = (d < 0) | (in_d & ((e < 0) | (in_e & (e_band <= rv))));
  const bool geq = (d >= 0) & (!in_d | ((e >= 0) & (!in_e | (e_band >= rv))));
  return c.w ? geq : leq;
}

// One query pixel's state: fields of its word and, per case, the
// query-side precondition and the constant triple (x, y, z = Q, Rhi, Rlo;
// w = 1 for a geq test).
struct QWord {
  int b1, a1, s1;
  bool same_pre, up_pre, dn_pre;
  int4 t_same, t_up, t_dn;
};

// The triple of sector pair lo (pixel_pallas._select_by_lo: lo outside
// 2..5 takes index 1) and its sense: even lo (2, 4) tests geq, odd leq.
__device__ __forceinline__ int4 pair_triple(const int4* trip_s, int lo) {
  return trip_s[(lo >= 2 && lo <= 5) ? lo : 1];
}

// Whether query pixel q matches target word w (pixel_pallas
// _match_unpacked). Parity and direction: "up" (s2 == s1 + 1) has lo =
// s1 and needs qcu & tcl; "down" (s1 == s2 + 1) has lo = s2 and needs
// qcl & tcu; both need min(s1, s2) > 0.
__device__ __forceinline__ bool match_word(int w, const QWord& q) {
  const int b2 = w & 0xFF;
  const int a2 = (w >> 8) & 0xFF;
  const int s2 = (w >> 16) & 7;
  const bool tsel = (w >> 19) & 1;
  const bool tcl = (w >> 20) & 1;
  const bool tcu = (w >> 21) & 1;
  const bool same = s2 == q.s1;
  const bool up = s2 == q.s1 + 1;
  const bool dn = s2 + 1 == q.s1;
  const int p = q.b1 * b2;
  const int x = q.a1 * b2;
  const int y = a2 * q.b1;
  // the three cases are exclusive: select one (numerator, triple) pair
  const bool pre = same ? (q.same_pre & (a2 > 0))
                        : (up ? (q.up_pre & tcl) : (dn & q.dn_pre & tcu));
  const int4 c = same ? q.t_same : (up ? q.t_up : q.t_dn);
  const int num = same ? abs(y - x) : x + y;
  return tsel & pre & staged_cmp(num, p, c);
}

// All |S| shift variants of one query pixel against one staged plane.
template <int XY>
__device__ __forceinline__ void score_pixel(const int32_t* __restrict__ ws,
                                            int base, const QWord& q,
                                            int (&cnt)[1 + 4 * XY]) {
  constexpr int NS = 1 + 4 * XY;
#pragma unroll
  for (int v = 0; v < NS; ++v)
    cnt[v] += match_word(ws[base + ring_dy(v) * WIN_W + ring_dx(v)], q)
                  ? 1 : 0;
}

template <int XY>
__global__ void __launch_bounds__(THREADS)
multimask_words_kernel(const int32_t* __restrict__ frames,
                       const int32_t* __restrict__ flipped, int hp, int wp,
                       const int32_t* __restrict__ sel_off,
                       const int32_t* __restrict__ sel_q,
                       const int32_t* __restrict__ bin_off,
                       const int32_t* __restrict__ mem_row,
                       const int32_t* __restrict__ mem_tile, int mirror,
                       Triples trip, int32_t* __restrict__ out) {
  constexpr int S = XY;  // largest |dx|, |dy| of the ring
  constexpr int NS = 1 + 4 * XY;
  constexpr int NV = 2 * NS;
  constexpr int WH = TILE_H + 2 * S;
  constexpr int WN = WH * WIN_W;

  __shared__ __align__(16) int32_t w_s[2][WN];  // [direction] windows
  __shared__ int4 trip_s[6];

  const int m0 = bin_off[blockIdx.x];
  const int m1 = bin_off[blockIdx.x + 1];
  if (m0 == m1) return;  // uniform: an empty bin
  if (threadIdx.x == 0) {  // read after bin_dirs' barriers
#pragma unroll
    for (int i = 0; i < 6; ++i)
      trip_s[i] = make_int4(trip.q[i], trip.rh[i], trip.rl[i],
                            (i == 2) | (i == 4));
  }
  const int dirs = bin_dirs(mem_tile, m0, m1, mirror);
  if (dirs == 0) return;  // uniform: only rows that report 0
  const long long off = window_offset<S>(blockIdx.x, hp, wp);
  if (dirs & 1) stage_window<WH>(w_s[0], frames + off, wp);
  if (dirs & 2) stage_window<WH>(w_s[1], flipped + off, wp);
  cp_async_commit();
  cp_async_wait<0>();
  const int live =
      block_live(((dirs & 1) ? window_has_sel<WH>(w_s[0]) : 0)
                 | ((dirs & 2) ? 2 * window_has_sel<WH>(w_s[1]) : 0));
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
      const int qw = sel_q[p];
      QWord q;
      q.b1 = qw & 0xFF;
      q.a1 = (qw >> 8) & 0xFF;
      q.s1 = (qw >> 16) & 7;
      q.same_pre = (q.s1 > 0) & (q.a1 > 0);
      q.up_pre = (q.s1 > 0) & (((qw >> 21) & 1) != 0);      // qcu
      q.dn_pre = (q.s1 - 1 > 0) & (((qw >> 20) & 1) != 0);  // qcl
      q.t_same = trip_s[0];
      q.t_up = pair_triple(trip_s, q.s1);
      q.t_dn = pair_triple(trip_s, q.s1 - 1);
      const int base = window_base<S>((qw >> POS_SHIFT) & POS_MASK);
      if (d & 1) score_pixel<XY>(w_s[0], base, q, cnt_d);
      if (d & 2) score_pixel<XY>(w_s[1], base, q, cnt_m);
    }
    warp_add<NS>(cnt_d, cnt_m, out + static_cast<long long>(mem_row[m]) * NV);
  }
}

template <int XY>
cudaError_t launch(const void* frames, const void* flipped, int hp, int wp,
                   const void* sel_off, const void* sel_q, const void* bin_off,
                   int n_bins, const void* mem_row, const void* mem_tile,
                   int mirror, const Triples& trip, void* out,
                   cudaStream_t stream) {
  multimask_words_kernel<XY><<<n_bins, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(frames),
      static_cast<const int32_t*>(flipped), hp, wp,
      static_cast<const int32_t*>(sel_off),
      static_cast<const int32_t*>(sel_q),
      static_cast<const int32_t*>(bin_off),
      static_cast<const int32_t*>(mem_row),
      static_cast<const int32_t*>(mem_tile), mirror, trip,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes by cds/kernels.py). `triples` is
// a host array of 18 ints, (Q, Rhi, Rlo) for each of the six constants of
// pixel_active.word_triples. `out` must hold zeros: the kernel adds each
// member's counts to its row. Launches on `stream` of card `device` and
// returns the first CUDA error of the launch (0 on success); the caller's
// current device is restored. Supported xy_shift: 0 and 2. The frames
// must be 16-byte aligned with wp a multiple of 16 (the wrapper checks).
extern "C" int cms_multimask_words(
    const void* frames, const void* flipped, int hp, int wp,
    const void* sel_off, const void* sel_q, const void* bin_off, int n_bins,
    const void* mem_row, const void* mem_tile, int xy_shift, int mirror,
    const int* triples, void* out, void* stream, int device) {
  if (n_bins <= 0) return 0;
  if (xy_shift != 0 && xy_shift != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Triples trip;
  for (int i = 0; i < 6; ++i) {
    trip.q[i] = triples[3 * i];
    trip.rh[i] = triples[3 * i + 1];
    trip.rl[i] = triples[3 * i + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return xy_shift == 0
               ? launch<0>(frames, flipped, hp, wp, sel_off, sel_q, bin_off,
                           n_bins, mem_row, mem_tile, mirror, trip, out, s)
               : launch<2>(frames, flipped, hp, wp, sel_off, sel_q, bin_off,
                           n_bins, mem_row, mem_tile, mirror, trip, out, s);
  });
}
