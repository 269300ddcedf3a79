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
// Work split, staging and reduction: multimask_common.cuh, as K1. It
// differs from K1 in three ways:
// - the staged planes are the raw target words (one int32 plane per
//   direction); each variant unpacks its word with bit-field extracts;
// - each thread keeps its query pixel's unpacked fields, and the three
//   constant triples the pixel can need, in registers: with the query
//   sector s1 fixed, the same-sector test uses triple 0, the "up" pair
//   (s2 == s1 + 1) uses lo = s1 and the "down" pair (s2 == s1 - 1) uses
//   lo = s1 - 1, so no per-variant table lookup remains;
// - the six c9_split triples (pixel_active.word_triples) arrive as
//   kernel arguments, so one code path serves every zt9.
// Mirror geometry is K1's: the flipped frame is the x-flip of the raw
// plane before the tile padding (pixel_active.pad_from_words), staged at
// the same window origin as the direct one.
// It keeps K1's two exact skips: a staged region with no sel bit, and a
// query pixel that can never match (sel = 0, since the predicate ANDs
// qsel & tsel, pixel_pallas.py:118; or none of the three cases' query-side
// preconditions holds).
//
// Per (pixel, variant) one staged chain runs (the reference's general
// form runs two; its packed-constant form, pixel_pallas.py:140, shows one
// suffices: same and adjacent are exclusive), ~35 integer ops and
// compares against ~12 for K1. What bounds it on the card: the same bytes
// as K1 per live (row, tile) (12.7 KB of window, 4 KB of query words)
// against ~3x K1's operations, so it is bound by the SMs' issue rate.

#include "multimask_common.cuh"

namespace {

using namespace cms;

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
  constexpr int RW = TILE_W + 2 * XY;
#pragma unroll
  for (int v = 0; v < NS; ++v)
    cnt[v] += match_word(ws[base + ring_dy(v) * RW + ring_dx(v)], q) ? 1 : 0;
}

template <int XY>
__global__ void __launch_bounds__(THREADS)
multimask_words_kernel(const int32_t* __restrict__ frames,
                       const int32_t* __restrict__ flipped, int hp, int wp,
                       const int32_t* __restrict__ q_words,
                       const int32_t* __restrict__ coords,
                       const int32_t* __restrict__ row_off,
                       const int32_t* __restrict__ tile_list,
                       const int32_t* __restrict__ tgt,
                       const int32_t* __restrict__ surv, int mirror,
                       Triples trip, int32_t* __restrict__ out) {
  constexpr int S = XY;  // largest |dx|, |dy| of the ring
  constexpr int NS = 1 + 4 * XY;
  constexpr int NV = 2 * NS;
  constexpr int RW = TILE_W + 2 * S;
  constexpr int RN = (TILE_H + 2 * S) * RW;

  __shared__ int32_t w_s[2][RN];
  __shared__ int4 trip_s[6];

  const int tid = threadIdx.x;
  const int col = tid % TILE_W;
  const int qrow0 = tid / TILE_W;
  const long long r = blockIdx.x;
  if (surv[r] == 0) {  // uniform over the block
    if (tid < NV) out[r * NV + tid] = 0;
    return;
  }
  if (tid < 6)  // read after stage_region's first __syncthreads
    trip_s[tid] = make_int4(trip.q[tid], trip.rh[tid], trip.rl[tid],
                            (tid == 2) | (tid == 4));
  int cnt_d[NS];
  int cnt_m[NS];
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    cnt_d[v] = 0;
    cnt_m[v] = 0;
  }
  const long long fbase = static_cast<long long>(tgt[r]) * hp * wp;

  for (int k = row_off[r]; k < row_off[r + 1]; ++k) {
    const int tile = tile_list[k];
    const int any = stage_region<S>(
        frames, flipped, fbase, wp, coords[2 * tile] + TILE_H - S,
        coords[2 * tile + 1] + TILE_W - S, mirror,
        [&](int p, int e, int w) { w_s[p][e] = w; });
    if (!any) continue;  // uniform: no target signal here

    const size_t tbase = static_cast<size_t>(tile) * TILE_PX;
#pragma unroll
    for (int i = 0; i < PX_PER_THREAD; ++i) {
      const int qy = qrow0 + i * ROWS_PER_PASS;
      const int qw = q_words[tbase + qy * TILE_W + col];
      if (!((qw >> 19) & 1)) continue;  // qsel = 0: never matches
      QWord q;
      q.b1 = qw & 0xFF;
      q.a1 = (qw >> 8) & 0xFF;
      q.s1 = (qw >> 16) & 7;
      q.same_pre = (q.s1 > 0) & (q.a1 > 0);
      q.up_pre = (q.s1 > 0) & (((qw >> 21) & 1) != 0);      // qcu
      q.dn_pre = (q.s1 - 1 > 0) & (((qw >> 20) & 1) != 0);  // qcl
      if (!(q.same_pre | q.up_pre | q.dn_pre)) continue;  // never matches
      q.t_same = trip_s[0];
      q.t_up = pair_triple(trip_s, q.s1);
      q.t_dn = pair_triple(trip_s, q.s1 - 1);
      const int base = (qy + S) * RW + (col + S);
      if (any & 1) score_pixel<XY>(w_s[0], base, q, cnt_d);
      if (any & 2) score_pixel<XY>(w_s[1], base, q, cnt_m);
    }
  }
  reduce_write<NS>(cnt_d, cnt_m, out + r * NV);
}

template <int XY>
cudaError_t launch(const void* frames, const void* flipped, int hp, int wp,
                   const void* q_words, const void* coords,
                   const void* row_off, const void* tile_list, int n_rows,
                   const void* tgt, const void* surv, int mirror,
                   const Triples& trip, void* out, cudaStream_t stream) {
  multimask_words_kernel<XY><<<n_rows, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(frames),
      static_cast<const int32_t*>(flipped), hp, wp,
      static_cast<const int32_t*>(q_words),
      static_cast<const int32_t*>(coords),
      static_cast<const int32_t*>(row_off),
      static_cast<const int32_t*>(tile_list),
      static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(surv),
      mirror, trip, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes by cds/kernels.py). `triples` is
// a host array of 18 ints, (Q, Rhi, Rlo) for each of the six constants of
// pixel_active.word_triples. Launches on `stream` of card `device` and
// returns cudaGetLastError() of the launch (0 on success); the caller's
// current device is restored. Supported xy_shift: 0 and 2.
extern "C" int cms_multimask_words(
    const void* frames, const void* flipped, int hp, int wp,
    const void* q_words, const void* coords, const void* row_off,
    const void* tile_list, int n_rows, const void* tgt, const void* surv,
    int xy_shift, int mirror, const int* triples, void* out, void* stream,
    int device) {
  if (n_rows <= 0) return 0;
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
               ? launch<0>(frames, flipped, hp, wp, q_words, coords,
                           row_off, tile_list, n_rows, tgt, surv, mirror,
                           trip, out, s)
               : launch<2>(frames, flipped, hp, wp, q_words, coords,
                           row_off, tile_list, n_rows, tgt, surv, mirror,
                           trip, out, s);
  });
}
