// Exact multi-mask colour-depth scorer for NVIDIA Hopper (sm_90a).
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
// Work split: one thread block per launch row (a mask and a target, given
// by the host table). The block walks the row's live-tile list
// tile_list[row_off[r] .. row_off[r+1]). No state carries across blocks.
// Each block writes its row's [2|S|] counts, zeros when surv == 0.
//
// Per (row, tile): stage in shared memory the (8+2s) x (128+2s) region of
// the padded frame that the shifts reach (origin (cy+8-s, cx+128-s)),
// direct and flipped, as the f32 ratio plane a2/b2 (-1 where a2 == 0) and
// the flag plane w >> 16 (_ratio_prep, pixel_pallas.py:291-297). The
// divide is IEEE (no fast-math), so the plane equals the reference's bit
// for bit. Each of the 256 threads owns 4 query pixels (one column, rows
// r, r+2, r+4, r+6), loads their compare constants (_ratio_consts,
// pixel_pallas.py:281-288) into registers and evaluates all 2|S| variants
// against shared memory, with one register counter per variant. A block
// reduction writes the counters once per row.
//
// What bounds it on the card: per live (row, tile) the block reads
// 2 x 12 x 132 x 4 B = 12.7 KB of target window and 20 KB of query
// constants (both mostly L2 hits: a mask's tiles and a target's frame are
// reused by many rows), against 1024 x 18 predicate evaluations of ~12
// integer and f32 ops each (~220K ops, ~7 ops per byte). It is bound by
// the SMs' issue rate more than by memory. The design stages each window
// once so that all 18 variants read it from shared memory, skips a tile
// whose staged region has no above-threshold target pixel (exact: every
// compare constant includes the target's sel bit), and skips query pixels
// whose three compare constants are all sentinels (they never match).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int TILE_PX = TILE_H * TILE_W;
constexpr int ROWS_PER_PASS = THREADS / TILE_W;     // 2
constexpr int PX_PER_THREAD = TILE_PX / THREADS;    // 4

// compare-constant sentinels (ratio_bounds.py _SAME_SENT/_UP_SENT/_DN_SENT)
constexpr int SAME_SENT = 31;
constexpr int UP_SENT = 31;
constexpr int DN_SENT = 63;

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

struct QConst {
  int sc, uc, dc;
  bool gup, gdn;
  float lo, hi, cup, cdn;
};

// All |S| shift variants of one query pixel against one staged plane pair.
// `base` is the pixel's (dx, dy) = (0, 0) position in the staged region.
template <int XY>
__device__ __forceinline__ void score_pixel(const float* __restrict__ rf,
                                            const uint8_t* __restrict__ fw,
                                            int base, const QConst& q,
                                            int (&cnt)[1 + 4 * XY]) {
  constexpr int NS = 1 + 4 * XY;
  constexpr int RW = TILE_W + 2 * XY;
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    const int o = base + ring_dy(v) * RW + ring_dx(v);
    const float r = rf[o];
    const int f = fw[o];
    const bool same_ok = ((f & 15) == q.sc) & (r >= q.lo) & (r <= q.hi);
    const bool up_ok = ((f & 31) == q.uc) & ((r <= q.cup) != q.gup);
    const bool dn_ok = ((f & 47) == q.dc) & ((r <= q.cdn) != q.gdn);
    cnt[v] += (same_ok | up_ok | dn_ok) ? 1 : 0;
  }
}

__device__ __forceinline__ void stage_word(int w, float* rf, uint8_t* fw,
                                           int e) {
  const int a2 = (w >> 8) & 0xFF;
  rf[e] = a2 == 0 ? -1.0f : static_cast<float>(a2)
                                / static_cast<float>(w & 0xFF);
  // flags live in bits 16..21 of a word: sector, sel, cl, cu
  fw[e] = static_cast<uint8_t>((w >> 16) & 0x3F);
}

template <int XY>
__global__ void __launch_bounds__(THREADS)
multimask_ratio_kernel(const int32_t* __restrict__ frames,
                       const int32_t* __restrict__ flipped, int hp, int wp,
                       const int32_t* __restrict__ q_cmp,
                       const float* __restrict__ q_f32,
                       const int32_t* __restrict__ coords,
                       const int32_t* __restrict__ row_off,
                       const int32_t* __restrict__ tile_list,
                       const int32_t* __restrict__ tgt,
                       const int32_t* __restrict__ surv, int mirror,
                       int32_t* __restrict__ out) {
  constexpr int S = XY;  // largest |dx|, |dy| of the ring
  constexpr int NS = 1 + 4 * XY;
  constexpr int NV = 2 * NS;
  constexpr int RH = TILE_H + 2 * S;
  constexpr int RW = TILE_W + 2 * S;
  constexpr int RN = RH * RW;

  __shared__ float rf_s[2][RN];
  __shared__ uint8_t fw_s[2][RN];
  __shared__ int red_s[THREADS / 32][NV];

  const int tid = threadIdx.x;
  const int col = tid % TILE_W;
  const int qrow0 = tid / TILE_W;
  const long long r = blockIdx.x;
  if (surv[r] == 0) {  // uniform over the block
    if (tid < NV) out[r * NV + tid] = 0;
    return;
  }
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
    const int ry = coords[2 * tile] + TILE_H - S;
    const int rx = coords[2 * tile + 1] + TILE_W - S;
    __syncthreads();  // the previous tile's readers are done
    int any_d = 0;
    int any_m = 0;
    for (int e = tid; e < RN; e += THREADS) {
      const int y = e / RW;
      const int x = e - y * RW;
      const long long off = fbase + static_cast<long long>(ry + y) * wp
                            + (rx + x);
      const int wd = frames[off];
      stage_word(wd, rf_s[0], fw_s[0], e);
      any_d |= (wd >> 19) & 1;
      if (mirror) {
        const int wm = flipped[off];
        stage_word(wm, rf_s[1], fw_s[1], e);
        any_m |= (wm >> 19) & 1;
      }
    }
    any_d = __syncthreads_or(any_d);
    any_m = __syncthreads_or(any_m);
    if (!(any_d | any_m)) continue;  // uniform: no target signal here

    const size_t tbase = static_cast<size_t>(tile) * TILE_PX;
#pragma unroll
    for (int i = 0; i < PX_PER_THREAD; ++i) {
      const int qy = qrow0 + i * ROWS_PER_PASS;
      const int qp = qy * TILE_W + col;
      const int qc = q_cmp[tbase + qp];
      QConst q;
      q.sc = qc & 31;
      q.uc = (qc >> 5) & 31;
      q.dc = (qc >> 10) & 63;
      if (q.sc == SAME_SENT && q.uc == UP_SENT && q.dc == DN_SENT)
        continue;  // unselected query pixel: never matches
      q.gup = ((qc >> 16) & 1) != 0;
      q.gdn = ((qc >> 17) & 1) != 0;
      const float* qf = q_f32 + 4 * tbase + qp;
      q.lo = qf[0];
      q.hi = qf[TILE_PX];
      q.cup = qf[2 * TILE_PX];
      q.cdn = qf[3 * TILE_PX];
      const int base = (qy + S) * RW + (col + S);
      if (any_d) score_pixel<XY>(rf_s[0], fw_s[0], base, q, cnt_d);
      if (any_m) score_pixel<XY>(rf_s[1], fw_s[1], base, q, cnt_m);
    }
  }

  // block reduction: warp shuffles, then one partial per warp in smem
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    int x = v < NS ? cnt_d[v] : cnt_m[v - NS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red_s[warp][v] = x;
  }
  __syncthreads();
  if (tid < NV) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red_s[w][tid];
    out[r * NV + tid] = s;
  }
}

template <int XY>
cudaError_t launch(const void* frames, const void* flipped, int hp, int wp,
                   const void* q_cmp, const void* q_f32, const void* coords,
                   const void* row_off, const void* tile_list, int n_rows,
                   const void* tgt, const void* surv, int mirror, void* out,
                   cudaStream_t stream) {
  multimask_ratio_kernel<XY><<<n_rows, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(frames),
      static_cast<const int32_t*>(flipped), hp, wp,
      static_cast<const int32_t*>(q_cmp), static_cast<const float*>(q_f32),
      static_cast<const int32_t*>(coords),
      static_cast<const int32_t*>(row_off),
      static_cast<const int32_t*>(tile_list),
      static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(surv),
      mirror, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes by cds/kernels.py). Launches on
// `stream` of card `device` and returns cudaGetLastError() of the launch
// (0 on success). The caller's current device is restored before return.
// Supported xy_shift: 0 and 2 (2|S| <= 32 variants, the reference's NV_PAD
// bound).
extern "C" int cms_multimask_ratio(
    const void* frames, const void* flipped, int hp, int wp,
    const void* q_cmp, const void* q_f32, const void* coords,
    const void* row_off, const void* tile_list, int n_rows, const void* tgt,
    const void* surv, int xy_shift, int mirror, void* out, void* stream,
    int device) {
  if (n_rows <= 0) return 0;
  if (xy_shift != 0 && xy_shift != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = xy_shift == 0
            ? launch<0>(frames, flipped, hp, wp, q_cmp, q_f32, coords,
                        row_off, tile_list, n_rows, tgt, surv, mirror, out, s)
            : launch<2>(frames, flipped, hp, wp, q_cmp, q_f32, coords,
                        row_off, tile_list, n_rows, tgt, surv, mirror, out,
                        s);
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}
