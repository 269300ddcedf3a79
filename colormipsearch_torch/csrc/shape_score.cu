// Shape (gradient) scorer for NVIDIA Hopper (sm_90a): G1 shape_rows.
//
// Replaces the XLA program (not a Pallas kernel) of the JAX package's
// gradientScores scorer, colormipsearch_tpu/cds/shape_kernel.py:79
// shape_score_stacked -> :34 shape_score_kernel: per target and row of the
// query's active band, the int32 row sums of
//
//   gap(x)  = g > 3 ? g : 0,  g = q_nonzero & z_nonzero & sg >= 80
//                                 ? sg - 40 : q_mask * grad
//   high(x) = high_expr & t_above
//
// with sg the slice gap of GradientAreaGapUtils (0 where the target has no
// slice, the target's slice where the query has none, else |q - z|), in
// the direct orientation and, with `mirror`, with the target's gradient and
// above-threshold planes read at column W-1-x (the mirror-pass equivalence
// of shape_oracle.py). With `flip_z` both orientations read the z planes at
// W-1-x instead (the ROI-mask path's mirrored-query pass). Plain version
// and wrapper: cds/shape_kernel.py (shape_rows_plain / shape_rows).
// Integer arithmetic only: a row sum is at most 1210 x 65535 < 2^31.
//
// The targets' planes are not stacked: a device table holds each target's
// four plane pointers (t_above, grad, z_nonzero, z_slice), already at the
// band's first row, so the cache's [H, W] tensors are read where they lie.
//
// Bound: the bytes. Each target pixel (6 B: grad 2, z_slice 2, z_nonzero
// and t_above 1 each) is needed once; the query's band (5 B/px) is shared by
// every target and comes from L2. The eager version made ~30 passes over
// [T, R, W] int32 temporaries. Here a warp takes one row of one target and
// walks it from both ends at once: lane l loads the pixels x and W-1-x of
// every plane (a reversed run of addresses still falls in the same
// sectors), which is all that the direct and the mirrored sums of both
// pixels need, so every byte is read once, into registers, with no shared
// memory and no barrier. The four sums are reduced with one warp REDUX each.

#include "multimask_common.cuh"

namespace {

constexpr int ROW_WARPS = 8;  // rows (one per warp) of a block
constexpr int GAP_THRESHOLD = 3;

struct Query {
  const unsigned char* nz;
  const short* slice;
  const unsigned char* mask;
  const unsigned char* high;
};

// One target pixel and the query pixel it is scored against.
__device__ __forceinline__ int gap(int q_nz, int q_sl, int q_mask, int z_nz,
                                   int z_sl, int grad) {
  int sg = q_sl - z_sl;
  sg = sg < 0 ? -sg : sg;
  sg = q_sl == 0 ? z_sl : sg;
  sg = z_sl == 0 ? 0 : sg;
  const int g = (q_nz && z_nz && sg >= 80) ? sg - 40 : (q_mask ? grad : 0);
  return g > GAP_THRESHOLD ? g : 0;
}

// Grid (row blocks, targets). table: per target the four plane pointers
// at row r0; out: [4][T][R] int32 (gaps_id, high_id, gaps_m, high_m; the
// last two only with mirror).
__global__ void __launch_bounds__(ROW_WARPS * 32)
    shape_rows_kernel(const unsigned long long* __restrict__ table, Query q,
                      int n_t, int rows, int w, int mirror, int flip_z,
                      int* __restrict__ out) {
  const int t = blockIdx.y;
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long off = static_cast<long long>(row) * w;
  const unsigned char* tab =
      reinterpret_cast<const unsigned char*>(table[4 * t]) + off;
  const unsigned short* grad =
      reinterpret_cast<const unsigned short*>(table[4 * t + 1]) + off;
  const unsigned char* znz =
      reinterpret_cast<const unsigned char*>(table[4 * t + 2]) + off;
  const short* zsl = reinterpret_cast<const short*>(table[4 * t + 3]) + off;
  const unsigned char* qnz = q.nz + off;
  const short* qsl = q.slice + off;
  const unsigned char* qmask = q.mask + off;
  const unsigned char* qhigh = q.high + off;
  int gaps_id = 0, high_id = 0, gaps_m = 0, high_m = 0;
  for (int a = lane; a < (w + 1) / 2; a += 32) {
    const int b = w - 1 - a;
    const int qa_nz = __ldg(qnz + a), qb_nz = __ldg(qnz + b);
    const int qa_sl = __ldg(qsl + a), qb_sl = __ldg(qsl + b);
    const int qa_m = __ldg(qmask + a), qb_m = __ldg(qmask + b);
    const int qa_h = __ldg(qhigh + a), qb_h = __ldg(qhigh + b);
    const int ga = __ldg(grad + a), gb = __ldg(grad + b);
    const int ta = __ldg(tab + a), tb = __ldg(tab + b);
    int za_nz = __ldg(znz + a), zb_nz = __ldg(znz + b);
    int za_sl = __ldg(zsl + a), zb_sl = __ldg(zsl + b);
    if (flip_z) {
      const int nz = za_nz, sl = za_sl;
      za_nz = zb_nz;
      za_sl = zb_sl;
      zb_nz = nz;
      zb_sl = sl;
    }
    // the middle column of an odd width is one pixel, counted once
    const int twin = b != a;
    gaps_id += gap(qa_nz, qa_sl, qa_m, za_nz, za_sl, ga);
    high_id += qa_h & ta;
    if (twin) {
      gaps_id += gap(qb_nz, qb_sl, qb_m, zb_nz, zb_sl, gb);
      high_id += qb_h & tb;
    }
    if (mirror) {
      gaps_m += gap(qa_nz, qa_sl, qa_m, za_nz, za_sl, gb);
      high_m += qa_h & tb;
      if (twin) {
        gaps_m += gap(qb_nz, qb_sl, qb_m, zb_nz, zb_sl, ga);
        high_m += qb_h & ta;
      }
    }
  }
  const unsigned all = 0xffffffffu;
  gaps_id = __reduce_add_sync(all, gaps_id);
  high_id = __reduce_add_sync(all, high_id);
  gaps_m = __reduce_add_sync(all, gaps_m);
  high_m = __reduce_add_sync(all, high_m);
  if (lane == 0) {
    const long long plane = static_cast<long long>(n_t) * rows;
    const long long i = static_cast<long long>(t) * rows + row;
    out[i] = gaps_id;
    out[plane + i] = high_id;
    if (mirror) {
      out[2 * plane + i] = gaps_m;
      out[3 * plane + i] = high_m;
    }
  }
}

}  // namespace

// host_table: 4 n_t plane pointers (t_above, grad, z_nonzero, z_slice per
// target, each at the band's first row), copied on `stream` into
// dev_table (4 n_t words); the query planes start at the band's first row
// too; every plane has row stride w.
extern "C" int cms_shape_rows(const unsigned long long* host_table,
                              void* dev_table, int n_t, const void* q_nz,
                              const void* q_slice, const void* q_mask,
                              const void* q_high, int rows, int w, int mirror,
                              int flip_z, void* out, void* stream,
                              int device) {
  if (n_t <= 0 || rows <= 0) return 0;
  if (w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaMemcpyAsync(
        dev_table, host_table, sizeof(unsigned long long) * 4 * n_t,
        cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
    const Query q{static_cast<const unsigned char*>(q_nz),
                  static_cast<const short*>(q_slice),
                  static_cast<const unsigned char*>(q_mask),
                  static_cast<const unsigned char*>(q_high)};
    const dim3 grid((rows + ROW_WARPS - 1) / ROW_WARPS, n_t);
    shape_rows_kernel<<<grid, ROW_WARPS * 32, 0, s>>>(
        static_cast<const unsigned long long*>(dev_table), q, n_t, rows, w,
        mirror, flip_z, static_cast<int*>(out));
    return cudaGetLastError();
  });
}
