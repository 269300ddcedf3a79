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
// four plane pointers (t_above, grad, z_nonzero, z_slice, at row 0), so the
// cache's [H, W] tensors are read where they lie.
//
// Bound: the bytes. Each target pixel (6 B: grad 2, z_slice 2, z_nonzero
// and t_above 1 each) is needed once; the query's band (5 B/px) is shared by
// every target. The eager version made ~30 passes over [T, R, W] int32
// temporaries. A block takes one band row and SR_WARPS targets, one per
// warp: it stages the query's row once for its targets (so the query's
// traffic is 1 / SR_WARPS of the targets' share) and each warp stages its
// target's four plane rows, all with 16-byte asynchronous copies (cp.async)
// of the aligned chunks that hold each row, into shared memory. The rows
// are staged rather than read straight into registers because a band row
// starts wherever the band does (1,210-byte and 2,420-byte plane rows: 2-
// or 4-byte aligned at best) and the mirror pairs column x with W-1-x: from
// shared memory each lane reads the pixels x and W-1-x of every plane
// (x = lane, lane + 32, ..), which is all that the direct and the mirrored
// sums of both pixels need, with no byte reversal. The middle column of an
// odd width is counted once. The four sums are reduced with one warp REDUX
// each.

#include "multimask_common.cuh"

namespace {

constexpr int SR_WARPS = 8;  // targets of a block, one per warp
constexpr int SR_THREADS = SR_WARPS * 32;
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

// Shared-memory bytes of a staged row of w elements of es bytes: its
// 16-byte chunks, one more for the row's misalignment.
__host__ __device__ inline int row_bytes(int w, int es) {
  return 16 * ((w * es + 15) / 16 + 1);
}

// Start the copy of the 16-byte chunks that hold nbytes from src into dst,
// chunks k = k0, k0 + step, ..; returns where the row starts in dst.
__device__ __forceinline__ int stage_row(unsigned char* dst, const void* src,
                                         int nbytes, int k0, int step) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t al = s & ~uintptr_t(15);
  const int delta = static_cast<int>(s - al);
  const int n = (delta + nbytes + 15) / 16;
  for (int k = k0; k < n; k += step)
    cms::cp_async<16>(dst + 16 * k,
                      reinterpret_cast<const void*>(al + 16 * k));
  return delta;
}

// Grid (band rows, target groups of SR_WARPS). table: per target the four
// plane pointers at row 0; q: the query's planes at row 0; out: [4][T][R]
// int32 (gaps_id, high_id, gaps_m, high_m; the last two only with mirror).
__global__ void __launch_bounds__(SR_THREADS)
    shape_rows_kernel(const unsigned long long* __restrict__ table, Query q,
                      int n_t, int r0, int rows, int w, int mirror,
                      int flip_z, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sr_smem[];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.y * SR_WARPS + warp;
  const long long off = static_cast<long long>(r0 + row) * w;
  const int b1 = row_bytes(w, 1), b2 = row_bytes(w, 2);
  unsigned char* q_nz = sr_smem;
  unsigned char* q_sl = q_nz + b1;
  unsigned char* q_mk = q_sl + b2;
  unsigned char* q_hi = q_mk + b1;
  unsigned char* t_ab = q_hi + b1 + warp * (2 * b1 + 2 * b2);
  unsigned char* t_gr = t_ab + b1;
  unsigned char* t_zn = t_gr + b2;
  unsigned char* t_zs = t_zn + b1;
  // the query's row, by the whole block
  const int tid = threadIdx.x;
  const int dq_nz = stage_row(q_nz, q.nz + off, w, tid, SR_THREADS);
  const int dq_sl = stage_row(q_sl, q.slice + off, 2 * w, tid, SR_THREADS);
  const int dq_mk = stage_row(q_mk, q.mask + off, w, tid, SR_THREADS);
  const int dq_hi = stage_row(q_hi, q.high + off, w, tid, SR_THREADS);
  // the target's rows, by its warp
  int d_ab = 0, d_gr = 0, d_zn = 0, d_zs = 0;
  if (t < n_t) {
    const unsigned long long* p = table + 4 * t;
    d_ab = stage_row(t_ab, reinterpret_cast<const unsigned char*>(p[0]) + off,
                     w, lane, 32);
    d_gr = stage_row(t_gr, reinterpret_cast<const short*>(p[1]) + off,
                     2 * w, lane, 32);
    d_zn = stage_row(t_zn, reinterpret_cast<const unsigned char*>(p[2]) + off,
                     w, lane, 32);
    d_zs = stage_row(t_zs, reinterpret_cast<const short*>(p[3]) + off,
                     2 * w, lane, 32);
  }
  cms::cp_async_commit();
  cms::cp_async_wait<0>();
  __syncthreads();
  if (t >= n_t) return;
  const unsigned char* qnz = q_nz + dq_nz;
  const short* qsl = reinterpret_cast<const short*>(q_sl + dq_sl);
  const unsigned char* qmask = q_mk + dq_mk;
  const unsigned char* qhigh = q_hi + dq_hi;
  const unsigned char* tab = t_ab + d_ab;
  const unsigned short* grad =
      reinterpret_cast<const unsigned short*>(t_gr + d_gr);
  const unsigned char* znz = t_zn + d_zn;
  const short* zsl = reinterpret_cast<const short*>(t_zs + d_zs);
  int gaps_id = 0, high_id = 0, gaps_m = 0, high_m = 0;
  for (int a = lane; a < (w + 1) / 2; a += 32) {
    const int b = w - 1 - a;
    const int qa_nz = qnz[a], qb_nz = qnz[b];
    const int qa_sl = qsl[a], qb_sl = qsl[b];
    const int qa_m = qmask[a], qb_m = qmask[b];
    const int qa_h = qhigh[a], qb_h = qhigh[b];
    const int ga = grad[a], gb = grad[b];
    const int ta = tab[a], tb = tab[b];
    int za_nz = znz[a], zb_nz = znz[b];
    int za_sl = zsl[a], zb_sl = zsl[b];
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
// target, each at row 0), copied on `stream` into dev_table (4 n_t words);
// the query planes at row 0 too; every plane has row stride w; the band is
// rows r0 .. r0 + rows - 1.
extern "C" int cms_shape_rows(const unsigned long long* host_table,
                              void* dev_table, int n_t, const void* q_nz,
                              const void* q_slice, const void* q_mask,
                              const void* q_high, int r0, int rows, int w,
                              int mirror, int flip_z, void* out, void* stream,
                              int device) {
  if (n_t <= 0 || rows <= 0) return 0;
  const int smem = 3 * row_bytes(w, 1) + row_bytes(w, 2) +
                   SR_WARPS * (2 * row_bytes(w, 1) + 2 * row_bytes(w, 2));
  if (w <= 0 || r0 < 0 || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaFuncSetAttribute(
        shape_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    err = cudaMemcpyAsync(dev_table, host_table,
                          sizeof(unsigned long long) * 4 * n_t,
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
    const Query q{static_cast<const unsigned char*>(q_nz),
                  static_cast<const short*>(q_slice),
                  static_cast<const unsigned char*>(q_mask),
                  static_cast<const unsigned char*>(q_high)};
    const dim3 grid(rows, (n_t + SR_WARPS - 1) / SR_WARPS);
    shape_rows_kernel<<<grid, SR_THREADS, smem, s>>>(
        static_cast<const unsigned long long*>(dev_table), q, n_t, r0, rows,
        w, mirror, flip_z, static_cast<int*>(out));
    return cudaGetLastError();
  });
}
