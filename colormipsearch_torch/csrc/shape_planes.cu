// Shape planes for NVIDIA Hopper (sm_90a): G2 dilate_rgb, G3 query_planes,
// G4 target_planes.
//
// Replace the XLA programs (not Pallas kernels) of the JAX package's
// gradientScores plane builds, colormipsearch_tpu/cds/shape_device.py:
// :127 _dilate_rgb (the circular makeLineRadii dilation of
// ImageTransformation.java:549-572), :211 _build_query_planes_jit and :164
// _build_target_planes_jit. Plain versions and wrappers:
// cds/shape_device.py (dilate_rgb_plain / dilate_rgb, query_planes_plain /
// query_planes, target_planes_plain / target_planes). Integer arithmetic
// only, so each equals its plain version exactly:
//   gray(r, g, b) = floor((2 (r + g + b) + 3) / 6)   (ColorTransformation)
//   slice(rgb)    = table[classify(rgb)], the 6 x 256 x 256 int16 table of
//                   cds/lut.py (786 KB, held in L2), the index clamped as
//                   slice_plane clamps it.
//
// cms_dilate_rgb (G2): out[y, x] = max over footprint rows dy of the max of
// in[y + dy, x - e(dy) .. x + e(dy)], pixels outside the frame 0, over u8
// RGB frames [T, H, W, 3]; optionally on the fly, the input's pixels in
// the excluded mask or with no channel above thr are 0 (the query's
// clearRegions, the z-gap's maskRGB(thr)). Bound: operations, 2 byte-quad
// maxima per footprint row and output pixel plus one per doubling level
// and input pixel (~2.2e8 for the query's r = 60 and r = 20 over one 566 x
// 1210 frame); the eager version issued one torch op per footprint row and
// level over whole frames (121 at r = 60). A pixel's RGB is one 32-bit
// word, so __vmaxu4 takes four byte maxima at once. A block owns a tile of
// BH x BW output pixels of one frame, with one column and BH / 2 rows of
// it in each thread's registers; it walks the tile's input rows, y0 - k ..
// y0 + BH - 1 + k, STAGE rows at a time: it loads the rows' span of BW + 2
// pad words into shared memory, builds their doubling levels there (level
// j holds the max of 2^j words from each column), and every output pixel
// then takes, for each staged row its footprint reaches, the max of the
// two overlapping windows of level floor(log2(2e + 1)) that cover
// [x - e, x + e], as the plain version does over whole frames.
//
// cms_query_planes (G3): the rest of build_query_planes in one pass over
// the frame, its two dilations and the excluded mask, a block per row:
// q_nonzero, q_slice, q_mask (gray > 2), high_expr (gray of the r = 60
// dilation where the r = 20 one is 0, > 0), the border frame and the row's
// any(q_nonzero | high_expr), from a block-wide OR. Bound: the bytes
// (10 B/px read, 5 written).
//
// cms_target_planes (G4): the rest of build_target_planes for a batch, one
// pass: t_above, the gradient (the gray of an RGB one, the int16 bits of a
// 16-bit one), z_nonzero and z_slice of the z-gap frame (a file, or G2's
// masked dilation at r = 10). Each target's four planes go straight into
// tensors of their own through a table of output pointers, so the cache
// holds no view of a batch. Bound: the bytes (raw frames read once, 6 B/px
// of planes written once).

#include "multimask_common.cuh"

namespace {

constexpr int MAX_K = 63;  // the footprint's half-height (MAX_DILATION_K)
constexpr int MAX_ROWS = 2 * MAX_K + 1;
constexpr int DIL_THREADS = 256;
constexpr int BW = 128;  // output columns of a tile
constexpr int BH = 16;   // output rows of a tile
constexpr int ROW_GROUPS = DIL_THREADS / BW;
constexpr int ROWS_PER_THREAD = BH / ROW_GROUPS;
constexpr int STAGE = 4;  // input rows staged together
constexpr int PX_THREADS = 256;
static_assert(DIL_THREADS % BW == 0 && BH % ROW_GROUPS == 0, "tile split");

struct DilateParams {
  int k;      // footprint rows -k .. k
  int pad;    // the largest extent
  int n_lvl;  // doubling levels 0 .. n_lvl - 1
  int e[MAX_ROWS];    // extent of footprint row dy + k
  int lvl[MAX_ROWS];  // floor(log2(2 e + 1))
  int d2[MAX_ROWS];   // 2 e + 1 - 2^lvl: the second window's offset
};

__device__ __forceinline__ int gray(int r, int g, int b) {
  return (2 * (r + g + b) + 3) / 6;
}

// The slice table's index of an RGB pixel (shape_device.classify_index):
// the reference's >= branch order, R first, then G, then B.
__device__ __forceinline__ int classify(int r, int g, int b) {
  const bool r_br = r >= g && r >= b;
  const bool g_br = !r_br && g >= r && g >= b;
  const bool ge_gb = g >= b, ge_rb = r >= b, ge_rg = r >= g;
  const int order = r_br ? (ge_gb ? 0 : 1)
                         : (g_br ? (ge_rb ? 2 : 3) : (ge_rg ? 4 : 5));
  const int maxv = r_br ? r : (g_br ? g : b);
  const int secv = r_br ? (ge_gb ? g : b)
                        : (g_br ? (ge_rb ? r : b) : (ge_rg ? r : g));
  return (order * 256 + maxv) * 256 + secv;
}

__device__ __forceinline__ short slice_of(const short* table, int n_table,
                                          int r, int g, int b) {
  const int i = classify(r, g, b);
  return __ldg(table + min(max(i, 0), n_table - 1));
}

// Grid (column tiles, row tiles, frames). Shared memory: n_lvl levels of
// STAGE rows x sw words.
__global__ void __launch_bounds__(DIL_THREADS)
    dilate_kernel(const __grid_constant__ DilateParams p,
                  const unsigned char* __restrict__ x,
                  const unsigned char* __restrict__ excluded, int has_thr,
                  int thr, int h, int w, unsigned char* __restrict__ out) {
  extern __shared__ unsigned lv_smem[];
  const int sw = BW + 2 * p.pad;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  const long long frame = static_cast<long long>(blockIdx.z) * h * w;
  const int tid = threadIdx.x;
  const int col = tid % BW;
  const int ry0 = y0 + (tid / BW) * ROWS_PER_THREAD;
  unsigned acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0u;
  for (int yi0 = y0 - p.k; yi0 < y0 + BH + p.k; yi0 += STAGE) {
    // level 0: the staged rows' words, 0 outside the frame
    for (int i = tid; i < STAGE * sw; i += DIL_THREADS) {
      const int gy = yi0 + i / sw, gx = x0 - p.pad + i % sw;
      unsigned v = 0u;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const long long px = static_cast<long long>(gy) * w + gx;
        const unsigned char* c = x + 3 * (frame + px);
        const int r = c[0], g = c[1], b = c[2];
        const bool keep = (!excluded || !excluded[px]) &&
                          (!has_thr || r > thr || g > thr || b > thr);
        v = keep ? (r | g << 8 | b << 16) : 0u;
      }
      lv_smem[i] = v;
    }
    __syncthreads();
    for (int j = 1; j < p.n_lvl; ++j) {
      const unsigned* prev = lv_smem + (j - 1) * STAGE * sw;
      unsigned* cur = lv_smem + j * STAGE * sw;
      const int step = 1 << (j - 1);
      const int len = sw - (1 << j) + 1;
      for (int i = tid; i < STAGE * sw; i += DIL_THREADS) {
        const int c = i % sw;
        if (c < len) cur[i] = __vmaxu4(prev[i], prev[i + step]);
      }
      __syncthreads();
    }
    for (int s = 0; s < STAGE; ++s) {
      const int gy = yi0 + s;
      if (gy < 0 || gy >= h) continue;  // a row of zeros
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int dy = gy - (ry0 + i);
        if (dy < -p.k || dy > p.k) continue;
        const int f = dy + p.k;
        const unsigned* lvl = lv_smem + (p.lvl[f] * STAGE + s) * sw;
        const int a = col + p.pad - p.e[f];
        acc[i] = __vmaxu4(acc[i], __vmaxu4(lvl[a], lvl[a + p.d2[f]]));
      }
    }
    __syncthreads();
  }
  const int gx = x0 + col;
  if (gx >= w) return;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int gy = ry0 + i;
    if (gy >= h) break;
    unsigned char* o = out + 3 * (frame + static_cast<long long>(gy) * w + gx);
    o[0] = acc[i] & 0xff;
    o[1] = (acc[i] >> 8) & 0xff;
    o[2] = (acc[i] >> 16) & 0xff;
  }
}

// Grid (rows). Outputs [H, W] bytes / int16, and row_any [H].
__global__ void __launch_bounds__(PX_THREADS)
    query_kernel(const unsigned char* __restrict__ rgb,
                 const unsigned char* __restrict__ excluded,
                 const unsigned char* __restrict__ d60,
                 const unsigned char* __restrict__ d20,
                 const short* __restrict__ table, int n_table, int h, int w,
                 int border, unsigned char* __restrict__ q_nz,
                 short* __restrict__ q_slice,
                 unsigned char* __restrict__ q_mask,
                 unsigned char* __restrict__ high,
                 unsigned char* __restrict__ row_any) {
  const int y = blockIdx.x;
  const bool row_in = y >= border && y < h - border;
  int any = 0;
  for (int x = threadIdx.x; x < w; x += PX_THREADS) {
    const long long px = static_cast<long long>(y) * w + x;
    const bool clear = excluded && excluded[px];
    const int r = clear ? 0 : rgb[3 * px];
    const int g = clear ? 0 : rgb[3 * px + 1];
    const int b = clear ? 0 : rgb[3 * px + 2];
    // hem: the r = 60 dilation where the r = 20 one is 0
    const bool near = d20[3 * px] | d20[3 * px + 1] | d20[3 * px + 2];
    const int he = near ? 0
                        : gray(d60[3 * px], d60[3 * px + 1], d60[3 * px + 2]);
    const bool in = row_in && x >= border && x < w - border;
    const int nz = in && (r | g | b) != 0;
    const int hi = he > 0;
    q_nz[px] = nz;
    q_mask[px] = in && gray(r, g, b) > 2;
    high[px] = hi;
    q_slice[px] = slice_of(table, n_table, r, g, b);
    any |= nz | hi;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) row_any[y] = any != 0;
}

// Grid (pixel blocks, targets). outs: per target the four output pointers
// (t_above, grad, z_nonzero, z_slice), each [H, W].
__global__ void __launch_bounds__(PX_THREADS)
    target_kernel(const unsigned char* __restrict__ cdm,
                  const void* __restrict__ grad, int grad_is_rgb,
                  const unsigned char* __restrict__ zrgb,
                  const unsigned char* __restrict__ excluded, int thr,
                  const short* __restrict__ table, int n_table, long long hw,
                  const unsigned long long* __restrict__ outs) {
  const long long p =
      static_cast<long long>(blockIdx.x) * PX_THREADS + threadIdx.x;
  if (p >= hw) return;
  const int t = blockIdx.y;
  const long long i = static_cast<long long>(t) * hw + p;
  const bool clear = excluded && excluded[p];
  const int r = clear ? 0 : cdm[3 * i];
  const int g = clear ? 0 : cdm[3 * i + 1];
  const int b = clear ? 0 : cdm[3 * i + 2];
  short gv;
  if (grad_is_rgb) {
    const unsigned char* c = static_cast<const unsigned char*>(grad) + 3 * i;
    gv = static_cast<short>(gray(c[0], c[1], c[2]));
  } else {
    gv = static_cast<const short*>(grad)[i];
  }
  const int zr = zrgb[3 * i], zg = zrgb[3 * i + 1], zb = zrgb[3 * i + 2];
  const bool z_nz = zr > thr || zg > thr || zb > thr;
  const unsigned long long* o = outs + 4 * t;
  reinterpret_cast<unsigned char*>(o[0])[p] = r > thr || g > thr || b > thr;
  reinterpret_cast<short*>(o[1])[p] = gv;
  reinterpret_cast<unsigned char*>(o[2])[p] = z_nz;
  reinterpret_cast<short*>(o[3])[p] =
      z_nz ? slice_of(table, n_table, zr, zg, zb) : short(0);
}

}  // namespace

// x, out: u8 [n_t, h, w, 3]; excluded: bool [h, w] or null; with has_thr,
// input pixels with no channel above thr count as 0; ext: the 2k + 1
// footprint rows' extents (imageproc.filters.make_line_radii).
extern "C" int cms_dilate_rgb(const void* x, const void* excluded,
                              int has_thr, int thr, int n_t, int h, int w,
                              int n_rows, const int* ext, void* out,
                              void* stream, int device) {
  if (n_t <= 0 || h <= 0 || w <= 0) return 0;
  if (n_rows < 1 || n_rows > MAX_ROWS || n_rows % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DilateParams p;
  p.k = n_rows / 2;
  p.pad = 0;
  p.n_lvl = 1;
  for (int f = 0; f < n_rows; ++f) {
    const int e = ext[f];
    if (e < 0 || e > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
    const int n = 2 * e + 1;
    int j = 0;
    while ((2 << j) <= n) ++j;
    p.e[f] = e;
    p.lvl[f] = j;
    p.d2[f] = n - (1 << j);
    p.pad = e > p.pad ? e : p.pad;
    p.n_lvl = j + 1 > p.n_lvl ? j + 1 : p.n_lvl;
  }
  const size_t smem =
      sizeof(unsigned) * p.n_lvl * STAGE * (BW + 2 * p.pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaFuncSetAttribute(
        dilate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n_t);
    dilate_kernel<<<grid, DIL_THREADS, smem, s>>>(
        p, static_cast<const unsigned char*>(x),
        static_cast<const unsigned char*>(excluded), has_thr, thr, h, w,
        static_cast<unsigned char*>(out));
    return cudaGetLastError();
  });
}

// rgb, d60, d20: u8 [h, w, 3]; excluded: bool [h, w] or null; outputs:
// q_nz, q_mask, high bool and q_slice int16 [h, w], row_any bool [h].
extern "C" int cms_query_planes(const void* rgb, const void* excluded,
                                const void* d60, const void* d20,
                                const void* table, int n_table, int h, int w,
                                int border, void* q_nz, void* q_slice,
                                void* q_mask, void* high, void* row_any,
                                void* stream, int device) {
  if (h <= 0 || w <= 0) return 0;
  if (n_table <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    query_kernel<<<h, PX_THREADS, 0, s>>>(
        static_cast<const unsigned char*>(rgb),
        static_cast<const unsigned char*>(excluded),
        static_cast<const unsigned char*>(d60),
        static_cast<const unsigned char*>(d20),
        static_cast<const short*>(table), n_table, h, w,
        border > 0 ? border : 0, static_cast<unsigned char*>(q_nz),
        static_cast<short*>(q_slice), static_cast<unsigned char*>(q_mask),
        static_cast<unsigned char*>(high),
        static_cast<unsigned char*>(row_any));
    return cudaGetLastError();
  });
}

// cdm, zrgb: u8 [n_t, h, w, 3]; grad: u8 [n_t, h, w, 3] (grad_is_rgb) or
// int16 [n_t, h, w]; excluded: bool [h, w] or null; host_outs: 4 n_t
// output pointers, copied on `stream` into dev_outs (4 n_t words).
extern "C" int cms_target_planes(const void* cdm, const void* grad,
                                 int grad_is_rgb, const void* zrgb,
                                 const void* excluded, int thr,
                                 const void* table, int n_table, int n_t,
                                 int h, int w,
                                 const unsigned long long* host_outs,
                                 void* dev_outs, void* stream, int device) {
  if (n_t <= 0 || h <= 0 || w <= 0) return 0;
  if (n_table <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaMemcpyAsync(
        dev_outs, host_outs, sizeof(unsigned long long) * 4 * n_t,
        cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
    const long long hw = static_cast<long long>(h) * w;
    const dim3 grid(static_cast<unsigned>((hw + PX_THREADS - 1) / PX_THREADS),
                    n_t);
    target_kernel<<<grid, PX_THREADS, 0, s>>>(
        static_cast<const unsigned char*>(cdm), grad, grad_is_rgb,
        static_cast<const unsigned char*>(zrgb),
        static_cast<const unsigned char*>(excluded), thr,
        static_cast<const short*>(table), n_table, hw,
        static_cast<const unsigned long long*>(dev_outs));
    return cudaGetLastError();
  });
}
