// Count-capped prescreen bound for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces the XLA function (not a Pallas kernel) of the JAX package's
// two-phase screen, colormipsearch_tpu/cds/prescreen.py:269
// _variant_block_bounds_capped, which runs it as dense bf16 products on
// the matrix unit:
//
//   bound[b, t] = max over variants v of
//                 sum over cells C of min(sum_j u[b, C, j] * w01[v, t, C, j],
//                                         cnt[v, t, C])
//
// with a variant an offset of shift_ring_offsets(xyShift) on the direct or
// the x-flipped raw frame, C the 8 x 16 cells of the tile-aligned grid and
// j the 60 hue bins. Plain versions and wrappers: cds/prescreen.py
// (cell_masks_plain / prescreen_cells, capped_bounds_plain /
// prescreen_capped). Integer arithmetic only, so both equal the reference
// exactly: counts <= 128, sums below 2^24.
//
// cms_prescreen_cells: w01 and cnt of every (variant, cell, target), as
// int64 bits (bit j = w01[j]) and uint8 counts, [variant][cell][target],
// targets innermost so that the second kernel's reads coalesce. One block
// per cell row and CELLS_TARGETS targets. It reads the rows of its cell
// row and the shift ring around them from device memory once, as bin
// bytes in shared memory (frame columns outside the frame and rows outside
// it hold an invalid bin), and serves every variant's shifted window from
// there: the flipped window of a cell is the raw columns mirrored about
// the raw frame width (the reference flips the raw frame before its ring
// pad, _sliding_cell_stats :225). A window's bits are the OR of its valid
// pixels' compat bits, colbits[k] (bit j set iff compat[j, k]); colbits
// arrives with the launch's parameters (constant memory) and is read from
// a 64-entry table in shared memory. Bound: the bytes (each word read
// once, the bits and counts written once) or the OR and count of each
// window pixel of each variant, whichever is larger.
//
// cms_prescreen_capped: the capped sums from a per-mask CSR of the query
// features (QueryRows: each mask's non-zero cells, each cell's (bin,
// count) entries). One block per mask and CAPPED_THREADS targets, one
// target per thread (a block per group of masks leaves a 1024 x 256
// partition ~2 blocks per SM, too few reads in flight to hide their
// latency). The block stages the mask's cells and entries in shared
// memory (in chunks when they do not fit); for each variant each thread
// reads its target's bits and count of the mask's cells (coalesced over
// the targets, CELL_UNROLL cells' reads in flight), sums count * bit over the
// cell's entries in an int32, adds min(sum, count) to the variant's sum,
// and at the end writes the max over the variants once as f32. No
// [mask, target, cell] intermediate exists. Cells where the query is zero
// add min(0, cnt) = 0, so skipping them is exact: the at-size masks hold
// ~1-5 % of the cells and ~0.2 % of the (cell, bin) entries, where the
// dense product multiplies all of them. Bound: its lane operations (a bit
// test and a multiply-add per (entry, variant, target), a min and an add
// per (cell, variant, target)) or its bytes (the bits, counts and CSR
// read once, the bounds written once), whichever is larger; the
// operations, at the phase-4 partition.
//
// Why not the tensor cores: a dense mma over every cell and bin would have
// a bound of ~3.3 ms at 989 TFLOP/s bf16 per 1024 x 256 partition, and
// still do hundreds of times the work these inputs need.

#include "multimask_common.cuh"

namespace {

constexpr int N_BINS = 60;
constexpr int NO_BIN = 63;  // table entry 63 is 0: not a valid pixel
constexpr int CELL_H = 8;
constexpr int CELL_W = 16;
constexpr int MAX_OFFSETS = 32;  // prescreen.MAX_OFFSETS
constexpr int CELLS_THREADS = 256;
constexpr int CELLS_TARGETS = 4;
constexpr int CAPPED_THREADS = 128;
constexpr int CELL_CAP = 256;    // cells of one staged chunk
constexpr int ENTRY_CAP = 1024;  // entries of one staged chunk (>= 60)
constexpr int CELL_UNROLL = 4;
constexpr int MAX_SMEM = 232448;

struct CellParams {
  unsigned long long colbits[N_BINS];
  int n_off;
  int dx[MAX_OFFSETS];
  int dy[MAX_OFFSETS];
};

// The bin of a packed word (prescreen.bin_plane_from_words), NO_BIN where
// the pixel is not selected or has no sector; sector 7 would give a bin
// past N_BINS, which the reference neither marks nor counts.
__device__ __forceinline__ int pixel_bin(int word) {
  const int b = word & 0xFF;
  const int a = (word >> 8) & 0xFF;
  const int s = (word >> 16) & 7;
  const int sel = (word >> 19) & 1;
  if (!sel || s == 0 || s > 6) return NO_BIN;
  return (s - 1) * 10 + min((a * 10) / max(b, 1), 9);
}

// Grid (target groups, cell rows). Shared memory: the 64-entry table,
// then CELLS_TARGETS bands of (8 + 2 pad) rows x sw raw columns from lo.
__global__ void __launch_bounds__(CELLS_THREADS)
    cells_kernel(const __grid_constant__ CellParams p,
                 const int* __restrict__ words, int n_t, int h, int w,
                 int gwn, int pad, int lo, int sw,
                 unsigned long long* __restrict__ bits,
                 unsigned char* __restrict__ cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* table = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* band = smem + 64 * sizeof(unsigned long long);
  const int rows = CELL_H + 2 * pad;
  const int cy = blockIdx.y;
  const int t0 = blockIdx.x * CELLS_TARGETS;
  if (threadIdx.x < 64)
    table[threadIdx.x] = threadIdx.x < N_BINS ? p.colbits[threadIdx.x] : 0ull;
  // stage: band row r of target tl is frame row 8 cy - pad + r
  for (int tr = 0; tr < CELLS_TARGETS * rows; ++tr) {
    const int tl = tr / rows;
    const int fr = cy * CELL_H - pad + (tr - tl * rows);
    const int t = t0 + tl;
    const bool in_rows = t < n_t && fr >= 0 && fr < h;
    const int* src =
        in_rows ? words + (static_cast<long long>(t) * h + fr) * w : words;
    unsigned char* dst = band + tr * sw;
    for (int c = threadIdx.x; c < sw; c += CELLS_THREADS) {
      const int fc = lo + c;
      dst[c] = in_rows && fc >= 0 && fc < w ? pixel_bin(src[fc]) : NO_BIN;
    }
  }
  __syncthreads();
  const int n_var = 2 * p.n_off;
  const int npos = gridDim.y * gwn;
  const int items = n_var * gwn * CELLS_TARGETS;
  for (int it = threadIdx.x; it < items; it += CELLS_THREADS) {
    const int tl = it % CELLS_TARGETS;
    const int rest = it / CELLS_TARGETS;
    const int cx = rest % gwn;
    const int v = rest / gwn;
    const int t = t0 + tl;
    if (t >= n_t) continue;
    const bool flip = v >= p.n_off;
    const int o = flip ? v - p.n_off : v;
    const int dx = p.dx[o];
    const int dy = p.dy[o];
    // the window's columns of the oriented frame are 16 cx + dx .. +15;
    // flipped, those are raw columns w - 16 - 16 cx - dx .. +15
    const int c0 = (flip ? w - CELL_W - CELL_W * cx - dx : CELL_W * cx + dx)
                   - lo;
    const unsigned char* src = band + (tl * rows + pad + dy) * sw + c0;
    unsigned long long acc = 0;
    int n = 0;
#pragma unroll 2
    for (int y = 0; y < CELL_H; ++y) {
#pragma unroll
      for (int x = 0; x < CELL_W; ++x) {
        const int b = src[y * sw + x];
        acc |= table[b];
        n += b < N_BINS;
      }
    }
    const long long at =
        (static_cast<long long>(v) * npos + cy * gwn + cx) * n_t + t;
    bits[at] = acc;
    cnt[at] = static_cast<unsigned char>(n);
  }
}

// Grid (masks, target tiles). Shared memory: per staged chunk its cells'
// positions and entry offsets and its entries, and each variant's running
// sum per thread.
__global__ void __launch_bounds__(CAPPED_THREADS)
    capped_kernel(const int* __restrict__ mask_off,
                  const int* __restrict__ cell_pos,
                  const int* __restrict__ cell_off,
                  const int* __restrict__ entries,
                  const unsigned long long* __restrict__ bits,
                  const unsigned char* __restrict__ cnt, int nv, int npos,
                  int n_t, float* __restrict__ out) {
  extern __shared__ __align__(16) int ismem[];
  int* s_pos = ismem;                  // [CELL_CAP]
  int* s_off = s_pos + CELL_CAP;       // [CELL_CAP + 1]
  int* s_ent = s_off + CELL_CAP + 1;   // [ENTRY_CAP]
  int* s_tot = s_ent + ENTRY_CAP;      // [nv][CAPPED_THREADS]
  int* s_end = s_tot + nv * CAPPED_THREADS;
  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const int t = blockIdx.y * CAPPED_THREADS + tid;
  const bool active = t < n_t;
  const long long plane = static_cast<long long>(npos) * n_t;
  for (int v = 0; v < nv; ++v) s_tot[v * CAPPED_THREADS + tid] = 0;
  const int c_end = mask_off[m + 1];
  for (int cs = mask_off[m]; cs < c_end;) {
    if (tid == 0) {  // the longest run of cells from cs that fits
      const int e0 = cell_off[cs];
      int lo_c = cs + 1, hi_c = min(c_end, cs + CELL_CAP);
      while (lo_c < hi_c) {
        const int mid = (lo_c + hi_c + 1) / 2;
        if (cell_off[mid] - e0 <= ENTRY_CAP) lo_c = mid; else hi_c = mid - 1;
      }
      *s_end = lo_c;
    }
    __syncthreads();
    const int ce = *s_end;
    const int nc = ce - cs;
    const int e0 = cell_off[cs];
    const int ne = cell_off[ce] - e0;
    for (int i = tid; i < nc; i += CAPPED_THREADS) {
      s_pos[i] = cell_pos[cs + i];
      s_off[i] = cell_off[cs + i] - e0;
    }
    if (tid == 0) s_off[nc] = ne;
    for (int i = tid; i < ne; i += CAPPED_THREADS) s_ent[i] = entries[e0 + i];
    __syncthreads();
    if (active) {
      for (int v = 0; v < nv; ++v) {
        const unsigned long long* bv = bits + v * plane + t;
        const unsigned char* cv = cnt + v * plane + t;
        int acc = 0;
        // CELL_UNROLL cells' loads are issued before any is used, so each
        // thread keeps several reads of device memory in flight
        for (int c0 = 0; c0 < nc; c0 += CELL_UNROLL) {
          unsigned long long b[CELL_UNROLL];
          int cap[CELL_UNROLL];
#pragma unroll
          for (int k = 0; k < CELL_UNROLL; ++k) {
            const bool in = c0 + k < nc;
            const long long at =
                static_cast<long long>(in ? s_pos[c0 + k] : 0) * n_t;
            b[k] = in ? bv[at] : 0ull;
            cap[k] = in ? cv[at] : 0;
          }
#pragma unroll
          for (int k = 0; k < CELL_UNROLL; ++k) {
            if (c0 + k >= nc) break;
            int s = 0;
            for (int e = s_off[c0 + k]; e < s_off[c0 + k + 1]; ++e) {
              const int en = s_ent[e];
              s += (en >> 8) * static_cast<int>((b[k] >> (en & 63)) & 1ull);
            }
            acc += min(s, cap[k]);
          }
        }
        s_tot[v * CAPPED_THREADS + tid] += acc;
      }
    }
    __syncthreads();  // the chunk's tables are restaged next
    cs = ce;
  }
  if (active) {
    int best = 0;
    for (int v = 0; v < nv; ++v)
      best = max(best, s_tot[v * CAPPED_THREADS + tid]);
    out[static_cast<long long>(m) * n_t + t] = static_cast<float>(best);
  }
}

}  // namespace

// words: int32 [n_t, h, w]; colbits: N_BINS host int64; shifts: n_off
// host (dx, dy) pairs; bits: int64 [2 n_off, ghn * gwn, n_t]; cnt: uint8
// of the same shape.
extern "C" int cms_prescreen_cells(const void* words, int n_t, int h, int w,
                                   int ghn, int gwn, const long long* colbits,
                                   int n_off, const int* shifts, void* bits,
                                   void* cnt, void* stream, int device) {
  if (n_t <= 0) return 0;
  if (n_off < 1 || n_off > MAX_OFFSETS || h > ghn * CELL_H ||
      w > gwn * CELL_W)
    return static_cast<int>(cudaErrorInvalidValue);
  CellParams p;
  for (int k = 0; k < N_BINS; ++k)
    p.colbits[k] = static_cast<unsigned long long>(colbits[k]);
  p.n_off = n_off;
  int pad = 0;
  for (int o = 0; o < n_off; ++o) {
    p.dx[o] = shifts[2 * o];
    p.dy[o] = shifts[2 * o + 1];
    const int ax = p.dx[o] < 0 ? -p.dx[o] : p.dx[o];
    const int ay = p.dy[o] < 0 ? -p.dy[o] : p.dy[o];
    pad = ax > pad ? ax : pad;
    pad = ay > pad ? ay : pad;
  }
  // the raw columns any window reads: lo .. hi - 1 (direct and flipped)
  const int lo = w - CELL_W * gwn - pad;
  const int sw = CELL_W * gwn + pad - lo;
  const size_t smem = 64 * sizeof(unsigned long long) +
                      static_cast<size_t>(CELLS_TARGETS) *
                          (CELL_H + 2 * pad) * sw;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaFuncSetAttribute(
        cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((n_t + CELLS_TARGETS - 1) / CELLS_TARGETS, ghn);
    cells_kernel<<<grid, CELLS_THREADS, smem, s>>>(
        p, static_cast<const int*>(words), n_t, h, w, gwn, pad, lo, sw,
        static_cast<unsigned long long*>(bits),
        static_cast<unsigned char*>(cnt));
    return cudaGetLastError();
  });
}

// The CSR (int32: mask_off [n_masks + 1], cell_pos, cell_off, entries),
// bits int64 and cnt uint8 [nv, npos, n_t]; out f32 [n_masks, n_t].
extern "C" int cms_prescreen_capped(const void* mask_off, const void* cell_pos,
                                    const void* cell_off, const void* entries,
                                    int n_masks, const void* bits,
                                    const void* cnt, int nv, int npos, int n_t,
                                    void* out, void* stream, int device) {
  if (n_masks <= 0 || n_t <= 0) return 0;
  if (nv < 1 || nv > 2 * MAX_OFFSETS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(int) * (CELL_CAP + CELL_CAP + 1 + ENTRY_CAP +
                     static_cast<size_t>(nv) * CAPPED_THREADS + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaFuncSetAttribute(
        capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(n_masks, (n_t + CAPPED_THREADS - 1) / CAPPED_THREADS);
    capped_kernel<<<grid, CAPPED_THREADS, smem, s>>>(
        static_cast<const int*>(mask_off), static_cast<const int*>(cell_pos),
        static_cast<const int*>(cell_off), static_cast<const int*>(entries),
        static_cast<const unsigned long long*>(bits),
        static_cast<const unsigned char*>(cnt), nv, npos, n_t,
        static_cast<float*>(out));
    return cudaGetLastError();
  });
}
