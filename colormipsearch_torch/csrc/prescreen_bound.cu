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
// targets innermost so that the second kernel's slabs are 2-D boxes. One
// block per CELL_ROWS cell rows and CELLS_TARGETS targets (fewer targets
// where a wide frame or a large shift would not fit). Bound: the bytes,
// each word read once and the bits and counts written once (0.70 + 0.24
// GB per 256-target partition at 566 x 1210). A window's bits are the OR
// of its valid pixels' compat bits; the first design looked each window
// pixel up in a 64-bit table once per variant (18 x 128 lookups per cell
// and target, with bank conflicts) and waited on one row of reads at a
// time. Here each pixel's bin is computed once and its presence once per
// distinct dy, and nothing is looked up per pixel:
//   1. stage the band's bins (frame rows 8 cy0 - pad .. 8 (cy0 +
//      CELL_ROWS) - 1 + pad, raw columns w - 16 gwn - pad .. 16 gwn + pad;
//      outside the frame a pixel has no bin) as bytes in shared memory,
//      each thread's reads of STAGE_ROWS rows x 2 columns issued before
//      any is used, and the bin computed without a branch or a division;
//   2. per distinct dy, the vertical pass: for every raw column, the
//      presence bits (1 << bin) and valid count of its 8 rows from
//      8 cy + dy, one 64-bit word per column (presence in bits 0..59, the
//      count, <= 8, in bits 60..63), stored with one spare word every 16
//      columns so that neighbouring cells' reads fall in other banks;
//   3. per variant with that dy, the horizontal pass: OR and add the 16
//      words of the window's raw columns (the flipped window of a cell is
//      the raw columns w - 16 - 16 cx - dx .. +15: OR and count do not
//      depend on the order), then turn the window's presence into compat
//      bits, one table entry per distinct bin present (compat is applied
//      to the presence, as the reference's presence @ compat^T is).
//
// cms_prescreen_capped: the capped sums from the query CSR regrouped by
// band (prescreen.QueryBands, built once per sweep beside the CSR: the
// records of MASK_GROUP masks' cells in one band of BAND_CELLS cells are
// one contiguous range, ordered by mask, each record with its entries'
// counts and each entry a one-hot word of its bin and its count). One
// block per (mask group, CAP_T targets, variant). Bound: its operations
// (a bit test and a multiply-add per (entry, variant, target), a min and
// an add per (cell, variant, target)). The first design ran a block per
// mask and read the mask's cells of the table from device memory for
// every mask: 8.1 GB for a 235 MB table per 1024 x 256 partition, bound
// by the latency of those reads (a table held in L2 ran no faster). Here
// each block walks the bands and holds one slab of the table, bits[v,
// band, targets] and its counts (BAND_CELLS x CAP_T: one 2-D box, copied
// with cp.async, double-buffered so the next band's copy overlaps this
// band's work, one barrier per band), in shared memory, and streams every
// record of its masks in that band past it: a table byte leaves L2 once
// per mask group. Each warp takes an equal share of the band's records in
// batches of at most 32 records and WARP_ENTS entries, staged from
// registers that were read while the previous batch was summed; its two
// half-warps take alternate records, four targets per lane, so a
// record's decode and an entry's read serve four targets, and a bit test
// is one AND with the entry's one-hot word. A half-warp adds each
// record's capped sums for v to its mask's running sums in shared memory
// (integer atomic adds: exact in any order). At the end the block folds v into the
// output with an integer atomicMax on the f32 bit pattern (non-negative
// floats order as ints).
//
// Why not the tensor cores: a dense mma over every cell and bin would have
// a bound of ~3.3 ms at 989 TFLOP/s bf16 per 1024 x 256 partition, and
// still do hundreds of times the work these inputs need.

#include <algorithm>
#include <cstdlib>

#include "multimask_common.cuh"

namespace {

constexpr int N_BINS = 60;
constexpr int NO_BIN = 63;  // not a valid pixel
constexpr int CELL_H = 8;
constexpr int CELL_W = 16;
constexpr int MAX_OFFSETS = 32;  // prescreen.MAX_OFFSETS
constexpr int MAX_PAD = 8;       // prescreen.MAX_PAD
constexpr int CELLS_THREADS = 512;
constexpr int CELLS_TARGETS = 2;
constexpr int CELL_ROWS = 2;   // cell rows per block
constexpr int STAGE_ROWS = 8;  // rows whose reads a thread issues together
constexpr int CAP_T = 64;  // targets per block: two per lane
constexpr int CAP_THREADS = 512;
constexpr int CAP_WARPS = CAP_THREADS / 32;
constexpr int BAND_CELLS = 64;   // prescreen.BAND_CELLS
constexpr int MASK_GROUP = 128;  // prescreen.MASK_GROUP
constexpr int WARP_ENTS = 64;    // entries of one warp's batch (>= N_BINS)
constexpr int SLAB = BAND_CELLS * CAP_T;
constexpr int MAX_SMEM = 232448;
constexpr unsigned long long PRESENCE = (1ull << N_BINS) - 1;
static_assert(CELLS_THREADS >= 256, "a thread per entry of magic");
static_assert((CELL_ROWS & (CELL_ROWS - 1)) == 0 &&
                  (CELLS_TARGETS & (CELLS_TARGETS - 1)) == 0,
              "the horizontal pass splits its items with shifts");

struct CellParams {
  unsigned long long colbits[N_BINS];
  unsigned magic[256];  // ceil(2^20 / max(b, 1))
  int n_off;
  int dx[MAX_OFFSETS];
  int n_dy;                        // distinct dy values
  int dy[MAX_OFFSETS];             // each distinct dy
  int dy_start[MAX_OFFSETS + 1];   // its offsets: offs[dy_start[d] ..]
  int offs[MAX_OFFSETS];           // offset indices, grouped by dy
};

// The bin of a packed word (prescreen.bin_plane_from_words), NO_BIN where
// the pixel is not selected or has no sector; sector 7 would give a bin
// past N_BINS, which the reference neither marks nor counts. No branch:
// the decile floor(10 a / b) (a, b < 256) is (10 a * magic[b]) >> 20 with
// magic[b] = ceil(2^20 / max(b, 1)), exact because 10 a (magic[b] b - 2^20)
// < 2550 * 255 < 2^20 (checked for every a and b).
__device__ __forceinline__ int pixel_bin(int word, const unsigned* magic) {
  const unsigned b = word & 0xFF;
  const unsigned a = (word >> 8) & 0xFF;
  const unsigned s = (word >> 16) & 7;
  const bool valid = ((word >> 19) & 1) && s - 1 < 6;
  const unsigned rb = min((10 * a * magic[b]) >> 20, 9u);
  return valid ? (s - 1) * 10 + rb : NO_BIN;
}

// 1 << k, and 0 for k >= 32 (a PTX shift clamps its amount)
__device__ __forceinline__ unsigned bit_or_zero(unsigned k) {
  unsigned r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(1u), "r"(k));
  return r;
}

// Grid (target groups, runs of CELL_ROWS cell rows). Shared memory: the
// 64-entry compat table, then per cell row and target the vertical pass's
// words (vs each), then per target its band of (8 CELL_ROWS + 2 pad) rows
// x sw raw bin bytes from lo.
__global__ void __launch_bounds__(CELLS_THREADS, 2)
    cells_kernel(const __grid_constant__ CellParams p,
                 const int* __restrict__ words, int n_t, int h, int w,
                 int ghn, int gwn, int pad, int lo, int sw, int vs, int tg,
                 unsigned long long* __restrict__ bits,
                 unsigned char* __restrict__ cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* table = reinterpret_cast<unsigned long long*>(smem);
  unsigned* magic = reinterpret_cast<unsigned*>(table + 64);
  unsigned long long* vcol = table + 64 + 128;
  unsigned char* band =
      reinterpret_cast<unsigned char*>(vcol + CELL_ROWS * tg * vs);
  const int rows = CELL_ROWS * CELL_H + 2 * pad;
  const int cy0 = blockIdx.y * CELL_ROWS;
  const int t0 = blockIdx.x * tg;
  const int tid = threadIdx.x;
  if (tid < 64) table[tid] = tid < N_BINS ? p.colbits[tid] : 0ull;
  if (tid < 256) magic[tid] = p.magic[tid];
  __syncthreads();
  // 1. stage: band row r of target tl is frame row 8 cy0 - pad + r. A
  // thread issues the reads of STAGE_ROWS rows x 2 columns before it
  // converts any, so that many of its reads are in flight at once.
  for (int tr0 = 0; tr0 < tg * rows; tr0 += STAGE_ROWS) {
    // each row's raw column lo, and whether the row is in the frame
    const int* row[STAGE_ROWS];
    bool row_in[STAGE_ROWS];
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k) {
      const int tr = tr0 + k;
      const int tl = tr / rows;
      const int fr = cy0 * CELL_H - pad + (tr - tl * rows);
      row_in[k] = tr < tg * rows && t0 + tl < n_t && fr >= 0 && fr < h;
      row[k] = row_in[k]
                   ? words + (static_cast<long long>(t0 + tl) * h + fr) * w + lo
                   : words - lo;
    }
    const int n_k = min(STAGE_ROWS, tg * rows - tr0);
    for (int c0 = tid; c0 < sw; c0 += 2 * CELLS_THREADS) {
      // every read is made (outside the frame it reads a word in range and
      // drops it) and every bin computed, with no branch among them
      int word[STAGE_ROWS][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = c0 + q * CELLS_THREADS;
        const bool in_cols = c < sw && lo + c >= 0 && lo + c < w;
        const int cc = in_cols ? c : -lo;  // row[k] + cc is in range
#pragma unroll
        for (int k = 0; k < STAGE_ROWS; ++k) word[k][q] = row[k][cc];
#pragma unroll
        for (int k = 0; k < STAGE_ROWS; ++k)
          word[k][q] = pixel_bin(in_cols && row_in[k] ? word[k][q] : 0, magic);
      }
#pragma unroll
      for (int k = 0; k < STAGE_ROWS; ++k) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q * CELLS_THREADS;
          if (k < n_k && c < sw) band[(tr0 + k) * sw + c] = word[k][q];
        }
      }
    }
  }
  __syncthreads();
  const int npos = ghn * gwn;
  const int n_rows = min(CELL_ROWS, ghn - cy0);  // cell rows of this block
  for (int d = 0; d < p.n_dy; ++d) {
    // 2. vertical: rows pad + dy .. +7 of every raw column
    for (int rt = 0; rt < n_rows * tg; ++rt) {
      const int cr = rt / tg, tl = rt - cr * tg;
      const unsigned char* col =
          band + (tl * rows + cr * CELL_H + pad + p.dy[d]) * sw;
      unsigned long long* out = vcol + rt * vs;
      for (int c = tid; c < sw; c += CELLS_THREADS) {
        unsigned lo32 = 0, hi32 = 0, n = 0;
#pragma unroll
        for (int y = 0; y < CELL_H; ++y) {
          const unsigned b = col[y * sw + c];
          lo32 |= bit_or_zero(b);
          hi32 |= bit_or_zero(b - 32);  // NO_BIN sets bit 31: masked below
          n += b < N_BINS;
        }
        hi32 &= static_cast<unsigned>(PRESENCE >> 32);
        out[c + (c >> 4)] =
            (static_cast<unsigned long long>(hi32 | n << 28) << 32) | lo32;
      }
    }
    __syncthreads();
    // 3. horizontal: each variant with this dy, each cell and target
    // item (vv, r): variant vv of this dy (offset vv / 2, flipped if odd);
    // r = cx << log_rt | cr << log_tg | tl, walked without a division
    const int k0 = p.dy_start[d];
    const int n_vv = 2 * (p.dy_start[d + 1] - k0);
    const int log_tg = __ffs(tg) - 1;
    const int log_rt = __ffs(CELL_ROWS) - 1 + log_tg;
    const int per_var = gwn << log_rt;
    int vv = 0;
    for (int r = tid;; r += CELLS_THREADS) {
      while (r >= per_var) {  // as r passes a variant's end
        r -= per_var;
        ++vv;
      }
      if (vv >= n_vv) break;
      const int rt = r & ((1 << log_rt) - 1);  // cell row cr, target tl
      const int cr = rt >> log_tg, tl = rt & (tg - 1);
      const int cx = r >> log_rt;
      const int flip = vv & 1;
      const int o = p.offs[k0 + (vv >> 1)];
      const int t = t0 + tl;
      if (t >= n_t || cr >= n_rows) continue;
      const int dx = p.dx[o];
      const int c0 = (flip ? w - CELL_W - CELL_W * cx - dx : CELL_W * cx + dx)
                     - lo;
      // column c0 + j sits at word c0 + j + (c0 + j) / 16
      const unsigned long long* src = vcol + rt * vs + c0 + (c0 >> 4);
      const int split = CELL_W - (c0 & 15);
      unsigned lo32 = 0, hi32 = 0, n = 0;
#pragma unroll
      for (int j = 0; j < CELL_W; ++j) {
        const unsigned long long x = src[j + (j >= split)];
        lo32 |= static_cast<unsigned>(x);
        hi32 |= static_cast<unsigned>(x >> 32);
        n += static_cast<unsigned>(x >> 60);
      }
      hi32 &= static_cast<unsigned>(PRESENCE >> 32);
      unsigned long long acc = 0;
      while (lo32) {
        acc |= table[__ffs(lo32) - 1];
        lo32 &= lo32 - 1;
      }
      while (hi32) {
        acc |= table[31 + __ffs(hi32)];
        hi32 &= hi32 - 1;
      }
      const int v = flip ? p.n_off + o : o;
      const long long at =
          (static_cast<long long>(v) * npos + (cy0 + cr) * gwn + cx) * n_t +
          t;
      bits[at] = acc;
      cnt[at] = static_cast<unsigned char>(n);
    }
    __syncthreads();  // the next dy rewrites the vertical words
  }
}

// An 8-byte asynchronous copy; src_bytes 0 fills the 8 bytes with zeros.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// Grid (mask groups, target tiles of CAP_T, variants). Shared memory: two
// slabs of bits and two of counts, the masks' running sums, and each
// warp's staged batch of entries. The two half-warps take alternate
// records of a batch; lane q of a half holds targets t0 + 4 q .. + 3, so
// that a record's decode and each entry's read serve four targets.
__global__ void __launch_bounds__(CAP_THREADS, 2)
    capped_kernel(const int* __restrict__ seg_off,
                  const int* __restrict__ recs,
                  const int* __restrict__ rec_off,
                  const unsigned long long* __restrict__ ents, int n_ent,
                  const unsigned long long* __restrict__ bits,
                  const unsigned char* __restrict__ cnt, int n_masks,
                  int npos, int n_t, int n_bands, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_bits = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* s_ent = s_bits + 2 * SLAB;  // [warp][WARP_ENTS]
  int* s_sum = reinterpret_cast<int*>(s_ent + CAP_WARPS * WARP_ENTS);
  unsigned char* s_cnt =
      reinterpret_cast<unsigned char*>(s_sum + MASK_GROUP * CAP_T);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane >> 4;
  const int quad = lane & 15;
  unsigned long long* w_ent = s_ent + warp * WARP_ENTS;
  const int g = blockIdx.x;
  const int t0 = blockIdx.y * CAP_T;
  const long long plane = static_cast<long long>(blockIdx.z) * npos;
  for (int i = tid; i < MASK_GROUP * CAP_T; i += CAP_THREADS) s_sum[i] = 0;
  // a slab entry i is cell i / CAP_T of the band and target t0 + i % CAP_T
  unsigned char c_next[SLAB / CAP_THREADS];
  // a band that none of the group's masks touches is never read
  auto load_band = [&](int b, int buf) {
    const int seg = g * n_bands + b;
    if (seg_off[seg] == seg_off[seg + 1]) return;
#pragma unroll
    for (int k = 0; k < SLAB / CAP_THREADS; ++k) {
      const int i = tid + k * CAP_THREADS;
      const int pos = b * BAND_CELLS + i / CAP_T;
      const int t = t0 + i % CAP_T;
      const bool in = pos < npos && t < n_t;
      const long long at = in ? (plane + pos) * n_t + t : 0;
      cp_async8(s_bits + buf * SLAB + i, bits + at, in ? 8 : 0);
      c_next[k] = in ? cnt[at] : 0;
    }
  };
  load_band(0, 0);
  cms::cp_async_commit();
  for (int b = 0; b < n_bands; ++b) {
    const int buf = b & 1;
    cms::cp_async_wait<0>();  // this thread's copies of band b
#pragma unroll
    for (int k = 0; k < SLAB / CAP_THREADS; ++k)
      s_cnt[buf * SLAB + tid + k * CAP_THREADS] = c_next[k];
    // band b's slab is complete, and every warp is done with band b - 1,
    // whose buffers the copies of band b + 1 take
    __syncthreads();
    if (b + 1 < n_bands) load_band(b + 1, buf ^ 1);
    cms::cp_async_commit();
    // a record's row of the slab, from this lane's four targets on
    const ulonglong2* slab =
        reinterpret_cast<const ulonglong2*>(s_bits + buf * SLAB) + 2 * quad;
    const unsigned* caps =
        reinterpret_cast<const unsigned*>(s_cnt + buf * SLAB) + quad;
    // the warp's share of the band's records, in batches of at most
    // WARP_RECS records and WARP_ENTS entries; the next batch's records
    // and entries are read while this one is summed
    const int seg = g * n_bands + b;
    const int r0 = seg_off[seg];
    const int per = (seg_off[seg + 1] - r0 + CAP_WARPS - 1) / CAP_WARPS;
    const int k_end = min(seg_off[seg + 1], r0 + (warp + 1) * per);
    int k = r0 + warp * per;
    if (k >= k_end) continue;
    int e_base = rec_off[k];
    int rec_next = k + lane < k_end ? recs[k + lane] : 0;
    unsigned long long ent_next[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = e_base + lane + 32 * q;
      ent_next[q] = e < n_ent ? ents[e] : 0ull;
    }
    while (k < k_end) {
      // the batch: the longest run of records whose entries fit
      const int rec_cur = rec_next;
      const int count = ((rec_cur >> 8) & 63) + ((rec_cur >> 14) & 63);
      int end = count;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, end, d);
        if (lane >= d) end += up;
      }
      const bool fits = k + lane < k_end && end <= WARP_ENTS;
      const int n = __popc(__ballot_sync(0xFFFFFFFFu, fits));
      const int ne = __shfl_sync(0xFFFFFFFFu, end, n - 1);
      const int start = end - count;  // the record's first entry
      w_ent[lane] = ent_next[0];
      w_ent[32 + lane] = ent_next[1];
      __syncwarp();
      k += n;
      e_base += ne;
      if (k < k_end) {
        rec_next = k + lane < k_end ? recs[k + lane] : 0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = e_base + lane + 32 * q;
          ent_next[q] = e < n_ent ? ents[e] : 0ull;
        }
      }
      const uint2* ent = reinterpret_cast<const uint2*>(w_ent);
      for (int i = 0; i < n; i += 2) {
        const int j = i + half;
        const int rec = __shfl_sync(0xFFFFFFFFu, rec_cur, j & 31);
        int e = __shfl_sync(0xFFFFFFFFu, start, j & 31);
        if (j >= n) continue;  // an odd batch's last pair has one record
        const int pos = rec & 0xFF;
        const ulonglong2 b01 = slab[pos * (CAP_T / 2)];
        const ulonglong2 b23 = slab[pos * (CAP_T / 2) + 1];
        // the four targets' sums in the halves of two words (a cell's
        // counts add up to at most 128); bins below 32 test the low words
        // of the bits, the others the high words
        unsigned s01 = 0, s23 = 0;
        unsigned w0 = static_cast<unsigned>(b01.x);
        unsigned w1 = static_cast<unsigned>(b01.y);
        unsigned w2 = static_cast<unsigned>(b23.x);
        unsigned w3 = static_cast<unsigned>(b23.y);
        const int e_mid = e + ((rec >> 8) & 63);
#pragma unroll 1
        for (; e < e_mid; ++e) {
          const uint2 en = ent[e];
          if (w0 & en.x) s01 += en.y;
          if (w1 & en.x) s01 += en.y << 16;
          if (w2 & en.x) s23 += en.y;
          if (w3 & en.x) s23 += en.y << 16;
        }
        w0 = static_cast<unsigned>(b01.x >> 32);
        w1 = static_cast<unsigned>(b01.y >> 32);
        w2 = static_cast<unsigned>(b23.x >> 32);
        w3 = static_cast<unsigned>(b23.y >> 32);
        const int e_end = e + ((rec >> 14) & 63);
#pragma unroll 1
        for (; e < e_end; ++e) {
          const uint2 en = ent[e];
          if (w0 & en.x) s01 += en.y;
          if (w1 & en.x) s01 += en.y << 16;
          if (w2 & en.x) s23 += en.y;
          if (w3 & en.x) s23 += en.y << 16;
        }
        const unsigned cap = caps[pos * (CAP_T / 4)];
        int* sum = s_sum + (rec >> 20) * CAP_T + 4 * quad;
        atomicAdd(sum, min(s01 & 0xFFFF, cap & 0xFF));
        atomicAdd(sum + 1, min(s01 >> 16, (cap >> 8) & 0xFF));
        atomicAdd(sum + 2, min(s23 & 0xFFFF, (cap >> 16) & 0xFF));
        atomicAdd(sum + 3, min(s23 >> 16, cap >> 24));
      }
      __syncwarp();  // the batch is restaged next
    }
  }
  __syncthreads();
  for (int i = tid; i < MASK_GROUP * CAP_T; i += CAP_THREADS) {
    const int m = g * MASK_GROUP + i / CAP_T;
    const int t = t0 + i % CAP_T;
    const int sum = s_sum[i];
    if (sum > 0 && m < n_masks && t < n_t)
      atomicMax(reinterpret_cast<int*>(out) + static_cast<long long>(m) * n_t
                    + t,
                __float_as_int(static_cast<float>(sum)));
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
  for (int b = 0; b < 256; ++b)
    p.magic[b] = ((1u << 20) + std::max(b, 1) - 1) / std::max(b, 1);
  p.n_off = n_off;
  p.n_dy = 0;
  int pad = 0;
  for (int o = 0; o < n_off; ++o) {
    const int dx = shifts[2 * o], dy = shifts[2 * o + 1];
    p.dx[o] = dx;
    pad = std::max(pad, std::max(std::abs(dx), std::abs(dy)));
    bool seen = false;
    for (int d = 0; d < p.n_dy; ++d) seen = seen || p.dy[d] == dy;
    if (!seen) p.dy[p.n_dy++] = dy;
  }
  if (pad > MAX_PAD) return static_cast<int>(cudaErrorInvalidValue);
  int k = 0;
  for (int d = 0; d < p.n_dy; ++d) {
    p.dy_start[d] = k;
    for (int o = 0; o < n_off; ++o)
      if (shifts[2 * o + 1] == p.dy[d]) p.offs[k++] = o;
  }
  p.dy_start[p.n_dy] = k;
  // the raw columns any window reads: lo .. lo + sw - 1 (direct and
  // flipped); the vertical words of a target: vs, one spare per 16 columns,
  // vs % 16 == 4 so that a half-warp's four targets and four cells fall in
  // distinct banks
  const int lo = w - CELL_W * gwn - pad;
  const int sw = CELL_W * gwn + pad - lo;
  const int vs = (sw + sw / 16 + 1 + 11) / 16 * 16 + 4;
  const int rows = CELL_ROWS * CELL_H + 2 * pad;
  int tg = CELLS_TARGETS;
  auto smem_of = [&](int n) {
    return (64 + 128) * sizeof(unsigned long long) +
           static_cast<size_t>(n) *
               (CELL_ROWS * vs * sizeof(unsigned long long) +
                static_cast<size_t>(rows) * sw);
  };
  while (tg > 1 && smem_of(tg) > MAX_SMEM) tg /= 2;
  const size_t smem = smem_of(tg);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaFuncSetAttribute(
        cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cells_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const dim3 grid((n_t + tg - 1) / tg, (ghn + CELL_ROWS - 1) / CELL_ROWS);
    cells_kernel<<<grid, CELLS_THREADS, smem, s>>>(
        p, static_cast<const int*>(words), n_t, h, w, ghn, gwn, pad, lo, sw,
        vs,
        tg, static_cast<unsigned long long*>(bits),
        static_cast<unsigned char*>(cnt));
    return cudaGetLastError();
  });
}

// The banded query CSR (int32: seg_off [n_groups * n_bands + 1], recs,
// rec_off, entries; prescreen.QueryBands, built with mask_group and
// band_cells equal to this file's), bits int64 and cnt uint8 [nv, npos,
// n_t]; out f32 [n_masks, n_t], zeros on entry.
extern "C" int cms_prescreen_capped(const void* seg_off, const void* recs,
                                    const void* rec_off, const void* entries,
                                    int n_ent, int n_masks, int mask_group,
                                    int band_cells, int n_bands,
                                    const void* bits, const void* cnt, int nv,
                                    int npos, int n_t, void* out, void* stream,
                                    int device) {
  if (n_masks <= 0 || n_t <= 0) return 0;
  if (nv < 1 || nv > 2 * MAX_OFFSETS || mask_group != MASK_GROUP ||
      band_cells != BAND_CELLS ||
      n_bands != (npos + BAND_CELLS - 1) / BAND_CELLS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(unsigned long long) * (2 * SLAB + CAP_WARPS * WARP_ENTS) +
      sizeof(int) * MASK_GROUP * CAP_T + 2 * SLAB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cms::on_device(device, [&] {
    cudaError_t err = cudaFuncSetAttribute(
        capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(capped_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const dim3 grid((n_masks + MASK_GROUP - 1) / MASK_GROUP,
                    (n_t + CAP_T - 1) / CAP_T, nv);
    capped_kernel<<<grid, CAP_THREADS, smem, s>>>(
        static_cast<const int*>(seg_off), static_cast<const int*>(recs),
        static_cast<const int*>(rec_off),
        static_cast<const unsigned long long*>(entries), n_ent,
        static_cast<const unsigned long long*>(bits),
        static_cast<const unsigned char*>(cnt), n_masks, npos, n_t, n_bands,
        static_cast<float*>(out));
    return cudaGetLastError();
  });
}
