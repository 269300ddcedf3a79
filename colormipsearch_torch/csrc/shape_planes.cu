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
// clearRegions, the z-gap's maskRGB(thr)). Bound: the larger of the bytes
// (6 B/px and the mask) and the operations, 2 byte-quad maxima per
// footprint row and output pixel plus one per doubling level and input
// pixel (~2.2e8 for the query's r = 60 and r = 20 over one 566 x 1210
// frame); the eager version issued one torch op per footprint row and
// level over whole frames (121 at r = 60).
//
// The footprints the system uses (r = 10 for the z-gap, 60 and 20 for the
// query) are compiled in (EXT_R10, EXT_R20, EXT_R60 below, held to
// makeLineRadii's formula by static_asserts and to the caller's extents at
// every launch); other radii take the generic kernel (dilate_kernel).
// The compiled kernel (ring_kernel) is built for what the card is short
// of: instruction issue, and latency at the block's barriers.
// - A pixel is two 16-bit-lane words (R | G << 16, B): the card has one
//   instruction for two 16-bit maxima (VIMNMX.U16x2, and a three-input
//   one) but none for four byte maxima (__vmaxu4 is six instructions).
// - A block owns a strip of 128 columns, one per thread, and walks its
//   rows down the frame (or a chunk of them: a single frame is cut into
//   row chunks until the blocks fill the card twice). Each input row is
//   staged once: its bytes and its excluded-mask bytes are copied with
//   16-byte cp.async chunks one stage (S = 4 rows) ahead, then repacked
//   with the clearing and masking applied, and its doubling levels built
//   three at a time from a base level (one barrier per three). Each
//   window of the footprint's extents is read from the levels once per
//   input row (two or three reads) and folded into the running maxima of
//   every output row the row reaches: a ring of registers, one slot per
//   footprint row, shifted by one row per input row, so every footprint
//   index is compile-time: one maximum per footprint row and word, with
//   no index arithmetic or range test.
// - A footprint of more than 21 rows is cut into groups of at most 21
//   consecutive rows (r = 20: 2, r = 60: 6), each run by blocks of its own
//   into a partial of 32-bit RGB words; a second kernel (combine_kernel)
//   takes their maxima. The ring stays in registers, and the query's single
//   frame fills the card.
// - Output rows leave as 4-byte words (through a shared-memory row buffer,
//   flushed once per stage), not as three byte stores per pixel.
// - The unrolled code is kept small (the staging is called, not inlined,
//   and only a stage's rows are unrolled): a copy per row of the ring's
//   period ran slower and took minutes to build.
// Frames shorter than the footprint work: rows outside the frame stage as
// zeros, and output rows outside it are not stored. The frames must be
// 16-byte aligned (the wrapper copies others); a chunk read past a row's
// end stays inside the caching allocator's 512-byte-rounded block.
//
// dilate_kernel (the generic path) owns a tile of BH x BW output pixels of
// one frame, with one column and BH / 2 rows of it in each thread's
// registers; it walks the tile's input rows, y0 - k .. y0 + BH - 1 + k,
// STAGE rows at a time: it loads the rows' span of BW + 2 pad words into
// shared memory, builds their doubling levels there (level j holds the max
// of 2^j words from each column), and every output pixel then takes, for
// each staged row its footprint reaches, the max of the two overlapping
// windows of level floor(log2(2e + 1)) that cover [x - e, x + e], as the
// plain version does over whole frames.
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

#include <algorithm>

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

// ---- G2, the compiled footprints --------------------------------------

// makeLineRadii (imageproc/filters.make_line_radii) of r = 10, 20 and 60:
// the half-extent of each footprint row, dy = -k .. k
constexpr int EXT_R10[21] = {
    1, 4, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10, 9, 9, 9, 8, 8, 7, 6, 4, 1
};
constexpr int EXT_R20[41] = {
    1, 6, 8, 10, 12, 13, 14, 15, 16, 16, 17, 17, 18, 18, 19, 19, 19, 19,
    19, 20, 20, 20, 19, 19, 19, 19, 19, 18, 18, 17, 17, 16, 16, 15, 14,
    13, 12, 10, 8, 6, 1
};
constexpr int EXT_R60[121] = {
    1, 10, 15, 18, 21, 24, 26, 28, 29, 31, 33, 34, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 48, 49, 50, 50, 51, 51, 52, 53, 53,
    54, 54, 55, 55, 55, 56, 56, 56, 57, 57, 57, 58, 58, 58, 58, 58, 59,
    59, 59, 59, 59, 59, 59, 59, 59, 60, 60, 60, 59, 59, 59, 59, 59, 59,
    59, 59, 59, 58, 58, 58, 58, 58, 57, 57, 57, 56, 56, 56, 55, 55, 55,
    54, 54, 53, 53, 52, 51, 51, 50, 50, 49, 48, 48, 47, 46, 45, 44, 43,
    42, 41, 40, 39, 38, 37, 36, 34, 33, 31, 29, 28, 26, 24, 21, 18, 15,
    10, 1
};

__host__ __device__ constexpr int isqrt_c(int n) {
  int s = 0;
  while ((s + 1) * (s + 1) <= n) ++s;
  return s;
}

// makeLineRadii's formula: R2 = int(r * r) + 1, k = isqrt(R2), and row dy
// covers -isqrt(R2 - dy^2) .. isqrt(R2 - dy^2)
__host__ __device__ constexpr int foot_ext(int r2, int dy) {
  return isqrt_c(r2 - dy * dy);
}

template <int N>
constexpr bool table_is(const int (&ext)[N], int r2) {
  if (N != 2 * isqrt_c(r2) + 1) return false;
  for (int i = 0; i < N; ++i)
    if (ext[i] != foot_ext(r2, i - N / 2)) return false;
  return true;
}
static_assert(table_is(EXT_R10, 101), "EXT_R10 is not makeLineRadii(10)");
static_assert(table_is(EXT_R20, 401), "EXT_R20 is not makeLineRadii(20)");
static_assert(table_is(EXT_R60, 3601), "EXT_R60 is not makeLineRadii(60)");

// the doubling level whose two windows cover 2e + 1 columns
__host__ __device__ constexpr int lvl_of(int e) {
  int j = 0;
  while ((2 << j) <= 2 * e + 1) ++j;
  return j;
}

constexpr int RING_BW = 128;    // columns of a strip: one per thread
constexpr int RING_ROWS = 21;   // footprint rows of a group, at most
constexpr int COMBINE_THREADS = 256;

// a group of footprint rows lo .. lo + n - 1 of footprint r2
__host__ __device__ constexpr int g_uses(int r2, int lo, int n, int e) {
  int c = 0;
  for (int d = lo; d < lo + n; ++d) c += foot_ext(r2, d) == e;
  return c;
}
__host__ __device__ constexpr int g_pad(int r2, int lo, int n) {
  int m = 0;
  for (int d = lo; d < lo + n; ++d)
    m = foot_ext(r2, d) > m ? foot_ext(r2, d) : m;
  return m;
}
// the doubling levels built for a group whose widest extent is pad: up
// to 8-wide windows when a second phase of levels would serve only one
// more (r = 10's 17- to 21-wide windows then take three reads), else all
// that the widest window needs
__host__ __device__ constexpr int g_levels(int pad) {
  return lvl_of(pad) == 4 ? 4 : lvl_of(pad) + 1;
}
// input rows staged together (fewer cost barriers per row, more cost
// shared memory and so blocks per SM)
constexpr int STAGE_ROWS = 4;
__host__ __device__ constexpr int g_sw(int r2, int lo, int n) {
  return RING_BW + 2 * g_pad(r2, lo, n);
}
// bytes of a staged row's raw pixels (3 per pixel) and of its excluded
// mask (1 per pixel): the 16-byte chunks that hold them, one more for the
// misalignment
__host__ __device__ constexpr int g_raw_bytes(int r2, int lo, int n) {
  return 16 * ((3 * g_sw(r2, lo, n) + 15) / 16 + 1);
}
__host__ __device__ constexpr int g_mask_bytes(int r2, int lo, int n) {
  return 16 * ((g_sw(r2, lo, n) + 15) / 16 + 1);
}
constexpr int OUT_ROW_BYTES = 3 * RING_BW + 16;  // a row of the output buffer
// levels [NL][S][SW] (8-byte words), raw rows and mask rows [2][S] (a
// chunk staged while the one before it is folded), the output rows [S]
__host__ __device__ constexpr int g_smem(int r2, int lo, int n, bool part) {
  return STAGE_ROWS *
         (8 * g_levels(g_pad(r2, lo, n)) * g_sw(r2, lo, n) +
          2 * (g_raw_bytes(r2, lo, n) + g_mask_bytes(r2, lo, n)) +
          (part ? 0 : OUT_ROW_BYTES));
}

// the footprint r2 cut into groups: the first of n0 rows, the rest of
// RING_ROWS - 1
template <int R2>
struct Foot {
  static constexpr int K = isqrt_c(R2);
  static constexpr int ROWS = 2 * K + 1;
  static constexpr int G = (ROWS + RING_ROWS - 3) / (RING_ROWS - 1);
  static constexpr int N0 = ROWS - (RING_ROWS - 1) * (G - 1);
  __host__ __device__ static constexpr int lo(int g) {
    return -K + (g == 0 ? 0 : N0 + (RING_ROWS - 1) * (g - 1));
  }
  __host__ __device__ static constexpr int n(int g) {
    return g == 0 ? N0 : RING_ROWS - 1;
  }
  static constexpr int smem(bool part) {
    int m = 0;
    for (int g = 0; g < G; ++g)
      m = g_smem(R2, lo(g), n(g), part) > m ? g_smem(R2, lo(g), n(g), part)
                                             : m;
    return m;
  }
};
static_assert(Foot<101>::G == 1 && Foot<401>::G == 2 && Foot<3601>::G == 6,
              "groups");
static_assert(Foot<3601>::N0 <= RING_ROWS && Foot<3601>::N0 > 0, "groups");

template <int R2, int LO, int N>
struct Group {
  static constexpr int LO_ROW = LO, N_ROWS = N;
  static constexpr int PAD = g_pad(R2, LO, N);
  static constexpr int NL = g_levels(PAD);
  static constexpr int SW = g_sw(R2, LO, N);
  static constexpr int S = STAGE_ROWS;
  static constexpr int RAWB = g_raw_bytes(R2, LO, N);
  static constexpr int MB = g_mask_bytes(R2, LO, N);
  // where the raw rows, the mask rows and the output rows start
  static constexpr int RAW_AT = 8 * NL * S * SW;
  static constexpr int MASK_AT = RAW_AT + 2 * S * RAWB;
  static constexpr int OUT_AT = MASK_AT + 2 * S * MB;
  static_assert(N <= RING_ROWS, "a group's rows");
  __host__ __device__ static constexpr int ext(int dy) {
    return foot_ext(R2, dy);
  }
  __host__ __device__ static constexpr int uses(int e) {
    return g_uses(R2, LO, N, e);
  }
  // the extents used by more than one row: their windows are taken once
  // per input row, the others folded straight from the levels
  __host__ __device__ static constexpr int shared_id(int e) {
    int c = 0;
    for (int v = 0; v < e; ++v) c += uses(v) > 1;
    return c;
  }
  static constexpr int NSH = shared_id(PAD + 1);
  // the i-th of them
  __host__ __device__ static constexpr int shared_ext(int i) {
    for (int v = 0, c = 0; v <= PAD; ++v) {
      if (uses(v) > 1) {
        if (c == i) return v;
        ++c;
      }
    }
    return 0;
  }
};

template <int V>
struct IntC {
  static constexpr int value = V;
};

// fn(IntC<I>) for I = B .. E - 1, unrolled by the compiler
template <int B, int E, class Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (B < E) {
    fn(IntC<B>{});
    static_for<B + 1, E>(fn);
  }
}

__device__ __forceinline__ uint2 max2(uint2 a, uint2 b) {
  return make_uint2(__vmaxu2(a.x, b.x), __vmaxu2(a.y, b.y));
}
__device__ __forceinline__ uint2 max3(uint2 a, uint2 b, uint2 c) {
  return make_uint2(__vimax3_u16x2(a.x, b.x, c.x),
                    __vimax3_u16x2(a.y, b.y, c.y));
}

// The max of the window row[-e .. e] from the levels of a staged row
// (row: level 0 at the output column; level j at + j * stride), with acc
// folded in: reads of level min(lvl_of(e), nl - 1) that cover the window,
// the last one ending at its right edge.
template <int E, int NL, int STRIDE>
__device__ __forceinline__ uint2 window_max(uint2 acc, const uint2* row) {
  constexpr int j = lvl_of(E) < NL - 1 ? lvl_of(E) : NL - 1;
  constexpr int u = 1 << j, n = (2 * E + 1 + u - 1) / u;
  const uint2* p = row + j * STRIDE - E;
  static_assert(n == 2 || n == 3, "two or three reads of a level");
  if constexpr (n == 2) {
    return max3(acc, p[0], p[2 * E + 1 - u]);
  } else {
    return max2(max3(acc, p[0], p[u]), p[2 * E + 1 - u]);
  }
}

struct RingArgs {
  const unsigned char* x;         // u8 [T, H, W, 3], 16-byte aligned
  const unsigned char* excluded;  // bool [H, W] or null
  int has_thr, thr;
  int h, w;
  int rh;                   // output rows of a block
  unsigned char* out;       // u8 [T, H, W, 3] (a footprint of one group)
  unsigned* part;           // [G][stride] RGB words (several groups)
  long long stride;         // words of a partial, a multiple of 4
};

// Where a block of ring_kernel works: a frame, the strip of RING_BW
// columns from x0 and the output rows y0 .. y1 - 1; the staged span of a
// row starts at pixel gx_lo and holds nb bytes.
struct RingBlock {
  int x0, y0, y1, gx_lo, nb, ncol;
  long long frame;  // rows before the frame
};

__device__ __forceinline__ uintptr_t row_src(const RingArgs& a,
                                             const RingBlock& b, int gy) {
  return reinterpret_cast<uintptr_t>(a.x) +
         static_cast<uintptr_t>(((b.frame + gy) * a.w + b.gx_lo) * 3);
}

// The output rows completed by input rows yc .. yc + S - 1, from the row
// buffer to the frame as 4-byte words (bytes at the strip's edges), a
// thread per word.
template <class Gp>
__device__ __noinline__ void ring_flush(const RingArgs a, const RingBlock b,
                                        int yc, const unsigned char* obuf) {
  constexpr int S = Gp::S;
  constexpr int HI = Gp::LO_ROW + Gp::N_ROWS - 1;
  static_assert((OUT_ROW_BYTES + 3) / 4 <= RING_BW, "a thread per word");
  const int j = threadIdx.x;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int yo = yc + s - HI;
    if (yo < b.y0 || yo >= b.y1) continue;
    const uintptr_t dst = reinterpret_cast<uintptr_t>(a.out) +
        static_cast<uintptr_t>(((b.frame + yo) * a.w + b.x0) * 3);
    const int v_lo = static_cast<int>(dst & 3), v_hi = v_lo + 3 * b.ncol;
    const int lo_b = 4 * j, hi_b = lo_b + 4;  // buffer bytes of word j
    if (lo_b >= v_hi) continue;
    const unsigned char* src = obuf + s * OUT_ROW_BYTES;
    const uintptr_t wa = (dst & ~uintptr_t(3)) + lo_b;
    if (lo_b >= v_lo && hi_b <= v_hi) {
      *reinterpret_cast<unsigned*>(wa) =
          *reinterpret_cast<const unsigned*>(src + lo_b);
    } else {
      for (int k = max(lo_b, v_lo); k < min(hi_b, v_hi); ++k)
        *reinterpret_cast<unsigned char*>(wa + (k - lo_b)) = src[k];
    }
  }
}

// Start the copy of input rows yc .. yc + S - 1 into raw and mask buffer
// buf: the 16-byte chunks that hold each row's span of pixels and of the
// excluded mask, with cp.async, so that they land while the chunk before
// is folded (a thread per chunk). Rows outside the frame copy nothing.
template <class Gp>
__device__ __noinline__ void ring_issue(const RingArgs a, const RingBlock b,
                                        int yc, int buf,
                                        unsigned char* smem) {
  constexpr int S = Gp::S, RAWB = Gp::RAWB, MB = Gp::MB;
  static_assert(RAWB / 16 <= RING_BW, "a thread per chunk");
  unsigned char* raw = smem + Gp::RAW_AT + buf * S * RAWB;
  unsigned char* msk = smem + Gp::MASK_AT + buf * S * MB;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int gy = yc + s;
    if (gy < 0 || gy >= a.h) continue;
    const uintptr_t src = row_src(a, b, gy);
    const uintptr_t al = src & ~uintptr_t(15);
    if (16 * tid < static_cast<int>(src - al) + b.nb)
      cms::cp_async<16>(raw + s * RAWB + 16 * tid,
                        reinterpret_cast<const void*>(al + 16 * tid));
    if (a.excluded) {
      const uintptr_t ms = reinterpret_cast<uintptr_t>(a.excluded) +
                           static_cast<uintptr_t>(gy) * a.w + b.gx_lo;
      const uintptr_t mal = ms & ~uintptr_t(15);
      if (16 * tid < static_cast<int>(ms - mal) + b.nb / 3)
        cms::cp_async<16>(msk + s * MB + 16 * tid,
                          reinterpret_cast<const void*>(mal + 16 * tid));
    }
  }
  cms::cp_async_commit();
}

// Stage input rows yc .. yc + S - 1 (buffer buf, copied by ring_issue):
// level 0 (the RGB words, the clearing and masking applied, 0 outside the
// frame), then the doubling levels. Not inlined: the ring's period calls
// it N / S times.
template <class Gp, bool PART>
__device__ __noinline__ void ring_stage(const RingArgs a, const RingBlock b,
                                        int yc, int buf,
                                        unsigned char* smem) {
  constexpr int S = Gp::S, SW = Gp::SW, PAD = Gp::PAD, NL = Gp::NL;
  uint2* lv = reinterpret_cast<uint2*>(smem);
  const unsigned char* raw = smem + Gp::RAW_AT + buf * S * Gp::RAWB;
  const unsigned char* msk = smem + Gp::MASK_AT + buf * S * Gp::MB;
  const int tid = threadIdx.x;
  // the staged columns inside the frame: c_lo .. c_hi - 1
  const int c_lo = b.gx_lo - (b.x0 - PAD), c_hi = c_lo + b.nb / 3;
  cms::cp_async_wait<0>();
  __syncthreads();
  if constexpr (!PART) {
    const int ys = b.y0 + Gp::LO_ROW;
    if (yc != ys) ring_flush<Gp>(a, b, yc - S, smem + Gp::OUT_AT);
  }
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int gy = yc + s;
    uint2* l0 = lv + s * SW;
    if (gy < 0 || gy >= a.h) {
      for (int c = tid; c < SW; c += RING_BW) l0[c] = make_uint2(0u, 0u);
      continue;
    }
    // pixel c of the row at rr + 3 c, its mask byte at mr + c
    const unsigned char* rr =
        raw + s * Gp::RAWB + (row_src(a, b, gy) & 15) - 3 * c_lo;
    const unsigned char* mr =
        msk + s * Gp::MB +
        ((reinterpret_cast<uintptr_t>(a.excluded) +
          static_cast<uintptr_t>(gy) * a.w + b.gx_lo) & 15) - c_lo;
    for (int c = tid; c < SW; c += RING_BW) {
      uint2 v = make_uint2(0u, 0u);
      if (c >= c_lo && c < c_hi) {
        const unsigned char* px = rr + 3 * c;
        const int r = px[0], g = px[1], bl = px[2];
        bool keep = !a.excluded || !mr[c];
        if (a.has_thr) keep = keep && max(r, max(g, bl)) > a.thr;
        if (keep) v = make_uint2(r | g << 16, bl);
      }
      l0[c] = v;
    }
  }
  __syncthreads();
  // the doubling levels, three at a time from a base level j0 (one
  // barrier per three): level j0 + k at c is the max of level j0 at c,
  // c + u, .., c + (2^k - 1) u, u = 2^j0
#pragma unroll
  for (int j0 = 0; j0 + 1 < NL; j0 += 3) {
    const int u = 1 << j0;
    const uint2* base = lv + j0 * S * SW;
#pragma unroll 1
    for (int i = tid; i < S * SW; i += RING_BW) {
      const int c = i % SW;
      const uint2* p = base + i;
      if (c >= SW - 2 * u + 1) continue;
      uint2 m = max2(p[0], p[u]);
      lv[(j0 + 1) * S * SW + i] = m;
      if (j0 + 2 >= NL || c >= SW - 4 * u + 1) continue;
      m = max3(m, p[2 * u], p[3 * u]);
      lv[(j0 + 2) * S * SW + i] = m;
      if (j0 + 3 >= NL || c >= SW - 8 * u + 1) continue;
      m = max3(max3(m, p[4 * u], p[5 * u]), p[6 * u], p[7 * u]);
      lv[(j0 + 3) * S * SW + i] = m;
    }
    __syncthreads();
  }
}

// One block: group Gp of the footprint over frame t, the strip of RING_BW
// columns from blockIdx.x * RING_BW and the output rows from blockIdx.y *
// rh. Shared memory: g_smem's layout (Group's *_AT offsets).
template <class Gp, bool PART>
__device__ __forceinline__ void ring_run(const RingArgs& a, int g, int t,
                                         unsigned char* smem) {
  constexpr int N = Gp::N_ROWS, S = Gp::S, SW = Gp::SW, PAD = Gp::PAD;
  constexpr int NL = Gp::NL, LO = Gp::LO_ROW, HI = LO + N - 1;
  const uint2* lv = reinterpret_cast<const uint2*>(smem);
  unsigned char* obuf = smem + Gp::OUT_AT;
  const int tid = threadIdx.x;
  RingBlock b;
  b.x0 = blockIdx.x * RING_BW;
  b.y0 = blockIdx.y * a.rh;
  if (b.y0 >= a.h) return;  // the whole block
  b.y1 = min(b.y0 + a.rh, a.h);
  b.gx_lo = max(b.x0 - PAD, 0);
  b.nb = 3 * (min(b.x0 + RING_BW + PAD, a.w) - b.gx_lo);
  b.ncol = min(RING_BW, a.w - b.x0);
  b.frame = static_cast<long long>(t) * a.h;
  const int gx = b.x0 + tid;

  // acc[k] holds output row yi - HI + k while input row yi is folded in;
  // acc[0] is then complete, and the ring shifts down by one row
  uint2 acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = make_uint2(0u, 0u);
  const int ys = b.y0 + LO;      // the first input row
  const int ye = b.y1 - 1 + HI;  // the last
  int yc = ys, buf = 0;
  ring_issue<Gp>(a, b, ys, 0, smem);
  for (; yc <= ye; yc += S, buf ^= 1) {
    // ring_stage's first barrier: the chunk's copies have landed, and the
    // last chunk's levels and output rows have been read and written
    ring_stage<Gp, PART>(a, b, yc, buf, smem);
    if (yc + S <= ye) ring_issue<Gp>(a, b, yc + S, buf ^ 1, smem);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint2* row = lv + s * SW + tid + PAD;  // at column gx
      // the windows of the extents that several rows use
      uint2 hw[Gp::NSH > 0 ? Gp::NSH : 1];
      static_for<0, Gp::NSH>([&](auto I) {
        constexpr int e = Gp::shared_ext(decltype(I)::value);
        hw[decltype(I)::value] =
            window_max<e, NL, S * SW>(make_uint2(0u, 0u), row);
      });
      static_for<0, N>([&](auto D) {
        constexpr int dy = LO + decltype(D)::value;
        constexpr int e = Gp::ext(dy);
        constexpr int k = HI - dy;
        if constexpr (Gp::uses(e) > 1) {
          constexpr int id = Gp::shared_id(e);
          acc[k] = max2(acc[k], hw[id]);
        } else {
          acc[k] = window_max<e, NL, S * SW>(acc[k], row);
        }
      });
      const int yo = yc + s - HI;
      // RGB word: R, G (bytes 0 and 2 of acc[0].x), B (byte 0 of .y)
      const unsigned rgb = __byte_perm(acc[0].x, acc[0].y, 0x1420);
      if constexpr (PART) {
        if (yo >= b.y0 && yo < b.y1 && gx < a.w)
          a.part[g * a.stride + (b.frame + yo) * a.w + gx] = rgb;
      } else if (tid < b.ncol) {
        const uintptr_t dst = reinterpret_cast<uintptr_t>(a.out) +
            static_cast<uintptr_t>(((b.frame + yo) * a.w + b.x0) * 3);
        unsigned char* o = obuf + s * OUT_ROW_BYTES + (dst & 3) + 3 * tid;
        o[0] = rgb & 0xff;
        o[1] = (rgb >> 8) & 0xff;
        o[2] = (rgb >> 16) & 0xff;
      }
#pragma unroll
      for (int i = 0; i + 1 < N; ++i) acc[i] = acc[i + 1];
      acc[N - 1] = make_uint2(0u, 0u);
    }
  }
  if constexpr (!PART) {
    __syncthreads();
    ring_flush<Gp>(a, b, yc - S, obuf);
  }
}

// Grid (column strips, row chunks, frames x groups); one group per block.
template <int R2, bool PART>
__global__ void __launch_bounds__(RING_BW) ring_kernel(const RingArgs a) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  using F = Foot<R2>;
  const int g = blockIdx.z % F::G, t = blockIdx.z / F::G;
  static_for<0, F::G>([&](auto I) {
    constexpr int gi = decltype(I)::value;
    if (g == gi)
      ring_run<Group<R2, F::lo(gi), F::n(gi)>, PART>(a, gi, t, ring_smem);
  });
}

// out[p] = the maximum of the G partials' RGB words at pixel p, as 3 bytes;
// a thread takes 4 pixels (12 bytes, 3 words). Grid (quads of pixels).
template <int G>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const unsigned* __restrict__ part, long long stride,
                   long long n_px, unsigned char* __restrict__ out) {
  const long long p0 =
      4 * (static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x);
  if (p0 >= n_px) return;
  if (p0 + 4 <= n_px) {
    uint4 m = __ldg(reinterpret_cast<const uint4*>(part + p0));
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(part + g * stride + p0));
      m = make_uint4(__vmaxu4(m.x, v.x), __vmaxu4(m.y, v.y),
                     __vmaxu4(m.z, v.z), __vmaxu4(m.w, v.w));
    }
    unsigned* o = reinterpret_cast<unsigned*>(out + 3 * p0);
    o[0] = __byte_perm(m.x, m.y, 0x4210);
    o[1] = __byte_perm(m.y, m.z, 0x5421);
    o[2] = __byte_perm(m.z, m.w, 0x6542);
    return;
  }
  for (long long p = p0; p < n_px; ++p) {
    unsigned v = part[p];
#pragma unroll
    for (int g = 1; g < G; ++g) v = __vmaxu4(v, part[g * stride + p]);
    out[3 * p] = v & 0xff;
    out[3 * p + 1] = (v >> 8) & 0xff;
    out[3 * p + 2] = (v >> 16) & 0xff;
  }
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

namespace {

// R2 of the compiled footprint whose extents are ext (n_rows of them), or
// 0 for the generic kernel
int compiled_r2(int n_rows, const int* ext) {
  auto is = [&](const int* table, int n) {
    if (n != n_rows) return false;
    for (int i = 0; i < n; ++i)
      if (ext[i] != table[i]) return false;
    return true;
  };
  if (is(EXT_R10, 21)) return 101;
  if (is(EXT_R20, 41)) return 401;
  if (is(EXT_R60, 121)) return 3601;
  return 0;
}

int groups_of(int r2) {
  return r2 == 101 ? Foot<101>::G : r2 == 401 ? Foot<401>::G
                                              : Foot<3601>::G;
}

long long partial_stride(int n_t, int h, int w) {
  return (static_cast<long long>(n_t) * h * w + 3) / 4 * 4;
}

template <int R2>
cudaError_t launch_ring(RingArgs a, int n_t, cudaStream_t s) {
  using F = Foot<R2>;
  constexpr bool part = F::G > 1;
  const int smem = F::smem(part);
  cudaError_t err = cudaFuncSetAttribute(
      ring_kernel<R2, part>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_kernel<R2, part>, RING_BW, smem);
  if (err != cudaSuccess) return err;
  // row chunks: a block walks its rows down the frame; cut the frames into
  // chunks of rows until the blocks fill every resident slot twice (the
  // query's single frame), not further (the halo grows)
  const long long slots = static_cast<long long>(std::max(per_sm, 1)) * sms;
  const long long strips = (a.w + RING_BW - 1) / RING_BW;
  const long long others = strips * n_t * F::G;
  const long long chunks = std::max(
      1LL, std::min<long long>(a.h, (2 * slots + others - 1) / others));
  a.rh = static_cast<int>((a.h + chunks - 1) / chunks);
  const dim3 grid(static_cast<unsigned>(strips),
                  static_cast<unsigned>((a.h + a.rh - 1) / a.rh),
                  static_cast<unsigned>(n_t * F::G));
  ring_kernel<R2, part><<<grid, RING_BW, smem, s>>>(a);
  if constexpr (part) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n_px = static_cast<long long>(n_t) * a.h * a.w;
    const long long quads = (n_px + 3) / 4;
    combine_kernel<F::G><<<static_cast<unsigned>(
        (quads + COMBINE_THREADS - 1) / COMBINE_THREADS), COMBINE_THREADS, 0,
        s>>>(a.part, a.stride, n_px, a.out);
  }
  return cudaGetLastError();
}

}  // namespace

// The scratch G2 needs for a footprint of n_rows rows with extents ext
// over n_t frames of h x w: 32-bit words of the partials of a compiled
// footprint of several groups; 0 for one group; -1 for the generic kernel.
extern "C" long long cms_dilate_plan(int n_rows, const int* ext, int n_t,
                                     int h, int w) {
  const int r2 = compiled_r2(n_rows, ext);
  if (r2 == 0) return -1;
  const int g = groups_of(r2);
  return g > 1 ? g * partial_stride(n_t, h, w) : 0;
}

// x, out: u8 [n_t, h, w, 3], x 16-byte aligned; excluded: bool [h, w] or
// null; with has_thr, input pixels with no channel above thr count as 0;
// ext: the 2k + 1 footprint rows' extents (imageproc.filters.
// make_line_radii); scratch: cms_dilate_plan's words (null when it is 0
// or -1). A compiled footprint runs ring_kernel (and combine_kernel), any
// other dilate_kernel.
extern "C" int cms_dilate_rgb(const void* x, const void* excluded,
                              int has_thr, int thr, int n_t, int h, int w,
                              int n_rows, const int* ext, void* out,
                              void* scratch, void* stream, int device) {
  if (n_t <= 0 || h <= 0 || w <= 0) return 0;
  if (n_rows < 1 || n_rows > MAX_ROWS || n_rows % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r2 = compiled_r2(n_rows, ext);
  if (r2 != 0) {
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        (groups_of(r2) > 1 &&
         (!scratch || reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(out) % 4 != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    RingArgs a{static_cast<const unsigned char*>(x),
               static_cast<const unsigned char*>(excluded), has_thr, thr, h,
               w, h, static_cast<unsigned char*>(out),
               static_cast<unsigned*>(scratch), partial_stride(n_t, h, w)};
    return cms::on_device(device, [&] {
      return r2 == 101 ? launch_ring<101>(a, n_t, s)
             : r2 == 401 ? launch_ring<401>(a, n_t, s)
                         : launch_ring<3601>(a, n_t, s);
    });
  }
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
