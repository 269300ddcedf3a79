// mipops — native host-side packing of scorer words for
// colormipsearch_torch.
//
// Copy of the two entry points of colormipsearch_tpu/native/mipops.cpp
// that the colorDepthSearch path calls: the packed scorer-plane
// construction (the int32 word layout of cds/pixel_kernel.py) straight
// from interleaved RGB u8, dense for a query and sparse (above-threshold
// pixels only) for a target block. The max filter, PackBits decode and
// gray conversion of that file serve other commands.
//
// Exposed with a plain C ABI for ctypes; OpenMP parallel across pixels /
// images.

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------- packed scorer planes (cds/pixel_kernel.py word layout) ---------

// word: b | a<<8 | sector<<16 | sel<<19 | cl<<20 | cu<<21
void pack_planes_rgb(const uint8_t* rgb, int32_t* out, int64_t n_px,
                     int threshold, const uint8_t* excluded /* nullable */) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_px; i++) {
        int r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
        int sel = (r > threshold || g > threshold || b > threshold) ? 1 : 0;
        if (excluded && excluded[i]) sel = 0;
        int sector = 0, first = 0, second = 0;
        if (b > r && b > g) {
            if (r > g) { sector = 1; first = b; second = r; }
            else { sector = 2; first = b; second = g; }
        } else if (g > b && g > r) {
            if (b > r) { sector = 3; first = g; second = b; }
            else { sector = 4; first = g; second = r; }
        } else if (r > b && r > g) {
            if (g > b) { sector = 5; first = r; second = g; }
            else { sector = 6; first = r; second = b; }
        }
        int a = (first != 0 && second != 0) ? second : 0;
        int bden = first > 1 ? first : 1;
        bool lt044 = a * 25 < 11 * bden;
        bool lt054 = a * 50 < 27 * bden;
        bool lt07 = a * 10 < 7 * bden;
        bool gt08 = a * 5 > 4 * bden;
        int cl = (sector == 2 && lt054) || (sector == 3 && gt08) ||
                 (sector == 4 && lt07) || (sector == 5 && gt08) ||
                 (sector == 6 && lt07);
        int cu = (sector == 1 && lt044) || (sector == 2 && gt08) ||
                 (sector == 3 && lt07) || (sector == 4 && gt08) ||
                 (sector == 5 && lt07);
        out[i] = bden | (a << 8) | (sector << 16) | (sel << 19) |
                 (cl << 20) | (cu << 21);
    }
}

// ---------- sparse packed scorer planes (host->device feed) ----------------

// Emit (flat index, word) pairs for ABOVE-THRESHOLD pixels only (sel=1);
// sub-threshold pixels canonicalize to word 1 (the empty-pixel word:
// bden clamps to 1) on the device-side scatter fill. Score-invariant:
// the match predicate gates on sel, the prescreen bins gate on sel, and
// the kernel's window skip reads only bit 19.
// rgb: [t, px_per_t, 3]; idx_buf/word_buf: [t * px_per_t] caller scratch;
// counts: [t] per-target pair counts (pairs are contiguous per target
// at offsets ti * px_per_t, ordered by flat index).
void sparse_pack_block(const uint8_t* rgb, int64_t t, int64_t px_per_t,
                       int threshold, int32_t* idx_buf, int32_t* word_buf,
                       int64_t* counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ti = 0; ti < t; ti++) {
        const uint8_t* p = rgb + ti * px_per_t * 3;
        int32_t* ib = idx_buf + ti * px_per_t;
        int32_t* wb = word_buf + ti * px_per_t;
        int64_t n = 0;
        for (int64_t i = 0; i < px_per_t; i++) {
            int r = p[i * 3], g = p[i * 3 + 1], b = p[i * 3 + 2];
            if (r <= threshold && g <= threshold && b <= threshold) continue;
            int sector = 0, first = 0, second = 0;
            if (b > r && b > g) {
                if (r > g) { sector = 1; first = b; second = r; }
                else { sector = 2; first = b; second = g; }
            } else if (g > b && g > r) {
                if (b > r) { sector = 3; first = g; second = b; }
                else { sector = 4; first = g; second = r; }
            } else if (r > b && r > g) {
                if (g > b) { sector = 5; first = r; second = g; }
                else { sector = 6; first = r; second = b; }
            }
            int a = (first != 0 && second != 0) ? second : 0;
            int bden = first > 1 ? first : 1;
            bool lt044 = a * 25 < 11 * bden;
            bool lt054 = a * 50 < 27 * bden;
            bool lt07 = a * 10 < 7 * bden;
            bool gt08 = a * 5 > 4 * bden;
            int cl = (sector == 2 && lt054) || (sector == 3 && gt08) ||
                     (sector == 4 && lt07) || (sector == 5 && gt08) ||
                     (sector == 6 && lt07);
            int cu = (sector == 1 && lt044) || (sector == 2 && gt08) ||
                     (sector == 3 && lt07) || (sector == 4 && gt08) ||
                     (sector == 5 && lt07);
            ib[n] = (int32_t)(ti * px_per_t + i);
            wb[n] = bden | (a << 8) | (sector << 16) | (1 << 19) |
                    (cl << 20) | (cu << 21);
            n++;
        }
        counts[ti] = n;
    }
}

}  // extern "C"
