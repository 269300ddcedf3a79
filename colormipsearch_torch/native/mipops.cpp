// mipops — native host-side packing of scorer words for
// colormipsearch_torch.
//
// Copy of the entry point of colormipsearch_tpu/native/mipops.cpp that
// the colorDepthSearch path calls: the packed scorer-plane construction
// (the int32 word layout of cds/pixel_kernel.py) straight from
// interleaved RGB u8, for a query. The max filter, PackBits decode and
// gray conversion of that file serve other commands.
//
// Exposed with a plain C ABI for ctypes; OpenMP parallel across pixels.

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

}  // extern "C"
