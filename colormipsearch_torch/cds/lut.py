"""Depth-slice LUT: RGB -> slice number (1..255).

Copy of `colormipsearch_tpu/cds/lut.py`. Re-derivation of
GradientAreaGapUtils.findSliceNumber/findSliceNumberInLUT
(cds/GradientAreaGapUtils.java:107-197). The reference scans a hard-coded
256-entry RGB LUT per pixel pair; since the scan result depends only on
(channel-order class, max value, second-max value), we precompute a
6 x 256 x 256 table once (host, float64 — bit-identical to the Java
doubles) and turn the per-pixel work into a single table lookup. Per-image
"slice planes" are then computed once per image, which makes the shape
scorer's hot loop pure integer elementwise work.

Channel-order classes (maxColor, secondMaxColor) -> LUT scan subranges
(GradientAreaGapUtils.java:107-129):
  (R,G)->[171,212] (R,B)->[213,255] (G,R)->[128,170]
  (G,B)->[86,127]  (B,R)->[0,29]    (B,G)->[30,85]
"""

from __future__ import annotations

import functools

import numpy as np

# The 256-entry RGB LUT (GradientAreaGapUtils.java:132-155). This is pure
# numeric data (a physical depth colormap), restated row-for-row.
_LUT_FLAT = [
    127, 0, 255, 125, 3, 255, 124, 6, 255, 122, 9, 255, 121, 12, 255, 120, 15, 255,
    119, 18, 255, 118, 21, 255, 116, 24, 255, 115, 27, 255, 114, 30, 255, 113, 33, 255,
    112, 36, 255, 110, 39, 255, 109, 42, 255, 108, 45, 255, 106, 48, 255, 105, 51, 255,
    104, 54, 255, 103, 57, 255, 101, 60, 255, 100, 63, 255, 99, 66, 255, 98, 69, 255,
    96, 72, 255, 95, 75, 255, 94, 78, 255, 93, 81, 255, 92, 84, 255, 90, 87, 255,
    89, 90, 255, 87, 93, 255, 86, 96, 255, 84, 99, 255, 83, 102, 255, 81, 105, 255,
    80, 108, 255, 78, 111, 255, 77, 114, 255, 75, 117, 255, 74, 120, 255, 72, 123, 255,
    71, 126, 255, 69, 129, 255, 68, 132, 255, 66, 135, 255, 65, 138, 255, 63, 141, 255,
    62, 144, 255, 60, 147, 255, 59, 150, 255, 57, 153, 255, 56, 156, 255, 54, 159, 255,
    53, 162, 255, 51, 165, 255, 50, 168, 255, 48, 171, 255, 47, 174, 255, 45, 177, 255,
    44, 180, 255, 42, 183, 255, 41, 186, 255, 39, 189, 255, 38, 192, 255, 36, 195, 255,
    35, 198, 255, 33, 201, 255, 32, 204, 255, 30, 207, 255, 29, 210, 255, 27, 213, 255,
    26, 216, 255, 24, 219, 255, 23, 222, 255, 21, 225, 255, 20, 228, 255, 18, 231, 255,
    16, 234, 255, 14, 237, 255, 12, 240, 255, 9, 243, 255, 6, 246, 255, 3, 249, 255,
    1, 252, 255, 0, 254, 255, 3, 255, 252, 6, 255, 249, 9, 255, 246, 12, 255, 243,
    15, 255, 240, 18, 255, 237, 21, 255, 234, 24, 255, 231, 27, 255, 228, 30, 255, 225,
    33, 255, 222, 36, 255, 219, 39, 255, 216, 42, 255, 213, 45, 255, 210, 48, 255, 207,
    51, 255, 204, 54, 255, 201, 57, 255, 198, 60, 255, 195, 63, 255, 192, 66, 255, 189,
    69, 255, 186, 72, 255, 183, 75, 255, 180, 78, 255, 177, 81, 255, 174, 84, 255, 171,
    87, 255, 168, 90, 255, 165, 93, 255, 162, 96, 255, 159, 99, 255, 156, 102, 255, 153,
    105, 255, 150, 108, 255, 147, 111, 255, 144, 114, 255, 141, 117, 255, 138, 120, 255, 135,
    123, 255, 132, 126, 255, 129, 129, 255, 126, 132, 255, 123, 135, 255, 120,
    138, 255, 117, 141, 255, 114, 144, 255, 111, 147, 255, 108, 150, 255, 105,
    153, 255, 102, 156, 255, 99, 159, 255, 96, 162, 255, 93, 165, 255, 90, 168, 255, 87,
    171, 255, 84, 174, 255, 81, 177, 255, 78, 180, 255, 75, 183, 255, 72, 186, 255, 69,
    189, 255, 66, 192, 255, 63, 195, 255, 60, 198, 255, 57, 201, 255, 54, 204, 255, 51,
    207, 255, 48, 210, 255, 45, 213, 255, 42, 216, 255, 39, 219, 255, 36, 222, 255, 33,
    225, 255, 30, 228, 255, 27, 231, 255, 24, 234, 255, 21, 237, 255, 18, 240, 255, 15,
    243, 255, 12, 246, 255, 9, 249, 255, 6, 252, 255, 3, 254, 255, 0, 255, 252, 3,
    255, 249, 6, 255, 246, 9, 255, 243, 12, 255, 240, 15, 255, 237, 18, 255, 234, 21,
    255, 231, 24, 255, 228, 27, 255, 225, 30, 255, 222, 33, 255, 219, 36, 255, 216, 39,
    255, 213, 42, 255, 210, 45, 255, 207, 48, 255, 204, 51, 255, 201, 54, 255, 198, 57,
    255, 195, 60, 255, 192, 63, 255, 189, 66, 255, 186, 69, 255, 183, 72, 255, 180, 75,
    255, 177, 78, 255, 174, 81, 255, 171, 84, 255, 168, 87, 255, 165, 90, 255, 162, 93,
    255, 159, 96, 255, 156, 99, 255, 153, 102, 255, 150, 105, 255, 147, 108,
    255, 144, 111, 255, 141, 114, 255, 138, 117, 255, 135, 120, 255, 132, 123,
    255, 129, 126, 255, 126, 129, 255, 123, 132, 255, 120, 135, 255, 117, 138,
    255, 114, 141, 255, 111, 144, 255, 108, 147, 255, 105, 150, 255, 102, 153,
    255, 99, 156, 255, 96, 159, 255, 93, 162, 255, 90, 165, 255, 87, 168,
    255, 84, 171, 255, 81, 173, 255, 78, 174, 255, 75, 175, 255, 72, 176,
    255, 69, 177, 255, 66, 178, 255, 63, 179, 255, 60, 180, 255, 57, 181,
    255, 54, 182, 255, 51, 183, 255, 48, 184, 255, 45, 185, 255, 42, 186,
    255, 39, 187, 255, 36, 188, 255, 33, 189, 255, 30, 190, 255, 27, 191,
    255, 24, 192, 255, 21, 193, 255, 18, 194, 255, 15, 195, 255, 12, 196,
    255, 9, 197, 255, 6, 198, 255, 3, 199, 255, 0, 200,
]

LUT_RGB = np.array(_LUT_FLAT, dtype=np.float64).reshape(256, 3)
assert LUT_RGB.shape == (256, 3)

# order ids: 0:(R,G) 1:(R,B) 2:(G,R) 3:(G,B) 4:(B,R) 5:(B,G)
ORDER_RANGES = {
    0: (171, 212), 1: (213, 255),
    2: (128, 170), 3: (86, 127),
    4: (0, 29), 5: (30, 85),
}


def _lut_row_ratios() -> np.ndarray:
    """Per-LUT-row ratio using the scan's own strict-comparison
    classification (ties -> ratio 0.0; GradientAreaGapUtils.java:159-183)."""
    r, g, b = LUT_RGB[:, 0], LUT_RGB[:, 1], LUT_RGB[:, 2]
    ratio = np.zeros(256, dtype=np.float64)
    b_max = (b > r) & (b > g)
    g_max = (g > r) & (g > b)
    r_max = (r > g) & (r > b)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(b_max & (r > g), r / b, ratio)
        ratio = np.where(b_max & (g > r), g / b, ratio)
        ratio = np.where(g_max & (r > b), r / g, ratio)
        ratio = np.where(g_max & (b > r), b / g, ratio)
        ratio = np.where(r_max & (g > b), g / r, ratio)
        ratio = np.where(r_max & (b > g), b / r, ratio)
    return ratio


@functools.lru_cache(maxsize=1)
def slice_number_table() -> np.ndarray:
    """int16 [6, 256, 256] table: [order, max_val, second_val] -> slice.

    Entry = findSliceNumber(order, second/max); max==0 rows are 0 (the
    NaN-ratio path of the reference returns slice 0).
    """
    lut_ratio = _lut_row_ratios()
    table = np.zeros((6, 256, 256), dtype=np.int16)
    maxv = np.arange(256, dtype=np.float64)[:, None]
    secv = np.arange(256, dtype=np.float64)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = secv / maxv  # [256, 256]; row 0 -> nan/inf
    for order, (start, end) in ORDER_RANGES.items():
        seg = lut_ratio[start:end + 1]  # [n]
        gaps = np.abs(ratio[:, :, None] - seg[None, None, :])
        # strict < scan keeps the FIRST minimum; np.argmin matches
        idx = np.argmin(np.where(np.isnan(gaps), np.inf, gaps), axis=2)
        slices = (start + idx + 1).astype(np.int16)
        slices[0, :] = 0  # max==0 -> NaN ratio -> slice 0
        table[order] = slices
    return table


def slice_plane(rgb: np.ndarray) -> np.ndarray:
    """Per-pixel slice numbers for an RGB [H, W, 3] array.

    Classification uses >= comparisons in the reference's branch order
    (GradientAreaGapUtils.java:31-93): R-max checked first, then G, then B.
    """
    r = rgb[:, :, 0].astype(np.int32)
    g = rgb[:, :, 1].astype(np.int32)
    b = rgb[:, :, 2].astype(np.int32)

    r_branch = (r >= g) & (r >= b)
    g_branch = ~r_branch & (g >= r) & (g >= b)
    b_branch = ~r_branch & ~g_branch

    order = np.zeros(r.shape, dtype=np.int8)
    maxv = np.zeros(r.shape, dtype=np.int32)
    secv = np.zeros(r.shape, dtype=np.int32)

    # R max: second = G if g >= b else B
    rg = r_branch & (g >= b)
    rb = r_branch & ~(g >= b)
    # G max: second = R if r >= b else B
    gr = g_branch & (r >= b)
    gb = g_branch & ~(r >= b)
    # B max: second = R if r >= g else G
    br = b_branch & (r >= g)
    bg = b_branch & ~(r >= g)

    for oid, sel, m, s in ((0, rg, r, g), (1, rb, r, b), (2, gr, g, r),
                           (3, gb, g, b), (4, br, b, r), (5, bg, b, g)):
        order = np.where(sel, oid, order)
        maxv = np.where(sel, m, maxv)
        secv = np.where(sel, s, secv)

    table = slice_number_table()
    return table[order, maxv, secv].astype(np.int32)


def slice_gap(mask_slice: np.ndarray, data_slice: np.ndarray) -> np.ndarray:
    """calculateSliceGap on slice planes (GradientAreaGapUtils.java:100-104):
    if either slice is 0 -> dataslice (so 0 when data is 0), else |m - d|."""
    gap = np.abs(mask_slice - data_slice)
    gap = np.where(mask_slice == 0, data_slice, gap)
    gap = np.where(data_slice == 0, 0, gap)
    return gap
