"""The plain reference of the gradient (shape) score (gradientScores).

Plain PyTorch and NumPy, on whatever device the caller's tensors live. A
restatement of Shape2DMatchColorDepthSearchAlgorithm (cds/Shape2DMatch
ColorDepthSearchAlgorithm.java:23-247), the query-side masks of
ColorDepthSearchAlgorithmProviderFactory.java:96-121, the depth-slice
lookup of GradientAreaGapUtils.java:100-197 and the normalized score of
GradientAreaGapUtils.java:199-235 and CalculateGradientScoresCmd.java:
616-645. It imports nothing of the program: it decodes the benchmark's
own PNGs (the mask's CDM, each target's CDM, gradient and z-gap files)
and derives every plane itself.

The mirrored orientation flips the gradient plane (for the gap sum) and
the target's signal plane (for the high-expression sum) and keeps every
other plane, which equals the reference's mirroring of the query-side
images and the z-gap mask, summed over the frame.

`precision` ("float32", "float16"; the default "exact" is float64, Java's
doubles) sets the float type of the gray conversions, the slice table's
ratios and the normalized score: the controls.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .pixel import label_regions

GAP_THRESHOLD = 3          # Shape2DMatchColorDepthSearchAlgorithm.java:26
LOW_NORMALIZED = 0.002     # GradientAreaGapUtils.java:219-235
HIGH_NORMALIZED = 1.0

# The 256-entry depth colour map (GradientAreaGapUtils.java:132-155).
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
# channel-order class -> the rows of the map that its scan visits
# (GradientAreaGapUtils.java:107-129): 0 (R,G), 1 (R,B), 2 (G,R),
# 3 (G,B), 4 (B,R), 5 (B,G)
ORDER_RANGES = ((171, 212), (213, 255), (128, 170), (86, 127), (0, 29),
                (30, 85))


def _np_float(precision: str):
    return np.float64 if precision == "exact" else np.dtype(precision).type


def _row_ratios(dtype) -> np.ndarray:
    """Each map row's ratio, second channel over first by the strict
    channel order (0 on ties)."""
    lut = LUT_RGB.astype(dtype)
    r, g, b = lut[:, 0], lut[:, 1], lut[:, 2]
    out = np.zeros(256, dtype=dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        for sel, num, den in (((b > r) & (b > g) & (r > g), r, b),
                              ((b > r) & (b > g) & (g > r), g, b),
                              ((g > r) & (g > b) & (r > b), r, g),
                              ((g > r) & (g > b) & (b > r), b, g),
                              ((r > g) & (r > b) & (g > b), g, r),
                              ((r > g) & (r > b) & (b > g), b, r)):
            out = np.where(sel, num / den, out)
    return out


@functools.lru_cache(maxsize=4)
def slice_table(precision: str = "exact") -> np.ndarray:
    """int64 [6, 256, 256]: [order, max, second] -> the slice number, 1 +
    the first map row of the order's range whose ratio lies nearest
    second / max (0 where max is 0)."""
    dtype = _np_float(precision)
    row = _row_ratios(dtype)
    maxv = np.arange(256, dtype=dtype)[:, None]
    secv = np.arange(256, dtype=dtype)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = secv / maxv
    table = np.zeros((6, 256, 256), dtype=np.int64)
    for order, (start, end) in enumerate(ORDER_RANGES):
        gaps = np.abs(ratio[:, :, None] - row[start:end + 1][None, None, :])
        idx = np.argmin(np.where(np.isnan(gaps), np.inf, gaps), axis=2)
        table[order] = start + idx + 1
        table[order, 0, :] = 0
    return table


def slice_plane(rgb: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Slice numbers of [..., 3] u8 pixels, classified with >= in the
    reference's branch order (R first, then G, then B)."""
    r, g, b = (rgb[..., c].to(torch.int64) for c in range(3))
    r_br = (r >= g) & (r >= b)
    g_br = ~r_br & (g >= r) & (g >= b)
    b_br = ~r_br & ~g_br
    order = torch.zeros_like(r)
    maxv, secv = order.clone(), order.clone()
    for oid, sel, m, s in ((0, r_br & (g >= b), r, g),
                           (1, r_br & ~(g >= b), r, b),
                           (2, g_br & (r >= b), g, r),
                           (3, g_br & ~(r >= b), g, b),
                           (4, b_br & (r >= g), b, r),
                           (5, b_br & ~(r >= g), b, g)):
        order = torch.where(sel, oid, order)
        maxv = torch.where(sel, m, maxv)
        secv = torch.where(sel, s, secv)
    table = torch.from_numpy(slice_table(precision)).to(rgb.device)
    return table[order, maxv, secv]


def gray(rgb: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """rgbToGrayNoGammaCorrection (ColorTransformation.java:40-54):
    (int)(r/3 + g/3 + b/3 + 0.5), each third a product with 1/3, 0 for
    black."""
    dt = getattr(torch, np.dtype(_np_float(precision)).name)
    third = torch.tensor(1.0, dtype=dt) / torch.tensor(3.0, dtype=dt)
    r, g, b = (rgb[..., c].to(dt) for c in range(3))
    out = torch.floor(((r * third + g * third) + b * third) + 0.5)
    return torch.where((rgb != 0).any(dim=-1), out.to(torch.int64), 0)


def line_radii(radius: float) -> list:
    """The circular kernel's half-width per row, -k..k (ImageJ
    RankFilters' makeLineRadii, ImageTransformation.java:549-572)."""
    r2 = int(radius * radius) + 1
    k = int(math.sqrt(r2 + 1e-10))
    return [int(math.sqrt(r2 - y * y + 1e-10)) if y else k
            for y in range(-k, k + 1)]


def dilate(rgb: torch.Tensor, radius: float) -> torch.Tensor:
    """Per-channel circular max filter of [H, W, 3] u8 (pixels outside
    the frame count as 0): for each row offset the horizontal running
    max of its half-width, shifted and combined."""
    h, w, _ = rgb.shape
    x = rgb.permute(2, 0, 1).to(torch.float32)
    radii = line_radii(radius)
    k = (len(radii) - 1) // 2
    out = torch.zeros_like(x)
    for e in sorted(set(radii)):
        hmax = torch.nn.functional.max_pool1d(
            torch.nn.functional.pad(x.reshape(3 * h, 1, w), (e, e)),
            2 * e + 1, stride=1).reshape(3, h, w)
        for y in [i - k for i, r in enumerate(radii) if r == e]:
            if abs(y) >= h:
                continue
            if y >= 0:   # out row i takes input row i + y
                out[:, :h - y] = torch.maximum(out[:, :h - y], hmax[:, y:])
            else:
                out[:, -y:] = torch.maximum(out[:, -y:], hmax[:, :h + y])
    return out.permute(1, 2, 0).to(torch.uint8)


def query_planes(mask_rgb: np.ndarray, device="cpu",
                 precision: str = "exact") -> dict:
    """The mask's planes: its CDM with the label regions cleared; its
    signal (any channel > 0), slice numbers, 0/1 mask (gray > 2) and
    high-expression ring (gray of the radius-60 dilation outside the
    radius-20 one > 0)."""
    h, w, _ = mask_rgb.shape
    rgb = torch.from_numpy(mask_rgb).to(device)
    rgb = torch.where(torch.from_numpy(label_regions(h, w)).to(device)
                      [:, :, None], 0, rgb).to(torch.uint8)
    d20 = dilate(rgb, 20.0)
    d60 = dilate(rgb, 60.0)
    hem = torch.where((d20 > 0).any(dim=2, keepdim=True), 0, d60)
    return {"nonzero": (rgb > 0).any(dim=2),
            "slice": slice_plane(rgb, precision),
            "mask": (gray(rgb, precision) > 2).to(torch.int64),
            "high": gray(hem.to(torch.uint8), precision) > 0}


def target_planes(cdm: np.ndarray, grad: np.ndarray, zgap: np.ndarray,
                  threshold: int, device="cpu",
                  precision: str = "exact") -> dict:
    """A target's planes from its three files: the CDM's signal (label
    regions cleared, any channel > threshold), the gradient's values (a
    gray file as it is, an RGB one through gray), and the z-gap's signal
    (any channel > threshold) and slice numbers there."""
    h, w, _ = cdm.shape
    t = torch.from_numpy(cdm).to(device)
    t = torch.where(torch.from_numpy(label_regions(h, w)).to(device)
                    [:, :, None], 0, t)
    g = torch.from_numpy(grad).to(device)
    g = gray(g, precision) if g.dim() == 3 else g.to(torch.int64)
    z = torch.from_numpy(zgap).to(device)
    z_nonzero = (z > threshold).any(dim=2)
    return {"above": (t > threshold).any(dim=2), "grad": g,
            "z_nonzero": z_nonzero,
            "z_slice": torch.where(z_nonzero, slice_plane(z, precision), 0)}


def _gap_sum(q: dict, grad, z_nonzero, z_slice) -> int:
    sg = (q["slice"] - z_slice).abs()
    sg = torch.where(q["slice"] == 0, z_slice, sg)
    sg = torch.where(z_slice == 0, 0, sg)
    gap = torch.where(q["nonzero"] & z_nonzero & (sg - 40 >= 40), sg - 40,
                      q["mask"] * grad)
    return int(torch.where(gap > GAP_THRESHOLD, gap, 0).sum())


def shape_score(q: dict, t: dict, mirror: bool) -> Tuple[int, int, bool]:
    """(gradientAreaGap, highExpressionArea, mirrored) of one pair: the
    orientation with the lower gap + high // 3; the unmirrored one on a
    tie."""
    gap = _gap_sum(q, t["grad"], t["z_nonzero"], t["z_slice"])
    high = int((q["high"] & t["above"]).sum())
    if mirror:
        m_gap = _gap_sum(q, t["grad"].flip(1), t["z_nonzero"], t["z_slice"])
        m_high = int((q["high"] & t["above"].flip(1)).sum())
        if m_gap + m_high // 3 < gap + high // 3:
            return m_gap, m_high, True
    return gap, high, False


def normalized_scores(pixels, gaps, highs, precision: str = "exact"):
    """Each match's normalizedScore within its mask's scored matches
    (Java's double arithmetic, stored as a float32)."""
    dt = _np_float(precision)
    shape = [g + h // 3 if g >= 0 and h >= 0 else -1
             for g, h in zip(gaps, highs)]
    max_p = max([-1] + [int(p or 0) for p in pixels])
    max_s = max([-1] + shape)
    out = []
    for p, s in zip(pixels, shape):
        p = int(p or 0)
        if p == 0 or max_p == 0 or s < 0 or max_s <= 0:
            v = dt(p)
        else:
            bounded = min(max(dt(s) / dt(max_s) * dt(2.5),
                              dt(LOW_NORMALIZED)), dt(HIGH_NORMALIZED))
            v = dt(p) / dt(max_p) / dt(bounded) * dt(100.0)
        out.append(float(np.float32(v)))
    return out
