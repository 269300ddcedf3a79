"""Circular max-filter (morphological dilation), ImageJ RankFilters-compatible.

Copy of `colormipsearch_tpu/imageproc/filters.py` without the native
max filter: the port's host path (ROI-mask runs, non-RGB images) is
rare, and its dilations run in NumPy/SciPy. The reference implements
this as a stateful sliding-histogram scan
(imageprocessing/ImageTransformation.java:201-535) whose kernel rows come
from makeLineRadii (ImageTransformation.java:549-572), including ImageJ's
radius snapping (1.5->1.75, 2.5->2.85). Here the same kernel footprint is
applied per channel; outside-image pixels count as 0, which for
non-negative pixel data is identical to the reference's window clipping.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage as ndi


def make_line_radii(radius_arg: float) -> np.ndarray:
    """Per-row kernel half-extents dx for kernel rows y = -kR..kR
    (ImageTransformation.makeLineRadii, :549-572). Returns int array
    [kHeight] of dx; row y covers x in [-dx, dx]."""
    if 1.5 <= radius_arg < 1.75:
        radius = 1.75
    elif 2.5 <= radius_arg < 2.85:
        radius = 2.85
    else:
        radius = radius_arg
    r2 = int(radius * radius) + 1
    k_radius = int(math.sqrt(r2 + 1e-10))
    k_height = 2 * k_radius + 1
    dxs = np.zeros(k_height, dtype=np.int64)
    dxs[k_radius] = k_radius
    for y in range(1, k_radius + 1):
        dx = int(math.sqrt(r2 - y * y + 1e-10))
        dxs[k_radius - y] = dx
        dxs[k_radius + y] = dx
    return dxs


def max_filter_plane(plane: np.ndarray, radius: float) -> np.ndarray:
    """Dilate a single 2D plane with the circular kernel (clip at borders).

    Decomposed row-wise for speed: for each distinct row half-extent e the
    horizontal sliding max H_e is O(N) (maximum_filter1d), then the circular
    result is the max of vertically-shifted H_e planes — identical to the
    dense footprint max since the footprint rows are intervals [-e, e].
    """
    dxs = make_line_radii(radius)
    k_radius = (len(dxs) - 1) // 2
    h = plane.shape[0]
    by_extent = {}
    for row, dx in enumerate(dxs):
        by_extent.setdefault(int(dx), []).append(row - k_radius)
    out = np.zeros_like(plane)
    for extent, offsets in by_extent.items():
        hmax = ndi.maximum_filter1d(plane, size=2 * extent + 1, axis=1,
                                    mode="constant", cval=0)
        for off in offsets:
            if off >= 0:
                np.maximum(out[:h - off], hmax[off:], out=out[:h - off])
            else:
                np.maximum(out[-off:], hmax[:h + off], out=out[-off:])
    return out


def max_filter_rgb(rgb: np.ndarray, radius: float) -> np.ndarray:
    """Per-channel dilation of an RGB [H, W, 3] array.

    The reference's RGBHistogram computes per-channel running maxima
    (ImageTransformation.java:36-84), i.e. channels dilate independently.
    """
    out = np.empty_like(rgb)
    for c in range(rgb.shape[2]):
        out[:, :, c] = max_filter_plane(rgb[:, :, c], radius)
    return out
