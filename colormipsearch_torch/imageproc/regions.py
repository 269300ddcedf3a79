"""Excluded-region (label box) masks.

Copy of `colormipsearch_tpu/imageproc/regions.py`. The reference burns
text labels into CDMs and excludes those boxes from search
(cmd/AbstractColorDepthMatchArgs.getRegionGeneratorForTextLabels,
colormipsearch-tools .../cmd/AbstractColorDepthMatchArgs.java:101-119):
a color-scale box (x >= width-270 && y < 90, only when width > 270) plus a
name label box (x < 330 && y < 100).

Here a region definition is a function (height, width) -> bool[H, W]
with True marking EXCLUDED pixels.
"""

from __future__ import annotations

import numpy as np


def label_regions_mask(height: int, width: int,
                       color_scale_width: int = 270,
                       color_scale_height: int = 90,
                       name_width: int = 330,
                       name_height: int = 100) -> np.ndarray:
    """True where a pixel lies inside a burned-in label region."""
    mask = np.zeros((height, width), dtype=bool)
    if width > color_scale_width:
        mask[:color_scale_height, width - color_scale_width:] = True
    mask[:name_height, :name_width] = True
    return mask


def no_regions_mask(height: int, width: int) -> np.ndarray:
    return np.zeros((height, width), dtype=bool)
