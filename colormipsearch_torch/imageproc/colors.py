"""Color transformations on dense planes.

Copy of `colormipsearch_tpu/imageproc/colors.py`. Counterparts of
imageprocessing/ColorTransformation.java, with the exact float64
arithmetic of the reference (Java doubles == NumPy float64).
"""

from __future__ import annotations

import numpy as np

from .io import Image, ImageKind

_THIRD = np.float64(1.0) / np.float64(3.0)


def rgb_to_gray_no_gamma(rgb: np.ndarray, max_gray_value: float = 255.0) -> np.ndarray:
    """rgbToGrayNoGammaCorrection (ColorTransformation.java:40-54):
    (int)((maxGray/255) * (r*(1/3) + g*(1/3) + b*(1/3) + 0.5)), 0 for black.
    Multiplications/additions replicate the reference's evaluation order."""
    r = rgb[:, :, 0].astype(np.float64)
    g = rgb[:, :, 1].astype(np.float64)
    b = rgb[:, :, 2].astype(np.float64)
    scale = np.float64(np.float32(max_gray_value) / np.float32(255.0))
    expr = ((r * _THIRD + g * _THIRD) + b * _THIRD) + np.float64(0.5)
    gray = np.floor(scale * expr).astype(np.int32)
    nonzero = (rgb != 0).any(axis=2)
    return np.where(nonzero, gray, 0)


def to_gray16_no_gamma(image: Image) -> np.ndarray:
    """toGray16WithNoGammaCorrection (ColorTransformation.java:97-112).
    NB for RGB input the reference keeps the 0..255 gray range."""
    if image.kind == ImageKind.RGB:
        return rgb_to_gray_no_gamma(image.pixels, 255.0)
    if image.kind == ImageKind.GRAY8:
        pv = image.pixels.astype(np.float32)
        return (pv / np.float32(255.0) * np.float32(65535.0)).astype(np.int32)
    return image.pixels.astype(np.int32)


def gray_to_signal(gray: np.ndarray, threshold: int) -> np.ndarray:
    """gray8Or16ToSignal (ColorTransformation.java:153-160): pv > thr -> 1."""
    return (gray > threshold).astype(np.int32)


def mask_rgb(rgb: np.ndarray, threshold: int) -> np.ndarray:
    """maskRGB with maskedVal=black (ColorTransformation.java:29-38):
    zero out pixels whose channels are all <= threshold."""
    keep = (rgb > threshold).any(axis=2)
    return np.where(keep[:, :, None], rgb, 0).astype(rgb.dtype)


def clear_region_rgb(rgb: np.ndarray, excluded: np.ndarray) -> np.ndarray:
    """clearRegion (ImageTransformation.java:182-193): excluded -> black."""
    return np.where(excluded[:, :, None], 0, rgb).astype(rgb.dtype)


def mirror_x(arr: np.ndarray) -> np.ndarray:
    """horizontalMirror (ImageTransformation.java:158-165)."""
    return arr[:, ::-1, ...]
