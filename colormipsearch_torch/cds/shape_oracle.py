"""Host (NumPy) shape planes of the gradient/shape scorer.

Copy of the plane builders of `colormipsearch_tpu/cds/shape_oracle.py`
(its per-pair NumPy scorer is left out: the port scores on the device,
`cds/shape_kernel.py`). The gradientScores command uses these only where
the reference does: ROI-mask runs and non-RGB images; every other plane
set is built on the device (`cds/shape_device.py`). Counterparts of
Shape2DMatchColorDepthSearchAlgorithm
(cds/Shape2DMatchColorDepthSearchAlgorithm.java:23-247) and the query-side
mask construction in ColorDepthSearchAlgorithmProviderFactory
(cds/ColorDepthSearchAlgorithmProviderFactory.java:76-127).

Key structural simplification (proved by substitution u = w-1-x over the
summed folds): the reference's mirrored pass applies horizontalMirror to
the query image, query mask, high-expression mask AND the target z-gap
mask, but NOT to the gradient image or target CDM
(Shape2DMatchColorDepthSearchAlgorithm.java:196-239). Summed over all
pixels this is exactly equivalent to keeping every query-side plane and
the z-gap plane fixed and flipping ONLY

  - the gradient image (for the gap sum), and
  - the target CDM (for the high-expression sum).

So no mirrored query planes are ever materialized; the mirror pass costs
two flipped reads of target-side planes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..imageproc import colors
from ..imageproc.filters import max_filter_rgb
from ..imageproc.io import Image, ImageKind
from .lut import slice_plane


@dataclass
class QueryShapePlanes:
    """Per-mask planes computed once (the reference builds these lazily
    once per mask: CalculateGradientScoresCmd.java:147-182). The host
    build holds NumPy arrays; the device build
    (`shape_device.build_query_planes`) holds tensors on its device."""
    q_nonzero: Any   # bool [H, W]: label-cleared query has any channel > 0
    q_slice: Any     # int [H, W] slice numbers of the query CDM
    q_mask: Any      # 0/1 signal mask (gray16 > 2)
    high_expr: Any   # 0/1 high-expression mask (dilate60 - dilate20)
    height: int
    width: int
    # the [H] active-rows vector of a device build: the one plane the
    # host reads (active_row_range)
    row_any: Optional[np.ndarray] = None   # bool [H]

    def active_row_range(self) -> tuple:
        """Row band outside which every per-pixel term is provably zero:
        the gap op needs q_nonzero (slice-gap term) or q_mask (grad
        default term, q_mask subset of q_nonzero), the high-expression
        sum needs high_expr. Rows are rounded out to multiples of 8."""
        if self.row_any is not None:
            rows = np.nonzero(self.row_any)[0]
        else:
            rows = np.nonzero(self.q_nonzero.any(axis=1)
                              | self.high_expr.astype(bool).any(axis=1))[0]
        if len(rows) == 0:
            return (0, min(8, self.height))
        r0 = (int(rows[0]) // 8) * 8
        r1 = min(-(-(int(rows[-1]) + 1) // 8) * 8, self.height)
        return (r0, r1)


def build_query_shape_planes(query: Image,
                             excluded: Optional[np.ndarray] = None,
                             roi_mask: Optional[Image] = None,
                             border: int = 0) -> QueryShapePlanes:
    """Query-side mask construction
    (ColorDepthSearchAlgorithmProviderFactory.java:96-121):
      queryImage   = clearRegions(query)
      highExpr     = signal0(gray16(where(dilate20 != 0, black, dilate60)))
      queryMask    = signal2(gray16(queryImage))
    plus optional ROI masking (Shape2DMatchColorDepthSearchAlgorithm.java:201-218).

    `border` is the reference's --border / queryBorderSize
    (AbstractColorDepthMatchArgs.java:24-25): the query LImage carries a
    border frame (ColorDepthSearchAlgorithmProviderFactory.java:103) and
    the gradient-gap fold skips it (LImage.fold:89-97 via combine4's
    first operand, Shape2DMatchColorDepthSearchAlgorithm.java:219-240).
    Zeroing q_nonzero and q_mask inside the frame is fold-exact: a
    border pixel then contributes gap = 0*grad = 0 <= GAP_THRESHOLD.
    The high-expression fold is NOT border-cropped in the reference —
    combine2's first operand there is the border-less target image
    (:226-239) — so high_expr stays full-frame. Dilations run on the
    full image FIRST, keeping footprints that straddle the frame exact.
    """
    rgb = query.rgb_i32().astype(np.uint8)
    if excluded is not None:
        rgb = colors.clear_region_rgb(rgb, excluded)
    d60 = max_filter_rgb(rgb, 60.0)
    d20 = max_filter_rgb(rgb, 20.0)
    hem_rgb = np.where((d20 > 0).any(axis=2)[:, :, None], 0, d60).astype(np.uint8)
    high_expr = colors.gray_to_signal(colors.rgb_to_gray_no_gamma(hem_rgb), 0)
    q_mask = colors.gray_to_signal(colors.rgb_to_gray_no_gamma(rgb), 2)
    if roi_mask is not None:
        roi_rgb = roi_mask.rgb_i32()
        if excluded is not None:
            roi_rgb = colors.clear_region_rgb(roi_rgb, excluded)
        roi_zero = (roi_rgb == 0).all(axis=2)
        rgb = np.where(roi_zero[:, :, None], 0, rgb).astype(np.uint8)
        q_mask = np.where(roi_zero, 0, q_mask)
        high_expr = np.where(roi_zero, 0, high_expr)
    q_nonzero = (rgb > 0).any(axis=2)
    if border > 0:
        frame = np.zeros_like(q_nonzero)
        frame[border:q_nonzero.shape[0] - border,
              border:q_nonzero.shape[1] - border] = True
        q_nonzero = q_nonzero & frame
        q_mask = np.where(frame, q_mask, 0)
    return QueryShapePlanes(
        q_nonzero=q_nonzero,
        q_slice=slice_plane(rgb),
        q_mask=q_mask,
        high_expr=high_expr,
        height=query.height,
        width=query.width,
    )


def compute_zgap_image(target: Image, query_threshold: int,
                       excluded: Optional[np.ndarray],
                       radius: float = 10.0) -> np.ndarray:
    """On-the-fly target z-gap: clearRegions -> mask(queryThreshold) ->
    unsafeMaxFilter(radius) (Shape2DMatchColorDepthSearchAlgorithmTest
    .java:338-343; the production variant precomputes these offline with
    radius 10 by the same recipe). Returns RGB [H, W, 3] uint8."""
    rgb = target.rgb_i32().astype(np.uint8)
    if excluded is not None:
        rgb = colors.clear_region_rgb(rgb, excluded)
    rgb = colors.mask_rgb(rgb, query_threshold)
    return max_filter_rgb(rgb, radius)


@dataclass
class TargetShapePlanes:
    """Per-target planes, computable once per target and cacheable. The
    host build holds NumPy arrays (grad and z_slice as uint16); the
    device build holds tensors (`shape_device.build_target_planes`)."""
    t_above: Any     # bool [H, W]: label-cleared target any channel > thr
    grad: Any        # [H, W] gradient image values (0..65535)
    z_nonzero: Any   # bool [H, W]: z-gap (masked) any channel > thr
    z_slice: Any     # [H, W] slice numbers of the z-gap image (0..256)


def build_target_shape_planes(target: Image, target_grad: Image,
                              target_zgap: Optional[Image],
                              query_threshold: int,
                              excluded: Optional[np.ndarray]) -> TargetShapePlanes:
    t_rgb = target.rgb_i32().astype(np.uint8)
    t_clear = colors.clear_region_rgb(t_rgb, excluded) if excluded is not None else t_rgb
    if target_zgap is not None:
        z_rgb = target_zgap.rgb_i32().astype(np.uint8)
    else:
        z_rgb = compute_zgap_image(target, query_threshold, excluded)
    # targetZGapMaskImage = zgap masked at queryThreshold
    # (Shape2DMatchColorDepthSearchAlgorithm.java:161)
    z_nonzero = (z_rgb > query_threshold).any(axis=2)
    z_slice = np.where(z_nonzero, slice_plane(z_rgb), 0)
    if target_grad.kind == ImageKind.RGB:
        grad = colors.rgb_to_gray_no_gamma(target_grad.pixels)
    else:
        grad = target_grad.gray_i32()
    return TargetShapePlanes(
        t_above=(t_clear > query_threshold).any(axis=2),
        grad=grad.astype(np.uint16),    # gradient distances fit u16
        z_nonzero=z_nonzero,
        z_slice=z_slice.astype(np.uint16),  # NB slice numbers reach 256
    )


def build_mirrored_query_shape_planes(query: Image,
                                      excluded: Optional[np.ndarray],
                                      roi_mask: Optional[Image],
                                      border: int = 0) -> QueryShapePlanes:
    """Query planes for the mirrored orientation when an ROI mask is in
    play. The reference mirrors the query but NOT the ROI
    (Shape2DMatchColorDepthSearchAlgorithm.java:201-218 applies
    maskTransformation only to the query-side images), so the
    flip-equivalence in the module docstring no longer holds; instead
    build planes from the x-flipped query (circular dilation commutes
    with mirroring) with the un-flipped ROI."""
    flipped = Image(query.kind, np.ascontiguousarray(query.pixels[:, ::-1]))
    flipped_excluded = (np.ascontiguousarray(excluded[:, ::-1])
                        if excluded is not None else None)
    # the border frame is x-symmetric, so it commutes with the flip
    return build_query_shape_planes(flipped, flipped_excluded, roi_mask,
                                    border)
