"""Algorithm factories: the library-facing construction API.

Counterpart of `colormipsearch_tpu/cds/factory.py` (:20-117), itself the
counterpart of cds/ColorDepthSearchAlgorithmProviderFactory.java:30-127
and the ColorMIPSearch facade (cds/ColorMIPSearch.java:12-47): one place
that applies the reference's parameter conventions (zTolerance =
pixColorFluctuation / 100, even xyShift validation, label-region
exclusion) and picks the engine. Scoring takes an explicit device
(`score_batch(targets_u8, device)`), as every device entry point of the
port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..imageproc.io import Image
from ..imageproc.regions import label_regions_mask
from .scores import ShapeMatchScore


def create_pixel_match_engine(query: Image,
                              query_threshold: int = 100,
                              mirror_mask: bool = False,
                              data_threshold: int = 100,
                              pix_color_fluctuation: float = 2.0,
                              xy_shift: int = 0,
                              use_label_regions: bool = True,
                              excluded: Optional[np.ndarray] = None,
                              engine: str = "auto",
                              neg_query: Optional[Image] = None,
                              neg_query_threshold: int = 0,
                              mirror_neg_query: bool = False):
    """Build a pixel-match engine with the reference's defaults
    (cmd/AbstractColorDepthMatchArgs.java:18-43).

    engine: "auto" and "pallas" build the two-phase path's active-tile
    engine (`pixel_active.ActiveTilePixelEngine`, the exact CUDA kernels),
    "dense" the dense engine (`pixel_kernel.PixelMatchEngine`). A negative
    query composes two engines with the reference's score subtraction
    (PixelMatchColorDepthSearchAlgorithm.java:195-217)."""
    if xy_shift % 2:
        raise ValueError("XY shift parameter must be an even number.")
    if engine not in ("auto", "dense", "pallas"):
        raise ValueError(f"engine {engine!r}: use auto, dense or pallas")
    if excluded is None and use_label_regions:
        excluded = label_regions_mask(query.height, query.width)

    def build(img, thr, mirror):
        if engine == "dense":
            from .pixel_kernel import PixelMatchEngine
            return PixelMatchEngine(img, thr, mirror, data_threshold,
                                    pix_color_fluctuation, xy_shift, excluded)
        from .pixel_active import ActiveTilePixelEngine
        return ActiveTilePixelEngine(img, thr, mirror, data_threshold,
                                     pix_color_fluctuation, xy_shift,
                                     excluded)

    pos = build(query, query_threshold, mirror_mask)
    if neg_query is None:
        return pos
    neg = build(neg_query, neg_query_threshold, mirror_neg_query)
    return NegQueryPixelMatchEngine(pos, neg)


class NegQueryPixelMatchEngine:
    """Positive/negative engine pair with the reference's subtraction
    (PixelMatchColorDepthSearchAlgorithm.java:195-217):
    pixels -= round(negPixels * querySize / negQuerySize),
    ratio  -= negPixels / negQuerySize."""

    def __init__(self, pos, neg):
        self.pos = pos
        self.neg = neg

    @property
    def query_size(self) -> int:
        return self.pos.planes.query_size

    def score_batch(self, targets_u8: np.ndarray, device):
        pixels, ratios, mirrored = self.pos.score_batch(targets_u8, device)
        neg_pixels, _, _ = self.neg.score_batch(targets_u8, device)
        neg_size = self.neg.planes.query_size
        if neg_size <= 0:
            return pixels, ratios, mirrored
        qsize = self.query_size
        adj = np.asarray([
            int(round(float(p) - float(n) * qsize / float(neg_size)))
            for p, n in zip(pixels, neg_pixels)])
        ratios = ratios - neg_pixels.astype(np.float64) / float(neg_size)
        return adj, ratios, mirrored


class ShapeMatchScorer:
    """Query-side shape planes and a per-target scorer for one mask
    (counterpart of the JAX package's ShapeScoreOracle, scoring through
    the port's device scorer, `shape_kernel.shape_score_rows`, on an
    explicit device). With an ROI mask and mirroring, the mirrored
    orientation has its own query planes, scored against the x-flipped
    z-gap planes (the reference mirrors the query but not the ROI)."""

    def __init__(self, query: Image, query_threshold: int,
                 mirror_query: bool, excluded: Optional[np.ndarray],
                 roi_mask: Optional[Image], border: int):
        from .shape_oracle import (build_mirrored_query_shape_planes,
                                   build_query_shape_planes)
        self.query_threshold = query_threshold
        self.mirror_query = mirror_query
        self.excluded = excluded
        self.planes = build_query_shape_planes(query, excluded, roi_mask,
                                               border)
        self.mirror_planes = (
            build_mirrored_query_shape_planes(query, excluded, roi_mask,
                                              border)
            if (mirror_query and roi_mask is not None) else None)

    def score(self, target: Image, target_grad: Image,
              target_zgap: Optional[Image] = None,
              device="cuda") -> ShapeMatchScore:
        """The best orientation's (gap, high-expression area) of one
        target, scored on `device`; the mirrored one only where its
        combined score is strictly lower
        (Shape2DMatchColorDepthSearchAlgorithm.java:171-185)."""
        from .shape_kernel import finish_shape_scores, shape_score_rows
        from .shape_oracle import build_target_shape_planes
        t = build_target_shape_planes(target, target_grad, target_zgap,
                                      self.query_threshold, self.excluded)

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        grad = on(t.grad.view(np.int16))[None]
        t_above = on(t.t_above)[None]
        z_nonzero = on(t.z_nonzero)[None]
        z_slice = on(t.z_slice.astype(np.int16))[None]

        def rows(q, znz, zsl, mirror):
            return shape_score_rows(
                on(q.q_nonzero), on(q.q_slice.astype(np.int16)),
                on(q.q_mask.astype(bool)), on(q.high_expr.astype(bool)),
                grad, znz, zsl, t_above, mirror=mirror)

        if self.mirror_planes is None:
            gaps, high, _, use_m = finish_shape_scores(
                *rows(self.planes, z_nonzero, z_slice, self.mirror_query),
                mirror=self.mirror_query)
            return ShapeMatchScore(int(gaps[0]), int(high[0]),
                                   mirrored=bool(use_m[0]))
        g_i, h_i, s_i, _ = finish_shape_scores(
            *rows(self.planes, z_nonzero, z_slice, False), mirror=False)
        g_m, h_m, s_m, _ = finish_shape_scores(
            *rows(self.mirror_planes, z_nonzero.flip(2), z_slice.flip(2),
                  False), mirror=False)
        if s_m[0] < s_i[0]:
            return ShapeMatchScore(int(g_m[0]), int(h_m[0]), mirrored=True)
        return ShapeMatchScore(int(g_i[0]), int(h_i[0]), mirrored=False)


def create_shape_match_scorer(query: Image,
                              query_threshold: int = 20,
                              mirror_mask: bool = True,
                              use_label_regions: bool = True,
                              excluded: Optional[np.ndarray] = None,
                              roi_mask: Optional[Image] = None,
                              border: int = 0) -> ShapeMatchScorer:
    """Build query-side shape planes and their scorer
    (createShapeMatchCDSAlgorithmProvider,
    ColorDepthSearchAlgorithmProviderFactory.java:76-127; border =
    queryBorderSize threaded from --border,
    CalculateGradientScoresCmd.java:478)."""
    if excluded is None and use_label_regions:
        excluded = label_regions_mask(query.height, query.width)
    return ShapeMatchScorer(query, query_threshold, mirror_mask, excluded,
                            roi_mask, border)


def is_match(matching_pixels: int, matching_pixels_ratio: float,
             pct_positive_pixels: float = 0.0) -> bool:
    """ColorMIPSearch.isMatch (cds/ColorMIPSearch.java:42-46)."""
    return (matching_pixels > 0
            and matching_pixels_ratio > pct_positive_pixels / 100.0)
