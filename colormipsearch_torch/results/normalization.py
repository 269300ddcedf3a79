"""Per-mask score normalization.

Copy of `colormipsearch_tpu/results/normalization.py`. Counterpart of
CalculateGradientScoresCmd.normalizeScores
(cmd/CalculateGradientScoresCmd.java:616-645): per mask group, take
max(matchingPixels) and max(gradScore), then set normalizedScore =
calculateNormalizedScore(...) on each match (exact float semantics in
cds/GradientAreaGapUtils.java:219-235).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..cds.scores import calculate_normalized_score
from ..model.entities import CDMatchEntity
from .grouping import group_matches_by_mask


def normalize_match_scores(matches: Sequence[CDMatchEntity]) -> None:
    """Normalize in place, grouped by mask entity id."""
    for _, group in group_matches_by_mask(matches).items():
        max_pixels = -1
        max_grad = -1
        for m in group:
            max_pixels = max(max_pixels, m.matching_pixels or 0)
            max_grad = max(max_grad, m.grad_score)
        for m in group:
            score = calculate_normalized_score(
                m.matching_pixels or 0, m.grad_score, max_pixels, max_grad)
            # the reference stores it as a Java float (32-bit)
            m.normalized_score = float(np.float32(score))
