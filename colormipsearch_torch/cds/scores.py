"""Shape score types and the normalized score.

Copy of `colormipsearch_tpu/cds/scores.py` without `PixelMatchScore`,
which the port does not use. Counterparts of the reference's score types
(cds/ShapeMatchScore.java:5-65, cds/GradientAreaGapUtils.java:199-235).
"""

from __future__ import annotations

from dataclasses import dataclass

LOW_NORMALIZED_NEGATIVE_SCORE = 0.002
HIGH_NORMALIZED_NEGATIVE_SCORE = 1.0


@dataclass
class ShapeMatchScore:
    gradient_area_gap: int
    high_expression_area: int
    bidirectional_area_gap: int = -1
    mirrored: bool = False

    @property
    def score(self) -> int:
        return calculate_2d_shape_score(self.gradient_area_gap,
                                        self.high_expression_area)


def calculate_2d_shape_score(gradient_area_gap, high_expression_area) -> int:
    """shapeScore = gradientAreaGap + highExpressionArea / 3
    (GradientAreaGapUtils.calculate2DShapeScore, cds/GradientAreaGapUtils.java:199-207)."""
    if (gradient_area_gap is not None and gradient_area_gap >= 0
            and high_expression_area is not None and high_expression_area >= 0):
        return int(gradient_area_gap) + int(high_expression_area) // 3
    return -1


def calculate_normalized_score(pixel_match_score: int,
                               shape_score: int,
                               max_pixel_match: int,
                               max_shape_score: int) -> float:
    """Normalized score (GradientAreaGapUtils.calculateNormalizedScore,
    cds/GradientAreaGapUtils.java:219-235):
    (pixelMatch/maxPixelMatch) / clamp(2.5*shape/maxShape, 0.002, 1.0) * 100,
    falling back to the raw pixel score when inputs are unusable."""
    if (pixel_match_score == 0 or max_pixel_match == 0
            or shape_score < 0 or max_shape_score <= 0):
        return float(pixel_match_score)
    normalized_pixel = float(pixel_match_score) / float(max_pixel_match)
    normalized_shape = float(shape_score) / float(max_shape_score)
    bounded_shape = min(max(normalized_shape * 2.5, LOW_NORMALIZED_NEGATIVE_SCORE),
                        HIGH_NORMALIZED_NEGATIVE_SCORE)
    return normalized_pixel / bounded_shape * 100.0
