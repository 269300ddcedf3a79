"""The shape/gradient scorer as torch ops on the device.

Counterpart of `colormipsearch_tpu/cds/shape_kernel.py`, an XLA program
(no Pallas kernel) re-designing Shape2DMatchColorDepthSearchAlgorithm
(cds/Shape2DMatchColorDepthSearchAlgorithm.java:23-247): a match is two
elementwise passes and row sums over precomputed integer planes, the
query's planes once per mask and the target's once per target
(`shape_device.py`, or the host builds of `shape_oracle.py`).

Mirror-pass equivalence (proof in shape_oracle.py): the mirrored
orientation only flips the gradient plane (gap sum) and the target plane
(high-expression sum), so both orientations run over the same query
planes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .shape_device import grad_values

GAP_THRESHOLD = 3


def shape_score_rows(q_nonzero, q_slice, q_mask, high_expr,
                     grad, z_nonzero, z_slice, t_above, *,
                     mirror: bool) -> Tuple[torch.Tensor, ...]:
    """Batched shape scores: query planes [R, W], target planes
    [T, R, W], all on one device (counterpart of `shape_score_kernel`).

    Returns per-ROW int32 sums [T, R] for (gaps_id, high_id, gaps_m,
    high_m). A per-pixel gap is at most max(slice gap 216, grad 65535),
    so a row sum fits int32 (1210 * 65535 < 2**31) but a whole-image sum
    may not; finish_shape_scores adds the rows in int64.
    """
    shape_score_rows.calls += 1
    q_nonzero = q_nonzero.to(torch.bool)[None]
    q_slice = q_slice.to(torch.int32)[None]
    q_mask = q_mask.to(torch.bool)[None]
    high_expr = high_expr.to(torch.bool)[None]
    z_slice = z_slice.to(torch.int32)

    # calculateSliceGap (GradientAreaGapUtils.java:100-104): 0 where the
    # target has no slice, the target's slice where the query has none
    sg = (q_slice - z_slice).abs()
    sg = torch.where(q_slice == 0, z_slice, sg).masked_fill_(z_slice == 0, 0)
    # PIXEL_GAP_OP (Shape2DMatchColorDepthSearchAlgorithm.java:28-42):
    # both images present and slices >= 80 apart -> sg - 40, else
    # queryMask * grad; zeroed unless > GAP_THRESHOLD
    use_slice = q_nonzero & z_nonzero.to(torch.bool) & (sg >= 80)
    slice_gap = sg - 40

    def gap_rows(grad_plane):
        gap = torch.where(use_slice, slice_gap,
                          grad_plane.masked_fill(~q_mask, 0))
        return gap.masked_fill_(gap <= GAP_THRESHOLD, 0).sum(
            dim=2, dtype=torch.int32)

    def high_rows(t_above_plane):
        return (high_expr & t_above_plane.to(torch.bool)).sum(
            dim=2, dtype=torch.int32)

    grad = grad_values(grad)
    gaps_id = gap_rows(grad)
    high_id = high_rows(t_above)
    if not mirror:
        return gaps_id, high_id, gaps_id, high_id
    return gaps_id, high_id, gap_rows(grad.flip(2)), high_rows(t_above.flip(2))


shape_score_rows.calls = 0


def shape_score_stacked(q_nonzero, q_slice, q_mask, high_expr,
                        t_above_list: Sequence[torch.Tensor],
                        grad_list: Sequence[torch.Tensor],
                        znz_list: Sequence[torch.Tensor],
                        zsl_list: Sequence[torch.Tensor],
                        *, r0: int, r1: int, mirror: bool):
    """Crop every plane to the query's active row band [r0, r1), stack
    the targets' [H, W] planes and score them (counterpart of
    `shape_score_stacked`)."""

    def stack(planes):
        return torch.stack([p[r0:r1] for p in planes])

    return shape_score_rows(q_nonzero[r0:r1], q_slice[r0:r1],
                            q_mask[r0:r1], high_expr[r0:r1],
                            stack(grad_list), stack(znz_list),
                            stack(zsl_list), stack(t_above_list),
                            mirror=mirror)


def finish_shape_scores(gaps_id, high_id, gaps_m, high_m, mirror: bool):
    """Row totals in int64 and the orientation choice
    (Shape2DMatchColorDepthSearchAlgorithm.java:171-185: keep the mirrored
    result only when its combined score is strictly lower). Takes the
    row sums as tensors on any device (or arrays); returns NumPy int64
    (gaps, high, score) and bool use_m, each [T]."""
    rows = [torch.as_tensor(x) for x in (gaps_id, high_id, gaps_m, high_m)]
    totals = torch.stack([x.to(torch.int64).sum(dim=1) for x in rows])
    gaps_id, high_id, gaps_m, high_m = totals.cpu().numpy()
    score_id = gaps_id + high_id // 3
    if not mirror:
        return gaps_id, high_id, score_id, np.zeros(len(gaps_id), dtype=bool)
    score_m = gaps_m + high_m // 3
    use_m = score_m < score_id
    gaps = np.where(use_m, gaps_m, gaps_id)
    high = np.where(use_m, high_m, high_id)
    score = np.where(use_m, score_m, score_id)
    return gaps, high, score, use_m
