"""Results grouping, partitioning, and top-ranked selection.

Copy of `colormipsearch_tpu/results/grouping.py`. Counterparts of
results/ItemsHandling.java:73-111, results/MatchEntitiesGrouping.java:26-40
and cmd/cdsprocess/ColorMIPProcessUtils.java:12-35.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, TypeVar

from ..model.entities import CDMatchEntity

T = TypeVar("T")


@dataclass
class ScoredEntry:
    name: str
    score: float
    entry: list


def partition_collection(items: Sequence[T], partition_size: int) -> List[List[T]]:
    """Chunk into fixed-size partitions (ItemsHandling.partitionCollection)."""
    size = partition_size if partition_size > 0 else 1
    return [list(items[i:i + size]) for i in range(0, len(items), size)]


def select_top_ranked_elements(items: Sequence[T],
                               grouping_criteria: Callable[[T], Optional[str]],
                               score_extractor: Callable[[T], float],
                               top_results: int,
                               limit_sub_results: int) -> List[ScoredEntry]:
    """Group -> sort each group desc by score (capped at limit_sub_results)
    -> rank groups by their max score -> cap at top_results
    (ItemsHandling.selectTopRankedElements, :80-109).

    Sorting is stable (Python sort == java list sort), preserving the
    reference's tie behavior.
    """
    grouped: Dict[str, List[T]] = {}
    for it in items:
        key = grouping_criteria(it) or "UNKNOWN"
        grouped.setdefault(key, []).append(it)
    entries = []
    for key, vals in grouped.items():
        vals.sort(key=lambda v: float(score_extractor(v)), reverse=True)
        if 0 < limit_sub_results < len(vals):
            vals = vals[:limit_sub_results]
        best = max(vals, key=lambda v: float(score_extractor(v)))
        entries.append(ScoredEntry(key, float(score_extractor(best)), vals))
    entries.sort(key=lambda se: se.score, reverse=True)
    if 0 < top_results < len(entries):
        entries = entries[:top_results]
    return entries


def select_best_matches(matches: List[CDMatchEntity],
                        top_line_matches: int,
                        top_samples_per_line: int,
                        top_matches_per_sample: int) -> List[CDMatchEntity]:
    """Top-ranked line/sample/match selection before gradient scoring
    (ColorMIPProcessUtils.selectBestMatches, :12-35): rank published lines
    by best pixel score, then samples within each line, then matches per
    sample."""
    top_lines = select_top_ranked_elements(
        matches,
        lambda m: m.matched_image.published_name if m.matched_image else None,
        lambda m: m.matching_pixels or 0,
        top_line_matches, -1)
    out: List[CDMatchEntity] = []
    for line_entry in top_lines:
        top_samples = select_top_ranked_elements(
            line_entry.entry,
            lambda m: m.matched_image.neuron_id if m.matched_image else None,
            lambda m: m.matching_pixels or 0,
            top_samples_per_line, top_matches_per_sample)
        for se in top_samples:
            out.extend(se.entry)
    return out


def group_matches_by_mask(matches: Sequence[CDMatchEntity]
                          ) -> Dict[int, List[CDMatchEntity]]:
    """Group matches by mask entity id
    (MatchEntitiesGrouping.groupMatchesByMaskID, :26-40)."""
    grouped: Dict[int, List[CDMatchEntity]] = {}
    for m in matches:
        key = m.mask_ref()
        grouped.setdefault(key, []).append(m)
    return grouped
