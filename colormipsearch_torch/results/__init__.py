"""Result partitioning, selection and normalization (counterpart of
`colormipsearch_tpu/results/`)."""

from .grouping import (ScoredEntry, group_matches_by_mask,
                       partition_collection, select_best_matches,
                       select_top_ranked_elements)
from .normalization import normalize_match_scores
