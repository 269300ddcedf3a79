"""normalizeGradientScores command: standalone normalization pass.

Copy of `colormipsearch_tpu/cmd/normalize_cmd.py`.

Counterpart of cmd/NormalizeGradientScoresCmd.java:50-321: per mask
group, filter matches with gradientAreaGap|bidirectionalAreaGap >= 0,
compute max(matchingPixels)/max(gradScore) and update normalizedScore
only.
"""

from __future__ import annotations

import argparse
import logging
import time

from ..dataio import DataSourceParam, ScoresFilter
from ..model import ProcessingType
from ..results import normalize_match_scores
from .args import add_common_args

LOG = logging.getLogger(__name__)


def add_parser(subparsers) -> None:
    for name in ("normalizeGradientScores", "mormalizeGradientScores"):
        # the second spelling preserves the reference CLI's typo alias
        # (cmd/Main.java:32-43)
        p = subparsers.add_parser(name, help="normalize gradient scores")
        add_common_args(p)
        p.add_argument("-md", "--matchesDir", default=None)
        p.add_argument("--db", default=None)
        p.add_argument("--masks-mip-ids", nargs="*", default=None)
        p.add_argument("--masks-libraries", nargs="*", default=[])
        p.add_argument("--masks-published-names", nargs="*", default=[])
        p.add_argument("--alignment-space", "-as", default=None)
        p.add_argument("--pctPositivePixels", type=float, default=0.0)
        p.add_argument("--processing-tag", default=None)
        p.set_defaults(func=run)


def run(args: argparse.Namespace) -> int:
    from .backends import matches_reader, matches_writer
    t_start = time.time()
    reader = matches_reader(args.db, args.matchesDir)
    selector = DataSourceParam(mip_ids=args.masks_mip_ids or [])
    mask_locations = reader.list_match_locations([selector])
    n = 0
    for mip_id in mask_locations:
        matches = reader.read_matches_by_mask(DataSourceParam(
            mip_ids=[mip_id],
            libraries=list(getattr(args, "masks_libraries", []) or []),
            names=list(getattr(args, "masks_published_names", []) or []),
            alignment_space=getattr(args, "alignment_space", None)))
        if not matches:
            continue
        # filter matches that have a shape score
        # (NormalizeGradientScoresCmd.java:288: gradientAreaGap|bidirectionalAreaGap >= 0)
        flt = ScoresFilter().add("gradientAreaGap|bidirectionalAreaGap", 0)
        with_scores = [m for m in matches if flt.matches(m)]
        if args.pctPositivePixels:
            with_scores = [m for m in with_scores
                           if (m.matching_pixels_ratio or 0)
                           >= args.pctPositivePixels / 100.0]
        normalize_match_scores(with_scores)
        tag = args.processing_tag or "normalizeGradientScore"
        for m in with_scores:
            if m.mask_image is not None:
                m.mask_image.add_processed_tag(
                    ProcessingType.NormalizeGradientScore, tag)
            if m.matched_image is not None:
                m.matched_image.add_processed_tag(
                    ProcessingType.NormalizeGradientScore, tag)
        n += len(with_scores)
        matches_writer(args.db, args.matchesDir).write_updates(
            matches if not args.db else with_scores, ["normalizedScore"])
    LOG.info("normalized %d matches in %.1fs", n, time.time() - t_start)
    return 0
