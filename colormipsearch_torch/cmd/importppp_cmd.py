"""importPPPResults command.

Counterpart of cmd/ImportPPPResultsCmd.java:58-441: walk PPP results
directories of per-EM cov_scores_*.json files, convert raw matches into
PPPMatchEntity records, attach screenshot file types by suffix, and
write grouped JSON results.

Copy of `colormipsearch_tpu/cmd/importppp_cmd.py`.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
from typing import List

from ..model import EMNeuronEntity, FileType, LMNeuronEntity, ProcessingType
from ..ppp import read_raw_ppp_matches
from .args import add_common_args

LOG = logging.getLogger(__name__)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("importPPPResults", help="import PPP matches")
    add_common_args(p)
    p.add_argument("--results-dir", "-rd", nargs="+", required=True,
                   help="dir(s) containing cov_scores_*.json files")
    p.add_argument("--screenshots-dir", default=None)
    p.add_argument("--only-best-skeleton-matches", action="store_true")
    p.add_argument("--em-library", default="flyem_hemibrain")
    p.add_argument("--lm-library", default="flylight_split_gal4_published")
    p.add_argument("--alignment-space", "-as", default="JRC2018_Unisex_20x_HR")
    p.add_argument("--db", default=None,
                   help="also upsert matches into this store "
                        "(pppMatches collection analogue)")
    p.set_defaults(func=run)


def _attach_screenshots(match, screenshots_dir: str) -> None:
    """Record screenshot SOURCE image files by PPP suffix
    (PPPMatchEntity.addSourceImageFile via ImportPPPResultsCmd's
    screenshot scan): the entity keeps only the screenshot TYPE ->
    image-name map; exported match files are resolved later from the
    pppmURL published store (EMPPPMatchesExporter.java:235-250)."""
    prefix = f"{match.source_em_name}-{match.source_lm_name}"
    try:
        names = os.listdir(screenshots_dir)
    except OSError:
        return
    for name in names:
        if name.startswith(prefix):
            match.add_source_image_file(name)


def run(args: argparse.Namespace) -> int:
    import json
    matches_by_em = {}
    files: List[str] = []
    for rd in args.results_dir:
        for root, _, names in os.walk(rd):
            files.extend(os.path.join(root, n) for n in names
                         if n.startswith("cov_scores_") and n.endswith(".json"))
    LOG.info("found %d PPP result files", len(files))
    for path in sorted(files):
        for m in read_raw_ppp_matches(
                path, only_best_matches=args.only_best_skeleton_matches):
            em_name = m.source_em_name
            body_id = re.match(r"([0-9]+)", em_name or "")
            em = EMNeuronEntity(published_name=body_id.group(1) if body_id else em_name,
                                library_name=args.em_library,
                                alignment_space=args.alignment_space)
            lm = LMNeuronEntity(published_name=(m.source_lm_name or "").split("-")[0],
                                library_name=args.lm_library,
                                alignment_space=args.alignment_space)
            m.mask_image = em
            m.matched_image = lm
            m.source_em_library = args.em_library
            m.source_lm_library = args.lm_library
            em.add_processed_tag(ProcessingType.PPPMatch, "pppImport")
            if args.screenshots_dir:
                _attach_screenshots(m, args.screenshots_dir)
            matches_by_em.setdefault(em_name, []).append(m)

    if args.db:
        from .backends import get_store
        store = get_store(args.db)
        n_db = sum(store.upsert_ppp_matches(ms)
                   for ms in matches_by_em.values())
        LOG.info("upserted %d PPP matches into %s", n_db, args.db)

    out_dir = args.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for em_name, matches in matches_by_em.items():
        doc = {"inputImage": matches[0].mask_image.to_dict(),
               "results": [m.to_dict() for m in
                           sorted(matches, key=lambda x: x.rank or 0)]}
        with open(os.path.join(out_dir, f"{em_name}.json"), "w") as f:
            json.dump(doc, f, indent=2)
        n += len(matches)
    LOG.info("imported %d PPP matches for %d EM bodies", n, len(matches_by_em))
    return 0
