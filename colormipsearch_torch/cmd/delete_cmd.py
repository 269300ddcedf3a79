"""deleteCDMatches command: bulk delete matches by filter
(cmd/DeleteCDMatchesCmd.java:46-354).

Semantics mirrored from the reference:
- masks are selected with the full NeuronSelector surface (alignment
  space, libraries, published names, mip ids, datasets, tags,
  annotations/terms incl. exclusions, processing tags);
- per selected mask, matches are further filtered by target-side
  selectors and match tags;
- by default only matches WITHOUT a gradient score are deleted
  (`gradientAreaGap|bidirectionalAreaGap` at the -1 "no score"
  sentinel, DeleteCDMatchesCmd.java:320-324);
  --include-matches-with-gradscore lifts that;
- deleted matches are ARCHIVED (full docs copied aside) unless
  --no-archive (DBNeuronMatchesRemover.java:20-34);
- deletes run in --delete-batch-size chunks over partitioned masks.

Deviation: the reference's remover is a no-op for file-system storage
(DeleteCDMatchesCmd.getCDMatchesRemover logs "only implemented for DB
storage"); here the JSON path actually deletes/rewrites per-mask files,
with the same filter surface applied host-side.

Copy of `colormipsearch_tpu/cmd/delete_cmd.py`.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..dataio import (DataSourceParam, JSONNeuronMatchesReader,
                      JSONNeuronMatchesWriter, ScoresFilter)
from .args import add_common_args

LOG = logging.getLogger(__name__)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("deleteCDMatches", help="bulk delete matches")
    add_common_args(p)
    p.add_argument("-md", "--matchesDir", default=None)
    p.add_argument("--db", default=None)
    p.add_argument("-as", "--alignment-space", default=None)
    # mask-side selectors (DeleteCDMatchesCmd.java:52-92)
    p.add_argument("--masks-libraries", nargs="*", default=[])
    p.add_argument("--masks-published-names", nargs="*", default=[])
    p.add_argument("--masks-mips", "--masks-mip-ids", dest="masks_mip_ids",
                   nargs="*", default=None)
    p.add_argument("--masks-datasets", nargs="*", default=[])
    p.add_argument("--masks-tags", nargs="*", default=[])
    p.add_argument("--masks-terms", nargs="*", default=[],
                   help="mask neuron annotations (terms)")
    p.add_argument("--excluded-masks-terms", nargs="*", default=[])
    p.add_argument("--masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG")
    # target-side selectors (:94-131)
    p.add_argument("--targets-libraries", nargs="*", default=[])
    p.add_argument("--targets-published-names", nargs="*", default=[])
    p.add_argument("--targets-mips", nargs="*", default=[])
    p.add_argument("--targets-datasets", nargs="*", default=[])
    p.add_argument("--targets-tags", nargs="*", default=[])
    p.add_argument("--targets-terms", nargs="*", default=[])
    p.add_argument("--excluded-targets-terms", nargs="*", default=[])
    p.add_argument("--targets-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG")
    # match-level filters (:147-153)
    p.add_argument("--match-tags", nargs="*", default=[])
    p.add_argument("--include-matches-with-gradscore", action="store_true",
                   help="also delete matches that already have a gradient "
                        "score (default deletes only score-less matches)")
    p.add_argument("--no-archive", action="store_true",
                   help="hard-delete without copying to the archive")
    p.add_argument("--delete-batch-size", type=int, default=10000)
    p.add_argument("--processingPartitionSize", "-ps", type=int, default=100)
    # legacy convenience filter kept from the minimal command
    p.add_argument("--max-matching-pixels", type=int, default=None,
                   help="delete matches with matchingPixels below this")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=run)


def _ptags(specs):
    out = {}
    for spec in specs or []:
        stage, _, tag = spec.partition("=")
        if tag:
            out.setdefault(stage, set()).add(tag)
    return out


def _mask_selector(args) -> DataSourceParam:
    return DataSourceParam(
        alignment_space=args.alignment_space,
        libraries=list(args.masks_libraries or []),
        names=list(args.masks_published_names or []),
        mip_ids=list(args.masks_mip_ids or []),
        datasets=set(args.masks_datasets or []),
        tags=set(args.masks_tags or []),
        annotations=set(args.masks_terms or []),
        excluded_annotations=set(args.excluded_masks_terms or []),
        processing_tags=_ptags(args.masks_processing_tags))


def _target_selector(args) -> DataSourceParam:
    sel = DataSourceParam(
        alignment_space=args.alignment_space,
        libraries=list(args.targets_libraries or []),
        names=list(args.targets_published_names or []),
        mip_ids=list(args.targets_mips or []),
        datasets=set(args.targets_datasets or []),
        tags=set(args.targets_tags or []),
        annotations=set(args.targets_terms or []),
        excluded_annotations=set(args.excluded_targets_terms or []),
        processing_tags=_ptags(args.targets_processing_tags))
    return sel if not _selector_empty(sel) else None


def _selector_empty(s: DataSourceParam) -> bool:
    return not (s.alignment_space or s.libraries or s.names or s.mip_ids
                or s.datasets or s.tags or s.excluded_tags or s.annotations
                or s.excluded_annotations or s.processing_tags)


def _scores_filter(args) -> ScoresFilter:
    flt = ScoresFilter()
    if not args.include_matches_with_gradscore:
        # -1 sentinel: NONE of the fields has a score — by default only
        # matches not yet gradient-scored are deleted
        # (DeleteCDMatchesCmd.java:320-324)
        flt.add("gradientAreaGap|bidirectionalAreaGap", -1)
    return flt


def _match_passes(args, m, target_sel, flt) -> bool:
    if not flt.empty and not flt.matches(m):
        return False
    if args.match_tags and not (set(args.match_tags) & set(m.tags or ())):
        return False
    if args.max_matching_pixels is not None \
            and (m.matching_pixels or 0) >= args.max_matching_pixels:
        return False
    if target_sel is not None and m.matched_image is not None \
            and not target_sel.matches_entity(m.matched_image):
        return False
    return True


def run(args: argparse.Namespace) -> int:
    if args.db:
        return _run_db(args)
    reader = JSONNeuronMatchesReader(args.matchesDir)
    mask_sel = _mask_selector(args)
    target_sel = _target_selector(args)
    flt = _scores_filter(args)
    n_deleted = 0
    for mip_id in reader.list_match_locations([mask_sel]):
        path = os.path.join(args.matchesDir, f"{mip_id}.json")
        matches = reader.read_matches_by_mask(
            DataSourceParam(mip_ids=[mip_id]))
        # list_match_locations only filters by mip id; apply the full
        # mask selector host-side (skip files whose inputImage fails it)
        # so e.g. --masks-libraries never deletes other libraries'
        # matches (DeleteCDMatchesCmd.java:52-92 mask selection)
        if matches and matches[0].mask_image is not None \
                and not mask_sel.matches_entity(matches[0].mask_image):
            continue
        keep = [m for m in matches
                if not _match_passes(args, m, target_sel, flt)]
        n_deleted += len(matches) - len(keep)
        if args.dry_run or len(keep) == len(matches):
            continue
        if keep:
            JSONNeuronMatchesWriter(args.matchesDir).write(keep)
        else:
            os.remove(path)
    LOG.info("%s %d matches", "would delete" if args.dry_run else "deleted",
             n_deleted)
    return 0


def _run_db(args: argparse.Namespace) -> int:
    """DB path: partitioned mask selection, filtered id collection,
    batched archive+delete (DeleteCDMatchesCmd.deleteAllCDMatches)."""
    from .backends import get_store
    from ..dataio.db import DBNeuronMatchesReader
    store = get_store(args.db)
    mask_sel = _mask_selector(args)
    target_sel = _target_selector(args)
    flt = _scores_filter(args)
    masks = store.find_neurons(mask_sel)
    if _selector_empty(mask_sel):
        pass  # empty selector = all masks with matches (legacy behavior)
    elif not masks:
        LOG.info("No masks were selected")
        return 0
    reader = DBNeuronMatchesReader(store) if hasattr(store, "_conn") \
        else _mongo_reader(store)
    part = max(args.processingPartitionSize, 1)
    mask_mips = sorted({e.mip_id for e in masks if e.mip_id}) if masks \
        else reader.list_match_locations([DataSourceParam()])
    n_deleted = 0
    n_would = 0
    pending_ids = []

    def flush():
        nonlocal n_deleted, n_would, pending_ids
        if not pending_ids:
            return
        if args.dry_run:
            n_would += len(pending_ids)
            LOG.info("dry run: would delete %d matches (batch)",
                     len(pending_ids))
        else:
            n_deleted += store.delete_matches_by_ids(
                pending_ids, archive=not args.no_archive)
        pending_ids = []

    for p0 in range(0, len(mask_mips), part):
        batch = mask_mips[p0:p0 + part]
        matches = reader.read_matches_by_mask(
            DataSourceParam(mip_ids=batch))
        for m in matches:
            if _match_passes(args, m, target_sel, flt) \
                    and m.entity_id is not None:
                pending_ids.append(m.entity_id)
                if len(pending_ids) >= args.delete_batch_size:
                    flush()
    if args.dry_run:
        flush()
        LOG.info("dry run complete: would delete %d matches total", n_would)
        return 0
    flush()
    LOG.info("deleted %d matches%s", n_deleted,
             "" if args.no_archive else " (archived)")
    return 0


def _mongo_reader(store):
    from ..dataio.db import DBNeuronMatchesReader
    return DBNeuronMatchesReader(store)
