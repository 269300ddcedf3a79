"""validateDBData command: consistency checks of entities vs files.

Counterpart of cmd/ValidateNBDBDataCmd.java:49-370:
- neuron selection by alignment space / libraries / samples / releases /
  tags / names / mipIds with paged offset+size reads,
- per-entity checks: publishedName validity, the compute-file matrix
  (SourceColorDepthImage + InputColorDepthImage, plus GradientImage +
  ZGapImage unless --no-grad-files-check) with on-disk existence,
- optional JACS library-membership cross-check (--jacs-url; the
  reference's CachedDataHelper/JacsDataGetter path) incl.
  --excluded-libraries containment,
- findings persisted into NeuronEntity.validationErrors (and CLEARED
  when a previously-failing entity re-validates clean), optional
  --error-tag stamped on failing entities and (via
  --apply-error-tag-to-em-cdmatches / --apply-error-tag-to-lm-cdmatches)
  onto their matches,
- dangling-reference scan of the match table (mask/target refs that no
  longer resolve to a neuron row).

Copy of `colormipsearch_tpu/cmd/validate_cmd.py`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..dataio import DataSourceParam, JSONCDMIPsReader
from ..mips.loader import filedata_exists
from ..model import ComputeFileType

LOG = logging.getLogger(__name__)

from .args import add_common_args

_PAGE = 1000


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("validateDBData",
                              help="validate entities vs files on disk")
    add_common_args(p)
    p.add_argument("--mips-file", default=None)
    p.add_argument("--db", default=None,
                   help="validate neurons from this store instead of a "
                        "JSON file")
    p.add_argument("-as", "--alignment-space", default=None)
    p.add_argument("-l", "--library", nargs="*", default=[])
    p.add_argument("--validated-samples", nargs="*", default=[],
                   help="restrict to these source sample/body ref IDs")
    p.add_argument("--validated-releases", nargs="*", default=[],
                   help="restrict to these dataset labels")
    p.add_argument("--validated-tags", nargs="*", default=[])
    p.add_argument("--validated-names", nargs="*", default=[])
    p.add_argument("--validated-mips", nargs="*", default=[])
    p.add_argument("--excluded-libraries", nargs="*", default=[],
                   help="JACS libraries the MIP must NOT also be part of "
                        "(requires --jacs-url)")
    p.add_argument("--jacs-url", "--data-url", dest="jacs_url", default=None)
    p.add_argument("--authorization", default=None)
    p.add_argument("--no-grad-files-check", action="store_true",
                   help="skip GradientImage/ZGapImage attribute checks")
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("--size", type=int, default=0)
    p.add_argument("--error-tag", default=None,
                   help="tag failing entities (and optionally their "
                        "matches) with this tag")
    p.add_argument("--apply-error-tag-to-em-cdmatches", action="store_true")
    p.add_argument("--apply-error-tag-to-lm-cdmatches", action="store_true")
    p.add_argument("--check-file-existence", action="store_true",
                   default=True,
                   help="verify compute files on disk (default on)")
    p.add_argument("--no-check-file-existence", dest="check_file_existence",
                   action="store_false")
    p.add_argument("--check-matches", action="store_true",
                   help="also scan the match table for dangling "
                        "mask/target references (DB mode)")
    p.add_argument("--error-report", default=None)
    p.set_defaults(func=run)


def _required_file_types(args):
    req = [ComputeFileType.SourceColorDepthImage,
           ComputeFileType.InputColorDepthImage]
    if not args.no_grad_files_check:
        req += [ComputeFileType.GradientImage, ComputeFileType.ZGapImage]
    return req


def _validate_entity(e, args, jacs_mips) -> list:
    """Error strings for one entity (validateNeuronEntity +
    checkComputeFile, ValidateNBDBDataCmd.java:287-337)."""
    errors = []
    if not e.published_name or e.published_name == \
            DataSourceParam.NO_CONSENSUS:
        errors.append("missing publishedName")
    if jacs_mips is not None:
        jm = jacs_mips.get(e.mip_id)
        if jm is None:
            errors.append(f"No color depth mip in JACS for MIP {e.mip_id}")
        else:
            libs = set(jm.libraries or [])
            if e.library_name not in libs:
                errors.append(
                    f"MIP {e.mip_id} is in {sorted(libs)} but not in the "
                    f"{e.library_name} library")
            bad = libs & set(args.excluded_libraries or [])
            if bad:
                errors.append(
                    f"MIP {e.mip_id} is also in {sorted(bad)} libraries")
    for cft in _required_file_types(args):
        fd = e.compute_files.get(cft)
        if fd is None:
            errors.append(f"Missing attribute for file type {cft.name}")
        elif args.check_file_existence and fd.file_name and \
                not filedata_exists(fd):
            # zip-entry aware (NeuronMIPUtils.exists,
            # ValidateNBDBDataCmd.java:326-337)
            errors.append(
                f"Compute file type {cft.name}:{fd.name} was not found")
    return errors


def _jacs_mips_by_id(args, mip_ids):
    """mipId -> JACS ColorDepthMIP (library membership); fetched by id
    like the reference's JacsDataGetter.retrieveCDMIPs."""
    if not args.jacs_url:
        return None
    from ..jacs.client import JacsClient
    client = JacsClient(args.jacs_url, authorization=args.authorization)
    mips = client.retrieve_color_depth_mips_with_samples(
        None, None, mip_ids=sorted(m for m in mip_ids if m))
    return {m.id: m for m in mips if m.id}


def _iter_entity_pages(args, store):
    """Paged reads so 100k+-neuron stores never load wholesale
    (PagedRequest semantics, ValidateNBDBDataCmd.java:193-199)."""
    base = dict(
        alignment_space=args.alignment_space,
        libraries=list(args.library or []),
        mip_ids=list(args.validated_mips or []),
        names=list(args.validated_names or []),
        source_ref_ids=set(args.validated_samples or []),
        datasets=set(args.validated_releases or []),
        tags=set(args.validated_tags or []))
    start = max(args.offset, 0)
    remaining = args.size if args.size > 0 else None
    while True:
        page = _PAGE if remaining is None else min(_PAGE, remaining)
        if page <= 0:
            return
        sel = DataSourceParam(offset=start, size=page, **base)
        if store is not None:
            batch = store.find_neurons(sel)
        else:
            batch = JSONCDMIPsReader(args.mips_file).read_mips(sel)
        if not batch:
            return
        yield batch
        start += page
        if remaining is not None:
            remaining -= len(batch)
        if len(batch) < page:
            return


def _tag_matches_of(store, entities, tag, by_mask: bool, by_target: bool):
    """Server-side bulk tagging of a bad neuron's matches — ONE
    update_many with $addToSet on Mongo, no match docs cross the wire
    (NeuronMatchesDao.updateAll, ValidateNBDBDataCmd.java:355-369)."""
    from ..dataio.base import AppendField
    refs = [e.entity_id for e in entities if e.entity_id is not None]
    if not refs:
        return 0
    return store.update_matches_fields_by_refs(
        mask_refs=refs if by_mask else None,
        matched_refs=refs if by_target else None,
        updates={"tags": AppendField({tag})})


def run(args: argparse.Namespace) -> int:
    if not args.mips_file and not args.db:
        LOG.error("--mips-file or --db required")
        return 1
    store = None
    if args.db:
        from .backends import get_store
        store = get_store(args.db)

    report = []
    failing, corrected = [], []
    n_entities = 0
    for batch in _iter_entity_pages(args, store):
        n_entities += len(batch)
        jacs_mips = _jacs_mips_by_id(
            args, [e.mip_id for e in batch if e.mip_id]) \
            if args.jacs_url else None
        changed = []
        for e in batch:
            errors = _validate_entity(e, args, jacs_mips)
            eid = e.mip_id or str(e.entity_id)
            if errors:
                report.extend({"entity": eid, "error": err}
                              for err in errors)
                e.validation_errors = set(errors)
                if args.error_tag:
                    e.tags.add(args.error_tag)
                failing.append(e)
                changed.append(e)
            elif e.validation_errors:
                # previously invalid, now clean: clear persisted errors
                e.validation_errors = set()
                corrected.append(e)
                changed.append(e)
        if store is not None and changed:
            # field-handler updates, never whole-doc replaces: errors
            # $addToSet validationErrors (+ error tag), corrections
            # $unset validationErrors (processValidationReport,
            # ValidateNBDBDataCmd.java:343-354; NB the reference also
            # addToSets the error tag onto CORRECTED entities — a
            # copy-paste slip we deliberately do not replicate)
            from ..dataio.base import AppendField, UnsetField
            for e in changed:
                if e.entity_id is None:
                    continue
                if e.validation_errors:
                    upd = {"validationErrors":
                           AppendField(sorted(e.validation_errors))}
                    if args.error_tag:
                        upd["tags"] = AppendField({args.error_tag})
                else:
                    upd = {"validationErrors": UnsetField()}
                store.update_entity_fields("neurons", e.entity_id, upd)

    if store is not None and args.error_tag and failing:
        n = _tag_matches_of(store, failing, args.error_tag,
                            args.apply_error_tag_to_em_cdmatches,
                            args.apply_error_tag_to_lm_cdmatches)
        if n:
            LOG.info("tagged %d matches with %r", n, args.error_tag)

    if store is not None and args.check_matches:
        for mask_ref, matched_ref in store.find_dangling_match_refs():
            report.append({"entity": f"match {mask_ref}->{matched_ref}",
                           "error": "dangling neuron reference"})

    LOG.info("validated %d entities: %d with errors, %d corrected",
             n_entities, len(failing), len(corrected))
    if args.error_report:
        with open(args.error_report, "w") as f:
            json.dump(report, f, indent=2)
    for err in report[:50]:
        LOG.warning("%s: %s", err["entity"], err["error"])
    return 1 if report else 0
