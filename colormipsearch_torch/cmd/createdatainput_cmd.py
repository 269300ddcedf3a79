"""createColorDepthSearchDataInput command: build MIP input JSON.

Counterpart of cmd/CreateCDSDataInputCmd.java:58-798. Two sources:
- local MIP stores (directories/zips): entities built from the CDM files
  with variant resolution by naming convention (the reference's indexed
  MIPsHandlingUtils lookup)
- JACS REST (--jacs-url): paged /colorDepthMIPsWithSamples retrieval
  (requires network; unavailable in air-gapped deployments)

Copy of `colormipsearch_tpu/cmd/createdatainput_cmd.py`.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
from typing import Optional

from ..dataio import JSONCDMIPsWriter
from ..model import (ComputeFileType, EMNeuronEntity, FileData, Gender,
                     LMNeuronEntity)
from ..persist import TimebasedIdGenerator
from .args import add_common_args
from .mipstores import (extract_channel, extract_em_body_id,
                        extract_lm_slide_code, extract_objective,
                        index_mip_stores, is_em_library, list_store_images,
                        lookup_variant_images)

LOG = logging.getLogger(__name__)

# variant type name -> ComputeFileType (CreateCDSDataInputCmd.java:111-127)
DEFAULT_VARIANT_MAPPING = {
    "cdm": ComputeFileType.InputColorDepthImage,
    "searchable_neurons": ComputeFileType.InputColorDepthImage,
    "segmentation": ComputeFileType.InputColorDepthImage,
    "grad": ComputeFileType.GradientImage,
    "gradient": ComputeFileType.GradientImage,
    "zgap": ComputeFileType.ZGapImage,
    "rgb": ComputeFileType.ZGapImage,
    "junk": ComputeFileType.JunkImage,
}


def add_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "createColorDepthSearchDataInput",
        help="build MIP input JSON from local stores or JACS")
    add_common_args(p)
    p.add_argument("--library", required=True,
                   help="library name (flyem*/flywire* => EM)")
    p.add_argument("--alignment-space", "-as", default="JRC2018_Unisex_20x_HR")
    p.add_argument("--cdm-location", nargs="+", default=[],
                   help="dir(s)/zip(s) with source CDM images")
    p.add_argument("--variant", action="append", default=[],
                   help="variant spec '<type>:<location>' (grad:…, zgap:…, searchable_neurons:…)")
    p.add_argument("--included-published-names", nargs="*", default=[],
                   help="only import these published names "
                        "(CreateCDSDataInputCmd.java:150)")
    p.add_argument("--excluded-neurons", nargs="*", default=[],
                   help="skip these neuron names "
                        "(CreateCDSDataInputCmd.java:162)")
    p.add_argument("--jacs-url", default=None)
    p.add_argument("--authorization", default=None)
    p.add_argument("--output-filename", default=None)
    p.add_argument("--db", default=None,
                   help="write imported neurons into this store (SQLite "
                        "path or mongodb:// URI) via the checked upsert "
                        "writer instead of a JSON file — the reference's "
                        "production flow (CreateCDSDataInputCmd.java:"
                        "237-260 via DBCheckedCDMIPsWriter)")
    p.add_argument("--tag", default=None,
                   help="stamp every imported entity with this tag "
                        "(CreateCDSDataInputCmd.java:626)")
    p.add_argument("--junk-tag", default="junk",
                   help="tag applied to junk-variant entities")
    p.add_argument("--match-neuron-state", action="store_true",
                   help="EM variants must match the source CDM's "
                        "neuron-state filename component "
                        "(MIPsHandlingUtils.java:138-148)")
    p.add_argument("--datasets", nargs="*", default=[],
                   help="JACS dataset filters")
    p.add_argument("--releases", nargs="*", default=[],
                   help="JACS release filters")
    p.add_argument("--included-mips", nargs="*", default=[],
                   help="JACS mipId filters")
    p.set_defaults(func=run)


def _dup_entity(e):
    """Per-searchable-variant entity duplication
    (AbstractNeuronEntity.duplicate; one input entity per segmented
    image, CreateCDSDataInputCmd.java:395-414)."""
    import copy
    d = copy.deepcopy(e)
    return d


def _entity_for_image(name: str, args, idgen) -> Optional[object]:
    stem = re.sub(r"\..*$", "", os.path.basename(name))
    em = is_em_library(args.library)
    if em:
        body_id = extract_em_body_id(stem)
        e = EMNeuronEntity()
        e.published_name = body_id or stem
    else:
        slide_code = extract_lm_slide_code(stem)
        e = LMNeuronEntity()
        e.slide_code = slide_code
        # populateLMDataFromFileName (CreateCDSDataInputCmd.java:779-798):
        # internal line name = first '-' component (may carry PI
        # initials); published name = the line with PI initials stripped
        line = stem.split("-")[0] if "-" in stem else stem
        e.internal_line_name = line
        pi_sep = line.find("_")
        e.published_name = (line[pi_sep + 1:] if pi_sep != -1 else line) \
            or "Unknown"
        e.objective = extract_objective(stem, args.alignment_space)
        gm = re.search(r"[-_]([mf])[-_]", stem)
        e.gender = Gender.from_val(gm.group(1)) if gm else None
    e.entity_id = idgen.generate_id()
    e.mip_id = str(e.entity_id)
    e.alignment_space = args.alignment_space
    e.library_name = args.library
    return e


def _populate_other_compute_files(e, variant_indexes, em: bool, args):
    """Resolve gradient/zgap/other variants for the entity's SEARCHABLE
    image (populateOtherComputeFilesFromInput,
    CreateCDSDataInputCmd.java:436-540): prefer a variant whose basename
    matches the searchable image's exactly (this pairs mirrored *_FL
    segmentations with their own grad/zgap files), then fall back to an
    objective-compatible candidate under the same neuron id."""
    from .mipstores import match_objectives
    fd = e.compute_files.get(ComputeFileType.InputColorDepthImage)
    if fd is None:
        return

    def base(name):
        return re.sub(r"(?:_CDM)?\..*$", "", os.path.basename(name))

    searchable_base = base(fd.file_name or "")
    nid = e.neuron_id or ""
    obj = getattr(e, "objective", None)
    for ftype, index in variant_indexes.items():
        cands = index.get(nid, [])
        if not cands:
            continue
        pick = None
        for c in cands:
            cb = base(c.entry_name)
            if cb == searchable_base or searchable_base in cb:
                pick = c
                break
        if pick is None:
            for c in cands:
                cobj = extract_objective(c.entry_name.replace(nid, ""),
                                         args.alignment_space)
                if em or match_objectives(obj, cobj):
                    pick = c
                    break
        if pick is not None:
            e.compute_files[ftype] = pick.file_data()


def run(args: argparse.Namespace) -> int:
    if args.jacs_url:
        return _run_jacs_import(args)
    em = is_em_library(args.library)
    idgen = TimebasedIdGenerator()

    variant_locations = {}
    for v in args.variant:
        vtype, _, loc = v.partition(":")
        ftype = DEFAULT_VARIANT_MAPPING.get(vtype.lower())
        if ftype is None:
            LOG.warning("unknown variant type %s", vtype)
            continue
        variant_locations.setdefault(ftype, []).append(loc)
    variant_indexes = {ftype: index_mip_stores(locs, em)
                       for ftype, locs in variant_locations.items()}

    included = set(args.included_published_names or [])
    excluded = set(args.excluded_neurons or [])
    searchable_index = variant_indexes.pop(
        ComputeFileType.InputColorDepthImage, {})
    junk_index = variant_indexes.pop(ComputeFileType.JunkImage, {})
    entities = []
    for loc in args.cdm_location:
        for entry in list_store_images(loc):
            e = _entity_for_image(entry.entry_name, args, idgen)
            if e is None:
                continue
            # include/exclude filters
            # (CreateCDSDataInputCmd.java:150,162,365-380)
            if included and e.published_name not in included:
                continue
            if excluded and (e.published_name in excluded
                             or (e.neuron_id or "") in excluded):
                continue
            e.compute_files[ComputeFileType.SourceColorDepthImage] = entry.file_data()
            nid = e.neuron_id or ""
            ch = extract_channel(entry.entry_name)
            obj = extract_objective(entry.entry_name, args.alignment_space)

            def variants_of(index):
                return lookup_variant_images(
                    nid, index, em, ch, obj, args.alignment_space,
                    match_neuron_state=args.match_neuron_state,
                    source_cdm_name=entry.entry_name)

            # ONE input entity per matched searchable/junk image
            # (flatMap duplication, CreateCDSDataInputCmd.java:395-414);
            # with no searchable variants configured the source CDM
            # itself is searchable (deviation from the reference, which
            # REQUIRES a searchable_neurons variant and drops neurons
            # without one — a fallback is strictly more usable and the
            # produced entity is identical when variants exist)
            produced = []
            for s in variants_of(searchable_index):
                d = _dup_entity(e)
                d.compute_files[ComputeFileType.InputColorDepthImage] = \
                    s.file_data()
                produced.append(d)
            if not produced and not searchable_index:
                d = _dup_entity(e)
                d.compute_files[ComputeFileType.InputColorDepthImage] = \
                    entry.file_data()
                produced.append(d)
            for j in variants_of(junk_index):
                d = _dup_entity(e)
                d.compute_files[ComputeFileType.InputColorDepthImage] = \
                    j.file_data()
                d.tags.add(args.junk_tag)
                produced.append(d)
            for d in produced:
                d.entity_id = idgen.generate_id()
                d.mip_id = str(d.entity_id)
                _populate_other_compute_files(d, variant_indexes, em, args)
                if args.tag:
                    d.tags.add(args.tag)
                entities.append(d)

    _write_entities(args, entities)
    return 0


def _write_entities(args, entities) -> None:
    """Persist imported neurons: checked store upsert with --db
    (DBCheckedCDMIPsWriter), JSON file otherwise."""
    if getattr(args, "db", None):
        from ..dataio.db import DBCDMIPsWriter
        from .backends import get_store
        w = DBCDMIPsWriter(get_store(args.db))
        w.open()
        w.write(entities)
        w.close()
        LOG.info("wrote %d entities to store %s", len(entities), args.db)
        return
    out = args.output_filename or os.path.join(
        args.output_dir or ".", f"{args.library.replace(' ', '_')}.json")
    w = JSONCDMIPsWriter(out)
    w.open()
    w.write(entities)
    w.close()
    LOG.info("wrote %d entities to %s", len(entities), out)


def _run_jacs_import(args) -> int:
    """Paged JACS REST import (CreateCDSDataInputCmd.java:249-260,
    646-678) through the typed client (jacs/client.py): full sample /
    em-body metadata mapping, retries, auth header."""
    from ..jacs import JacsClient, em_neuron_from_mip, lm_neuron_from_mip

    idgen = TimebasedIdGenerator()
    em = is_em_library(args.library)
    client = JacsClient(args.jacs_url, authorization=args.authorization)
    try:
        mips = client.retrieve_color_depth_mips_with_samples(
            args.library, args.alignment_space,
            datasets=args.datasets, releases=args.releases,
            mip_ids=args.included_mips)
    except RuntimeError as e:
        LOG.error("JACS request failed: %s", e)
        return 1
    included = set(args.included_published_names or [])
    excluded = set(args.excluded_neurons or [])
    entities = []
    for mip in mips:
        e = (em_neuron_from_mip(mip, args.library, args.alignment_space)
             if em else
             lm_neuron_from_mip(mip, args.library, args.alignment_space))
        if included and e.published_name not in included:
            continue
        if excluded and (e.published_name in excluded
                         or (e.neuron_id or "") in excluded):
            continue
        if args.tag:
            e.tags.add(args.tag)
        e.entity_id = idgen.generate_id()
        entities.append(e)
    _write_entities(args, entities)
    return 0
