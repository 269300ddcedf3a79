"""exportData command: NeuronBridge-style JSON export.

Copy of `colormipsearch_tpu/cmd/exportdata_cmd.py`.

Counterpart of cmd/ExportData4NBCmd.java + cmd/dataexport/*.java. Result
types (cmd/ExportedResultType.java:3-12): EM_CD_MATCHES, LM_CD_MATCHES,
EM_PPP_MATCHES, EM_MIPS, LM_MIPS. Per mask: read matches, keep the best
match per (maskMIP, targetMIP) pair by normalizedScore
(AbstractCDMatchesExporter.selectBestMatchPerMIPPair,
cmd/dataexport/AbstractCDMatchesExporter.java:108-125), convert entities
to export metadata (dto/AbstractNeuronMetadata.java fields), and write
grouped ResultMatches JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List

from ..dataio import DataSourceParam
from ..model import CDMatchEntity, NeuronEntity
from .args import add_common_args

LOG = logging.getLogger(__name__)

EXPORT_TYPES = ("EM_CD_MATCHES", "LM_CD_MATCHES", "EM_PPP_MATCHES",
                "EM_MIPS", "LM_MIPS")


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("exportData", help="export for NeuronBridge")
    add_common_args(p)
    p.add_argument("--exported-result-type", required=True,
                   choices=EXPORT_TYPES)
    p.add_argument("-md", "--matchesDir", default=None,
                   help="per-mask matches dir (CD/PPP matches export)")
    p.add_argument("--db", default=None,
                   help="read matches from this SQLite store")
    p.add_argument("--mips-file", default=None, help="MIP JSON (MIPs export)")
    p.add_argument("--default-relative-url-index", type=int, default=-1,
                   help="path component the relative URLs start at "
                        "(ExportData4NBCmd.java:115-117; -1 = keep absolute)")
    p.add_argument("--relative-url-indexes-by-filetype", nargs="*",
                   default=[], metavar="FILETYPE=INDEX[,nonhttp]",
                   help="per-FileType URL index overrides "
                        "(ExportData4NBCmd.java:119-123)")
    p.add_argument("--default-image-store", default=None,
                   help="default NeuronBridge image store "
                        "(ExportData4NBCmd.java:162)")
    p.add_argument("--image-stores-per-neuron-meta", nargs="*", default=[],
                   metavar="ALIGNMENTSPACE[:LIBRARY]=STORE",
                   help="image store overrides keyed by alignment space "
                        "and optional library (ExportData4NBCmd.java:165-172)")
    p.add_argument("--published-urls", default=None,
                   help="published-URLs JSON (publishedURLs collection "
                        "shape: [{id, uploaded:{cdm, cdm_thumbnail, ...}}]); "
                        "merged into exported files maps "
                        "(ColorDepthMIP.updateEMNeuron/updateLMNeuron)")
    p.add_argument("--published-lm-stacks", default=None,
                   help="published LM stacks JSON keyed by slideCode "
                        "(publishedLMImages analogue; sets "
                        "VisuallyLosslessStack / Gal4Expression)")
    p.add_argument("--published-lm-images", default=None,
                   help="offline PublishedLMImage docs JSON (list of "
                        "{sampleRef, alignmentSpace, files,...}; the "
                        "publishedLMImage store is used when --db is "
                        "given and this arg is absent) — PPP export's "
                        "LM 3D-stack source (EMPPPMatchesExporter"
                        ".retrieveEMAndLMSourceData:160-169)")
    p.add_argument("--pppm-urls", default=None,
                   help="offline PPPmURLs docs JSON (list of {id, "
                        "uploadedFiles, uploadedThumbnails}, keyed by "
                        "PPP match id or sourceEmName-sourceLmName); "
                        "the pppmURL store is used when --db is given "
                        "and this arg is absent (PPPmURLs.java:11-32)")
    p.add_argument("--jacs-samples-file", default=None,
                   help="offline LM sample docs JSON (list of CDMIPSample "
                        "dicts with a `name` field) for PPP target "
                        "enrichment; with --jacs-url samples are fetched "
                        "live (JacsDataGetter.retrieveLMSamplesByName)")
    p.add_argument("--published-alignment-space-alias", nargs="*",
                   default=[], metavar="SPACE=ALIAS",
                   help="alignment-space aliases accepted when matching "
                        "published LM images "
                        "(ExportData4NBCmd.java:84-87,256-259)")
    p.add_argument("--size", type=int, default=-1,
                   help="cap matches per mask")
    p.add_argument("--max-matched-targets", type=int, default=-1,
                   help="cap exported matches per input MIP after "
                        "ordering by normalizedScore "
                        "(AbstractCDMatchesExporter.limitMatches)")
    p.add_argument("--max-matches-with-same-name-per-mip", type=int,
                   default=-1,
                   help="cap matches sharing one target publishedName "
                        "per input MIP (limitMatches grouping)")
    p.add_argument("--jacs-mips-file", default=None,
                   help="offline ColorDepthMIP docs JSON (the "
                        "CachedDataHelper fixture): enriches exported "
                        "neurons with sample/body publishing metadata "
                        "(ColorDepthMIP.updateEMNeuron/updateLMNeuron)")
    p.add_argument("--jacs-url", default=None,
                   help="LIVE CachedDataHelper: fetch ColorDepthMIP "
                        "docs by id from this JACS data service during "
                        "export (JacsDataGetter.httpRetrieveCDMIPs); "
                        "--jacs-mips-file takes precedence when both "
                        "are given")
    p.add_argument("--authorization", default=None,
                   help="Authorization header for --jacs-url")
    p.add_argument("--jacs-read-batch-size", type=int, default=5000,
                   help="MIP ids per JACS fetch (readBatchSize)")
    p.add_argument("--config-url", default=None,
                   help="NeuronBridge config service base URL: fetches "
                        "the internal->display library-name mapping from "
                        "{configURL}/cdm_library and applies it to "
                        "exported libraryName fields "
                        "(ExportData4NBCmd.java:67,264; "
                        "JacsDataGetter.retrieveLibraryNameMapping)")
    p.add_argument("--library-name-mapping", default=None,
                   help="offline {internalLibrary: displayName} JSON "
                        "(the cdm_library config fixture); takes "
                        "precedence over --config-url")
    p.add_argument("--target-libraries", nargs="*", default=[])
    p.add_argument("--target-tags", nargs="*", default=[])
    p.add_argument("--target-excluded-tags", nargs="*", default=[])
    p.add_argument("--target-annotations", nargs="*", default=[])
    p.add_argument("--target-excluded-annotations", nargs="*", default=[])
    p.add_argument("--matches-excluded-tags", nargs="*", default=[],
                   help="drop matches carrying any of these tags")
    p.add_argument("--validation", choices=("required", "off"),
                   default="required",
                   help="required-attribute validation of exported "
                        "metadata; failing ITEMS are dropped with an "
                        "error log, the run continues (the reference's "
                        "Jackson ValidatingSerializer over "
                        "dto/AbstractNeuronMetadata @NotBlank fields)")
    p.set_defaults(func=run)


# the reference's always-on @NotBlank/@NotNull DTO constraints
# (dto/AbstractNeuronMetadata.java:98-157, LMNeuronMetadata.java:18,27);
# mipId is the WithAllRequiredAttrs group's extra field, checked too
# because every CD export carries MIPs
REQUIRED_EXPORT_ATTRS = ("mipId", "libraryName", "publishedName",
                         "alignmentSpace", "anatomicalArea")
REQUIRED_LM_ATTRS = ("slideCode", "objective", "gender")

# EM anatomical areas are derived from the alignment space when the
# body record carries none (ColorDepthMIP.getAnatomicalAreaFromAlignmentSpace)
_AREA_BY_ALIGNMENT_SPACE = {"JRC2018_Unisex_20x_HR": "Brain",
                            "JRC2018_VNC_Unisex_40x_DS": "VNC"}


def anatomical_area_from_alignment_space(space) -> str:
    return _AREA_BY_ALIGNMENT_SPACE.get(space or "", "Brain")


def _enrich_from_jacs_mip(e: NeuronEntity, d: Dict, files: Dict,
                          jacs_mips) -> None:
    """Offline CachedDataHelper enrichment: overlay publishing metadata
    from the neuron's JACS ColorDepthMIP doc
    (ColorDepthMIP.updateEMNeuron:249-272 / updateLMNeuron:209-221)."""
    mip = jacs_mips.get(e.mip_id or "")
    if mip is None:
        return
    if type(e).__name__.startswith("EM"):
        if mip.body_id is not None:
            d["publishedName"] = mip.em_body_id()
        if mip.neuron_instance:
            d["neuronInstance"] = mip.neuron_instance
        if mip.neuron_type:
            d["neuronType"] = mip.neuron_type
        return
    if mip.lm_line_name():
        d["publishedName"] = mip.lm_line_name()
    if mip.lm_gender():
        d["gender"] = mip.lm_gender()
    if mip.lm_slide_code():
        d["slideCode"] = mip.lm_slide_code()
    if mip.anatomical_area:
        d["anatomicalArea"] = mip.anatomical_area
    if mip.objective:
        d["objective"] = mip.objective
    if mip.sample_3d_stack:
        files["VisuallyLosslessStack"] = mip.sample_3d_stack
    if mip.sample_gal4_expression:
        files["Gal4Expression"] = mip.sample_gal4_expression


def neuron_metadata(e: NeuronEntity, url_transformer=None,
                    image_store_mapping=None, published_urls=None,
                    published_lm_stacks=None, jacs_mips=None,
                    library_names=None) -> Dict:
    """Entity -> export metadata (entity.metadata() analogue;
    dto/AbstractNeuronMetadata.java:43-61). When transformers are given,
    file URLs are relativized per FileType and the FileType.store entry
    is set from the image-store mapping (AbstractDataExporter.java:76-84,
    applied BEFORE any library-name remap so the mapping keys on the
    internal library name)."""
    is_em = type(e).__name__.startswith("EM")
    d: Dict = {"mipId": e.mip_id,
               "libraryName": e.library_name,
               "publishedName": e.published_name,
               "alignmentSpace": e.alignment_space}
    for attr, key in (("gender", "gender"),
                      ("anatomical_area", "anatomicalArea"),
                      ("objective", "objective"),
                      ("slide_code", "slideCode"),
                      ("neuron_type", "neuronType"),
                      ("neuron_instance", "neuronInstance")):
        v = getattr(e, attr, None)
        if v is not None:
            d[key] = v.name if hasattr(v, "name") and attr == "gender" else v
    if is_em and not d.get("anatomicalArea"):
        # EM bodies derive the area from the alignment space
        # (ColorDepthMIP.updateEMNeuron:257-263)
        d["anatomicalArea"] = anatomical_area_from_alignment_space(
            e.alignment_space)
    if e.neuron_terms:
        d["neuronTerms"] = list(e.neuron_terms)
    files = {t.name: v for t, v in sorted(e.files.items(),
                                          key=lambda kv: kv[0].name)} \
        if e.files else {}
    if jacs_mips is not None:
        _enrich_from_jacs_mip(e, d, files, jacs_mips)
    if published_urls:
        from .dataexport import apply_published_urls
        uploaded = published_urls.get(str(e.entity_id)) \
            or published_urls.get(e.mip_id or "")
        if uploaded:
            files = apply_published_urls(
                files, uploaded, type(e).__name__.startswith("EM"))
    if published_lm_stacks and not type(e).__name__.startswith("EM"):
        from .dataexport import apply_published_lm_stacks
        stacks = published_lm_stacks.get(
            str(getattr(e, "slide_code", None) or "")) \
            or published_lm_stacks.get(e.mip_id or "")
        if stacks:
            files = apply_published_lm_stacks(files, stacks)
    if image_store_mapping is not None:
        files["store"] = image_store_mapping.get_image_store(
            e.alignment_space, e.library_name)
    if url_transformer is not None:
        files = {t: (url_transformer.relativize_url(t, v)
                     if t != "store" else v)
                 for t, v in files.items()}
    if files:
        d["files"] = files
    if library_names:
        # display-name remap LAST: the image-store mapping above keys on
        # the INTERNAL library name (AbstractDataExporter.java:54-57
        # updateFileStore-before-setLibraryName ordering)
        d["libraryName"] = library_names.get(e.library_name,
                                             e.library_name)
    d["type"] = ("EMImage" if type(e).__name__.startswith("EM") else "LMImage")
    return d


def _load_library_names(args) -> Dict | None:
    """internal->display library-name mapping: offline JSON fixture or
    the live config service {configURL}/cdm_library
    (JacsDataGetter.retrieveLibraryNameMapping)."""
    path = getattr(args, "library_name_mapping", None)
    if path:
        with open(path) as f:
            return json.load(f)
    url = getattr(args, "config_url", None)
    if url:
        from ..jacs.client import retrieve_library_name_mapping
        return retrieve_library_name_mapping(url)
    return None


def build_transformers(args):
    """CLI args -> (URLTransformer, ImageStoreMapping|None, publishedURLs)
    (ExportData4NBCmd.java:285-293,399-407)."""
    from .dataexport import (URLTransformer, load_published_urls,
                             parse_file_type_indexes,
                             parse_image_store_mapping)
    url_t = URLTransformer(
        args.default_relative_url_index,
        parse_file_type_indexes(args.relative_url_indexes_by_filetype))
    store_m = None
    if args.default_image_store:
        store_m = parse_image_store_mapping(
            args.default_image_store, args.image_stores_per_neuron_meta)
    urls = None
    if getattr(args, "published_urls", None):
        urls = load_published_urls(args.published_urls)
    lm_stacks = None
    if getattr(args, "published_lm_stacks", None):
        from .dataexport import load_published_lm_stacks
        lm_stacks = load_published_lm_stacks(args.published_lm_stacks)
    # store-backed published data (PublishedURLsDao/PublishedLMImageDao,
    # DaosProvider.java:82-88): a DB-configured export reads the
    # publishedURL / publishedLMImage stores directly; explicit JSON
    # file args take precedence (the offline fallback)
    if getattr(args, "db", None):
        from .backends import get_store
        store = get_store(args.db)
        if urls is None and hasattr(store, "load_published_urls"):
            stored = store.load_published_urls()
            urls = stored or None
        if lm_stacks is None and hasattr(store, "load_published_lm_stacks"):
            stored = store.load_published_lm_stacks()
            lm_stacks = stored or None
    return url_t, store_m, urls, lm_stacks


def validate_export_metadata(d: Dict) -> List[str]:
    """Required-attribute validation per exported type: the reference
    rejects items with blank @NotBlank DTO fields via a Jackson
    ValidatingSerializer (cmd/dataexport/ValidatingSerializer.java:22-29
    over dto/AbstractNeuronMetadata + LMNeuronMetadata); here invalid
    ITEMS are dropped with an error log and the run continues."""
    missing = [k for k in REQUIRED_EXPORT_ATTRS if not d.get(k)]
    if d.get("type") == "LMImage":
        missing += [k for k in REQUIRED_LM_ATTRS if not d.get(k)]
    return missing


_SUSPICIOUS_RE = __import__("re").compile(r"Suspicious match from .+ import")


def _not_suspicious(m: CDMatchEntity) -> bool:
    """Matches tagged suspicious at import time (a missing neuron was
    artificially created) never export
    (AbstractCDMatchesExporter.doesNotLookSuspicious)."""
    return not any(_SUSPICIOUS_RE.search(t) for t in (m.tags or ()))


def select_best_match_per_mip_pair(matches: List[CDMatchEntity],
                                   excluded_tags=()) -> List[CDMatchEntity]:
    """Dedupe (maskMIP, targetMIP) pairs keeping max normalizedScore
    (AbstractCDMatchesExporter.java:108-125; first wins on ties).
    Matches without a normalized score, suspicious-import matches and
    matches carrying excluded tags are dropped first."""
    excluded = set(excluded_tags or ())
    best: Dict = {}
    for m in matches:
        if m.normalized_score is None:
            continue
        if not _not_suspicious(m):
            continue
        if excluded and (set(m.tags or ()) & excluded):
            continue
        key = (m.mask_image.mip_id if m.mask_image else None,
               m.matched_image.mip_id if m.matched_image else None)
        cur = best.get(key)
        if cur is None or m.normalized_score > cur.normalized_score:
            best[key] = m
    out = list(best.values())
    out.sort(key=lambda m: -(m.normalized_score or 0))
    return out


def limit_matches(matches: List[CDMatchEntity], matched_of,
                  max_same_name: int, max_targets: int
                  ) -> List[CDMatchEntity]:
    """limitMatches (AbstractCDMatchesExporter.java:126-151): cap the
    matches sharing one target publishedName per input MIP, then cap
    the total, both ordered by normalizedScore descending."""
    if max_same_name > 0:
        by_name: Dict = {}
        for m in matches:
            t = matched_of(m)
            by_name.setdefault(t.published_name if t else None,
                               []).append(m)
        kept = []
        for group in by_name.values():
            group.sort(key=lambda m: -(m.normalized_score or 0))
            kept.extend(group[:max_same_name])
        matches = kept
    matches = sorted(matches, key=lambda m: -(m.normalized_score or 0))
    if max_targets > 0:
        matches = matches[:max_targets]
    return matches


def _export_cd_matches(args, by_target: bool) -> int:
    """CD matches export. EM side groups per mask mip
    (EMCDMatchesExporter); LM side groups per TARGET mip with the
    match direction inverted — inputImage is the LM target, results
    are the EM masks (LMCDMatchesExporter over readMatchesByTarget)."""
    from .backends import matches_reader
    t_start = time.time()
    reader = matches_reader(args.db, args.matchesDir)
    url_t, store_m, pub_urls, lm_stacks = build_transformers(args)
    jacs_mips = _load_jacs_mips_fixture(args)
    lib_names = _load_library_names(args)
    target_sel = DataSourceParam(
        libraries=list(args.target_libraries or []),
        tags=set(args.target_tags or []),
        excluded_tags=set(args.target_excluded_tags or []),
        annotations=set(args.target_annotations or []),
        excluded_annotations=set(args.target_excluded_annotations or []))
    has_target_sel = any((target_sel.libraries, target_sel.tags,
                          target_sel.excluded_tags, target_sel.annotations,
                          target_sel.excluded_annotations))
    out_dir = args.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    n = n_dropped = 0
    if by_target:
        locations = reader.list_target_locations([DataSourceParam()])
    else:
        locations = reader.list_match_locations([DataSourceParam()])
    for mip_id in locations:
        if by_target:
            matches = reader.read_matches_by_target(
                DataSourceParam(mip_ids=[mip_id]))
        else:
            matches = reader.read_matches_by_mask(
                DataSourceParam(mip_ids=[mip_id]))

        def input_of(m):
            return m.matched_image if by_target else m.mask_image

        def matched_of(m):
            return m.mask_image if by_target else m.matched_image

        if has_target_sel:
            matches = [m for m in matches
                       if matched_of(m) is not None
                       and target_sel.matches_entity(matched_of(m))]
        selected = select_best_match_per_mip_pair(
            matches, excluded_tags=args.matches_excluded_tags)
        selected = limit_matches(selected, matched_of,
                                 args.max_matches_with_same_name_per_mip,
                                 args.max_matched_targets)
        if args.size > 0:
            selected = selected[:args.size]
        if not selected:
            continue
        _prefetch_jacs_mips(
            jacs_mips,
            [input_of(selected[0])] + [matched_of(m) for m in selected])

        def meta(e):
            return neuron_metadata(e, url_t, store_m, pub_urls, lm_stacks,
                                   jacs_mips=jacs_mips,
                                   library_names=lib_names)

        input_meta = meta(input_of(selected[0]))
        missing = validate_export_metadata(input_meta) \
            if args.validation != "off" else []
        if missing:
            LOG.warning("skipping export for %s: missing attrs %s",
                        mip_id, missing)
            n_dropped += len(selected)
            continue
        results = []
        for m in selected:
            image_meta = meta(matched_of(m))
            missing = validate_export_metadata(image_meta) \
                if args.validation != "off" else []
            if missing:
                LOG.warning("skipping match in %s: missing attrs %s",
                            mip_id, missing)
                n_dropped += 1
                continue
            r = {"image": image_meta,
                 "mirrored": m.mirrored,
                 "normalizedScore": m.normalized_score,
                 "matchingPixels": m.matching_pixels}
            files = ({t.name: v for t, v in m.match_files.items()}
                     if m.match_files else {})
            # per-match searchable-neuron URLs + store
            # (updateMatchedResultsMetadata,
            # AbstractCDMatchesExporter.java:164-210): CDMInput = the
            # INPUT side's published searchable URL, CDMMatch = the
            # matched side's; store follows the matched image
            if pub_urls:
                files.update(_match_files_from_published(
                    input_of(m), matched_of(m), pub_urls, url_t))
            if store_m is not None and image_meta.get("files", {}).get("store"):
                files["store"] = image_meta["files"]["store"]
            if files:
                r["files"] = files
            results.append(r)
        doc = {"inputImage": input_meta, "results": results}
        with open(os.path.join(out_dir, f"{mip_id}.json"), "w") as f:
            json.dump(doc, f, indent=2)
        n += len(results)
    LOG.info("exported %d matches (%d dropped by validation) in %.1fs", n,
             n_dropped, time.time() - t_start)
    return 0


def _match_files_from_published(input_e, matched_e, pub_urls, url_t):
    """CDMInput/CDMMatch from the published searchable_neurons URLs
    (AbstractCDMatchesExporter.updateMatchedResultsMetadata:176-205);
    absent URLs leave the file unset, exactly as the reference nulls
    the entry."""
    out = {}
    for e, key in ((input_e, "CDMInput"), (matched_e, "CDMMatch")):
        if e is None:
            continue
        uploaded = pub_urls.get(str(e.entity_id)) \
            or pub_urls.get(e.mip_id or "")
        url = (uploaded or {}).get("searchable_neurons")
        if url:
            out[key] = url_t.relativize_url(key, url) if url_t else url
    return out


def _load_jacs_mips_fixture(args):
    """CachedDataHelper source: the offline fixture JSON (a plain
    mipId -> ColorDepthMIP dict) when --jacs-mips-file is given, or a
    LIVE prefetching CachedDataHelper over --jacs-url (the reference's
    only mode, CachedDataHelper.java + JacsDataGetter.java); None when
    neither is configured."""
    path = getattr(args, "jacs_mips_file", None)
    if path:
        from ..jacs.client import ColorDepthMIP
        with open(path) as f:
            docs = json.load(f)
        return {d["id"]: ColorDepthMIP.from_dict(d)
                for d in docs if d.get("id")}
    jacs_url = getattr(args, "jacs_url", None)
    if jacs_url:
        from ..jacs.client import CachedDataHelper, JacsClient
        client = JacsClient(jacs_url,
                            authorization=getattr(args, "authorization",
                                                  None))
        return CachedDataHelper(
            client,
            read_batch_size=getattr(args, "jacs_read_batch_size", 5000))
    return None


def _prefetch_jacs_mips(jacs_mips, entities) -> None:
    """Batch-fetch the ids an export group will enrich (live helper
    only; the fixture dict has everything already)."""
    if jacs_mips is None or not hasattr(jacs_mips, "prefetch"):
        return
    jacs_mips.prefetch([e.mip_id for e in entities
                        if e is not None and e.mip_id])


def _export_mips(args) -> int:
    from ..dataio import JSONCDMIPsReader
    reader = JSONCDMIPsReader(args.mips_file)
    url_t, store_m, pub_urls, lm_stacks = build_transformers(args)
    jacs_mips = _load_jacs_mips_fixture(args)
    lib_names = _load_library_names(args)
    entities = reader.read_mips(DataSourceParam())
    _prefetch_jacs_mips(jacs_mips, entities)
    out_dir = args.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    by_name: Dict[str, List] = {}
    for e in entities:
        by_name.setdefault(e.published_name or "unknown", []).append(e)
    for name, group in by_name.items():
        doc = {"results": [neuron_metadata(e, url_t, store_m, pub_urls,
                                           lm_stacks, jacs_mips=jacs_mips,
                                           library_names=lib_names)
                           for e in group]}
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(doc, f, indent=2)
    LOG.info("exported %d MIPs in %d files", len(entities), len(by_name))
    return 0


def _parse_as_aliases(pairs) -> Dict[str, set]:
    """SPACE=ALIAS args -> {space: {aliases}}
    (ExportData4NBCmd.java:256-259)."""
    out: Dict[str, set] = {}
    for pair in pairs or []:
        if "=" not in pair:
            continue
        space, alias = pair.split("=", 1)
        out.setdefault(space, set()).add(alias)
    return out


def _load_lm_samples(args):
    """name -> CDMIPSample resolver: offline fixture list (docs carry
    `name`) or live `/data/samples?name=...`
    (CachedDataHelper.retrieveLMSamplesByName:63-75)."""
    from ..jacs.client import CDMIPSample
    path = getattr(args, "jacs_samples_file", None)
    if path:
        with open(path) as f:
            docs = json.load(f)
        fixture = {}
        for d in docs:
            s = CDMIPSample.from_dict(d)
            if s and s.name:
                fixture[s.name] = s

        def lookup(names):
            return {n: fixture[n] for n in names if n in fixture}
        return lookup
    jacs_url = getattr(args, "jacs_url", None)
    if jacs_url:
        from ..jacs.client import JacsClient
        client = JacsClient(jacs_url,
                            authorization=getattr(args, "authorization",
                                                  None))
        cache: Dict[str, object] = {}

        def lookup(names):
            missing = sorted(n for n in names if n and n not in cache)
            if missing:
                for s in client.retrieve_lm_samples_by_name(missing):
                    if s.name:
                        cache[s.name] = s
                for n in missing:
                    # negative-cache unresolvable names too: without
                    # this every mask group re-fetches the same misses
                    cache.setdefault(n, None)
            return {n: cache[n] for n in names
                    if cache.get(n) is not None}
        return lookup
    return lambda names: {}


def _find_published_lm3d_stack(sample_ref, alignment_space, lm_images_by_ref,
                               as_aliases) -> str | None:
    """First published LM image for the sample in the export alignment
    space (or an alias) carrying a VisuallyLosslessStack
    (EMPPPMatchesExporter.findPublishedLM3DStack:261-276)."""
    aliases = as_aliases.get(alignment_space or "", set())
    for img in lm_images_by_ref.get(sample_ref, []):
        img_as = img.get("alignmentSpace")
        if img_as != alignment_space and img_as not in aliases:
            continue
        url = (img.get("files") or {}).get("VisuallyLosslessStack")
        if url:
            return url
    return None


def _export_ppp_matches(args) -> int:
    """EM PPP matches export — the full EMPPPMatchesExporter pipeline
    (cmd/dataexport/EMPPPMatchesExporter.java:84-276): drop matches
    without source screenshots, group per mask publishedName ordered by
    rank, enrich targets from LM samples + published LM images + the
    per-match pppmURL store, convert to PPPMatchedTarget DTOs with
    screenshot FileTypes, relativize URLs, map image stores, cap
    same-published-name matches, and write grouped results keyed by the
    EM body ref id."""
    from ..model import PPPMatchEntity, PPPScreenshotType
    url_t, store_m, pub_urls, _lm_stacks = build_transformers(args)
    jacs_mips = _load_jacs_mips_fixture(args)
    lib_names = _load_library_names(args)
    get_samples = _load_lm_samples(args)
    as_aliases = _parse_as_aliases(args.published_alignment_space_alias)
    store = None
    if args.db:
        from .backends import get_store
        store = get_store(args.db)

    offline_lm_images = None
    if getattr(args, "published_lm_images", None):
        # index by sampleRef once — per-group linear scans would be
        # O(masks x docs) on production-sized dumps
        offline_lm_images = {}
        with open(args.published_lm_images) as f:
            for d in json.load(f):
                offline_lm_images.setdefault(d.get("sampleRef"),
                                             []).append(d)

    def find_lm_images_by_ref(sample_refs) -> Dict[str, List[dict]]:
        if offline_lm_images is not None:
            return {r: offline_lm_images[r] for r in sample_refs
                    if r in offline_lm_images}
        if store is not None and hasattr(store, "find_published_lm_images"):
            docs = store.find_published_lm_images(
                sample_refs=sorted(sample_refs)) if sample_refs else []
        else:
            docs = []
        by_ref: Dict[str, List[dict]] = {}
        for d in docs:
            by_ref.setdefault(d.get("sampleRef"), []).append(d)
        return by_ref

    offline_pppm_urls = None
    if getattr(args, "pppm_urls", None):
        with open(args.pppm_urls) as f:
            offline_pppm_urls = {str(d.get("_id", d.get("id"))): d
                                 for d in json.load(f)
                                 if d.get("_id", d.get("id")) is not None}

    def match_url_key(m) -> str:
        """Lookup key into the pppmURL map: the match entity id, or the
        natural sourceEmName-sourceLmName pair for id-less fs-sourced
        matches (offline fixtures key on it)."""
        return (str(m.entity_id) if m.entity_id is not None
                else f"{m.source_em_name}-{m.source_lm_name}")

    def pppm_urls_for(group) -> Dict[str, dict]:
        """match_url_key -> PPPmURLs doc
        (PublishedURLsDao.findByEntityIds over pppmURL,
        EMPPPMatchesExporter.java:177-180)."""
        if offline_pppm_urls is not None:
            out = {}
            for m in group:
                doc = offline_pppm_urls.get(str(m.entity_id)) \
                    or offline_pppm_urls.get(
                        f"{m.source_em_name}-{m.source_lm_name}")
                if doc:
                    out[match_url_key(m)] = doc
            return out
        if store is not None and hasattr(store, "find_pppm_urls_by_ids"):
            return store.find_pppm_urls_by_ids(
                [m.entity_id for m in group])
        return {}

    def read_all_by_mask():
        if store is not None:
            for em_name in store.list_ppp_em_names():
                yield em_name, store.find_ppp_matches_by_em(em_name)
            return
        for fname in sorted(os.listdir(args.matchesDir)):
            if not fname.endswith(".json"):
                continue
            with open(os.path.join(args.matchesDir, fname)) as f:
                doc = json.load(f)
            matches = [PPPMatchEntity.from_dict(r)
                       for r in doc.get("results", [])]
            mask = doc.get("inputImage")
            for m in matches:
                if m.mask_image is None and mask:
                    from ..model import entity_from_dict
                    m.mask_image = entity_from_dict(mask)
            yield fname[:-5], matches

    out_dir = args.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    n = n_dropped = 0
    for mask_id, all_matches in read_all_by_mask():
        # order ascending by rank (SortCriteria("rank", ASC), :112-114)
        all_matches.sort(key=lambda m: m.rank if m.rank is not None
                         else float("inf"))
        # filter out matches without source screenshots (:119-121)
        matches = [m for m in all_matches if m.has_source_image_files]
        if args.size > 0:
            matches = matches[:args.size]
        if not matches:
            LOG.info("no exportable PPP matches for %s (%d read)",
                     mask_id, len(all_matches))
            continue
        # group by the mask's publishedName (:131-141)
        groups: Dict[str, List[PPPMatchEntity]] = {}
        for m in matches:
            pub = (m.mask_image.published_name
                   if m.mask_image else None) or mask_id
            groups.setdefault(pub, []).append(m)
        for pub_name, group in groups.items():
            em = group[0].mask_image
            em_meta = neuron_metadata(em, url_t, store_m, pub_urls,
                                      jacs_mips=jacs_mips,
                                      library_names=lib_names) \
                if em is not None else {"publishedName": pub_name}
            # EM body ref without the "EMBody#" prefix names the output
            # file (EMNeuronEntity.metadata:56 via getSourceRefIdOnly +
            # writeGroupedItemsList keyed by getEmRefId:151); the field
            # itself is @JsonIgnore (dto/EMNeuronMetadata.java:19-21) so
            # it never serializes into inputImage
            em_ref_id = (em.source_ref_id.split("#")[-1]
                         if em is not None and em.source_ref_id else None)
            # PPP masks/targets validate in the default group only:
            # mipId is @NotBlank solely in WithAllRequiredAttrs
            # (dto/AbstractNeuronMetadata.java:34,84; PPP EM masks are
            # body-level records)
            missing = [a for a in validate_export_metadata(em_meta)
                       if a != "mipId"] \
                if args.validation != "off" else []
            if missing:
                LOG.warning("skipping PPP export for %s: missing attrs %s",
                            pub_name, missing)
                n_dropped += len(group)
                continue
            em_store = (em_meta.get("files") or {}).get("store")
            # sample + published-image source data (:160-169)
            sample_names = {m.extract_lm_sample_name() for m in group}
            samples = get_samples(sorted(x for x in sample_names if x))
            lm_images_by_ref = find_lm_images_by_ref(
                {s.ref() for s in samples.values()})
            urls_by_id = pppm_urls_for(group)
            results = []
            for m in group:
                t = m.matched_target_metadata()
                target = (neuron_metadata(m.matched_image)
                          if m.matched_image is not None else {})
                # LMPPPNeuronMetadata: PPP targets carry no MIP id and
                # inherit space/area from the EM mask (:210-219)
                target.pop("mipId", None)
                target["type"] = "LMImage"
                target.setdefault("alignmentSpace",
                                  em_meta.get("alignmentSpace"))
                target.setdefault("anatomicalArea",
                                  em_meta.get("anatomicalArea"))
                target.setdefault("objective", m.source_objective())
                if m.source_lm_library:
                    # display-name mapped (updateTargetFromLMSample:221)
                    lib = m.source_lm_library
                    if lib_names:
                        lib = lib_names.get(lib, lib)
                    target["libraryName"] = lib
                files: Dict[str, str] = {}
                sample = samples.get(m.extract_lm_sample_name())
                if sample is not None:
                    lm3d = _find_published_lm3d_stack(
                        sample.ref(), target.get("alignmentSpace"),
                        lm_images_by_ref, as_aliases)
                    target["id"] = sample.id
                    if sample.lm_line_name():
                        target["publishedName"] = sample.lm_line_name()
                    if sample.slide_code:
                        target["slideCode"] = sample.slide_code
                    if sample.gender:
                        from ..model import Gender
                        g = Gender.from_val(sample.gender)
                        if g is not None:
                            target["gender"] = g.name
                    if sample.mounting_protocol:
                        target["mountingProtocol"] = sample.mounting_protocol
                    tfiles = dict(target.get("files") or {})
                    if lm3d:
                        tfiles["VisuallyLosslessStack"] = \
                            url_t.relativize_url("VisuallyLosslessStack",
                                                 lm3d)
                    if store_m is not None:
                        tfiles["store"] = store_m.get_image_store(
                            target.get("alignmentSpace"),
                            target.get("libraryName"))
                    if tfiles:
                        target["files"] = tfiles
                    # per-match screenshot URLs from the pppmURL store
                    # (:235-250); absent URL records log an error and
                    # leave the match file unset
                    urls_doc = urls_by_id.get(match_url_key(m))
                    if m.has_source_image_files:
                        if urls_doc:
                            uploaded = urls_doc.get("uploadedFiles") or {}
                            thumbs = urls_doc.get("uploadedThumbnails") or {}
                            for tname in m.source_image_files:
                                st = PPPScreenshotType.from_name(tname)
                                if st is None:
                                    continue
                                u = uploaded.get(tname)
                                if u:
                                    ft = st.file_type.name
                                    files[ft] = url_t.relativize_url(ft, u)
                                if st.has_thumbnail and thumbs.get(tname):
                                    ft = st.thumbnail_file_type.name
                                    files[ft] = url_t.relativize_url(
                                        ft, thumbs[tname])
                            if files and em_store:
                                # the EM image's store applies to the
                                # match screenshots too (:250)
                                files["store"] = em_store
                        else:
                            LOG.error(
                                "PPP match %s-%s has screenshots but no "
                                "published URLs for %s", m.source_em_name,
                                m.source_lm_name, m.entity_id)
                else:
                    LOG.error("No sample found for %s", m.source_lm_name)
                t["image"] = target
                if files:
                    t["files"] = files
                results.append(t)
            # only matches that resolved published match files export
            # (hasMatchFiles filter, :183)
            results = [r for r in results if r.get("files")]
            # cap same-published-name matches per EM mask, then order
            # by rank (:184-200)
            cap = args.max_matches_with_same_name_per_mip
            if cap > 0:
                by_name: Dict[str, List[dict]] = {}
                for r in results:
                    by_name.setdefault(
                        r["image"].get("publishedName"), []).append(r)
                results = [r for g in by_name.values()
                           for r in sorted(
                               g, key=lambda x: x.get("pppmRank") or 0)[:cap]]
            results.sort(key=lambda x: x.get("pppmRank") or 0)
            if not results:
                n_dropped += len(group)
                continue
            # write keyed by the EM body ref id (:150-151)
            key = em_ref_id or pub_name
            with open(os.path.join(out_dir, f"{key}.json"), "w") as f:
                json.dump({"inputImage": em_meta, "results": results},
                          f, indent=2)
            n += len(results)
    LOG.info("exported %d PPP matches (%d dropped)", n, n_dropped)
    return 0


def run(args: argparse.Namespace) -> int:
    t = args.exported_result_type
    if t in ("EM_CD_MATCHES", "LM_CD_MATCHES"):
        if not args.matchesDir and not args.db:
            LOG.error("--matchesDir or --db required for %s", t)
            return 1
        return _export_cd_matches(args, by_target=(t == "LM_CD_MATCHES"))
    if t == "EM_PPP_MATCHES":
        if not args.matchesDir and not args.db:
            LOG.error("--matchesDir or --db required for %s", t)
            return 1
        return _export_ppp_matches(args)
    if not args.mips_file:
        LOG.error("--mips-file required for %s", t)
        return 1
    return _export_mips(args)
