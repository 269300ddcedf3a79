"""colorDepthSearch command: the mask x target pixel-match sweep.

Counterpart of `colormipsearch_tpu/cmd/colordepthsearch_cmd.py`. The host
logic (reading and filtering MIPs, decoding target partitions, the
session entity, match building and flushing) is copied from it; the
device work is the port's two-phase path
(`parallel/twophase_sweep.TwoPhaseSweep`) on the `--device` given.

The exact predicate follows the JAX package's own switch,
`CMS_RATIO_PRED` (read once per run, default "1"): "1" runs the ratio
kernel, any other value (the reference's "0") the packed-word kernel.
Both give the same scores. No other `CMS_*` variable is read.

Refused here, each with a pointer to ROADMAP.md: `--engine dense` (the
dense engine is a later port) and `--jax-distributed` (multi-host is a
later port). The multi-process grid options of the reference
(--process-id/--process-count) are not offered yet.
"""

from __future__ import annotations

import argparse
import getpass
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from colormipsearch_tpu.cmd.args import (ListArg, add_cds_params,
                                         add_common_args,
                                         excluded_regions_for)
from colormipsearch_tpu.dataio import (DataSourceParam, JSONCDMIPsReader,
                                       JSONCDSSessionWriter)
from colormipsearch_tpu.mips import MIPsCache
from colormipsearch_tpu.model import (CDMatchEntity, CDSSessionEntity,
                                      ComputeFileType, ProcessingType)
from colormipsearch_tpu.persist import TimebasedIdGenerator
from colormipsearch_tpu.results import partition_collection

from ..cds.pixel_kernel import z_tolerance_to_zt9
from ..device import resolve_device

LOG = logging.getLogger(__name__)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "colorDepthSearch", help="pairwise color depth search")
    add_common_args(p)
    add_cds_params(p)
    p.add_argument("-m", "--masks", nargs="+", required=True,
                   help="mask MIPs: JSON file(s) 'path:offset:length', or "
                        "with --mips-storage db, library selector(s) "
                        "'library:offset:length'")
    p.add_argument("-i", "--targets", "--images", nargs="+", required=True,
                   help="target MIPs: JSON file(s) or (--mips-storage db) "
                        "library selector(s), 'name:offset:length'")
    p.add_argument("--mips-storage", choices=("file", "db"), default="file",
                   help="where mask/target MIP entities come from")
    p.add_argument("--masks-index", type=int, default=0)
    p.add_argument("--masks-length", type=int, default=-1)
    p.add_argument("--targets-index", type=int, default=0)
    p.add_argument("--targets-length", type=int, default=-1)
    p.add_argument("-as", "--alignment-space", default=None)
    p.add_argument("--masks-tags", "--mask-tags", dest="masks_tags",
                   nargs="*", default=[])
    p.add_argument("--masks-excluded-tags", "--mask-excluded-tags",
                   dest="masks_excluded_tags", nargs="*", default=[])
    p.add_argument("--masks-terms", nargs="*", default=[])
    p.add_argument("--excluded-masks-terms", nargs="*", default=[])
    p.add_argument("--masks-datasets", nargs="*", default=[])
    p.add_argument("--masks-published-names", nargs="*", default=[])
    p.add_argument("--targets-tags", "--target-tags", dest="targets_tags",
                   nargs="*", default=[])
    p.add_argument("--targets-excluded-tags", "--target-excluded-tags",
                   dest="targets_excluded_tags", nargs="*", default=[])
    p.add_argument("--targets-terms", nargs="*", default=[])
    p.add_argument("--excluded-targets-terms", nargs="*", default=[])
    p.add_argument("--targets-datasets", nargs="*", default=[])
    p.add_argument("--targets-published-names", nargs="*", default=[])
    p.add_argument("--perMaskSubdir", default="masks")
    p.add_argument("--perTargetSubdir", default=None,
                   help="also write per-target grouped results")
    p.add_argument("--processing-tag", default=None)
    p.add_argument("--update-matches", action="store_true",
                   help="re-run mode: refresh pixel scores of existing "
                        "(mask, target) matches without clobbering their "
                        "gradient/normalized scores")
    p.add_argument("--masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="only process masks already stamped with these "
                        "processing tags, e.g. ColorDepthSearch=run1")
    p.add_argument("--excluded-masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="skip masks already stamped with these tags")
    p.add_argument("--write-batch-size", type=int, default=0,
                   help="flush results every N masks (0 = at end)")
    p.add_argument("--db", default=None,
                   help="write matches to this SQLite store instead of JSON")
    p.add_argument("--jax-distributed", action="store_true",
                   help="refused: multi-host runs are not ported yet")
    p.add_argument("--cdsConcurrency", type=int, default=0,
                   help="host decode-pool threads (0 = default 8)")
    p.add_argument("--engine", choices=("auto", "dense", "pallas"),
                   default="auto",
                   help="scoring engine: 'auto' and 'pallas' run the "
                        "two-phase active-tile path; 'dense' is not ported")
    p.add_argument("--prescreen", choices=("on", "off"), default="on",
                   help="upper-bound screen before the exact kernel "
                        "(results identical)")
    p.add_argument("--device", default="cuda",
                   help="torch device for scoring: cuda, cuda:N or cpu")
    p.set_defaults(func=run)


def _filter_by_processing_tags(entities, include_specs, exclude_specs):
    """Restartable stage selection by processedTags stamps. Specs are
    STAGE=TAG with STAGE a ProcessingType name."""

    def parse(specs):
        out = []
        for s in specs or []:
            stage, _, tag = s.partition("=")
            try:
                out.append((ProcessingType[stage], tag))
            except KeyError:
                LOG.warning("unknown processing stage %r in %r", stage, s)
        return out

    inc, exc = parse(include_specs), parse(exclude_specs)
    if not inc and not exc:
        return entities
    kept = [e for e in entities
            if all(e.has_processed_tag(pt, tag) for pt, tag in inc)
            and not any(e.has_processed_tag(pt, tag) for pt, tag in exc)]
    LOG.info("processing-tag filters kept %d/%d masks", len(kept),
             len(entities))
    return kept


def _side_selector(args, side: str) -> DataSourceParam:
    """Mask/target neuron selector from the CLI args."""
    g = lambda name: getattr(args, f"{side}_{name}", None) or []
    return DataSourceParam(
        alignment_space=getattr(args, "alignment_space", None),
        names=list(g("published_names")),
        datasets=set(g("datasets")),
        tags=set(g("tags")),
        excluded_tags=set(g("excluded_tags")),
        annotations=set(g("terms")),
        excluded_annotations=set(getattr(
            args, f"excluded_{side}_terms", None) or []))


def _read_mips(args, files: List[str], index: int, length: int, side: str):
    """Read one side's MIP entities from JSON files or (--mips-storage
    db) store libraries, apply the side's selectors and keep entities
    with an input CDM."""
    sel = _side_selector(args, side)
    entities = []
    if getattr(args, "mips_storage", "file") == "db":
        if not args.db:
            raise SystemExit("--mips-storage db requires --db")
        from colormipsearch_tpu.cmd.backends import get_store
        from colormipsearch_tpu.dataio.db import DBCDMIPsReader
        reader = DBCDMIPsReader(get_store(args.db))
        for f in files:
            la = ListArg.parse(f)
            param = DataSourceParam(
                alignment_space=sel.alignment_space,
                libraries=[la.input], names=sel.names,
                datasets=sel.datasets, tags=sel.tags,
                excluded_tags=sel.excluded_tags,
                annotations=sel.annotations,
                excluded_annotations=sel.excluded_annotations,
                offset=la.offset, size=la.length)
            entities.extend(reader.read_mips(param))
    else:
        for f in files:
            la = ListArg.parse(f)
            param = DataSourceParam(offset=la.offset, size=la.length)
            mips = JSONCDMIPsReader(la.input).read_mips(param)
            entities.extend(e for e in mips if sel.matches_entity(e))
    entities = [e for e in entities
                if ComputeFileType.InputColorDepthImage in e.compute_files]
    param = DataSourceParam(offset=index, size=length)
    return param.apply_slice(entities)


def _load_target_images(targets, cache: MIPsCache, workers: int = 8):
    """Decode a target partition with a thread pool. Returns (pixel
    arrays, entities, failed) where failed lists (target, error message):
    one bad image is reported per pair downstream, not fatal."""

    def load(t):
        try:
            return t, cache.load_mip(t, ComputeFileType.InputColorDepthImage), None
        except Exception as e:  # decode/IO failure: capture, don't kill
            return t, None, f"{type(e).__name__}: {e}"

    loaded, entities, failed = [], [], []
    shape = None
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for t, mip, err in pool.map(load, targets):
            if err is not None:
                LOG.warning("target %s failed to load: %s", t.mip_id, err)
                failed.append((t, err))
                continue
            if mip.image is None:
                LOG.warning("no input image for target %s", t.mip_id)
                failed.append((t, "no input image"))
                continue
            px = (mip.image.pixels if mip.image.pixels.ndim == 3
                  else np.repeat(mip.image.pixels[..., None], 3, axis=2))
            if shape is None:
                shape = px.shape
            elif px.shape != shape:
                LOG.warning("target %s has size %s, expected %s — skipped",
                            t.mip_id, px.shape, shape)
                failed.append((t, f"image size {px.shape} != mask size "
                                  f"{shape}"))
                continue
            loaded.append(px)
            entities.append(t)
    return loaded, entities, failed


def _refuse(args) -> None:
    if args.engine == "dense":
        raise SystemExit("--engine dense is not ported to colormipsearch_torch "
                         "yet (see ROADMAP.md, queue 1); use --engine auto "
                         "or pallas, or the JAX package")
    if args.jax_distributed:
        raise SystemExit("--jax-distributed: multi-host runs are not ported "
                         "to colormipsearch_torch yet (see ROADMAP.md, "
                         "queue 1)")


def run(args: argparse.Namespace) -> int:
    from ..cds.pixel_active import ActiveTilePixelEngine
    from ..cds.prescreen import PairPrescreen
    from ..parallel.twophase_sweep import TwoPhaseSweep

    _refuse(args)
    device = resolve_device(args.device)
    t_start = time.time()
    masks = _read_mips(args, args.masks, args.masks_index,
                       args.masks_length, "masks")
    targets = _read_mips(args, args.targets, args.targets_index,
                         args.targets_length, "targets")
    masks = _filter_by_processing_tags(
        masks, args.masks_processing_tags,
        args.excluded_masks_processing_tags)
    LOG.info("read %d masks, %d targets", len(masks), len(targets))
    if not masks or not targets:
        LOG.warning("nothing to search")
        return 0

    idgen = TimebasedIdGenerator()
    session_id = idgen.generate_id()
    run_tag = args.processing_tag or str(session_id)

    array_store = None
    if args.array_cache:
        from colormipsearch_tpu.imageproc.store import PackedArrayStore
        array_store = PackedArrayStore(args.array_cache)
    cache = MIPsCache(args.cacheSize, array_store=array_store)
    zt9 = z_tolerance_to_zt9(args.pixColorFluctuation)

    # persist session params for provenance
    if args.output_dir or args.db:
        session = CDSSessionEntity(
            entity_id=session_id, username=getpass.getuser(),
            params={"mirrorMask": args.mirrorMask,
                    "dataThreshold": args.dataThreshold,
                    "maskThreshold": args.maskThreshold,
                    "pixColorFluctuation": args.pixColorFluctuation,
                    "xyShift": args.xyShift,
                    "pctPositivePixels": args.pctPositivePixels},
            masks=[{"file": f} for f in args.masks],
            targets=[{"file": f} for f in args.targets])
        if args.db:
            from colormipsearch_tpu.cmd.backends import get_store
            get_store(args.db).create_session(session)
        else:
            JSONCDSSessionWriter(args.output_dir).create_session(session)

    all_matches: List[CDMatchEntity] = []
    target_parts = partition_collection(targets, args.processingPartitionSize)
    ratio_threshold = (args.pctPositivePixels or 0.0) / 100.0
    # the reference's switch (pixel_pallas.py:278): ratio only for "1"
    ratio_pred = os.environ.get("CMS_RATIO_PRED", "1")
    predicate = "ratio" if ratio_pred == "1" else "words"
    LOG.info("scoring on %s (two-phase active-tile path, %s predicate; "
             "CMS_RATIO_PRED=%s)", device, predicate, ratio_pred)

    # query tables once per mask, over a host thread pool (decode, tile
    # packing and ratio-plane tables are GIL-releasing numpy/PIL work)
    def prep_one(mask):
        mip = cache.load_mip(mask, ComputeFileType.InputColorDepthImage)
        if mip.image is None:
            LOG.warning("no input image for mask %s", mask.mip_id)
            return None
        excluded = excluded_regions_for(args, mip.image.height,
                                        mip.image.width)
        return (mask, ActiveTilePixelEngine(
            mip.image, args.maskThreshold, args.mirrorMask,
            args.dataThreshold, args.pixColorFluctuation, args.xyShift,
            excluded, predicate))

    t_prep = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        prepared = [p for p in pool.map(prep_one, masks) if p is not None]
    LOG.info("prepared %d mask engines in %.1fs", len(prepared),
             time.perf_counter() - t_prep)
    if not prepared:
        return 0

    screen = u_matrix = thresholds = None
    if args.prescreen == "on":
        first = prepared[0][1]
        screen = PairPrescreen(zt9, args.xyShift, first.tiles.height,
                               first.tiles.width)
        u_matrix = np.stack([screen.query_features(eng.planes.words)
                             for _, eng in prepared])
        thresholds = np.array(
            [max(ratio_threshold * eng.tiles.query_size, 0.5)
             for _, eng in prepared])
    sweep = TwoPhaseSweep([eng for _, eng in prepared], [device], screen,
                          u_matrix, thresholds)

    flushed = 0

    def maybe_flush():
        nonlocal flushed
        if args.db and args.write_batch_size > 0 \
                and len(all_matches) - flushed >= args.write_batch_size:
            from colormipsearch_tpu.cmd.backends import matches_writer
            matches_writer(args.db, None,
                           update_scores_only=args.update_matches
                           ).write(all_matches[flushed:])
            flushed = len(all_matches)

    stage_totals = {"decode": 0.0, "matches": 0.0}
    # decode prefetch: partition i+1 decodes on a host thread while the
    # device scores partition i
    prefetcher = ThreadPoolExecutor(max_workers=1)

    def decode(part):
        return _load_target_images(part, cache,
                                   workers=args.cdsConcurrency or 8)

    def record_pair_errors(failed):
        """One error CDMatchEntity per (mask, failed target) pair."""
        for target, err in failed:
            for mask, _ in prepared:
                m = CDMatchEntity()
                m.mask_image = mask
                m.matched_image = target
                m.session_ref_id = str(session_id)
                m.match_found = False
                m.errors = err
                m.tags.add(run_tag)
                all_matches.append(m)

    def decoded_parts():
        """(target entities, stacked pixels) per partition that has any
        decoded image; decoding runs one partition ahead."""
        pending = None
        for pi, part in enumerate(target_parts):
            t0 = time.perf_counter()
            if pending is None:
                t_imgs, t_entities, t_failed = decode(part)
            else:
                t_imgs, t_entities, t_failed = pending.result()
            if pi + 1 < len(target_parts):
                pending = prefetcher.submit(decode, target_parts[pi + 1])
            stage_totals["decode"] += time.perf_counter() - t0
            if t_failed:
                record_pair_errors(t_failed)
            if t_imgs:
                yield t_entities, np.stack(t_imgs)
            else:
                maybe_flush()

    try:
        # pipelined: partition p+1 is launched before p's matches are built
        for t_entities, scores, mirrored in sweep.sweep_parts(
                decoded_parts(), stage_totals):
            t0 = time.perf_counter()
            for bi, (mask, eng) in enumerate(prepared):
                query_size = eng.tiles.query_size
                qsize = max(query_size, 1)
                for ti, target in enumerate(t_entities):
                    pixels = int(scores[bi, ti]) if query_size else 0
                    ratio = pixels / qsize if query_size else 0.0
                    # isMatch (ColorMIPSearch.java:42-46)
                    if not (pixels > 0 and ratio > ratio_threshold):
                        continue
                    m = CDMatchEntity()
                    m.mask_image = mask
                    m.matched_image = target
                    m.session_ref_id = str(session_id)
                    m.matching_pixels = pixels
                    m.matching_pixels_ratio = float(np.float32(ratio))
                    m.mirrored = bool(mirrored[bi, ti])
                    m.match_found = True
                    m.tags.add(run_tag)
                    mask.add_processed_tag(ProcessingType.ColorDepthSearch,
                                           run_tag)
                    target.add_processed_tag(ProcessingType.ColorDepthSearch,
                                             run_tag)
                    all_matches.append(m)
            stage_totals["matches"] += time.perf_counter() - t0
            maybe_flush()
    finally:
        prefetcher.shutdown(wait=True)

    n_groups = 0
    if args.db or args.output_dir:
        from colormipsearch_tpu.cmd.backends import matches_writer
        per_masks = (os.path.join(args.output_dir, args.perMaskSubdir)
                     if args.output_dir else None)
        per_targets = (os.path.join(args.output_dir, args.perTargetSubdir)
                       if args.output_dir and args.perTargetSubdir else None)
        writer = matches_writer(args.db, per_masks, per_targets,
                                update_scores_only=args.update_matches)
        if args.db and flushed:
            n_groups = writer.write(all_matches[flushed:]) \
                if flushed < len(all_matches) else 0
        else:
            n_groups = writer.write(all_matches)
    if args.db:
        # stamp every searched mip with the run's processing tag in the
        # store, matched or not
        from colormipsearch_tpu.cmd.backends import get_store
        from colormipsearch_tpu.dataio.db import DBCDMIPsWriter
        DBCDMIPsWriter(get_store(args.db)).add_processing_tags(
            masks + targets, ProcessingType.ColorDepthSearch, {run_tag})
    LOG.info("stage times: %s",
             {k: round(v, 2) for k, v in stage_totals.items()})
    LOG.info("found %d matches (%d masks) in %.1fs",
             len(all_matches), n_groups, time.time() - t_start)
    return 0
