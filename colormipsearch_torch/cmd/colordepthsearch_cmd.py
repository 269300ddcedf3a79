"""colorDepthSearch command: the mask x target pixel-match sweep.

Counterpart of `colormipsearch_tpu/cmd/colordepthsearch_cmd.py`. The host
logic (reading and filtering MIPs, decoding target partitions, the
session entity, match building and writing) is copied from it, over the
port's own copies of the host modules (`model`, `dataio`, `mips`,
`persist`, `results`, `imageproc`). Masks and targets come from JSON
files, or with `--mips-storage db` from the `--db` store; results go to
per-mask JSON files (`-od`) or, with `--db`, to the SQLite (or Mongo)
store: the session row, the matches (pair-keyed upserts; with
`--update-matches` only the pixel scores of existing pairs change) and
every searched MIP stamped with the run's processing tag. The device
work runs on `--device`: "cuda" is every visible card (as the JAX
package drives every local device), "cuda:N" one card, "cpu" the CPU.
Two engines:
- `--engine auto` / `pallas`: the two-phase path
  (`parallel/twophase_sweep.TwoPhaseSweep`: prescreen bound, then the
  exact CUDA kernels), targets split over the devices;
- `--engine dense`: every pixel of every pair through the dense engine
  (`cds/pixel_kernel.py`), mask batches of `--maskBatchSize` swept over a
  ("mask", "target") mesh of the devices (`parallel/sweep.py`).

Scale-out, as the JAX package:
- `--process-id/--process-count` (defaults from CMS_PROCESS_ID and
  CMS_PROCESS_COUNT): the reference's job-array grid; each process sweeps
  its block of the mask x target grid
  (`parallel/distributed.block_for_process`) and writes whole per-mask
  files, so each grid process needs its own `-od`;
- `--jax-distributed` (the JAX package's flag name, so its launch
  scripts run unchanged): the processes join a torch.distributed group
  with the gloo backend (CMS_COORDINATOR=host:port, CMS_NUM_PROCESSES,
  CMS_PROCESS_ID; `parallel/multihost.py`). The two-phase path sweeps
  each process's block of every partition (`device_blocks`) and gathers
  the scores; the dense path sweeps a mesh over every process's devices.
  Process 0 alone writes. A group that does not form within its timeout
  ends the run with an error.

The exact predicate follows the JAX package's own switch,
`CMS_RATIO_PRED` (read once per run, default "1"): "1" runs the ratio
kernel, any other value (the reference's "0") the packed-word kernel.
Both give the same scores. Besides it and the scale-out variables above,
only the image cache's budget knobs of the reference are read
(`CMS_IMAGE_CACHE_MB`, `CMS_LOW_MEM_PCT`; `mips/loader.py`,
`utils/memguard.py`).

`--write-batch-size N` flushes the matches to the store once N are
pending. The partition loop is pipelined (partition p+1 is launched on
the device before p is collected), so a flush writes only rows of
collected partitions: a target's load error is recorded with the
partition it belongs to. A run killed after a flush leaves exactly the
flushed partitions' rows, and rerunning the same command converges to
the store of one uninterrupted run. `CMS_TEST_KILL_AFTER_FLUSHES=N` (a
test hook, as in the JAX package) SIGKILLs the process after its Nth
flush.
"""

from __future__ import annotations

import argparse
import dataclasses
import getpass
import json
import logging
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from ..cds import kernels
from ..cds.oracle import shift_ring_offsets
from ..cds.pixel_kernel import (pack_targets, prepare_query_planes,
                                z_tolerance_to_zt9)
from ..dataio import (DataSourceParam, JSONCDMIPsReader,
                      JSONCDSSessionWriter)
from ..dataio.db import DBCDMIPsReader, DBCDMIPsWriter
from ..device import peak_memory_gib, resolve_devices
from ..mips import MIPsCache
from ..model import (CDMatchEntity, CDSSessionEntity, ComputeFileType,
                     ProcessingType)
from ..persist import TimebasedIdGenerator
from ..results import partition_collection
from ..utils import trace
from .args import (ListArg, add_cds_params, add_common_args, check_grid,
                   excluded_regions_for)
from .backends import get_store, matches_writer

LOG = logging.getLogger(__name__)

_FLUSH_COUNT = 0


def _test_kill_hook() -> None:
    """Fault injection for the kill-and-resume tests: SIGKILL this
    process after the Nth incremental flush when
    CMS_TEST_KILL_AFTER_FLUSHES is set (an LSF array job dying
    mid-partition; submitCDSBatch.sh:14-25, ColorDepthSearchCmd.java:
    316-335)."""
    n = os.environ.get("CMS_TEST_KILL_AFTER_FLUSHES")
    if not n:
        return
    global _FLUSH_COUNT
    _FLUSH_COUNT += 1
    if _FLUSH_COUNT >= int(n):
        os.kill(os.getpid(), signal.SIGKILL)


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
                   help="where mask/target MIP entities come from: 'db' "
                        "reads them from the --db store by library and "
                        "selectors (DBCDMIPsReader.java:30-60)")
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
                        "gradient/normalized scores "
                        "(ColorDepthSearchCmd.java:395-401)")
    p.add_argument("--masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="only process masks already stamped with these "
                        "processing tags, e.g. ColorDepthSearch=run1")
    p.add_argument("--excluded-masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="skip masks already stamped with these tags")
    p.add_argument("--write-batch-size", type=int, default=0,
                   help="flush matches to the --db store every N "
                        "matches (0 = at the end)")
    p.add_argument("--db", default=None,
                   help="write matches to this SQLite store (or a "
                        "mongodb:// URI) instead of JSON")
    p.add_argument("--process-id", type=int,
                   default=int(os.environ.get("CMS_PROCESS_ID", -1)),
                   help="grid block index for multi-process sweeps; each "
                        "grid process writes whole per-mask files, so "
                        "give each its own -od")
    p.add_argument("--process-count", type=int,
                   default=int(os.environ.get("CMS_PROCESS_COUNT", 0)),
                   help="total grid processes")
    p.add_argument("--jax-distributed", action="store_true",
                   help="join a multi-process run over torch.distributed "
                        "(gloo; CMS_COORDINATOR=host:port, "
                        "CMS_NUM_PROCESSES, CMS_PROCESS_ID): each process "
                        "scores its share of every partition and process "
                        "0 writes the results")
    p.add_argument("--cdsConcurrency", type=int, default=0,
                   help="host decode-pool threads (0 = default 8)")
    p.add_argument("--engine", choices=("auto", "dense", "pallas"),
                   default="auto",
                   help="scoring engine: 'auto' and 'pallas' run the "
                        "two-phase active-tile path; 'dense' scores every "
                        "pixel of every pair (the cross-check)")
    p.add_argument("--prescreen", choices=("on", "off"), default="on",
                   help="upper-bound screen before the exact kernel "
                        "(two-phase path only; results identical)")
    p.add_argument("--device", default="cuda",
                   help="torch device(s) for scoring: cuda (every visible "
                        "card), cuda:N or cpu")
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
    """Read one side's MIP entities: JSON file lists, or store libraries
    when --mips-storage db (DBCDMIPsReader.java:30-60). Both paths apply
    the side's selectors and keep entities with an input CDM."""
    sel = _side_selector(args, side)
    entities = []
    if args.mips_storage == "db":
        reader = DBCDMIPsReader(get_store(args.db))
        for f in files:
            la = ListArg.parse(f)
            entities.extend(reader.read_mips(dataclasses.replace(
                sel, libraries=[la.input], offset=la.offset,
                size=la.length)))
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


def run(args: argparse.Namespace) -> int:
    from ..parallel.multihost import (maybe_init_distributed,
                                      shutdown_distributed)
    if args.mips_storage == "db" and not args.db:
        raise SystemExit("--mips-storage db requires --db")
    check_grid(args)
    devices = resolve_devices(args.device)
    multi = bool(args.jax_distributed) and maybe_init_distributed()
    try:
        return _search(args, devices, multi)
    finally:
        if multi:
            shutdown_distributed()


def _search(args: argparse.Namespace, devices, multi: bool) -> int:
    from ..cds.pixel_active import ActiveTilePixelEngine
    from ..cds.prescreen import PairPrescreen
    from ..parallel.multihost import process_index
    from ..parallel.twophase_sweep import TwoPhaseSweep

    t_start = time.time()
    masks = _read_mips(args, args.masks, args.masks_index,
                       args.masks_length, "masks")
    targets = _read_mips(args, args.targets, args.targets_index,
                         args.targets_length, "targets")
    masks = _filter_by_processing_tags(
        masks, args.masks_processing_tags,
        args.excluded_masks_processing_tags)
    if args.process_count > 0 and args.process_id >= 0:
        # deterministic grid block, restartable per process id
        # (the LSF job-array mapping, submitCDSJob.sh:58-66)
        from ..parallel.distributed import block_for_process
        blk = block_for_process(len(masks), len(targets),
                                args.process_id, args.process_count)
        masks = masks[blk.mask_offset:blk.mask_offset + blk.mask_length]
        targets = targets[blk.target_offset:
                          blk.target_offset + blk.target_length]
        LOG.info("process %d/%d owns block %s", args.process_id,
                 args.process_count, blk)
    LOG.info("read %d masks, %d targets", len(masks), len(targets))
    if not masks or not targets:
        LOG.warning("nothing to search")
        return 0
    # one writer per multi-process run, as the reference's collecting
    # process (SparkColorMIPSearchProcessor.java:73)
    writes = bool(args.output_dir or args.db) and \
        (not multi or process_index() == 0)

    idgen = TimebasedIdGenerator()
    session_id = idgen.generate_id()
    run_tag = args.processing_tag or str(session_id)

    array_store = None
    if args.array_cache:
        from ..imageproc.store import PackedArrayStore
        array_store = PackedArrayStore(args.array_cache)
    cache = MIPsCache(args.cacheSize, array_store=array_store)
    zt9 = z_tolerance_to_zt9(args.pixColorFluctuation)

    # persist session params for provenance
    if writes:
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
            get_store(args.db).create_session(session)
        else:
            JSONCDSSessionWriter(args.output_dir).create_session(session)

    all_matches: List[CDMatchEntity] = []
    target_parts = partition_collection(targets, args.processingPartitionSize)
    ratio_threshold = (args.pctPositivePixels or 0.0) / 100.0
    dense = args.engine == "dense"
    # the reference's switch (pixel_pallas.py:278): ratio only for "1"
    ratio_pred = os.environ.get("CMS_RATIO_PRED", "1")
    predicate = "ratio" if ratio_pred == "1" else "words"
    if dense:
        LOG.info("scoring on %s (dense engine)", devices)
    else:
        LOG.info("scoring on %s (two-phase active-tile path, %s predicate; "
                 "CMS_RATIO_PRED=%s)", devices, predicate, ratio_pred)

    # query tables once per mask, over a host thread pool (decode, tile
    # packing and ratio-plane tables are GIL-releasing numpy/PIL work):
    # packed query planes for the dense engine, an engine for the
    # two-phase path
    def prep_one(mask):
        mip = cache.load_mip(mask, ComputeFileType.InputColorDepthImage)
        if mip.image is None:
            LOG.warning("no input image for mask %s", mask.mip_id)
            return None
        excluded = excluded_regions_for(args, mip.image.height,
                                        mip.image.width)
        if dense:
            return (mask, prepare_query_planes(mip.image, args.maskThreshold,
                                               excluded))
        return (mask, ActiveTilePixelEngine(
            mip.image, args.maskThreshold, args.mirrorMask,
            args.dataThreshold, args.pixColorFluctuation, args.xyShift,
            excluded, predicate))

    prep_s = {}
    with trace.timed("cds.prep", prep_s, "prep"), \
            ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        prepared = [p for p in pool.map(prep_one, masks) if p is not None]
    LOG.info("prepared %d mask engines in %.1fs", len(prepared),
             prep_s["prep"])
    if not prepared:
        return 0
    query_sizes = [qp.query_size if dense else qp.tiles.query_size
                   for _, qp in prepared]

    stage_totals = {"decode": 0.0, "matches": 0.0, "write": 0.0}
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

    unscored_failures = []  # load errors after the last decoded partition

    def decoded_parts():
        """((target entities, load errors), stacked pixels) per partition
        that has any decoded image; decoding runs one partition ahead. A
        partition's load errors (and those of image-less partitions
        before it) travel with it, so that they are recorded when it is
        collected."""
        pending = None
        failed = []
        for pi, part in enumerate(target_parts):
            with trace.timed("cds.decode", stage_totals, "decode"):
                if pending is None:
                    t_imgs, t_entities, t_failed = decode(part)
                else:
                    with trace.span("cds.decode.wait"):
                        t_imgs, t_entities, t_failed = pending.result()
                if pi + 1 < len(target_parts):
                    pending = prefetcher.submit(decode,
                                                target_parts[pi + 1])
            failed.extend(t_failed)
            if t_imgs:
                yield (t_entities, failed), np.stack(t_imgs)
                failed = []
        unscored_failures.extend(failed)

    # batched incremental flushes to the store (ColorDepthSearchCmd.java:
    # 316-335 --write-batch-size; whole-mask JSON files are written at the
    # end): only rows of collected partitions are ever in all_matches
    flushed = 0

    def maybe_flush():
        nonlocal flushed
        if writes and args.db and args.write_batch_size > 0 \
                and len(all_matches) - flushed >= args.write_batch_size:
            with trace.timed("cds.write", stage_totals, "write"):
                matches_writer(args.db, None,
                               update_scores_only=args.update_matches).write(
                    all_matches[flushed:])
            flushed = len(all_matches)
            _test_kill_hook()

    if dense:
        scored = _dense_parts(args, decoded_parts(), prepared, devices, zt9,
                              stage_totals)
    else:
        screen = u_matrix = thresholds = None
        if args.prescreen == "on":
            with trace.timed("cds.features", stage_totals, "features"):
                first = prepared[0][1]
                screen = PairPrescreen(zt9, args.xyShift, first.tiles.height,
                                       first.tiles.width)
                u_matrix = np.stack([screen.query_features(eng.planes.words)
                                     for _, eng in prepared])
                thresholds = np.array(
                    [max(ratio_threshold * q, 0.5) for q in query_sizes])
        sweep = TwoPhaseSweep([eng for _, eng in prepared], devices, screen,
                              u_matrix, thresholds)
        # pipelined: partition p+1 is launched before p's matches are built
        # (and, over several processes, before p's rows are gathered)
        scored = (_gathered_parts(sweep, decoded_parts(), stage_totals)
                  if multi else sweep.sweep_parts(decoded_parts(),
                                                  stage_totals))

    try:
        for (t_entities, failed), scores, mirrored in scored:
            with trace.timed("cds.matches", stage_totals, "matches"):
                record_pair_errors(failed)
                for bi, (mask, _) in enumerate(prepared):
                    query_size = query_sizes[bi]
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
                        mask.add_processed_tag(
                            ProcessingType.ColorDepthSearch, run_tag)
                        target.add_processed_tag(
                            ProcessingType.ColorDepthSearch, run_tag)
                        all_matches.append(m)
            maybe_flush()
    finally:
        prefetcher.shutdown(wait=True)
    record_pair_errors(unscored_failures)

    n_groups = 0
    if writes:
        with trace.timed("cds.write", stage_totals, "write"):
            per_masks = per_targets = None
            if args.output_dir:
                per_masks = os.path.join(args.output_dir, args.perMaskSubdir)
                if args.perTargetSubdir:
                    per_targets = os.path.join(args.output_dir,
                                               args.perTargetSubdir)
            if flushed < len(all_matches) or not flushed:
                n_groups = matches_writer(
                    args.db, per_masks, per_targets,
                    update_scores_only=args.update_matches).write(
                    all_matches[flushed:])
            if args.db:
                # stamp EVERY searched MIP with the run's processing tag,
                # matched or not, so that restartable selection by "lacks tag
                # X" sees the whole processed block (ColorDepthSearchCmd.java:
                # 346-358)
                DBCDMIPsWriter(get_store(args.db)).add_processing_tags(
                    masks + targets, ProcessingType.ColorDepthSearch,
                    {run_tag})
    elif multi and (args.output_dir or args.db):
        LOG.info("process %d: results written by process 0",
                 process_index())
    LOG.info("stage times: %s",
             {k: round(v, 2) for k, v in stage_totals.items()})
    LOG.info("found %d matches (%d masks) in %.1fs",
             len(all_matches), n_groups, time.time() - t_start)
    peak = peak_memory_gib(devices)
    if peak is not None:
        LOG.info("peak device memory %.3f GiB", peak)
    LOG.info("kernel launches %s", json.dumps(kernels.launch_counts()))
    return 0


def _gathered_parts(sweep, parts, stage_totals):
    """(key, scores int64 [B, T], mirrored bool [B, T]) per
    partition of a multi-process two-phase run: each process sweeps its
    block of every partition's targets (device_blocks over processes)
    through the one-process pipelined loop (`sweep_parts`), pads its rows
    to the largest block, and every process gathers them."""
    from ..parallel.multihost import (process_allgather, process_count,
                                      process_index)
    from ..parallel.twophase_sweep import device_blocks

    def own_blocks():
        for key, t_stack in parts:
            blocks = device_blocks(t_stack.shape[0], process_count())
            off, ln = blocks[process_index()]
            yield (key, blocks), t_stack[off:off + ln]

    bsz = len(sweep.engines)
    for (key, blocks), own_s, own_m in sweep.sweep_parts(
            own_blocks(), stage_totals):
        tsz = sum(n for _, n in blocks)
        per = max(n for _, n in blocks)
        s = np.zeros((bsz, per), np.int64)
        m = np.zeros((bsz, per), np.int8)
        s[:, :own_s.shape[1]], m[:, :own_m.shape[1]] = own_s, own_m
        g_s, g_m = process_allgather((s, m))
        scores = np.zeros((bsz, tsz), np.int64)
        mirrored = np.zeros((bsz, tsz), bool)
        for p, (o, n) in enumerate(blocks):
            scores[:, o:o + n] = g_s[p][:, :n]
            mirrored[:, o:o + n] = g_m[p][:, :n].astype(bool)
        yield key, scores, mirrored


def _dense_parts(args, parts, prepared, devices, zt9: int, stage_totals):
    """(key, scores [B, T], mirrored [B, T]) per (key, targets) partition of
    the dense engine: targets packed once per partition, on the mesh's
    devices, and the masks swept in batches of --maskBatchSize over a
    ("mask", "target") mesh of every process's devices, one mask block.
    Neither axis is padded (the JAX package pads both so that its jitted
    sweep sees one shape): the last batch holds what is left, and the
    targets split into balanced blocks (`multihost.distribute`)."""
    from ..parallel.multihost import distribute, global_pair_mesh
    from ..parallel.sweep import sharded_pixel_sweep
    mesh = global_pair_mesh(devices, mask_shards=1)
    shifts = shift_ring_offsets(args.xyShift)
    pad = max(args.xyShift, 1)
    for key, t_stack in parts:
        with trace.timed("dense.pack", stage_totals, "pack"):
            planes = distribute(mesh, ("target", None, None, None),
                                t_stack).map(lambda t: pack_targets(
                                    t, args.dataThreshold, pad))
            t_padded = planes.map(lambda p: p[0])
            t_flipped = planes.map(lambda p: p[1])
        scores, mirrored = [], []
        with trace.timed("dense.score", stage_totals, "score"):
            for block in partition_collection(prepared, args.maskBatchSize):
                q_words = np.stack([qp.words for _, qp in block])
                s, m, _ = sharded_pixel_sweep(mesh, q_words, t_padded,
                                              t_flipped, shifts, zt9,
                                              args.mirrorMask)
                scores.append(s)
                mirrored.append(m)
        yield key, np.concatenate(scores), np.concatenate(mirrored)
