"""gradientScores command: shape-score re-ranking of top CDS matches.

Counterpart of `colormipsearch_tpu/cmd/gradientscores_cmd.py`
(cmd/CalculateGradientScoresCmd.java:71-647): list masks with matches ->
read + filter matches -> select best lines/samples/matches -> per-mask
query planes built once -> target planes built on the device in batches
and kept in a byte-bounded LRU -> batched shape scoring -> per-mask
normalization -> write updates + tags. Matches are the per-mask JSON
files of colorDepthSearch (`-md`) or the rows of its `--db` store, where
only the scored fields of each match are updated. The device work runs on `--device`:
"cuda" is every visible card (the JAX package's `grad_devices`, every
local device), "cuda:N" one card, "cpu" the CPU. Plane builds go
round-robin over the devices, each target's planes stay in the plane
cache on the device that built them, and each batch is scored per
device, where its planes live (the ROI two-pass branch moves its planes
to the first device).

Target frames decode on a thread pool; their planes derive on the device
from the raw u8 frames (`cds/shape_device.py`). The host plane builds of
`cds/shape_oracle.py` run only where the reference's do: ROI-mask runs
(query planes) and non-RGB images. The plane cache keeps its budget of
4 GiB and 2048 entries, counted in the planes' real bytes.

`--process-id/--process-count` (defaults from CMS_PROCESS_ID and
CMS_PROCESS_COUNT) split the sorted mask list into contiguous blocks,
one per process, as the reference's job arrays shard mask mipIds
(submitGAJob.sh:50-60). Each process rewrites the per-mask files, or
updates the store rows, of its own masks, so the processes may share one
`-md` or one `--db` (the SQLite store's WAL journal and busy timeout let
concurrent processes write one file).

Score updates flush every `--write-batch-size` matches;
`CMS_TEST_KILL_AFTER_GA_FLUSHES=N` (a test hook, as in the JAX package)
SIGKILLs the process after its Nth flush. The updates are idempotent, so
rerunning the command converges to the result of one uninterrupted run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from ..cds import kernels, shape_device
from ..cds.shape_kernel import (CheckedPlanes, finish_shape_scores,
                                shape_rows_cached)
from ..cds.shape_oracle import (QueryShapePlanes, TargetShapePlanes,
                                build_mirrored_query_shape_planes,
                                build_query_shape_planes,
                                build_target_shape_planes)
from ..dataio import DataSourceParam, ScoresFilter
from ..device import peak_memory_gib, resolve_devices
from ..imageproc.io import ImageKind, load_image
from ..mips import MIPsCache
from ..model import CDMatchEntity, ComputeFileType, ProcessingType
from ..results import (group_matches_by_mask, normalize_match_scores,
                       partition_collection, select_best_matches)
from .args import (add_cds_params, add_common_args, check_grid,
                   excluded_regions_for)
from .backends import matches_reader, matches_writer

LOG = logging.getLogger(__name__)

PLANES_CACHE_BYTES = 4 << 30
PLANES_CACHE_ENTRIES = 2048

_FLUSH_COUNT = 0


def _test_kill_hook() -> None:
    """Fault injection for the kill-and-resume tests: SIGKILL after the
    Nth batched score flush when CMS_TEST_KILL_AFTER_GA_FLUSHES is set (a
    GA grid job dying mid-run; the reference resubmits the same
    mask-block offsets, submitGAJob.sh:50-60,
    CalculateGradientScoresCmd.java:602-614)."""
    n = os.environ.get("CMS_TEST_KILL_AFTER_GA_FLUSHES")
    if not n:
        return
    global _FLUSH_COUNT
    _FLUSH_COUNT += 1
    if _FLUSH_COUNT >= int(n):
        os.kill(os.getpid(), signal.SIGKILL)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("gradientScores",
                              help="gradient/shape score re-ranking")
    add_common_args(p)
    add_cds_params(p)
    p.add_argument("-md", "--matchesDir", default=None,
                   help="per-mask matches dir (from colorDepthSearch)")
    p.add_argument("--db", default=None,
                   help="read/write matches in this SQLite store (or a "
                        "mongodb:// URI)")
    p.add_argument("--masks-mip-ids", nargs="*", default=None,
                   help="only process these mask MIP ids")
    p.add_argument("--nBestLines", type=int, default=-1)
    p.add_argument("--nBestSamplesPerLine", type=int, default=-1)
    p.add_argument("--nBestMatchesPerSample", type=int, default=-1)
    p.add_argument("--targetsPerBatch", type=int, default=128,
                   help="max targets scored per device step")
    p.add_argument("--planes-threads", type=int, default=0,
                   help="host threads decoding target frames "
                        "(0 = cpu count)")
    p.add_argument("--processing-tag", default=None)
    p.add_argument("--masks-tags", nargs="*", default=[],
                   help="only rescore masks carrying these tags "
                        "(AbstractGradientScoresArgs.java mask selectors)")
    p.add_argument("--masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="only rescore masks stamped with these processing "
                        "tags (AbstractGradientScoresArgs.java:58)")
    p.add_argument("--cancel-previous-gradient-scores", action="store_true")
    p.add_argument("--use-bidirectional-matching", action="store_true",
                   help="accepted for command-line compatibility; 3D "
                        "bidirectional shape matching is not computed "
                        "(CalculateGradientScoresCmd.java:89-94 hard-codes "
                        "it false)")
    p.add_argument("--computeZGapOnTheFly", action="store_true",
                   help="derive missing ZGap variants by 10px dilation")
    p.add_argument("--write-batch-size", type=int, default=10000,
                   help="flush score updates once this many matches are "
                        "pending (0 = one flush at the end; "
                        "CalculateGradientScoresCmd.java:602-614)")
    p.add_argument("--process-id", type=int,
                   default=int(os.environ.get("CMS_PROCESS_ID", -1)),
                   help="grid block index for multi-process runs: this "
                        "process rescores its block of the sorted masks")
    p.add_argument("--process-count", type=int,
                   default=int(os.environ.get("CMS_PROCESS_COUNT", 0)),
                   help="total grid processes")
    p.add_argument("--device", default="cuda",
                   help="torch device(s) for planes and scoring: cuda "
                        "(every visible card), cuda:N or cpu")
    p.set_defaults(func=run)


def run(args: argparse.Namespace) -> int:
    if not args.matchesDir and not args.db:
        raise SystemExit("gradientScores reads and rewrites the matches of "
                         "-md/--matchesDir or of the --db store")
    check_grid(args)
    devices = resolve_devices(args.device)
    t_start = time.time()
    reader = matches_reader(args.db, args.matchesDir)
    ptags = {}
    for spec in args.masks_processing_tags or []:
        stage, _, tag = spec.partition("=")
        if tag:
            ptags.setdefault(stage, set()).add(tag)
    mask_selector = DataSourceParam(
        mip_ids=args.masks_mip_ids or [],
        tags=set(args.masks_tags or []),
        processing_tags=ptags)
    selector = DataSourceParam(mip_ids=args.masks_mip_ids or [])
    mask_locations = reader.list_match_locations([selector])
    LOG.info("found %d masks with matches; scoring on %s",
             len(mask_locations), devices)
    if args.process_count > 0 and args.process_id >= 0:
        # deterministic, restartable block of the sorted mask list, the
        # same in every process (the reference's job arrays shard mask
        # mipIds, submitGAJob.sh:50-60)
        from ..parallel.twophase_sweep import device_blocks
        off, ln = device_blocks(len(mask_locations),
                                args.process_count)[args.process_id]
        mask_locations = mask_locations[off:off + ln]
        LOG.info("process %d/%d owns %d masks (offset %d)",
                 args.process_id, args.process_count, ln, off)

    array_store = None
    if args.array_cache:
        from ..imageproc.store import PackedArrayStore
        array_store = PackedArrayStore(args.array_cache)
    cache = MIPsCache(args.cacheSize, array_store=array_store)
    scores_filter = ScoresFilter()
    if args.pctPositivePixels:
        scores_filter.add("matchingRatio", args.pctPositivePixels / 100.0)
    # the reference loads the ROI mask once per mask; it is one file
    roi_mask = (load_image(args.queryROIMaskName)
                if args.queryROIMaskName else None)

    updated: List[CDMatchEntity] = []
    planes_cache = PlaneCache(devices)
    # one writer, batched flushes across masks; pending lists always hold
    # a mask's FULL match list, so the grouped per-mask rewrite never
    # loses rows (field-level updates on the store)
    writer = matches_writer(args.db, args.matchesDir)
    update_fields = ["gradientAreaGap", "highExpressionArea",
                     "normalizedScore"]
    pending_updates: List[CDMatchEntity] = []

    def flush_updates(force: bool = False):
        if not pending_updates:
            return
        if force or (args.write_batch_size > 0
                     and len(pending_updates) >= args.write_batch_size):
            writer.write_updates(pending_updates, update_fields)
            pending_updates.clear()
            _test_kill_hook()

    for mip_id in mask_locations:
        sel = DataSourceParam(mip_ids=[mip_id],
                              tags=mask_selector.tags,
                              processing_tags=mask_selector.processing_tags)
        matches = reader.read_matches_by_mask(
            sel,
            scores_filter=None if scores_filter.empty else scores_filter)
        if not matches:
            continue
        if args.cancel_previous_gradient_scores:
            for m in matches:
                m.reset_gradient_scores()
        selected = select_best_matches(matches, args.nBestLines,
                                       args.nBestSamplesPerLine,
                                       args.nBestMatchesPerSample)
        scored_for_mask: List[CDMatchEntity] = []
        # a single mip id may map to multiple mask entities
        # (NormalizeGradientScoresCmd.java:270-273)
        for mask_matches in group_matches_by_mask(selected).values():
            mask = mask_matches[0].mask_image
            mask_img = cache.load_mip(
                mask, ComputeFileType.InputColorDepthImage).image
            if mask_img is None:
                LOG.warning("no CDM for mask %s", mip_id)
                continue
            excluded = excluded_regions_for(args, mask_img.height,
                                            mask_img.width)
            qplanes = _build_qplanes(mask_img, excluded, roi_mask,
                                     args.border, devices[0])
            qplanes_m = None
            if roi_mask is not None and args.mirrorMask:
                # the reference mirrors the query but NOT the ROI, so the
                # mirrored orientation needs its own plane set
                qplanes_m = _to_device(build_mirrored_query_shape_planes(
                    mask_img, excluded, roi_mask, args.border), devices[0])
            scored_for_mask.extend(score_mask_partitions(
                mask_matches, qplanes, cache, args, excluded,
                planes_cache, qplanes_m))
        # normalization runs over the selected+scored matches only
        # (CalculateGradientScoresCmd.java:213-247)
        normalize_match_scores(scored_for_mask)
        updated.extend(scored_for_mask)
        tag = args.processing_tag or "gradientScore"
        for m in scored_for_mask:
            if m.mask_image is not None:
                m.mask_image.add_processed_tag(ProcessingType.GradientScore, tag)
            if m.matched_image is not None:
                m.matched_image.add_processed_tag(ProcessingType.GradientScore, tag)
        # queue the mask's FULL match list, the scored subset carrying
        # its updates (whole-group rewrite of the per-mask file)
        pending_updates.extend(matches)
        flush_updates()
    flush_updates(force=True)
    LOG.info("updated %d matches in %.1fs (target planes: %d cached, "
             "%d built on the host; decode %.2fs, plane builds %.2fs)",
             len(updated), time.time() - t_start, len(planes_cache),
             planes_cache.host_builds, planes_cache.seconds["decode"],
             planes_cache.seconds["planes"])
    peak = peak_memory_gib(devices)
    if peak is not None:
        LOG.info("peak device memory %.3f GiB", peak)
    LOG.info("kernel launches %s", json.dumps(kernels.launch_counts()))
    return 0


# ---- query planes ----------------------------------------------------------

def _to_device(qp: QueryShapePlanes, device) -> QueryShapePlanes:
    """Host-built query planes on `device`, with their active-rows vector."""
    row_any = qp.q_nonzero.any(axis=1) | qp.high_expr.astype(bool).any(axis=1)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    return QueryShapePlanes(
        q_nonzero=up(qp.q_nonzero, bool), q_slice=up(qp.q_slice, np.int16),
        q_mask=up(qp.q_mask, bool), high_expr=up(qp.high_expr, bool),
        height=qp.height, width=qp.width, row_any=row_any)


def _build_qplanes(mask_img, excluded, roi_mask, border: int, device):
    """Per-mask query shape planes on the device; the host path for
    ROI-mask runs and non-RGB masks, as the reference's."""
    if roi_mask is None and mask_img.kind == ImageKind.RGB:
        return shape_device.build_query_planes(mask_img.pixels, excluded,
                                               border, device=device)
    return _to_device(build_query_shape_planes(mask_img, excluded, roi_mask,
                                               border), device)


# ---- target planes ---------------------------------------------------------

def _planes_nbytes(entry) -> int:
    if entry is None:
        return 0  # a target with missing files
    planes = entry.planes
    return sum(t.numel() * t.element_size()
               for t in (planes.t_above, planes.grad, planes.z_nonzero,
                         planes.z_slice))


class PlaneCache:
    """Target planes resident on the devices that built them, keyed by
    target, in a byte- and entry-bounded LRU. Under low host memory it
    halves (more recomputation, never an OOM; AbstractCmd.java:52-62
    analogue). A target whose files are missing is cached as None.

    devices: a device or a list of them; plane builds take them in turn
    (`next_slot`), and `slot(key)` is the index of the device that holds
    a target's planes. An entry may repeat: the slots still split the
    work. Each target's planes are checked once, at insert, and held as
    `CheckedPlanes` with their data pointers (`entry`), from which G1's
    pointer table is built. `seconds` accumulates the host seconds of the
    cold path:
    "decode" (thread-pooled image decode) and "planes" (upload and device
    build; with `sync` set, the build's device work too). `host_builds`
    counts targets whose planes were built on the host (non-RGB
    images)."""

    def __init__(self, devices, max_bytes: int = PLANES_CACHE_BYTES,
                 max_entries: int = PLANES_CACHE_ENTRIES):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [torch.device(d) for d in devices]
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self.sync = False
        self.host_builds = 0
        self.seconds = {"decode": 0.0, "planes": 0.0}
        # key -> (CheckedPlanes or None, slot)
        self._planes: OrderedDict = OrderedDict()
        self._nbytes = 0
        self._next = 0
        # the last mask's query planes (two sets with an ROI mask) per device
        self._query: dict = {}
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._planes)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._planes

    @property
    def nbytes(self) -> int:
        """Bytes of the cached planes."""
        return self._nbytes

    def next_slot(self) -> int:
        """The device slot of the next plane build (round-robin)."""
        slot = self._next
        self._next = (self._next + 1) % len(self.devices)
        return slot

    def entry(self, key):
        """The CheckedPlanes of `key` (None if missing), refreshed as most
        recently used."""
        with self._lock:
            got = self._planes.get(key)
            if got is None:
                return None
            self._planes.move_to_end(key)
            return got[0]

    def get(self, key):
        """The planes of `key` (None if missing), refreshed as most
        recently used."""
        entry = self.entry(key)
        return entry.planes if entry is not None else None

    def slot(self, key) -> int:
        """Index into `devices` of the device holding key's planes."""
        with self._lock:
            return self._planes[key][1]

    def insert(self, key, planes, slot: int = 0) -> None:
        """Cache a target's planes (None for missing files), checked here
        (CheckedPlanes raises on a plane G1 cannot read)."""
        entry = CheckedPlanes(planes) if planes is not None else None
        with self._lock:
            old = self._planes.pop(key, None)
            self._nbytes -= _planes_nbytes(old and old[0])
            size = _planes_nbytes(entry)
            while self._planes and (len(self._planes) >= self.max_entries
                                    or self._nbytes + size > self.max_bytes):
                _, evicted = self._planes.popitem(last=False)
                self._nbytes -= _planes_nbytes(evicted[0])
            self._planes[key] = (entry, slot)
            self._nbytes += size
        from ..utils.memguard import shared_guard
        shared_guard().relieve(self._evict_half, "plane-cache")

    def _evict_half(self) -> int:
        with self._lock:
            n = len(self._planes) // 2
            for _ in range(n):
                _, evicted = self._planes.popitem(last=False)
                self._nbytes -= _planes_nbytes(evicted[0])
        return n

    def query_on(self, qplanes: QueryShapePlanes, device) -> QueryShapePlanes:
        """A mask's query planes on `device`, copied device to device once
        per mask (the copies of the last two plane sets are kept)."""
        device = torch.device(device)
        if qplanes.q_nonzero.device == device:
            return qplanes
        held = self._query.get(id(qplanes))
        if held is None or held[0] is not qplanes:
            if len(self._query) >= 2:  # this mask's two orientations
                self._query.pop(next(iter(self._query)))
            held = self._query[id(qplanes)] = (qplanes, {})
        copies = held[1]
        got = copies.get(device)
        if got is None:
            got = dataclasses.replace(qplanes, **{
                n: getattr(qplanes, n).to(device)
                for n in ("q_nonzero", "q_slice", "q_mask", "high_expr")})
            copies[device] = got
        return got


def _decode_raw(target, cache: MIPsCache, args):
    """Decode a target's raw frames (thread-pool work). Returns
    (cdm u8 [H,W,3], (grad_arr, grad_is_rgb), zgap u8 [H,W,3] | None)
    or None when required files are missing, or the string "host" when
    the images need the host path (non-RGB CDM/zgap)."""
    cdm = cache.load_mip(target, ComputeFileType.InputColorDepthImage).image
    grad = cache.load_mip(target, ComputeFileType.GradientImage).image
    zgap = cache.load_mip(target, ComputeFileType.ZGapImage).image
    if cdm is None or grad is None or \
            (zgap is None and not args.computeZGapOnTheFly):
        return None
    if cdm.kind != ImageKind.RGB or \
            (zgap is not None and zgap.kind != ImageKind.RGB):
        return "host"
    if grad.kind == ImageKind.RGB:
        grad_raw = (grad.pixels, True)
    else:
        grad_raw = (grad.pixels.astype(np.uint16), False)
    zgap_px = zgap.pixels if zgap is not None else None
    return (cdm.pixels, grad_raw, zgap_px)


def _planes_host(target, cache: MIPsCache, args, excluded, device):
    """A target's planes built on the host (non-RGB images), uploaded."""
    cdm = cache.load_mip(target, ComputeFileType.InputColorDepthImage).image
    grad = cache.load_mip(target, ComputeFileType.GradientImage).image
    zgap = cache.load_mip(target, ComputeFileType.ZGapImage).image
    p = build_target_shape_planes(cdm, grad, zgap, args.maskThreshold,
                                  excluded)
    return TargetShapePlanes(
        t_above=torch.from_numpy(p.t_above).to(device),
        grad=torch.from_numpy(p.grad.view(np.int16)).to(device),
        z_nonzero=torch.from_numpy(p.z_nonzero).to(device),
        z_slice=torch.from_numpy(p.z_slice.astype(np.int16)).to(device))


def _build_planes_device(raws, args, excluded, planes_cache: PlaneCache):
    """Batched device plane builds: each group of same-(shape, grad kind,
    zgap mode) raw frames is split into one block per device slot, built
    on the slot's device. Returns [(TargetShapePlanes, slot)] in input
    order, each target's planes in tensors of their own, as the build
    writes them (a view of the batch would keep the whole batch alive in
    the cache)."""
    from ..parallel.twophase_sweep import device_blocks
    results = [None] * len(raws)
    groups: dict = {}
    for i, (cdm, (_, grad_is_rgb), zgap_px) in enumerate(raws):
        mode = "file" if zgap_px is not None else "otf"
        groups.setdefault((cdm.shape, grad_is_rgb, mode), []).append(i)
    n_slots = len(planes_cache.devices)
    for (_, grad_is_rgb, mode), idxs in groups.items():
        first = planes_cache.next_slot()
        for d, (off, ln) in enumerate(device_blocks(len(idxs), n_slots)):
            if ln == 0:
                continue
            slot = (first + d) % n_slots
            block = idxs[off:off + ln]
            sets = shape_device.build_target_plane_sets(
                np.stack([raws[i][0] for i in block]),
                np.stack([raws[i][1][0] for i in block]),
                np.stack([raws[i][2] for i in block]) if mode == "file"
                else None, excluded, thr=int(args.maskThreshold),
                zgap_mode=mode, grad_is_rgb=grad_is_rgb,
                device=planes_cache.devices[slot])
            for i, planes in zip(block, sets):
                results[i] = (TargetShapePlanes(*planes), slot)
    return results


def _prefetch_planes(targets, cache, args, excluded,
                     planes_cache: PlaneCache) -> None:
    """Build every missing target's planes: thread-pooled decode, then
    one device build per group of raw frames and device."""
    seen = set()
    missing = []
    for t in targets:
        key = t.entity_id or t.mip_id
        if key not in planes_cache and key not in seen:
            seen.add(key)
            missing.append((key, t))
    if not missing:
        return
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=args.planes_threads
                            or os.cpu_count() or 2) as pool:
        raws = list(pool.map(lambda kt: _decode_raw(kt[1], cache, args),
                             missing))
    t1 = time.perf_counter()
    planes_cache.seconds["decode"] += t1 - t0
    device_keys, device_raws = [], []
    for (key, t), raw in zip(missing, raws):
        if raw is None:
            planes_cache.insert(key, None)
        elif isinstance(raw, str):  # "host": non-RGB edge case
            planes_cache.host_builds += 1
            slot = planes_cache.next_slot()
            planes_cache.insert(key, _planes_host(
                t, cache, args, excluded, planes_cache.devices[slot]), slot)
        else:
            device_keys.append(key)
            device_raws.append(raw)
    if device_raws:
        built = _build_planes_device(device_raws, args, excluded,
                                     planes_cache)
        for key, (planes, slot) in zip(device_keys, built):
            planes_cache.insert(key, planes, slot)
    if planes_cache.sync:
        for device in set(planes_cache.devices):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    planes_cache.seconds["planes"] += time.perf_counter() - t1


# ---- scoring ---------------------------------------------------------------

def score_mask_partitions(mask_matches, qplanes, cache, args, excluded,
                          planes_cache: PlaneCache, qplanes_m=None):
    """Score one mask's matches in targetsPerBatch partitions. Used by the
    CLI run loop and by chip_smoke.py at size."""
    scored_all = []
    for part in partition_collection(mask_matches, args.targetsPerBatch):
        scored_all.extend(_score_batch(part, qplanes, cache, args,
                                       excluded, planes_cache, qplanes_m))
    return scored_all


def _score_batch(part, qplanes, cache: MIPsCache, args, excluded,
                 planes_cache: PlaneCache, qplanes_m=None):
    """Batched shape scoring for one mask's matches: one scorer launch
    per device slot over the targets whose planes it holds (two for the
    ROI-mask case), all queued before any result is read. qplanes_m
    carries the mirrored-orientation plane set for the ROI-mask case."""
    tplanes = []
    slots = []
    scored_matches = []
    want_shape = (qplanes.height, qplanes.width)
    _prefetch_planes([m.matched_image for m in part if m.matched_image],
                     cache, args, excluded, planes_cache)
    for m in part:
        target = m.matched_image
        entry = None
        if target is not None:
            key = target.entity_id or target.mip_id
            if key not in planes_cache:  # evicted since the prefetch
                _prefetch_planes([target], cache, args, excluded,
                                 planes_cache)
            entry = planes_cache.entry(key)
        if entry is None:
            # no negative score possible
            # (Shape2DMatchColorDepthSearchAlgorithm.java:155-158)
            m.gradient_area_gap = -1
            m.high_expression_area = -1
            continue
        if entry.shape != want_shape:
            # size mismatch vs the mask frame: skip rather than fail the
            # whole batch (per-pair failure isolation)
            LOG.warning("target %s planes %s mismatch mask frame %s — "
                        "skipped", target.mip_id, entry.shape, want_shape)
            m.gradient_area_gap = -1
            m.high_expression_area = -1
            continue
        tplanes.append(entry)
        slots.append(planes_cache.slot(key))
        scored_matches.append(m)
    if not tplanes:
        return []

    # crop to the query's active row band: outside it every gap /
    # high-expression term is zero (QueryShapePlanes.active_row_range).
    # The mirror pass only flips columns, so the crop is mirror-safe.
    r0, r1 = qplanes.active_row_range()
    if qplanes_m is not None:
        # ROI-mask path: two identity-orientation passes, the second with
        # mirrored-query planes and flipped z planes; the crop covers
        # the active rows of both orientations
        m0, m1 = qplanes_m.active_row_range()
        r0, r1 = min(r0, m0), max(r1, m1)
    by_slot: dict = {}
    for i, slot in enumerate(slots):
        by_slot.setdefault(slot, []).append(i)

    def score(qp, idxs, device, mirror, flip_z=False):
        # the entries hold their planes' tensors until the launch is
        # queued, and their pointers are the table's
        q = planes_cache.query_on(qp, device)
        return shape_rows_cached(q.q_nonzero, q.q_slice, q.q_mask,
                                 q.high_expr, [tplanes[i] for i in idxs],
                                 r0=r0, r1=r1, mirror=mirror, flip_z=flip_z)

    # every slot's launches are queued before any result is read
    queued = []
    for slot, idxs in by_slot.items():
        device = planes_cache.devices[slot]
        if qplanes_m is None:
            queued.append((idxs, score(qplanes, idxs, device,
                                       args.mirrorMask)))
        else:
            queued.append((idxs, score(qplanes, idxs, device, False),
                           score(qplanes_m, idxs, device, False, True)))
    gaps = np.zeros(len(tplanes), dtype=np.int64)
    high = np.zeros(len(tplanes), dtype=np.int64)
    for idxs, out, *out_m in queued:
        if not out_m:
            gaps[idxs], high[idxs], _, _ = finish_shape_scores(
                *out, mirror=args.mirrorMask)
            continue
        g_i, h_i, s_i, _ = finish_shape_scores(*out, mirror=False)
        g_m, h_m, s_m, _ = finish_shape_scores(*out_m[0], mirror=False)
        use_m = s_m < s_i
        gaps[idxs] = np.where(use_m, g_m, g_i)
        high[idxs] = np.where(use_m, h_m, h_i)
    for i, m in enumerate(scored_matches):
        m.gradient_area_gap = int(gaps[i])
        m.high_expression_area = int(high[i])
        m.bidirectional_area_gap = None
    return scored_matches
