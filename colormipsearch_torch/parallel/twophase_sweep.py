"""Two-phase sweep (prescreen bound, then exact scoring) over CUDA devices.

Counterpart of `colormipsearch_tpu/parallel/pallas_sweep.py` (:33-176).
Targets are block-partitioned over the given devices and each device
runs the whole pipeline on its shard: pack words, pad (for the ratio
predicate, into its prepared target planes), prescreen bound, live tiles
and launch table, exact kernel launch, and the reduction of its counts
to scores and mirrored flags (row_reduce) with their copy to the host.
Every (mask, target) score is independent, so shards need no
collectives. Launches are queued on each device's current stream;
collect() waits for a partition's copies and unpacks each block.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cds.multimask import (MultiMaskScorer, launch_params,
                             signal_extents, tile_live_dev)
from ..cds.pixel_active import pad_for_predicate
from ..cds.prescreen import sparse_query_rows
from ..utils import trace


def device_blocks(n: int, n_devices: int) -> List[Tuple[int, int]]:
    """Balanced contiguous (offset, length) blocks of n items over
    n_devices devices (first n % n_devices blocks get one extra)."""
    base, extra = divmod(n, n_devices)
    blocks, off = [], 0
    for d in range(n_devices):
        ln = base + (1 if d < extra else 0)
        blocks.append((off, ln))
        off += ln
    return blocks


class TwoPhaseSweep:
    """Two-phase exact sweep over the given devices.

    engines: one ActiveTilePixelEngine per mask.
    devices: the torch.devices to shard targets over (explicit).
    screen/u_matrix/thresholds: optional prescreen — u_matrix is the
      stacked [B, F] query feature matrix (its CSR, `sparse_query_rows`,
      is built once per device), thresholds the per-mask keep thresholds
      in pixels. Without a screen every pair is scored exactly.

    Each group of engines that share CDS params (zTolerance, xyShift) gets
    one multi-mask launch per device and partition."""

    def __init__(self, engines: Sequence, devices: Sequence, screen=None,
                 u_matrix: Optional[np.ndarray] = None,
                 thresholds: Optional[np.ndarray] = None):
        self.engines = list(engines)
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices")
        self.screen = screen
        self.u_matrix = u_matrix
        self.thresholds = thresholds
        self._rows_dev = {}
        by_params = {}
        for i, e in enumerate(self.engines):
            by_params.setdefault(launch_params(e), []).append(i)
        self.groups = [(np.array(idx), MultiMaskScorer(
                            [self.engines[i] for i in idx]))
                       for idx in by_params.values()]

    def _u_for(self, device):
        """The query features' CSR on `device` (built on the first call)."""
        got = self._rows_dev.get(device)
        if got is None:
            got = sparse_query_rows(self.u_matrix).to(device)
            self._rows_dev[device] = got
        return got

    def launch(self, targets_u8: np.ndarray, stage: Optional[dict] = None,
               sync: bool = False):
        """Queue the full two-phase sweep of one target batch on every
        device; returns a handle for collect(). Only the bounds copy to
        the host waits for a device.

        stage: optional dict that accumulates host seconds per stage
        (pack, pad, bound, live, launch: the seconds of the spans
        sweep.pack, sweep.pad, sweep.bound, sweep.live and
        sweep.exact_launch) and the count of screened-out pairs. sync:
        end each stage with a device synchronize, so that its seconds
        include its device work (a profiling aid: it stops the device
        work of one stage from overlapping the next)."""
        tsz = targets_u8.shape[0]
        launched = []  # (offset, length, [(mask indices, ScoreBlock)])
        with trace.span("sweep.part") as part:
            for dev, (off, ln) in zip(self.devices,
                                      device_blocks(tsz, len(self.devices))):
                if ln == 0:
                    continue
                launched.append((off, ln, self._launch_block(
                    targets_u8[off:off + ln], dev, stage, sync and stage
                    is not None and dev.type == "cuda")))
        return tsz, launched, part.job

    def _launch_block(self, targets_u8: np.ndarray, dev, stage, sync):
        """launch() on one device's block: [(mask indices, ScoreBlock)],
        one per group."""
        def settle():
            if sync:
                torch.cuda.synchronize(dev)

        ln = targets_u8.shape[0]
        with trace.timed("sweep.pack", stage, "pack"):
            words = self.engines[0].pack_raw_words(targets_u8, dev)
            settle()
        # each predicate's padded target planes, once per block
        with trace.timed("sweep.pad", stage, "pad"):
            predicates = {scorer.predicate for _, scorer in self.groups}
            packed = {p: pad_for_predicate(words, p) for p in predicates}
            settle()
        if self.screen is None:
            survivors = np.ones((len(self.engines), ln), np.int32)
        else:
            with trace.timed("sweep.bound", stage, "bound"):
                bounds = self.screen.bounds_from_words(self._u_for(dev),
                                                       words)  # [B, ln]
                survivors = (bounds > self.thresholds[:, None]).astype(
                    np.int32)
                if stage is not None:
                    stage["screened"] = stage.get("screened", 0) + int(
                        (survivors == 0).sum())
                settle()
        # the launch table's inputs, where the words are (a card builds
        # the table there)
        with trace.timed("sweep.live", stage, "live"):
            ranges = signal_extents(words)
            live = tile_live_dev(words)
            del words
            settle()
        with trace.timed("sweep.exact_launch", stage, "launch"):
            blocks = [(idx, scorer.launch_block(
                packed[scorer.predicate], survivors[idx],
                signal_ranges=ranges, tile_live=live))
                for idx, scorer in self.groups]
            settle()
        return blocks

    def collect(self, handle):
        """Drain one launch()'s results (all devices, all masks): each
        group's block, once its copy has landed; returns (scores int64
        [B, T], mirrored bool [B, T]) in target order."""
        tsz, launched, job = handle
        bsz = len(self.engines)
        scores = np.zeros((bsz, tsz), dtype=np.int64)
        mirrored = np.zeros((bsz, tsz), dtype=bool)
        with trace.span("sweep.collect", job=job):
            for off, ln, blocks in launched:
                for idx, block in blocks:
                    s, m = block.result()
                    scores[idx, off:off + ln] = s
                    mirrored[idx, off:off + ln] = m
        return scores, mirrored

    def sweep(self, targets_u8: np.ndarray, stage: Optional[dict] = None):
        """launch + collect in one call."""
        return self.collect(self.launch(targets_u8, stage))

    def sweep_parts(self, parts: Iterable, stage: Optional[dict] = None,
                    sync: bool = False):
        """Pipelined sweep of many partitions: yields (key, scores,
        mirrored) for each (key, targets_u8) of `parts`, in order.
        Partition p+1 is launched before partition p is collected, so the
        host work of p's collect and of the caller's use of p overlaps the
        device work of p+1; p's copy to the host is queued behind p's own
        launch, so its collect does not wait for p+1's."""
        inflight = None
        for key, targets_u8 in parts:
            nxt = (key, self.launch(targets_u8, stage, sync))
            if inflight is not None:
                yield (inflight[0],) + self.collect(inflight[1])
            inflight = nxt
        if inflight is not None:
            yield (inflight[0],) + self.collect(inflight[1])
