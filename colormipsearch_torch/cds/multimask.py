"""Exact multi-mask scorer: one kernel launch scores many masks.

Counterpart of `colormipsearch_tpu/cds/multimask.py` (:447-782 scorer,
:900-967 signal ranges and live tiles). The two-phase sweep's exact
phase scores each mask's prescreen survivors; one launch covers every
mask of a target partition.

- Host side, each mask's survivors become launch rows (mask, target,
  survivor flag). Each row carries its exact list of live tiles: the
  mask's active tiles whose sampled window can hold target signal (the
  3x3-dilated tile-presence bitmaps of tile_live_from_words, intersected
  with the target's signal row and column intervals). Skipped tiles
  provably score 0, so any exact skip gives the same scores.
- Device side, `multimask_counts` launches the hand-written Hopper kernel
  (`csrc/multimask_ratio.cu`) on CUDA tensors and runs its plain PyTorch
  version, `multimask_counts_plain`, on CPU tensors. `multimask_counts.
  launches` counts kernel launches.

Left out: the tier-2 bin-compat gate (off by default in the reference),
and the adaptive live-table gate, ROWS, G_BUCKET and pow2 k-grid buckets,
which exist for Mosaic's SMEM limits and compile costs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from colormipsearch_tpu.cds.oracle import shift_ring_offsets

from . import kernels
from .pixel_active import TILE_H, TILE_W, DeferredScore

KERNEL_XY_SHIFTS = (0, 2)  # xy_shift values the kernel is built for


# ---- the exact kernel: plain version and wrapper --------------------------

def _ratio_match(rf, fw, qc, qf):
    """Ratio-interval predicate (reference pixel_pallas._ratio_consts and
    _ratio_match): 3 masked equality checks and 4 f32 compares against
    exactly placed bounds. qc int32 [..., 8, 128]; qf f32 [..., 4, 8, 128]."""
    sc, uc, dc = qc & 31, (qc >> 5) & 31, (qc >> 10) & 63
    gup = ((qc >> 16) & 1) > 0
    gdn = ((qc >> 17) & 1) > 0
    lo, hi, cup, cdn = qf.unbind(-3)
    same_ok = ((fw & 15) == sc) & (rf >= lo) & (rf <= hi)
    up_ok = ((fw & 31) == uc) & ((rf <= cup) ^ gup)
    dn_ok = ((fw & 47) == dc) & ((rf <= cdn) ^ gdn)
    return same_ok | up_ok | dn_ok


def _ratio_prep(w):
    """Ratio plane a2/b2 (-1 where a2 == 0) and flag plane w >> 16 of a
    packed window (reference pixel_pallas._ratio_prep)."""
    a2 = (w >> 8) & 0xFF
    rf = a2.to(torch.float32) / (w & 0xFF).to(torch.float32)
    return torch.where(a2 == 0, torch.full_like(rf, -1.0), rf), w >> 16


def _pairs(row_off, tile_list, surv):
    """(row, tile) pairs the kernel scores: every surviving row with every
    tile of its list."""
    counts = (row_off[1:] - row_off[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(counts.numel(), device=tile_list.device), counts)
    tiles = tile_list.to(torch.int64)
    keep = surv.to(torch.int64)[rows] != 0
    return rows[keep], tiles[keep]


def multimask_counts_plain(frames, flipped, q_cmp, q_f32, coords, row_off,
                           tile_list, tgt, surv, xy_shift: int, mirror: bool):
    """Plain PyTorch version of the exact kernel (same arguments).

    frames, flipped: int32 [T, Hp, Wp] ring-padded frames and x-flips;
    q_cmp int32 [NT, 8, 128], q_f32 f32 [NT, 4, 8, 128] and coords int32
    [NT, 2] are the stacked query tiles of every mask; row_off int32
    [R+1] and tile_list int32 [L] give each row's live tiles; tgt and
    surv int32 [R] give each row's target and survivor flag. Returns
    int32 [R, 2|S|] per-variant match counts (direct variants then
    mirrored; mirrored columns are 0 when mirror is off).

    Gathers each (row, tile) window by indexing, builds the ratio and
    flag planes, takes one slice per variant, applies the predicate and
    sums."""
    offsets = shift_ring_offsets(xy_shift)
    ns, s = len(offsets), xy_shift
    out = torch.zeros((tgt.numel(), 2 * ns), dtype=torch.int32,
                      device=tgt.device)
    rows, tiles = _pairs(row_off, tile_list, surv)
    dev = frames.device
    # (row, tile) windows gathered at once: ~40 KB of temporaries each
    pair_batch = 8192 if dev.type == "cuda" else 1024
    ys = torch.arange(TILE_H + 2 * s, device=dev)
    xs = torch.arange(TILE_W + 2 * s, device=dev)
    planes = (frames, flipped) if mirror else (frames,)
    for p0 in range(0, rows.numel(), pair_batch):
        rb, tb = rows[p0:p0 + pair_batch], tiles[p0:p0 + pair_batch]
        ti = tgt.to(torch.int64)[rb][:, None, None]
        ry = (coords[tb, 0].to(torch.int64) + TILE_H - s)[:, None, None]
        rx = (coords[tb, 1].to(torch.int64) + TILE_W - s)[:, None, None]
        yy = ry + ys[None, :, None]
        xx = rx + xs[None, None, :]
        qc, qf = q_cmp[tb], q_f32[tb]
        cnt = torch.zeros((rb.numel(), 2 * ns), dtype=torch.int32,
                          device=dev)
        for pi, plane in enumerate(planes):
            rf, fw = _ratio_prep(plane[ti, yy, xx])
            for vi, (dx, dy) in enumerate(offsets):
                r0, c0 = s + dy, s + dx
                m = _ratio_match(rf[:, r0:r0 + TILE_H, c0:c0 + TILE_W],
                                 fw[:, r0:r0 + TILE_H, c0:c0 + TILE_W],
                                 qc, qf)
                cnt[:, pi * ns + vi] = m.sum(dim=(1, 2), dtype=torch.int32)
        out.index_add_(0, rb, cnt)
    return out


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def multimask_counts(frames, flipped, q_cmp, q_f32, coords, row_off,
                     tile_list, tgt, surv, xy_shift: int, mirror: bool):
    """Exact per-variant counts (see multimask_counts_plain).

    CPU tensors run the plain version. CUDA tensors launch the Hopper
    kernel (built at first use) or raise; there is no fallback."""
    args = (frames, flipped, q_cmp, q_f32, coords, row_off, tile_list,
            tgt, surv)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return multimask_counts_plain(*args, xy_shift, mirror)
    if kinds != {"cuda"}:
        raise ValueError(f"tensors on {sorted(kinds)}: expected all on one "
                         "CUDA device or all on the CPU")
    lib = kernels.load_library().lib
    dev = frames.device
    for name, t, dt, nd in (("frames", frames, torch.int32, 3),
                            ("flipped", flipped, torch.int32, 3),
                            ("q_cmp", q_cmp, torch.int32, 3),
                            ("q_f32", q_f32, torch.float32, 4),
                            ("coords", coords, torch.int32, 2),
                            ("row_off", row_off, torch.int32, 1),
                            ("tile_list", tile_list, torch.int32, 1),
                            ("tgt", tgt, torch.int32, 1),
                            ("surv", surv, torch.int32, 1)):
        _check(name, t, dt, nd, dev)
    if xy_shift not in KERNEL_XY_SHIFTS:
        raise ValueError(f"xy_shift {xy_shift} not in {KERNEL_XY_SHIFTS}")
    n_tiles = q_cmp.shape[0]
    if flipped.shape != frames.shape:
        raise ValueError("frames and flipped differ in shape")
    if (tuple(q_cmp.shape[1:]) != (TILE_H, TILE_W)
            or tuple(q_f32.shape) != (n_tiles, 4, TILE_H, TILE_W)
            or tuple(coords.shape) != (n_tiles, 2)):
        raise ValueError("query tiles must be q_cmp [NT, 8, 128], q_f32 "
                         "[NT, 4, 8, 128] and coords [NT, 2]")
    n_rows = tgt.numel()
    if surv.numel() != n_rows or row_off.numel() != n_rows + 1:
        raise ValueError("tgt and surv need one entry per row and row_off "
                         "one more")
    nv = 2 * len(shift_ring_offsets(xy_shift))
    out = torch.empty((n_rows, nv), dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out
    _, hp, wp = frames.shape
    rc = lib.cms_multimask_ratio(
        frames.data_ptr(), flipped.data_ptr(), hp, wp,
        q_cmp.data_ptr(), q_f32.data_ptr(), coords.data_ptr(),
        row_off.data_ptr(), tile_list.data_ptr(), n_rows, tgt.data_ptr(),
        surv.data_ptr(), xy_shift, int(bool(mirror)), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"multimask_ratio kernel launch failed: "
                           f"cudaError {rc}")
    multimask_counts.launches += 1
    return out


multimask_counts.launches = 0


# ---- live tiles and signal ranges ----------------------------------------

def _sel_any_rowcol(words: torch.Tensor):
    sel = (words >> 19) & 1
    return sel.amax(dim=2), sel.amax(dim=1)  # [T, H], [T, W]


def _first_last(flags: np.ndarray) -> np.ndarray:
    n = flags.shape[1]
    any_f = flags.any(axis=1)
    first = np.where(any_f, flags.argmax(axis=1), 0).astype(np.int32)
    last = np.where(any_f, n - 1 - flags[:, ::-1].argmax(axis=1),
                    -1).astype(np.int32)
    return np.stack([first, last], axis=1)


def row_ranges_from_words(words: torch.Tensor) -> np.ndarray:
    """int32 [T, 2] (first, last) above-threshold signal row per packed
    target frame; (0, -1) for empty targets."""
    rows = _sel_any_rowcol(words)[0].cpu().numpy() > 0
    return _first_last(rows)


def signal_ranges_from_words(words: torch.Tensor) -> np.ndarray:
    """int32 [T, 4] (first_row, last_row, first_col, last_col) signal
    extents per packed target frame (raw-frame coordinates); (0, -1) for
    empty targets."""
    r, c = _sel_any_rowcol(words)
    return np.concatenate([_first_last(r.cpu().numpy() > 0),
                           _first_last(c.cpu().numpy() > 0)], axis=1)


def _tile_live_dev(words: torch.Tensor, gh: int, gw: int):
    tsz, h, w = words.shape
    sel = ((words >> 19) & 1) > 0  # [T, H, W]

    def pool_dilate(s):
        p = torch.nn.functional.pad(s, (0, gw * TILE_W - w,
                                        0, gh * TILE_H - h))
        t = p.reshape(tsz, gh, TILE_H, gw, TILE_W).any(dim=4).any(dim=2)
        t = torch.nn.functional.pad(t, (1, 1, 1, 1))
        t = t[:, :-2] | t[:, 1:-1] | t[:, 2:]
        return t[:, :, :-2] | t[:, :, 1:-1] | t[:, :, 2:]

    # the mirror flip is of the RAW w-wide plane (pad_from_words), so
    # flip BEFORE the tile-alignment padding
    return pool_dilate(sel), pool_dilate(torch.flip(sel, dims=(2,)))


def tile_live_from_words(words: torch.Tensor) -> tuple:
    """Per-target 3x3-dilated tile-presence bitmaps, (direct, mirrored),
    each np.bool_ [T, gh, gw] over the mask tile grid: does target j
    (resp. its x-flip) have above-threshold signal in the 3x3 tile
    neighbourhood that every shift of the tile at (ty, tx) samples?"""
    _, h, w = words.shape
    d, m = _tile_live_dev(words, -(-h // TILE_H), -(-w // TILE_W))
    return d.cpu().numpy(), m.cpu().numpy()


# ---- the scorer ----------------------------------------------------------

@dataclass
class LaunchTable:
    """Host launch table of one exact launch."""
    row_off: np.ndarray     # int32 [R + 1] offsets into tile_list
    tile_list: np.ndarray   # int32 [L] stacked-tile indices, row by row
    tgt: np.ndarray         # int32 [R] target per row
    surv: np.ndarray        # int32 [R] survivor flag (all 1 from build_table)
    # engine position -> (row indices, their target indices)
    spans: dict = field(default_factory=dict)


def launch_params(engine) -> tuple:
    """The CDS params that engines of one launch must share (zTolerance,
    xyShift)."""
    return engine.zt9, engine.xy_shift


def shared_params(engines) -> bool:
    """Whether engines can share one launch."""
    return len({launch_params(e) for e in engines}) == 1


class MultiMaskScorer:
    """One-launch-many-masks exact sweep over a shared target block.

    engines: ActiveTilePixelEngine per mask; they must share zTolerance
    and xyShift. Their query tiles are stacked once on the host and
    uploaded once per device."""

    def __init__(self, engines: Sequence):
        self.engines = list(engines)
        if not self.engines:
            raise ValueError("no engines")
        if not shared_params(self.engines):
            raise ValueError("a multi-mask launch needs shared CDS params "
                             "(zTolerance, xyShift)")
        self.zt9 = self.engines[0].zt9
        self.xy_shift = self.engines[0].xy_shift
        self.shifts = self.engines[0].shifts
        self.mirror = any(e.mirror_query for e in self.engines)
        sizes = {(e.tiles.height, e.tiles.width) for e in self.engines}
        if len(sizes) != 1:
            raise ValueError(f"masks of different sizes: {sorted(sizes)}")
        h, w = sizes.pop()
        # the padded frame the tiles' windows index (pad_from_words)
        self.frame_shape = (-(-h // TILE_H) * TILE_H + 2 * TILE_H,
                            -(-w // TILE_W) * TILE_W + 2 * TILE_W)
        counts = [e.tiles.n_active for e in self.engines]
        self._tile_off = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        tiles = [e.tiles for e in self.engines]
        self._q_host = (
            np.concatenate([t.q_cmp for t in tiles]).astype(np.int32),
            np.concatenate([t.q_f32 for t in tiles]).astype(np.float32),
            np.concatenate([t.coords for t in tiles]).astype(np.int32))
        self._q_dev = {}  # torch.device -> (q_cmp, q_f32, coords)

    def _q_for(self, device: torch.device):
        got = self._q_dev.get(device)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device) for a in self._q_host)
            self._q_dev[device] = got
        return got

    def build_table(self, survivors: np.ndarray,
                    signal_ranges: Optional[np.ndarray] = None,
                    tile_live: Optional[tuple] = None) -> LaunchTable:
        """Rows and live-tile lists for `survivors` int [B, T].

        signal_ranges: optional int32 [T, 2] or [T, 4] row (and column)
        signal extents; tile_live: optional (direct, mirrored) bitmaps.
        Either restricts each row's tiles to those that can score."""
        s = max((abs(dy) for _, dy in self.shifts), default=0)
        sx = max((abs(dx) for dx, _ in self.shifts), default=0)
        row_counts, tiles_l, tgt_l = [], [], []
        spans = {}
        n_rows = 0
        for pos, eng in enumerate(self.engines):
            sidx = np.nonzero(survivors[pos])[0]
            if len(sidx) == 0:
                continue
            n = len(sidx)
            dest = sidx.astype(np.int32)
            t = eng.tiles
            cy, cx = t.coords[:, 0], t.coords[:, 1]
            live = np.ones((n, t.n_active), bool)
            if tile_live is not None:
                per_t = (tile_live[0] | tile_live[1]) if eng.mirror_query \
                    else tile_live[0]
                live &= per_t[dest][:, cy // TILE_H, cx // TILE_W]
            if signal_ranges is not None:
                # a tile's shifts sample raw rows [cy - s, cy + 8 + s) and
                # cols [cx - sx, cx + 128 + sx); the mirror pass samples
                # the x-flipped raw plane, whose signal cols are the
                # reflection of the target's about (w - 1) / 2
                rr = signal_ranges[dest].astype(np.int64)
                live &= ((cy[None] >= rr[:, :1] - TILE_H - s + 1)
                         & (cy[None] <= rr[:, 1:2] + s))
                if rr.shape[1] >= 4:
                    c0, c1 = rr[:, 2:3], rr[:, 3:4]
                    cok = ((cx[None] >= c0 - TILE_W - sx + 1)
                           & (cx[None] <= c1 + sx))
                    if eng.mirror_query:
                        w = t.width
                        cok |= ((cx[None] >= w - 1 - c1 - TILE_W - sx + 1)
                                & (cx[None] <= w - 1 - c0 + sx))
                    live &= cok
            row, tl = np.nonzero(live)
            row_counts.append(np.bincount(row, minlength=n))
            tiles_l.append((self._tile_off[pos] + tl).astype(np.int32))
            tgt_l.append(dest)
            spans[pos] = (n_rows + np.arange(n), sidx)
            n_rows += n
        cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs
               else np.zeros(0, dt))
        counts = cat(row_counts, np.int64)
        return LaunchTable(
            row_off=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            tile_list=cat(tiles_l, np.int32), tgt=cat(tgt_l, np.int32),
            surv=np.ones(n_rows, np.int32), spans=spans)

    def launch_deferred(self, packed, survivors: np.ndarray,
                        signal_ranges: Optional[np.ndarray] = None,
                        tile_live: Optional[tuple] = None
                        ) -> List[DeferredScore]:
        """Queue the exact sweep of ALL masks over one packed target block
        (on the frames' device); returns one DeferredScore per engine
        (drain with pixel_active.drain_deferred: the shared output is
        copied once)."""
        frames, flipped = packed
        if tuple(frames.shape[1:]) != self.frame_shape:
            raise ValueError(f"padded frames {tuple(frames.shape[1:])} do "
                             f"not fit masks padded to {self.frame_shape}")
        dev = frames.device
        tsz = frames.shape[0]
        surv_np = np.asarray(survivors).astype(np.int32)
        tab = self.build_table(surv_np, signal_ranges, tile_live)
        q_cmp, q_f32, coords = self._q_for(dev)
        up = [torch.from_numpy(a).to(dev) for a in
              (tab.row_off, tab.tile_list, tab.tgt, tab.surv)]
        out = multimask_counts(frames, flipped, q_cmp, q_f32, coords, *up,
                               self.xy_shift, self.mirror)
        pendings = [[] for _ in self.engines]
        for pos, (rows, dest) in tab.spans.items():
            pendings[pos].append((dest, out, rows))
        return [DeferredScore(e, tsz, pendings[i], surv_np[i])
                for i, e in enumerate(self.engines)]
