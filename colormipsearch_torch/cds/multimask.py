"""Exact multi-mask scorer: one kernel launch scores many masks.

Counterpart of `colormipsearch_tpu/cds/multimask.py` (:447-782 scorer,
:900-967 signal ranges and live tiles). The two-phase sweep's exact
phase scores each mask's prescreen survivors; one launch covers every
mask of a target partition.

- Host side, each mask's survivors become launch rows (mask, target,
  survivor flag). Each row carries its exact list of
  live tiles, each with the directions (direct, mirrored) in which it
  can score: the mask's active tiles that hold a selected query pixel
  and whose sampled window can hold target signal (the 3x3-dilated
  tile-presence bitmaps of tile_live_from_words, intersected with the
  target's signal row and column intervals). Skipped tiles and
  directions provably score 0, so any exact skip gives the same scores.
  The query side is each mask's compact lists of selected pixels
  (pixel_active.compact_selected), stacked.
- Device side, one kernel per predicate, each with a plain PyTorch
  version that CPU tensors run: `multimask_counts` launches the ratio
  kernel (`csrc/multimask_ratio.cu`, K1), `multimask_words_counts` the
  packed-word kernel (`csrc/multimask_words.cu`, K3a). Each wrapper first
  sorts the table's (row, tile) members into window bins on the device
  (`window_bins`: one bin per target and tile position, so a window is
  staged once for every mask that reads it) and launches one block per
  bin. Each wrapper's `.launches` counts its kernel launches.

Left out: the tier-2 bin-compat gate (CMS_MM_TIER2=1, off by default in
the reference), which cut more of each row's list but lowered the
pipelined rate on the H100 (a net loss, as on the TPU); and the adaptive
live-table gate, ROWS, G_BUCKET and pow2 k-grid buckets, which exist for
Mosaic's SMEM limits and compile costs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import kernels
from .oracle import shift_ring_offsets
from .pixel_active import (POS_SHIFT, TILE_H, TILE_W, DeferredScore,
                           _match_unpacked, _unpack)

KERNEL_XY_SHIFTS = (0, 2)  # xy_shift values the kernels are built for


# ---- the exact kernels: plain versions and wrappers ------------------------

# a tile_list entry: the stacked tile index, and the directions in which
# the (row, tile) can score (host live-tile cut; bit DIR_SHIFT direct,
# bit DIR_SHIFT + 1 mirrored)
DIR_SHIFT = 29
TILE_MASK = (1 << DIR_SHIFT) - 1


def _ratio_match(rf, fw, qc, qf):
    """Ratio-interval predicate (reference pixel_pallas._ratio_consts and
    _ratio_match): 3 masked equality checks and 4 f32 compares against
    exactly placed bounds. qc int32 [...]; qf f32 [..., 4]."""
    sc, uc, dc = qc & 31, (qc >> 5) & 31, (qc >> 10) & 63
    gup = ((qc >> 16) & 1) > 0
    gdn = ((qc >> 17) & 1) > 0
    lo, hi, cup, cdn = qf.unbind(-1)
    same_ok = ((fw & 15) == sc) & (rf >= lo) & (rf <= hi)
    up_ok = ((fw & 31) == uc) & ((rf <= cup) ^ gup)
    dn_ok = ((fw & 47) == dc) & ((rf <= cdn) ^ gdn)
    return same_ok | up_ok | dn_ok


def _pairs(row_off, tile_list, surv):
    """(row, tile) pairs the kernel scores: every surviving row with every
    tile of its list (direction bits dropped: the plain versions score
    both directions, so they also check that the host cut is exact)."""
    counts = (row_off[1:] - row_off[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(counts.numel(), device=tile_list.device), counts)
    tiles = tile_list.to(torch.int64) & TILE_MASK
    keep = surv.to(torch.int64)[rows] != 0
    return rows[keep], tiles[keep]


def _counts_plain(planes, sel_off, coords, row_off, tile_list, tgt, surv,
                  xy_shift: int, mirror: bool, pos_shift: int, query, match):
    """The exact counts for either predicate, as plain torch ops over the
    compact lists: every (row, tile) pair with every selected pixel of
    the tile (entries sel_off[tile] ..), each variant's target value
    gathered from the padded planes by indexing.

    planes: (direct planes, mirrored planes), each a tuple of [T, Hp, Wp]
    tensors; query(entries) -> the entries' constants; match(target
    values, constants) -> bool."""
    offsets = shift_ring_offsets(xy_shift)
    ns = len(offsets)
    dev = tgt.device
    out = torch.zeros((tgt.numel(), 2 * ns), dtype=torch.int32, device=dev)
    rows, tiles = _pairs(row_off, tile_list, surv)
    sel_off = sel_off.to(torch.int64)
    n_sel = sel_off[tiles + 1] - sel_off[tiles]
    keep = n_sel > 0
    rows, tiles, n_sel = rows[keep], tiles[keep], n_sel[keep]
    # (pair, entry) items in batches of ~2**20 (2**16 on the CPU)
    limit = 1 << (20 if dev.type == "cuda" else 16)
    ends = torch.cumsum(n_sel, 0)
    p0 = 0
    while p0 < rows.numel():
        start = int(ends[p0 - 1]) if p0 else 0
        p1 = max(int(torch.searchsorted(ends, start + limit, right=True)),
                 p0 + 1)
        rb, tb, nb = rows[p0:p1], tiles[p0:p1], n_sel[p0:p1]
        item = torch.repeat_interleave(torch.arange(rb.numel(), device=dev),
                                       nb)
        first = torch.cumsum(nb, 0) - nb
        entry = sel_off[tb][item] + torch.arange(item.numel(), device=dev) \
            - first[item]
        q = query(entry)
        pos = (q[0] >> pos_shift) & (TILE_H * TILE_W - 1)
        t = tgt.to(torch.int64)[rb][item]
        y = coords[tb, 0].to(torch.int64)[item] + TILE_H + (pos >> 7)
        x = coords[tb, 1].to(torch.int64)[item] + TILE_W + (pos & 127)
        cnt = torch.zeros((item.numel(), 2 * ns), dtype=torch.int32,
                          device=dev)
        for pi, plane in enumerate(planes[:2 if mirror else 1]):
            for vi, (dx, dy) in enumerate(offsets):
                m = match(tuple(p[t, y + dy, x + dx] for p in plane), q)
                cnt[:, pi * ns + vi] = m.to(torch.int32)
        out.index_add_(0, rb[item], cnt)
        p0 = p1
    return out


def multimask_counts_plain(rf, fw, rf_m, fw_m, sel_off, sel_q, sel_f32,
                           coords, row_off, tile_list, tgt, surv,
                           xy_shift: int, mirror: bool):
    """Plain PyTorch version of the ratio kernel (same arguments).

    rf, fw, rf_m, fw_m: the padded target planes of
    pixel_active.pad_ratio_planes, f32 / uint8 [T, Hp, Wp] (direct, then
    x-flipped); sel_off int32 [NT+1], sel_q int32 [P] and sel_f32 f32
    [P, 4] the stacked compact lists of every mask's NT active tiles
    (pixel_active.compact_selected) and coords int32 [NT, 2] their
    origins; row_off int32 [R+1] and tile_list int32 [L] give each row's
    live tiles (entries tile | directions << DIR_SHIFT); tgt and surv int32
    [R] give each row's target and survivor flag. Returns int32 [R, 2|S|]
    per-variant match counts (direct variants then mirrored; mirrored
    columns are 0 when mirror is off)."""
    return _counts_plain(
        ((rf, fw), (rf_m, fw_m)), sel_off, coords, row_off, tile_list, tgt,
        surv, xy_shift, mirror, POS_SHIFT["ratio"],
        lambda e: (sel_q[e], sel_f32[e]),
        lambda t, q: _ratio_match(t[0], t[1].to(torch.int32),
                                  q[0] & ((1 << POS_SHIFT["ratio"]) - 1),
                                  q[1]))


def multimask_words_counts_plain(frames, flipped, sel_off, sel_q, coords,
                                 row_off, tile_list, tgt, surv,
                                 xy_shift: int, mirror: bool, triples):
    """Plain PyTorch version of the packed-word kernel: frames and flipped
    int32 [T, Hp, Wp], the padded word frames (pixel_active.pad_from_words)
    in place of the ratio planes; sel_q [P] the selected pixels' raw
    words (with their places); the predicate's six constants `triples`
    (pixel_active.word_triples). The other arguments and the output as
    multimask_counts_plain."""
    mask = (1 << POS_SHIFT["words"]) - 1
    return _counts_plain(
        ((frames,), (flipped,)), sel_off, coords, row_off, tile_list, tgt,
        surv, xy_shift, mirror, POS_SHIFT["words"], lambda e: (sel_q[e],),
        lambda t, q: _match_unpacked(_unpack(q[0] & mask), _unpack(t[0]),
                                     triples))


def window_bins(row_off, tile_list, tgt, surv, coords, frame_shape,
                n_targets: int):
    """The kernels' work list (torch ops on the table's device, with no
    wait on the device): the (row, tile) members sorted into bins by the
    target window they read, bin = target * gh * gw + ty * gw + tx for the
    tile origin (8 ty, 128 tx) on the gh x gw tile grid of padded frames
    of frame_shape. A member of a row whose survivor flag is 0 keeps no
    direction, so it scores nothing.

    Returns bin_off int32 [n_targets * gh * gw + 1] (bin b's members are
    bin_off[b] .. bin_off[b+1] - 1), mem_row int32 [L] and mem_tile int32
    [L] (the tile_list entry: tile | directions << DIR_SHIFT)."""
    hp, wp = frame_shape
    gh, gw = hp // TILE_H - 2, wp // TILE_W - 2
    n_bins = n_targets * gh * gw
    dev = tile_list.device
    rows = torch.repeat_interleave(
        torch.arange(tgt.numel(), dtype=torch.int32, device=dev),
        (row_off[1:] - row_off[:-1]).to(torch.int64),
        output_size=tile_list.numel())
    pos = coords[:, 0] // TILE_H * gw + coords[:, 1] // TILE_W
    key, order = torch.sort(tgt[rows] * (gh * gw) + pos[tile_list & TILE_MASK])
    rows = rows[order]
    entry = tile_list[order]
    entry = torch.where(surv[rows] != 0, entry, entry & TILE_MASK)
    bin_off = torch.zeros(n_bins + 1, dtype=torch.int32, device=dev)
    torch.cumsum(torch.bincount(key, minlength=n_bins), 0, out=bin_off[1:])
    return bin_off, rows, entry


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(args) -> bool:
    """False for all-CPU tensors, True for all-CUDA ones; raises on a mix."""
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"}:
        raise ValueError(f"tensors on {sorted(kinds)}: expected all on one "
                         "CUDA device or all on the CPU")
    return True


def _check_table(planes, sel, coords, row_off, tile_list, tgt, surv,
                 xy_shift):
    """Validate a launch's tensors for the kernels; returns (n_rows, nv).
    planes: [(name, tensor, dtype)] target planes of one shape [T, Hp, Wp];
    sel: [(name, tensor, dtype, shape after the entry count)], the compact
    lists after sel_off."""
    dev = coords.device
    shape = tuple(planes[0][1].shape)
    for name, t, dt in planes:
        _check(name, t, dt, 3, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        # the kernels copy 16-byte (4-byte for uint8) chunks of each row
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if shape[2] % 16:
        raise ValueError(f"padded frame width {shape[2]} is not a "
                         f"multiple of 16")
    for name, t, dt, nd in (("coords", coords, torch.int32, 2),
                            ("row_off", row_off, torch.int32, 1),
                            ("tile_list", tile_list, torch.int32, 1),
                            ("tgt", tgt, torch.int32, 1),
                            ("surv", surv, torch.int32, 1)):
        _check(name, t, dt, nd, dev)
    n_tiles = coords.shape[0]
    if tuple(coords.shape) != (n_tiles, 2):
        raise ValueError("coords must be [NT, 2]")
    (_, sel_off, _, _), *entries = sel
    _check("sel_off", sel_off, torch.int32, 1, dev)
    if sel_off.numel() != n_tiles + 1:
        raise ValueError(f"sel_off: expected NT + 1 = {n_tiles + 1} "
                         f"offsets, got {sel_off.numel()}")
    n_entries = entries[0][1].shape[0] if entries else 0
    for name, t, dt, tail in entries:
        _check(name, t, dt, 1 + len(tail), dev)
        if tuple(t.shape) != (n_entries,) + tail:
            raise ValueError(f"{name}: expected [P]+{list(tail)}, got "
                             f"{tuple(t.shape)}")
        if tail and t.data_ptr() % 16:  # read as one 16-byte vector
            raise ValueError(f"{name} must be 16-byte aligned")
    if xy_shift not in KERNEL_XY_SHIFTS:
        raise ValueError(f"xy_shift {xy_shift} not in {KERNEL_XY_SHIFTS}")
    n_rows = tgt.numel()
    if surv.numel() != n_rows or row_off.numel() != n_rows + 1:
        raise ValueError("tgt and surv need one entry per row and row_off "
                         "one more")
    return n_rows, 2 * len(shift_ring_offsets(xy_shift))


def multimask_counts(rf, fw, rf_m, fw_m, sel_off, sel_q, sel_f32, coords,
                     row_off, tile_list, tgt, surv, xy_shift: int,
                     mirror: bool):
    """Exact per-variant counts, ratio predicate (see
    multimask_counts_plain).

    CPU tensors run the plain version. CUDA tensors launch the Hopper
    kernel (built at first use) or raise; there is no fallback."""
    args = (rf, fw, rf_m, fw_m, sel_off, sel_q, sel_f32, coords, row_off,
            tile_list, tgt, surv)
    if not _on_cuda(args):
        return multimask_counts_plain(*args, xy_shift, mirror)
    lib = kernels.load_library("multimask_ratio").lib
    n_rows, nv = _check_table(
        [("rf", rf, torch.float32), ("fw", fw, torch.uint8),
         ("rf_m", rf_m, torch.float32), ("fw_m", fw_m, torch.uint8)],
        [("sel_off", sel_off, torch.int32, ()),
         ("sel_q", sel_q, torch.int32, ()),
         ("sel_f32", sel_f32, torch.float32, (4,))],
        coords, row_off, tile_list, tgt, surv, xy_shift)
    dev = rf.device
    out = torch.zeros((n_rows, nv), dtype=torch.int32, device=dev)
    n_t, hp, wp = rf.shape
    bin_off, mem_row, mem_tile = window_bins(
        row_off, tile_list, tgt, surv, coords, (hp, wp), n_t)
    if mem_row.numel() == 0:
        return out
    rc = lib.cms_multimask_ratio(
        rf.data_ptr(), fw.data_ptr(), rf_m.data_ptr(), fw_m.data_ptr(), hp,
        wp, sel_off.data_ptr(), sel_q.data_ptr(), sel_f32.data_ptr(),
        bin_off.data_ptr(), bin_off.numel() - 1, mem_row.data_ptr(),
        mem_tile.data_ptr(), xy_shift, int(bool(mirror)), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"multimask_ratio kernel launch failed: "
                           f"cudaError {rc}")
    multimask_counts.launches += 1
    return out


multimask_counts.launches = 0


def multimask_words_counts(frames, flipped, sel_off, sel_q, coords, row_off,
                           tile_list, tgt, surv, xy_shift: int, mirror: bool,
                           triples):
    """Exact per-variant counts, packed-word predicate (see
    multimask_words_counts_plain).

    CPU tensors run the plain version. CUDA tensors launch the Hopper
    kernel (built at first use) or raise; there is no fallback."""
    args = (frames, flipped, sel_off, sel_q, coords, row_off, tile_list, tgt,
            surv)
    if not _on_cuda(args):
        return multimask_words_counts_plain(*args, xy_shift, mirror, triples)
    lib = kernels.load_library("multimask_words").lib
    n_rows, nv = _check_table(
        [("frames", frames, torch.int32), ("flipped", flipped, torch.int32)],
        [("sel_off", sel_off, torch.int32, ()),
         ("sel_q", sel_q, torch.int32, ())],
        coords, row_off, tile_list, tgt, surv, xy_shift)
    flat = [int(v) for tr in triples for v in tr]
    if len(flat) != 18:
        raise ValueError("triples: expected six (Q, Rhi, Rlo) triples")
    dev = frames.device
    out = torch.zeros((n_rows, nv), dtype=torch.int32, device=dev)
    n_t, hp, wp = frames.shape
    bin_off, mem_row, mem_tile = window_bins(
        row_off, tile_list, tgt, surv, coords, (hp, wp), n_t)
    if mem_row.numel() == 0:
        return out
    rc = lib.cms_multimask_words(
        frames.data_ptr(), flipped.data_ptr(), hp, wp, sel_off.data_ptr(),
        sel_q.data_ptr(), bin_off.data_ptr(), bin_off.numel() - 1,
        mem_row.data_ptr(), mem_tile.data_ptr(), xy_shift, int(bool(mirror)),
        (ctypes.c_int * 18)(*flat), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"multimask_words kernel launch failed: "
                           f"cudaError {rc}")
    multimask_words_counts.launches += 1
    return out


multimask_words_counts.launches = 0

# predicate -> (kernel wrapper, plain version); both take
# MultiMaskScorer.kernel_args() followed by MultiMaskScorer.kernel_tail()
PREDICATE_KERNELS = {
    "ratio": (multimask_counts, multimask_counts_plain),
    "words": (multimask_words_counts, multimask_words_counts_plain),
}


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
    tile_list: np.ndarray   # int32 [L] tile | directions << DIR_SHIFT, by row
    tgt: np.ndarray         # int32 [R] target per row
    surv: np.ndarray        # int32 [R] survivor flag (all 1 from build_table)
    # engine position -> (row indices, their target indices)
    spans: dict = field(default_factory=dict)


def launch_params(engine) -> tuple:
    """The CDS params that engines of one launch must share (zTolerance,
    xyShift) and the exact predicate: engines of different predicates
    never share a launch (the reference asserts it, multimask.py:472)."""
    return engine.zt9, engine.xy_shift, engine.predicate


def shared_params(engines) -> bool:
    """Whether engines can share one launch."""
    return len({launch_params(e) for e in engines}) == 1


class MultiMaskScorer:
    """One-launch-many-masks exact sweep over a shared target block.

    engines: ActiveTilePixelEngine per mask; they must share zTolerance,
    xyShift and predicate. Their compact query lists (sel_off, sel_q and,
    for "ratio", sel_f32) and tile origins are stacked once on the host
    and uploaded once per device."""

    def __init__(self, engines: Sequence):
        self.engines = list(engines)
        if not self.engines:
            raise ValueError("no engines")
        if not shared_params(self.engines):
            raise ValueError("a multi-mask launch needs shared CDS params "
                             "(zTolerance, xyShift) and one predicate")
        e0 = self.engines[0]
        self.zt9, self.xy_shift, self.predicate = launch_params(e0)
        self.shifts = e0.shifts
        self.triples = e0.triples
        self.mirror = any(e.mirror_query for e in self.engines)
        sizes = {(e.tiles.height, e.tiles.width) for e in self.engines}
        if len(sizes) != 1:
            raise ValueError(f"masks of different sizes: {sorted(sizes)}")
        h, w = sizes.pop()
        self._width = w
        # the mask tile grid and the padded frame the tiles' windows index
        # (pad_from_words)
        self._grid = (-(-h // TILE_H), -(-w // TILE_W))
        self.frame_shape = ((self._grid[0] + 2) * TILE_H,
                            (self._grid[1] + 2) * TILE_W)
        tiles = [e.tiles for e in self.engines]
        # entries per stacked tile; a tile without any is never launched
        self._n_sel = np.concatenate(
            [np.diff(t.sel_off) for t in tiles]).astype(np.int64)
        names = ("sel_q", "sel_f32") if self.predicate == "ratio" \
            else ("sel_q",)
        coords = np.concatenate([t.coords for t in tiles])
        # the kernel's query arguments in order: sel_off, the lists, coords
        self._q_host = (
            np.concatenate([[0], np.cumsum(self._n_sel)]).astype(np.int32),
            *(np.concatenate([getattr(t, n) for t in tiles]) for n in names),
            coords)
        self._q_dev = {}  # torch.device -> the query tensors
        # the stacked tiles a launch row may list (those with an entry):
        # engine i's are _listed[_listed_off[i]:_listed_off[i + 1]], at
        # grid positions _listed_pos (ty * gw + tx)
        self._listed = np.flatnonzero(self._n_sel).astype(np.int32)
        self._listed_off = np.searchsorted(
            self._listed, np.cumsum([0] + [t.n_active for t in tiles]))
        cy, cx = coords[self._listed].T
        self._listed_pos = cy // TILE_H * self._grid[1] + cx // TILE_W

    def _q_for(self, device: torch.device):
        """The stacked query tensors on `device`, in the kernel's argument
        order: (sel_off, sel_q, sel_f32, coords) or (sel_off, sel_q,
        coords)."""
        got = self._q_dev.get(device)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device) for a in self._q_host)
            self._q_dev[device] = got
        return got

    def kernel_args(self, planes, table: LaunchTable) -> list:
        """The tensors of one launch in the order of the predicate's
        kernel: the target planes (pixel_active.pad_for_predicate), the
        query tensors and the table's (row_off, tile_list, tgt, surv)."""
        dev = planes[0].device
        return (list(planes) + list(self._q_for(dev))
                + [torch.from_numpy(a).to(dev) for a in
                   (table.row_off, table.tile_list, table.tgt, table.surv)])

    def kernel_tail(self) -> tuple:
        """The arguments of the predicate's kernel after the launch's
        tensors: xy_shift, mirror and, for "words", the six triples."""
        tail = (self.xy_shift, self.mirror)
        return tail + ((self.triples,) if self.predicate == "words" else ())

    def counts(self, args):
        """Per-variant counts of one launch (args = kernel_args(...))
        through the predicate's wrapper."""
        kernel, _ = PREDICATE_KERNELS[self.predicate]
        return kernel(*args, *self.kernel_tail())

    def build_table(self, survivors: np.ndarray,
                    signal_ranges: Optional[np.ndarray] = None,
                    tile_live: Optional[tuple] = None) -> LaunchTable:
        """Rows and live-tile lists for `survivors` int [B, T].

        signal_ranges: optional int32 [T, 2] or [T, 4] row (and column)
        signal extents; tile_live: optional (direct, mirrored) bitmaps.
        Either restricts each row's tiles, per direction, to those that
        can score; a tile stays in a row's list with the directions that
        can (exact: each test only drops windows without target signal).
        Tiles without a selected query pixel are never listed.

        Rows come in engine order, each engine's in target order, and a
        row's tiles in the engine's tile order."""
        survivors = np.asarray(survivors)
        eng, dest = np.nonzero(survivors)
        codes = self._direction_codes(survivors.shape[1], signal_ranges,
                                      tile_live)
        # the candidates: every row with every listed tile of its engine
        cnt = np.diff(self._listed_off)[eng]
        ends = np.cumsum(cnt)
        starts = ends - cnt
        n_cand = int(ends[-1]) if len(ends) else 0
        idx = np.arange(n_cand) + np.repeat(self._listed_off[eng] - starts,
                                            cnt)
        code = codes[np.repeat(dest * (self._grid[0] * self._grid[1]), cnt)
                     + self._listed_pos[idx]]
        keep = np.flatnonzero(code)
        bounds = np.searchsorted(eng, np.arange(len(self.engines) + 1))
        spans = {pos: (np.arange(a, b), dest[a:b]) for pos, (a, b)
                 in enumerate(zip(bounds[:-1], bounds[1:])) if b > a}
        return LaunchTable(
            row_off=np.searchsorted(keep, np.append(starts, n_cand)
                                    ).astype(np.int32),
            tile_list=self._listed[idx[keep]]
            | (code[keep].astype(np.int32) << DIR_SHIFT),
            tgt=dest.astype(np.int32), surv=np.ones(len(eng), np.int32),
            spans=spans)

    def _direction_codes(self, n_targets: int,
                         signal_ranges: Optional[np.ndarray],
                         tile_live: Optional[tuple]) -> np.ndarray:
        """uint8 [n_targets * gh * gw]: for each target and tile position
        (ty * gw + tx) on the mask tile grid, the directions (bit 0 direct,
        bit 1 mirrored) in which a tile there can score against that
        target (build_table's tests)."""
        gh, gw = self._grid
        s = max((abs(dy) for _, dy in self.shifts), default=0)
        sx = max((abs(dx) for dx, _ in self.shifts), default=0)
        live_d = np.ones((n_targets, gh, gw), bool)
        # the launch's mirror setting, not the engine's: a direction
        # leaves a row's list only by an exact test, so the kernel's
        # counts equal its plain version's for every engine
        live_m = live_d if self.mirror else np.zeros_like(live_d)
        if tile_live is not None:
            live_d = live_d & tile_live[0]
            live_m = live_m & tile_live[1]
        if signal_ranges is not None:
            # a tile's shifts sample raw rows [cy - s, cy + 8 + s) and
            # cols [cx - sx, cx + 128 + sx); the mirror pass samples the
            # x-flipped raw plane, whose signal cols are the reflection of
            # the target's about (w - 1) / 2
            rr = np.asarray(signal_ranges).astype(np.int64)
            cy = np.arange(gh) * TILE_H
            rok = ((cy >= rr[:, :1] - TILE_H - s + 1)
                   & (cy <= rr[:, 1:2] + s))[:, :, None]
            live_d = live_d & rok
            live_m = live_m & rok
            if rr.shape[1] >= 4:
                cx = np.arange(gw) * TILE_W
                c0, c1 = rr[:, 2:3], rr[:, 3:4]
                w = self._width
                live_d = live_d & ((cx >= c0 - TILE_W - sx + 1)
                                   & (cx <= c1 + sx))[:, None, :]
                live_m = live_m & ((cx >= w - 1 - c1 - TILE_W - sx + 1)
                                   & (cx <= w - 1 - c0 + sx))[:, None, :]
        return (live_d.view(np.uint8) | (live_m.view(np.uint8) << 1)).ravel()

    def launch_deferred(self, packed, survivors: np.ndarray,
                        signal_ranges: Optional[np.ndarray] = None,
                        tile_live: Optional[tuple] = None
                        ) -> List[DeferredScore]:
        """Queue the exact sweep of ALL masks over one packed target block
        (on its device): packed is the predicate's padded target planes
        (pixel_active.pad_for_predicate). Returns one
        DeferredScore per engine (drain with pixel_active.drain_deferred:
        the shared output is copied once)."""
        packed = tuple(packed)
        if tuple(packed[0].shape[1:]) != self.frame_shape:
            raise ValueError(f"padded frames {tuple(packed[0].shape[1:])} "
                             f"do not fit masks padded to {self.frame_shape}")
        tsz = packed[0].shape[0]
        surv_np = np.asarray(survivors).astype(np.int32)
        tab = self.build_table(surv_np, signal_ranges, tile_live)
        out = self.counts(self.kernel_args(packed, tab))
        pendings = [[] for _ in self.engines]
        for pos, (rows, dest) in tab.spans.items():
            pendings[pos].append((dest, out, rows))
        return [DeferredScore(e, tsz, pendings[i], surv_np[i])
                for i, e in enumerate(self.engines)]
