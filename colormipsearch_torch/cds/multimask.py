"""Exact multi-mask scorer: one kernel launch scores many masks.

Counterpart of `colormipsearch_tpu/cds/multimask.py` (:447-782 scorer,
:900-967 signal ranges and live tiles). The two-phase sweep's exact
phase scores each mask's prescreen survivors; one launch covers every
mask of a target partition.

- The launch table: each mask's survivors become launch rows (mask,
  target, survivor flag). Each row carries its exact list of
  live tiles, each with the directions (direct, mirrored) in which it
  can score: the mask's active tiles that hold a selected query pixel
  and whose sampled window can hold target signal (the 3x3-dilated
  tile-presence bitmaps of tile_live_dev, intersected with the
  target's signal row and column extents, signal_extents). Skipped tiles
  and directions provably score 0, so any exact skip gives the same
  scores. The table is built on the launch's device from the bitmaps
  and extents as they lie there (`launch_table`: `csrc/launch_table.cu`
  on a card, its plain version `launch_table_plain` on the CPU). The
  query side is each mask's compact lists of selected pixels
  (pixel_active.compact_selected), stacked.
- Device side, one kernel per predicate, each with a plain PyTorch
  version that CPU tensors run: `multimask_counts` launches the ratio
  kernel (`csrc/multimask_ratio.cu`, K1), `multimask_words_counts` the
  packed-word kernel (`csrc/multimask_words.cu`, K3a). Each wrapper first
  sorts the table's (row, tile) members into window bins on the device
  (`window_bins`: one bin per target and tile position, so a window is
  staged once for every mask that reads it) and launches one block per
  bin. Each wrapper's `.launches` counts its kernel launches.
- The collect: `row_reduce` (`csrc/row_reduce.cu`, R1; plain version
  `row_reduce_plain` on the CPU), queued behind the exact kernel, reduces
  each row's counts to its mask's score and mirrored flag in a dense
  [masks, targets] block, which a ScoreBlock copies to the host once,
  queued at launch (pinned memory and an event on a card).

Left out: the tier-2 bin-compat gate (CMS_MM_TIER2=1, off by default in
the reference), which cut more of each row's list but lowered the
pipelined rate on the H100 (a net loss, as on the TPU); and the adaptive
live-table gate, ROWS, G_BUCKET and pow2 k-grid buckets, which exist for
Mosaic's SMEM limits and compile costs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import trace
from . import kernels
from .oracle import shift_ring_offsets
from .pixel_active import (POS_SHIFT, TILE_H, TILE_W, _match_unpacked,
                           _unpack)

KERNEL_XY_SHIFTS = (0, 2)  # xy_shift values the kernels are built for


# ---- the exact kernels: plain versions and wrappers ------------------------

# a tile_list entry: the stacked tile index, and the directions in which
# the (row, tile) can score (the launch table's live-tile cut; bit
# DIR_SHIFT direct, bit DIR_SHIFT + 1 mirrored)
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
    both directions, so they also check that the table's cut is exact)."""
    counts = (row_off[1:] - row_off[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(counts.numel(), device=tile_list.device), counts)
    # a launch table has room past row_off[-1]: no row's
    tiles = tile_list[:rows.numel()].to(torch.int64) & TILE_MASK
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
    direction, so it scores nothing. Entries of tile_list past
    row_off[-1] (a launch table has room for every candidate) belong to
    no row: they sort past every bin.

    Returns bin_off int32 [n_targets * gh * gw + 1] (bin b's members are
    bin_off[b] .. bin_off[b+1] - 1), mem_row int32 [L] and mem_tile int32
    [L] (the tile_list entry: tile | directions << DIR_SHIFT)."""
    hp, wp = frame_shape
    gh, gw = hp // TILE_H - 2, wp // TILE_W - 2
    n_bins = n_targets * gh * gw
    n_rows = tgt.numel()
    dev = tile_list.device
    # the entries past row_off[-1] go to row n_rows, of target n_targets
    counts = torch.cat([row_off[1:] - row_off[:-1],
                        tile_list.numel() - row_off[-1:]])
    rows = torch.repeat_interleave(
        torch.arange(n_rows + 1, dtype=torch.int32, device=dev),
        counts.to(torch.int64), output_size=tile_list.numel())
    tgt = torch.cat([tgt, tgt.new_full((1,), n_targets)])
    surv = torch.cat([surv, surv.new_zeros(1)])
    pos = coords[:, 0] // TILE_H * gw + coords[:, 1] // TILE_W
    key, order = torch.sort(tgt[rows] * (gh * gw) + pos[tile_list & TILE_MASK])
    rows = rows[order]
    entry = tile_list[order]
    entry = torch.where(surv[rows] != 0, entry, entry & TILE_MASK)
    # bin b starts at the first key not below b (bincount would wait for
    # the device to size its output)
    bin_off = torch.searchsorted(
        key, torch.arange(n_bins + 1, dtype=key.dtype, device=dev),
        out_int32=True)
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


# ---- live tiles and signal extents ----------------------------------------

def _sel_any_rowcol(words: torch.Tensor):
    sel = ((words >> 19) & 1) > 0
    return sel.any(dim=2), sel.any(dim=1)  # [T, H], [T, W]


def _first_last(flags: torch.Tensor) -> torch.Tensor:
    """int32 [T, 2] (first, last) index of a true flag per row of bool [T,
    n]; (0, -1) for a row without one."""
    n = flags.shape[1]
    idx = torch.arange(n, device=flags.device)
    last = torch.where(flags, idx, -1).amax(dim=1)
    first = torch.where(last >= 0, torch.where(flags, idx, n).amin(dim=1), 0)
    return torch.stack([first, last], dim=1).to(torch.int32)


def signal_extents(words: torch.Tensor) -> torch.Tensor:
    """int32 [T, 4] (first_row, last_row, first_col, last_col) signal
    extents per packed target frame (raw-frame coordinates), (0, -1) for
    empty targets, on the words' device (nothing waits)."""
    r, c = _sel_any_rowcol(words)
    return torch.cat([_first_last(r), _first_last(c)], dim=1)


def row_ranges_from_words(words: torch.Tensor) -> np.ndarray:
    """int32 [T, 2] (first, last) above-threshold signal row per packed
    target frame; (0, -1) for empty targets."""
    return _first_last(_sel_any_rowcol(words)[0]).cpu().numpy()


def tile_live_dev(words: torch.Tensor) -> tuple:
    """Per-target 3x3-dilated tile-presence bitmaps, (direct, mirrored),
    each bool [T, gh, gw] over the mask tile grid, on the words' device:
    does target j (resp. its x-flip) have above-threshold signal in the
    3x3 tile neighbourhood that every shift of the tile at (ty, tx)
    samples?"""
    tsz, h, w = words.shape
    gh, gw = -(-h // TILE_H), -(-w // TILE_W)
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


# ---- the launch table on the device ----------------------------------------

def direction_codes_plain(n_targets: int, grid, width: int, reach,
                          mirror: bool, extents=None, tile_live=None,
                          device="cpu") -> torch.Tensor:
    """uint8 [n_targets * gh * gw] direction codes (bit 0 direct, bit 1
    mirrored) of each target and tile position (ty * gw + tx) on the mask
    tile grid `grid` (gh, gw): the directions in which a tile there can
    score against that target. width: the masks' raw width; reach:
    (sy, sx), the largest |dy| and |dx| of the shifts; mirror: the
    launch's setting, not an engine's (a direction leaves a row's list
    only by an exact test, so the kernel's counts equal its plain
    version's for every engine); extents: int32 [T, 2] or [T, 4]
    (signal_extents) or None; tile_live: (direct, mirrored) bool
    [T, gh, gw] (tile_live_dev) or None."""
    gh, gw = grid
    sy, sx = reach
    d = torch.ones((n_targets, gh, gw), dtype=torch.bool, device=device)
    m = d if mirror else torch.zeros_like(d)
    if tile_live is not None:
        d = d & tile_live[0]
        m = m & tile_live[1]
    if extents is not None:
        # a tile's shifts sample raw rows [cy - sy, cy + 8 + sy) and cols
        # [cx - sx, cx + 128 + sx); the mirror pass samples the x-flipped
        # raw plane, whose signal cols are the reflection of the
        # target's about (width - 1) / 2
        ext = extents.to(torch.int64)
        cy = torch.arange(gh, device=device) * TILE_H
        rok = ((cy >= ext[:, :1] - TILE_H - sy + 1)
               & (cy <= ext[:, 1:2] + sy))[:, :, None]
        d = d & rok
        m = m & rok
        if ext.shape[1] >= 4:
            cx = torch.arange(gw, device=device) * TILE_W
            c0, c1 = ext[:, 2:3], ext[:, 3:4]
            d = d & ((cx >= c0 - TILE_W - sx + 1)
                     & (cx <= c1 + sx))[:, None, :]
            m = m & ((cx >= width - 1 - c1 - TILE_W - sx + 1)
                     & (cx <= width - 1 - c0 + sx))[:, None, :]
    return (d.to(torch.uint8) | (m.to(torch.uint8) << 1)).reshape(-1)


def launch_table_plain(rows, listed, listed_off, listed_pos, n_cand: int,
                       n_targets: int, grid, width: int, reach,
                       mirror: bool, extents=None, tile_live=None):
    """Plain PyTorch version of the launch-table kernel (same arguments),
    on tensors on one device: each row's live tiles, each listed tile of
    the row's engine with the directions direction_codes_plain leaves it
    at the row's target (a tile that keeps none is left out).

    rows: int32 [2, R], each row's engine, then its target (engine order,
    then target order); listed int32 [NL], listed_off int32 [B + 1] and
    listed_pos int32 [NL]: engine i's listed tiles are
    listed[listed_off[i]:listed_off[i + 1]], at grid positions listed_pos;
    n_cand: the candidates, every row's listed tiles; the rest as
    direction_codes_plain. Returns row_off int32 [R + 1] and tile_list
    int32 [n_cand]: row r's tiles are tile_list[row_off[r]:row_off[r + 1]]
    (tile | code << DIR_SHIFT, in the engine's tile order); the entries
    past row_off[R] are 0."""
    dev = rows.device
    n_rows = rows.shape[1]
    row_off = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    tile_list = torch.zeros(n_cand, dtype=torch.int32, device=dev)
    if n_rows == 0:
        return row_off, tile_list
    gh, gw = grid
    codes = direction_codes_plain(n_targets, grid, width, reach, mirror,
                                  extents, tile_live, dev)
    eng, dest = rows.to(torch.int64)
    off = listed_off.to(torch.int64)
    cnt = off[eng + 1] - off[eng]
    # the candidates: every row with every listed tile of its engine
    row = torch.repeat_interleave(torch.arange(n_rows, device=dev), cnt,
                                  output_size=n_cand)
    start = torch.cumsum(cnt, 0) - cnt
    j = off[eng][row] + torch.arange(n_cand, device=dev) - start[row]
    code = codes[dest[row] * (gh * gw) + listed_pos[j].to(torch.int64)]
    keep = code != 0
    counts = torch.zeros(n_rows, dtype=torch.int32, device=dev).index_add_(
        0, row, keep.to(torch.int32))
    torch.cumsum(counts, 0, dtype=torch.int32, out=row_off[1:])
    kept = listed[j[keep]] | (code[keep].to(torch.int32) << DIR_SHIFT)
    tile_list[:kept.numel()] = kept
    return row_off, tile_list


def launch_table(rows, listed, listed_off, listed_pos, n_cand: int,
                 n_targets: int, grid, width: int, reach, mirror: bool,
                 extents=None, tile_live=None):
    """The launch table (see launch_table_plain). CPU tensors run the
    plain version. CUDA tensors launch the card's kernel
    (`csrc/launch_table.cu`, built at first use) or raise; nothing waits
    for the card."""
    live = () if tile_live is None else tuple(tile_live)
    ext = () if extents is None else (extents,)
    args = (rows, listed, listed_off, listed_pos, *ext, *live)
    if not _on_cuda(args):
        return launch_table_plain(rows, listed, listed_off, listed_pos,
                                  n_cand, n_targets, grid, width, reach,
                                  mirror, extents, tile_live)
    lib = kernels.load_library("launch_table").lib
    dev = rows.device
    gh, gw = grid
    _check("rows", rows, torch.int32, 2, dev)
    for name, t in (("listed", listed), ("listed_off", listed_off),
                    ("listed_pos", listed_pos)):
        _check(name, t, torch.int32, 1, dev)
    if extents is not None:
        _check("extents", extents, torch.int32, 2, dev)
        if tuple(extents.shape) not in ((n_targets, 2), (n_targets, 4)):
            raise ValueError(f"extents: expected [{n_targets}, 2 or 4], got "
                             f"{tuple(extents.shape)}")
    for name, t in zip(("live_d", "live_m"), live):
        _check(name, t, torch.bool, 3, dev)
        if tuple(t.shape) != (n_targets, gh, gw):
            raise ValueError(f"{name}: expected [{n_targets}, {gh}, {gw}], "
                             f"got {tuple(t.shape)}")
    n_rows = rows.shape[1]
    if rows.shape[0] != 2:
        raise ValueError("rows must be [2, R]: engines, then targets")
    row_off = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    tile_list = torch.zeros(n_cand, dtype=torch.int32, device=dev)
    if n_rows == 0:
        return row_off, tile_list
    codes = torch.empty(n_targets * gh * gw, dtype=torch.uint8, device=dev)
    counts = torch.empty(n_rows, dtype=torch.int32, device=dev)
    ext_ptr, n_ext = ((None, 0) if extents is None
                      else (extents.data_ptr(), extents.shape[1]))
    live_d, live_m = [t.data_ptr() for t in live] or [None, None]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cms_launch_table_count(
        ext_ptr, n_ext, live_d, live_m, n_targets, gh, gw, width, reach[0],
        reach[1], int(bool(mirror)), rows.data_ptr(), n_rows,
        listed_off.data_ptr(), listed_pos.data_ptr(), codes.data_ptr(),
        counts.data_ptr(), stream, dev.index)
    if rc == 0:
        torch.cumsum(counts, 0, dtype=torch.int32, out=row_off[1:])
        rc = lib.cms_launch_table_write(
            codes.data_ptr(), gh * gw, rows.data_ptr(), n_rows,
            listed.data_ptr(), listed_off.data_ptr(), listed_pos.data_ptr(),
            row_off.data_ptr(), tile_list.data_ptr(), stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"launch_table kernel launch failed: "
                           f"cudaError {rc}")
    launch_table.launches += 1
    return row_off, tile_list


launch_table.launches = 0


# ---- the collect: counts to scores on the device ---------------------------

# each engine's row_reduce flags: it mirrors the query; it has no query
# pixel (it scores 0)
ROW_MIRROR, ROW_EMPTY = 1, 2
MIRRORED_BIT = -(1 << 31)  # bit 31 of an int32 block value: mirrored


def row_reduce_plain(counts, eng, tgt, flags, n_targets: int):
    """Plain PyTorch version of the collect's reduction (same arguments).

    counts: int32 [R, 2S] per-variant counts (multimask_counts': direct
    variants, then mirrored); eng and tgt: int32 [R] each row's engine and
    target; flags: uint8 [B] each engine's ROW_MIRROR and ROW_EMPTY bits.
    Returns int32 [B, n_targets], 0 but at each row's (engine, target):
    best | mirrored << 31, where best is the direct variants' maximum, or
    where the engine mirrors the maximum of all, and mirrored says the
    mirrored maximum passes the direct one (strict: ties stay direct);
    an empty engine's best is 0."""
    out = torch.zeros(flags.numel() * n_targets, dtype=torch.int32,
                      device=counts.device)
    if counts.shape[0]:
        s = counts.shape[1] // 2
        direct = counts[:, :s].amax(dim=1)
        mirror = counts[:, s:].amax(dim=1)
        e = eng.to(torch.int64)
        f = flags.to(torch.int32)[e]
        mirrored = ((f & ROW_MIRROR) != 0) & (mirror > direct)
        best = torch.where(mirrored, mirror, direct)
        best = torch.where((f & ROW_EMPTY) != 0, torch.zeros_like(best),
                           best)
        out[e * n_targets + tgt.to(torch.int64)] = torch.where(
            mirrored, best | MIRRORED_BIT, best)
    return out.reshape(flags.numel(), n_targets)


def row_reduce(counts, eng, tgt, flags, n_targets: int):
    """The collect's reduction (see row_reduce_plain). CPU tensors run the
    plain version. CUDA tensors launch the card's kernel
    (`csrc/row_reduce.cu`, built at first use) or raise; nothing waits for
    the card."""
    args = (counts, eng, tgt, flags)
    if not _on_cuda(args):
        return row_reduce_plain(*args, n_targets)
    lib = kernels.load_library("row_reduce").lib
    dev = counts.device
    _check("counts", counts, torch.int32, 2, dev)
    for name, t in (("eng", eng), ("tgt", tgt)):
        _check(name, t, torch.int32, 1, dev)
    _check("flags", flags, torch.uint8, 1, dev)
    n_rows, nv = counts.shape
    if eng.numel() != n_rows or tgt.numel() != n_rows:
        raise ValueError("eng and tgt need one entry per row of counts")
    out = torch.zeros((flags.numel(), n_targets), dtype=torch.int32,
                      device=dev)
    if n_rows == 0:
        return out
    rc = lib.cms_row_reduce(
        counts.data_ptr(), n_rows, nv, eng.data_ptr(), tgt.data_ptr(),
        flags.data_ptr(), n_targets, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"row_reduce kernel launch failed: "
                           f"cudaError {rc}")
    row_reduce.launches += 1
    return out


row_reduce.launches = 0


class ScoreBlock:
    """One launch's scores on their way to the host: row_reduce's int32
    [B, T] block, copied once. On a card the copy goes into pinned memory,
    non_blocking, queued behind the reduction with an event recorded
    behind it, so nothing waits until the block is read; on the CPU the
    block is already on the host."""

    def __init__(self, block: torch.Tensor):
        self._event = None
        if block.device.type == "cuda":
            host = torch.empty(block.shape, dtype=block.dtype,
                               pin_memory=True)
            host.copy_(block, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(block.device))
            block = host
        self._block = block
        self._result = None

    def result(self):
        """(scores int64 [B, T], mirrored bool [B, T]), once the copy has
        landed (the wait is a `sweep.wait` span)."""
        if self._result is None:
            with trace.span("sweep.wait"):
                if self._event is not None:
                    self._event.synchronize()
            v = self._block.numpy()
            self._result = ((v & ~MIRRORED_BIT).astype(np.int64), v < 0)
            self._block = self._event = None
        return self._result


# ---- the scorer ----------------------------------------------------------

@dataclass
class LaunchTable:
    """Launch table of one exact launch (MultiMaskScorer.table): tensors
    on the launch's device. tile_list has room for every candidate: its
    entries past row_off[R] are 0."""
    row_off: torch.Tensor    # int32 [R + 1] offsets into tile_list
    tile_list: torch.Tensor  # int32 [L] tile | directions << DIR_SHIFT, by row
    tgt: torch.Tensor        # int32 [R] target per row
    surv: torch.Tensor       # int32 [R] survivor flag (all 1 when built)
    eng: Optional[torch.Tensor] = None  # int32 [R] engine position per row


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
        # the launch-table kernel's arguments: (listed, listed_off,
        # listed_pos) as int32
        self._l_host = tuple(a.astype(np.int32) for a in (
            self._listed, self._listed_off, self._listed_pos))
        self._l_dev = {}  # torch.device -> the listed tiles' tensors
        # row_reduce's engine flags, uint8 [B]
        self._f_host = (np.array(
            [(ROW_MIRROR if e.mirror_query else 0)
             | (ROW_EMPTY if e.tiles.query_size == 0 else 0)
             for e in self.engines], np.uint8),)
        self._f_dev = {}  # torch.device -> the flags' tensor
        # the shifts' reach (largest |dy|, |dx|)
        self._reach = (max((abs(dy) for _, dy in self.shifts), default=0),
                       max((abs(dx) for dx, _ in self.shifts), default=0))

    @staticmethod
    def _upload(cache: dict, host: tuple, device: torch.device) -> tuple:
        got = cache.get(device)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device) for a in host)
            cache[device] = got
        return got

    def _q_for(self, device: torch.device):
        """The stacked query tensors on `device` (uploaded at first use),
        in the kernel's argument order: (sel_off, sel_q, sel_f32, coords)
        or (sel_off, sel_q, coords)."""
        return self._upload(self._q_dev, self._q_host, device)

    def kernel_args(self, planes, table: LaunchTable) -> list:
        """The tensors of one launch in the order of the predicate's
        kernel: the target planes (pixel_active.pad_for_predicate), the
        query tensors and the table's (row_off, tile_list, tgt, surv)."""
        dev = planes[0].device
        return (list(planes) + list(self._q_for(dev))
                + [table.row_off, table.tile_list, table.tgt, table.surv])

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

    def table(self, survivors: np.ndarray, device, extents=None,
              tile_live=None) -> LaunchTable:
        """The launch table of `survivors` int [B, T], built on `device` by
        launch_table (the card's kernel; on the CPU its plain version).

        Rows come in engine order, each engine's in target order, one per
        survivor; a row lists its engine's tiles that hold a selected
        query pixel, in tile order, each with the directions in which it
        can score. extents (int32 [T, 2] or [T, 4], signal_extents) and
        tile_live ((direct, mirrored) bool [T, gh, gw], tile_live_dev)
        each restrict those directions (exact: each test only drops
        windows without target signal); they are read where they lie,
        NumPy inputs are uploaded. The rows go up in one copy (pinned on a
        card); tile_list has room for every candidate, which the host
        counts from the survivors, so nothing waits for the device."""
        device = torch.device(device)
        survivors = np.asarray(survivors)
        eng, dest = np.nonzero(survivors)
        n_cand = int(np.diff(self._listed_off) @ np.count_nonzero(
            survivors, axis=1))
        cuda = device.type == "cuda"
        host = torch.empty((2, len(eng)), dtype=torch.int32, pin_memory=cuda)
        staged = host.numpy()
        staged[0], staged[1] = eng, dest
        rows = host.to(device, non_blocking=cuda)
        if extents is not None:
            extents = torch.as_tensor(extents, device=device)
        if tile_live is not None:
            tile_live = tuple(torch.as_tensor(t, device=device)
                              for t in tile_live)
        row_off, tile_list = launch_table(
            rows, *self._upload(self._l_dev, self._l_host, device), n_cand,
            survivors.shape[1], self._grid, self._width, self._reach,
            self.mirror, extents, tile_live)
        return LaunchTable(row_off=row_off, tile_list=tile_list, tgt=rows[1],
                           surv=torch.ones(len(eng), dtype=torch.int32,
                                           device=device), eng=rows[0])

    def launch_block(self, packed, survivors: np.ndarray,
                     signal_ranges=None, tile_live=None) -> ScoreBlock:
        """Queue the exact sweep of ALL masks over one packed target block
        (on its device), its reduction to scores and mirrored flags
        (row_reduce) and their copy to the host: packed is the predicate's
        padded target planes (pixel_active.pad_for_predicate);
        signal_ranges and tile_live as table's extents and tile_live.
        Returns the launch's ScoreBlock, its rows in engine order."""
        packed = tuple(packed)
        if tuple(packed[0].shape[1:]) != self.frame_shape:
            raise ValueError(f"padded frames {tuple(packed[0].shape[1:])} "
                             f"do not fit masks padded to {self.frame_shape}")
        dev = packed[0].device
        surv_np = np.asarray(survivors).astype(np.int32)
        with trace.span("sweep.table"):
            tab = self.table(surv_np, dev, signal_ranges, tile_live)
        counts = self.counts(self.kernel_args(packed, tab))
        return ScoreBlock(row_reduce(
            counts, tab.eng, tab.tgt,
            *self._upload(self._f_dev, self._f_host, dev),
            packed[0].shape[0]))
