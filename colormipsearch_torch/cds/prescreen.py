"""Prescreen: a provable upper bound on pixel-match scores, in PyTorch.

Counterpart of `colormipsearch_tpu/cds/prescreen.py` (:67-154 host
tables, :157-196 target features, :202-310 the count-capped bound,
:354-377 the feature bound, :380-482 PairPrescreen).
Phase 1 of the two-phase search bounds every (mask, target) pair's
best-variant score; only pairs whose bound clears the keep threshold
reach the exact scorer, so results are the same with the screen on or
off.

The bound: quantize each pixel's hue state into N_SECT x NB bins
(sector, ratio decile). For one shift offset o,

  score_o <= sum_C min( sum_j u[C, j] * w01[C+o, j],  tcnt[C+o] )

where u[C, j] counts query pixels of bin j in SUBTILE_H x SUBTILE_W cell
C, w01[C+o, j] = 1 iff the shifted cell holds a target pixel whose bin is
gap-compatible with j (compat_matrix, a superset of the exact predicate
by interval arithmetic over bin edges), and tcnt[C+o] counts its
bin-valid target pixels (the sampling map p -> p+o is injective). The
bound is the max over offsets, direct and x-flipped.

`PairPrescreen.bounds_from_words` computes it in two stages, each a
hand-written Hopper kernel (`csrc/prescreen_bound.cu`) with a plain
PyTorch version that CPU tensors run:
- `prescreen_cells` (plain: `cell_masks_plain`): per variant (direct and
  flipped frame x offset), cell and target, w01 as the bits of an int64
  and tcnt as a uint8;
- `prescreen_capped` (plain: `capped_bounds_plain`): the capped sums
  over the query's non-zero cells only, read from a per-mask CSR of its
  (bin, count) entries (`sparse_query_rows`, `QueryRows`), max over the
  variants. The at-size masks fill ~3 % of the cells and ~0.2 % of the
  (cell, bin) entries, so this skips nearly all of the dense product.
  The kernel reads the CSR regrouped by mask group and band of cells
  (`query_bands`, `QueryRows.bands`), so that a block holds one band of
  the table in shared memory while its masks' cells stream past.
Each wrapper's `.launches` counts its kernel launches.
`_variant_block_bounds_capped` is the same bound as dense fp32 products
(the JAX package's formulation, op for op); no command calls it:
`chip_smoke.py` times it beside the kernels and screens with it.

The target-feature path bounds with one product per orientation:
`target_features` marks, per cell and query bin j, whether the cell
dilated by xyShift holds a target pixel compatible with j, and
`PairPrescreen.bounds` takes u against those 0/1 features
(`_bounds_matmul`). It is looser than the capped bound (exact <= capped
<= feature) and no command calls it: it is kept for a benchmark's
prescreen cell, which times it as the reference's bench.py does.

Left out: the uncapped `_variant_block_bounds` (CMS_PRESCREEN_CAP=0), a
user switch between two bounds that no workload has shown to win.

Every value is an integer below 2^24 (cell counts <= 128, 0/1 weights,
sums <= the query size). The two stages compute in integers; the fp32
products of the dense and feature bounds are exact on any device as
long as no reduced-precision mode is on: the bound never rounds below
the count (a bf16 product would round its output above 256). Those
entry points turn TF32 off for their own products and restore the
caller's setting afterwards.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import trace
from . import kernels
from .multimask import _check, _on_cuda
from .oracle import shift_ring_offsets
from .pixel_kernel import PAIR_K9

NB = 10  # ratio bins per sector (bin width 1/NB >= zTolerance)
N_SECT = 6
N_BINS = N_SECT * NB
TILE_H = 8
TILE_W = 128
# spatial feature cells: SUBTILE_H x SUBTILE_W, dividing the 8x128 tiles
SUBTILE_W = 16
SUBTILE_H = 8
N_PLANES = -(-N_BINS // 30)  # 30 presence bits per int32 plane


def _cell_grid(grid_hw):
    """(rows, cols) of the cell grid for a (gh, gw) 8x128-tile grid."""
    gh, gw = grid_hw
    return gh * (TILE_H // SUBTILE_H), gw * (TILE_W // SUBTILE_W)


@functools.lru_cache(maxsize=8)
def compat_matrix(zt9: int) -> np.ndarray:
    """bool [N_BINS, N_BINS]: could ANY query pixel in bin jq match ANY
    target pixel in bin jt under the exact gap predicate? Computed with
    interval arithmetic over bin edges, erring on the inclusive side.

    Exact predicate recap (AbstractColorDepthSearchAlgorithm.java:260-388):
    - same sector: |r1 - r2| <= zTol, both ratios > 0
    - adjacent (lo, lo+1): side preconditions and
        lo odd:  r_lo-side < c_lo, r_hi-side < c_hi, r1 + r2 <= 2K + zTol
        lo even: both > 0.8,                      r1 + r2 >= 2K - zTol
      with (c_lo, c_hi) = (0.44, 0.54) for pair (1,2) and 0.7/0.7 for
      pairs (3,4), (5,6).
    """
    zt = zt9 / 1e9
    if zt > 1.0 / NB:
        raise ValueError("zTolerance exceeds the prescreen bin width")
    delta = 1.0 / NB
    compat = np.zeros((N_BINS, N_BINS), dtype=bool)

    def bin_range(j):
        rb = j % NB
        return rb * delta, (rb + 1) * delta  # [lo, hi)

    pair_k = {lo: PAIR_K9[lo - 1] / 1e9 for lo in range(1, 6)}
    for jq in range(N_BINS):
        sq = jq // NB + 1
        q_lo, q_hi = bin_range(jq)
        for jt in range(N_BINS):
            st = jt // NB + 1
            t_lo, t_hi = bin_range(jt)
            if sq == st:
                # |r1 - r2| <= zt possible iff intervals within zt
                # (inclusive comparisons: over-inclusion is free)
                if q_lo - zt <= t_hi and t_lo - zt <= q_hi:
                    compat[jq, jt] = True
                continue
            if abs(sq - st) != 1:
                continue
            lo = min(sq, st)
            k2 = 2 * pair_k[lo]
            if lo in (2, 4):
                # both ratios > 0.8 and r1 + r2 >= 2K - zt
                if q_hi >= 0.8 and t_hi >= 0.8 and q_hi + t_hi >= k2 - zt:
                    compat[jq, jt] = True
            else:
                if lo == 1:
                    c_q = 0.44 if sq == 1 else 0.54
                    c_t = 0.44 if st == 1 else 0.54
                else:
                    c_q = c_t = 0.7
                # both below their cutoffs and r1 + r2 <= 2K + zt
                if q_lo <= c_q and t_lo <= c_t and q_lo + t_lo <= k2 + zt:
                    compat[jq, jt] = True
    return compat


def bin_plane_from_words(words, xp):
    """Per-pixel bin id in [0, N_BINS) or -1 for unselected/no-sector
    pixels, for numpy or torch (`xp`) packed scorer words."""
    b = words & 0xFF
    a = (words >> 8) & 0xFF
    s = (words >> 16) & 0x7
    sel = (words >> 19) & 1
    # rbin via integer arithmetic: floor(a/b * NB) (b >= 1); clamp to NB-1
    rb = xp.clip((a * NB) // xp.clip(b, 1, None), None, NB - 1)
    bins = (s - 1) * NB + rb
    return xp.where((sel > 0) & (s > 0), bins, -1)


def query_features(words: np.ndarray) -> np.ndarray:
    """[npos * N_BINS] cell-bin counts for a query (host); npos = cell
    rows x cols, row-major. uint8: cell counts are <= 128."""
    h, w = words.shape
    gh = -(-h // TILE_H)
    gw = -(-w // TILE_W)
    ghn, gwn = _cell_grid((gh, gw))
    padded = np.full((gh * TILE_H, gw * TILE_W), -1, dtype=np.int64)
    padded[:h, :w] = bin_plane_from_words(words.astype(np.int64), np)
    tiles = padded.reshape(ghn, SUBTILE_H, gwn, SUBTILE_W).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(ghn * gwn, SUBTILE_H * SUBTILE_W)
    dt = np.uint8 if SUBTILE_H * SUBTILE_W <= 255 else np.float32
    feats = np.zeros((ghn * gwn, N_BINS), dtype=dt)
    for j in range(N_BINS):
        feats[:, j] = (tiles == j).sum(axis=1).astype(dt)
    return feats.reshape(-1)


def _bitmask_planes(t_words: torch.Tensor, flip: bool) -> torch.Tensor:
    """[T, N_PLANES, H, W] int32 bin-presence bitmask planes (bins packed
    30 per plane), undilated. The flip is of the raw plane."""
    if flip:
        t_words = torch.flip(t_words, dims=(2,))
    bins = bin_plane_from_words(t_words, torch)
    valid = bins >= 0
    one = torch.ones_like(bins)
    planes = []
    for p in range(N_PLANES):
        lo, hi = 30 * p, 30 * (p + 1)
        here = valid & (bins >= lo) & (bins < hi)
        shift = torch.where(here, bins - lo, 0)
        planes.append(torch.where(here, one << shift, 0))
    return torch.stack(planes, dim=1).to(torch.int32)


def _presence_from_bits(tile_or: torch.Tensor) -> torch.Tensor:
    """[T, npos, N_BINS] f32 presence from [T, N_PLANES, npos] bitmasks."""
    k_ids = torch.arange(30, dtype=torch.int32, device=tile_or.device)
    parts = [(tile_or[:, p, :, None] >> k_ids) & 1 for p in range(N_PLANES)]
    return torch.cat(parts, dim=-1)[..., :N_BINS].to(torch.float32)


def _window(x: torch.Tensor, dim: int, k: int, op) -> torch.Tensor:
    """'valid' sliding-window reduction of width k along `dim`."""
    n = x.shape[dim] - k + 1
    out = x.narrow(dim, 0, n)
    for i in range(1, k):
        out = op(out, x.narrow(dim, i, n))
    return out


def _sliding_cell_stats(t_words: torch.Tensor, flip: bool, pad: int,
                        grid_hw):
    """Sliding-window (SUBTILE_H x SUBTILE_W) statistics over the
    pad-ringed tile-aligned frame, computed once and sliced per offset:
      or_full  [T, P, Hc-SUBTILE_H+1, Wc-SUBTILE_W+1]  presence bitmasks
      cnt_full [T,    Hc-SUBTILE_H+1, Wc-SUBTILE_W+1]  bin-valid counts
    """
    gh, gw = grid_hw
    tsz, h, w = t_words.shape
    words2 = _bitmask_planes(t_words, flip)               # [T, P, H, W]
    hc = gh * TILE_H + 2 * pad
    wc = gw * TILE_W + 2 * pad
    canvas = torch.zeros((tsz, N_PLANES, hc, wc), dtype=torch.int32,
                         device=t_words.device)
    canvas[:, :, pad:pad + h, pad:pad + w] = words2
    any_bin = canvas[:, 0]
    for p in range(1, N_PLANES):
        any_bin = any_bin | canvas[:, p]
    cnt = (any_bin != 0).to(torch.int32)
    or_full = _window(_window(canvas, 2, SUBTILE_H, torch.bitwise_or),
                      3, SUBTILE_W, torch.bitwise_or)
    cnt_full = _window(_window(cnt, 1, SUBTILE_H, torch.add),
                       2, SUBTILE_W, torch.add)
    return or_full, cnt_full


def _cell_slice(full: torch.Tensor, pad: int, dx: int, dy: int, grid_hw):
    """Strided slice picking the cell grid shifted by (dx, dy)."""
    ghn, gwn = _cell_grid(grid_hw)
    r0, c0 = pad + dy, pad + dx
    out = full[..., r0:r0 + (ghn - 1) * SUBTILE_H + 1:SUBTILE_H,
               c0:c0 + (gwn - 1) * SUBTILE_W + 1:SUBTILE_W]
    return out.reshape(full.shape[:-2] + (ghn * gwn,))


def _variant_block_bounds_capped(u3: torch.Tensor, t_words: torch.Tensor,
                                 zt9: int, offsets, grid_hw,
                                 flip: bool) -> torch.Tensor:
    """Count-capped per-offset-max upper bounds [B, T'] (f32, integral),
    as dense fp32 products over every cell and bin (the JAX package's
    formulation). `bounds_from_words` computes the same bound in two
    kernels; chip_smoke.py times this one beside them.

    u3: f32 [B, npos, N_BINS] query cell-bin counts; t_words: int32
    [T', H, W] packed target words (unpadded frame)."""
    tsz = t_words.shape[0]
    pad = max((max(abs(dx), abs(dy)) for dx, dy in offsets), default=0)
    or_full, cnt_full = _sliding_cell_stats(t_words, flip, pad, grid_hw)
    compat = torch.from_numpy(compat_matrix(zt9).astype(np.float32)).to(
        t_words.device)                                    # [J, K]
    bsz, npos = u3.shape[0], u3.shape[1]
    # chunk the per-cell [B, T', chunk] temp to ~128 MB
    chunk = max(1, min(npos, (128 << 20) // max(bsz * tsz * 4, 1)))
    best = None
    for dx, dy in offsets:
        tile_or = _cell_slice(or_full, pad, dx, dy, grid_hw)  # [T, P, npos]
        cnts = _cell_slice(cnt_full, pad, dx, dy, grid_hw)    # [T, npos]
        pres = _presence_from_bits(tile_or)                   # [T, npos, K]
        w01 = ((pres @ compat.T) > 0).to(torch.float32)       # [T, npos, J]
        cnts_f = cnts.to(torch.float32)
        bound_o = torch.zeros((bsz, tsz), dtype=torch.float32,
                              device=t_words.device)
        for p0 in range(0, npos, chunk):
            s = torch.einsum("bpj,tpj->btp", u3[:, p0:p0 + chunk],
                             w01[:, p0:p0 + chunk])
            capped = torch.minimum(s, cnts_f[None, :, p0:p0 + chunk])
            bound_o = bound_o + capped.sum(dim=2)
        best = bound_o if best is None else torch.maximum(best, bound_o)
    return best


# ---- the count-capped bound in two stages ----------------------------------

# elements of one [entries, targets] temporary of capped_bounds_plain
PLAIN_ELEMS = 1 << 24
MAX_OFFSETS = 32  # shift offsets the kernels take (xyShift <= 6)
MAX_PAD = 8       # largest |dx| or |dy| of an offset the kernels take
# the capped kernel's tiles (csrc/prescreen_bound.cu): a block runs the
# cells of MASK_GROUP masks against the table in bands of BAND_CELLS cells
MASK_GROUP = 128
BAND_CELLS = 64


@functools.lru_cache(maxsize=8)
def col_bits(zt9: int) -> np.ndarray:
    """int64 [N_BINS]: bit j of entry k is set iff a target pixel of bin k
    is compatible with query bin j (compat[j, k]), so that a cell's w01
    is the OR of its valid pixels' entries."""
    compat = compat_matrix(zt9)
    weights = np.left_shift(np.int64(1), np.arange(N_BINS, dtype=np.int64))
    return (compat.astype(np.int64) * weights[:, None]).sum(axis=0)


def cell_masks_plain(t_words: torch.Tensor, zt9: int, offsets, grid_hw):
    """Per variant, cell and target of int32 [T, H, W] packed words (the
    unpadded frame): (bits int64 [2 * n_off, npos, T], bit j set iff the
    shifted cell holds a valid target pixel whose bin is compatible with
    query bin j; cnt uint8 [2 * n_off, npos, T], its valid pixels).

    Variant v < n_off is offset v on the direct frame, v >= n_off offset
    v - n_off on the raw frame flipped in x. A variant's cell (cy, cx) is
    the window of frame rows 8 cy + dy .. +7 and columns 16 cx + dx .. +15
    (_cell_slice of _sliding_cell_stats); pixels outside the frame are
    not valid. Computed in blocks of FEATURE_BLOCK targets."""
    tsz, h, w = t_words.shape
    dev = t_words.device
    ghn, gwn = _cell_grid(grid_hw)
    npos = ghn * gwn
    pad = max((max(abs(dx), abs(dy)) for dx, dy in offsets), default=0)
    # the bin's compat bits; index N_BINS (not valid) holds 0
    table = torch.from_numpy(np.append(col_bits(zt9), 0)).to(dev)
    variants = [(flip, dx, dy) for flip in (False, True)
                for dx, dy in offsets]
    bits = torch.empty((len(variants), npos, tsz), dtype=torch.int64,
                       device=dev)
    cnt = torch.empty((len(variants), npos, tsz), dtype=torch.uint8,
                      device=dev)
    for t0 in range(0, tsz, PairPrescreen.FEATURE_BLOCK):
        blk = t_words[t0:t0 + PairPrescreen.FEATURE_BLOCK]
        n = blk.shape[0]
        bins = bin_plane_from_words(blk, torch)
        bins = torch.where((bins >= 0) & (bins < N_BINS), bins, N_BINS)
        for v, (flip, dx, dy) in enumerate(variants):
            if v % len(offsets) == 0:  # a canvas per orientation
                canvas = torch.full((n, ghn * SUBTILE_H + 2 * pad,
                                     gwn * SUBTILE_W + 2 * pad), N_BINS,
                                    dtype=torch.int64, device=dev)
                canvas[:, pad:pad + h, pad:pad + w] = (
                    torch.flip(bins, dims=(2,)) if flip else bins)
            win = canvas[:, pad + dy:pad + dy + ghn * SUBTILE_H,
                         pad + dx:pad + dx + gwn * SUBTILE_W].reshape(
                n, ghn, SUBTILE_H, gwn, SUBTILE_W)
            ors = or_reduce(or_reduce(table[win], 4), 2)   # [n, ghn, gwn]
            valid = (win < N_BINS).sum(dim=(2, 4))
            bits[v, :, t0:t0 + n] = ors.reshape(n, npos).T
            cnt[v, :, t0:t0 + n] = valid.reshape(n, npos).T.to(torch.uint8)
    return bits, cnt


@dataclass(frozen=True)
class QueryRows:
    """Per-mask CSR of the non-zero query features: mask b's cells are
    cell_pos[mask_off[b]:mask_off[b + 1]] (ascending), and cell c's
    entries are entries[cell_off[c]:cell_off[c + 1]], each bin | count
    << 8 (ascending bins, counts 1..128). All int32, on one device."""

    mask_off: torch.Tensor  # [B + 1]
    cell_pos: torch.Tensor  # [NC]
    cell_off: torch.Tensor  # [NC + 1]
    entries: torch.Tensor   # [NE]
    npos: int

    @property
    def n_masks(self) -> int:
        return self.mask_off.numel() - 1

    @property
    def device(self) -> torch.device:
        return self.entries.device

    def tensors(self):
        return (self.mask_off, self.cell_pos, self.cell_off, self.entries)

    def to(self, device) -> "QueryRows":
        """The rows on `device`: these rows (and their bands, once built)
        when they are there already."""
        if self.device == torch.device(device):
            return self
        return QueryRows(*(t.to(device) for t in self.tensors()),
                         npos=self.npos)

    @functools.cached_property
    def bands(self) -> "QueryBands":
        """The CSR regrouped for the capped kernel (query_bands), on the
        same device; built at first use and kept with the rows."""
        return query_bands(self)

    def to_dense(self) -> torch.Tensor:
        """The uint8 [B, npos * N_BINS] feature matrix it was built from."""
        dev = self.device
        n_cells = self.cell_pos.numel()
        cell_mask = torch.repeat_interleave(
            torch.arange(self.n_masks, device=dev),
            self.mask_off.diff().long())
        ent_cell = torch.repeat_interleave(
            torch.arange(n_cells, device=dev), self.cell_off.diff().long())
        dense = torch.zeros((self.n_masks, self.npos * N_BINS),
                            dtype=torch.uint8, device=dev)
        ent = self.entries.long()
        col = self.cell_pos.long()[ent_cell] * N_BINS + (ent & 63)
        dense[cell_mask[ent_cell], col] = (ent >> 8).to(torch.uint8)
        return dense


@dataclass(frozen=True)
class QueryBands:
    """The cells of a QueryRows regrouped by mask group and band, the
    order and form in which the capped kernel reads them. Group g holds
    masks g * MASK_GROUP .. +MASK_GROUP - 1, band b cells b * BAND_CELLS
    .. +BAND_CELLS - 1. The records of (g, b) are recs[seg_off[g * n_bands
    + b]:seg_off[g * n_bands + b + 1]], by mask, then cell (ascending),
    each (mask - g * MASK_GROUP) << 20 | n_hi << 14 | n_lo << 8 | (cell -
    b * BAND_CELLS), int32. Record k's entries are entries[rec_off[k]:
    rec_off[k + 1]], int64: its cell's n_lo entries of bins below 32, then
    its n_hi others, each count << 32 | 1 << (bin % 32), so that the
    kernel tests a target's bit with one AND. On the rows' device."""

    seg_off: torch.Tensor  # int32 [n_groups * n_bands + 1]
    recs: torch.Tensor     # int32 [NC]
    rec_off: torch.Tensor  # int32 [NC + 1]
    entries: torch.Tensor  # int64 [NE]
    n_bands: int

    def tensors(self):
        return (self.seg_off, self.recs, self.rec_off, self.entries)


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """int32 [n + 1] exclusive prefix sums of n counts, from 0."""
    off = torch.zeros(counts.numel() + 1, dtype=torch.int32,
                      device=counts.device)
    torch.cumsum(counts, 0, out=off[1:])
    return off


def query_bands(rows: QueryRows) -> QueryBands:
    """The QueryBands of a query CSR, computed on its device: one stable
    sort of the cells by (mask group, band) and a gather of their
    entries (a cell's entries stay in ascending bin order)."""
    dev = rows.device
    n_bands = -(-rows.npos // BAND_CELLS)
    n_groups = -(-rows.n_masks // MASK_GROUP)
    n_cells = rows.cell_pos.numel()
    mask = torch.repeat_interleave(torch.arange(rows.n_masks, device=dev),
                                   rows.mask_off.diff().long())
    pos = rows.cell_pos.long()
    per_cell = rows.cell_off.diff().long()
    ent = rows.entries.long()
    ent_cell = torch.repeat_interleave(torch.arange(n_cells, device=dev),
                                       per_cell)
    n_lo = torch.bincount(ent_cell[(ent & 63) < 32], minlength=n_cells)
    key = mask // MASK_GROUP * n_bands + pos // BAND_CELLS
    order = torch.sort(key, stable=True).indices
    recs = (mask % MASK_GROUP << 20 | (per_cell - n_lo) << 14 | n_lo << 8
            | pos % BAND_CELLS)[order]
    per = per_cell[order]
    rec_off = _offsets(per)
    first = torch.repeat_interleave(rows.cell_off[:-1].long()[order], per)
    start = torch.repeat_interleave(rec_off[:-1].long(), per)
    moved = ent[first + torch.arange(first.numel(), device=dev) - start]
    return QueryBands(
        seg_off=_offsets(torch.bincount(key, minlength=n_groups * n_bands)),
        recs=recs.to(torch.int32), rec_off=rec_off,
        entries=moved >> 8 << 32 | 1 << (moved & 31), n_bands=n_bands)


def sparse_query_rows(u_matrix) -> QueryRows:
    """The CSR of a [B, npos * N_BINS] query feature matrix (numpy or a
    tensor; counts <= 255), on the tensor's device (numpy: the CPU)."""
    u = (u_matrix if isinstance(u_matrix, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(u_matrix)))
    bsz = u.shape[0]
    npos = u.shape[1] // N_BINS
    flat = u.reshape(-1)
    at, = torch.nonzero(flat, as_tuple=True)  # ascending: row-major order
    cells, per_cell = torch.unique_consecutive(at // N_BINS,
                                               return_counts=True)
    count = flat[at].to(torch.int64)
    return QueryRows(
        mask_off=_offsets(torch.bincount(cells // npos, minlength=bsz)),
        cell_pos=(cells % npos).to(torch.int32),
        cell_off=_offsets(per_cell),
        entries=(at % N_BINS | (count << 8)).to(torch.int32), npos=npos)


def capped_bounds_plain(rows: QueryRows, bits: torch.Tensor,
                        cnt: torch.Tensor) -> torch.Tensor:
    """f32 [B, T] count-capped bounds: for each mask the max over the
    variants of sum over its cells C of min(sum over C's entries (j, n)
    of n * bit j of bits[v, C], cnt[v, C]). Integer sums, in blocks of
    targets that keep each [entries, targets] temporary near PLAIN_ELEMS
    elements."""
    nv, npos, tsz = bits.shape
    dev = bits.device
    bsz, n_cells = rows.n_masks, rows.cell_pos.numel()
    best = torch.zeros((bsz, tsz), dtype=torch.int64, device=dev)
    if n_cells == 0:
        return best.to(torch.float32)
    cell_mask = torch.repeat_interleave(torch.arange(bsz, device=dev),
                                        rows.mask_off.diff().long())
    ent_cell = torch.repeat_interleave(torch.arange(n_cells, device=dev),
                                       rows.cell_off.diff().long())
    cell_pos = rows.cell_pos.long()
    ent_pos = cell_pos[ent_cell]
    ent = rows.entries.long()
    ent_bin, ent_n = (ent & 63)[:, None], (ent >> 8)[:, None]
    step = max(1, PLAIN_ELEMS // ent.numel())
    for t0 in range(0, tsz, step):
        t1 = min(tsz, t0 + step)
        for v in range(nv):
            hit = (bits[v, :, t0:t1][ent_pos] >> ent_bin) & 1
            s = torch.zeros((n_cells, t1 - t0), dtype=torch.int64,
                            device=dev).index_add_(0, ent_cell, hit * ent_n)
            capped = torch.minimum(s, cnt[v, :, t0:t1][cell_pos].long())
            total = torch.zeros((bsz, t1 - t0), dtype=torch.int64,
                                device=dev).index_add_(0, cell_mask, capped)
            best[:, t0:t1] = torch.maximum(best[:, t0:t1], total)
    return best.to(torch.float32)


def prescreen_cells(t_words: torch.Tensor, zt9: int, offsets, grid_hw):
    """(bits, cnt) of cell_masks_plain. CPU tensors run the plain
    version; a CUDA tensor launches `cms_prescreen_cells` (built at first
    use) or raises. The checks come first, on every device."""
    _check("t_words", t_words, torch.int32, 3, t_words.device)
    tsz, h, w = t_words.shape
    ghn, gwn = _cell_grid(grid_hw)
    if not (0 < h <= ghn * SUBTILE_H and 0 < w <= gwn * SUBTILE_W):
        raise ValueError(f"frame {h}x{w} does not fit the cell grid "
                         f"{ghn}x{gwn}")
    if not 0 < len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets: expected 1 to "
                         f"{MAX_OFFSETS}")
    if max(max(abs(dx), abs(dy)) for dx, dy in offsets) > MAX_PAD:
        raise ValueError(f"an offset beyond {MAX_PAD} pixels")
    if not _on_cuda([t_words]):
        return cell_masks_plain(t_words, zt9, offsets, grid_hw)
    lib = kernels.load_library("prescreen_bound").lib
    dev = t_words.device
    nv, npos = 2 * len(offsets), ghn * gwn
    bits = torch.empty((nv, npos, tsz), dtype=torch.int64, device=dev)
    cnt = torch.empty((nv, npos, tsz), dtype=torch.uint8, device=dev)
    if tsz == 0:
        return bits, cnt
    shifts = [int(s) for dx, dy in offsets for s in (dx, dy)]
    rc = lib.cms_prescreen_cells(
        t_words.data_ptr(), tsz, h, w, ghn, gwn,
        (ctypes.c_longlong * N_BINS)(*(int(b) for b in col_bits(zt9))),
        len(offsets), (ctypes.c_int * len(shifts))(*shifts),
        bits.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"prescreen_cells kernel launch failed: "
                           f"cudaError {rc}")
    prescreen_cells.launches += 1
    return bits, cnt


prescreen_cells.launches = 0


def prescreen_capped(rows: QueryRows, bits: torch.Tensor,
                     cnt: torch.Tensor) -> torch.Tensor:
    """f32 [B, T] bounds of capped_bounds_plain. CPU tensors run the
    plain version; CUDA tensors launch `cms_prescreen_capped` (built at
    first use) or raise; the kernel reads `rows.bands`, built at the first
    launch with these rows. The checks come first, on every device."""
    on_cuda = _on_cuda([*rows.tensors(), bits, cnt])
    dev = bits.device
    for name, t in zip(("mask_off", "cell_pos", "cell_off", "entries"),
                       rows.tensors()):
        _check(name, t, torch.int32, 1, dev)
    _check("bits", bits, torch.int64, 3, dev)
    _check("cnt", cnt, torch.uint8, 3, dev)
    nv, npos, tsz = bits.shape
    if tuple(cnt.shape) != tuple(bits.shape) or npos != rows.npos:
        raise ValueError(f"bits {tuple(bits.shape)}, cnt "
                         f"{tuple(cnt.shape)} and {rows.npos} query cells "
                         f"do not agree")
    if rows.cell_off.numel() != rows.cell_pos.numel() + 1:
        raise ValueError("cell_off needs one entry more than cell_pos")
    if not 0 < nv <= 2 * MAX_OFFSETS:
        raise ValueError(f"{nv} variants: expected 1 to {2 * MAX_OFFSETS}")
    if not on_cuda:
        return capped_bounds_plain(rows, bits, cnt)
    lib = kernels.load_library("prescreen_bound").lib
    out = torch.zeros((rows.n_masks, tsz), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    bands = rows.bands
    rc = lib.cms_prescreen_capped(
        *(t.data_ptr() for t in bands.tensors()), bands.entries.numel(),
        rows.n_masks, MASK_GROUP,
        BAND_CELLS, bands.n_bands, bits.data_ptr(), cnt.data_ptr(), nv,
        npos, tsz, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"prescreen_capped kernel launch failed: "
                           f"cudaError {rc}")
    prescreen_capped.launches += 1
    return out


prescreen_capped.launches = 0


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over one dimension, which it drops (torch has no OR
    reduction): the two halves are ORed until one slice is left."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = x.narrow(dim, 0, n // 2) | x.narrow(dim, n // 2, n // 2)
        x = half | x.narrow(dim, n - 1, 1) if n % 2 else half
    return x.squeeze(dim)


def _or_dilate(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """OR over a centred window of 2 * pad + 1 along `dim`, zero outside
    (reduce_window with "same" padding): shifted ORs of a zero-ringed
    copy."""
    n = x.shape[dim]
    ring = [0, 0] * (x.dim() - 1 - dim) + [pad, pad]
    padded = torch.nn.functional.pad(x, ring)
    return _window(padded, dim, 2 * pad + 1, torch.bitwise_or).narrow(
        dim, 0, n)


def target_features(t_words: torch.Tensor, zt9: int, xy_shift: int, grid_hw,
                    flip: bool = False) -> torch.Tensor:
    """f32 0/1 [T, npos * N_BINS] compat-presence features, on the device
    of t_words (int32 [T, H, W] packed target words, unpadded frame):
    w01[c, j] = 1 iff the cell c dilated by xy_shift holds a target pixel
    whose bin is compatible with query bin j. flip=True gives the
    features of the x-flipped frame (the flip is of the raw plane)."""
    gh, gw = grid_hw
    tsz, h, w = t_words.shape
    pad = max(xy_shift, 0)
    words2 = _bitmask_planes(t_words, flip)               # [T, P, H, W]
    if pad:
        # the rectangular OR-dilation is separable: one pass per axis
        words2 = _or_dilate(_or_dilate(words2, 2, pad), 3, pad)
    ghn, gwn = _cell_grid(grid_hw)
    padded = torch.zeros((tsz, N_PLANES, gh * TILE_H, gw * TILE_W),
                         dtype=torch.int32, device=t_words.device)
    padded[:, :, :h, :w] = words2
    cells = padded.reshape(tsz, N_PLANES, ghn, SUBTILE_H, gwn, SUBTILE_W)
    tile_or = or_reduce(or_reduce(cells, 5), 3).reshape(
        tsz, N_PLANES, ghn * gwn)                         # [T, P, npos]
    compat = torch.from_numpy(compat_matrix(zt9).astype(np.float32)).to(
        t_words.device)                                    # [J, K]
    pres = _presence_from_bits(tile_or)                    # [T, npos, K]
    return ((pres @ compat.T) > 0).to(torch.float32).reshape(tsz, -1)


def _bounds_matmul(u: torch.Tensor, wd: torch.Tensor, wm: torch.Tensor
                   ) -> torch.Tensor:
    """max(u wd^T, u wm^T): the feature bound [B, T] (f32, integral)."""
    return torch.maximum(u @ wd.T, u @ wm.T)


@contextlib.contextmanager
def _fp32_matmul():
    """CUDA matmuls in full fp32 (TF32 off) inside the block; the
    process-wide setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class PairPrescreen:
    """Block-level screen: bounds [B, T] for every (mask, target) pair,
    computed on the device that holds the target words."""

    # target sub-block: bounds the [T, planes, H, W] temporaries
    FEATURE_BLOCK = 64

    def __init__(self, zt9: int, xy_shift: int, height: int, width: int):
        self.zt9 = zt9
        self.xy_shift = xy_shift
        self.grid_hw = (-(-height // TILE_H), -(-width // TILE_W))
        self.height = height
        self.width = width
        self.offsets = tuple(shift_ring_offsets(xy_shift))

    def query_features(self, words: np.ndarray) -> np.ndarray:
        return query_features(words)

    def target_features(self, t_words: torch.Tensor,
                        t_words_flipped: torch.Tensor = None) -> tuple:
        """(direct, mirrored) f32 [T, npos * N_BINS] compat-presence
        features on the device of t_words, computed in FEATURE_BLOCK
        target sub-blocks. Without t_words_flipped the mirrored features
        come from a flip of each sub-block."""
        outs_d, outs_m = [], []
        with _fp32_matmul():
            for i in range(0, t_words.shape[0], self.FEATURE_BLOCK):
                wb = t_words[i:i + self.FEATURE_BLOCK]
                outs_d.append(target_features(wb, self.zt9, self.xy_shift,
                                              self.grid_hw))
                if t_words_flipped is None:
                    outs_m.append(target_features(
                        wb, self.zt9, self.xy_shift, self.grid_hw, flip=True))
                else:
                    outs_m.append(target_features(
                        t_words_flipped[i:i + self.FEATURE_BLOCK], self.zt9,
                        self.xy_shift, self.grid_hw))
        if not outs_d:
            npos = int(np.prod(_cell_grid(self.grid_hw)))
            empty = torch.zeros((0, npos * N_BINS), dtype=torch.float32,
                                device=t_words.device)
            return empty, empty
        return torch.cat(outs_d), torch.cat(outs_m)

    def bounds(self, u_block, tfeats) -> np.ndarray:
        """Feature bounds [B, T] (numpy f32) from a query feature matrix
        [B, npos * N_BINS] and target_features' (direct, mirrored) pair,
        on the features' device."""
        wd, wm = tfeats
        u = torch.as_tensor(u_block).to(device=wd.device,
                                        dtype=torch.float32)
        with _fp32_matmul():  # exact fp32 products
            return _bounds_matmul(u, wd, wm).cpu().numpy()

    def bounds_from_words(self, u_matrix, t_words: torch.Tensor
                          ) -> np.ndarray:
        """Variant-consistent bounds [B, T] (numpy f32) from the query
        features (a QueryRows CSR, or a numpy or tensor [B, npos * N_BINS]
        matrix, turned into one) and packed target words on their device:
        prescreen_cells, then prescreen_capped, on the whole partition;
        one copy to the host at the end."""
        rows = (u_matrix if isinstance(u_matrix, QueryRows)
                else sparse_query_rows(u_matrix)).to(t_words.device)
        bits, cnt = prescreen_cells(t_words, self.zt9, self.offsets,
                                    self.grid_hw)
        bounds = prescreen_capped(rows, bits, cnt)
        with trace.span("sweep.wait"):
            return bounds.cpu().numpy()
