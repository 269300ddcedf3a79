"""Active-tile pixel-match engine for one mask, in PyTorch.

Counterpart of `colormipsearch_tpu/cds/pixel_pallas.py` (:57-260 word
predicate, :323-383 query tiles, :702-1059 engine and deferred results).
A neuron mask occupies a few percent of the frame, so the exact scorer
touches only the mask's ACTIVE 8x128 tiles. This module holds:

- the packed-word predicate as plain torch ops on int32
  (`_match_unpacked`, with its six constants from `word_triples`): the
  exact staged-rational hue-gap test on raw words, which the reference
  runs under `CMS_RATIO_PRED=0`;
- the host query tables (`ActiveTiles`, `build_active_tiles`): the
  mask's active tiles as raw words, their window origins and, for the
  ratio predicate only, its compare planes
  (`ratio_bounds.query_ratio_planes`); and the compact lists the
  kernels walk (`compact_selected`): per active tile, the pixels that can
  match under the engine's predicate, with their constants gathered in
  that order;
- target pack and pad on an explicit device: the raw u8 block goes to
  the device in chunks through staging buffers (`stage_frames`, pinned
  on a card) and `pack_words` packs the words there (the kernel
  `csrc/target_pack.cu` on a card, its plain version `pack_words_plain`
  on the CPU); then the ring pad and the x-flip of the raw plane; for the
  ratio predicate, its prepared target planes (`pad_ratio_planes`: the
  f32 ratio plane and the flag plane, built once per target block in the
  same pass);
- `ActiveTilePixelEngine.score_packed`, a one-mask launch of the exact
  multi-mask kernel of the engine's predicate (`cds/multimask.py`).

Left out, as workarounds for the TPU: the 64-target block placement
(`DEVICE_BLOCK`, `PACK_SUPER`), the K=128/768 tile-count buckets and the
packed-constant and f32-product forms of the word predicate (the v5e
emulates int32 multiply; all three forms are bit-identical). Here a
mask's tables hold exactly its active tiles.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels
from .exact_ratio import c9_split
from .oracle import shift_ring_offsets
from .pixel_kernel import (PAIR_K9, QueryPlanes, prepare_query_planes,
                           target_words, z_tolerance_to_zt9)
from .ratio_bounds import query_ratio_planes

TILE_H = 8
TILE_W = 128
NV_PAD = 32  # most variants (2 * |shifts|) an engine may have, as the reference
# the exact predicates: the f32 ratio-interval test (the default) and the
# int32 staged-rational test on packed words (the reference's
# CMS_RATIO_PRED=0); both give the same scores
PREDICATES = ("ratio", "words")
# a compact entry carries its pixel's place in the tile, y * 128 + x
# (10 bits), above the bits its predicate's constant uses: q_cmp uses
# bits 0-17, a packed word bits 0-21
POS_SHIFT = {"ratio": 20, "words": 22}
# the compare-constant sentinels of ratio_bounds.query_ratio_planes: a
# query pixel whose three constants are all sentinels never matches
_SENTINELS = (31, 31, 63)


# targets a pinned staging chunk holds: 32 frames of 1210 x 566 are 65.7
# MB, so the two buffers of stage_frames hold 128 MiB (the caching host
# allocator rounds each up to 64 MiB)
STAGE_TARGETS = 32
STAGE_SLOTS = 2


# ---- the packed-word predicate, plain version ------------------------------

def _unpack(word):
    """(b, a, sector, sel, cl, cu) int32 fields of packed words (reference
    pixel_pallas._unpack)."""
    return (word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0x7,
            (word >> 19) & 1, (word >> 20) & 1, (word >> 21) & 1)


def _leq_geq_chain(u, v, q, r_hi, r_lo):
    """Exact u/v <= C and u/v >= C for C = (q*1e6 + r_hi*64 + r_lo)/1e9 in
    int32 (reference pixel_pallas._leq_geq_chain; exact_ratio.py proves
    the bands).

    Signed overflow: e = d*15625 - r_hi*v overflows int32 when d is
    outside its band. The reference wraps there and never reads e, but
    signed overflow is undefined in C++, so e is computed from d only
    inside the band (from 0 elsewhere), here and in the CUDA kernel:
    exact, with no wrap and no int64."""
    d = u * 1000 - q * v
    in_d = (d >= 0) & (d <= 65601)
    e = torch.where(in_d, d, 0) * 15625 - r_hi * v
    in_e = (e >= 0) & (e <= 65601)
    e_band = 64 * torch.where(in_e, e, 0)
    rv = r_lo * v
    leq_e = (e < 0) | (in_e & (e_band <= rv))
    geq_e = (e >= 0) & ((e_band >= rv) | ~in_e)
    leq = (d < 0) | (in_d & leq_e)
    geq = (d >= 0) & (geq_e | ~in_d)
    return leq, geq


def _select_by_lo(lo, values):
    """values[lo - 1] where lo is 2..5, values[0] elsewhere (reference)."""
    out = torch.full_like(lo, values[0])
    for i in (2, 3, 4, 5):
        out = torch.where(lo == i, values[i - 1], out)
    return out


def word_triples(zt9: int) -> tuple:
    """The six c9_split triples (Q, Rhi, Rlo) of the word predicate at
    zt9: index 0 for the same-sector test (leq at zt9), index lo = 1..5
    for the adjacent test of sector pair (lo, lo + 1).

    Parity: even lo (2, 4) tests geq at max(2k - zt9, 0), odd lo tests
    leq at 2k + zt9, k = PAIR_K9[lo - 1]. Every split the reference
    computes is computed here, so an out-of-range zt9 raises its
    ValueError (c9_split refuses Q > 3000, which allows
    zt9 <= 1,008,843,137). That includes the c9 = 0 branch:
    max(2k - zt9, 0) is 0 for zt9 >= 709,725,490 at pair 1's k, whose
    geq split is computed and not used (pair 1 tests leq); the even
    pairs' 2k is 1,992,156,862, so their constant stays above 9.8e8."""
    leq = [c9_split(2 * k + zt9) for k in PAIR_K9]
    geq = [c9_split(max(2 * k - zt9, 0)) for k in PAIR_K9]
    return (c9_split(zt9),) + tuple(
        geq[lo - 1] if lo % 2 == 0 else leq[lo - 1] for lo in range(1, 6))


def _match_unpacked(q, t, triples):
    """The exact packed-word predicate on unpacked fields (reference
    pixel_pallas._match_unpacked, its general form, with the constants
    given as word_triples(zt9)). q and t are _unpack tuples of int32
    tensors that broadcast; returns bool.

    Parity and direction: lo is s1 when s2 == s1 + 1 (up), else s2; up
    needs qcu & tcl, down (s1 == s2 + 1) needs qcl & tcu, both need
    min(s1, s2) > 0; even lo tests geq and odd lo leq."""
    b1, a1, s1, qsel, qcl, qcu = q
    b2, a2, s2, tsel, tcl, tcu = t
    p = b1 * b2
    diff = (a2 * b1 - a1 * b2).abs()
    same_leq, _ = _leq_geq_chain(diff, p, *triples[0])
    same_ok = (s1 == s2) & (s1 > 0) & (a1 > 0) & (a2 > 0) & same_leq
    up = s2 == s1 + 1
    down = s1 == s2 + 1
    adj = (up | down) & (torch.minimum(s1, s2) > 0)
    lo = torch.where(up, s1, s2)
    cond = (up & ((qcu & tcl) > 0)) | (down & ((qcl & tcu) > 0))
    q_c, rh_c, rl_c = (_select_by_lo(lo, [tr[j] for tr in triples[1:]])
                       for j in range(3))
    leq, geq = _leq_geq_chain(a1 * b2 + a2 * b1, p, q_c, rh_c, rl_c)
    is_even = (lo == 2) | (lo == 4)
    gap_ok = (is_even & geq) | (~is_even & leq)
    return ((qsel & tsel) > 0) & (same_ok | (adj & cond & gap_ok))


def ratio_prep(w):
    """Ratio plane a2/b2 (-1 where a2 == 0; IEEE f32 divide) and flag
    plane w >> 16 of packed words (reference pixel_pallas._ratio_prep)."""
    a2 = (w >> 8) & 0xFF
    rf = a2.to(torch.float32) / (w & 0xFF).to(torch.float32)
    return torch.where(a2 == 0, torch.full_like(rf, -1.0), rf), w >> 16


def _match_predicate(q, t, zt9: int):
    """The packed-word predicate at zt9 (reference
    pixel_pallas._match_predicate without its v5e forms)."""
    return _match_unpacked(q, t, word_triples(zt9))


# ---- query tables ------------------------------------------------------------

@dataclass
class ActiveTiles:
    """Host-prepared active-tile decomposition of one query.

    K = n_active: one entry per tile holding a selected query pixel. The
    ratio predicate's planes are built only for it (None otherwise), as
    in the reference."""
    coords: np.ndarray    # int32 [K, 2]: tile origin (row, col) in the raw frame
    n_active: int
    query_size: int
    height: int
    width: int
    q_words: np.ndarray   # int32 [K, TILE_H, TILE_W] raw packed query words
    q_cmp: Optional[np.ndarray] = None  # int32 [K, TILE_H, TILE_W] compare constants
    q_f32: Optional[np.ndarray] = None  # f32 [K, 4, TILE_H, TILE_W]: L, U, Cup, Cdn
    # the compact lists of one predicate (compact_selected): tile k's
    # selected pixels are entries sel_off[k] .. sel_off[k+1] - 1
    sel_off: Optional[np.ndarray] = None  # int32 [K + 1]
    sel_q: Optional[np.ndarray] = None    # int32 [P]: const | pos << POS_SHIFT
    sel_f32: Optional[np.ndarray] = None  # f32 [P, 4] ("ratio"): L, U, Cup, Cdn

    @classmethod
    def from_numpy(cls, coords, n_active: int, q_tiles, query_size: int,
                   height: int, width: int, q_cmp=None, q_f32=None
                   ) -> "ActiveTiles":
        """Tables from arrays in the reference's layout (its K-bucket
        padding and the n_active column of `coords` are dropped). q_cmp
        and q_f32 are None for a words-predicate reference engine."""
        k = int(n_active)

        def cut(a, dtype):
            return None if a is None else np.ascontiguousarray(
                np.asarray(a)[:k], dtype=dtype)

        return cls(
            coords=np.ascontiguousarray(np.asarray(coords)[:k, :2],
                                        dtype=np.int32),
            n_active=k, query_size=int(query_size), height=int(height),
            width=int(width), q_words=cut(q_tiles, np.int32),
            q_cmp=cut(q_cmp, np.int32), q_f32=cut(q_f32, np.float32))

    def for_predicate(self, predicate: str, zt9: int) -> "ActiveTiles":
        """These tiles with the tables of `predicate`: the ratio planes are
        built from q_words where missing and dropped for "words"."""
        if predicate not in PREDICATES:
            raise ValueError(f"predicate {predicate!r} not in {PREDICATES}")
        if predicate == "words":
            return dataclasses.replace(self, q_cmp=None, q_f32=None,
                                       sel_off=None, sel_q=None,
                                       sel_f32=None)
        if self.q_cmp is not None:
            return self
        q_cmp, q_f32 = query_ratio_planes(self.q_words, zt9)
        return dataclasses.replace(
            self, q_cmp=np.ascontiguousarray(q_cmp, dtype=np.int32),
            q_f32=np.ascontiguousarray(q_f32.transpose(1, 0, 2, 3),
                                       dtype=np.float32),
            sel_off=None, sel_q=None, sel_f32=None)

    def compacted(self, predicate: str) -> "ActiveTiles":
        """These tiles with the compact lists of `predicate` (built once;
        see compact_selected)."""
        if self.sel_off is not None and (predicate == "words") == (
                self.sel_f32 is None):
            return self
        return dataclasses.replace(self, **compact_selected(self, predicate))


def selected_pixels(tiles: ActiveTiles, predicate: str) -> np.ndarray:
    """bool [K, TILE_H, TILE_W]: the query pixels that can match under
    `predicate`; every other pixel scores 0 against any target (the
    kernels' exact skips of the reference's layout).

    - "ratio": not all three compare constants are sentinels;
    - "words": sel is set and one of the three cases' query-side
      preconditions holds (same: s1 > 0 and a1 > 0; up: s1 > 0 and cu;
      down: s1 > 1 and cl), as _match_unpacked requires."""
    if predicate == "ratio":
        qc = tiles.q_cmp
        sentinel = ((qc & 31) == _SENTINELS[0]) \
            & (((qc >> 5) & 31) == _SENTINELS[1]) \
            & (((qc >> 10) & 63) == _SENTINELS[2])
        return ~sentinel
    _, a1, s1, qsel, qcl, qcu = _unpack(tiles.q_words)
    pre = ((s1 > 0) & (a1 > 0)) | ((s1 > 0) & (qcu > 0)) \
        | ((s1 > 1) & (qcl > 0))
    return (qsel > 0) & pre


def compact_selected(tiles: ActiveTiles, predicate: str) -> dict:
    """The compact lists the exact kernels walk, as ActiveTiles fields.

    For each active tile the selected pixels (selected_pixels) in row-major
    order: sel_off [K + 1] int32 offsets; sel_q [P] int32, the pixel's
    constant (q_cmp for "ratio", its raw word for "words") with its place
    in the tile (y * 128 + x) at bit POS_SHIFT[predicate]; for "ratio"
    sel_f32 [P, 4] its four f32 bounds. A tile may hold 0 entries."""
    if predicate not in PREDICATES:
        raise ValueError(f"predicate {predicate!r} not in {PREDICATES}")
    k = tiles.n_active
    sel = selected_pixels(tiles, predicate).reshape(k, TILE_H * TILE_W)
    tile, pos = np.nonzero(sel)
    counts = np.bincount(tile, minlength=k)
    const = (tiles.q_cmp if predicate == "ratio" else tiles.q_words
             ).reshape(k, TILE_H * TILE_W)[tile, pos]
    out = dict(
        sel_off=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        sel_q=np.ascontiguousarray(
            const | (pos.astype(np.int32) << POS_SHIFT[predicate]),
            dtype=np.int32),
        sel_f32=None)
    if predicate == "ratio":
        out["sel_f32"] = np.ascontiguousarray(
            tiles.q_f32.reshape(k, 4, TILE_H * TILE_W)[tile, :, pos],
            dtype=np.float32).reshape(-1, 4)
    return out


def build_active_tiles(planes: QueryPlanes, zt9: int,
                       predicate: str = "ratio") -> ActiveTiles:
    """Decompose packed query planes into active 8x128 tiles, with the
    tables of `predicate`.

    coords are tile origins (ty*8, tx*128); in the ring-padded target
    frame (frame[r, c] = t[r - 8, c - 128]) the same numbers are the
    origins of the 3x3 tile neighbourhood around the tile, so shift
    (dx, dy) of query pixel (i, j) samples frame row coords[0]+8+dy+i,
    column coords[1]+128+dx+j."""
    words = planes.words
    h, w = words.shape
    gh = -(-h // TILE_H)
    gw = -(-w // TILE_W)
    padded = np.zeros((gh * TILE_H, gw * TILE_W), dtype=np.int32)
    padded[:h, :w] = words
    sel = (padded >> 19) & 1
    tiles = padded.reshape(gh, TILE_H, gw, TILE_W).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(gh * gw, TILE_H, TILE_W)
    tile_sel = sel.reshape(gh, TILE_H, gw, TILE_W).any(axis=(1, 3)).reshape(-1)
    idx = np.nonzero(tile_sel)[0]
    ty, tx = np.divmod(idx, gw)
    coords = np.stack([ty * TILE_H, tx * TILE_W], axis=1).astype(np.int32)
    return ActiveTiles(
        coords=coords.reshape(-1, 2), n_active=len(idx),
        query_size=planes.query_size, height=h, width=w,
        q_words=np.ascontiguousarray(tiles[idx], dtype=np.int32)
    ).for_predicate(predicate, zt9)


class ActiveTilePixelEngine:
    """Active-tile pixel-match scorer for one query (mask).

    Same scoring semantics as the reference's ActiveTilePixelEngine;
    targets are packed with this engine's prepare_targets (tile-aligned
    padded frame) on the device the caller names. `predicate` picks the
    exact test, "ratio" (the default) or "words" (the reference's
    CMS_RATIO_PRED=0 path); both give the same scores."""

    def __init__(self, query, query_threshold: int, mirror_query: bool,
                 target_threshold: int, pix_color_fluctuation: float,
                 xy_shift: int, excluded: Optional[np.ndarray] = None,
                 predicate: str = "ratio"):
        """query: a decoded RGB image or its [H, W, 3] uint8 pixels."""
        planes = prepare_query_planes(query, query_threshold, excluded)
        zt9 = z_tolerance_to_zt9(pix_color_fluctuation)
        self._setup(build_active_tiles(planes, zt9, predicate), mirror_query,
                    target_threshold, zt9, xy_shift, predicate)
        self.planes = planes

    @classmethod
    def from_tiles(cls, tiles: ActiveTiles, mirror_query: bool,
                   target_threshold: int, zt9: int, xy_shift: int,
                   predicate: str = "ratio") -> "ActiveTilePixelEngine":
        """Engine over query tables built elsewhere (ActiveTiles.from_numpy
        carries the reference engine's exact state across)."""
        eng = cls.__new__(cls)
        eng._setup(tiles, mirror_query, target_threshold, zt9, xy_shift,
                   predicate)
        eng.planes = None
        return eng

    def with_predicate(self, predicate: str) -> "ActiveTilePixelEngine":
        """This mask's engine for another predicate, over the same query
        tiles (no second query prep)."""
        eng = self.from_tiles(self.tiles.for_predicate(predicate, self.zt9),
                              self.mirror_query, self.target_threshold,
                              self.zt9, self.xy_shift, predicate)
        eng.planes = self.planes
        return eng

    def _setup(self, tiles, mirror_query, target_threshold, zt9, xy_shift,
               predicate):
        if predicate not in PREDICATES:
            raise ValueError(f"predicate {predicate!r} not in {PREDICATES}")
        if predicate == "ratio" and tiles.q_cmp is None:
            raise ValueError("ratio predicate without ratio planes")
        self.tiles = tiles.compacted(predicate)
        self.predicate = predicate
        self.mirror_query = bool(mirror_query)
        self.target_threshold = int(target_threshold)
        self.zt9 = int(zt9)
        self.xy_shift = int(xy_shift)
        self.shifts = tuple(shift_ring_offsets(self.xy_shift))
        if 2 * len(self.shifts) > NV_PAD:
            raise ValueError(f"xyShift {xy_shift}: {2 * len(self.shifts)} "
                             f"variants exceed {NV_PAD}")
        # the word predicate's constants (raises for an out-of-range zt9)
        self.triples = (word_triples(self.zt9) if predicate == "words"
                        else None)
        self._solo = None  # one-mask MultiMaskScorer, built on first use

    # ---- target pack and pad -----------------------------------------

    def pack_raw_words(self, targets_u8: np.ndarray, device) -> torch.Tensor:
        """int32 [T, H, W] scorer words (unpadded frame) on `device`; also
        the prescreen's input: the raw block staged to the device
        (stage_frames) and packed there (pack_words)."""
        targets_u8 = np.ascontiguousarray(targets_u8)
        if targets_u8.dtype != np.uint8 or targets_u8.ndim != 4:
            raise ValueError("targets must be uint8 [T, H, W, 3]")
        return pack_words(stage_frames(targets_u8, device),
                          self.target_threshold)

    @staticmethod
    def pad_from_words(words: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tile-aligned ring-padded frame and its x-flip, filled with
        word 1, on the words' device. The flip is of the RAW w-wide plane,
        before the asymmetric tile padding (reference `_pad_block`), so
        flip_x sampling maps to t[w-1-x-dx]."""
        _, h, w = words.shape
        gh = -(-h // TILE_H)
        gw = -(-w // TILE_W)
        # (left, right, top, bottom): one full tile ring around the
        # tile-aligned frame
        spec = (TILE_W, gw * TILE_W - w + TILE_W,
                TILE_H, gh * TILE_H - h + TILE_H)
        pad = torch.nn.functional.pad
        return (pad(words, spec, value=1).contiguous(),
                pad(torch.flip(words, dims=(2,)), spec, value=1).contiguous())

    @staticmethod
    def pad_ratio_planes(words: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The ratio kernel's target planes, built once per target block
        in the pass that pads: (rf, fw, rf_m, fw_m), the ratio plane f32
        and the flag plane uint8 of pad_from_words(words)'s frame and of
        its x-flip, equal to ratio_prep of those frames bit for bit (the
        fill word 1 has a2 = 0 and no flags: -1.0 and 0)."""
        _, h, w = words.shape
        gh = -(-h // TILE_H)
        gw = -(-w // TILE_W)
        spec = (TILE_W, gw * TILE_W - w + TILE_W,
                TILE_H, gh * TILE_H - h + TILE_H)
        pad = torch.nn.functional.pad
        rf, fw = ratio_prep(words)
        fw = fw.to(torch.uint8)
        out = []
        for plane, fill in ((rf, -1.0), (fw, 0)):
            out.append((pad(plane, spec, value=fill).contiguous(),
                        pad(torch.flip(plane, dims=(2,)), spec,
                            value=fill).contiguous()))
        return out[0][0], out[1][0], out[0][1], out[1][1]

    def prepare_targets(self, targets_u8: np.ndarray, device):
        """Pack targets into the padded planes of the engine's predicate
        (pad_for_predicate)."""
        return pad_for_predicate(self.pack_raw_words(targets_u8, device),
                                 self.predicate)

    # ---- scoring -------------------------------------------------------

    def score_packed(self, packed, survivors=None):
        """Exact sweep of this mask over one packed block: a one-mask
        launch of the multi-mask kernel of the engine's predicate (K2 on
        K1's kernel, K3b on K3a's). survivors: optional [T] 0/1 prescreen
        bitmap; zero entries are not scored and report 0. Returns
        (best_scores int64 [T], ratios f64 [T], mirrored bool [T]), the
        ratios best / query_size (0 for a mask without a query pixel)."""
        from .multimask import MultiMaskScorer
        if self._solo is None:
            self._solo = MultiMaskScorer([self])
        tsz = packed[0].shape[0]
        surv = (np.ones((1, tsz), np.int32) if survivors is None
                else np.asarray(survivors).astype(np.int32)[None])
        scores, mirrored = self._solo.launch_block(packed, surv).result()
        best, q = scores[0], self.tiles.query_size
        ratios = (np.zeros(best.shape, np.float64) if q == 0
                  else best.astype(np.float64) / float(q))
        return best, ratios, mirrored[0]

    def score_batch(self, targets_u8: np.ndarray, device):
        """targets_u8: [T, H, W, 3] uint8, scored on `device`. Returns
        (scores, ratios, mirrored)."""
        return self.score_packed(self.prepare_targets(targets_u8, device))


def stage_frames(targets_u8: np.ndarray, device) -> torch.Tensor:
    """The u8 [T, H, W, 3] block on `device`, copied in chunks of
    STAGE_TARGETS targets through STAGE_SLOTS host buffers in turn.

    For a CUDA device the buffers are pinned (PyTorch's caching host
    allocator) and each chunk's copy to the card is non_blocking on the
    current stream, so the host copy of one chunk overlaps the transfer
    of the one before; a buffer is rewritten only after the event
    recorded behind the copy that read it. Nothing waits for the last
    copies: the block's readers are queued behind them on that stream.
    The buffers go back to the allocator when the call returns. On the
    CPU the same loop runs with plain buffers."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    src = torch.from_numpy(np.ascontiguousarray(targets_u8))
    out = torch.empty(src.shape, dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device) if cuda else None
    bufs = [None] * STAGE_SLOTS
    read = [None] * STAGE_SLOTS  # the event behind each buffer's last copy
    for k, t0 in enumerate(range(0, src.shape[0], STAGE_TARGETS)):
        chunk = src[t0:t0 + STAGE_TARGETS]
        slot = k % STAGE_SLOTS
        if read[slot] is not None:
            read[slot].synchronize()
        if bufs[slot] is None or bufs[slot].numel() < chunk.numel():
            bufs[slot] = torch.empty(chunk.numel(), dtype=torch.uint8,
                                     pin_memory=cuda)
        staged = bufs[slot][:chunk.numel()].view(chunk.shape)
        staged.copy_(chunk)
        out[t0:t0 + chunk.shape[0]].copy_(staged, non_blocking=cuda)
        if cuda:
            read[slot] = torch.cuda.Event()
            read[slot].record(stream)
    return out


def pack_words_plain(t_u8: torch.Tensor, threshold: int) -> torch.Tensor:
    """int32 [T, H, W] words of a u8 [T, H, W, 3] block, on its device, by
    the occupancy rule of the JAX package's host feed: a block with more
    than (T*H*W)//4 above-threshold pixels gets target_words everywhere
    (its dense feed); otherwise its sub-threshold pixels get word 1 (b = 1,
    sel = 0: never matches; its sparse feed's scatter fill). The rule is
    applied on the device: nothing is copied to the host."""
    words = target_words(t_u8, threshold)
    sel = ((words >> 19) & 1).bool()
    dense = sel.sum() > words.numel() // 4
    return torch.where(sel | dense, words, 1)


def pack_words(t_u8: torch.Tensor, threshold: int) -> torch.Tensor:
    """pack_words_plain's words. A CPU tensor runs the plain version; a
    CUDA tensor launches `cms_target_pack` (built at first use) or
    raises. The checks come first, on every device."""
    if t_u8.dtype != torch.uint8 or t_u8.dim() != 4 or t_u8.shape[-1] != 3:
        raise ValueError(f"expected a uint8 [T, H, W, 3] block, got "
                         f"{t_u8.dtype} {tuple(t_u8.shape)}")
    if t_u8.device.type != "cuda":
        return pack_words_plain(t_u8, threshold)
    lib = kernels.load_library("target_pack").lib
    t_u8 = t_u8.contiguous()
    dev = t_u8.device
    out = torch.empty(t_u8.shape[:3], dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    count = torch.empty(1, dtype=torch.int64, device=dev)
    # a channel is 0..255: every threshold below 0 (above 255) selects
    # all (no) pixels, as -1 (255) does
    thr = min(max(int(threshold), -1), 255)
    rc = lib.cms_target_pack(t_u8.data_ptr(), out.numel(), thr,
                             count.data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream,
                             dev.index)
    if rc != 0:
        raise RuntimeError(f"target_pack kernel launch failed: "
                           f"cudaError {rc}")
    pack_words.launches += 1
    return out


pack_words.launches = 0


def pad_for_predicate(words: torch.Tensor, predicate: str
                      ) -> Tuple[torch.Tensor, ...]:
    """The padded target planes that `predicate`'s exact kernel reads:
    pad_from_words for "words", pad_ratio_planes for "ratio"."""
    if predicate not in PREDICATES:
        raise ValueError(f"predicate {predicate!r} not in {PREDICATES}")
    return (ActiveTilePixelEngine.pad_ratio_planes(words)
            if predicate == "ratio"
            else ActiveTilePixelEngine.pad_from_words(words))
