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
  (`ratio_bounds.query_ratio_planes`);
- target pack and pad as torch ops on an explicit device: the host
  sparse pack of the reference (`native.mipops.sparse_pack_block`) then
  a scatter with fill word 1, or a dense pack for full blocks; the ring
  pad and the x-flip of the raw plane;
- `ActiveTilePixelEngine.score_packed_deferred`, a one-mask launch of
  the exact multi-mask kernel of the engine's predicate
  (`cds/multimask.py`), and the deferred result handles drained with one
  batched copy to the host.

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

from colormipsearch_tpu.cds.exact_ratio import c9_split
from colormipsearch_tpu.cds.oracle import shift_ring_offsets

from .pixel_kernel import (PAIR_K9, QueryPlanes, pack_planes,
                           prepare_query_planes, z_tolerance_to_zt9)
from .ratio_bounds import query_ratio_planes

TILE_H = 8
TILE_W = 128
NV_PAD = 32  # most variants (2 * |shifts|) an engine may have, as the reference
# the exact predicates: the f32 ratio-interval test (the default) and the
# int32 staged-rational test on packed words (the reference's
# CMS_RATIO_PRED=0); both give the same scores
PREDICATES = ("ratio", "words")


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
            return dataclasses.replace(self, q_cmp=None, q_f32=None)
        if self.q_cmp is not None:
            return self
        q_cmp, q_f32 = query_ratio_planes(self.q_words, zt9)
        return dataclasses.replace(
            self, q_cmp=np.ascontiguousarray(q_cmp, dtype=np.int32),
            q_f32=np.ascontiguousarray(q_f32.transpose(1, 0, 2, 3),
                                       dtype=np.float32))


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
        self.tiles = tiles
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

    def _pack_block(self, t_block_u8: np.ndarray, device) -> torch.Tensor:
        """Dense pack of a [T, H, W, 3] uint8 block on `device`."""
        t = torch.from_numpy(np.ascontiguousarray(t_block_u8)).to(device)
        r = t[..., 0].to(torch.int32)
        g = t[..., 1].to(torch.int32)
        b = t[..., 2].to(torch.int32)
        thr = self.target_threshold
        above = (r > thr) | (g > thr) | (b > thr)
        return pack_planes(r, g, b, above, torch)

    def _pack_block_sparse(self, t_block_u8: np.ndarray, device
                           ) -> Optional[torch.Tensor]:
        """Sparse feed: (flat index, word) pairs of the above-threshold
        pixels, scattered on the device into a plane filled with word 1
        (b=1, sel=0: never matches; sub-threshold pixels canonicalize to
        it, which no score, bound or skip can see). None when the block
        is too dense to benefit."""
        from colormipsearch_tpu.native.mipops import sparse_pack_block
        t, h, w = t_block_u8.shape[:3]
        idx, vals = sparse_pack_block(t_block_u8, self.target_threshold)
        if len(idx) > (t * h * w) // 4:
            return None
        flat = torch.full((t * h * w,), 1, dtype=torch.int32, device=device)
        flat[torch.from_numpy(idx.astype(np.int64)).to(device)] = \
            torch.from_numpy(vals.astype(np.int32)).to(device)
        return flat.reshape(t, h, w)

    def pack_raw_words(self, targets_u8: np.ndarray, device) -> torch.Tensor:
        """int32 [T, H, W] scorer words (unpadded frame) on `device`; also
        the prescreen's input."""
        device = torch.device(device)
        targets_u8 = np.ascontiguousarray(targets_u8)
        if targets_u8.dtype != np.uint8 or targets_u8.ndim != 4:
            raise ValueError("targets must be uint8 [T, H, W, 3]")
        out = self._pack_block_sparse(targets_u8, device)
        if out is None:
            out = self._pack_block(targets_u8, device)
        return out

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

    def prepare_targets(self, targets_u8: np.ndarray, device):
        """Pack targets into the tile-aligned padded frame (+ x-flip)."""
        return self.pad_from_words(self.pack_raw_words(targets_u8, device))

    # ---- scoring -------------------------------------------------------

    def score_packed_deferred(self, packed, survivors=None):
        """Queue the exact sweep of this mask over one packed block and
        return a DeferredScore: a one-mask launch of the multi-mask kernel
        of the engine's predicate (K2 on K1's kernel, K3b on K3a's).
        survivors: optional [T] 0/1 prescreen bitmap; zero entries are not
        scored and report 0."""
        from .multimask import MultiMaskScorer
        if self._solo is None:
            self._solo = MultiMaskScorer([self])
        tsz = packed[0].shape[0]
        surv = (np.ones((1, tsz), np.int32) if survivors is None
                else np.asarray(survivors).astype(np.int32)[None])
        return self._solo.launch_deferred(packed, surv)[0]

    def score_packed(self, packed, survivors=None):
        return self.score_packed_deferred(packed, survivors)()


class DeferredScore:
    """Handle for an in-flight exact sweep (one mask x one target block).

    The kernel launches are queued on the device when this object is
    built; calling it copies the per-variant counts to the host and
    reduces them to (best_scores int64[T], ratios f64[T], mirrored
    bool[T]). For a mask sweep use drain_deferred, which copies every
    pending buffer in one batch."""

    def __init__(self, engine, tsz: int, pending, surv_np):
        self._engine = engine
        self._tsz = tsz
        # [(dest target indices, device counts [rows, 2S], row indices)];
        # a device buffer may be shared by several DeferredScores
        self._pending = pending
        self._surv_np = surv_np
        self._result = None

    def device_outputs(self):
        return [dev for _, dev, _ in self._pending]

    def finalize(self, hosts):
        """Reduce already-copied host arrays (same order as
        device_outputs()) to the scoring triple."""
        if self._result is not None:
            return self._result
        eng = self._engine
        n = len(eng.shifts)
        out = np.zeros((self._tsz, 2 * n), dtype=np.int64)
        for (dest, _, rows), host in zip(self._pending, hosts):
            out[dest] = np.asarray(host)[rows]
        if self._surv_np is not None:
            # non-survivor rows report 0
            out = out * self._surv_np.astype(np.int64)[:, None]
        direct = out[:, :n].max(axis=1)
        if eng.mirror_query:
            mirror = out[:, n:].max(axis=1)
            best = np.maximum(direct, mirror)
            mirrored = mirror > direct  # strict: ties stay direct
        else:
            best = direct
            mirrored = np.zeros_like(direct, dtype=bool)
        if eng.tiles.query_size == 0:
            z = np.zeros_like(best)
            self._result = (z, np.zeros_like(best, dtype=np.float64),
                            mirrored)
        else:
            ratios = best.astype(np.float64) / float(eng.tiles.query_size)
            self._result = (best.astype(np.int64), ratios, mirrored)
        return self._result

    def __call__(self):
        if self._result is None:
            drain_deferred([self])
        return self._result


def _to_host(tensors):
    """One batched copy per device: the flattened buffers of a device are
    concatenated on it and copied to the host together."""
    by_dev = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    hosts = [None] * len(tensors)
    for idxs in by_dev.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs]).cpu().numpy()
        off = 0
        for i in idxs:
            n = tensors[i].numel()
            hosts[i] = flat[off:off + n].reshape(tuple(tensors[i].shape))
            off += n
    return hosts


def drain_deferred(deferreds):
    """Drain many DeferredScores with one batched copy per device;
    buffers shared by several handles are copied once."""
    flat, seen, spans = [], {}, []
    for d in deferreds:
        outs = d.device_outputs() if d._result is None else []
        ids = []
        for o in outs:
            key = id(o)
            if key not in seen:
                seen[key] = len(flat)
                flat.append(o)
            ids.append(seen[key])
        spans.append(ids)
    hosts = _to_host(flat) if flat else []
    return [d.finalize([hosts[i] for i in ids])
            if d._result is None else d._result
            for d, ids in zip(deferreds, spans)]
