"""Active-tile pixel-match engine for one mask, in PyTorch.

Counterpart of `colormipsearch_tpu/cds/pixel_pallas.py` (:323-383 query
tiles, :702-1059 engine and deferred results). A neuron mask occupies a
few percent of the frame, so the exact scorer touches only the mask's
ACTIVE 8x128 tiles. This module holds:

- the host query tables (`ActiveTiles`, `build_active_tiles`): the
  mask's active tiles, their window origins and the ratio-predicate
  compare planes (`ratio_bounds.query_ratio_planes`);
- target pack and pad as torch ops on an explicit device: the host
  sparse pack of the reference (`native.mipops.sparse_pack_block`) then
  a scatter with fill word 1, or a dense pack for full blocks; the ring
  pad and the x-flip of the raw plane;
- `ActiveTilePixelEngine.score_packed_deferred`, a one-mask launch of
  the exact multi-mask kernel (`cds/multimask.py`), and the deferred
  result handles drained with one batched copy to the host.

Left out, as workarounds for the TPU: the 64-target block placement
(`DEVICE_BLOCK`, `PACK_SUPER`) and the K=128/768 tile-count buckets.
Here a mask's tables hold exactly its active tiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from colormipsearch_tpu.cds.oracle import shift_ring_offsets

from .pixel_kernel import (QueryPlanes, pack_planes, prepare_query_planes,
                           z_tolerance_to_zt9)
from .ratio_bounds import query_ratio_planes

TILE_H = 8
TILE_W = 128
NV_PAD = 32  # most variants (2 * |shifts|) an engine may have, as the reference


@dataclass
class ActiveTiles:
    """Host-prepared active-tile decomposition of one query.

    K = n_active: one entry per tile holding a selected query pixel."""
    coords: np.ndarray    # int32 [K, 2]: tile origin (row, col) in the raw frame
    n_active: int
    query_size: int
    height: int
    width: int
    q_cmp: np.ndarray     # int32 [K, TILE_H, TILE_W] packed compare constants
    q_f32: np.ndarray     # f32 [K, 4, TILE_H, TILE_W]: L, U, Cup, Cdn

    @classmethod
    def from_numpy(cls, coords, n_active: int, q_cmp, q_f32,
                   query_size: int, height: int, width: int
                   ) -> "ActiveTiles":
        """Tables from arrays in the reference's layout (its K-bucket
        padding and the n_active column of `coords` are dropped)."""
        k = int(n_active)
        return cls(
            coords=np.ascontiguousarray(np.asarray(coords)[:k, :2],
                                        dtype=np.int32),
            n_active=k, query_size=int(query_size), height=int(height),
            width=int(width),
            q_cmp=np.ascontiguousarray(np.asarray(q_cmp)[:k], dtype=np.int32),
            q_f32=np.ascontiguousarray(np.asarray(q_f32)[:k],
                                       dtype=np.float32))


def build_active_tiles(planes: QueryPlanes, zt9: int) -> ActiveTiles:
    """Decompose packed query planes into active 8x128 tiles.

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
    q_cmp, q_f32 = query_ratio_planes(tiles[idx], zt9)
    return ActiveTiles(
        coords=coords.reshape(-1, 2), n_active=len(idx),
        query_size=planes.query_size, height=h, width=w,
        q_cmp=np.ascontiguousarray(q_cmp, dtype=np.int32),
        q_f32=np.ascontiguousarray(q_f32.transpose(1, 0, 2, 3),
                                   dtype=np.float32))


class ActiveTilePixelEngine:
    """Active-tile pixel-match scorer for one query (mask).

    Same scoring semantics as the reference's ActiveTilePixelEngine;
    targets are packed with this engine's prepare_targets (tile-aligned
    padded frame) on the device the caller names."""

    def __init__(self, query, query_threshold: int, mirror_query: bool,
                 target_threshold: int, pix_color_fluctuation: float,
                 xy_shift: int, excluded: Optional[np.ndarray] = None):
        """query: a decoded RGB image or its [H, W, 3] uint8 pixels."""
        planes = prepare_query_planes(query, query_threshold, excluded)
        zt9 = z_tolerance_to_zt9(pix_color_fluctuation)
        self._setup(build_active_tiles(planes, zt9), mirror_query,
                    target_threshold, zt9, xy_shift)
        self.planes = planes

    @classmethod
    def from_tiles(cls, tiles: ActiveTiles, mirror_query: bool,
                   target_threshold: int, zt9: int, xy_shift: int
                   ) -> "ActiveTilePixelEngine":
        """Engine over query tables built elsewhere (ActiveTiles.from_numpy
        carries the reference engine's exact state across)."""
        eng = cls.__new__(cls)
        eng._setup(tiles, mirror_query, target_threshold, zt9, xy_shift)
        eng.planes = None
        return eng

    def _setup(self, tiles, mirror_query, target_threshold, zt9, xy_shift):
        self.tiles = tiles
        self.mirror_query = bool(mirror_query)
        self.target_threshold = int(target_threshold)
        self.zt9 = int(zt9)
        self.xy_shift = int(xy_shift)
        self.shifts = tuple(shift_ring_offsets(self.xy_shift))
        if 2 * len(self.shifts) > NV_PAD:
            raise ValueError(f"xyShift {xy_shift}: {2 * len(self.shifts)} "
                             f"variants exceed {NV_PAD}")
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
        """Queue the exact sweep of this mask over one packed block (a
        one-mask launch of the multi-mask kernel) and return a
        DeferredScore. survivors: optional [T] 0/1 prescreen bitmap;
        zero entries are not scored and report 0."""
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
