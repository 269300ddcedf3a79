"""The packed-word scorer's host helpers and the dense engine.

Counterpart of `colormipsearch_tpu/cds/pixel_kernel.py`:
- copies of its host half (:49-107, :251-277): the boundary constants,
  the zTolerance encoding, the per-pixel word packer and the query-plane
  preparation, pinned equal to the reference by
  `tests/test_torch_host_copies.py`;
- the dense engine (:145-317): `pack_targets`, `pixel_match_packed` and
  `PixelMatchEngine`, which score every pixel of a [B] query block
  against a [T] target block for every shift. The JAX engine is XLA, no
  Pallas kernel, so this one is eager torch ops over the word predicate
  of `pixel_active.py` (`_match_unpacked` with `word_triples`; one form
  equal to both of the reference's forms, the fused one for zt9 <=
  54,000,000 and the general one above). It is the independent
  cross-check of the two-phase path and runs `--engine dense`. Targets
  are scored in chunks so that no [B, T, H, W] intermediate exceeds
  DENSE_CHUNK_ELEMS elements; `tests/test_torch_dense.py` pins each
  function equal to the JAX one.

Word layout (bit 0 = LSB):
  [0:8)  b  ratio denominator (max channel, >= 1)
  [8:16) a  ratio numerator (0 if either channel is 0)
  [16:19) sector 0..6
  [19]   sel: query mask-selected / target above-threshold
  [20]   cl: adjacency precondition toward sector-1 pair
  [21]   cu: adjacency precondition toward sector+1 pair
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .oracle import shift_ring_offsets

# most elements of a [B, T_chunk, H, W] intermediate of the dense engine
# (its int32 temporaries: 64 MB each)
DENSE_CHUNK_ELEMS = 1 << 24

# boundary constants scaled by 1e9 (AbstractColorDepthSearchAlgorithm.java:183-187)
BR_BG_9 = 354_862_745
BG_GB_9 = 996_078_431
GB_GR_9 = 505_882_353
GR_RG_9 = 996_078_431
RG_RB_9 = 505_882_353
PAIR_K9 = (BR_BG_9, BG_GB_9, GB_GR_9, GR_RG_9, RG_RB_9)  # by lo sector 1..5


def z_tolerance_to_zt9(pix_color_fluctuation: float) -> int:
    """zTolerance = pixColorFluctuation / 100 as an exact 1e-9 rational
    (ColorDepthSearchAlgorithmProviderFactory.java:55-56)."""
    return round(pix_color_fluctuation * 10_000_000)


def _i32(x, xp):
    return xp.asarray(x, dtype=xp.int32)


def pack_planes(r, g, b, sel, xp):
    """Pack per-pixel scorer state into one int32 word (see module doc).

    `xp` is `numpy` or `torch`; r, g, b are integer arrays of that
    namespace and sel a boolean one. Branch structure of
    AbstractColorDepthSearchAlgorithm.java:195-257: strict max
    classification into 6 hue sectors; ratio = second/first with 0
    sentinel when either channel is 0.
    """
    b_max = (b > r) & (b > g)
    g_max = (g > b) & (g > r)
    r_max = (r > b) & (r > g)
    s1 = b_max & (r > g)
    s2 = b_max & ~(r > g)
    s3 = g_max & (b > r)
    s4 = g_max & ~(b > r)
    s5 = r_max & (g > b)
    s6 = r_max & ~(g > b)
    sector = _i32(s1 * 1 + s2 * 2 + s3 * 3 + s4 * 4 + s5 * 5 + s6 * 6, xp)

    first = xp.where(s1 | s2, b, xp.where(s3 | s4, g, xp.where(s5 | s6, r, 0)))
    second = xp.where(s1, r, xp.where(s2, g, xp.where(s3, b, xp.where(
        s4, r, xp.where(s5, g, xp.where(s6, b, 0))))))
    a = _i32(xp.where((first != 0) & (second != 0), second, 0), xp)
    bden = _i32(xp.clip(first, 1, None), xp)

    # adjacency preconditions, resolved per own sector
    # (AbstractColorDepthSearchAlgorithm.java:260-388):
    # pair (1,2): sector-1 side < 0.44, sector-2 side < 0.54
    # pairs (2,3)/(4,5): both sides > 0.8 ; pairs (3,4)/(5,6): both < 0.7
    lt044 = a * 25 < 11 * bden
    lt054 = a * 50 < 27 * bden
    lt07 = a * 10 < 7 * bden
    gt08 = a * 5 > 4 * bden
    # cl: condition toward the (sector-1, sector) pair
    cl = ((sector == 2) & lt054) | ((sector == 3) & gt08) \
        | ((sector == 4) & lt07) | ((sector == 5) & gt08) | ((sector == 6) & lt07)
    # cu: condition toward the (sector, sector+1) pair
    cu = ((sector == 1) & lt044) | ((sector == 2) & gt08) \
        | ((sector == 3) & lt07) | ((sector == 4) & gt08) | ((sector == 5) & lt07)

    word = (bden | (a << 8) | (sector << 16)
            | (_i32(sel, xp) << 19)
            | (_i32(cl, xp) << 20)
            | (_i32(cu, xp) << 21))
    return _i32(word, xp)


@dataclass
class QueryPlanes:
    """Host-prepared packed query planes for one mask."""
    words: np.ndarray  # int32 [H, W]
    query_size: int
    height: int
    width: int


def query_rgb(query) -> np.ndarray:
    """int32 [H, W, 3] channels of a decoded RGB image
    (`imageproc.io.Image`) or of its [H, W, 3] uint8
    pixel array."""
    if hasattr(query, "rgb_i32"):
        return query.rgb_i32()
    rgb = np.asarray(query)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"expected an [H, W, 3] uint8 array, got "
                         f"{rgb.dtype} {rgb.shape}")
    return rgb.astype(np.int32)


def prepare_query_planes(query, query_threshold: int,
                         excluded: Optional[np.ndarray] = None) -> QueryPlanes:
    """Host-side query prep (getMaskPosArray dense analogue,
    AbstractColorDepthSearchAlgorithm.java:96-126). Uses the native
    mipops packer when available (parity asserted in the reference's
    tests). `query` as in `query_rgb`."""
    from ..native.mipops import pack_planes_native
    rgb = query_rgb(query)
    qsel = (rgb > query_threshold).any(axis=2)
    if excluded is not None:
        qsel = qsel & ~excluded
    words = pack_planes_native(rgb.astype(np.uint8), query_threshold,
                               excluded)
    if words is None:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        words = pack_planes(r, g, b, qsel, np)
    h, w = rgb.shape[:2]
    return QueryPlanes(words=words, query_size=int(qsel.sum()),
                       height=h, width=w)


# ---- the dense engine ---------------------------------------------------------

def _shift_list(shifts) -> list:
    """(dx, dy) int pairs of an [S, 2] array, list or tensor."""
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.cpu().numpy()
    return [(int(dx), int(dy))
            for dx, dy in np.asarray(shifts).reshape(-1, 2)]


def pixel_match_packed(q_words: torch.Tensor, t_padded: torch.Tensor,
                       t_padded_flipped: torch.Tensor, shifts, zt9: int,
                       mirror: bool,
                       max_elems: int = DENSE_CHUNK_ELEMS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores for a query block against a target block, on the tensors'
    device.

    Args:
      q_words: [B, H, W] int32 packed query planes
      t_padded: [T, H+2p, W+2p] int32 packed target planes (padded with
        word 1, which never matches)
      t_padded_flipped: same, flipped in x (pass t_padded when mirror is
        off)
      shifts: [S, 2] (dx, dy) shift offsets, each within the pad
      returns (best [B, T] int32, mirrored [B, T] bool): the max over
      shifts of the direct counts, and of the flipped ones when mirror is
      on; mirrored where the flipped max is strictly greater.

    The reference slices with lax.dynamic_slice, which clamps its start;
    a torch slice does not, so every shift must lie within the pad."""
    from .pixel_active import _match_unpacked, _unpack, word_triples
    bsz, h, w = q_words.shape
    tsz = t_padded.shape[0]
    pad_h = t_padded.shape[1] - h
    pad_w = t_padded.shape[2] - w
    if pad_h != pad_w or pad_w % 2:
        raise ValueError("symmetric padding expected")
    pad = pad_w // 2
    shifts = _shift_list(shifts)
    if any(abs(dx) > pad or abs(dy) > pad for dx, dy in shifts):
        raise ValueError(f"shifts {shifts} exceed the pad {pad}")
    triples = word_triples(zt9)
    q = _unpack(q_words[:, None])  # [B, 1, H, W] fields
    best_d = torch.zeros((bsz, tsz), dtype=torch.int32, device=q_words.device)
    best_m = torch.zeros_like(best_d)
    chunk = max(1, max_elems // max(1, bsz * h * w))

    def variant_scores(plane, t0, t1, dx, dy):
        sl = plane[t0:t1, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        return _match_unpacked(q, _unpack(sl[None]), triples).sum(
            dim=(2, 3), dtype=torch.int32)  # [B, t1 - t0]

    for t0 in range(0, tsz, chunk):
        t1 = min(t0 + chunk, tsz)
        for dx, dy in shifts:
            best_d[:, t0:t1] = torch.maximum(
                best_d[:, t0:t1], variant_scores(t_padded, t0, t1, dx, dy))
            if mirror:
                best_m[:, t0:t1] = torch.maximum(
                    best_m[:, t0:t1],
                    variant_scores(t_padded_flipped, t0, t1, dx, dy))
    if not mirror:
        return best_d, torch.zeros_like(best_d, dtype=torch.bool)
    return torch.maximum(best_d, best_m), best_m > best_d


def target_words(t_rgb_u8: torch.Tensor, target_threshold: int
                 ) -> torch.Tensor:
    """int32 [T, H, W] words of a u8 RGB target batch [T, H, W, 3], on its
    device: sel is set where any channel is above the threshold."""
    r = t_rgb_u8[..., 0].to(torch.int32)
    g = t_rgb_u8[..., 1].to(torch.int32)
    b = t_rgb_u8[..., 2].to(torch.int32)
    above = ((r > target_threshold) | (g > target_threshold)
             | (b > target_threshold))
    return pack_planes(r, g, b, above, torch)


def pack_targets(t_rgb_u8, target_threshold: int, pad: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a u8 RGB target batch [T, H, W, 3] (a tensor, on its device,
    or a NumPy array, on the CPU) into the padded plane and its x-flip:
    the flip of the PADDED plane, as the reference's padded[:, :, ::-1]
    (torch has no negative-step slice)."""
    words = target_words(torch.as_tensor(t_rgb_u8), target_threshold)
    # b=1, sel=0: never matches
    padded = torch.nn.functional.pad(words, (pad, pad, pad, pad), value=1)
    return padded, torch.flip(padded, dims=(2,))


class PixelMatchEngine:
    """One query against target batches on an explicit device.

    Mirrors ColorMIPSearch + PixelMatchColorDepthSearchAlgorithm for a
    single mask; for multi-mask blocked sweeps use parallel.sweep."""

    def __init__(self, query, query_threshold: int, mirror_query: bool,
                 target_threshold: int, pix_color_fluctuation: float,
                 xy_shift: int, excluded: Optional[np.ndarray] = None):
        self.planes = prepare_query_planes(query, query_threshold, excluded)
        self.mirror_query = mirror_query
        self.target_threshold = target_threshold
        self.zt9 = z_tolerance_to_zt9(pix_color_fluctuation)
        self.xy_shift = xy_shift
        self.shifts = np.asarray(shift_ring_offsets(xy_shift), dtype=np.int32)
        self.pad = max(xy_shift, 1)

    def prepare_targets(self, targets_u8: np.ndarray, device):
        """Pack and pad a [T, H, W, 3] uint8 target batch on `device`;
        reusable across queries."""
        t = torch.from_numpy(np.ascontiguousarray(targets_u8)).to(device)
        return pack_targets(t, self.target_threshold, self.pad)

    def score_packed(self, packed_targets
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scores int32 [T], ratios f64 [T], mirrored bool [T])."""
        t_padded, t_flipped = packed_targets
        q = torch.from_numpy(self.planes.words).to(t_padded.device)[None]
        best, mirrored = pixel_match_packed(
            q, t_padded, t_flipped, self.shifts, zt9=self.zt9,
            mirror=self.mirror_query)
        best = best[0].cpu().numpy()
        mirrored = mirrored[0].cpu().numpy()
        if self.planes.query_size == 0:
            best = np.zeros_like(best)
            return best, np.zeros_like(best, dtype=np.float64), mirrored
        ratios = best.astype(np.float64) / float(self.planes.query_size)
        return best, ratios, mirrored

    def score_batch(self, targets_u8: np.ndarray, device):
        """targets_u8: [T, H, W, 3] uint8, scored on `device`. Returns
        (scores, ratios, mirrored)."""
        return self.score_packed(self.prepare_targets(targets_u8, device))
