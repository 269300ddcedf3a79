"""Host helpers of the packed-word scorer, without JAX.

Copies of the host half of `colormipsearch_tpu/cds/pixel_kernel.py`
(:49-107, :251-277): the boundary constants, the zTolerance encoding,
the per-pixel word packer and the query-plane preparation. The dense
XLA engine of that module (`pixel_match_packed`, `pack_targets`) is not
part of this package. `tests/test_torch_host_copies.py` pins every
function here equal to the reference.

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
from typing import Optional

import numpy as np

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
