"""Prescreen: a provable upper bound on pixel-match scores, in PyTorch.

Counterpart of `colormipsearch_tpu/cds/prescreen.py` (:67-154 host
tables, :202-310 the count-capped bound, :443-482 bounds_from_words).
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

Every value is an integer below 2^24 (cell counts <= 128, 0/1 weights,
sums <= the query size), so the fp32 products and sums here are exact on
any device as long as no reduced-precision mode is on: the bound never
rounds below the count. `bounds_from_words` turns TF32 off for its own
products and restores the caller's setting afterwards.

Left out: the uncapped `_variant_block_bounds` (CMS_PRESCREEN_CAP=0) and
the target-feature path (`target_features`, `bounds`).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

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
    """Count-capped per-offset-max upper bounds [B, T'] (f32, integral).

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

    def bounds_from_words(self, u_matrix, t_words: torch.Tensor
                          ) -> np.ndarray:
        """Variant-consistent bounds [B, T] (numpy f32) from a query
        feature matrix (numpy or tensor [B, npos * N_BINS]) and packed
        target words on their device; one copy to the host at the end."""
        dev = t_words.device
        u = torch.as_tensor(u_matrix).to(device=dev, dtype=torch.float32)
        u3 = u.reshape(u.shape[0], -1, N_BINS)
        outs = []
        with _fp32_matmul():  # exact fp32 products
            for i in range(0, t_words.shape[0], self.FEATURE_BLOCK):
                wb = t_words[i:i + self.FEATURE_BLOCK]
                bd = _variant_block_bounds_capped(u3, wb, self.zt9,
                                                  self.offsets, self.grid_hw,
                                                  False)
                bm = _variant_block_bounds_capped(u3, wb, self.zt9,
                                                  self.offsets, self.grid_hw,
                                                  True)
                outs.append(torch.maximum(bd, bm))
        if not outs:
            return np.zeros((u3.shape[0], 0), np.float32)
        return torch.cat(outs, dim=1).cpu().numpy()
