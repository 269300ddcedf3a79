"""The plain reference of the colour-depth pixel match (colorDepthSearch).

Plain PyTorch, on whatever device the caller's tensors live. A restatement
of the reference's scalar Java loops (PixelMatchColorDepthSearchAlgorithm
.java:113-265, the hue-sector gap of AbstractColorDepthSearchAlgorithm
.java:157-390), with the exact-rational predicate that the port's
normative oracle states (`colormipsearch_tpu/cds/oracle.py:
match_exact_rational`, which equals Java's doubles except at exact
rational ties, where it counts a tie as a match). It imports nothing of
the program: it reads the benchmark's own frames.

`precision="bfloat16"` is the control: the same search with each pixel's
ratio and the colour gap in bfloat16, which breaks the configuration's
guarantee of an exact colour test. (float32 decides ratios of 8-bit
channels as the exact test does, so it is no control.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# the adjacent-sector boundary constants (AbstractColorDepthSearchAlgorithm
# .java:157-390), by lower sector 1..5
PAIR_K = (0.354862745, 0.996078431, 0.505882353, 0.996078431, 0.505882353)


def label_regions(h: int, w: int) -> np.ndarray:
    """True inside the burned-in label boxes that the search excludes
    (AbstractColorDepthMatchArgs.java:101-119): the colour scale
    (x >= w - 270, y < 90, when w > 270) and the name (x < 330, y < 100)."""
    out = np.zeros((h, w), dtype=bool)
    if w > 270:
        out[:90, w - 270:] = True
    out[:100, :330] = True
    return out


def shift_ring(xy_shift: int):
    """(dx, dy) of each shift variant: (0, 0), then for each even ring i
    up to xy_shift the 8 offsets in {-i, 0, i}^2 other than (0, 0)."""
    out = [(0, 0)]
    for i in range(2, xy_shift + 1, 2):
        out += [(x, y) for x in (-i, 0, i) for y in (-i, 0, i)
                if (x, y) != (0, 0)]
    return out


def sectors(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(sector 0..6, numerator a, denominator b) per pixel of [..., 3]:
    the hue sector by the strict channel order (1 BR, 2 BG, 3 GB, 4 GR,
    5 RG, 6 RB; 0 for ties), and its ratio second / first as a / b, a = 0
    where either channel is 0."""
    r, g, b = (rgb[..., c].to(torch.int32) for c in range(3))
    b_max = (b > r) & (b > g)
    g_max = (g > b) & (g > r)
    r_max = (r > b) & (r > g)
    z = torch.zeros_like(r)
    sec, first, second = z.clone(), z.clone(), z.clone()
    for s, sel, f, sc in ((1, b_max & (r > g), b, r),
                          (2, b_max & ~(r > g), b, g),
                          (3, g_max & (b > r), g, b),
                          (4, g_max & ~(b > r), g, r),
                          (5, r_max & (g > b), r, g),
                          (6, r_max & ~(g > b), r, b)):
        sec = torch.where(sel, s, sec)
        first = torch.where(sel, f, first)
        second = torch.where(sel, sc, second)
    a = torch.where((first != 0) & (second != 0), second, 0)
    return sec, a, torch.clamp(first, min=1)


def match_exact(s1, a1, b1, s2, a2, b2, zt9: int) -> torch.Tensor:
    """The match predicate over exact rationals (int64)."""
    p = b1 * b2
    diff = (a2 * b1 - a1 * b2).abs()
    ok = (s1 == s2) & (s1 > 0) & (a1 > 0) & (a2 > 0) \
        & (diff * 1_000_000_000 <= zt9 * p)
    up, down = s2 == s1 + 1, s1 == s2 + 1
    adj = (up | down) & (torch.minimum(s1, s2) > 0)
    lo = torch.where(up, s1, s2)
    u = a1 * b2 + a2 * b1
    for lo_s, k in zip(range(1, 6), PAIR_K):
        k9 = round(k * 1e9)
        if lo_s == 1:   # BR side below 0.44, BG side below 0.54
            cond = torch.where(s1 == 1, a1 * 25 < 11 * b1, a1 * 50 < 27 * b1) \
                & torch.where(s2 == 1, a2 * 25 < 11 * b2, a2 * 50 < 27 * b2)
        elif lo_s in (2, 4):   # both above 0.8
            cond = (a1 * 5 > 4 * b1) & (a2 * 5 > 4 * b2)
        else:                  # both below 0.7
            cond = (a1 * 10 < 7 * b1) & (a2 * 10 < 7 * b2)
        if lo_s in (2, 4):
            gap_ok = u * 1_000_000_000 >= max(2 * k9 - zt9, 0) * p
        else:
            gap_ok = u * 1_000_000_000 <= (2 * k9 + zt9) * p
        ok = ok | (adj & (lo == lo_s) & cond & gap_ok)
    return ok


def match_float(s1, a1, b1, s2, a2, b2, z_tol: float,
                dtype=torch.float32) -> torch.Tensor:
    """The reference's double formulation of the gap (the ratios, the gap
    and the tolerance), evaluated in `dtype`."""
    q1 = torch.where(a1 > 0, a1.to(dtype) / b1.to(dtype), 0.0)
    q2 = torch.where(a2 > 0, a2.to(dtype) / b2.to(dtype), 0.0)
    gap = torch.full(q1.shape, 10000.0, dtype=dtype, device=q1.device)
    gap = torch.where((s1 == s2) & (s1 > 0) & (q1 > 0) & (q2 > 0),
                      (q2 - q1).abs(), gap)
    for lo_s, k in zip(range(1, 6), PAIR_K):
        k = torch.tensor(k, dtype=dtype)
        fwd = (s1 == lo_s) & (s2 == lo_s + 1)
        bwd = (s1 == lo_s + 1) & (s2 == lo_s)
        if lo_s == 1:
            cond = (fwd & (q1 < 0.44) & (q2 < 0.54)) \
                | (bwd & (q1 < 0.54) & (q2 < 0.44))
            val = (q1 - k) + (q2 - k)
        elif lo_s in (2, 4):
            cond = (fwd | bwd) & (q1 > 0.8) & (q2 > 0.8)
            val = (k - q1) + (k - q2)
        else:
            cond = (fwd | bwd) & (q1 < 0.7) & (q2 < 0.7)
            val = (q1 - k) + (q2 - k)
        gap = torch.where(cond, val, gap)
    return gap <= torch.tensor(z_tol, dtype=dtype)


class PixelQuery:
    """One mask's selected pixels: above `mask_threshold` in any channel
    and outside the label regions."""

    def __init__(self, mask_rgb: np.ndarray, mask_threshold: int,
                 device="cpu"):
        h, w, _ = mask_rgb.shape
        sel = (mask_rgb > mask_threshold).any(axis=2) & ~label_regions(h, w)
        ys, xs = np.nonzero(sel)
        self.h, self.w = h, w
        self.size = len(ys)
        self.ys = torch.from_numpy(ys.astype(np.int64)).to(device)
        self.xs = torch.from_numpy(xs.astype(np.int64)).to(device)
        px = torch.from_numpy(mask_rgb[ys, xs]).to(device)
        self.sec, self.a, self.b = (p.to(torch.int64) for p in sectors(px))


class TargetPlanes:
    """A batch of targets' per-pixel sector, ratio and signal, flattened:
    [T, H * W] each."""

    def __init__(self, targets: torch.Tensor, data_threshold: int):
        t = targets.reshape(targets.shape[0], -1, 3)
        self.above = (t > data_threshold).any(dim=2)
        sec, a, b = sectors(t)
        self.sec, self.a, self.b = (sec.to(torch.int8), a.to(torch.int16),
                                    b.to(torch.int16))


def pixel_scores(q: PixelQuery, t: TargetPlanes, zt9: int, xy_shift: int,
                 mirror: bool, precision: str = "exact"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores int64 [T], mirrored bool [T]) of one mask against a batch:
    the most matched pixels over the shift variants, unmirrored, and
    mirrored (x -> w - 1 - x after the shift) where that is strictly
    more."""
    n_t = t.above.shape[0]
    best = [torch.zeros(n_t, dtype=torch.int64, device=q.ys.device)
            for _ in range(2)]
    if q.size == 0:
        return best[0], best[0] > 0
    for o, mirrored in enumerate((False, True)[:1 + int(mirror)]):
        for dx, dy in shift_ring(xy_shift):
            tx, ty = q.xs + dx, q.ys + dy
            valid = (tx >= 0) & (tx < q.w) & (ty >= 0) & (ty < q.h)
            sx = (q.w - 1) - tx if mirrored else tx
            idx = torch.where(valid, ty * q.w + sx, 0)
            s2, a2, b2 = (p[:, idx].to(torch.int64)
                          for p in (t.sec, t.a, t.b))
            if precision == "exact":
                ok = match_exact(q.sec, q.a, q.b, s2, a2, b2, zt9)
            else:
                ok = match_float(q.sec, q.a, q.b, s2, a2, b2, zt9 / 1e9,
                                 getattr(torch, precision))
            hits = (ok & t.above[:, idx] & valid).sum(dim=1)
            best[o] = torch.maximum(best[o], hits)
    return torch.maximum(best[0], best[1]), best[1] > best[0]


def block_scores(masks, targets_u8: np.ndarray, *, mask_threshold: int,
                 data_threshold: int, zt9: int, xy_shift: int, mirror: bool,
                 device="cpu", precision: str = "exact", batch: int = 128):
    """(scores int64 [B, T], mirrored bool [B, T], query sizes [B]) of
    mask frames against target frames, targets in batches on `device`."""
    queries = [PixelQuery(m, mask_threshold, device) for m in masks]
    scores = np.zeros((len(masks), len(targets_u8)), np.int64)
    mirrored = np.zeros(scores.shape, bool)
    for i in range(0, len(targets_u8), batch):
        tb = torch.from_numpy(np.ascontiguousarray(
            targets_u8[i:i + batch])).to(device)
        planes = TargetPlanes(tb, data_threshold)
        for bi, q in enumerate(queries):
            s, m = pixel_scores(q, planes, zt9, xy_shift, mirror, precision)
            scores[bi, i:i + len(tb)] = s.cpu().numpy()
            mirrored[bi, i:i + len(tb)] = m.cpu().numpy()
    return scores, mirrored, np.array([q.size for q in queries])


def is_match(pixels: int, query_size: int, pct_positive: float) -> bool:
    """isMatch (ColorMIPSearch.java:42-46): a stored match has pixels > 0
    and pixels / query size above pctPositivePixels / 100."""
    return pixels > 0 and pixels / max(query_size, 1) > pct_positive / 100.0
