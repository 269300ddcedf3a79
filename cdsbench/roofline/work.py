"""The least work of the kernels, counted from the benchmark's inputs, and
the card's peaks.

Frozen copies of `chip_smoke.py:688` kernel_work and `:1369`
shape_bounds, recounted from the inputs: no number here is read from the
program's launch tables, tiles or plane layouts, so a redesign of a
kernel moves its time and not its yardstick.

- K1, the exact kernel: every (selected query pixel, shift variant,
  orientation) of a pair that the bound lets through, whose shifted
  pixel lies in the frame where the target has signal, is one evaluation
  that any exact implementation must make; each costs at least
  `OPS_PER_EVAL` lane operations (the ratio, three flag tests, four
  compares, two xors, two ors and the add). Bound by operations.
- G1, the shape scorer: each call reads the query's five planes (1 + 2 +
  1 + 1 B/px) and each target's three (1 + 2 + 1 + 2 B/px) over the rows
  where the query has signal or a high-expression ring, once, and writes
  four 8-byte totals per target. Bound by bytes.
- G2, the query's two dilations (r = 60, 20): each reads 3 B/px of the
  frame and writes 3 B/px, and reads the 1 B/px region mask. Bytes only:
  the operations of a circular max filter depend on how it is built.
- P1, the sweep's target pack: each raw target frame (3 B/px) read once
  and its scorer words written once, one 4-byte word a pixel (the int32
  [T, H, W] plane that the bound B1-B2 and K1 read). P1's own second
  read of the frame is not counted, so a one-pass pack reads a higher
  share. Bound by bytes.

Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s of float32 outside the
tensor cores (33.5 T lane operations/s, an FMA counted as two) and 3.35
TB/s of HBM3, at the full 700 W; the run states the card's power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.pixel import label_regions, shift_ring

PEAK_LANE_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12
OPS_PER_EVAL = 12


def variant_footprints(masks, mask_threshold: int, xy_shift: int,
                       mirror: bool, device="cpu") -> torch.Tensor:
    """float32 [B, H * W]: for each mask, at each target pixel, the number
    of (selected pixel, variant, orientation) that land there."""
    h, w, _ = masks[0].shape
    keep = ~label_regions(h, w)
    out = torch.zeros((len(masks), h * w), dtype=torch.float32,
                      device=device)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero((m > mask_threshold).any(axis=2) & keep)
        ys = torch.from_numpy(ys).to(device)
        xs = torch.from_numpy(xs).to(device)
        for mirrored in (False, True)[:1 + int(mirror)]:
            for dx, dy in shift_ring(xy_shift):
                tx, ty = xs + dx, ys + dy
                ok = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                sx = (w - 1) - tx if mirrored else tx
                idx = (ty * w + sx)[ok]
                out[i].index_add_(0, idx, torch.ones(
                    idx.shape, dtype=torch.float32, device=device))
    return out


def k1_evaluations(footprints: torch.Tensor, targets_u8: np.ndarray,
                   survivors: np.ndarray, data_threshold: int,
                   batch: int = 256) -> int:
    """The evaluations that the surviving pairs of one sweep need:
    sum over pairs with survivors[b, t] of footprint_b . signal_t."""
    dev = footprints.device
    total = 0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, len(targets_u8), batch):
            t = torch.from_numpy(np.ascontiguousarray(
                targets_u8[i:i + batch])).to(dev)
            sig = (t > data_threshold).any(dim=3).reshape(len(t), -1).to(
                torch.float32)
            n = footprints @ sig.T   # exact: integers below 2^24
            s = torch.from_numpy(survivors[:, i:i + batch]).to(dev)
            total += int((n.to(torch.float64) * s).sum().item())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return total


def k1_seconds(evaluations: int) -> float:
    """The least time of K1 for these evaluations (operations bound)."""
    return evaluations * OPS_PER_EVAL / PEAK_LANE_OPS


P1_READ_BYTES = 3    # a raw RGB pixel
P1_WORD_BYTES = 4    # a scorer word, one a pixel


def p1_bytes(n_targets: int, height: int, width: int) -> int:
    """Bytes of the pack of n_targets frames of height x width."""
    return n_targets * height * width * (P1_READ_BYTES + P1_WORD_BYTES)


def bytes_seconds(n_bytes: int) -> float:
    """The least time to move these bytes through HBM."""
    return n_bytes / PEAK_BYTES


def active_rows(query: dict) -> int:
    """Rows where the query has signal or its high-expression ring."""
    return int((query["nonzero"].any(dim=1) | query["high"].any(dim=1))
               .sum())


def g1_bytes(rows: int, width: int, n_targets: int) -> int:
    """Bytes of one G1 call over n_targets targets."""
    return rows * width * (5 + 6 * n_targets) + 32 * n_targets


def g2_query_bytes(height: int, width: int) -> int:
    """Bytes of one mask's two query dilations."""
    return 2 * (height * width * 6 + height * width)
