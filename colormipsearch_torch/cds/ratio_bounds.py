"""Exact f32 decision bounds for the ratio-interval predicate.

A copy of `colormipsearch_tpu/cds/ratio_bounds.py` that loads no JAX
(the reference reaches `PAIR_K9` through the JAX module
`cds/pixel_kernel.py`). `tests/test_torch_host_copies.py` pins it equal
to the reference.

The hue-gap predicate compares target ratios r2 = a2/b2 against
query-derived rational thresholds (exact_ratio.py staging,
AbstractColorDepthSearchAlgorithm.java:157-390):

  same sector:    |r2 - r1| <= zt9/1e9          (r1 = a1/b1)
  adjacent pair:  r1 + r2  <=/>=  C9/1e9        (C9 = 2*K9[lo] -+ zt9)

Every such test is an interval/halfline membership of r2 in a set whose
boundary V is a rational with denominator 1e9*b1 — a QUERY-side
constant. The achievable r2 values form a finite set of rationals with
denominator <= 255, whose minimum spacing is 1/(255*254) ~= 1.54e-5.
This module places, per query pixel, an f32 threshold STRICTLY BETWEEN
the achievable rationals straddling V (respecting the inclusive
semantics of the exact comparison), so that on device

    r2f <op> Vf      with r2f = fl(a2 * rcp(b2)), |r2f - r2| <= ~4e-7

decides the exact rational comparison bit-identically: the placed
threshold is >= half-spacing (7.7e-6) away from every achievable
rational, a ~20x margin over the device division error. a2 == 0 pixels
(excluded from same-sector matches, but legal in adjacent matches with
r2 = 0) are encoded as the sentinel r2f = -1; all placements below keep
the sentinel on the correct side of every test.

The placement is computed once per zt9 as (a1, b1)-indexed tables
(int64 numpy over the 255 achievable denominators) and gathered into
per-pixel query planes; the device predicate then needs only f32
compares, equality checks, and boolean algebra — no int32 multiplies
(the CUDA kernel in `csrc/multimask_ratio.cu` evaluates exactly this).
"""

from __future__ import annotations

import functools

import numpy as np

from .pixel_kernel import PAIR_K9  # JAX-free copy

# achievable target ratios: a2/b2 with b2 in [1, 255] (bden >= 1 by
# packing). a2 <= 255; using the superset a in [0, 256] only widens the
# candidate set (placement stays strictly between two members, so a
# superset is always safe).
_BS = np.arange(1, 256, dtype=np.int64)

# sentinel threshold values (see placement rules in _place_*):
NEVER_LEQ = np.float32(-2.0)   # r2f <= NEVER_LEQ is false for all r2f >= -1
ALWAYS_LEQ = np.float32(3.0)   # r2f <= ALWAYS_LEQ is true for all r2f <= 1.1
NEVER_GEQ = np.float32(3.0)    # r2f >= NEVER_GEQ is false (incl sentinel)
SENT_GEQ = np.float32(-0.5)    # between the -1 sentinel and all real r2


def _mid_f32(r_lo: np.ndarray, r_hi: np.ndarray) -> np.ndarray:
    """f32 value strictly between r_lo < r_hi (f64 rationals >= 1.5e-5
    apart; f32 rounding of the midpoint moves it < 1e-7)."""
    r_hi_c = np.minimum(r_hi, r_lo + 0.5)
    return ((r_lo + r_hi_c) * 0.5).astype(np.float32)


def _straddle(num: np.ndarray, den: np.ndarray, strict: bool):
    """Achievable rationals straddling V = num/den (elementwise int64).

    strict=False: r_lo = max{a/b <= V}, r_hi = min{a/b > V}
    strict=True:  r_lo = max{a/b <  V}, r_hi = min{a/b >= V}
    Returns (r_lo f64 with -inf where empty, r_hi f64).
    """
    n = num.shape[0]
    r_lo = np.full(n, -np.inf)
    r_hi = np.full(n, np.inf)
    chunk = 4096
    for i in range(0, n, chunk):
        nu = num[i:i + chunk, None]
        de = den[i:i + chunk, None]
        prod = nu * _BS[None, :]
        if strict:
            amax = -(-prod // de) - 1      # ceil(prod/de) - 1: max a < V
        else:
            amax = prod // de              # floor: max a <= V
        bsf = _BS[None, :].astype(np.float64)
        # a is capped at 256: when amax >= 256 every achievable a/b of
        # this denominator is on the low side (no candidate above V)
        capped = amax >= 256
        amax = np.clip(amax, -1, 256)
        lo_vals = np.where(amax >= 0, amax / bsf, -np.inf)
        hi_vals = np.where(capped, np.inf, (amax + 1) / bsf)
        r_lo[i:i + chunk] = lo_vals.max(axis=1)
        r_hi[i:i + chunk] = hi_vals.min(axis=1)
    return r_lo, r_hi


def _place_leq(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """f32 T with (r2f <= T) <=> (r2 <= num/den), honoring the a2==0
    sentinel (-1): r2=0 is a legal value for adjacent tests, so T < -1
    exactly when V < 0 (then no r2 >= 0 qualifies and the sentinel must
    fail too)."""
    r_lo, r_hi = _straddle(num, den, strict=False)
    t = np.where(np.isneginf(r_lo), np.float64(NEVER_LEQ),
                 _mid_f32(np.where(np.isneginf(r_lo), 0.0, r_lo), r_hi))
    return t.astype(np.float32)


def _place_geq_adj(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """f32 T with NOT(r2f <= T) <=> (r2 >= num/den) for adjacent tests
    (r2 = 0 legal, sentinel -1 must agree with r2 = 0): V <= 0 =>
    always-true => T = NEVER_LEQ (-2, below the sentinel)."""
    r_lo, r_hi = _straddle(num, den, strict=True)
    # V > 0 guarantees r_lo >= 0 exists (a=0 < V); V > max achievable
    # leaves r_hi = +inf -> never true -> _mid_f32 caps at r_lo + 0.5,
    # above every real r2f near r_lo and below nothing that matters
    safe_lo = np.where(np.isneginf(r_lo), 0.0, r_lo)
    t = _mid_f32(safe_lo, r_hi)
    return np.where(num <= 0, NEVER_LEQ, t).astype(np.float32)


def _place_geq_same(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """f32 T with (r2f >= T) <=> (r2 >= num/den) AND the -1 sentinel
    failing (same-sector matches require a2 > 0): V <= 0 => T = -0.5
    (all real r2 >= 0 pass, sentinel fails)."""
    r_lo, r_hi = _straddle(num, den, strict=True)
    nonpos = num <= 0
    t = np.where(nonpos, np.float64(SENT_GEQ),
                 _mid_f32(np.where(np.isneginf(r_lo), 0.0, r_lo), r_hi))
    return t.astype(np.float32)


@functools.lru_cache(maxsize=8)
def bounds_tables(zt9: int):
    """(a1, b1)-indexed f32 threshold tables for one zTolerance.

    Returns dict with:
      L  [256,256]  same-sector lower bound  (r2f >= L placement)
      U  [256,256]  same-sector upper bound  (r2f <= U placement)
      V  [5,256,256] adjacent-pair threshold by lo sector 1..5
                     (even lo: geq placement for C9=2K-zt9, tested as
                      NOT(r2f <= V); odd lo: leq placement for 2K+zt9)
    """
    a1 = np.repeat(np.arange(256, dtype=np.int64), 256)
    b1 = np.tile(np.arange(256, dtype=np.int64), 256)
    b1s = np.maximum(b1, 1)            # b1=0 never occurs for valid pixels
    den = b1s * 10 ** 9
    e9 = 10 ** 9

    tab = {}
    # same sector: L = (a1*1e9 - zt9*b1) / (1e9*b1), U = (a1*1e9 + zt9*b1)
    tab["L"] = _place_geq_same(a1 * e9 - zt9 * b1s, den).reshape(256, 256)
    tab["U"] = _place_leq(a1 * e9 + zt9 * b1s, den).reshape(256, 256)
    v = np.zeros((5, 256, 256), np.float32)
    for lo in range(1, 6):
        k9 = PAIR_K9[lo - 1]
        if lo % 2 == 0:   # geq (2k - zt9)/1e9 - r1
            c9 = 2 * k9 - zt9
            v[lo - 1] = _place_geq_adj(c9 * b1s - a1 * e9,
                                       den).reshape(256, 256)
        else:             # leq (2k + zt9)/1e9 - r1
            c9 = 2 * k9 + zt9
            v[lo - 1] = _place_leq(c9 * b1s - a1 * e9, den).reshape(256, 256)
    tab["V"] = v
    return tab


# q_cmp bit layout (see pixel_pallas ratio predicate):
#   [0:5)   same compare constant: s1|8, sentinel 31
#   [5:10)  up compare constant: (s1+1)|8|16 masked vs f&0b011111, sent 31
#   [10:16) down compare constant: (s1-1)|8|32 vs f&0b101111, sentinel 63
#   [16]    gup: up-pair direction is geq (lo = s1 even)
#   [17]    gdn: down-pair direction is geq (lo = s1-1 even)
_SAME_SENT = 31
_UP_SENT = 31
_DN_SENT = 63


def query_ratio_planes(words: np.ndarray, zt9: int):
    """Per-pixel ratio-predicate query planes from a packed word plane.

    Returns (q_cmp int32 [H,W], q_f32 float32 [4,H,W]) with
    q_f32 = [L, U, Cup, Cdn]. All validity conditions (sel, sector
    bounds, a1>0 for same, qcu/qcl adjacency preconditions) are folded
    into sentinels here, so the kernel needs no query-side flag logic.
    """
    tabs = bounds_tables(zt9)
    w = np.asarray(words)
    b1 = w & 0xFF
    a1 = (w >> 8) & 0xFF
    s1 = (w >> 16) & 0x7
    sel = (w >> 19) & 1
    qcl = (w >> 20) & 1
    qcu = (w >> 21) & 1

    valid_same = (sel > 0) & (s1 >= 1) & (a1 >= 1)
    same_cmp = np.where(valid_same, s1 + 8, _SAME_SENT)
    valid_up = (sel > 0) & (qcu > 0) & (s1 >= 1) & (s1 <= 5)
    up_cmp = np.where(valid_up, s1 + 25, _UP_SENT)      # (s1+1)|8|16
    valid_dn = (sel > 0) & (qcl > 0) & (s1 >= 2) & (s1 <= 6)
    dn_cmp = np.where(valid_dn, s1 + 39, _DN_SENT)      # (s1-1)|8|32
    gup = ((s1 % 2) == 0).astype(np.int32)              # lo = s1
    gdn = ((s1 % 2) == 1).astype(np.int32)              # lo = s1 - 1
    q_cmp = (same_cmp | (up_cmp << 5) | (dn_cmp << 10)
             | (gup << 16) | (gdn << 17)).astype(np.int32)

    lf = np.where(valid_same, tabs["L"][a1, b1], NEVER_GEQ)
    uf = np.where(valid_same, tabs["U"][a1, b1], NEVER_LEQ)
    # adjacent thresholds; value unused when the cmp constant is a
    # sentinel, so clipped indices are harmless
    cup = tabs["V"][np.clip(s1 - 1, 0, 4), a1, b1]
    cdn = tabs["V"][np.clip(s1 - 2, 0, 4), a1, b1]
    q_f32 = np.stack([lf, uf, cup, cdn]).astype(np.float32)
    return q_cmp, q_f32
