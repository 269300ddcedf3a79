"""The constant split of the exact int32 ratio compare.

Copy of `c9_split` from `colormipsearch_tpu/cds/exact_ratio.py` (:41-49),
which also proves the staging bounds. A ratio u / v is compared with
C9 / 10^9 as 10^6 * (u*10^3 - Q*v) <= R * v, R = Rhi*64 + Rlo, so that
every intermediate stays in int32 (`pixel_active._leq_geq_chain` and the
word kernel). `tests/test_torch_host_copies.py` pins it equal to the
reference.
"""

from __future__ import annotations

from typing import Tuple


def c9_split(c9: int) -> Tuple[int, int, int]:
    """Split a 10^-9-scaled constant for ratio_leq_c9. Returns (Q, Rhi, Rlo)."""
    if c9 < 0:
        raise ValueError("negative thresholds not supported")
    q, r = divmod(int(c9), 10 ** 6)
    if q > 3000:
        raise ValueError(f"C9 too large for int32 staging: {c9}")
    r_hi, r_lo = divmod(r, 64)
    return q, r_hi, r_lo
