"""kernel.g1_roofline_pct: the shape scorer G1's share of its roofline:
the bytes of its calls in the window (cdsbench/roofline/work.py, from the
masks' rows and the batches) at the card's memory rate over G1's device
time in the traced window."""

from cdsbench import harness
from cdsbench.roofline import work


def read(rec):
    b = rec.get("g1_bytes")
    t = harness.kernel_seconds(rec.get("trace", {}), "shape_rows")
    return 100.0 * b / work.PEAK_BYTES / t if b and t else None
