"""kernel.g2_roofline_pct: the dilation G2's share of its roofline over
the masks' query dilations (r = 60, 20): their bytes
(cdsbench/roofline/work.py) at the card's memory rate over G2's device
time in the traced window."""

from cdsbench import harness
from cdsbench.roofline import work


def read(rec):
    b = rec.get("g2_bytes")
    t = harness.kernel_seconds(rec.get("trace", {}), "ring_kernel",
                               "combine_kernel", "dilate_kernel")
    return 100.0 * b / work.PEAK_BYTES / t if b and t else None
