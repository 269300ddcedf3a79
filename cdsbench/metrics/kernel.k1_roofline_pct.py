"""kernel.k1_roofline_pct: the exact kernel K1's share of its roofline:
the least time of the evaluations that the surviving pairs need
(cdsbench/roofline/work.py, from the inputs) over K1's device time in the
traced window."""

from cdsbench import harness
from cdsbench.roofline import work


def read(rec):
    n = rec.get("k1_evaluations")
    t = harness.kernel_seconds(rec.get("trace", {}), "multimask_ratio")
    return 100.0 * work.k1_seconds(n) / t if n and t else None
