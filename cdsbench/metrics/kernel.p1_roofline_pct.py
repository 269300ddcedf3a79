"""kernel.p1_roofline_pct: the sweep's target pack P1 (`count_kernel` and
`words_kernel`, colormipsearch_torch/csrc/target_pack.cu) against its
roofline: the least time of the bytes that the window's packs need
(cdsbench/roofline/work.py, from the frames' shape) over the two
kernels' device time in the traced window."""

import re

from cdsbench.roofline import work

# the kernel's own name, not one that ends in it (K3a's
# multimask_words_kernel)
P1 = re.compile(r"(?<![A-Za-z0-9_])(count|words)_kernel\b")


def read(rec):
    n = rec.get("p1_bytes")
    t = sum(s for op, s in rec.get("trace", {}).get("device_ops", {}).items()
            if P1.search(op))
    return 100.0 * work.bytes_seconds(n) / t if n and t else None
