"""device.idle_pct.cds: the share of the traced window in which no
kernel, copy or set ran on the card (torch.profiler), colorDepthSearch
cells."""


def read(rec):
    tr = rec.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None
