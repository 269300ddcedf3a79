"""peak_host_gib: the largest VmRSS of the run's process over the window,
sampled every 0.1 s, in GiB: the host memory a grid job must be given."""


def read(rec):
    peak = rec.get("peak_rss_bytes")
    return peak / 2 ** 30 if peak else None
