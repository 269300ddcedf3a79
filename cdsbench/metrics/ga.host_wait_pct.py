"""ga.host_wait_pct: the share of the traced window in which the thread
that scores the masks waits on a device-to-host copy: 100 x the union of
the program's `ga.wait` spans on that thread (the query's active rows,
the row sums) over the window."""

from cdsbench import program


def read(rec):
    if not program.seen(rec, "ga.mask") or not rec.get("window_s"):
        return None
    waits = program.intervals(rec, "ga.wait", calling_thread=True)
    return 100.0 * program.union_s(waits) / rec["window_s"]
