"""sweep.host_wait_pct: the share of the traced window in which the
thread that runs the sweep waits on a device-to-host copy: 100 x the
union of the program's `sweep.wait` spans on that thread (the bounds,
the live tiles, the drain) over the window."""

from cdsbench import program


def read(rec):
    if not program.seen(rec, "sweep.part") or not rec.get("window_s"):
        return None
    waits = program.intervals(rec, "sweep.wait", calling_thread=True)
    return 100.0 * program.union_s(waits) / rec["window_s"]
