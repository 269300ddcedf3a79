"""sweep.pack_ms_per_target: the sweep's target pack (its stage seconds,
"pack"), milliseconds per target swept."""


def read(rec):
    s, n = rec["stage"].get("pack"), rec.get("targets")
    return 1e3 * s / n if s is not None and n else None
