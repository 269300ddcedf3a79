"""ga.planes_ms_per_target: gradientScores' target plane builds (its
closing log, "plane builds"), milliseconds per distinct target of the
window's jobs."""


def read(rec):
    s, n = rec.get("planes_s"), rec.get("cold_targets")
    return 1e3 * s / n if s is not None and n else None
