"""ga.decode_ms_per_target: gradientScores' target decode (its closing
log, "decode"), milliseconds per distinct target of the window's jobs
(all cold; counted from the traffic)."""


def read(rec):
    s, n = rec.get("decode_s"), rec.get("cold_targets")
    return 1e3 * s / n if s is not None and n else None
