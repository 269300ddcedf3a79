"""cds.prep_ms_per_mask: colorDepthSearch's mask engine prep (its
"prepared N mask engines in" log), milliseconds per mask searched."""


def read(rec):
    s, n = rec.get("prep_s"), rec.get("masks")
    return 1e3 * s / n if s is not None and n else None
