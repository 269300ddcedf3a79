"""cds.features_ms_per_mask: colorDepthSearch's prescreen query features
(its `stage times` log, "features"), milliseconds per mask searched."""


def read(rec):
    s, n = rec["stage"].get("features"), rec.get("masks")
    return 1e3 * s / n if s is not None and n else None
