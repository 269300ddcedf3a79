"""ga_matches_per_s: every match given gradient scores in the window's
completed jobs or masks over the window's whole time (host clock)."""


def read(rec):
    if not rec.get("matches") or not rec.get("window_s"):
        return None
    return rec["matches"] / rec["window_s"]
