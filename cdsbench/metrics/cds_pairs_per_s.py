"""cds_pairs_per_s: every (mask, target) pair of the window's completed
jobs or passes over the window's whole time (host clock)."""


def read(rec):
    if not rec.get("pairs") or not rec.get("window_s"):
        return None
    return rec["pairs"] / rec["window_s"]
