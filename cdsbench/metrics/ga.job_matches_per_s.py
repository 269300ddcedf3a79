"""ga.job_matches_per_s: every match given gradient scores in the
window's completed cold jobs over the window's whole time (host clock).
The job cell's rate, per layer: it spreads past any bound allowed
end to end, since the host's own speed moves it."""


def read(rec):
    if not rec.get("matches") or not rec.get("window_s"):
        return None
    return rec["matches"] / rec["window_s"]
