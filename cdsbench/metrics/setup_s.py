"""setup_s: seconds from the run's start to the window's (library,
ingest, warm-up job or pass, kernel builds on a checkout's first run)."""


def read(rec):
    return rec.get("setup_s")
