"""ga.upload_ms_per_target: the host side of the raw frames' uploads in
the target plane builds (the program's `ga.upload` spans), milliseconds
per target built (ga.planes.misses)."""

from cdsbench import program


def read(rec):
    ivs = program.intervals(rec, "ga.upload")
    n = program.counter(rec, "ga.planes.misses")
    return 1e3 * program.total_s(ivs) / n if ivs and n else None
