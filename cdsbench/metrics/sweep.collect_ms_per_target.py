"""sweep.collect_ms_per_target: the sweep's collect (the program's
`sweep.collect` spans: the wait for each partition's results and their
reduction to scores and mirrored flags, or their unpacking where the card
reduced them), milliseconds per target swept."""

from cdsbench import program


def read(rec):
    ivs, n = program.intervals(rec, "sweep.collect"), rec.get("targets")
    return 1e3 * program.total_s(ivs) / n if ivs and n else None
