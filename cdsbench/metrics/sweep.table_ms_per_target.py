"""sweep.table_ms_per_target: the host's exact-launch tables
(`MultiMaskScorer.build_table`, the program's `sweep.table` spans),
milliseconds per target swept."""

from cdsbench import program


def read(rec):
    ivs, n = program.intervals(rec, "sweep.table"), rec.get("targets")
    return 1e3 * program.total_s(ivs) / n if ivs and n else None
