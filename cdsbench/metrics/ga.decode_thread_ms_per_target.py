"""ga.decode_thread_ms_per_target: the decode pool's threads' time per
target decoded: the program's `ga.decode` spans summed over its threads,
milliseconds per target built (ga.planes.misses). Over
ga.decode_ms_per_target, the pool's wall time per target, it is decode's
effective thread count."""

from cdsbench import program


def read(rec):
    ivs = program.intervals(rec, "ga.decode")
    n = program.counter(rec, "ga.planes.misses")
    return 1e3 * program.total_s(ivs) / n if ivs and n else None
