"""ga.plane_hit_pct: the plane cache's lookups that found a target's
planes: 100 x ga.planes.hits / (hits + misses), the program's counters
over the traced window."""

from cdsbench import program


def read(rec):
    hits = program.counter(rec, "ga.planes.hits")
    misses = program.counter(rec, "ga.planes.misses")
    if hits is None or not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
