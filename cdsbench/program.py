"""What the program recorded of a traced window, for the metric readers.

`rec["program"]` is what `colormipsearch_torch.utils.trace.drain()`
handed over after the window: "spans", each (name, start_ns, end_ns,
thread, id, parent, job) on the wall clock; "counters", what each counter
added over the window; "thread", the thread that ran the window. A run
whose program records nothing (or a run without the recorder on) has no
such record, and every function here then gives None.

The arithmetic lives here, beside the readers, and not in the program:
it is part of the yardstick.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def _record(rec: dict) -> Optional[dict]:
    got = rec.get("program")
    return got if got and got.get("spans") else None


def intervals(rec: dict, name: str, calling_thread: bool = False
              ) -> Optional[List[Tuple[int, int]]]:
    """(start_ns, end_ns) of every span of that name (on the window's
    thread only, with calling_thread); None without a record."""
    got = _record(rec)
    if got is None:
        return None
    return [(t0, t1) for n, t0, t1, thread, *_ in got["spans"]
            if n == name and (not calling_thread
                              or thread == got["thread"])]


def seen(rec: dict, name: str) -> bool:
    """Whether the record holds any span of that name."""
    return bool(intervals(rec, name))


def total_s(ivs: List[Tuple[int, int]]) -> float:
    """Their durations' sum, in seconds (overlaps count twice)."""
    return sum(t1 - t0 for t0, t1 in ivs) / 1e9


def union_s(ivs: List[Tuple[int, int]]) -> float:
    """Seconds covered by their union."""
    total, edge = 0, None
    for a, b in sorted(ivs):
        if edge is None or a > edge:
            total += b - a
            edge = b
        elif b > edge:
            total += b - edge
            edge = b
    return total / 1e9


def counter(rec: dict, name: str) -> Optional[int]:
    """What a counter added over the window (0 where it did not move);
    None without a record."""
    got = _record(rec)
    return None if got is None else int(got["counters"].get(name, 0))
