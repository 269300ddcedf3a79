"""The port's own spans and counters, on the wall clock of a device trace.

Off by default. While off, `span(name)` costs one flag check and returns
one shared no-op context manager: it allocates nothing, reads no clock
and records nothing. `enable()` turns recording on for the process,
`drain()` hands over what was recorded since, `disable()` turns it off.

A recorded span is (name, start_ns, end_ns, thread, id, parent, job). Its
start is `time.time_ns()`, the wall clock against which torch.profiler's
Chrome trace states its `baseTimeNanoseconds`, so spans and device
activity share one time line; its length is read on the monotonic
`time.perf_counter_ns()`, so that a step of the wall clock moves a span
but never stretches it. The parent is the innermost span open in
the calling thread (a pool task takes its submitter's, through `bind`);
the job is the id of the root span, unless the span names its job (a
sweep partition's collect carries its launch's job).

`timed(name, acc, key)` is a span that also adds its seconds to
`acc[key]` whether recording is on or not: the stage totals that the
commands log and the sweep hands back are the spans' own lengths.

Counters (`counter(name)`) are process-wide integers, counted whether
recording is on or not; `counts()` reads them all, and `drain()` gives
what they and the kernel wrappers' launch counts (`cds/kernels.py:
launch_counts`) added since `enable()` or the last `drain()`.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

_on = False
_lock = threading.Lock()
_spans: list = []
_ids = itertools.count(1)
_local = threading.local()
_counters: Dict[str, "Counter"] = {}
_base: Tuple[Dict[str, int], Dict[str, int]] = ({}, {})


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    job: int


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Noop:
    """The span of a run that records nothing."""

    __slots__ = ()
    id = None
    job = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "job", "acc", "key", "id", "parent", "w0", "t0")

    def __init__(self, name: str, job: Optional[int] = None, acc=None,
                 key: Optional[str] = None):
        self.name = name
        self.job = job
        self.acc = acc
        self.key = key
        self.id = None

    def __enter__(self):
        if _on:
            stack = _stack()
            top = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = top.id if top is not None else None
            if self.job is None:
                self.job = top.job if top is not None else self.id
            stack.append(self)
            self.w0 = time.time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        length = time.perf_counter_ns() - self.t0
        if self.acc is not None:
            self.acc[self.key] = self.acc.get(self.key, 0.0) + length / 1e9
        if self.id is not None:
            stack = _stack()
            if stack[-1] is self:
                stack.pop()
            else:
                stack.remove(self)
            # a plain tuple of untracked values: the collector stops
            # tracking it, so a window's spans add no full collections
            rec = (self.name, self.w0, self.w0 + length,
                   threading.get_ident(), self.id, self.parent, self.job)
            with _lock:
                _spans.append(rec)
        return False


def span(name: str, job: Optional[int] = None):
    """A context manager that records `name` while recording is on (the
    shared no-op while off). `job` names the span's job in place of its
    root's."""
    return _Span(name, job) if _on else _NOOP


def timed(name: str, acc: Optional[dict], key: str):
    """span(name), which also adds its seconds to acc[key] (when acc is
    not None) whether recording is on or not."""
    if acc is None:
        return _Span(name) if _on else _NOOP
    return _Span(name, None, acc, key)


def bind(fn):
    """fn, run under the calling thread's innermost open span: hand a
    pool task its submitter as parent (a pool does not copy it)."""
    if not _on:
        return fn
    stack = _stack()
    if not stack:
        return fn
    top = stack[-1]

    def run(*args, **kwargs):
        own = _stack()
        own.append(top)
        try:
            return fn(*args, **kwargs)
        finally:
            own.pop()

    return run


# ---- counters ----------------------------------------------------------------

class Counter:
    """A named process-wide integer."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        with _lock:
            self.value += n


def counter(name: str) -> Counter:
    """The counter of that name (made on first use)."""
    with _lock:
        got = _counters.get(name)
        if got is None:
            got = _counters[name] = Counter(name)
        return got


def counts(since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Every counter's value, or what each added after `since` (an
    earlier counts())."""
    with _lock:
        now = {n: c.value for n, c in _counters.items()}
    if since is None:
        return now
    return {n: v - since.get(n, 0) for n, v in now.items()}


def _launches() -> Dict[str, int]:
    from ..cds.kernels import launch_counts
    return launch_counts()


def _added(now: Dict[str, int], base: Dict[str, int]) -> Dict[str, int]:
    return {n: v - base.get(n, 0) for n, v in now.items()
            if v != base.get(n, 0)}


# ---- the switch ----------------------------------------------------------------

def enable() -> None:
    """Start recording (what drain() gives is counted from here)."""
    global _on
    drain()
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> dict:
    """What was recorded since enable() or the last drain(), handed over:
    {"spans": [Span], "counters": {name: added}, "launches": {kernel:
    added}, "thread": the calling thread}. Counters and launches list
    only those that moved."""
    global _base
    with _lock:
        spans = _spans[:]
        del _spans[:]
    now = (counts(), _launches())
    base, _base = _base, now
    return {"spans": [Span(*s) for s in spans],
            "counters": _added(now[0], base[0]),
            "launches": _added(now[1], base[1]),
            "thread": threading.get_ident()}

