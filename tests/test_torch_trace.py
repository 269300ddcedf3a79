"""The port's recorder (`colormipsearch_torch/utils/trace.py`): the
shared no-op while off, parents and job ids while on, a pool task's
parent, lengths on the monotonic clock, the stage totals fed by the
spans' own lengths, and counters that no thread loses."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from colormipsearch_torch.utils import trace


@pytest.fixture
def recorder():
    """Recording on for the test, off and emptied after it."""
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


def test_off_is_one_shared_noop():
    trace.disable()
    trace.drain()
    noop = trace.span("sweep.pack")
    assert trace.span("ga.decode") is noop
    assert trace.span("x", job=7) is noop
    assert trace.timed("sweep.pad", None, "pad") is noop
    assert noop.id is None and noop.job is None
    with noop as s:
        assert s is noop
    fn = len
    assert trace.bind(fn) is fn
    got = trace.drain()
    assert got["spans"] == [] and got["counters"] == {} \
        and got["launches"] == {}


def test_nesting_gives_parents_and_jobs(recorder):
    with trace.span("root") as root:
        with trace.span("child") as child:
            with trace.span("leaf") as leaf:
                pass
        with trace.span("sibling") as sib:
            pass
    with trace.span("second") as second:
        with trace.span("collect", job=root.job) as coll:
            pass
    spans = {s.id: s for s in trace.drain()["spans"]}
    assert spans[root.id].parent is None and spans[root.id].job == root.id
    assert spans[child.id].parent == root.id
    assert spans[leaf.id].parent == child.id
    assert spans[sib.id].parent == root.id
    assert {spans[i].job for i in (child.id, leaf.id, sib.id)} == {root.id}
    assert spans[second.id].job == second.id != root.id
    # a span that names its job keeps its parent
    assert spans[coll.id].parent == second.id
    assert spans[coll.id].job == root.id
    for s in spans.values():
        assert s.start_ns <= s.end_ns
        assert s.thread == threading.get_ident()
    assert spans[root.id].start_ns <= spans[leaf.id].start_ns
    assert spans[leaf.id].end_ns <= spans[root.id].end_ns


def test_pool_task_names_its_submitter(recorder):
    def task(i):
        with trace.span("task"):
            return threading.get_ident()

    with trace.span("pool") as pool_span, \
            ThreadPoolExecutor(max_workers=3) as pool:
        idents = list(pool.map(trace.bind(task), range(6)))
    with trace.span("later") as later:
        pass
    spans = trace.drain()["spans"]
    tasks = [s for s in spans if s.name == "task"]
    assert len(tasks) == 6
    assert all(s.parent == pool_span.id and s.job == pool_span.id
               for s in tasks)
    assert {s.thread for s in tasks} == set(idents)
    assert threading.get_ident() not in idents
    # the workers' stacks are left empty: the main thread's next root is
    # its own job
    assert [s.job for s in spans if s.name == "later"] == [later.id]


def test_length_is_monotonic_when_the_wall_clock_steps(recorder,
                                                       monkeypatch):
    """A span is placed on the wall clock but takes its length from the
    monotonic clock: a wall clock set back 1 s inside the span neither
    shortens it nor makes it negative, in the record or in the totals."""
    walls = [10**18]

    class Clock:
        perf_counter_ns = staticmethod(time.perf_counter_ns)

        @staticmethod
        def time_ns():
            now = walls[-1]
            walls.append(now - 10**9)
            return now

    monkeypatch.setattr(trace, "time", Clock)
    acc = {}
    t0 = time.perf_counter_ns()
    with trace.timed("stage.x", acc, "x"):
        time.sleep(0.002)
    outer = time.perf_counter_ns() - t0
    [s] = trace.drain()["spans"]
    assert s.start_ns == 10**18
    assert 2_000_000 <= s.end_ns - s.start_ns <= outer
    assert acc["x"] == (s.end_ns - s.start_ns) / 1e9


@pytest.mark.parametrize("on", [False, True])
def test_timed_feeds_its_totals_from_the_span(on):
    trace.disable()
    trace.drain()
    if on:
        trace.enable()
    try:
        acc = {}
        for _ in range(3):
            with trace.timed("stage.x", acc, "x"):
                time.sleep(0.001)
        spans = trace.drain()["spans"]
    finally:
        trace.disable()
    assert acc["x"] >= 0.003
    if on:
        assert [s.name for s in spans] == ["stage.x"] * 3
        total = 0.0
        for s in spans:   # in their order, as timed() adds them
            total += (s.end_ns - s.start_ns) / 1e9
        assert acc["x"] == total
    else:
        assert spans == []


def test_counters_count_while_off_and_drain_from_enable(recorder):
    c = trace.counter("test.trace.items")
    assert trace.counter("test.trace.items") is c
    trace.disable()
    before = trace.counts()
    c.add(5)
    assert trace.counts(since=before)["test.trace.items"] == 5
    trace.enable()
    c.add()
    c.add(2)
    assert trace.drain()["counters"] == {"test.trace.items": 3}
    assert trace.drain()["counters"] == {}


def test_threads_lose_no_span_and_no_count(recorder):
    """More threads than cores, a short switch interval: every span and
    every add of every thread is kept, each under its own thread's
    root."""
    c = trace.counter("test.trace.stress")
    n_threads, n_each = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(_):
            with trace.span("root") as root:
                for _ in range(n_each):
                    with trace.span("inner"):
                        c.add()
            return root.id

        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            roots = list(pool.map(work, range(n_threads), timeout=60))
    finally:
        sys.setswitchinterval(old)
    got = trace.drain()
    assert got["counters"]["test.trace.stress"] == n_threads * n_each
    inner = [s for s in got["spans"] if s.name == "inner"]
    assert len(inner) == n_threads * n_each
    assert len({s.id for s in got["spans"]}) == len(got["spans"])
    by_root = {}
    for s in inner:
        by_root.setdefault(s.parent, []).append(s)
    assert sorted(by_root) == sorted(roots)
    assert all(len(v) == n_each and {s.job for s in v} == {p}
               for p, v in by_root.items())
