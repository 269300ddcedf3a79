"""The readers of the program's own spans and counters
(`rec["program"]`): each on a synthetic record, and None, not 0, where
the record is missing or holds nothing of its layer."""

import pytest

from cdsbench import harness as H
from cdsbench import program

MS = 1_000_000
MAIN, POOL = 1, 2


def _span(name, t0_ms, t1_ms, thread=MAIN, sid=0, parent=None, job=0):
    return (name, t0_ms * MS, t1_ms * MS, thread, sid, parent, job)


def _read(metric, rec):
    return H.load_plugin("metrics", metric).read(rec)


def _sweep_rec():
    spans = [_span("sweep.part", 0, 400), _span("sweep.part", 500, 900),
             _span("sweep.wait", 100, 200), _span("sweep.wait", 150, 250),
             _span("sweep.wait", 600, 650),
             _span("sweep.wait", 0, 1000, thread=POOL),  # not the sweep's
             _span("sweep.table", 300, 310), _span("sweep.table", 800, 830)]
    return {"window_s": 2.0, "targets": 20,
            "program": {"spans": spans, "counters": {}, "thread": MAIN}}


def _ga_rec():
    spans = [_span("ga.mask", 0, 900), _span("ga.wait", 10, 30),
             _span("ga.wait", 20, 60), _span("ga.wait", 0, 500, thread=POOL),
             _span("ga.upload", 100, 103), _span("ga.upload", 200, 205),
             _span("ga.decode", 0, 30, thread=POOL),
             _span("ga.decode", 0, 50, thread=POOL + 1),
             _span("ga.decode", 40, 60, thread=POOL)]
    counters = {"ga.planes.hits": 1, "ga.planes.misses": 4}
    return {"window_s": 4.0,
            "program": {"spans": spans, "counters": counters,
                        "thread": MAIN}}


@pytest.mark.parametrize("metric,want", [
    ("sweep.host_wait_pct", 100.0 * 0.2 / 2.0),     # 100-250 and 600-650
    ("sweep.table_ms_per_target", 40.0 / 20),
])
def test_sweep_readers(metric, want):
    assert _read(metric, _sweep_rec()) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("ga.host_wait_pct", 100.0 * 0.05 / 4.0),       # 10-60
    ("ga.plane_hit_pct", 20.0),
    ("ga.upload_ms_per_target", 8.0 / 4),
    ("ga.decode_thread_ms_per_target", 100.0 / 4),
])
def test_ga_readers(metric, want):
    assert _read(metric, _ga_rec()) == pytest.approx(want)


METRICS = ["sweep.host_wait_pct", "sweep.table_ms_per_target",
           "ga.host_wait_pct", "ga.plane_hit_pct", "ga.upload_ms_per_target",
           "ga.decode_thread_ms_per_target"]


@pytest.mark.parametrize("metric", METRICS)
def test_no_record_reads_none(metric):
    """A run without the recorder (the parent, an untraced run), or whose
    recorder saw nothing, reports nothing."""
    assert _read(metric, {"window_s": 2.0, "targets": 20}) is None
    empty = {"spans": [], "counters": {}, "thread": MAIN}
    assert _read(metric, {"window_s": 2.0, "targets": 20,
                          "program": empty}) is None


@pytest.mark.parametrize("metric,rec", [
    ("sweep.host_wait_pct", _ga_rec()),          # no sweep ran
    ("sweep.table_ms_per_target", _ga_rec()),
    ("ga.host_wait_pct", _sweep_rec()),          # no mask scored
    ("ga.plane_hit_pct", _sweep_rec()),          # no lookup
    ("ga.upload_ms_per_target", _sweep_rec()),
    ("ga.decode_thread_ms_per_target", _sweep_rec()),
])
def test_other_layers_read_none(metric, rec):
    assert _read(metric, rec) is None


def test_no_wait_reads_zero():
    """A sweep that never waited reads 0, not None: the layer ran."""
    rec = _sweep_rec()
    rec["program"]["spans"] = [s for s in rec["program"]["spans"]
                               if s[0] != "sweep.wait" or s[3] == POOL]
    assert _read("sweep.host_wait_pct", rec) == 0.0


def test_union_and_total():
    """union_s counts overlapping and touching intervals once; total_s
    counts each interval's length."""
    ivs = [(5, 9), (0, 3), (2, 4), (9, 9), (8, 12)]
    assert program.union_s([(a * MS, b * MS) for a, b in ivs]) == \
        pytest.approx(11 / 1000)
    assert program.total_s([(a * MS, b * MS) for a, b in ivs]) == \
        pytest.approx(13 / 1000)
    assert program.union_s([]) == 0
