"""The reader of the sweep's collect (`sweep.collect_ms_per_target`): the
program's `sweep.collect` spans over the targets swept, and None, not 0,
where the record is missing or holds no collect."""

import pytest

from cdsbench import harness as H

MS = 1_000_000


def _read(rec):
    return H.load_plugin("metrics", "sweep.collect_ms_per_target").read(rec)


def _rec(spans):
    return {"window_s": 2.0, "targets": 20,
            "program": {"spans": [(n, a * MS, b * MS, 1, i, None, 0)
                                  for i, (n, a, b) in enumerate(spans)],
                        "counters": {}, "thread": 1}}


def test_collect_spans_per_target():
    rec = _rec([("sweep.part", 0, 400), ("sweep.collect", 400, 430),
                ("sweep.wait", 405, 410), ("sweep.collect", 900, 910)])
    assert _read(rec) == pytest.approx(40.0 / 20)


def test_no_collect_reads_none():
    assert _read({"window_s": 2.0, "targets": 20}) is None
    assert _read(_rec([])) is None
    assert _read(_rec([("ga.mask", 0, 900)])) is None
