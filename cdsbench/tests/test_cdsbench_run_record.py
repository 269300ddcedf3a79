"""What a run records besides its metrics: each step's seconds, the
collector's passes, and in a traced run the program's own spans (the
recorder on for the window, and nothing where the program has none);
and P1's roofline reader on a synthetic trace record."""

import gc
import json
import sys
import time
import types

import pytest

from cdsbench import harness as H
from cdsbench import run as R
from cdsbench.roofline import work

CELL = "cds.stream_adversarial"
P1_OPS = {
    "(anonymous namespace)::count_kernel(unsigned char const*, long, int, "
    "unsigned long long*)": 0.001,
    "(anonymous namespace)::words_kernel(unsigned char const*, long, int, "
    "unsigned long long const*, int*)": 0.003,
}
K3A = ("void (anonymous namespace)::multimask_words_kernel<2>(int const*, "
       "int const*)")


class FakeTrace:
    """DeviceTrace's stand-in on the CPU: the device ops it is given, and
    the host spans that the run hands to read()."""

    ops: dict = {}
    spans: list = []

    def __init__(self, out_dir):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def read(self, t0_ns, t1_ns, spans):
        FakeTrace.spans = list(spans)
        return {"busy_s": 0.001, "window_s": (t1_ns - t0_ns) / 1e9,
                "device_ops": dict(FakeTrace.ops), "idle_gaps": []}


def _fake_driver(record: bool):
    """A driver whose step sleeps, and with `record` opens the program's
    sweep spans the way the sweep does."""

    def step(run, state):
        if record:
            from colormipsearch_torch.utils import trace
            with trace.span("sweep.part"):
                with trace.span("sweep.wait"):
                    time.sleep(0.002)
        time.sleep(0.005)
        run.rec["targets"] = run.rec.get("targets", 0) + 10

    return types.SimpleNamespace(
        setup=lambda run: {}, step=step, spans=lambda run: [],
        after=lambda run, state: None,
        check=lambda run, state: {"wrong": (0, 0)},
        control=lambda run, precision: {"wrong": (0, 0)})


def _run(monkeypatch, driver, trace: bool, metrics=()):
    load = H.load_plugin
    monkeypatch.setattr(H, "load_plugin", lambda kind, name: (
        driver if kind == "drivers" else load(kind, name)))
    monkeypatch.setattr(H, "DeviceTrace", FakeTrace)
    bench = {"end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": m, "unit": "%", "workloads": [CELL]}
                           for m in metrics]}
    run = R.Run(CELL, 2 ** 31 + 3, 0.05, trace, device="cpu")
    try:
        return run, R.run_cell(run, bench)
    finally:
        run.close()


def test_step_record(monkeypatch):
    """Each step's seconds, one a step, together the window."""
    run, got = _run(monkeypatch, _fake_driver(False), False)
    steps = run.rec["step_s"]
    assert len(steps) == run.rec["steps"] >= 2
    assert all(s > 0 for s in steps)
    assert sum(steps) == pytest.approx(run.rec["window_s"], rel=1e-6)
    assert "setup_s" in got["metrics"]
    assert json.loads(json.dumps(got)) == got
    line = H.step_summary(steps)
    assert line.startswith(f"steps {len(steps)} step_s q1 ")
    assert "(step " in line and line.count("first") == 1


def test_step_summary_short():
    assert H.step_summary([]) == "steps 0"
    assert "median 1.5000" in H.step_summary([1.5])
    got = H.step_summary([1.0, 3.0, 2.0, 2.0, 2.0])
    assert "max 3.0000 (step 1)" in got and "first 1.0000 3.0000 2.0000" in got


def test_gc_watch_sees_and_leaves():
    with H.GcWatch() as w:
        gc.collect()
    assert any(g == 2 and s >= 0 for g, s in w.passes)
    assert w._note not in gc.callbacks
    assert H.gc_summary(w.passes).startswith("gc gen2 ")
    assert H.gc_summary([]) == "gc no passes"


def test_recorder_on_in_traced_run(monkeypatch):
    """A traced run turns the program's recorder on for the window, hands
    its spans to the record and to the gap labels, and turns it off."""
    from colormipsearch_torch.utils import trace
    run, got = _run(monkeypatch, _fake_driver(True), True,
                    ["sweep.host_wait_pct"])
    names = {s[0] for s in run.rec["program"]["spans"]}
    assert {"sweep.part", "sweep.wait"} <= names
    labels = {s[0] for s in FakeTrace.spans}
    assert {"step", "sweep.part", "sweep.wait"} <= labels
    assert got["metrics"]["sweep.host_wait_pct"]["value"] > 0
    assert not trace._on


def test_recorder_missing(monkeypatch):
    """A program without the recorder (the import fails): the traced run
    records nothing of it, its readers read None, and the run ends."""
    monkeypatch.setitem(sys.modules, "colormipsearch_torch.utils", None)
    assert R.program_recorder() is None
    run, got = _run(monkeypatch, _fake_driver(False), True,
                    ["sweep.host_wait_pct", "sweep.table_ms_per_target"])
    assert "program" not in run.rec
    assert got["metrics"] == {} and got["correct"]
    assert {s[0] for s in FakeTrace.spans} == {"step"}


def _p1(rec):
    return H.load_plugin("metrics", "kernel.p1_roofline_pct").read(rec)


def test_p1_reader():
    """P1's bytes over count_kernel + words_kernel's device time; K3a's
    multimask_words_kernel is not P1's."""
    n = work.p1_bytes(2000, 566, 1210)
    assert n == 2000 * 566 * 1210 * 7
    rec = {"p1_bytes": n,
           "trace": {"device_ops": {**P1_OPS, K3A: 5.0, "Memcpy": 1.0}}}
    assert _p1(rec) == pytest.approx(100.0 * n / work.PEAK_BYTES / 0.004)


@pytest.mark.parametrize("rec", [
    {"p1_bytes": 10 ** 9, "trace": {"device_ops": {K3A: 1.0}}},
    {"p1_bytes": 10 ** 9},                     # an untraced record
    {"trace": {"device_ops": dict(P1_OPS)}},   # no bytes counted
])
def test_p1_reader_none(rec):
    assert _p1(rec) is None


def test_traced_stream_reports_p1(monkeypatch):
    """A tiny traced run of the stream cell on the CPU counts P1's bytes
    from the window's targets and reports the per-layer metrics that the
    recorder and the trace feed."""
    from test_cdsbench_faults import TINY
    wl = H.load_json("workloads", CELL)
    wl["traffic"].update(TINY[CELL])
    monkeypatch.setattr(H, "DeviceTrace", FakeTrace)
    monkeypatch.setattr(FakeTrace, "ops", {
        **P1_OPS, "void (anonymous namespace)::multimask_ratio_kernel<2>()":
        0.01})
    with open(R.os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    run = R.Run(CELL, 2 ** 32 + 17, 0.1, True, device="cpu", workload=wl)
    try:
        got = R.run_cell(run, bench)
    finally:
        run.close()
    assert got["correct"], got["compared"]
    h, w = 566, 1210
    assert run.rec["p1_bytes"] == run.rec["targets"] * h * w * 7
    for m in ("kernel.p1_roofline_pct", "sweep.host_wait_pct",
              "sweep.table_ms_per_target", "kernel.k1_roofline_pct"):
        assert m in got["metrics"], m
