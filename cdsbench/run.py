"""The benchmark of colormipsearch_torch on the card.

    python -m cdsbench --workload CELL --seed N --seconds S --trace 0|1

One run: make the cell's inputs from the seed, warm up on its shapes (set
up), run jobs or passes back to back until S seconds have passed (the one
in progress finishes and counts), check what the window produced against
the plain reference, and print one JSON line. With --trace 0 the line
holds the cell's end-to-end metrics, with --trace 1 its per-layer ones
(the window under torch.profiler, host spans around the calls into the
program, and the program's own spans and counters). A cell
(cdsbench/workloads/CELL.json) names its configuration (cdsbench/configs/),
its driver (cdsbench/drivers/) and its traffic; each metric is a reader of
the run's record (cdsbench/metrics/NAME.py); BENCHMARK.json says which
metrics a cell reports. Every run also keeps each step's seconds and the
garbage collector's passes in the window, and prints a line of each to
standard error.

The run exits non-zero and prints no result without as many cards as the
cell asks for, or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.time()   # set-up is counted from here

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional

from . import harness as H


class Run:
    """One run of one cell: its files, seed, device, working directory
    (under TMPDIR) and record (what the metric readers read)."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", workload: Optional[dict] = None):
        self.cell = cell
        self.workload = workload or H.load_json("workloads", cell)
        self.config = H.load_json("configs", self.workload["config"])
        self.params = self.config["parameters"]
        self.traffic = self.workload["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.workdir = tempfile.mkdtemp(prefix=f"cdsbench-{cell}-")
        self.rec: dict = {"pairs": 0, "matches": 0, "steps": 0, "stage": {},
                          "step_s": []}
        self.spans = H.Spans()
        self.logs = H.LogCapture()

    def add_stage(self, totals: dict) -> None:
        """Accumulate stage seconds and counts (the sweep's dict)."""
        st = self.rec["stage"]
        for k, v in totals.items():
            st[k] = st.get(k, 0) + v

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """BENCHMARK.json's metrics of a cell: its end-to-end metrics, or
    with trace its per-layer ones (a metric with `workloads` where it
    lists the cell; one without, where the cell reports what it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def plan(cell: str, bench: dict) -> dict:
    """What a run of `cell` would load, resolved by name from its files
    alone: the configuration, the driver and each metric's reader."""
    workload = H.load_json("workloads", cell)
    config = H.load_json("configs", workload["config"])
    driver = H.load_plugin("drivers", workload["driver"])
    metrics = [m["name"] for trace in (False, True)
               for m in cell_metrics(bench, cell, trace)]
    for m in metrics:
        if not callable(getattr(H.load_plugin("metrics", m), "read", None)):
            raise ValueError(f"metric {m} has no read(record)")
    for f in ("setup", "step", "spans", "after", "check", "control"):
        if not callable(getattr(driver, f, None)):
            raise ValueError(f"driver {workload['driver']} has no {f}()")
    return {"config": config["name"], "driver": workload["driver"],
            "chips": workload["chips"], "metrics": metrics}


def power_limit_w() -> Optional[float]:
    """The card's power limit, as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def program_recorder():
    """The program's own recorder (`colormipsearch_torch.utils.trace`),
    turned on; None where the program has none."""
    try:
        from colormipsearch_torch.utils import trace
    except ImportError:
        return None
    trace.enable()
    return trace


def run_cell(run: Run, bench: dict) -> dict:
    """Set up, run the window, check; the result line as a dict."""
    import torch
    driver = H.load_plugin("drivers", run.workload["driver"])
    cuda = run.device.startswith("cuda")
    with run.logs:
        state = driver.setup(run)
        if cuda:
            torch.cuda.synchronize()
        run.rec["setup_s"] = time.time() - T_START
        trace = H.DeviceTrace(run.workdir) if run.trace else None
        recorder = None
        if trace:
            for owner, attr, name in driver.spans(run):
                run.spans.wrap(owner, attr, name)
            trace.__enter__()
            recorder = program_recorder()
        with H.RssSampler() as rss, H.GcWatch() as gcw:
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            mark = t0
            while True:
                with run.spans.span("step"):
                    driver.step(run, state)
                run.rec["steps"] += 1
                now = time.perf_counter()
                run.rec["step_s"].append(now - mark)
                mark = now
                if now - t0 >= run.seconds:
                    break
            run.rec["window_s"] = now - t0
            t1_ns = time.time_ns()
        run.rec["gc"] = gcw.passes
        if trace:
            if recorder is not None:
                run.rec["program"] = recorder.drain()
                recorder.disable()
            trace.__exit__(None, None, None)
            run.spans.unwrap()
            # gaps take the innermost span of both: the program's nest
            # inside the harness's
            program = [s[:3] for s in
                       run.rec.get("program", {}).get("spans", [])]
            run.rec["trace"] = trace.read(t0_ns, t1_ns,
                                          run.spans.items + program)
        run.rec["peak_rss_bytes"] = rss.peak
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        driver.after(run, state)
        compared = driver.check(run, state)
    metrics = {}
    for m in cell_metrics(bench, run.cell, run.trace):
        value = H.load_plugin("metrics", m["name"]).read(run.rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": int(run.workload["chips"]),
              "memory_peak_bytes": int(peak)}
    if cuda:
        device["power_limit_w"] = run.rec.get("power_limit_w")
    result = {"correct": all(v <= lim for v, lim in compared.values())
              and run.rec.get("failed", 0) == 0,
              "attempted": int(run.rec.get("attempted", 0)),
              "failed": int(run.rec.get("failed", 0)),
              "metrics": metrics, "device": device}
    if run.trace:
        tr = run.rec["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": H.top(tr["device_ops"]),
                               "idle_gaps": tr["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cdsbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = os.path.join(H.ROOT, "build", "cdsbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace))
    try:
        import torch
        chips = int(run.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"cdsbench: {run.cell} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        run.rec["power_limit_w"] = power_limit_w()
        result = run_cell(run, bench)
    finally:
        run.close()
    found = H.forbidden_modules()
    if found:
        print(f"cdsbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(H.step_summary(run.rec["step_s"]), file=sys.stderr)
    print(H.gc_summary(run.rec["gc"]), file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
