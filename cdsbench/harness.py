"""What every cell's run shares: its files, the host memory sampler, the
captured program log, the traced window, and the check for JAX.

Nothing here names a cell, a configuration or a metric: those are files
found by name (`load_json`, `load_plugin`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import logging
import os
import statistics
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# modules that may not be loaded in a run's process, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "colormipsearch_tpu")


def load_json(kind: str, name: str) -> dict:
    """cdsbench/<kind>/<name>.json"""
    with open(os.path.join(PKG, kind, f"{name}.json")) as f:
        return json.load(f)


def load_plugin(kind: str, name: str):
    """The module of cdsbench/<kind>/<name>.py (names may hold dots)."""
    path = os.path.join(PKG, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"cdsbench.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- host memory -------------------------------------------------------------

def rss_bytes(pid: str = "self") -> int:
    """VmRSS of a process, 0 where /proc has none."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class RssSampler:
    """The largest VmRSS of this process over a window, sampled every
    `period` seconds on a thread. Copy of `colormipsearch_torch/scripts/
    dress_rehearsal.py:154` run_stage's poll: that machine's kernel keeps
    no VmHWM, so the peak is the largest sample."""

    def __init__(self, period: float = 0.1):
        self.period = period
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, rss_bytes())
            self._stop.wait(self.period)

    def __enter__(self):
        self.peak = rss_bytes()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, rss_bytes())


# ---- the window's steps and collections ----------------------------------------

class GcWatch:
    """The garbage collector's passes over a window, each (generation,
    seconds), through `gc.callbacks`: it watches and changes nothing of
    when or how the collector runs."""

    def __init__(self):
        self.passes: List[Tuple[int, float]] = []
        self._t0 = None

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.passes.append((info["generation"],
                                time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)


def step_summary(step_s: List[float]) -> str:
    """One line on the window's steps: their count, quartiles, extremes,
    the slowest's place, and the first three."""
    if not step_s:
        return "steps 0"
    q = (statistics.quantiles(step_s, n=4) if len(step_s) > 1
         else [step_s[0]] * 3)
    slow = max(range(len(step_s)), key=step_s.__getitem__)
    first = " ".join(f"{s:.4f}" for s in step_s[:3])
    return (f"steps {len(step_s)} step_s q1 {q[0]:.4f} median {q[1]:.4f} "
            f"q3 {q[2]:.4f} min {min(step_s):.4f} max {max(step_s):.4f} "
            f"(step {slow}) first {first}")


def gc_summary(passes: List[Tuple[int, float]]) -> str:
    """One line on the collector's passes in the window, by generation:
    how many, their seconds in all, the longest."""
    parts = []
    for g in (0, 1, 2):
        got = [s for gen, s in passes if gen == g]
        if got:
            parts.append(f"gen{g} {len(got)} passes {sum(got):.4f} s "
                         f"longest {max(got):.4f} s")
    return "gc " + ("; ".join(parts) if parts else "no passes")


# ---- the program's log ---------------------------------------------------------

class LogCapture(logging.Handler):
    """The program's INFO records, kept as (message template, args, time)
    instead of printed: the commands log their stage seconds and counts
    (`stage times`, `prepared ... in`, `updated ... matches`)."""

    def __init__(self, logger: str = "colormipsearch_torch"):
        super().__init__(logging.INFO)
        self.records: List[Tuple[str, tuple, float]] = []
        self._logger = logging.getLogger(logger)

    def emit(self, record):
        args = record.args if isinstance(record.args, tuple) else (
            record.args,)
        self.records.append((str(record.msg), args, record.created))

    def __enter__(self):
        self._logger.addHandler(self)
        self._old = (self._logger.level, self._logger.propagate)
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._old[0])
        self._logger.propagate = self._old[1]

    def since(self, mark: int, prefix: str) -> List[tuple]:
        """The args of the records after `mark` whose template starts with
        prefix."""
        return [a for m, a, _ in self.records[mark:] if m.startswith(prefix)]


# ---- spans and the device trace -------------------------------------------------

class Spans:
    """Host spans (name, start, end) in the wall clock's nanoseconds, the
    clock of torch.profiler's trace. `wrap` times calls into the program
    from outside it: it replaces an attribute for the traced window only."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._undo: List[Callable] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            with self._lock:
                self.items.append((name, t0, time.time_ns()))

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr, None)
        if fn is None:   # the program no longer has it: no span
            return
        spans = self

        def timed(*a, **k):
            with spans.span(name):
                return fn(*a, **k)

        timed.__wrapped__ = fn
        # one attribute dict: attributes the program keeps on its
        # functions (a kernel wrapper's `.launches`) reach the original
        timed.__dict__ = fn.__dict__
        setattr(owner, attr, timed)
        self._undo.append(lambda: setattr(owner, attr, fn))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path: str, t0_ns: int, t1_ns: int,
               spans: List[Tuple[str, int, int]]) -> dict:
    """From a torch.profiler Chrome trace of the window [t0_ns, t1_ns]
    (wall clock): busy seconds (the union of kernel, copy and set
    intervals), each device operation's seconds by name, and the idle
    gaps, each named by the innermost host span open at its middle."""
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    w0, w1 = t0_ns / 1e3 - base_us, t1_ns / 1e3 - base_us
    ops: Dict[str, float] = {}
    ivs = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ivs.append((a, b))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) / 1e6
    ivs.sort()
    busy, gaps, edge = 0.0, [], w0
    for a, b in ivs:
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    host = sorted((s / 1e3 - base_us, e / 1e3 - base_us, n)
                  for n, s, e in spans)

    def label(t):
        best = None
        for s, e, n in host:
            if s > t:
                break
            if e >= t:
                best = n   # the latest-starting span that holds t
        return best or "harness"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": ops,
            "idle_gaps": [[label((a + b) / 2), (b - a) / 1e6]
                          for a, b in gaps[:10]]}


class DeviceTrace:
    """torch.profiler over the window, device activity only (kernels,
    copies, sets); the host's side is the spans'."""

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "window_trace.json")
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)

    def read(self, t0_ns: int, t1_ns: int, spans) -> dict:
        try:
            return read_trace(self.path, t0_ns, t1_ns, spans)
        finally:
            os.remove(self.path)


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest items, names cut to 160 characters."""
    return [[k[:160], v] for k, v in sorted(items.items(),
                                            key=lambda kv: -kv[1])[:n]]


def kernel_seconds(trace: dict, *names: str) -> Optional[float]:
    """Device seconds of the operations whose name holds any of `names`;
    None where the trace has none."""
    got = [s for op, s in trace.get("device_ops", {}).items()
           if any(n in op for n in names)]
    return sum(got) if got else None
