"""The benchmark's files resolve by name, and a new cell, configuration
or metric is new files only."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from cdsbench import harness as H
from cdsbench import run as R

BENCH = os.path.join(H.ROOT, "BENCHMARK.json")


def _bench():
    with open(BENCH) as f:
        return json.load(f)


def _workloads():
    return sorted(n[:-5] for n in os.listdir(os.path.join(H.PKG, "workloads"))
                  if n.endswith(".json"))


@pytest.mark.parametrize("cell", _workloads())
def test_workload_resolves(cell):
    got = R.plan(cell, _bench())
    wl = H.load_json("workloads", cell)
    assert got["config"] == wl["config"] and got["chips"] == 1
    assert "setup_s" in got["metrics"]


def test_benchmark_names_existing_files():
    b = _bench()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(H.ROOT, c["file"]))
    cells = {w["name"] for w in b["workloads"]}
    assert cells <= set(_workloads())
    for w in b["workloads"]:
        assert H.load_json("workloads", w["name"])["config"] == w["config"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(H.PKG, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:   # every cell reports setup_s, another end-to-end
        assert len(R.cell_metrics(b, cell, False)) >= 2   # metric and a
        assert R.cell_metrics(b, cell, True)              # per-layer one


def test_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark, with a dummy cell, configuration and
    metric added as files and entries, plans the dummy cell with no
    existing file edited."""
    shutil.copytree(H.PKG, tmp_path / "cdsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (tmp_path / "cdsbench").rglob("*")
               if q.is_file())}
    (tmp_path / "cdsbench" / "configs" / "dummy_cfg.json").write_text(
        json.dumps({"name": "dummy_cfg", "parameters": {}}))
    (tmp_path / "cdsbench" / "workloads" / "dummy.cell.json").write_text(
        json.dumps({"name": "dummy.cell", "config": "dummy_cfg",
                    "driver": "cds_job", "chips": 1, "why": "a test",
                    "traffic": {"kind": "regional"}}))
    (tmp_path / "cdsbench" / "metrics" / "dummy.metric.py").write_text(
        "def read(rec):\n    return rec.get('dummy')\n")
    b["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                           "traffic": "cell", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "dummy.metric", "unit": "s",
                           "better": "lower", "source": "program_counter",
                           "layer": "test", "moves": "setup_s",
                           "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, cdsbench.run as R; "
         "print(json.dumps(R.plan('dummy.cell', "
         "json.load(open('BENCHMARK.json')))))"],
        cwd=tmp_path, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    got = json.loads(out.stdout)
    assert got["driver"] == "cds_job"
    assert got["metrics"] == ["setup_s", "dummy.metric"]
    for p, data in before.items():
        assert open(p, "rb").read() == data


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(H.PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_imports():
    """No module of the benchmark imports JAX or the JAX package (whole
    top-level names: the port's name begins with the JAX package's)."""
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(H.FORBIDDEN), path


@pytest.mark.parametrize("sub", ["reference", "roofline", "traffic"])
def test_yardstick_imports_no_program(sub):
    for path in _sources(sub):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "colormipsearch_torch" not in tops, path


def test_no_card_no_result(tmp_path):
    """Without a card the run fails and prints no result: it never falls
    back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "cdsbench", "--workload",
         "cds.block_regional", "--seed", str(2 ** 33 + 5), "--seconds", "1",
         "--trace", "0"], cwd=H.ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path)))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_bare_tree_fails(tmp_path):
    """A tree with only BENCHMARK.json and the benchmark's folder (no
    program) exits non-zero with no result."""
    shutil.copytree(H.PKG, tmp_path / "cdsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "-m", "cdsbench", "--workload", "ga.job_cold",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
