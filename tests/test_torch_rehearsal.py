"""The port's dress rehearsal (colormipsearch_torch/scripts/dress_rehearsal.py)
against the JAX package's (scripts/dress_rehearsal.py), on the CPU.

- The port's generator writes the same PNG bytes as the JAX generator in
  ems/, lms/, grad/ and zgap/ at two sizes that roll and band every
  fixture.
- Without --cpu on a machine without a card, the port's rehearsal
  ingests the library and then fails at colorDepthSearch, its first
  device stage, with that stage's rc in rehearsal.json: there is no CPU
  fallback. That ingested store is copied, and both rehearsals run their
  search, gradient, normalize and export stages over a copy each with
  --cpu (the port's plain versions; the JAX package's interpret-mode
  Pallas). Tolerance: exact. The stored rows are equal field by field,
  the exported files byte for byte, and the counts of rehearsal.json
  equal.
- --skip-through cds keeps the entries of an earlier run, and a stage
  killed mid-run is recorded in rehearsal.json with its rc before the
  script exits.
"""

import importlib.util
import json
import os
import shutil
import signal
import sqlite3
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from colormipsearch_torch.scripts import dress_rehearsal as port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "dress_rehearsal.py")
PORT = [sys.executable, "-m", "colormipsearch_torch.scripts.dress_rehearsal"]
JAX = [sys.executable, JAX_SCRIPT]
SIZE = ["--masks", "4", "--targets", "6"]
# resume over an ingested store: the search, gradient, normalize, export
AFTER_INGEST = [*SIZE, "--skip-generate", "--skip-through", "import_lm"]
# 3 EM and 4 LM fixtures: from mask 3 and target 4 on every fixture is
# rolled, and every frame but the first is banded
GENERATOR_SIZES = [(6, 8), (7, 13)]
LIBRARY_DIRS = ["ems", "lms", "grad", "zgap"]
ROW_FIELDS = ("matching_pixels, matching_pixels_ratio, mirrored, "
              "gradient_area_gap, high_expression_area, normalized_score")
STAGE_TIMEOUT_S = 600


def _jax_rehearsal_module():
    spec = importlib.util.spec_from_file_location("jax_dress_rehearsal",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    """The stages' environment: none of the caller's CMS_ settings, and
    no virtual device mesh of the JAX tests (the script runs alone)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CMS_") and k != "XLA_FLAGS"}
    env.update(extra)
    return env


def _start(cmd, wd, *args, **env):
    return subprocess.Popen([*cmd, str(wd), *args], cwd=REPO, env=_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=STAGE_TIMEOUT_S)
    return proc.returncode, out


def _report(wd):
    with open(os.path.join(wd, "rehearsal.json")) as f:
        return json.load(f)


def _rows(wd):
    """{(mask_ref, matched_ref): the scores} of every stored CD match."""
    con = sqlite3.connect(os.path.join(wd, "store.db"))
    try:
        return {(r[0], r[1]): r[2:] for r in con.execute(
            f"SELECT mask_ref, matched_ref, {ROW_FIELDS} FROM cd_matches")}
    finally:
        con.close()


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


# ---- the library generator -------------------------------------------------

@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    """{(masks, targets): (the port's workdir, the JAX package's)}, each
    generated once."""
    jax_mod = _jax_rehearsal_module()
    out = {}
    for n_masks, n_targets in GENERATOR_SIZES:
        root = tmp_path_factory.mktemp(f"library_{n_masks}x{n_targets}")
        wds = (str(root / "port"), str(root / "jax"))
        port.generate_library(wds[0], n_masks, n_targets)
        jax_mod.generate_library(wds[1], n_masks, n_targets)
        out[(n_masks, n_targets)] = wds
    return out


@pytest.mark.parametrize("sub", LIBRARY_DIRS)
@pytest.mark.parametrize("size", GENERATOR_SIZES,
                         ids=[f"{m}x{t}" for m, t in GENERATOR_SIZES])
def test_generator_writes_the_jax_generators_bytes(libraries, size, sub):
    port_wd, jax_wd = libraries[size]
    got, want = _files(os.path.join(port_wd, sub)), \
        _files(os.path.join(jax_wd, sub))
    assert len(want) == (size[0] if sub == "ems" else size[1])
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


# ---- the rehearsal ---------------------------------------------------------

@pytest.fixture(scope="module")
def no_card(tmp_path_factory):
    """The port's rehearsal without --cpu where torch sees no card: it
    generates and ingests, then stops at colorDepthSearch."""
    wd = tmp_path_factory.mktemp("rehearsal") / "no_card"
    rc, out = _finish(_start(PORT, wd, *SIZE, CUDA_VISIBLE_DEVICES=""))
    return str(wd), rc, out


@pytest.fixture(scope="module")
def rehearsals(no_card):
    """Both rehearsals with --cpu over copies of the ingested store, run
    side by side: {"port": workdir, "jax": workdir}."""
    ingested = no_card[0]
    wds = {name: os.path.join(os.path.dirname(ingested), name)
           for name in ("port", "jax")}
    for wd in wds.values():
        shutil.copytree(ingested, wd)
    procs = {"port": _start(PORT, wds["port"], *AFTER_INGEST, "--cpu"),
             "jax": _start(JAX, wds["jax"], *AFTER_INGEST, "--cpu")}
    for name, proc in procs.items():
        rc, out = _finish(proc)
        assert rc == 0, f"{name} rehearsal exited {rc}:\n{out[-3000:]}"
    return wds


def test_without_a_card_the_first_device_stage_fails(no_card):
    wd, rc, out = no_card
    assert rc != 0
    assert "stage cds failed" in out
    report = _report(wd)
    assert report["import_em"]["rc"] == 0 and report["import_lm"]["rc"] == 0
    assert report["cds"]["rc"] != 0
    assert "ga_b0" not in report and "export" not in report
    assert not _rows(wd)  # nothing was scored, on any device
    with open(os.path.join(wd, "cds.log")) as f:
        assert "no CUDA card" in f.read()


def test_rehearsal_rows_equal_jax(rehearsals):
    got, want = _rows(rehearsals["port"]), _rows(rehearsals["jax"])
    assert want and got.keys() == want.keys()
    # every stage wrote: pixel scores, gradient scores, normalized scores
    assert all(r[0] > 0 and r[3] is not None and r[5] is not None
               for r in want.values())
    for key in want:
        assert got[key] == want[key], key


def test_rehearsal_exports_equal_jax(rehearsals):
    got = _files(os.path.join(rehearsals["port"], "export"))
    want = _files(os.path.join(rehearsals["jax"], "export"))
    masks_with_rows = {f"{m}.json" for m, _ in _rows(rehearsals["jax"])}
    assert set(want) == masks_with_rows and len(want) == 4
    assert got == want


def test_rehearsal_counts_equal_jax(rehearsals):
    got, want = _report(rehearsals["port"]), _report(rehearsals["jax"])
    assert got.keys() == want.keys()
    for key in ("config", "matches_written", "ga_matches_scored"):
        assert got[key] == want[key], key
    assert got["matches_written"] == len(_rows(rehearsals["jax"]))
    assert got["export"]["files_written"] == want["export"]["files_written"]
    for stage in ("cds", "ga_b0", "ga_b1", "ga_b2", "ga_b3", "ga",
                  "normalize", "export"):
        assert got[stage].keys() == want[stage].keys(), stage
        assert got[stage]["rc"] == 0, stage
    assert got["ga"]["blocks"] == 4
    for name in ("cds", "ga_b3", "normalize", "export"):
        assert os.path.getsize(os.path.join(rehearsals["port"],
                                            f"{name}.log")) > 0


def test_skip_through_cds_keeps_earlier_entries(rehearsals, tmp_path):
    wd = tmp_path / "resumed"
    shutil.copytree(rehearsals["port"], wd)
    before, rows = _report(wd), _rows(wd)
    os.remove(wd / "ga_b0.log")
    rc, out = _finish(_start(PORT, wd, *SIZE, "--skip-generate",
                             "--skip-through", "cds", "--ga-blocks", "1",
                             "--cpu"))
    assert rc == 0, out[-3000:]
    after = _report(wd)
    for stage in ("generate", "import_em", "import_lm", "cds"):
        assert after[stage] == before[stage], stage
        assert f"stage {stage}:" not in out
    assert after["ga"]["blocks"] == 1 and after["ga_b0"]["rc"] == 0
    assert os.path.exists(wd / "ga_b0.log")
    assert _rows(wd) == rows
    assert after["ga_matches_scored"] == before["ga_matches_scored"]


def test_killed_stage_is_recorded_before_the_exit(rehearsals, tmp_path):
    wd = tmp_path / "killed"
    shutil.copytree(rehearsals["port"], wd)
    rc, out = _finish(_start(PORT, wd, *SIZE, "--skip-generate",
                             "--skip-through", "cds", "--cpu",
                             CMS_TEST_KILL_AFTER_GA_FLUSHES="1"))
    assert rc != 0
    assert f"stage ga_b0 failed rc={-signal.SIGKILL}" in out
    report = _report(wd)
    assert report["ga_b0"]["rc"] == -signal.SIGKILL
    assert "ga_b1" in report  # the earlier run's entry, kept
    assert report["cds"]["rc"] == 0


@pytest.mark.parametrize("cpu", [True, False], ids=["cpu", "card"])
def test_stage_arguments_are_the_jax_scripts(monkeypatch, tmp_path, cpu):
    """Each stage runs `python -m colormipsearch_torch` with the JAX
    script's arguments letter for letter; the device stages add --device
    (cpu with --cpu, else cuda), and nothing else differs."""
    monkeypatch.delenv("CMS_REHEARSAL_GA_BLOCKS", raising=False)

    def recorder(into):
        def run_stage(name, cmd, results, env_extra=None):
            into[name] = cmd
            results[name] = {"wall_s": 1.0, "peak_rss_gb": 0.0, "rc": 0}
        return run_stage

    jax_mod = _jax_rehearsal_module()
    got, want = {}, {}
    monkeypatch.setattr(port, "run_stage", recorder(got))
    monkeypatch.setattr(jax_mod, "run_stage", recorder(want))
    flags = ["--skip-generate"] + (["--cpu"] if cpu else [])
    port.main([str(tmp_path / "port"), *flags])
    monkeypatch.setattr(sys, "argv", ["dress_rehearsal.py",
                                      str(tmp_path / "jax"), *flags])
    jax_mod.main()
    assert list(got) == list(want) == [
        "import_em", "import_lm", "cds", "ga_b0", "ga_b1", "ga_b2", "ga_b3",
        "normalize", "export"]
    device = ["--device", "cpu" if cpu else "cuda"]
    for name, cmd in want.items():
        assert cmd[:3] == [sys.executable, "-m", "colormipsearch_tpu"]
        args = [a.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                for a in cmd[3:]]
        if name == "cds" or name.startswith("ga_b"):
            args += device
        assert got[name] == [sys.executable, "-m", "colormipsearch_torch",
                             *args], name
