"""Kill-and-resume on the port's CLI over SQLite (the scenarios of
tests/test_kill_resume.py): a colorDepthSearch process SIGKILLed after
its first incremental flush leaves exactly the rows of the partitions it
flushed, and rerunning the same command converges to the store of one
uninterrupted run; two runs equal one; a gradientScores process killed
after its first score flush converges on resume; and two gradientScores
grid blocks writing one store equal one process. The colorDepthSearch
loop is pipelined (partition p+1 is launched before p is collected), so
these runs also check that a flush writes only collected rows.

Every run is a subprocess with two threads; runs that do not depend on
each other start together."""

import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from test_kill_resume import _build_workspace, _canonical_store  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240


def _search_cmd(ws, db):
    return ["-m", "colormipsearch_torch", "colorDepthSearch",
            "-m", str(ws / "masks.json"), "-i", str(ws / "targets.json"),
            "--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
            "--pctPositivePixels", "1", "--processingPartitionSize", "1",
            "--write-batch-size", "1", "--db", str(db),
            "--processing-tag", "killtest", "--device", "cpu"]


def _ga_cmd(db, *extra):
    return ["-m", "colormipsearch_torch", "gradientScores", "--db", str(db),
            "--maskThreshold", "20", "--mirrorMask", "--computeZGapOnTheFly",
            "--write-batch-size", "1", "--processing-tag", "gatest",
            "--device", "cpu", *extra]


def _run_together(*runs):
    """Start every (argv, extra env) run at once; returns [(exit code,
    output)] in order, each run killed at RUN_TIMEOUT_S."""
    procs = []
    for argv, extra in runs:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CMS_", "XLA_FLAGS"))}
        env.update(OMP_NUM_THREADS="2", **extra)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    return out


def _ok(result):
    rc, text = result
    assert rc == 0, text[-3000:]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Three rounds of runs; the canonical store contents after each
    step, keyed by scenario."""
    ws = tmp_path_factory.mktemp("torch-kill")
    _build_workspace(ws)
    db = {name: ws / f"{name}.db" for name in
          ("clean", "crash", "twice", "ga_clean", "ga_crash", "ga_blocks")}
    kill = {"CMS_TEST_KILL_AFTER_FLUSHES": "1"}
    r = _run_together((_search_cmd(ws, db["clean"]), {}),
                      (_search_cmd(ws, db["crash"]), kill),
                      (_search_cmd(ws, db["twice"]), {}))
    _ok(r[0])
    _ok(r[2])
    got = {"search_kill_rc": r[1][0], "search_kill_log": r[1][1],
           "clean": _canonical_store(db["clean"]),
           "partial": _canonical_store(db["crash"]),
           "once": _canonical_store(db["twice"])}
    # the gradient runs start from copies of the finished search store
    for name in ("ga_clean", "ga_crash", "ga_blocks"):
        shutil.copy(db["clean"], db[name])
    r = _run_together(
        (_search_cmd(ws, db["crash"]), {}),
        (_search_cmd(ws, db["twice"]), {}),
        (_ga_cmd(db["ga_clean"]), {}),
        (_ga_cmd(db["ga_crash"]), {"CMS_TEST_KILL_AFTER_GA_FLUSHES": "1"}),
        (_ga_cmd(db["ga_blocks"], "--process-id", "0",
                 "--process-count", "2"), {}),
        (_ga_cmd(db["ga_blocks"], "--process-id", "1",
                 "--process-count", "2"), {}))
    for i in (0, 1, 2, 4, 5):
        _ok(r[i])
    got.update({"resumed": _canonical_store(db["crash"]),
                "twice": _canonical_store(db["twice"]),
                "ga_clean": _canonical_store(db["ga_clean"]),
                "ga_kill_rc": r[3][0], "ga_kill_log": r[3][1],
                "ga_partial": _canonical_store(db["ga_crash"]),
                "ga_blocks": _canonical_store(db["ga_blocks"])})
    _ok(_run_together((_ga_cmd(db["ga_crash"]), {}))[0])
    got["ga_resumed"] = _canonical_store(db["ga_crash"])
    return got


def _pairs(store):
    return {(m["maskImage"]["mipId"], m["image"]["mipId"])
            for m in store["matches"]}


def test_sigkill_mid_run_then_resume_converges(stores):
    assert stores["search_kill_rc"] == -9, stores["search_kill_log"][-3000:]
    clean, partial = stores["clean"], stores["partial"]
    assert len(clean["matches"]) >= 4
    # the kill lands mid-run: the first flushed partition is one target,
    # whose rows are stored as an uninterrupted run stores them
    assert 0 < len(partial["matches"]) < len(clean["matches"])
    assert len({t for _, t in _pairs(partial)}) == 1
    assert all(m in clean["matches"] for m in partial["matches"])
    assert stores["resumed"] == clean


def test_double_run_is_idempotent(stores):
    assert stores["twice"] == stores["once"] == stores["clean"]


def test_ga_sigkill_then_resume_converges(stores):
    assert stores["ga_kill_rc"] == -9, stores["ga_kill_log"][-3000:]
    clean = stores["ga_clean"]
    assert any(m.get("gradientAreaGap", -1) >= 0 for m in clean["matches"])
    assert stores["ga_partial"] != clean
    assert stores["ga_resumed"] == clean


def test_ga_grid_blocks_union_equals_single_run(stores):
    """Two gradientScores grid processes, started together on one store,
    produce the one-process result."""
    assert stores["ga_blocks"] == stores["ga_clean"]


def test_flush_writes_only_collected_partitions(tmp_path, fixtures_dir,
                                                monkeypatch):
    """One target per partition: lm-0, then an unreadable file, then
    lm-2. When lm-0's partition is flushed, the pipelined loop has
    already decoded the next partitions (the unreadable one and lm-2);
    the flush holds lm-0's rows alone, and the unreadable target's error
    rows are written with lm-2's partition. A rerun converges to one
    uninterrupted run."""
    import json

    from colormipsearch_torch.cmd import colordepthsearch_cmd as cds
    from colormipsearch_torch.cmd.main import main
    broken = tmp_path / "broken.tif"
    broken.write_bytes(b"not an image")
    lms = [fixtures_dir / "lms" / "VT033614_127B01_AE_01-20171124_64_H6-f-"
           "CH2_01.tif", broken,
           fixtures_dir / "lms" / "VT016795_115C08_AE_01-20200221_61_I2-m-"
           "CH1_01.tif"]
    em = {"class": "org.janelia.colormipsearch.model.EMNeuronEntity",
          "id": "1001", "mipId": "em-0", "libraryName": "flyem_test",
          "computeFiles": {"InputColorDepthImage": str(
              fixtures_dir / "ems" / "12191_JRC2018U.tif")}}
    targets = [{"class": "org.janelia.colormipsearch.model.LMNeuronEntity",
                "id": str(2001 + i), "mipId": f"lm-{i}",
                "libraryName": "flylight_test",
                "computeFiles": {"InputColorDepthImage": str(path)}}
               for i, path in enumerate(lms)]
    for name, ents in (("masks.json", [em]), ("targets.json", targets)):
        (tmp_path / name).write_text(json.dumps(ents))

    def search(db):
        return main(_search_cmd(tmp_path, db)[2:])

    class Killed(Exception):
        pass

    def kill():
        raise Killed

    with monkeypatch.context() as m:
        m.setattr(cds, "_test_kill_hook", kill)
        with pytest.raises(Killed):
            search(tmp_path / "crash.db")
    partial = _canonical_store(tmp_path / "crash.db")["matches"]
    assert [(d["image"]["mipId"], "errors" in d) for d in partial] == \
        [("lm-0", False)]
    assert search(tmp_path / "crash.db") == 0
    assert search(tmp_path / "clean.db") == 0
    clean = _canonical_store(tmp_path / "clean.db")["matches"]
    assert sorted((d["image"]["mipId"], "errors" in d) for d in clean) == \
        [("lm-0", False), ("lm-1", True), ("lm-2", False)]
    assert _canonical_store(tmp_path / "crash.db")["matches"] == clean
