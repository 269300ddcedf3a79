"""The production pipeline on the port (python -m colormipsearch_torch,
--device cpu): colorDepthSearch -> gradientScores ->
normalizeGradientScores -> exportData with the arguments of
scripts/run_full_precompute.sh, over one SQLite store and over per-mask
JSON files. The rows read back and the exported files equal the JAX
package's chain on the same workspace, and the goldens hold; the port's
own run_full_precompute.sh (two gradient processes on one store) exports
the same files."""

import json
import os
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu import dataio as jax_io  # noqa: E402
from colormipsearch_tpu.cmd.main import main as jax_main  # noqa: E402
from colormipsearch_tpu.dataio import db as jax_db  # noqa: E402

from colormipsearch_torch import dataio as port_io  # noqa: E402
from colormipsearch_torch.cmd.main import main  # noqa: E402
from colormipsearch_torch.dataio import db as port_db  # noqa: E402

from test_torch_gradient_cli import _write_workspace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "colormipsearch_torch", "scripts",
                      "run_full_precompute.sh")
# scripts/run_full_precompute.sh's stage arguments
CDS = ["--maskThreshold", "20", "--dataThreshold", "20",
       "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
       "--pctPositivePixels", "1", "--processingPartitionSize", "256"]
GRAD = ["--maskThreshold", "20", "--mirrorMask", "--nBestLines", "300",
        "--computeZGapOnTheFly"]
GOLDEN = {"lm-0": (439, False, 21365, 731),
          "lm-1": (414, False, 33884, 523),     # z-gap file
          "lm-2": (426, True, 40696, 17253)}
EXPORTED_SCORES = [("lm-0", 100.0), ("lm-2", 97.04), ("lm-1", 94.31)]
PACKAGES = {"torch": (port_io, port_db, main),
            "jax": (jax_io, jax_db, jax_main)}


def _stage_args(out, backend):
    """(store args of colorDepthSearch, matches args of the later stages)."""
    if backend == "sqlite":
        db = ["--db", str(out / "nb.db")]
        return db, db
    return ["-od", str(out / "cds")], ["-md", str(out / "cds" / "masks")]


def _chain(run, ws, out, backend, dev):
    cache = ["--array-cache", str(out / "array-cache")]
    store, matches = _stage_args(out, backend)
    assert run(["colorDepthSearch", "-m", str(ws / "masks.json"),
                "-i", str(ws / "targets.json"), *CDS, *cache, *store,
                "--processing-tag", "cds-test", *dev]) == 0
    assert run(["gradientScores", *matches, *GRAD, *cache, *dev]) == 0
    assert run(["normalizeGradientScores", *matches]) == 0
    assert run(["exportData", "--exported-result-type", "EM_CD_MATCHES",
                *matches, "-od", str(out / "export")]) == 0


@pytest.fixture(scope="module")
def chains(tmp_path_factory, fixtures_dir):
    """Each package's chain per backend, run once. The port's script runs
    in the background meanwhile, in a workdir of its own."""
    ws = tmp_path_factory.mktemp("pipeline-ws")
    _write_workspace(ws, fixtures_dir)
    script_dir = tmp_path_factory.mktemp("pipeline-script")
    for name in ("masks.json", "targets.json"):
        shutil.copy(ws / name, script_dir / name)
    env = dict(os.environ, CMS_DEVICE="cpu", CMS_GA_PROCS="2",
               CMS_PROCESS_COUNT="1", OMP_NUM_THREADS="2")
    script = subprocess.Popen(["bash", SCRIPT, str(script_dir)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for pkg, dev in (("torch", ["--device", "cpu"]), ("jax", [])):
            run = PACKAGES[pkg][2]
            for backend in ("sqlite", "json"):
                d = tmp_path_factory.mktemp(f"{pkg}-{backend}")
                _chain(run, ws, d, backend, dev)
                out[pkg, backend] = d
    finally:
        log, _ = script.communicate(timeout=240)
    out["script"] = (script.returncode, log, script_dir)
    return out


def _rows(pkg, out, backend):
    """Every match read back through the package's reader, without the
    per-run match and session ids."""
    io, db, _ = PACKAGES[pkg]
    if backend == "sqlite":
        reader = db.DBNeuronMatchesReader(db.SqliteStore(str(out / "nb.db")))
    else:
        reader = io.JSONNeuronMatchesReader(str(out / "cds" / "masks"))
    rows = []
    for mip in reader.list_match_locations([io.DataSourceParam()]):
        for m in reader.read_matches_by_mask(io.DataSourceParam(
                mip_ids=[mip])):
            d = m.to_dict()
            d.pop("id", None)
            d.pop("sessionRefId", None)
            rows.append(d)
    return sorted(rows, key=lambda d: d["image"]["mipId"])


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("backend", ["sqlite", "json"])
def test_rows_equal_jax(chains, backend):
    """Pixel scores, gaps, normalized scores and tags read back equal."""
    got = _rows("torch", chains["torch", backend], backend)
    want = _rows("jax", chains["jax", backend], backend)
    assert got == want
    assert {d["image"]["mipId"]: (d["matchingPixels"], d["mirrored"],
                                  d["gradientAreaGap"],
                                  d["highExpressionArea"])
            for d in got} == GOLDEN
    assert all(d["tags"] == ["cds-test"] for d in got)


@pytest.mark.parametrize("backend", ["sqlite", "json"])
def test_exports_byte_equal_jax(chains, backend):
    got = _tree(chains["torch", backend] / "export")
    assert list(got) == ["em-12191.json"]
    assert got == _tree(chains["jax", backend] / "export")
    doc = json.loads(got["em-12191.json"])
    assert [(r["image"]["mipId"], round(r["normalizedScore"], 2))
            for r in doc["results"]] == EXPORTED_SCORES


def test_json_chain_exports_what_the_store_chain_does(chains):
    assert _tree(chains["torch", "json"] / "export") == \
        _tree(chains["torch", "sqlite"] / "export")


@pytest.mark.parametrize("alias", ["normalizeGradientScores",
                                   "mormalizeGradientScores"])
def test_normalize_rerun_and_alias(chains, tmp_path, alias):
    """Both spellings rerun the normalization over a finished store and
    over finished JSON files; the scores stay, as on the JAX package."""
    for backend in ("sqlite", "json"):
        rows = {}
        for pkg, (_, _, run) in PACKAGES.items():
            out = tmp_path / pkg / backend
            shutil.copytree(chains[pkg, backend], out)
            _, matches = _stage_args(out, backend)
            assert run([alias, *matches]) == 0
            rows[pkg] = _rows(pkg, out, backend)
        assert rows["torch"] == rows["jax"] == \
            _rows("torch", chains["torch", backend], backend)


def test_run_full_precompute_script(chains):
    """The port's script (one search block, two gradient processes
    sharing the store) exports the JAX chain's files."""
    rc, log, workdir = chains["script"]
    assert rc == 0, log[-3000:]
    for stage in ("colorDepthSearch", "gradientScores (2 blocks)",
                  "normalizeGradientScores", "exportData"):
        assert f"=== {stage}" in log
    assert _tree(workdir / "export") == \
        _tree(chains["jax", "sqlite"] / "export")
