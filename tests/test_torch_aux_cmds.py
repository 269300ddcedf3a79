"""The port's six host commands around the production pipeline
(createColorDepthSearchDataInput, copyToMipsStore, importPPPResults, tag,
validateDBData, deleteCDMatches) against the JAX package's on the same
inputs: each scenario runs once per package in a directory of its own,
and the files written, the reports and the store rows read back (SQLite
and the in-process pymongo fake) are equal. Entity ids come from each
package's TimebasedIdGenerator, pinned to one counter per package, so the
two runs mint the same ids and the files compare byte for byte.

The cases are those of tests/test_cli_aux_cmds.py,
test_copymips_renames.py, test_delete_cmd.py and
test_selector_and_validate.py."""

import itertools
import json
import os
import pathlib
import shutil

import pytest

pytest.importorskip("torch")

from colormipsearch_tpu import dataio as jax_io  # noqa: E402
from colormipsearch_tpu import model as jax_model  # noqa: E402
from colormipsearch_tpu import persist as jax_persist  # noqa: E402
from colormipsearch_tpu.cmd import backends as jax_backends  # noqa: E402
from colormipsearch_tpu.cmd.main import main as jax_main  # noqa: E402
from colormipsearch_tpu.dataio import db as jax_db  # noqa: E402
from colormipsearch_tpu.dataio import db_mongo as jax_mongo  # noqa: E402

from colormipsearch_torch import dataio as port_io  # noqa: E402
from colormipsearch_torch import model as port_model  # noqa: E402
from colormipsearch_torch import persist as port_persist  # noqa: E402
from colormipsearch_torch.cmd import backends as port_backends  # noqa: E402
from colormipsearch_torch.cmd.main import main as port_main  # noqa: E402
from colormipsearch_torch.dataio import db as port_db  # noqa: E402
from colormipsearch_torch.dataio import db_mongo as port_mongo  # noqa: E402

import test_copymips_renames as copymips_ref  # noqa: E402
import test_delete_cmd as delete_ref  # noqa: E402
import test_selector_and_validate as selector_ref  # noqa: E402
from test_db_mongo import _FakeClient  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CDSEARCH = FIXTURES / "cdsearch"


class Pkg:
    """One package's CLI, model and store layer, rooted in its own
    directory, with an optional Mongo fake behind a mongodb:// URI."""

    def __init__(self, name, main, io, db, mongo, model, backends, root):
        self.name, self.main, self.io, self.db = name, main, io, db
        self.mongo, self.model, self.backends = mongo, model, backends
        self.root = root
        self.mongo_uri = self.mongo_store = None

    def run(self, *argv) -> int:
        # the port's main() closes its store cache when a command ends:
        # hand the fake to the cache before each command
        if self.mongo_uri:
            self.backends._stores[self.mongo_uri] = self.mongo_store
        return self.main([str(a) for a in argv])

    def db_arg(self, backend):
        if backend == "mongo":
            self.mongo_uri = f"mongodb://{self.name}-aux/neuronbridge"
            self.mongo_store = self.mongo.MongoStore(
                client=_FakeClient(), database="neuronbridge")
            return self.mongo_uri
        return str(self.root / "nb.db")

    def store(self, db):
        if db.startswith("mongodb://"):
            return self.mongo_store
        return self.db.SqliteStore(db)

    def convert(self, entities):
        """Entities built by a test module of the JAX package, as this
        package's."""
        return [getattr(self.model, type(e).__name__).from_dict(e.to_dict())
                for e in entities]

    def done(self):
        self.backends._stores.pop(self.mongo_uri, None)


MODULES = {"torch": (port_main, port_io, port_db, port_mongo, port_model,
                     port_backends),
           "jax": (jax_main, jax_io, jax_db, jax_mongo, jax_model,
                   jax_backends)}


@pytest.fixture(autouse=True)
def fixed_ids(monkeypatch):
    """Each package's id generator hands out one counter's ids."""
    for persist in (port_persist, jax_persist):
        counter = itertools.count(7_000_000_000)
        monkeypatch.setattr(persist.TimebasedIdGenerator, "_next_block",
                            lambda self, n, c=counter: [next(c)
                                                        for _ in range(n)])


def _canon(value, root):
    """A JSON-able value with the package's root written as <ROOT>."""
    return json.loads(json.dumps(value, sort_keys=True).replace(
        str(root), "<ROOT>"))


def tree(root, skip=(".db", ".db-wal", ".db-shm")):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(skip):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def dump(pkg, store):
    """Every neuron, CD match, PPP match and archived id of a store."""
    sel = pkg.io.DataSourceParam
    reader = pkg.db.DBNeuronMatchesReader(store)
    mips = reader.list_match_locations([sel()])
    out = {
        "neurons": sorted((n.to_dict() for n in store.find_neurons(sel())),
                          key=lambda d: json.dumps(d, sort_keys=True)),
        "matches": sorted((m.to_dict() for m in reader.read_matches_by_mask(
            sel(mip_ids=mips))) if mips else [],
            key=lambda d: json.dumps(d, sort_keys=True)),
        "ppp": [m.to_dict() for em in sorted(store.list_ppp_em_names())
                for m in store.find_ppp_matches_by_em(em)],
        "archived": sorted(store.archived_match_ids()),
    }
    return _canon(out, pkg.root)


def both(tmp_path, scenario, *args):
    """Run scenario(pkg, *args) once per package, each in its own
    directory, and return what each gave, its root written as <ROOT>."""
    got = {}
    for name, mods in MODULES.items():
        root = tmp_path / name
        root.mkdir()
        pkg = Pkg(name, *mods, root)
        try:
            got[name] = scenario(pkg, *args)
        finally:
            pkg.done()
        got[name] = {k: (v.replace(str(root).encode(), b"<ROOT>")
                         if isinstance(v, bytes) else _canon(v, root))
                     for k, v in _flatten(got[name]).items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _flatten(result):
    """Scenario results as one flat dict (file trees spread out)."""
    out = {}
    for key, value in result.items():
        if isinstance(value, dict) and value and all(
                isinstance(v, bytes) for v in value.values()):
            out.update({f"{key}/{k}": v for k, v in value.items()})
        else:
            out[key] = value
    return out


def _finish(pkg, db, out):
    """Add the store's rows (with --db) to a scenario's result."""
    if db:
        store = pkg.store(db)
        out["store"] = dump(pkg, store)
        if not db.startswith("mongodb://"):
            store.close()
    return out


# ---------------------------------------------------------------- import

def _ppp_dir(pkg):
    rd = pkg.root / "ppp" / "00"
    rd.mkdir(parents=True)
    for f in FIXTURES.glob("cov_scores_*.json"):
        shutil.copy(f, rd)
    shots = pkg.root / "screenshots"
    shots.mkdir()
    for em, lm in PPP_PAIRS:
        for sfx in ("_1_raw.png", "_5_ch.png"):
            (shots / f"{em}-{lm}{sfx}").write_bytes(b"png")
    return pkg.root / "ppp", shots


PPP_PAIRS = [("1599747200-PFNp_c-RT_18U",
              "BJD_100A01_AE_01-20170929_62_B1_REG_UNISEX_40x"),
             ("484130600-SMP145-RT_18U",
              "BJD_105A09_AE_01-20180112_62_A2_REG_UNISEX_40x")]


def _import_ppp(pkg, backend, extra):
    rd, shots = _ppp_dir(pkg)
    db = pkg.db_arg(backend) if backend != "json" else None
    out = {}
    for i in range(2 if db else 1):  # a re-import keeps the entity ids
        argv = ["importPPPResults", "-rd", rd, "-od", pkg.root / f"out{i}",
                "--screenshots-dir", shots, *extra]
        out[f"rc{i}"] = pkg.run(*argv, *(["--db", db] if db else []))
        out[f"out{i}"] = tree(pkg.root / f"out{i}")
    return _finish(pkg, db, out)


@pytest.mark.parametrize("backend,extra", [
    ("json", []), ("json", ["--only-best-skeleton-matches"]),
    ("json", ["--em-library", "flyem_x", "--lm-library", "flylight_y",
              "-as", "JRC2018_VNC_Unisex_40x_DS"]),
    ("sqlite", []), ("mongo", [])])
def test_import_ppp_equal_jax(tmp_path, backend, extra):
    got = both(tmp_path, _import_ppp, backend, extra)
    assert got["rc0"] == 0
    files = [k for k in got if k.startswith("out0/")]
    assert sorted(files) == ["out0/1599747200-PFNp_c-RT_18U.json",
                             "out0/484130600-SMP145-RT_18U.json"]
    doc = json.loads(got[files[0]])
    assert doc["results"][0]["class"].endswith("PPPMatchEntity")
    if backend != "json":
        assert got["out0/" + files[0][5:]] == got["out1/" + files[0][5:]]
        assert len({m["sourceEmName"] for m in got["store"]["ppp"]}) == 2


CREATE_CASES = {
    "em": ["--library", "flyem_test", "--cdm-location", CDSEARCH / "ems",
           "--variant", f"grad:{CDSEARCH / 'grad'}"],
    "lm_variants": ["--library", "flylight_test", "--cdm-location",
                    CDSEARCH / "lms", "--variant", f"grad:{CDSEARCH / 'grad'}",
                    "--variant", f"zgap:{CDSEARCH / 'zgap'}"],
    "lm_searchable_junk": [
        "--library", "flylight_test", "--cdm-location", CDSEARCH / "lms",
        "--variant", f"searchable_neurons:{CDSEARCH / 'lms'}",
        "--variant", f"junk:{CDSEARCH / 'zgap'}", "--junk-tag", "jj"],
    "filters": ["--library", "flyem_test", "--cdm-location", CDSEARCH / "ems",
                "--tag", "imported", "--included-published-names", "12191",
                "1752016801", "--excluded-neurons", "1752016801",
                "--match-neuron-state"],
}


def _create(pkg, case, backend):
    db = pkg.db_arg(backend) if backend != "json" else None
    argv = ["createColorDepthSearchDataInput", *CREATE_CASES[case]]
    out = {"rc": pkg.run(*argv, *(["--db", db] if db else
                                  ["-od", pkg.root / "mips"]))}
    out["mips"] = tree(pkg.root / "mips") if not db else {}
    return _finish(pkg, db, out)


@pytest.mark.parametrize("case,backend", [
    ("em", "json"), ("em", "sqlite"), ("em", "mongo"),
    ("lm_variants", "json"), ("lm_variants", "sqlite"),
    ("lm_searchable_junk", "json"), ("filters", "json")])
def test_create_data_input_equal_jax(tmp_path, case, backend):
    got = both(tmp_path, _create, case, backend)
    assert got["rc"] == 0
    if backend == "json":
        (name, data), = [(k, v) for k, v in got.items()
                         if k.startswith("mips/")]
        rows = json.loads(data)
    else:
        rows = got["store"]["neurons"]
    names = {r["publishedName"] for r in rows}
    if case == "em":
        assert len(rows) == 3 and {"12191", "1752016801"} <= names
    elif case == "lm_variants":
        assert len(rows) == 4
        assert any("ZGapImage" in r["computeFiles"] for r in rows)
    elif case == "filters":
        assert names == {"12191"} and all("imported" in r["tags"]
                                          for r in rows)


# ----------------------------------------------------- tag and validate

def _em_mips(pkg):
    assert pkg.run("createColorDepthSearchDataInput", "--library",
                   "flyem_test", "--cdm-location", CDSEARCH / "ems",
                   "-od", pkg.root / "mips") == 0
    return pkg.root / "mips" / "flyem_test.json"


def _tag_validate(pkg, backend):
    mips_file = _em_mips(pkg)
    if backend == "json":
        src = ["--mips-file", mips_file]
        db = None
    else:
        db = pkg.db_arg(backend)
        w = pkg.db.DBCDMIPsWriter(pkg.store(db))
        w.open()
        w.write(pkg.io.JSONCDMIPsReader(str(mips_file)).read_mips(
            pkg.io.DataSourceParam()))
        w.close()
        src = ["--db", db]
    report = pkg.root / "errors.json"
    out = {"tag": pkg.run("tag", *src, "--tag", "round1", "--names", "12191"),
           "untag": pkg.run("tag", *src, "--tag", "round2", "--remove",
                            "--names", "1752016801"),
           "checked": pkg.run("validateDBData", *src, "--no-grad-files-check",
                              "--check-file-existence",
                              "--error-report", report),
           "checked_report": json.loads(report.read_text()),
           "full": pkg.run("validateDBData", *src, "--error-tag", "bad",
                           "--error-report", report),
           "full_report": json.loads(report.read_text()),
           "mips": tree(pkg.root / "mips")}
    return _finish(pkg, db, out)


@pytest.mark.parametrize("backend", ["json", "sqlite", "mongo"])
def test_tag_and_validate_equal_jax(tmp_path, backend):
    got = both(tmp_path, _tag_validate, backend)
    assert (got["tag"], got["untag"], got["checked"], got["full"]) == \
        (0, 0, 0, 1)
    assert got["checked_report"] == []
    errors = {e["error"] for e in got["full_report"]}
    assert any("GradientImage" in e for e in errors)
    assert any("ZGapImage" in e for e in errors)
    rows = got["store"]["neurons"] if backend != "json" else json.loads(
        got["mips/flyem_test.json"])
    assert {r["publishedName"] for r in rows
            if "round1" in r.get("tags", [])} == {"12191"}


def _validate_store(pkg, backend, fixtures_dir):
    """tests/test_selector_and_validate.py's persisted errors, error tags
    on the entities and their matches, the dangling-ref scan and the
    clearing of corrected entities."""
    db = pkg.db_arg(backend)
    store = pkg.store(db)
    m = pkg.model
    tif = str(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    good = m.EMNeuronEntity(entity_id=1, mip_id="m-good",
                            library_name="libA", published_name="ok")
    for cft in (m.ComputeFileType.InputColorDepthImage,
                m.ComputeFileType.SourceColorDepthImage):
        good.compute_files[cft] = m.FileData.from_string(tif)
    bad = m.EMNeuronEntity(entity_id=2, mip_id="m-bad", library_name="libA",
                           published_name="oops")
    bad.compute_files[m.ComputeFileType.InputColorDepthImage] = \
        m.FileData.from_string("/nonexistent/file.tif")
    orphan = m.LMNeuronEntity(entity_id=3, mip_id="m-t", library_name="libB",
                              published_name="t")
    store.upsert_neurons([good, bad, orphan])
    m1, m2 = m.CDMatchEntity(), m.CDMatchEntity()
    m1.mask_image, m1.matched_image, m1.matching_pixels = bad, orphan, 10
    m2.mask_image, m2.matched_image, m2.matching_pixels = good, orphan, 20
    store.upsert_matches([m1, m2])
    if backend == "sqlite":
        store._conn.execute("DELETE FROM neuron_metadata WHERE entity_id = 3")
        store._conn.commit()
    else:
        store.neurons.delete_many({"_id": 3})
    report = pkg.root / "report.json"
    out = {"rc": pkg.run("validateDBData", "--db", db, "--no-grad-files-check",
                         "--error-tag", "validationError",
                         "--apply-error-tag-to-em-cdmatches",
                         "--check-matches", "--error-report", report),
           "report": json.loads(report.read_text())}
    out["after"] = dump(pkg, store)
    fixed = store.find_neurons(pkg.io.DataSourceParam(mip_ids=["m-bad"]))[0]
    for cft in (m.ComputeFileType.InputColorDepthImage,
                m.ComputeFileType.SourceColorDepthImage):
        fixed.compute_files[cft] = m.FileData.from_string(tif)
    store.upsert_neurons([fixed])
    out["rc_fixed"] = pkg.run("validateDBData", "--db", db,
                              "--no-grad-files-check", "--offset", "0",
                              "--size", "2")
    return _finish(pkg, db, out)


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
def test_validate_store_equal_jax(tmp_path, backend, fixtures_dir):
    got = both(tmp_path, _validate_store, backend, fixtures_dir)
    assert got["rc"] == 1
    by_entity = {}
    for e in got["report"]:
        by_entity.setdefault(e["entity"], []).append(e["error"])
    assert any("not found" in x for x in by_entity["m-bad"])
    assert "m-good" not in by_entity
    assert any("dangling" in "".join(v) for k, v in by_entity.items()
               if k.startswith("match"))
    bad = [n for n in got["after"]["neurons"] if n["mipId"] == "m-bad"][0]
    assert bad["validationErrors"] and "validationError" in bad["tags"]
    final = [n for n in got["store"]["neurons"] if n["mipId"] == "m-bad"][0]
    assert not final.get("validationErrors")


SELECTORS = [["--annotations", "LC10", "--excluded-tags", "bad"],
             ["--excluded-annotations", "LC10"], ["--datasets", "release2"],
             ["--source-refs", "Sample#2"], ["--mip-ids", "mip-1", "mip-4"],
             ["--library", "libB", "--excluded-tags", "bad"],
             ["--names", "name-0", "No Consensus"], ["--tags", "good"],
             ["-as", "JRC2018_Unisex_20x_HR", "--library", "libA"]]


def _tag_selectors(pkg, backend):
    db = pkg.db_arg(backend)
    pkg.store(db).upsert_neurons(pkg.convert(selector_ref._neurons()))
    out = {}
    for i, sel in enumerate(SELECTORS):
        out[f"rc{i}"] = pkg.run("tag", "--db", db, "--tag", f"sel{i}", *sel)
    # removal with selector feedback (the removed tag is in --tags):
    # snapshot paging still covers everything
    out["rm"] = pkg.run("tag", "--db", db, "--tag", "sel0", "--remove",
                        "--tags", "sel0")
    return _finish(pkg, db, out)


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
def test_tag_selectors_equal_jax(tmp_path, backend):
    got = both(tmp_path, _tag_selectors, backend)
    tagged = {i: sorted(n["mipId"] for n in got["store"]["neurons"]
                        if f"sel{i}" in n.get("tags", []))
              for i in range(len(SELECTORS))}
    assert tagged[0] == []  # removed again
    assert tagged[3] == ["mip-2"]
    assert tagged[4] == ["mip-1", "mip-4"]


# ------------------------------------------------------ copyToMipsStore

def _copy_store(pkg):
    mips_file = _em_mips(pkg)
    out = {"rc": pkg.run("copyToMipsStore", "--mips-file", mips_file,
                         "--target-folder", pkg.root / "store",
                         "--update-mips"),
           "simulate": pkg.run("copyToMipsStore", "--mips-file", mips_file,
                               "--target-folder", pkg.root / "sim", "-n")}
    out["store"] = sorted(os.path.relpath(os.path.join(d, f), pkg.root)
                          for d, _, fs in os.walk(pkg.root / "store")
                          for f in fs)
    out["mips"] = tree(pkg.root / "mips")
    out["sim_exists"] = (pkg.root / "sim").exists()
    return out


def _write_mips(pkg, entities, path):
    w = pkg.io.JSONCDMIPsWriter(str(path))
    w.open()
    w.write(entities)
    w.close()


def _copy_lm_rename(pkg, fixtures_dir):
    lm, = pkg.convert([copymips_ref._lm_entity(pkg.root, fixtures_dir)])
    mips_file = pkg.root / "lm_mips.json"
    _write_mips(pkg, [lm], mips_file)
    out = {"rc": pkg.run("copyToMipsStore", "--mips-file", mips_file,
                         "--target-folder", pkg.root / "store",
                         "--update-mips")}
    out["reimport"] = pkg.run(
        "createColorDepthSearchDataInput", "--library", "flylight_reimport",
        "--cdm-location", pkg.root / "store", "-od", pkg.root / "reimport")
    out["files"] = tree(pkg.root / "reimport")
    out["lm_mips"] = json.loads(mips_file.read_text())
    out["store"] = sorted(os.listdir(pkg.root / "store"))
    out["segments"] = sorted(os.listdir(pkg.root / "store" /
                                        "searchable_neurons"))
    return out


def _copy_missing_segment(pkg, fixtures_dir):
    lm, = pkg.convert([copymips_ref._lm_entity(pkg.root, fixtures_dir)])
    bad = pkg.root / ("VT033614_127B01_AE_01-20171124_64_H6-40x-Brain-"
                      "JRC2018_Unisex_20x_HR-2483089192251293794-CH2.tif")
    bad.write_bytes(b"x")
    lm.compute_files[pkg.model.ComputeFileType.InputColorDepthImage] = \
        pkg.model.FileData.from_string(str(bad))
    mips_file = pkg.root / "lm_mips.json"
    _write_mips(pkg, [lm], mips_file)
    store = pkg.root / "store"
    out = {"rc": pkg.run("copyToMipsStore", "--mips-file", mips_file,
                         "--target-folder", store)}
    out["segmented"] = (store / "searchable_neurons").exists()
    out["rc_ignored"] = pkg.run("copyToMipsStore", "--mips-file", mips_file,
                                "--target-folder", store,
                                "--lmIgnoreMissingSegmentation", "-f")
    out["segments"] = sorted(os.listdir(store / "searchable_neurons"))
    return out


def test_copy_to_mips_store_equal_jax(tmp_path):
    got = both(tmp_path, _copy_store)
    assert got["rc"] == got["simulate"] == 0 and not got["sim_exists"]
    assert sum(p.endswith(".tif") for p in got["store"]) >= 3
    assert "<ROOT>/store" in got["mips/flyem_test.json"].decode()


def test_copy_lm_canonical_rename_equal_jax(tmp_path, fixtures_dir):
    got = both(tmp_path, _copy_lm_rename, fixtures_dir)
    assert got["rc"] == got["reimport"] == 0
    assert got["segments"] == [
        "VT033614_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_"
        "20x_HR-2483089192251293794-CH2-1_CDM.tif"]
    rows = json.loads(got["files/flylight_reimport.json"])
    assert "20171124_64_H6" in {r.get("slideCode") for r in rows}


def test_copy_missing_segment_index_equal_jax(tmp_path, fixtures_dir):
    got = both(tmp_path, _copy_missing_segment, fixtures_dir)
    assert got["rc"] == got["rc_ignored"] == 0
    assert not got["segmented"] and got["segments"]


# ------------------------------------------------------ deleteCDMatches

DELETE_CASES = {
    "default": [[]],
    "gradscore_and_match_tags": [["--include-matches-with-gradscore",
                                  "--match-tags", "keepme"]],
    "dry_run_then_no_archive": [["--dry-run"], ["--no-archive"]],
    "target_selector": [["--targets-libraries", "NoSuchLibrary"],
                        ["--targets-libraries",
                         "FlyLight Split-GAL4 Drivers"]],
    "mask_selector_no_match": [["--masks-libraries", "NoSuchLibrary"]],
    "score_filter": [["--max-matching-pixels", "300", "--delete-batch-size",
                      "2", "-ps", "1"]],
}


def _delete_db(pkg, backend, case):
    db = pkg.db_arg(backend)
    store = pkg.store(db)
    pkg.db.DBNeuronMatchesWriter(store).write(
        pkg.convert(delete_ref._matches()))
    out = {}
    for i, extra in enumerate(DELETE_CASES[case]):
        out[f"rc{i}"] = pkg.run("deleteCDMatches", "--db", db, *extra)
        out[f"after{i}"] = dump(pkg, store)
    if backend == "sqlite":
        store.close()
    return out


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
@pytest.mark.parametrize("case", sorted(DELETE_CASES))
def test_delete_store_equal_jax(tmp_path, case, backend):
    got = both(tmp_path, _delete_db, backend, case)
    n = len(delete_ref._matches())
    left = [len(v["matches"]) for k, v in sorted(got.items())
            if k.startswith("after")]
    want = {"default": [5], "gradscore_and_match_tags": [n - 2],
            "dry_run_then_no_archive": [n, 5], "target_selector": [n, 5],
            "mask_selector_no_match": [n]}.get(case)
    if want is not None:
        assert left == want
    if case == "default":
        assert len(got["after0"]["archived"]) == n - 5
    if case == "dry_run_then_no_archive":
        assert got["after1"]["archived"] == []


def _delete_json(pkg, extra_runs):
    md = pkg.root / "matches"
    matches = pkg.convert(delete_ref._matches())
    pkg.io.JSONNeuronMatchesWriter(str(md)).write(matches)
    out = {}
    for i, extra in enumerate(extra_runs):
        extra = [matches[0].mask_image.library_name if a is None else a
                 for a in extra]
        out[f"rc{i}"] = pkg.run("deleteCDMatches", "-md", md, *extra)
        out[f"tree{i}"] = tree(md)
    return out


@pytest.mark.parametrize("runs", [
    [["--masks-libraries", "NoSuchLibrary", "--dry-run"],
     ["--masks-libraries", "NoSuchLibrary"]],
    [["--masks-libraries", None]],
    [["--include-matches-with-gradscore", "--masks-libraries", None,
      "--dry-run"], ["--include-matches-with-gradscore"]]],
    ids=["mask_selector_no_match", "mask_selector_filters", "all"])
def test_delete_json_equal_jax(tmp_path, runs):
    got = both(tmp_path, _delete_json, runs)
    assert all(v == 0 for k, v in got.items() if k.startswith("rc"))


# ------------------------------------------- PPP import -> PPP export

def _ppp_roundtrip(pkg):
    rd, shots = _ppp_dir(pkg)
    db = pkg.db_arg("sqlite")
    out = {}
    for i in range(2):
        out[f"rc{i}"] = pkg.run("importPPPResults", "-rd", rd, "-od",
                                pkg.root / f"ppp_json{i}", "--db", db,
                                "--screenshots-dir", shots)
    urls = pkg.root / "pppm_urls.json"
    urls.write_text(json.dumps(
        [{"id": f"{em}-{lm}",
          "uploadedFiles": {"RAW": f"https://s3/ppp/{em}-{lm}_raw.png",
                            "CH": f"https://s3/ppp/{em}-{lm}_ch.png"},
          "uploadedThumbnails": {"CH": f"https://s3/ppp/{em}-{lm}_ch.jpg"}}
         for em, lm in PPP_PAIRS]))
    samples = pkg.root / "samples.json"
    samples.write_text(json.dumps(
        [{"_id": "101", "name": "BJD_100A01_AE_01-20170929_62_B1",
          "publishingName": "BJD_100A01", "slideCode": "20170929_62_B1",
          "gender": "f"},
         {"_id": "102", "name": "BJD_105A09_AE_01-20180112_62_A2",
          "publishingName": "BJD_105A09", "slideCode": "20180112_62_A2",
          "gender": "m"}]))
    out["rc_export"] = pkg.run(
        "exportData", "--exported-result-type", "EM_PPP_MATCHES", "--db", db,
        "-od", pkg.root / "ppp_export", "--pppm-urls", urls,
        "--jacs-samples-file", samples)
    out["export"] = tree(pkg.root / "ppp_export")
    return _finish(pkg, db, out)


def test_ppp_db_roundtrip(tmp_path):
    """importPPPResults --db (with screenshots, twice), then exportData
    --exported-result-type EM_PPP_MATCHES: byte-equal to the JAX chain."""
    got = both(tmp_path, _ppp_roundtrip)
    assert got["rc0"] == got["rc1"] == got["rc_export"] == 0
    assert sorted(k for k in got if k.startswith("export/")) == \
        ["export/1599747200.json", "export/484130600.json"]
    d = json.loads(got["export/1599747200.json"])
    assert len(d["results"]) == 1
    r = d["results"][0]
    assert r["type"] == "PPPMatch"
    assert r["image"]["publishedName"] == "BJD_100A01"
    assert r["files"]["CDMBestThumbnail"].endswith("_ch.jpg")
    assert sum(1 for m in got["store"]["ppp"]
               if m.get("sourceImageFiles")) == 2
