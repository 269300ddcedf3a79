"""The port's exportData (python -m colormipsearch_torch exportData)
against the JAX command on the same inputs: the golden EM export byte for
byte (tests/test_export_golden.py), every --exported-result-type with the
offline enrichment files, the EM PPP export over the SQLite store, the
Mongo fake and a per-mask directory (tests/test_ppp_export.py), and
published data read from a store (tests/test_published_stores.py).
Every case compares the two commands' output files byte for byte."""

import json
import os

import pytest

pytest.importorskip("torch")

from colormipsearch_tpu import dataio as jax_io  # noqa: E402
from colormipsearch_tpu import model as jax_model  # noqa: E402
from colormipsearch_tpu.cmd import backends as jax_backends  # noqa: E402
from colormipsearch_tpu.cmd.main import main as jax_main  # noqa: E402
from colormipsearch_tpu.dataio import db as jax_db  # noqa: E402
from colormipsearch_tpu.dataio import db_mongo as jax_mongo  # noqa: E402

from colormipsearch_torch import dataio as port_io  # noqa: E402
from colormipsearch_torch import model as port_model  # noqa: E402
from colormipsearch_torch.cmd import backends as port_backends  # noqa: E402
from colormipsearch_torch.cmd.main import main  # noqa: E402
from colormipsearch_torch.dataio import db as port_db  # noqa: E402
from colormipsearch_torch.dataio import db_mongo as port_mongo  # noqa: E402

import test_export_golden as golden  # noqa: E402
import test_ppp_export as ppp  # noqa: E402
import test_published_stores as published  # noqa: E402
from test_db_mongo import _FakeClient  # noqa: E402

PACKAGES = {"torch": (port_io, port_db, port_mongo, port_model,
                      port_backends, main),
            "jax": (jax_io, jax_db, jax_mongo, jax_model, jax_backends,
                    jax_main)}
GOLDEN_ARGS = ["--jacs-mips-file", str(golden.GOLDEN_DIR / "jacs_mips.json"),
               "--default-relative-url-index", "3",
               "--default-image-store", "fl:open_data:brain",
               "--image-stores-per-neuron-meta",
               "JRC2018_Unisex_20x_HR:flyem_hemibrain_1_2_1="
               "fl:hemibrain:v1.2.1"]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _convert(model, entities):
    """Entities built by a test module of the JAX package, as `model`'s."""
    return [getattr(model, type(e).__name__).from_dict(e.to_dict())
            for e in entities]


def _store(pkg, backend, tmp_path):
    """(--db argument, store) of one package."""
    _, db, mongo, _, backends, _ = PACKAGES[pkg]
    if backend == "sqlite":
        path = str(tmp_path / f"{pkg}.db")
        return path, db.SqliteStore(path)
    return f"mongodb://{pkg}-export/neuronbridge", mongo.MongoStore(
        client=_FakeClient(), database="neuronbridge")


def _export(pkg, out, args, db=None, store=None):
    """Run the package's exportData into `out`; a Mongo fake store is
    handed to the package's store cache for the run."""
    backends, run = PACKAGES[pkg][4:]
    if db is not None and db.startswith("mongodb://"):
        backends._stores[db] = store
    try:
        assert run(["exportData", "-od", str(out), *args]) == 0
    finally:
        backends._stores.pop(db, None)
    return _tree(out)


def test_em_export_matches_golden_bytes(tmp_path):
    """The golden EM export, from per-mask files the port writes as the
    JAX package does."""
    trees = {}
    for pkg in PACKAGES:
        io, model = PACKAGES[pkg][0], PACKAGES[pkg][3]
        md = tmp_path / pkg / "masks"
        io.JSONNeuronMatchesWriter(str(md)).write(
            _convert(model, golden._build_matches()))
        trees[pkg] = _export(pkg, tmp_path / pkg / "out",
                             ["--exported-result-type", "EM_CD_MATCHES",
                              "-md", str(md), *GOLDEN_ARGS])
    assert _tree(tmp_path / "torch" / "masks") == \
        _tree(tmp_path / "jax" / "masks")
    want = (golden.GOLDEN_DIR / "em-A.golden.json").read_bytes()
    assert trees["torch"] == trees["jax"] == {"em-A.json": want}


def _enrichment_files(tmp_path, matches):
    """Offline published URLs, LM stacks and a library-name mapping for
    the golden matches."""
    urls = tmp_path / "urls.json"
    urls.write_text(json.dumps(
        [{"_id": 11, "uploaded": {"cdm": "https://s3/pub/em/A_CDM.png",
                                  "searchable_neurons":
                                      "https://s3/pub/em/A_sn.png"}},
         {"id": 21, "uploaded": {"cdm": "https://s3/pub/lm/R11_CDM.png",
                                 "searchable_neurons":
                                     "https://s3/pub/lm/R11_sn.png"}}]))
    stacks = tmp_path / "stacks.json"
    stacks.write_text(json.dumps(published.LM_IMAGE_DOCS))
    names = tmp_path / "names.json"
    names.write_text(json.dumps({"flylight_gen1_mcfo": "FlyLight Gen1 MCFO"}))
    mips = tmp_path / "mips.json"
    mips.write_text(json.dumps(
        [matches[0].mask_image.to_dict()]
        + [m.matched_image.to_dict() for m in matches]))
    return ["--published-urls", str(urls), "--published-lm-stacks",
            str(stacks), "--library-name-mapping", str(names),
            "--relative-url-indexes-by-filetype", "CDMInput=2,nonhttp"], mips


@pytest.mark.parametrize("result_type,source", [
    ("EM_CD_MATCHES", "md"), ("EM_CD_MATCHES", "sqlite"),
    ("LM_CD_MATCHES", "md"), ("LM_CD_MATCHES", "sqlite"),
    ("EM_MIPS", "file"), ("LM_MIPS", "file")])
def test_result_types_equal_jax(tmp_path, result_type, source):
    """Every CD and MIP result type, with the offline enrichment files."""
    extra, mips = _enrichment_files(tmp_path, golden._build_matches())
    trees = {}
    for pkg in PACKAGES:
        io, db, _, model = PACKAGES[pkg][:4]
        matches = _convert(model, golden._build_matches())
        if source == "md":
            src = ["-md", str(tmp_path / pkg / "masks")]
            io.JSONNeuronMatchesWriter(src[1]).write(matches)
        elif source == "sqlite":
            path, store = _store(pkg, "sqlite", tmp_path)
            db.DBNeuronMatchesWriter(store).write(matches)
            src = ["--db", path]
        else:
            src = ["--mips-file", str(mips)]
        trees[pkg] = _export(pkg, tmp_path / pkg / "out",
                             ["--exported-result-type", result_type, *src,
                              *GOLDEN_ARGS, *extra])
    assert trees["torch"] and trees["torch"] == trees["jax"]


def _seed_ppp(model, store, urls_for=(ppp.LM_A, ppp.LM_B)):
    """tests/test_ppp_export.py's store: four PPP matches, published URLs
    for some of them, published LM images."""
    matches = _convert(model, ppp._build_matches())
    assert store.upsert_ppp_matches(matches) == 4
    store.upsert_pppm_urls([ppp._pppm_urls_doc(m.entity_id, m.source_lm_name)
                            for m in matches if m.source_lm_name in urls_for])
    store.upsert_published_lm_images(ppp.LM_IMAGE_DOCS)


PPP_CASES = {
    "full_pipeline": (ppp.SAMPLE_DOCS, (ppp.LM_A, ppp.LM_B),
                      ["--published-alignment-space-alias",
                       f"{ppp.ALIGNMENT_SPACE}=JRC2018_Unisex_HR",
                       "--default-relative-url-index", "1",
                       "--default-image-store", "fl:open_data:brain"]),
    "same_name_cap": (ppp.SAMPLE_DOCS, (ppp.LM_A, ppp.LM_B, ppp.LM_D),
                      ["--max-matches-with-same-name-per-mip", "1"]),
    "missing_sample": ([ppp.SAMPLE_DOCS[0], ppp.SAMPLE_DOCS[2]],
                       (ppp.LM_A, ppp.LM_B), []),
    "library_name_mapping": (ppp.SAMPLE_DOCS, (ppp.LM_A, ppp.LM_B),
                             ["--library-name-mapping", None]),
}


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
@pytest.mark.parametrize("case", sorted(PPP_CASES))
def test_ppp_export_equal_jax(tmp_path, case, backend):
    """The EM PPP export reads its PPP rows from the store."""
    samples_docs, urls_for, extra = PPP_CASES[case]
    samples = tmp_path / "samples.json"
    samples.write_text(json.dumps(samples_docs))
    if None in extra:
        mapping = tmp_path / "libnames.json"
        mapping.write_text(json.dumps({
            "flyem_hemibrain_1_2_1": "FlyEM Hemibrain v1.2.1",
            "flylight_split_gal4_published": "FlyLight Split-GAL4 Drivers"}))
        extra = [str(mapping) if a is None else a for a in extra]
    trees = {}
    for pkg in PACKAGES:
        db, store = _store(pkg, backend, tmp_path)
        _seed_ppp(PACKAGES[pkg][3], store, urls_for)
        trees[pkg] = _export(pkg, tmp_path / pkg,
                             ["--exported-result-type", "EM_PPP_MATCHES",
                              "--db", db, "--jacs-samples-file",
                              str(samples), *extra], db, store)
    assert list(trees["torch"]) == ["2941323.json"]
    assert trees["torch"] == trees["jax"]


def test_ppp_export_offline_dir_equal_jax(tmp_path):
    """PPP matches from a per-mask directory, with offline pppmURLs and
    published LM images: no store."""
    matches = ppp._build_matches()
    mdir = tmp_path / "matches"
    mdir.mkdir()
    (mdir / f"{ppp.EM_NAME}.json").write_text(json.dumps(
        {"inputImage": matches[0].mask_image.to_dict(),
         "results": [m.to_dict() for m in matches]}))
    files = {}
    for name, docs in (("samples", ppp.SAMPLE_DOCS),
                       ("urls", [ppp._pppm_urls_doc(f"{ppp.EM_NAME}-{n}", n)
                                 for n in (ppp.LM_A, ppp.LM_B)]),
                       ("images", ppp.LM_IMAGE_DOCS)):
        files[name] = tmp_path / f"{name}.json"
        files[name].write_text(json.dumps(docs))
    args = ["--exported-result-type", "EM_PPP_MATCHES", "-md", str(mdir),
            "--jacs-samples-file", str(files["samples"]),
            "--pppm-urls", str(files["urls"]),
            "--published-lm-images", str(files["images"])]
    trees = {pkg: _export(pkg, tmp_path / pkg, args) for pkg in PACKAGES}
    assert list(trees["torch"]) == ["2941323.json"]
    assert trees["torch"] == trees["jax"]


@pytest.mark.parametrize("case", ["sqlite", "mongo", "file_args"])
def test_published_data_from_store_equal_jax(tmp_path, case):
    """Published URLs and LM stacks read from the store (both backends),
    and JSON file arguments taking precedence over the store."""
    override = tmp_path / "urls.json"
    override.write_text(json.dumps(
        [{"_id": 11, "uploaded": {"cdm": "https://s3/override/em.png"}}]))
    trees = {}
    for pkg in PACKAGES:
        db_mod, model = PACKAGES[pkg][1], PACKAGES[pkg][3]
        db, store = _store(pkg, "sqlite" if case == "file_args" else case,
                           tmp_path)
        store.upsert_published_urls(published.URL_DOCS)
        if case != "file_args":
            store.upsert_published_lm_images(published.LM_IMAGE_DOCS)
        matches = _convert(model, published._build_matches())
        store.upsert_neurons([matches[0].mask_image]
                             + [m.matched_image for m in matches])
        db_mod.DBNeuronMatchesWriter(store).write(matches)
        extra = ["--published-urls", str(override)] \
            if case == "file_args" else []
        trees[pkg] = _export(pkg, tmp_path / pkg,
                             ["--exported-result-type", "EM_CD_MATCHES",
                              "--db", db, *extra], db, store)
    assert list(trees["torch"]) == ["em-A.json"]
    assert trees["torch"] == trees["jax"]
    doc = json.loads(trees["torch"]["em-A.json"])
    assert doc["inputImage"]["files"]["CDM"] == (
        "https://s3/override/em.png" if case == "file_args"
        else "https://s3/pub/em/1001_CDM.png")
