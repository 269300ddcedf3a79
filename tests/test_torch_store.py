"""The port's store layer (colormipsearch_torch.dataio.db and db_mongo)
against the JAX package's: the DAO scenarios of tests/test_dataio_db.py
and tests/test_db_mongo.py run through both packages' stores, on SQLite
and on the in-process pymongo fake, and what each reads back is equal.
Generated entity ids differ between runs, so they are compared by the
rows they link, not by value."""

import json
import pathlib

import pytest

pytest.importorskip("torch")

from colormipsearch_tpu import dataio as jax_io  # noqa: E402
from colormipsearch_tpu import model as jax_model  # noqa: E402
from colormipsearch_tpu.dataio import db as jax_db  # noqa: E402
from colormipsearch_tpu.dataio import db_mongo as jax_mongo  # noqa: E402

from colormipsearch_torch import dataio as port_io  # noqa: E402
from colormipsearch_torch import model as port_model  # noqa: E402
from colormipsearch_torch.dataio import db as port_db  # noqa: E402
from colormipsearch_torch.dataio import db_mongo as port_mongo  # noqa: E402

from test_db_mongo import _FakeClient  # noqa: E402

FIXTURE = (pathlib.Path(__file__).parent / "fixtures" / "cdsmatches" /
           "testcdsmatches.json")
PACKAGES = {"torch": (port_io, port_db, port_mongo, port_model),
            "jax": (jax_io, jax_db, jax_mongo, jax_model)}
_IDS = {"id", "maskImageRefId", "matchedImageRefId", "sessionRefId", "_id"}


def _open(pkg, backend, tmp_path):
    _, db, mongo, _ = PACKAGES[pkg]
    if backend == "sqlite":
        return db.SqliteStore(str(tmp_path / f"{pkg}.db"))
    return mongo.MongoStore(client=_FakeClient(), database="neuronbridge")


def _canon(doc):
    """A doc without its generated ids."""
    if isinstance(doc, dict):
        return {k: _canon(v) for k, v in doc.items() if k not in _IDS}
    if isinstance(doc, list):
        return [_canon(v) for v in doc]
    return doc


def _linked(matches):
    """Each match as its canonical doc, checking that its refs name the
    neurons embedded in it."""
    out = []
    for m in matches:
        assert m.mask_ref() == m.mask_image.entity_id
        assert m.matched_ref() == m.matched_image.entity_id
        out.append(_canon(m.to_dict()))
    return out


def _fixture_matches(model):
    with open(FIXTURE) as f:
        return [model.CDMatchEntity.from_dict(d) for d in json.load(f)]


def _roundtrip_and_upsert(pkg, store):
    io, db, _, model = PACKAGES[pkg]
    matches = _fixture_matches(model)
    writer = db.DBNeuronMatchesWriter(store)
    reader = db.DBNeuronMatchesReader(store)
    out = {"written": writer.write(matches)}
    mips = reader.list_match_locations([io.DataSourceParam()])
    sel = io.DataSourceParam(mip_ids=mips)
    out["first"] = _linked(reader.read_matches_by_mask(sel))
    out["rewritten"] = writer.write(matches)
    out["second"] = _linked(reader.read_matches_by_mask(sel))
    for m in matches:
        m.normalized_score = 42.0
    writer.write_updates(matches, ["normalizedScore"])
    out["updated"] = _linked(reader.read_matches_by_mask(sel))
    strong = io.ScoresFilter().add("matchingPixels", 100)
    out["strong"] = _linked(reader.read_matches_by_mask(
        sel, scores_filter=strong))
    out["targets"] = reader.list_target_locations([io.DataSourceParam()])
    target = out["targets"][0]
    out["by_target"] = _linked(reader.read_matches_by_target(
        io.DataSourceParam(mip_ids=[target])))
    out["deleted"] = store.delete_matches(max_pixels=100)
    out["mips"] = mips
    return out


def _neuron_selectors(pkg, store):
    io, db, _, model = PACKAGES[pkg]
    matches = _fixture_matches(model)
    entities = [m.mask_image for m in matches] + \
        [m.matched_image for m in matches]
    w = db.DBCDMIPsWriter(store)
    w.write(entities)
    w.add_processing_tags(entities[:3], model.ProcessingType.ColorDepthSearch,
                          {"t1"})
    r = db.DBCDMIPsReader(store)

    def read(**kw):
        return sorted((_canon(e.to_dict()) for e in r.read_mips(
            io.DataSourceParam(**kw))), key=json.dumps)

    return {"library": read(libraries=["FlyEM_Hemibrain_v1.2.1"]),
            "tagged": read(tags={"t1"}),
            "untagged": read(excluded_tags={"t1"}),
            "sliced": len(r.read_mips(io.DataSourceParam(offset=2, size=3))),
            "libraries": store.distinct_neuron_values("library_name")}


def _update_scores_only(pkg, store):
    _, db, _, model = PACKAGES[pkg]
    matches = _fixture_matches(model)
    writer = db.DBNeuronMatchesWriter(store)
    writer.write(matches)
    for m in matches:
        m.gradient_area_gap = 12345
        m.normalized_score = 88.5
    writer.write_updates(matches, ["gradientAreaGap", "normalizedScore"])
    rerun = [model.CDMatchEntity.from_dict(m.to_dict()) for m in matches]
    for m in rerun:
        m.matching_pixels = (m.matching_pixels or 0) + 1
    db.DBNeuronMatchesWriter(store, update_scores_only=True).write(rerun)
    reader = db.DBNeuronMatchesReader(store)
    io = PACKAGES[pkg][0]
    read = reader.read_matches_by_mask(io.DataSourceParam(
        mip_ids=reader.list_match_locations([io.DataSourceParam()])))
    assert all(m.gradient_area_gap == 12345 and m.normalized_score == 88.5
               for m in read)
    return _linked(read)


def _session_provenance(pkg, store):
    model = PACKAGES[pkg][3]
    s = model.CDSSessionEntity(username="tester",
                               params={"xyShift": 2, "mirrorMask": True},
                               masks=[{"file": "m.json"}],
                               targets=[{"file": "t.json"}])
    sid = store.create_session(s)
    assert sid == s.entity_id
    docs = store.list_sessions()
    assert [d.get("id", d.get("_id")) for d in docs] in ([sid], [str(sid)])
    return [_canon(d) for d in docs]


def _ppp_rows_and_urls(pkg, store):
    model = PACKAGES[pkg][3]
    ms = [model.PPPMatchEntity(source_em_name="em-A",
                               source_lm_name=f"lm-{i}", rank=float(i),
                               cov_score=-100.0 - i)
          for i in range(3)]
    ms[0].add_source_image_file("em-A-lm-0_1_raw.png")
    out = {"upserted": store.upsert_ppp_matches(ms)}
    ids = [m.entity_id for m in ms]
    ms2 = [model.PPPMatchEntity(source_em_name="em-A",
                                source_lm_name=f"lm-{i}", rank=float(i),
                                cov_score=-200.0 - i)
           for i in range(3)]
    store.upsert_ppp_matches(ms2)
    assert [m.entity_id for m in ms2] == ids    # natural-key re-import
    got = store.find_ppp_matches_by_em("em-A")
    assert [m.entity_id for m in got] == ids
    out["em_names"] = store.list_ppp_em_names()
    out["rows"] = [_canon(m.to_dict()) for m in got]
    docs = [{"_id": i, "uploadedFiles": {"RAW": f"https://s3/{k}_raw.png"},
             "uploadedThumbnails": {"CH": f"https://s3/{k}_ch.jpg"}}
            for k, i in enumerate(ids[:2])]
    out["urls_upserted"] = store.upsert_pppm_urls(docs)
    store.upsert_pppm_urls([{"_id": ids[0], "uploadedFiles": {"RAW": "u2"}}])
    found = store.find_pppm_urls_by_ids(ids)
    # keyed by the match ids, in match order
    out["urls"] = [_canon(found.get(str(i))) for i in ids]
    out["no_urls"] = store.find_pppm_urls_by_ids([])
    return out


def _published(pkg, store):
    urls = [{"_id": 11, "uploaded": {"cdm": "https://s3/em.png"}},
            {"id": 21, "uploaded": {"cdm": "https://s3/lm.png"}}]
    images = [{"sampleRef": "Sample#1", "slideCode": "s1", "objective": "40x",
               "alignmentSpace": "JRC2018_Unisex_20x_HR",
               "files": {"VisuallyLosslessStack": "https://s3/a1.h5j"}},
              {"sampleRef": "Sample#2", "slideCode": "s2", "objective": "63x",
               "alignmentSpace": "JRC2018_Unisex_20x_HR",
               "files": {"Gal4Expression": "https://s3/g2.png"}}]
    out = {"urls": store.upsert_published_urls(urls),
           "images": store.upsert_published_lm_images(images)}
    store.upsert_published_urls([{"_id": 11, "uploaded": {"cdm": "u2"}}])
    out["loaded_urls"] = store.load_published_urls()
    out["stacks"] = store.load_published_lm_stacks()
    out["by_ref"] = [_canon(d) for d in store.find_published_lm_images(
        sample_refs=["Sample#2"])]
    out["none"] = store.find_published_lm_images(sample_refs=["Sample#2"],
                                                 objective="40x")
    return out


def _bulk_write(pkg, store):
    """Many matches written, updated and deleted in batches; on the Mongo
    fake, every batch is one bulk_write."""
    _, db, _, model = PACKAGES[pkg]
    matches = _fixture_matches(model)
    db.DBNeuronMatchesWriter(store).write(matches)
    for m in matches:
        m.gradient_area_gap = 7
    out = {"updated": store.update_match_fields(matches, ["gradientAreaGap"])}
    for m in matches:
        m.matching_pixels = (m.matching_pixels or 0) + 1
    out["rescored"] = store.upsert_matches(matches, update_scores_only=True)
    read = store.find_matches_by_mask_refs(
        sorted({m.mask_ref() for m in matches}))
    out["read"] = sorted((json.dumps(d) for d in _linked(read)))
    ids = sorted(m.entity_id for m in matches)[:3]
    out["deleted"] = store.delete_matches_by_ids(ids)
    assert sorted(store.archived_match_ids()) == ids
    out["dangling"] = store.find_dangling_match_refs()
    if hasattr(store, "matches"):   # the Mongo fake logs its operations
        out["ops"] = (list(store.matches.op_log),
                      list(store._db["cdMatchesArchive"].op_log),
                      all(isinstance(e, tuple)
                          for e in store.neurons.op_log))
    return out


SCENARIOS = {"roundtrip_and_upsert": _roundtrip_and_upsert,
             "neuron_selectors": _neuron_selectors,
             "update_scores_only": _update_scores_only,
             "session_provenance": _session_provenance,
             "ppp_rows_and_urls": _ppp_rows_and_urls,
             "published_data": _published,
             "bulk_write": _bulk_write}


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_store_scenario(tmp_path, scenario, backend):
    """One DAO scenario through both packages' stores reads back equal."""
    got = SCENARIOS[scenario]("torch", _open("torch", backend, tmp_path))
    want = SCENARIOS[scenario]("jax", _open("jax", backend, tmp_path))
    assert got == want


def test_open_store_dispatch(tmp_path):
    """A path opens SQLite; a mongodb:// URI needs pymongo, which is not
    installed: both packages refuse it the same way."""
    assert isinstance(port_mongo.open_store(str(tmp_path / "x.db")),
                      port_db.SqliteStore)
    for mongo in (port_mongo, jax_mongo):
        with pytest.raises(RuntimeError, match="pymongo"):
            mongo.open_store("mongodb://localhost/neuronbridge")


def test_sqlite_store_is_shared_by_processes(tmp_path):
    """The WAL journal and the 60 s busy timeout that let concurrent grid
    processes write one file."""
    store = port_db.SqliteStore(str(tmp_path / "w.db"))
    assert store._conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    assert store._conn.execute("PRAGMA busy_timeout").fetchone()[0] == 60000
    store.close()
