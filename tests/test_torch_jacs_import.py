"""The port's JACS import against the JAX package's, over the in-process
JACS fake of tests/test_jacs_client.py on localhost: the paged MIP
listing, createColorDepthSearchDataInput --jacs-url (JSON and --db, with
the EM and LM entity mapping, which test_torch_host_copies.py also
pins) and validateDBData's JACS lookups give equal entities, files,
reports and store rows."""

import json

import pytest

pytest.importorskip("torch")

from colormipsearch_tpu import jacs as jax_jacs  # noqa: E402

from colormipsearch_torch import jacs as port_jacs  # noqa: E402

import test_jacs_client as ref  # noqa: E402
from test_jacs_client import jacs_server  # noqa: E402,F401
from test_torch_aux_cmds import both, fixed_ids, tree  # noqa: E402,F401


def test_paged_listing_equal_jax(jacs_server):  # noqa: F811
    """Three pages of two, the auth header on every request, the count."""
    got = {}
    for name, j in (("torch", port_jacs), ("jax", jax_jacs)):
        ref._Handler.seen_auth = []
        client = j.JacsClient(jacs_server, authorization="Bearer tok",
                              page_size=2)
        mips = client.retrieve_color_depth_mips_with_samples(
            "flyem_hemibrain", "JRC2018_Unisex_20x_HR")
        got[name] = ([m.id for m in mips], len(ref._Handler.seen_auth),
                     set(ref._Handler.seen_auth),
                     client.count_color_depth_mips(
                         "flyem_hemibrain", "JRC2018_Unisex_20x_HR"),
                     # the fake serves an id-set fetch as one page
                     [m.id for m in j.JacsClient(jacs_server)
                      .retrieve_color_depth_mips_with_samples(
                          None, None, mip_ids=["lm-2", "em-9", ""])])
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == ([f"em-{i}" for i in range(5)], 3,
                                {"Bearer tok"}, 5)


def _jacs_import(pkg, server, library, backend, extra):
    db = pkg.db_arg(backend) if backend != "json" else None
    out_file = pkg.root / "mips.json"
    rc = pkg.run("createColorDepthSearchDataInput", "--library", library,
                 "--jacs-url", server, "--authorization", "Bearer tok",
                 *extra, *(["--db", db] if db else
                           ["--output-filename", out_file]))
    out = {"rc": rc, "files": tree(pkg.root)}
    if db:
        store = pkg.store(db)
        out["neurons"] = sorted(
            (n.to_dict() for n in store.find_neurons(
                pkg.io.DataSourceParam())),
            key=lambda d: json.dumps(d, sort_keys=True))
        if backend == "sqlite":
            store.close()
    return out


@pytest.mark.parametrize("library,backend,extra", [
    ("flyem_hemibrain", "json", []),
    ("flylight_gen1_mcfo", "json", []),
    ("flyem_hemibrain", "json", ["--tag", "v1", "--included-published-names",
                                 "1000", "1001", "1002",
                                 "--excluded-neurons", "1001"]),
    ("flyem_hemibrain", "sqlite", ["--datasets", "hemibrain:v1.2.1",
                                   "--releases", "r1"]),
    ("flylight_gen1_mcfo", "mongo", ["-as", "JRC2018_VNC_Unisex_40x_DS"])])
def test_jacs_import_equal_jax(tmp_path, jacs_server, library,  # noqa: F811
                               backend, extra):
    got = both(tmp_path, _jacs_import, jacs_server, library, backend,
               extra)
    assert got["rc"] == 0
    rows = (json.loads(got["files/mips.json"]) if backend == "json"
            else got["neurons"])
    if library == "flyem_hemibrain" and not extra:
        assert len(rows) == 5 and rows[0]["publishedName"] == "1000"
    elif library == "flylight_gen1_mcfo":
        assert [r["publishedName"] for r in rows] == ["R12A34"]
    elif "--tag" in extra:
        assert sorted(r["publishedName"] for r in rows) == ["1000", "1002"]


def _validate_jacs(pkg, server, extra):
    db = pkg.db_arg("sqlite")
    store = pkg.store(db)
    m = pkg.model
    neurons = [m.EMNeuronEntity(entity_id=10 + i, mip_id=f"em-{i}",
                                library_name="flyem_hemibrain",
                                published_name=f"{1000 + i}")
               for i in range(3)]
    neurons += [m.LMNeuronEntity(entity_id=20, mip_id="lm-1",
                                 library_name="flylight_gen1_mcfo",
                                 published_name="R12A34"),
                m.LMNeuronEntity(entity_id=21, mip_id="lm-404",
                                 library_name="flylight_gen1_mcfo",
                                 published_name="gone")]
    store.upsert_neurons(neurons)
    store.close()
    report = pkg.root / "report.json"
    rc = pkg.run("validateDBData", "--db", db, "--jacs-url", server,
                 "--no-grad-files-check", "--no-check-file-existence",
                 "--error-tag", "jacs", "--error-report", report, *extra)
    out = {"rc": rc, "report": json.loads(report.read_text())}
    store = pkg.store(db)
    out["neurons"] = sorted((n.to_dict() for n in store.find_neurons(
        pkg.io.DataSourceParam())), key=lambda d: d["mipId"])
    store.close()
    return out


@pytest.mark.parametrize("extra", [
    [], ["--excluded-libraries", "flyem_hemibrain", "--library",
         "flylight_gen1_mcfo"]])
def test_validate_jacs_lookups_equal_jax(tmp_path, jacs_server,  # noqa: F811
                                         extra):
    got = both(tmp_path, _validate_jacs, jacs_server, extra)
    assert got["rc"] == 1
    errors = {}
    for e in got["report"]:
        errors.setdefault(e["entity"], []).append(e["error"])
    assert any("No color depth mip in JACS" in x for x in errors["lm-404"])
    if not extra:
        assert "em-0" in errors  # the fake lists no library membership
