"""The port's field-update handlers (colormipsearch_torch.dataio.base:
SetField, AppendField, RemoveField, IncField, SetOnCreateField,
UnsetField and apply_field_updates) equal the JAX package's for every
handler kind, on a document that is being created and on one that
exists; and the stores apply them the same way."""

import copy
import json

import pytest

pytest.importorskip("torch")

from colormipsearch_tpu.dataio import base as jax_base  # noqa: E402
from colormipsearch_tpu.dataio import db as jax_db  # noqa: E402
from colormipsearch_tpu.dataio import db_mongo as jax_mongo  # noqa: E402
from colormipsearch_tpu.model import EMNeuronEntity as JaxEM  # noqa: E402

from colormipsearch_torch.dataio import base  # noqa: E402
from colormipsearch_torch.dataio import db as port_db  # noqa: E402
from colormipsearch_torch.dataio import db_mongo as port_mongo  # noqa: E402
from colormipsearch_torch.model import EMNeuronEntity  # noqa: E402

from test_db_mongo import _FakeClient  # noqa: E402

DOCS = [{}, {"tags": ["a", "b"], "useCount": 3, "libraryName": "flyem"},
        {"tags": [], "useCount": None, "history": ["run1"]}]

# per handler kind: (constructor name, args) updates of one field each
HANDLERS = {
    "set": [("SetField", ("renamed",)), ("SetField", (None,)),
            ("SetField", ([1, 2],))],
    "unset": [("UnsetField", ()), ("UnsetField", ())],
    "set_on_create": [("SetOnCreateField", ("libA",)),
                      ("SetOnCreateField", ({"k": 1},))],
    "inc": [("IncField", (2,)), ("IncField", (-5,)), ("IncField", (0.5,))],
    "append": [("AppendField", ("b",)), ("AppendField", (["x", "a", "x"],)),
               ("AppendField", ({"z", "c", "a"},)),
               ("AppendField", (("t", "u"),))],
    "append_push": [("AppendField", ("run1", False)),
                    ("AppendField", (["a", "a"], False)),
                    ("AppendField", ({"q", "a"}, False))],
    "remove": [("RemoveField", ("a",)), ("RemoveField", (["a", "zz"],)),
               ("RemoveField", ({"b"},)), ("RemoveField", (("a", "b"),))],
}
FIELDS = ("tags", "useCount", "libraryName", "history")


def _updates(module, specs, field):
    return {field: getattr(module, name)(*args) for name, args in specs}


@pytest.mark.parametrize("created", [False, True])
@pytest.mark.parametrize("kind", sorted(HANDLERS) + ["unknown"])
def test_apply_field_updates_equals_jax(kind, created):
    for doc in DOCS:
        for field in FIELDS:
            if kind == "unknown":
                got_u = {field: base.FieldUpdate("rename", 1)}
                want_u = {field: jax_base.FieldUpdate("rename", 1)}
                for fn, u in ((base.apply_field_updates, got_u),
                              (jax_base.apply_field_updates, want_u)):
                    with pytest.raises(ValueError, match="unknown"):
                        fn(copy.deepcopy(doc), u, created)
                continue
            for spec in HANDLERS[kind]:
                got_u = _updates(base, [spec], field)
                want_u = _updates(jax_base, [spec], field)
                assert got_u == {field: base.FieldUpdate(
                    *vars(want_u[field]).values())}
                try:
                    want = jax_base.apply_field_updates(
                        copy.deepcopy(doc), want_u, created)
                except TypeError:   # e.g. inc of a list: both refuse
                    with pytest.raises(TypeError):
                        base.apply_field_updates(copy.deepcopy(doc), got_u,
                                                 created)
                    continue
                got = base.apply_field_updates(copy.deepcopy(doc), got_u,
                                               created)
                assert got == want


def test_combined_updates_equal_jax():
    """Several handlers in one update, applied in their order."""
    for created in (False, True):
        for doc in DOCS:
            got = base.apply_field_updates(copy.deepcopy(doc), {
                "tags": base.AppendField(["x"]),
                "useCount": base.SetOnCreateField(9),
                "libraryName": base.SetField("flyem2"),
                "history": base.UnsetField()}, created)
            want = jax_base.apply_field_updates(copy.deepcopy(doc), {
                "tags": jax_base.AppendField(["x"]),
                "useCount": jax_base.SetOnCreateField(9),
                "libraryName": jax_base.SetField("flyem2"),
                "history": jax_base.UnsetField()}, created)
            assert got == want


def _store_docs(base_mod, db_mod, mongo_mod, em_cls, backend, tmp_path):
    """Every handler through update_entity_fields on one store; the neuron
    docs after each step."""
    if backend == "sqlite":
        store = db_mod.SqliteStore(str(tmp_path / f"{db_mod.__name__}.db"))

        def doc(eid):
            row = store._conn.execute(
                "SELECT doc FROM neuron_metadata WHERE entity_id = ?",
                (eid,)).fetchone()
            return row and json.loads(row[0])
    else:
        store = mongo_mod.MongoStore(client=_FakeClient(),
                                     database="neuronbridge")

        def doc(eid):
            got = [dict(d) for d in store.neurons.find({"_id": eid})]
            for d in got:
                d.pop("_id", None)
            return got[0] if got else None
    e = em_cls(entity_id=5, mip_id="em-5", library_name="flyem",
               published_name="n5")
    e.tags = {"a"}
    store.upsert_neurons([e])
    steps = [(5, {"publishedName": base_mod.SetField("renamed")}),
             (5, {"tags": base_mod.AppendField({"a", "b", "c"})}),
             (5, {"history": base_mod.AppendField("run1", add_to_set=False)}),
             (5, {"history": base_mod.AppendField("run1", add_to_set=False)}),
             (5, {"tags": base_mod.RemoveField("b")}),
             (5, {"tags": base_mod.RemoveField(["a", "c", "zz"])}),
             (5, {"useCount": base_mod.IncField(2)}),
             (5, {"useCount": base_mod.IncField(3),
                  "libraryName": base_mod.SetField("flyem2")}),
             (5, {"publishedName": base_mod.UnsetField()}),
             (999, {"tags": base_mod.AppendField(["x"])}),
             (7, {"libraryName": base_mod.SetOnCreateField("libA"),
                  "tags": base_mod.AppendField(["t"])}),
             (7, {"libraryName": base_mod.SetOnCreateField("libB")})]
    out = []
    for eid, updates in steps:
        out.append((bool(store.update_entity_fields("neurons", eid, updates)),
                    doc(eid)))
    return out


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
def test_store_field_updates_equal_jax(tmp_path, backend):
    got = _store_docs(base, port_db, port_mongo, EMNeuronEntity, backend,
                      tmp_path)
    want = _store_docs(jax_base, jax_db, jax_mongo, JaxEM, backend, tmp_path)
    assert got == want
    assert got[-1][1]["libraryName"] == "libA"
