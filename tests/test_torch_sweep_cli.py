"""The slice as a whole: the port's TwoPhaseSweep equals the JAX package's
(Pallas kernels interpreted) on a small library, and the port's CLI on
the golden fixtures gives 439/414/426 and the same per-mask result JSON
as the reference CLI, apart from session ids."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9  # noqa: E402
from colormipsearch_tpu.cds.pixel_pallas import \
    ActiveTilePixelEngine as RefEngine  # noqa: E402
from colormipsearch_tpu.cds.prescreen import \
    PairPrescreen as RefPrescreen  # noqa: E402
from colormipsearch_tpu.cmd.main import main as ref_main  # noqa: E402
from colormipsearch_tpu.dataio import JSONCDMIPsWriter  # noqa: E402
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402
from colormipsearch_tpu.model import (ComputeFileType,  # noqa: E402
                                      EMNeuronEntity, FileData, Gender,
                                      LMNeuronEntity)
from colormipsearch_tpu.parallel.pallas_sweep import \
    TwoPhaseSweep as RefSweep  # noqa: E402

from colormipsearch_torch.cds.pixel_active import \
    ActiveTilePixelEngine  # noqa: E402
from colormipsearch_torch.cds.prescreen import PairPrescreen  # noqa: E402
from colormipsearch_torch.cmd.main import main  # noqa: E402
from colormipsearch_torch.parallel.twophase_sweep import (  # noqa: E402
    TwoPhaseSweep, device_blocks)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(17)
    h, w = 48, 160
    masks = []
    for _ in range(5):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.8] = 0
        masks.append(q)
    targets = rng.integers(0, 256, size=(29, h, w, 3)).astype(np.uint8)
    targets[rng.random((29, h, w)) < 0.7] = 0
    targets = targets[:16]
    # odd targets keep one 10x24 stripe: their bounds fall below the
    # keep threshold, so the screen has pairs to drop
    for i in range(1, 16, 2):
        b0, c0 = (13 * i) % (h - 10), (41 * i) % (w - 24)
        stripe = targets[i, b0:b0 + 10, c0:c0 + 24].copy()
        targets[i] = 0
        targets[i, b0:b0 + 10, c0:c0 + 24] = stripe
    return masks, targets


def _screen_inputs(cls, engines, h, w, words):
    screen = cls(z_tolerance_to_zt9(1.0), 2, h, w)
    u = np.stack([screen.query_features(words(e)) for e in engines])
    thr = np.maximum(0.05 * np.array([e.tiles.query_size for e in engines]),
                     0.5)
    return screen, u, thr


def test_device_blocks():
    assert device_blocks(10, 3) == [(0, 4), (4, 3), (7, 3)]
    assert device_blocks(2, 4) == [(0, 1), (1, 1), (2, 0), (2, 0)]


def test_twophase_sweep_matches_reference(library):
    masks, targets = library
    h, w = targets.shape[1:3]
    ref_engines = [RefEngine(image_from_array(q), 20, True, 20, 1.0, 2, None,
                             interpret=True) for q in masks]
    screen, u, thr = _screen_inputs(RefPrescreen, ref_engines, h, w,
                                    lambda e: e.planes.words)
    want_s, want_m = RefSweep(ref_engines, screen, u, thr,
                              devices=jax.devices()[:1]).sweep(targets)
    engines = [ActiveTilePixelEngine(image_from_array(q), 20, True, 20, 1.0,
                                     2, None) for q in masks]
    screen_t, u_t, thr_t = _screen_inputs(PairPrescreen, engines, h, w,
                                          lambda e: e.planes.words)
    np.testing.assert_array_equal(u_t, u)
    stage = {}
    # two target shards (both on the CPU) exercise the device split
    got_s, got_m = TwoPhaseSweep(engines, [CPU, CPU], screen_t, u_t,
                                 thr_t).sweep(targets, stage)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_m, want_m)
    assert stage["screened"] > 0
    assert {"pack", "pad", "bound", "live", "launch"} <= set(stage)
    # without the screen every pair is scored: the scores of screened-out
    # pairs appear, the survivors' are unchanged
    all_s, all_m = TwoPhaseSweep(engines, [CPU]).sweep(targets)
    kept = want_s > 0
    np.testing.assert_array_equal(all_s[kept], want_s[kept])
    np.testing.assert_array_equal(all_m[kept], want_m[kept])
    assert (all_s >= want_s).all()


LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, fixtures_dir):
    """The three-fixture workspace of tests/test_cli_e2e.py."""
    ws = tmp_path_factory.mktemp("torch-cds")
    em = EMNeuronEntity(entity_id=1001, mip_id="em-12191",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="flyem_test", published_name="12191")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(str(fixtures_dir / "ems" / "12191_JRC2018U.tif"))
    targets = []
    for i, name in enumerate(LM_NAMES):
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=name.split("_")[0],
                            slide_code=f"sc-{i}", anatomical_area="Brain",
                            gender=Gender.f, objective="40x")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "lms" / f"{name}.tif"))
        targets.append(lm)
    for fname, ents in (("masks.json", [em]), ("targets.json", targets)):
        w = JSONCDMIPsWriter(str(ws / fname))
        w.open()
        w.write(ents)
        w.close()
    return ws


def _search_args(ws, out, *extra):
    return ["colorDepthSearch", "-m", os.path.join(ws, "masks.json"),
            "-i", os.path.join(ws, "targets.json"), "--maskThreshold", "20",
            "--dataThreshold", "20", "--pixColorFluctuation", "1",
            "--xyShift", "2", "--mirrorMask", "--processing-tag", "golden",
            "-od", out, *extra]


def _without_session(doc):
    if isinstance(doc, dict):
        return {k: _without_session(v) for k, v in doc.items()
                if k != "sessionRefId"}
    if isinstance(doc, list):
        return [_without_session(v) for v in doc]
    return doc


@pytest.mark.parametrize("prescreen", ["on", "off"])
def test_cli_goldens_match_reference(workspace, tmp_path, prescreen):
    ws = str(workspace)
    out = str(tmp_path / "torch_out")
    assert main(_search_args(ws, out, "--device", "cpu",
                             "--prescreen", prescreen)) == 0
    with open(os.path.join(out, "masks", "em-12191.json")) as f:
        got = json.load(f)
    res = {r["image"]["mipId"]: r for r in got["results"]}
    assert [res[k]["matchingPixels"] for k in ("lm-0", "lm-1", "lm-2")] == \
        [439, 414, 426]
    assert res["lm-2"]["mirrored"] is True
    assert res["lm-0"]["mirrored"] is False
    ref_out = str(tmp_path / "ref_out")
    assert ref_main(_search_args(ws, ref_out)) == 0
    with open(os.path.join(ref_out, "masks", "em-12191.json")) as f:
        want = json.load(f)
    assert _without_session(got) == _without_session(want)


# every option of these cases was refused until the port had it (the
# dense engine, the multi-process layer, the store layer): they all run;
# --mips-storage db refuses only without a --db store to read from


def _store_rows(db):
    from colormipsearch_torch.dataio import DataSourceParam
    from colormipsearch_torch.dataio.db import (DBNeuronMatchesReader,
                                                SqliteStore)
    store = SqliteStore(db)
    rows = DBNeuronMatchesReader(store).read_matches_by_mask(
        DataSourceParam(mip_ids=["em-12191"]))
    store.close()
    return [(m.matched_image.mip_id, m.matching_pixels, m.mirrored,
             sorted(m.tags)) for m in rows]


@pytest.mark.parametrize("argv,needle", [
    (["--engine", "dense"], "--engine dense"),
    (["--jax-distributed"], "multi-host"),
    (["--db", "store.db"], "--db"),
    (["--mips-storage", "db"], "--mips-storage db"),
    (["--update-matches"], "--update-matches"),
    (["--write-batch-size", "100"], "--write-batch-size"),
])
def test_cli_refusals_name_roadmap(workspace, tmp_path, argv, needle):
    """Each option runs and gives the reference CLI's results: --engine
    dense, --jax-distributed in one process (no CMS_COORDINATOR: no group
    to join), --update-matches and --write-batch-size write the reference's
    files; --db stores its rows; --mips-storage db refuses without --db,
    before any work, and with it reads the MIPs from the store by
    library."""
    ws = str(workspace)
    out = tmp_path / "o"
    db = str(tmp_path / "store.db")
    args = _search_args(ws, str(out), "--device", "cpu",
                        *[db if a == "store.db" else a for a in argv])
    if needle == "--mips-storage db":
        with pytest.raises(SystemExit, match="requires --db"):
            main(args)
        assert not out.exists()  # refused before any work
        from colormipsearch_torch.dataio import (DataSourceParam,
                                                 JSONCDMIPsReader)
        from colormipsearch_torch.dataio.db import (DBCDMIPsWriter,
                                                    SqliteStore)
        store = SqliteStore(db)
        for name in ("masks.json", "targets.json"):
            DBCDMIPsWriter(store).write(JSONCDMIPsReader(os.path.join(
                ws, name)).read_mips(DataSourceParam()))
        store.close()
        args = ["colorDepthSearch", "-m", "flyem_test", "-i",
                "flylight_test", *_search_args(ws, str(out))[5:],
                "--device", "cpu", "--mips-storage", "db", "--db", db]
    assert main(args + ["--maskBatchSize", "1"]) == 0
    ref_out = tmp_path / "ref"
    assert ref_main(_search_args(ws, str(ref_out))) == 0
    with open(ref_out / "masks" / "em-12191.json") as f:
        want = _without_session(json.load(f))
    assert [r["matchingPixels"] for r in want["results"]] == [439, 426, 414]
    if "--db" in args:
        assert not out.exists()  # the store takes the results
        assert _store_rows(db) == [
            (r["image"]["mipId"], r["matchingPixels"], r["mirrored"],
             ["golden"]) for r in want["results"]]
        return
    with open(out / "masks" / "em-12191.json") as f:
        assert _without_session(json.load(f)) == want


def test_gradient_scores_refused(tmp_path):
    """gradientScores refuses without matches to read (neither -md nor
    --db); with --db it reads the store, not -md: an empty store leaves
    the -md files untouched."""
    with pytest.raises(SystemExit, match="--db"):
        main(["gradientScores", "--device", "cpu"])
    md = tmp_path / "masks"
    md.mkdir()
    (md / "em-1.json").write_text("{}")
    assert main(["gradientScores", "-md", str(md), "--db",
                 str(tmp_path / "x.db"), "--device", "cpu"]) == 0
    assert (md / "em-1.json").read_text() == "{}"


def test_sweep_parts_pipelines_partitions(library):
    """sweep_parts yields each partition's sweep, in order, with its key."""
    masks, targets = library
    h, w = targets.shape[1:3]
    engines = [ActiveTilePixelEngine(q, 20, True, 20, 1.0, 2) for q in masks]
    screen, u, thr = _screen_inputs(PairPrescreen, engines, h, w,
                                    lambda e: e.planes.words)
    sweep = TwoPhaseSweep(engines, [CPU], screen, u, thr)
    parts = [("a", targets[:6]), ("b", targets[6:11]), ("c", targets[11:])]
    got = list(sweep.sweep_parts(parts))
    assert [k for k, _, _ in got] == ["a", "b", "c"]
    for (_, s, m), (_, tp) in zip(got, parts):
        want_s, want_m = sweep.sweep(tp)
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(m, want_m)


def test_sweep_groups_engines_by_params(library):
    """Engines of two xyShift values: one launch per param group, and each
    engine's scores equal its own one-mask launch."""
    masks, targets = library
    engines = [ActiveTilePixelEngine(q, 20, i % 2 == 0, 20, 1.0,
                                     2 if i < 3 else 0)
               for i, q in enumerate(masks)]
    sweep = TwoPhaseSweep(engines, [CPU])
    assert sorted(len(idx) for idx, _ in sweep.groups) == [2, 3]
    got_s, got_m = sweep.sweep(targets)
    for i, e in enumerate(engines):
        s, _, m = e.score_packed(e.prepare_targets(targets, CPU))
        np.testing.assert_array_equal(got_s[i], s)
        np.testing.assert_array_equal(got_m[i], m)


def _seconds(spans, name):
    """The seconds of a span name, added up in the order they ended, as
    the stage totals add them (sum() would compensate the rounding)."""
    total = 0.0
    for s in spans:
        if s.name == name:
            total += (s.end_ns - s.start_ns) / 1e9
    return total


def test_stage_totals_are_the_spans(library):
    """With the recorder on, each stage of the sweep's dict is the sum of
    its span's seconds, and every span of a partition, its collect
    included, carries the partition's job."""
    from colormipsearch_torch.utils import trace
    masks, targets = library
    h, w = targets.shape[1:3]
    engines = [ActiveTilePixelEngine(q, 20, True, 20, 1.0, 2) for q in masks]
    screen, u, thr = _screen_inputs(PairPrescreen, engines, h, w,
                                    lambda e: e.planes.words)
    sweep = TwoPhaseSweep(engines, [CPU, CPU], screen, u, thr)
    parts = [("a", targets[:6]), ("b", targets[6:11]), ("c", targets[11:])]
    stage = {}
    trace.enable()
    try:
        list(sweep.sweep_parts(parts, stage))
        got = trace.drain()
    finally:
        trace.disable()
    spans = got["spans"]
    for key, name in (("pack", "sweep.pack"), ("pad", "sweep.pad"),
                      ("bound", "sweep.bound"), ("live", "sweep.live"),
                      ("launch", "sweep.exact_launch")):
        assert stage[key] == _seconds(spans, name), key
    assert stage["screened"] > 0
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "sweep.part"]
    assert len(roots) == 3 and all(s.parent is None for s in roots)
    jobs = {s.id for s in roots}
    assert {s.job for s in spans} == jobs
    assert sorted(s.job for s in spans if s.name == "sweep.collect") == \
        sorted(jobs)
    parent_of = {}
    for s in spans:
        if s.parent is not None:
            parent_of.setdefault(s.name, set()).add(by_id[s.parent].name)
    # the live tiles stay where the words are: no copy waits under them
    assert parent_of["sweep.wait"] == {"sweep.bound", "sweep.collect"}
    assert parent_of["sweep.table"] == {"sweep.exact_launch"}
    assert parent_of["sweep.pack"] == {"sweep.part"}
    # two device blocks a partition: two of each stage span per part
    assert sum(s.name == "sweep.pack" for s in spans) == 6
    # one launch table per device block and group
    assert sum(s.name == "sweep.table" for s in spans) == 6
    # the sweep counts nothing of its own
    assert not any(n.startswith("sweep.") for n in got["counters"])


@pytest.mark.parametrize("prescreen", ["on", "off"])
def test_cli_stage_times_keep_their_keys(workspace, tmp_path, caplog,
                                         prescreen):
    """colorDepthSearch's `stage times` and `prepared ... in` logs keep
    their keys; with the recorder on each logged stage is its spans'
    seconds."""
    import logging

    from colormipsearch_torch.utils import trace
    caplog.set_level(logging.INFO, logger="colormipsearch_torch")
    trace.enable()
    try:
        assert main(_search_args(str(workspace), str(tmp_path / "out"),
                                 "--device", "cpu", "--prescreen",
                                 prescreen)) == 0
        spans = trace.drain()["spans"]
    finally:
        trace.disable()
    logged = [r.args for r in caplog.records
              if r.msg == "stage times: %s"]
    assert len(logged) == 1
    stages = logged[0] if isinstance(logged[0], dict) else logged[0][0]
    names = {"decode": "cds.decode", "matches": "cds.matches",
             "write": "cds.write", "pack": "sweep.pack", "pad": "sweep.pad",
             "live": "sweep.live", "launch": "sweep.exact_launch"}
    if prescreen == "on":
        names.update(features="cds.features", bound="sweep.bound")
    assert set(stages) == set(names) | ({"screened"} if prescreen == "on"
                                        else set())
    for key, name in names.items():
        assert stages[key] == round(_seconds(spans, name), 2), key
    prep = [r.args for r in caplog.records
            if r.msg == "prepared %d mask engines in %.1fs"]
    assert len(prep) == 1 and prep[0][0] == 1
    assert prep[0][1] == _seconds(spans, "cds.prep")
