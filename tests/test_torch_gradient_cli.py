"""The port's gradientScores command (python -m colormipsearch_torch
gradientScores --device cpu) on the golden fixtures: the reference's
goldens, and per-mask JSON files identical to the JAX CLI's on the same
input under each option set."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cmd.main import main as jax_main  # noqa: E402

from colormipsearch_torch.cmd.main import main  # noqa: E402
from colormipsearch_torch.utils import trace  # noqa: E402

LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]
GRAD_ARGS = ["--maskThreshold", "20", "--mirrorMask", "--computeZGapOnTheFly"]


def _write_workspace(ws, fixtures_dir):
    """The test_cli_e2e.py workspace: one EM mask, three LM targets with
    their gradient files and, for BJD, its z-gap file."""
    em = {"class": "org.janelia.colormipsearch.model.EMNeuronEntity",
          "id": "1001", "mipId": "em-12191",
          "alignmentSpace": "JRC2018_Unisex_20x_HR",
          "libraryName": "flyem_test", "publishedName": "12191",
          "computeFiles": {"InputColorDepthImage": str(
              fixtures_dir / "ems" / "12191_JRC2018U.tif")}}
    lms = []
    for i, name in enumerate(LM_NAMES):
        files = {"InputColorDepthImage": str(fixtures_dir / "lms" /
                                             f"{name}.tif"),
                 "GradientImage": str(fixtures_dir / "grad" / f"{name}.png")}
        zgap = fixtures_dir / "zgap" / f"{name}.tif"
        if zgap.exists():
            files["ZGapImage"] = str(zgap)
        lms.append({"class": "org.janelia.colormipsearch.model.LMNeuronEntity",
                    "id": str(2001 + i), "mipId": f"lm-{i}",
                    "alignmentSpace": "JRC2018_Unisex_20x_HR",
                    "libraryName": "flylight_test",
                    "publishedName": name.split("_")[0],
                    "computeFiles": files, "slideCode": f"sc-{i}",
                    "anatomicalArea": "Brain", "objective": "40x",
                    "gender": "f"})
    for fname, ents in (("masks.json", [em]), ("targets.json", lms)):
        with open(ws / fname, "w") as f:
            json.dump(ents, f, indent=2)


@pytest.fixture(scope="module")
def cds_masks(tmp_path_factory, fixtures_dir):
    """The port's colorDepthSearch output (per-mask dir) on the workspace."""
    ws = tmp_path_factory.mktemp("torch-grad")
    _write_workspace(ws, fixtures_dir)
    rc = main(["colorDepthSearch", "-m", str(ws / "masks.json"),
               "-i", str(ws / "targets.json"), "--maskThreshold", "20",
               "--dataThreshold", "20", "--pixColorFluctuation", "1",
               "--xyShift", "2", "--mirrorMask", "--device", "cpu",
               "-od", str(ws / "cds")])
    assert rc == 0
    return ws / "cds" / "masks"


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _results(masks_dir):
    with open(os.path.join(masks_dir, "em-12191.json")) as f:
        return {r["image"]["mipId"]: r for r in json.load(f)["results"]}


@pytest.fixture(scope="module")
def scored_masks(cds_masks, tmp_path_factory):
    """The port's gradientScores on a copy of the search output."""
    masks = _copy(cds_masks, tmp_path_factory.mktemp("scored") / "masks")
    assert main(["gradientScores", "-md", masks, *GRAD_ARGS,
                 "--device", "cpu"]) == 0
    return masks


def test_gradient_goldens(scored_masks):
    res = _results(scored_masks)
    got = {k: (r["matchingPixels"], r["gradientAreaGap"],
               r["highExpressionArea"], r["mirrored"])
           for k, r in res.items()}
    assert got == {"lm-0": (439, 21365, 731, False),
                   "lm-1": (414, 33884, 523, False),   # z-gap file
                   "lm-2": (426, 40696, 17253, True)}
    # every shape ratio clamps to 1: the pixel ratio x 100, as a float32
    assert res["lm-0"]["normalizedScore"] == 100.0
    assert res["lm-2"]["normalizedScore"] == float(np.float32(426 / 439 * 100))
    assert res["lm-1"]["normalizedScore"] == float(np.float32(414 / 439 * 100))


def test_plane_cache_counts_and_spans(cds_masks, tmp_path, caplog):
    """gradientScores with the recorder on: every target is one miss, a
    lookup of each match's target is a hit or a miss, the closing log
    keeps its decode and plane-build seconds (those of the spans) and adds
    the cache's counts, and every span, the decode pool's included, is of
    the run's job."""
    import logging
    caplog.set_level(logging.INFO, logger="colormipsearch_torch")
    masks = _copy(cds_masks, tmp_path / "masks")
    trace.enable()
    try:
        assert main(["gradientScores", "-md", masks, *GRAD_ARGS,
                     "--device", "cpu"]) == 0
        got = trace.drain()
    finally:
        trace.disable()
    counted, spans = got["counters"], got["spans"]
    lookups = len(_results(masks))
    assert counted["ga.planes.misses"] == len(LM_NAMES) == lookups
    assert counted.get("ga.planes.hits", 0) + counted["ga.planes.misses"] \
        == lookups
    assert "ga.planes.evictions" not in counted
    closing = [r.args for r in caplog.records
               if r.msg.startswith("updated %d matches")]
    assert len(closing) == 1
    n, _, cached, host, decode_s, planes_s, hits, misses, evictions = \
        closing[0]
    assert (n, cached, host, hits, misses, evictions) == (3, 3, 0, 0, 3, 0)

    def seconds(name):
        total = 0.0
        for s in spans:
            if s.name == name:
                total += (s.end_ns - s.start_ns) / 1e9
        return total

    assert decode_s == seconds("ga.decode_pool") > 0
    assert planes_s == seconds("ga.plane_build") > 0
    by_id = {s.id: s for s in spans}
    root = [s for s in spans if s.name == "ga.job"]
    assert len(root) == 1 and root[0].parent is None
    assert {s.job for s in spans} == {root[0].id}
    decodes = [s for s in spans if s.name == "ga.decode"]
    assert len(decodes) == 3
    assert {by_id[s.parent].name for s in decodes} == {"ga.decode_pool"}
    files = [by_id[s.parent].name for s in spans
             if s.name.startswith("ga.decode.")]
    assert sorted(s.name for s in spans if s.name.startswith("ga.decode.")) \
        == ["ga.decode.cdm"] * 3 + ["ga.decode.grad"] * 3 + \
        ["ga.decode.zgap"] * 3
    assert set(files) == {"ga.decode"}
    parents = {s.name: by_id[s.parent].name for s in spans
               if s.parent is not None and s.name != "ga.wait"}
    assert parents["ga.upload"] == "ga.plane_build"
    assert parents["ga.mask"] == "ga.job"
    assert parents["ga.batch"] == "ga.mask"
    assert {by_id[s.parent].name for s in spans if s.name == "ga.wait"} \
        == {"ga.query_planes", "ga.finish"}


def _roi_file(tmp_path):
    """A half-zero ROI mask of the frame (tests/test_roi_mask.py's
    _roi(..., zero_right=True)), as a tif."""
    from PIL import Image
    arr = np.full((566, 1210, 3), 255, dtype=np.uint8)
    arr[:, 1210 // 2:] = 0
    path = tmp_path / "roi.tif"
    Image.fromarray(arr).save(path)
    return str(path)


@pytest.mark.parametrize("options", ["nbest", "cancel", "border", "roi"])
def test_same_files_as_jax(cds_masks, scored_masks, tmp_path, options):
    """The port and the JAX CLI, each on its own copy of the same input,
    write identical per-mask JSON files. The cancel case starts from
    scored files, so the reset shows."""
    extra = {"nbest": ["--nBestLines", "1"],
             "cancel": ["--cancel-previous-gradient-scores",
                        "--nBestLines", "1"],
             "border": ["--border", "4"],
             "roi": ["--queryROIMaskName", None]}[options]
    if options == "roi":
        extra[1] = _roi_file(tmp_path)
    src = scored_masks if options == "cancel" else cds_masks
    port = _copy(src, tmp_path / "port")
    ref = _copy(src, tmp_path / "ref")
    assert main(["gradientScores", "-md", port, *GRAD_ARGS, *extra,
                 "--device", "cpu"]) == 0
    assert jax_main(["gradientScores", "-md", ref, *GRAD_ARGS, *extra]) == 0
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port)) == ["em-12191.json"]
    for name in names:
        with open(os.path.join(port, name)) as a, \
                open(os.path.join(ref, name)) as b:
            got, want = a.read(), b.read()
        assert got == want
    res = _results(port)
    if options in ("nbest", "cancel"):
        # one line kept: the others carry no (or no more) shape score
        assert [k for k, r in res.items() if "gradientAreaGap" in r] == \
            ["lm-0"]
    if options == "roi":
        assert res["lm-0"]["gradientAreaGap"] != 21365


@pytest.mark.parametrize("flag", [["--db", "x.db"],
                                  ["--process-id", "0", "--process-count",
                                   "2"],
                                  ["--process-id", "1", "--process-count",
                                   "2"]])
def test_refused_options(cds_masks, scored_masks, tmp_path, flag):
    """Each option runs. --db reads and writes the store, not -md: over an
    empty store the -md files stay as they are. The grid options: of two
    processes, process 0 owns the one mask and rescores it as the
    one-process run does, process 1 owns none."""
    masks = _copy(cds_masks, tmp_path / "masks")
    if flag[0] == "--db":
        assert main(["gradientScores", "-md", masks, *GRAD_ARGS, "--db",
                     str(tmp_path / flag[1]), "--device", "cpu"]) == 0
        assert _results(masks) == _results(str(cds_masks))
        return
    assert main(["gradientScores", "-md", masks, *GRAD_ARGS, *flag,
                 "--device", "cpu"]) == 0
    if flag[1] == "0":
        assert _results(masks) == _results(scored_masks)
    else:
        assert _results(masks) == _results(str(cds_masks))


def test_default_device_is_cuda(cds_masks, monkeypatch):
    """--device defaults to cuda and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["gradientScores", "-md", str(cds_masks), *GRAD_ARGS])


def test_plane_cache_budget():
    """The plane cache evicts by bytes and by entries, oldest first, in
    the planes' own bytes; a missing target's None costs nothing."""
    from colormipsearch_torch.cds.shape_oracle import TargetShapePlanes
    from colormipsearch_torch.cmd.gradientscores_cmd import PlaneCache

    def planes():
        return TargetShapePlanes(*(torch.zeros((64, 512), dtype=dt)
                                   for dt in (torch.bool, torch.int16,
                                              torch.bool, torch.int16)))

    per = 64 * 512 * 6
    cache = PlaneCache("cpu", max_bytes=1 << 20, max_entries=100)
    fit = (1 << 20) // per
    for i in range(fit + 4):
        cache.insert(f"k{i}", planes())
        assert cache.nbytes <= 1 << 20
    assert len(cache) == fit and cache.nbytes == fit * per
    assert f"k{fit + 3}" in cache and "k0" not in cache
    cache.get("k4")                     # refreshed: evicted last
    cache.insert("none", None)
    assert "none" in cache and cache.get("none") is None
    assert cache.nbytes == fit * per
    cache.insert("new", planes())
    assert "k4" in cache and "k5" not in cache
    small = PlaneCache("cpu", max_entries=3)
    for i in range(5):
        small.insert(i, planes())
    assert len(small) == 3 and 0 not in small and 4 in small


def test_score_batch_edge_targets(tmp_path):
    """A target without a gradient and one of another frame size score
    -1 and the scored one equals the JAX command's; a gray CDM takes the
    host path, which refuses it as the reference's does."""
    import argparse

    from PIL import Image

    from colormipsearch_tpu import model as ref_model
    from colormipsearch_tpu.cds.shape_device import build_query_planes_device
    from colormipsearch_tpu.cmd import gradientscores_cmd as ref_gc
    from colormipsearch_tpu.mips import MIPsCache as RefCache
    from colormipsearch_torch import model
    from colormipsearch_torch.cmd import gradientscores_cmd as gc
    from colormipsearch_torch.imageproc.io import image_from_array
    from colormipsearch_torch.mips import MIPsCache
    rng = np.random.default_rng(4)
    h, w = 72, 136      # the reference's 60 px dilation needs h > 60
    query = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    query[rng.random((h, w)) < 0.7] = 0
    files = []
    for i, (kind, size, grad) in enumerate(
            [("RGB", (h, w), True), ("RGB", (h, w), False),
             ("RGB", (h + 8, w), True), ("L", (h, w), True)]):
        px = rng.integers(0, 256, size=size + ((3,) if kind == "RGB"
                                               else ()), dtype=np.uint8)
        cdm = tmp_path / f"t{i}.png"
        Image.fromarray(px, mode=kind).save(cdm)
        gpath = None
        if grad:
            gpath = tmp_path / f"t{i}_g.png"
            Image.fromarray(rng.integers(0, 255, size=size, dtype=np.uint8),
                            mode="L").save(gpath)
        files.append((cdm, gpath))
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=True, targetsPerBatch=8,
                              planes_threads=2)

    def matches(pkg, which):
        em = pkg.EMNeuronEntity(entity_id=1, mip_id="em")
        out = []
        for i in which:
            cdm, gpath = files[i]
            lm = pkg.LMNeuronEntity(entity_id=10 + i, mip_id=f"lm-{i}")
            lm.compute_files[pkg.ComputeFileType.InputColorDepthImage] = \
                pkg.FileData.from_string(str(cdm))
            if gpath is not None:
                lm.compute_files[pkg.ComputeFileType.GradientImage] = \
                    pkg.FileData.from_string(str(gpath))
            m = pkg.CDMatchEntity()
            m.mask_image, m.matched_image = em, lm
            out.append(m)
        return out

    qplanes = gc._build_qplanes(image_from_array(query), None, None, 0,
                                "cpu")
    ref_qplanes = build_query_planes_device(query)
    planes_cache = gc.PlaneCache("cpu")
    got = matches(model, range(3))
    scored = gc._score_batch(got, qplanes, MIPsCache(16), args, None,
                             planes_cache)
    want = matches(ref_model, range(3))
    ref_gc._score_batch(want, ref_qplanes, RefCache(16), args, None, {})
    assert [m.matched_image.mip_id for m in scored] == ["lm-0"]
    assert [(m.gradient_area_gap, m.high_expression_area) for m in got] == \
        [(m.gradient_area_gap, m.high_expression_area) for m in want]
    assert [m.gradient_area_gap for m in got[1:]] == [-1, -1]
    assert planes_cache.host_builds == 0
    with pytest.raises(ValueError, match="not an RGB image"):
        ref_gc._score_batch(matches(ref_model, [3]), ref_qplanes,
                            RefCache(16), args, None, {})
    with pytest.raises(ValueError, match="not an RGB image"):
        gc._score_batch(matches(model, [3]), qplanes, MIPsCache(16), args,
                        None, planes_cache)
    assert planes_cache.host_builds == 1


def test_score_batch_after_eviction(tmp_path, monkeypatch):
    """A batch larger than the plane cache: targets evicted since the
    prefetch are rebuilt, and the scorer gets, for each target, an entry
    whose pointers are those of the planes it holds; the scores equal the
    JAX command's."""
    import argparse

    from PIL import Image

    from colormipsearch_tpu import model as ref_model
    from colormipsearch_tpu.cds.shape_device import build_query_planes_device
    from colormipsearch_tpu.cmd import gradientscores_cmd as ref_gc
    from colormipsearch_tpu.mips import MIPsCache as RefCache
    from colormipsearch_torch import model
    from colormipsearch_torch.cds import shape_kernel as sk
    from colormipsearch_torch.cmd import gradientscores_cmd as gc
    from colormipsearch_torch.imageproc.io import image_from_array
    from colormipsearch_torch.mips import MIPsCache
    rng = np.random.default_rng(41)
    h, w = 64, 96
    query = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    query[rng.random((h, w)) < 0.7] = 0
    files = []
    for i in range(5):
        px = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        px[rng.random((h, w)) < 0.5] = 0
        cdm, grad = tmp_path / f"t{i}.png", tmp_path / f"t{i}_g.png"
        Image.fromarray(px).save(cdm)
        Image.fromarray(rng.integers(0, 255, size=(h, w), dtype=np.uint8),
                        mode="L").save(grad)
        files.append((cdm, grad))
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=True, targetsPerBatch=8,
                              planes_threads=2)

    def matches(pkg):
        em = pkg.EMNeuronEntity(entity_id=1, mip_id="em")
        out = []
        for i, (cdm, grad) in enumerate(files):
            lm = pkg.LMNeuronEntity(entity_id=10 + i, mip_id=f"lm-{i}")
            lm.compute_files[pkg.ComputeFileType.InputColorDepthImage] = \
                pkg.FileData.from_string(str(cdm))
            lm.compute_files[pkg.ComputeFileType.GradientImage] = \
                pkg.FileData.from_string(str(grad))
            m = pkg.CDMatchEntity()
            m.mask_image, m.matched_image = em, lm
            out.append(m)
        return out

    seen = []
    scorer = gc.shape_rows_cached

    def spy(*a, **k):
        for e in a[4]:
            seen.append(e.ptrs.tolist() == [
                getattr(e.planes, n).data_ptr()
                for n in sk.TARGET_PLANE_NAMES])
        return scorer(*a, **k)

    monkeypatch.setattr(gc, "shape_rows_cached", spy)
    qplanes = gc._build_qplanes(image_from_array(query), None, None, 0,
                                "cpu")
    planes_cache = gc.PlaneCache("cpu", max_entries=2)
    got = matches(model)
    before = trace.counts()
    scored = gc._score_batch(got, qplanes, MIPsCache(16), args, None,
                             planes_cache)
    # the prefetch's 5 lookups miss and its inserts evict 3; each of the
    # 5 matches then finds its target evicted, looks it up again (a miss)
    # and evicts one
    counted = trace.counts(since=before)
    assert (counted["ga.planes.hits"], counted["ga.planes.misses"],
            counted["ga.planes.evictions"]) == (0, 10, 8)
    want = matches(ref_model)
    ref_gc._score_batch(want, build_query_planes_device(query), RefCache(16),
                        args, None, {})
    assert len(scored) == 5 and seen == [True] * 5 and len(planes_cache) == 2
    assert [(m.gradient_area_gap, m.high_expression_area) for m in got] == \
        [(m.gradient_area_gap, m.high_expression_area) for m in want]
