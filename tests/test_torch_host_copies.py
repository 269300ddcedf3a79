"""The port's host copies (colormipsearch_torch.cds.{pixel_kernel,
ratio_bounds, pixel_active, prescreen, oracle, exact_ratio} and the host
modules of the colorDepthSearch and gradientScores commands) must equal
the JAX package's functions exactly on the same inputs."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cds import pixel_kernel as ref_pk  # noqa: E402
from colormipsearch_tpu.cds import pixel_pallas as ref_pp  # noqa: E402
from colormipsearch_tpu.cds import prescreen as ref_ps  # noqa: E402
from colormipsearch_tpu.cds import ratio_bounds as ref_rb  # noqa: E402
from colormipsearch_tpu.imageproc import (label_regions_mask,  # noqa: E402
                                          load_image)
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import pixel_active as pa  # noqa: E402
from colormipsearch_torch.cds import pixel_kernel as pk  # noqa: E402
from colormipsearch_torch.cds import prescreen as ps  # noqa: E402
from colormipsearch_torch.cds import ratio_bounds as rb  # noqa: E402

ZT9 = ref_pk.z_tolerance_to_zt9(1.0)


def _random_rgb(rng, shape, zero_frac):
    px = rng.integers(0, 256, size=shape + (3,)).astype(np.uint8)
    px[rng.random(shape) < zero_frac] = 0
    return px


def test_constants_and_ztol():
    assert pk.PAIR_K9 == ref_pk.PAIR_K9
    for f in (0.0, 0.5, 1.0, 2.0, 5.4, 12.5):
        assert pk.z_tolerance_to_zt9(f) == ref_pk.z_tolerance_to_zt9(f)


def test_pack_planes_numpy_and_torch():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, size=(3, 64, 96, 3)).astype(np.int32)
    rgb[rng.random((3, 64, 96)) < 0.3] = 0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    sel = (rgb > 20).any(axis=-1)
    want = np.asarray(ref_pk.pack_planes(r, g, b, sel, np))
    np.testing.assert_array_equal(pk.pack_planes(r, g, b, sel, np), want)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (r, g, b)]
    got = pk.pack_planes(*t, torch.from_numpy(sel), torch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def em_planes(fixtures_dir):
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    return (query, excluded,
            ref_pk.prepare_query_planes(query, 20, excluded),
            pk.prepare_query_planes(query, 20, excluded))


def test_prepare_query_planes(em_planes):
    query, excluded, want, got = em_planes
    np.testing.assert_array_equal(got.words, want.words)
    assert (got.query_size, got.height, got.width) == \
        (want.query_size, want.height, want.width)
    # the [H, W, 3] uint8 array gives the same planes as the image
    from_px = pk.prepare_query_planes(query.pixels, 20, excluded)
    np.testing.assert_array_equal(from_px.words, want.words)
    assert from_px.query_size == want.query_size


def test_query_ratio_planes():
    rng = np.random.default_rng(9)
    rgb = _random_rgb(rng, (40, 256), 0.3).astype(np.int32)
    words = ref_pk.pack_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                               (rgb > 20).any(axis=-1), np)
    want_c, want_f = ref_rb.query_ratio_planes(words, ZT9)
    got_c, got_f = rb.query_ratio_planes(words, ZT9)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("source", ["fixture", "random", "empty"])
def test_build_active_tiles(em_planes, source):
    if source == "fixture":
        planes = em_planes[2]
    else:
        rng = np.random.default_rng(11)
        px = _random_rgb(rng, (48, 160), 0.8 if source == "random" else 1.0)
        planes = ref_pk.prepare_query_planes(image_from_array(px), 20, None)
    want = ref_pp.build_active_tiles(planes, 2, ZT9)
    got = pa.build_active_tiles(planes, ZT9)
    n = want.n_active
    assert (got.n_active, got.query_size, got.height, got.width) == \
        (n, want.query_size, want.height, want.width)
    np.testing.assert_array_equal(got.coords, want.coords[:n, :2])
    np.testing.assert_array_equal(got.q_words, want.q_tiles[:n])
    np.testing.assert_array_equal(got.q_cmp, want.q_cmp[:n])
    np.testing.assert_array_equal(got.q_f32, want.q_f32[:n])
    carried = pa.ActiveTiles.from_numpy(want.coords, n, want.q_tiles,
                                        want.query_size, want.height,
                                        want.width, want.q_cmp, want.q_f32)
    for name in ("coords", "q_words", "q_cmp", "q_f32"):
        np.testing.assert_array_equal(getattr(carried, name),
                                      getattr(got, name))


@pytest.mark.parametrize("fluct", [1.0, 2.0])
def test_compat_matrix(fluct):
    zt9 = ref_pk.z_tolerance_to_zt9(fluct)
    np.testing.assert_array_equal(ps.compat_matrix(zt9),
                                  ref_ps.compat_matrix(zt9))


def test_query_features_and_bins(em_planes):
    words = em_planes[2].words
    np.testing.assert_array_equal(ps.query_features(words),
                                  ref_ps.query_features(words))
    want = np.asarray(ref_ps.bin_plane_from_words(words.astype(np.int64),
                                                  xp=np))
    np.testing.assert_array_equal(
        ps.bin_plane_from_words(words.astype(np.int64), np), want)
    np.testing.assert_array_equal(
        ps.bin_plane_from_words(torch.from_numpy(words), torch).numpy(), want)


# ---- the copies of the host modules the colorDepthSearch command uses -----

def _same_outcome(fn_got, fn_want):
    """Both calls return equal values, or both raise the same type."""
    try:
        want = fn_want()
    except Exception as e:  # the reference refuses: so must the copy
        with pytest.raises(type(e)):
            fn_got()
        return
    assert fn_got() == want


def _case_shift_ring_offsets(tmp_path, fixtures_dir):
    from colormipsearch_tpu.cds.oracle import shift_ring_offsets as want
    from colormipsearch_torch.cds.oracle import shift_ring_offsets as got
    for xy in range(5):
        _same_outcome(lambda: got(xy), lambda: want(xy))


def _case_c9_split(tmp_path, fixtures_dir):
    from colormipsearch_tpu.cds.exact_ratio import c9_split as want
    from colormipsearch_torch.cds.exact_ratio import c9_split as got
    rng = np.random.default_rng(3)
    values = [0, 1, 63, 64, 999_999, 10_000_000, 354_862_745,
              3_000_999_999, 3_001_000_000, -1]
    values += [int(v) for v in rng.integers(0, 3_001_000_000, 64)]
    for c9 in values:
        _same_outcome(lambda: got(c9), lambda: want(c9))


def _case_cmd_args(tmp_path, fixtures_dir):
    import argparse

    from colormipsearch_tpu.cmd import args as want
    from colormipsearch_torch.cmd import args as got
    for h, w in ((566, 1210), (40, 200), (120, 300)):
        for no_labels in (False, True):
            ns = argparse.Namespace(noLabelRegions=no_labels)
            np.testing.assert_array_equal(
                got.excluded_regions_for(ns, h, w),
                want.excluded_regions_for(ns, h, w))
    for v in ("a.json", "a.json:3", "a.json:3:10", "c:/x.json:-1:2"):
        assert vars(got.ListArg.parse(v)) == vars(want.ListArg.parse(v))
    parsed = []
    for mod in (got, want):
        p = argparse.ArgumentParser()
        mod.add_common_args(p)
        mod.add_cds_params(p)
        parsed.append(vars(p.parse_args(["--xyShift", "2"])))
    assert parsed[0] == parsed[1]


def _case_label_regions(tmp_path, fixtures_dir):
    from colormipsearch_tpu.imageproc import regions as want
    from colormipsearch_torch.imageproc import regions as got
    for h, w in ((566, 1210), (50, 100), (200, 271)):
        np.testing.assert_array_equal(got.label_regions_mask(h, w),
                                      want.label_regions_mask(h, w))
        np.testing.assert_array_equal(got.no_regions_mask(h, w),
                                      want.no_regions_mask(h, w))


def _case_load_image(tmp_path, fixtures_dir):
    from colormipsearch_tpu.imageproc import io as want
    from colormipsearch_torch.imageproc import io as got
    paths = sorted((fixtures_dir / "ems").iterdir())[:2]
    paths += sorted((fixtures_dir.parent / "imageprocessing").iterdir())[:1]
    for path in paths:
        a, b = got.load_image(str(path)), want.load_image(str(path))
        assert a.kind.value == b.kind.value
        np.testing.assert_array_equal(a.pixels, b.pixels)
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(got.load_image(data).pixels, b.pixels)
    arr = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    np.testing.assert_array_equal(got.image_from_array(arr).pixels,
                                  want.image_from_array(arr).pixels)
    for n in ("x.tif", "x.PNG", "x.txt"):
        assert got.is_image_file(n) == want.is_image_file(n)


def _match_dicts(fixtures_dir):
    import json
    with open(fixtures_dir.parent / "cdsmatches" / "testcdsmatches.json") as f:
        return json.load(f)


def _case_model_entities(tmp_path, fixtures_dir):
    from colormipsearch_tpu import model as want
    from colormipsearch_torch import model as got
    for d in _match_dicts(fixtures_dir):
        assert got.CDMatchEntity.from_dict(d).to_dict() == \
            want.CDMatchEntity.from_dict(d).to_dict()
        for side in ("maskImage", "image"):
            assert got.entity_from_dict(d[side]).to_dict() == \
                want.entity_from_dict(d[side]).to_dict()
    for enum_name in ("ComputeFileType", "FileType", "ProcessingType",
                      "Gender"):
        assert [(e.name, e.value) for e in getattr(got, enum_name)] == \
            [(e.name, e.value) for e in getattr(want, enum_name)]
    for v in ("a/b.png", {"dataType": "zipEntry", "fileName": "a.zip",
                          "entryName": "b/c.tif"}, None):
        fg, fw = got.FileData.from_json(v), want.FileData.from_json(v)
        assert (fg is None) == (fw is None)
        if fg is not None:
            assert (fg.to_json(), fg.name) == (fw.to_json(), fw.name)
    s_got = got.CDSSessionEntity(entity_id=7, username="u", params={"a": 1})
    s_want = want.CDSSessionEntity(entity_id=7, username="u", params={"a": 1})
    assert s_got.to_dict() == s_want.to_dict()


def _tree(root):
    import os
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path) as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _case_json_reader_writer(tmp_path, fixtures_dir):
    """MIP lists read and grouped match files written the same, on the
    match fixtures: a round trip through each package."""
    import json

    from colormipsearch_tpu import dataio as want_io
    from colormipsearch_tpu import model as want_model
    from colormipsearch_torch import dataio as got_io
    from colormipsearch_torch import model as got_model
    docs = _match_dicts(fixtures_dir)
    mips = tmp_path / "mips.json"
    with open(mips, "w") as f:
        json.dump([d["maskImage"] for d in docs] + [d["image"] for d in docs],
                  f)
    for param in ({}, {"offset": 3, "size": 5},
                  {"libraries": [docs[0]["image"].get("libraryName")]}):
        got = got_io.JSONCDMIPsReader(str(mips)).read_mips(
            got_io.DataSourceParam(**param))
        want = want_io.JSONCDMIPsReader(str(mips)).read_mips(
            want_io.DataSourceParam(**param))
        assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    for pkg_io, pkg_model, out in ((got_io, got_model, "got"),
                                   (want_io, want_model, "want")):
        matches = [pkg_model.CDMatchEntity.from_dict(d) for d in docs]
        n = pkg_io.JSONNeuronMatchesWriter(
            str(tmp_path / out / "masks"),
            str(tmp_path / out / "targets")).write(matches)
        assert n > 0
        pkg_io.JSONCDSSessionWriter(str(tmp_path / out)).create_session(
            pkg_model.CDSSessionEntity(entity_id=11, username="u",
                                       params={"xyShift": 2}))
    got_files, want_files = _tree(tmp_path / "got"), _tree(tmp_path / "want")
    assert got_files and got_files == want_files


def _case_partition_collection(tmp_path, fixtures_dir):
    from colormipsearch_tpu.results import partition_collection as want
    from colormipsearch_torch.results import partition_collection as got
    for n in (0, 1, 7, 100):
        for size in (-1, 0, 1, 3, 100):
            assert got(list(range(n)), size) == want(list(range(n)), size)


def _case_id_generator(tmp_path, fixtures_dir):
    from colormipsearch_tpu.persist import TimebasedIdGenerator as Want
    from colormipsearch_torch.persist import TimebasedIdGenerator as Got
    got, want = Got(deployment_context=3), Want(deployment_context=3)
    assert got.ip_component == want.ip_component
    ids = got.generate_ids(2100)
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    low = [(i & 0xFFF) for i in ids]
    assert low == [(i & 0xFFF) for i in want.generate_ids(2100)]
    lock = Got(lock_file=str(tmp_path / "lk" / "id.lock")).generate_ids(3)
    assert len(set(lock)) == 3
    with pytest.raises(ValueError):
        Got(deployment_context=16)


def _case_native_pack(tmp_path, fixtures_dir):
    """The copy of mipops packs the query words the reference packs, on
    its native path where g++ builds it and on the NumPy path."""
    from colormipsearch_torch.native import mipops as got
    rng = np.random.default_rng(17)
    block = _random_rgb(rng, (3, 40, 70), 0.5)
    excluded = rng.random((40, 70)) < 0.2
    rgb = block[0].astype(np.int32)
    for exc in (None, excluded):
        sel = (rgb > 20).any(axis=2)
        if exc is not None:
            sel &= ~exc
        ref = ref_pk.pack_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2], sel,
                                 np)
        words = got.pack_planes_native(block[0], 20, exc)
        assert (words is None) == (not got.available())
        if words is not None:
            np.testing.assert_array_equal(words, ref)
        np.testing.assert_array_equal(
            pk.prepare_query_planes(block[0], 20, exc).words, ref)
    assert os.path.dirname(got.library_path()).endswith(
        os.path.join("build", "native"))


def _case_mips_cache(tmp_path, fixtures_dir):
    """MIPsCache loads a fixture MIP (directly and through the array
    store) as the reference does."""
    from colormipsearch_tpu.imageproc.store import PackedArrayStore as WStore
    from colormipsearch_tpu.mips import MIPsCache as WCache
    from colormipsearch_torch.imageproc.store import PackedArrayStore as GStore
    from colormipsearch_torch.mips import MIPsCache as GCache
    from colormipsearch_torch.model import (ComputeFileType, EMNeuronEntity,
                                            FileData)
    from colormipsearch_torch.utils.memguard import MemoryGuard
    em = EMNeuronEntity(entity_id=5, mip_id="em-5")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(str(fixtures_dir / "ems" / "12191_JRC2018U.tif"))
    from colormipsearch_tpu import model as wm
    em_w = wm.EMNeuronEntity(entity_id=5, mip_id="em-5")
    em_w.compute_files[wm.ComputeFileType.InputColorDepthImage] = \
        wm.FileData.from_string(str(fixtures_dir / "ems" / "12191_JRC2018U.tif"))
    want = WCache(4).load_mip(em_w, wm.ComputeFileType.InputColorDepthImage)
    for store in (None, GStore(str(tmp_path / "arrays"))):
        cache = GCache(4, array_store=store)
        for _ in range(2):  # a miss, then a hit
            got = cache.load_mip(em, ComputeFileType.InputColorDepthImage)
            np.testing.assert_array_equal(got.image.pixels,
                                          want.image.pixels)
    np.testing.assert_array_equal(
        WStore(str(tmp_path / "arrays")).load(
            em_w.compute_files[wm.ComputeFileType.InputColorDepthImage]
        ).pixels, want.image.pixels)
    # a cache under memory pressure evicts as the reference's does
    from colormipsearch_tpu.utils.memguard import MemoryGuard as WGuard
    caches = (GCache(4, memory_guard=MemoryGuard(
                  probe=lambda: (0, 100), min_interval=0.0)),
              WCache(4, memory_guard=WGuard(
                  probe=lambda: (0, 100), min_interval=0.0)))
    sizes = []
    for cache, ent, cft in ((caches[0], em, ComputeFileType),
                            (caches[1], em_w, wm.ComputeFileType)):
        for eid in (5, 6, 7):
            ent.entity_id = eid
            cache.load_mip(ent, cft.InputColorDepthImage)
            sizes.append(len(cache._cache))
    assert sizes[:3] == sizes[3:] and min(sizes) < 3


# ---- the copies of the host modules the gradientScores command uses -------

_EM = "org.janelia.colormipsearch.model.EMNeuronEntity"
_LM = "org.janelia.colormipsearch.model.LMNeuronEntity"
_MATCH = "org.janelia.colormipsearch.model.CDMatchEntity"


def _synthetic_match_docs(seed, n=60):
    """Match dicts over 3 masks, 5 published lines and 3 samples each,
    with tied pixel scores and every kind of shape-score field: absent,
    -1, 0 and positive."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        mask = int(rng.integers(1, 4))
        line, sample = int(rng.integers(0, 5)), int(rng.integers(0, 3))
        d = {"class": _MATCH, "mirrored": bool(rng.integers(0, 2)),
             "maskImage": {"class": _EM, "id": str(mask),
                           "mipId": f"em-{mask}", "publishedName": f"b{mask}"},
             "image": {"class": _LM, "id": str(1000 + i), "mipId": f"lm-{i}",
                       "publishedName": f"line{line}",
                       "slideCode": f"line{line}-s{sample}"},
             "matchingPixels": int(rng.integers(0, 40)),
             "matchingPixelsRatio": float(np.float32(rng.random()))}
        kind = int(rng.integers(0, 4))
        if kind == 1:
            d["gradientAreaGap"], d["highExpressionArea"] = -1, -1
        elif kind >= 2:
            d["gradientAreaGap"] = int(rng.integers(0, 5000)) * (kind - 2)
            d["highExpressionArea"] = int(rng.integers(0, 3000))
        if rng.random() < 0.1:
            d["bidirectionalAreaGap"] = int(rng.integers(-1, 900))
        if rng.random() < 0.3:
            d["maskImageRefId"] = str(mask + 10)
        docs.append(d)
    return docs


def _both_matches(seed):
    from colormipsearch_tpu.model import CDMatchEntity as Want
    from colormipsearch_torch.model import CDMatchEntity as Got
    docs = _synthetic_match_docs(seed)
    return ([Got.from_dict(d) for d in docs],
            [Want.from_dict(d) for d in docs])


def _ids(matches):
    return [(m.mask_ref(), m.matched_image.mip_id) for m in matches]


def _case_match_score_helpers(tmp_path, fixtures_dir):
    got, want = _both_matches(1)
    for g, w in zip(got, want):
        assert (g.mask_ref(), g.grad_score, g.has_grad_score) == \
            (w.mask_ref(), w.grad_score, w.has_grad_score)
        for side in ("mask_image", "matched_image"):
            assert getattr(g, side).neuron_id == getattr(w, side).neuron_id
        g.reset_gradient_scores()
        w.reset_gradient_scores()
        assert g.to_dict() == w.to_dict()


def _case_scores_filter(tmp_path, fixtures_dir):
    from colormipsearch_tpu.dataio import ScoresFilter as Want
    from colormipsearch_torch.dataio import ScoresFilter as Got
    got, want = _both_matches(2)
    for selectors in ([], [("matchingRatio", 0.5)],
                      [("gradientAreaGap|bidirectionalAreaGap", -1)],
                      [("gradientAreaGap", 1), ("highExpressionArea", 100)],
                      [("nosuchfield", 0)]):
        fg, fw = Got(), Want()
        for name, v in selectors:
            fg.add(name, v)
            fw.add(name, v)
        assert fg.empty == fw.empty
        assert [fg.matches(m) for m in got] == [fw.matches(m) for m in want]


def _case_matches_reader(tmp_path, fixtures_dir):
    """Per-mask files written by each package and read back by each
    reader, with selectors, filters and sorts; write_updates rewrites the
    same files."""
    from colormipsearch_tpu import dataio as want_io
    from colormipsearch_torch import dataio as got_io
    got, want = _both_matches(3)
    for io_, matches, out in ((got_io, got, "got"), (want_io, want, "want")):
        io_.JSONNeuronMatchesWriter(str(tmp_path / out)).write(matches)
    assert _tree(tmp_path / "got") == _tree(tmp_path / "want")
    rg = got_io.JSONNeuronMatchesReader(str(tmp_path / "got"))
    rw = want_io.JSONNeuronMatchesReader(str(tmp_path / "want"))
    for mip_ids in ([], ["em-2"], ["em-9"]):
        assert rg.list_match_locations([got_io.DataSourceParam(
            mip_ids=mip_ids)]) == rw.list_match_locations(
            [want_io.DataSourceParam(mip_ids=mip_ids)])
    for sel, flt, sort in ((["em-1"], None, None),
                           ([], ("matchingPixels", 10), None),
                           ([], None, ("matchingPixels", True)),
                           (["em-3"], ("matchingRatio", 0.2),
                            ("gradientAreaGap", False))):
        args = []
        for io_ in (got_io, want_io):
            f = io_.ScoresFilter().add(*flt) if flt else None
            s = io_.SortCriteria(*sort) if sort else None
            args.append((io_.DataSourceParam(mip_ids=sel), None, f, s))
        a = rg.read_matches_by_mask(*args[0])
        b = rw.read_matches_by_mask(*args[1])
        assert [m.to_dict() for m in a] == [m.to_dict() for m in b]
    a = rg.read_matches_by_mask(got_io.DataSourceParam())
    b = rw.read_matches_by_mask(want_io.DataSourceParam())
    for m in a + b:
        m.gradient_area_gap = 7
    for io_, matches, out in ((got_io, a, "got"), (want_io, b, "want")):
        assert io_.JSONNeuronMatchesWriter(str(tmp_path / out)).write_updates(
            matches, ["gradientAreaGap"]) == 3
    assert _tree(tmp_path / "got") == _tree(tmp_path / "want")


def _case_select_best_matches(tmp_path, fixtures_dir):
    from colormipsearch_tpu import results as want_r
    from colormipsearch_torch import results as got_r
    got, want = _both_matches(4)
    for top in ((-1, -1, -1), (1, -1, -1), (2, 1, 1), (3, 2, 2), (0, 0, 0)):
        a = got_r.select_best_matches(list(got), *top)
        b = want_r.select_best_matches(list(want), *top)
        assert _ids(a) == _ids(b)
        ga, gb = got_r.group_matches_by_mask(a), want_r.group_matches_by_mask(b)
        assert list(ga) == list(gb)
        assert [_ids(v) for v in ga.values()] == [_ids(v) for v in gb.values()]


def _case_scores(tmp_path, fixtures_dir):
    from colormipsearch_tpu.cds import scores as want
    from colormipsearch_torch.cds import scores as got
    values = (-1, 0, 1, 2, 3, 17, 439, 100_000)
    for a in values + (None,):
        for b in values + (None,):
            assert got.calculate_2d_shape_score(a, b) == \
                want.calculate_2d_shape_score(a, b)
            if a is not None and b is not None:
                assert got.ShapeMatchScore(a, b).score == \
                    want.ShapeMatchScore(a, b).score
    for p in values:
        for s in values:
            for mp in (0, 1, 439):
                for ms in (-1, 0, 5, 100_000):
                    assert got.calculate_normalized_score(p, s, mp, ms) == \
                        want.calculate_normalized_score(p, s, mp, ms)


def _case_normalize(tmp_path, fixtures_dir):
    from colormipsearch_tpu.results import normalize_match_scores as want
    from colormipsearch_torch.results import normalize_match_scores as got
    for seed in (5, 6):
        a, b = _both_matches(seed)
        got(a)
        want(b)
        assert [m.normalized_score for m in a] == \
            [m.normalized_score for m in b]


def _case_colors(tmp_path, fixtures_dir):
    from colormipsearch_tpu.imageproc import colors as want
    from colormipsearch_tpu.imageproc.io import Image as WImage
    from colormipsearch_tpu.imageproc.io import ImageKind as WKind
    from colormipsearch_torch.imageproc import colors as got
    from colormipsearch_torch.imageproc.io import Image as GImage
    from colormipsearch_torch.imageproc.io import ImageKind as GKind
    rng = np.random.default_rng(8)
    rgb = _random_rgb(rng, (30, 50), 0.3)
    excluded = rng.random((30, 50)) < 0.2
    for fn, args in (("rgb_to_gray_no_gamma", (rgb,)),
                     ("rgb_to_gray_no_gamma", (rgb, 65535.0)),
                     ("gray_to_signal", (rgb[..., 0].astype(np.int32), 20)),
                     ("mask_rgb", (rgb, 20)),
                     ("clear_region_rgb", (rgb, excluded)),
                     ("mirror_x", (rgb,))):
        np.testing.assert_array_equal(getattr(got, fn)(*args),
                                      getattr(want, fn)(*args))
    gray8 = rgb[..., 1]
    gray16 = rng.integers(0, 65536, (30, 50)).astype(np.uint16)
    for kind, px in (("RGB", rgb), ("GRAY8", gray8), ("GRAY16", gray16)):
        np.testing.assert_array_equal(
            got.to_gray16_no_gamma(GImage(GKind[kind], px)),
            want.to_gray16_no_gamma(WImage(WKind[kind], px)))


def _case_filters(tmp_path, fixtures_dir):
    from colormipsearch_tpu.imageproc import filters as want
    from colormipsearch_torch.imageproc import filters as got
    for r in (1.0, 1.5, 1.7, 2.5, 2.8, 3.0, 10.0, 20.0, 60.0):
        np.testing.assert_array_equal(got.make_line_radii(r),
                                      want.make_line_radii(r))
    rng = np.random.default_rng(9)
    rgb = _random_rgb(rng, (80, 130), 0.95)
    rgb[0, 0] = rgb[-1, -1] = 255
    for r in (2.5, 10.0, 60.0):
        np.testing.assert_array_equal(got.max_filter_rgb(rgb, r),
                                      want.max_filter_rgb(rgb, r))
        np.testing.assert_array_equal(got.max_filter_plane(rgb[..., 0], r),
                                      want.max_filter_plane(rgb[..., 0], r))



def _case_filters_short_planes(tmp_path, fixtures_dir):
    """Planes shorter than the kernel: offsets past the plane sample only
    outside-image pixels (0). The reference is the JAX package's default
    path, its native filter, or where that does not load, the dense
    footprint max (never its NumPy decomposition, which raises there)."""
    from scipy import ndimage as ndi

    from colormipsearch_tpu import native
    from colormipsearch_tpu.imageproc import filters as want
    from colormipsearch_torch.imageproc import filters as got
    rng = np.random.default_rng(11)
    for h in (1, 19, 20, 40, 59, 60, 61):
        rgb = _random_rgb(rng, (h, 96), 0.9)
        for r in (20.0, 60.0):
            if native.available():
                ref = want.max_filter_rgb(rgb, r)
            else:
                fp = want.circular_footprint(r)
                ref = np.stack([ndi.maximum_filter(
                    rgb[..., c], footprint=fp, mode="constant", cval=0)
                    for c in range(3)], axis=-1)
            np.testing.assert_array_equal(got.max_filter_rgb(rgb, r), ref)
            np.testing.assert_array_equal(
                got.max_filter_plane(rgb[..., 1], r), ref[..., 1])


def _case_enums_ppp_suffix(tmp_path, fixtures_dir):
    from colormipsearch_tpu.model.enums import FileType as want
    from colormipsearch_torch.model.enums import FileType as got
    assert [v.name for v in got] == [v.name for v in want]
    for v in got:
        assert v.display_ppp_suffix == want[v.name].display_ppp_suffix
    names = ["em-lm" + (v.file_suffix or "") for v in want]
    names += ["em-lm_9_unknown.png", "", "plain.tif", "_1_raw.png"]
    for name in names:
        g, w = got.find_by_ppp_suffix(name), want.find_by_ppp_suffix(name)
        assert (g and g.name) == (w and w.name), name


def _case_mips_loader(tmp_path, fixtures_dir):
    """filedata_exists on plain files, directories, zip entries (exact,
    by the basename fallback, missing) and broken archives; has_image."""
    import zipfile

    from colormipsearch_tpu.mips import loader as want
    from colormipsearch_tpu.model import FileData as WantFD
    from colormipsearch_torch.mips import loader as got
    from colormipsearch_torch.model import FileData, FileDataType
    tif = fixtures_dir / "ems" / "12191_JRC2018U.tif"
    z = tmp_path / "mips.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.write(tif, "deep/dir/12191_JRC2018U.tif")
        zf.writestr("other/notes.txt", "x")
    (tmp_path / "broken.zip").write_bytes(b"not a zip")
    refs = [FileData.from_string(str(tif)),
            FileData.from_string(str(tmp_path)),
            FileData.from_string(str(tmp_path / "missing.tif"))]
    for archive, entry in ((z, "deep/dir/12191_JRC2018U.tif"),
                           (z, "other/12191_JRC2018U.tif"),
                           (z, "other/notes.txt"), (z, "missing.tif"),
                           (tmp_path / "broken.zip", "a.tif"),
                           (tmp_path / "none.zip", "a.tif")):
        refs.append(FileData(file_name=str(archive),
                             data_type=FileDataType.zipEntry,
                             entry_name=entry))
    got_exists = [got.filedata_exists(None)] + [got.filedata_exists(fd)
                                                for fd in refs]
    want_exists = [want.filedata_exists(None)] + [
        want.filedata_exists(WantFD.from_json(fd.to_json())) for fd in refs]
    assert got_exists == want_exists
    assert got_exists == [False, True, False, False, True, True, True,
                          False, False, False]
    for image in (None, object()):
        assert got.NeuronMIP(None, None, image).has_image == \
            want.NeuronMIP(None, None, image).has_image == (image is not None)


def _case_json_mips_writer(tmp_path, fixtures_dir):
    """JSONCDMIPsWriter: the bytes written, append mode and processing
    tags."""
    from colormipsearch_tpu import dataio as want_io
    from colormipsearch_tpu import model as want_model
    from colormipsearch_torch import dataio as got_io
    from colormipsearch_torch import model as got_model
    docs = [d["maskImage"] for d in _match_dicts(fixtures_dir)[:4]]
    docs += [d["image"] for d in _match_dicts(fixtures_dir)[:4]]
    out = {}
    for name, io, model in (("got", got_io, got_model),
                            ("want", want_io, want_model)):
        path = tmp_path / name / "mips.json"
        ents = [model.entity_from_dict(d) for d in docs]
        w = io.JSONCDMIPsWriter(str(path))
        w.open()
        w.write(ents[:5])
        w.add_processing_tags(ents[:2], model.ProcessingType.ColorDepthSearch,
                              {"t1", "t2"})
        w.close()
        w = io.JSONCDMIPsWriter(str(path), append=True)
        w.open()
        w.write(ents[5:])
        w.close()
        out[name] = path.read_bytes()
    assert out["got"] == out["want"]


def _case_ppp_raw_reader(tmp_path, fixtures_dir):
    from colormipsearch_tpu.ppp import read_raw_ppp_matches as want
    from colormipsearch_torch.ppp import read_raw_ppp_matches as got
    for path in sorted(fixtures_dir.parent.glob("cov_scores_*.json")):
        for best in (False, True):
            g = [m.to_dict() for m in got(str(path), only_best_matches=best)]
            w = [m.to_dict() for m in want(str(path),
                                           only_best_matches=best)]
            assert g == w and g


def _case_mipstores(tmp_path, fixtures_dir):
    """Name parsing, store indexing (directories and zips) and the
    variant lookup of cmd.mipstores."""
    import zipfile

    from colormipsearch_tpu.cmd import mipstores as want
    from colormipsearch_torch.cmd import mipstores as got
    names = [p.name for p in sorted(fixtures_dir.glob("*/*"))]
    names += ["1537331894-RT-JRC2018_Unisex_20x_HR-CDM.tif",
              "R12A34-20200101_31_A1-m-20x-VNC-JRC2018_VNC_Unisex_40x_DS"
              "-CH1_CDM.png", "flyem_hemibrain", "flywire_fafb", "x_FL.tif",
              "a-b-c-CH3-07_CDM.tif", "", "1234_FL-01.png",
              "1234_LV_x.tif", "1234-L_x.tif"]
    for n in names:
        for fn in ("extract_em_body_id", "extract_lm_slide_code",
                   "extract_channel", "is_em_library",
                   "extract_em_neuron_state"):
            _same_outcome(lambda: getattr(got, fn)(n),
                          lambda: getattr(want, fn)(n))
        for space in ("", "JRC2018_Unisex_20x_HR",
                      "JRC2018_VNC_Unisex_40x_DS"):
            _same_outcome(lambda: got.extract_objective(n, space),
                          lambda: want.extract_objective(n, space))
    for a in (None, "20x", "40x", "63X"):
        for b in (None, "20x", "40x", "63x"):
            assert got.match_objectives(a, b) == want.match_objectives(a, b)
    z = tmp_path / "lms.zip"
    with zipfile.ZipFile(z, "w") as zf:
        for p in sorted((fixtures_dir / "lms").glob("*")):
            zf.write(p, f"sub/{p.name}")
        zf.writestr("sub/readme.txt", "x")

    def entries(found):
        return [(e.store_base_path, e.store_entry_type.name, e.image_path,
                 e.entry_name, e.file_data().to_json()) for e in found]

    for loc in (fixtures_dir / "lms", fixtures_dir / "grad", z,
                tmp_path / "none"):
        assert entries(got.list_store_images(str(loc))) == \
            entries(want.list_store_images(str(loc)))
    locs = [str(fixtures_dir / "ems"), str(fixtures_dir / "grad"),
            str(fixtures_dir / "zgap"), str(z)]
    for em in (False, True):
        gi, wi = got.index_mip_stores(locs, em), want.index_mip_stores(locs,
                                                                      em)
        assert {k: entries(v) for k, v in gi.items()} == \
            {k: entries(v) for k, v in wi.items()}
        for nid in sorted(wi) + ["no-such-id"]:
            for ch, obj in ((-1, None), (1, "40x"), (0, "20x")):
                for state in (False, True):
                    kw = dict(match_neuron_state=state,
                              source_cdm_name=f"{nid}_LV_CDM.tif")
                    g = got.lookup_variant_images(
                        nid, gi, em, ch, obj, "JRC2018_Unisex_20x_HR", **kw)
                    w = want.lookup_variant_images(
                        nid, wi, em, ch, obj, "JRC2018_Unisex_20x_HR", **kw)
                    assert entries(g) == entries(w)



def _case_jacs_neuron_from_mip(tmp_path, fixtures_dir):
    """em_neuron_from_mip and lm_neuron_from_mip on the JACS fake's MIP
    records (tests/test_jacs_client.py), with and without an alignment
    space of their own."""
    from colormipsearch_tpu import jacs as want
    from colormipsearch_torch import jacs as got
    import test_jacs_client as ref
    for doc in ref.EM_MIPS + [ref.LM_MIP, ref.BARE_LM_MIP, ref.BARE_EM_MIP]:
        for d in (doc, {k: v for k, v in doc.items()
                        if k != "alignmentSpace"}):
            for fn in ("em_neuron_from_mip", "lm_neuron_from_mip"):
                g, w = (getattr(j, fn)(j.ColorDepthMIP.from_dict(d), "lib",
                                       "JRC2018_Unisex_20x_HR").to_dict()
                        for j in (got, want))
                assert g == w

def _case_lut(tmp_path, fixtures_dir):
    from colormipsearch_tpu.cds import lut as want
    from colormipsearch_torch.cds import lut as got
    np.testing.assert_array_equal(got.slice_number_table(),
                                  want.slice_number_table())
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, size=(40, 90, 3), dtype=np.uint8)
    rgb[0, :, 0] = rgb[0, :, 1]
    rgb[1] = 0
    np.testing.assert_array_equal(got.slice_plane(rgb), want.slice_plane(rgb))
    a = rng.integers(0, 257, (40, 90))
    b = rng.integers(0, 257, (40, 90))
    a[0], b[1] = 0, 0
    np.testing.assert_array_equal(got.slice_gap(a, b), want.slice_gap(a, b))


def _case_shape_oracle(tmp_path, fixtures_dir):
    """Host planes of a crop of the golden fixtures: query planes with and
    without an ROI, a border and label regions, the mirrored ROI planes,
    and target planes from z-gap files and on the fly."""
    from colormipsearch_tpu.cds import shape_oracle as want
    from colormipsearch_tpu.imageproc.io import Image as WImage
    from colormipsearch_torch.cds import shape_oracle as got
    from colormipsearch_torch.imageproc.io import Image as GImage
    from colormipsearch_torch.imageproc.io import load_image as gload
    bjd = ("BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
           "2483089192251293794-CH2-01_CDM")
    crop = (slice(150, 350), slice(300, 700))

    def both(path):
        img = gload(str(path))
        px = np.ascontiguousarray(img.pixels[crop])
        return GImage(img.kind, px), WImage(want.ImageKind(img.kind.value), px)

    qg, qw = both(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    tg, tw = both(fixtures_dir / "lms" / f"{bjd}.tif")
    gg, gw = both(fixtures_dir / "grad" / f"{bjd}.png")
    zg, zw = both(fixtures_dir / "zgap" / f"{bjd}.tif")
    rng = np.random.default_rng(12)
    excluded = rng.random(qg.shape) < 0.05
    roi = np.full(qg.shape + (3,), 255, np.uint8)
    roi[:, roi.shape[1] // 2:] = 0
    roi_g, roi_w = (GImage(qg.kind, roi),
                    WImage(qw.kind, roi))

    def same_query(a, b):
        for name in ("q_nonzero", "q_slice", "q_mask", "high_expr"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        (r0, r1), (w0, w1) = a.active_row_range(), b.active_row_range()
        assert w0 <= r0 and r1 <= w1 and r0 % 8 == 0

    for exc in (None, excluded):
        for roi_pair in ((None, None), (roi_g, roi_w)):
            for border in (0, 4):
                same_query(
                    got.build_query_shape_planes(qg, exc, roi_pair[0], border),
                    want.build_query_shape_planes(qw, exc, roi_pair[1],
                                                  border))
        same_query(got.build_mirrored_query_shape_planes(qg, exc, roi_g, 4),
                   want.build_mirrored_query_shape_planes(qw, exc, roi_w, 4))
        for zpair in ((zg, zw), (None, None)):
            a = got.build_target_shape_planes(tg, gg, zpair[0], 20, exc)
            b = want.build_target_shape_planes(tw, gw, zpair[1], 20, exc)
            for name in ("t_above", "grad", "z_nonzero", "z_slice"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
        np.testing.assert_array_equal(got.compute_zgap_image(tg, 20, exc),
                                      want.compute_zgap_image(tw, 20, exc))


# ---- the copies of the store layer and of the export's host modules -------

def _case_field_updates(tmp_path, fixtures_dir):
    """dataio.base's additions: the handlers, apply_field_updates and the
    CDMIPsWriter interface."""
    from colormipsearch_tpu.dataio import base as want
    from colormipsearch_torch.dataio import base as got
    for mod in (got, want):
        assert mod.CDMIPsWriter.__abstractmethods__ == frozenset(
            {"open", "write", "add_processing_tags", "close"})
    docs = []
    for mod in (got, want):
        doc = {"tags": ["a"], "n": 1}
        mod.apply_field_updates(doc, {"tags": mod.AppendField({"c", "b"}),
                                      "n": mod.IncField(2),
                                      "x": mod.SetOnCreateField(1)}, True)
        mod.apply_field_updates(doc, {"tags": mod.RemoveField("a"),
                                      "n": mod.UnsetField()}, False)
        docs.append(doc)
    assert docs[0] == docs[1] == {"tags": ["b", "c"], "x": 1}


def _case_ppp_match_entity(tmp_path, fixtures_dir):
    """PPPMatchEntity (its JSON form, its sample-name and objective
    parses and its export metadata) and the PPP screenshot kinds."""
    import test_ppp_export as ppp

    from colormipsearch_tpu import model as want
    from colormipsearch_torch import model as got
    for m in ppp._build_matches():
        d = m.to_dict()
        g = got.PPPMatchEntity.from_dict(d)
        assert g.to_dict() == want.PPPMatchEntity.from_dict(d).to_dict() == d
        for fn in ("extract_lm_sample_name", "source_objective",
                   "matched_target_metadata"):
            assert getattr(g, fn)() == getattr(m, fn)()
        assert g.has_source_image_files == m.has_source_image_files
    assert [(t.name, t.file_type.name, t.has_thumbnail)
            for t in got.PPPScreenshotType] == \
        [(t.name, t.file_type.name, t.has_thumbnail)
         for t in want.PPPScreenshotType]
    for name in ("a_1_raw.png", "a_6_ch_skel.png", "a.tif", "x_5_ch.png"):
        g = got.PPPScreenshotType.find_screenshot_type(name)
        w = want.PPPScreenshotType.find_screenshot_type(name)
        assert (g and g.name) == (w and w.name)


def _case_sqlite_store(tmp_path, fixtures_dir):
    """SqliteStore: the match fixtures written and read back by mask and
    by target, as the reference's store does."""
    from colormipsearch_tpu.dataio import db as want
    from colormipsearch_torch.dataio import db as got
    reads = []
    for mod, io_name in ((got, "colormipsearch_torch"),
                         (want, "colormipsearch_tpu")):
        io = __import__(f"{io_name}.dataio", fromlist=["DataSourceParam"])
        model = __import__(f"{io_name}.model", fromlist=["CDMatchEntity"])
        store = mod.SqliteStore(str(tmp_path / f"{io_name}.db"))
        mod.DBNeuronMatchesWriter(store).write(
            [model.CDMatchEntity.from_dict(d)
             for d in _match_dicts(fixtures_dir)])
        reader = mod.DBNeuronMatchesReader(store)
        masks = reader.list_match_locations([io.DataSourceParam()])
        targets = reader.list_target_locations([io.DataSourceParam()])
        by_mask = reader.read_matches_by_mask(io.DataSourceParam(
            mip_ids=masks[:1]))
        by_target = reader.read_matches_by_target(io.DataSourceParam(
            mip_ids=targets[:1]))
        reads.append((masks, targets,
                      [(m.matched_image.mip_id, m.matching_pixels)
                       for m in by_mask],
                      [(m.mask_image.mip_id, m.matching_pixels)
                       for m in by_target],
                      store.distinct_neuron_values("library_name")))
        store.close()
    assert reads[0] == reads[1] and reads[0][2]


def _case_mongo_pushdown(tmp_path, fixtures_dir):
    """db_mongo's server-side selector and score-filter clauses."""
    from colormipsearch_tpu.dataio import DataSourceParam as WParam
    from colormipsearch_tpu.dataio import ScoresFilter as WFilter
    from colormipsearch_tpu.dataio import db_mongo as want
    from colormipsearch_torch.dataio import DataSourceParam as GParam
    from colormipsearch_torch.dataio import ScoresFilter as GFilter
    from colormipsearch_torch.dataio import db_mongo as got
    params = [{}, {"alignment_space": "JRC2018_Unisex_20x_HR",
                   "libraries": ["a", "b"], "mip_ids": ["m1"],
                   "names": ["n"], "entity_ids": {3, 1},
                   "source_ref_ids": {"s"}, "datasets": {"d2", "d1"},
                   "tags": {"t"}, "excluded_tags": {"x"},
                   "annotations": {"KC"}, "excluded_annotations": {"y"},
                   "processing_tags": {"ColorDepthSearch": {"r1"}}}]
    for p in params:
        assert got.selector_pushdown_clauses("maskImage", GParam(**p)) == \
            want.selector_pushdown_clauses("maskImage", WParam(**p))
    for sel in ([], [("matchingRatio", 0.5)],
                [("gradientAreaGap|bidirectionalAreaGap", -1)],
                [("gradientAreaGap|bidirectionalAreaGap", 0),
                 ("normalizedScore", 10)]):
        fg, fw = GFilter(), WFilter()
        for name, v in sel:
            fg.add(name, v)
            fw.add(name, v)
        assert got.scores_pushdown_clauses(fg) == \
            want.scores_pushdown_clauses(fw)


def _case_backends(tmp_path, fixtures_dir):
    """cmd.backends: the reader and writer of each backend, one store per
    path until close_stores()."""
    from colormipsearch_tpu.cmd import backends as want
    from colormipsearch_torch.cmd import backends as got
    md = str(tmp_path / "md")
    for db in (None, str(tmp_path / "b.db")):
        for fn in ("matches_reader", "matches_writer"):
            assert type(getattr(got, fn)(db, md)).__name__ == \
                type(getattr(want, fn)(db, md)).__name__
    assert got.matches_writer(str(tmp_path / "b.db"), None,
                              update_scores_only=True).update_scores_only
    path = str(tmp_path / "c.db")
    store = got.get_store(path)
    assert got.get_store(path) is store
    got.close_stores()
    assert got._stores == {}
    assert got.get_store(path) is not store
    got.close_stores()


def _case_jacs_client(tmp_path, fixtures_dir):
    """jacs.client: the JACS records, the MIP cache with its ref
    hydration (a stand-in client serves the fetches) and the library-name
    mapping."""
    import dataclasses
    import json

    from colormipsearch_tpu.jacs import client as want
    from colormipsearch_torch.jacs import client as got
    with open(fixtures_dir.parent / "export_golden" / "jacs_mips.json") as f:
        docs = json.load(f)
    docs = docs + [{"id": "m-ref", "emBodyRef": "EMBody#7"},
                   {"id": "m-sample", "sampleRef": "Sample#9"}]
    for d in docs:
        g, w = got.ColorDepthMIP.from_dict(d), want.ColorDepthMIP.from_dict(d)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        for fn in ("em_body_id", "em_dataset", "em_terms", "lm_line_name",
                   "lm_slide_code", "lm_gender", "lm_release_names"):
            assert getattr(g, fn)() == getattr(w, fn)()

    def stand_in(mod):
        class Client:
            def retrieve_color_depth_mips_by_ids(self, ids):
                return [mod.ColorDepthMIP.from_dict(d) for d in docs
                        if d["id"] in ids]

            def retrieve_em_bodies_by_refs(self, refs):
                return [mod.CDMIPBody.from_dict(
                    {"_id": r.split("#")[1], "datasetIdentifier": "ds"})
                    for r in refs]

            def retrieve_lm_samples_by_refs(self, refs):
                return [mod.CDMIPSample.from_dict(
                    {"_id": r.split("#")[1], "publishingName": "L"})
                    for r in refs]
        return Client()

    cached = []
    for mod in (got, want):
        helper = mod.CachedDataHelper(stand_in(mod), read_batch_size=1)
        helper.prefetch([d["id"] for d in docs] + ["absent"])
        helper.set_library_name_mapping({"a": "A"})
        cached.append(([dataclasses.asdict(helper.get(d["id"]))
                        for d in docs], helper.get("absent"),
                       helper.get_library_name("a"),
                       helper.get_library_name("b")))
    assert cached[0] == cached[1]
    assert cached[0][0][-1]["sample"]["publishing_name"] == "L"
    maps = []
    for mod in (got, want):
        real = mod.http_get_json
        mod.http_get_json = lambda url, retries=3: {
            "config": {"lib1": {"name": "Lib One"}, "lib2": None}}
        try:
            maps.append(mod.retrieve_library_name_mapping("http://cfg/"))
        finally:
            mod.http_get_json = real
    assert maps[0] == maps[1] == {"lib1": "Lib One", "lib2": None}


def _case_dataexport(tmp_path, fixtures_dir):
    """cmd.dataexport: URL relativization, image-store mapping and the
    published URL and LM-stack loaders."""
    import json

    from colormipsearch_tpu.cmd import dataexport as want
    from colormipsearch_torch.cmd import dataexport as got
    urls = ["https://s3.amazonaws.com/bucket/JRC2018/lib/a.png",
            "/nrs/path/to/b.png", "c.png", None, "https://host/x"]
    specs = ["CDM=2", "SignalMip=1,nonhttp"]
    tg = got.URLTransformer(3, got.parse_file_type_indexes(specs))
    tw = want.URLTransformer(3, want.parse_file_type_indexes(specs))
    for ft in ("CDM", "SignalMip", "CDMThumbnail", None):
        for u in urls:
            assert tg.relativize_url(ft, u) == tw.relativize_url(ft, u)
    store_specs = ["JRC2018_Unisex_20x_HR=brain",
                   "JRC2018_Unisex_20x_HR:flyem=hemibrain"]
    mg = got.parse_image_store_mapping("default", store_specs)
    mw = want.parse_image_store_mapping("default", store_specs)
    for space, lib in (("JRC2018_Unisex_20x_HR", "flyem"),
                       ("JRC2018_Unisex_20x_HR", "other"), ("VNC", None),
                       (None, None)):
        assert mg.get_image_store(space, lib) == mw.get_image_store(space, lib)
    for mod in (got, want):
        with pytest.raises(ValueError):
            mod.parse_file_type_indexes(["CDM"])
    uploaded = {"cdm": "u1", "cdm_thumbnail": "u2", "skeletonswc": "u3",
                "searchable_neurons": "u4"}
    files = {"CDM": "old"}
    for is_em in (True, False):
        assert got.apply_published_urls(files, uploaded, is_em) == \
            want.apply_published_urls(files, uploaded, is_em)
    stacks = {"VisuallyLosslessStack": "v", "Gal4Expression": "g", "x": "y"}
    assert got.apply_published_lm_stacks(files, stacks) == \
        want.apply_published_lm_stacks(files, stacks)
    path = tmp_path / "docs.json"
    path.write_text(json.dumps([{"_id": 1, "uploaded": {"cdm": "a"}},
                                {"id": "s1", "slideCode": "sc",
                                 "files": {"Gal4Expression": "g"}},
                                {"uploaded": {}}]))
    for fn in ("load_published_urls", "load_published_lm_stacks"):
        assert getattr(got, fn)(str(path)) == getattr(want, fn)(str(path))


HOST_COPY_CASES = {
    "dataio.base.apply_field_updates": _case_field_updates,
    "model.PPPMatchEntity": _case_ppp_match_entity,
    "dataio.db.SqliteStore": _case_sqlite_store,
    "dataio.db_mongo": _case_mongo_pushdown,
    "cmd.backends": _case_backends,
    "jacs.client": _case_jacs_client,
    "cmd.dataexport": _case_dataexport,
    "model.CDMatchEntity.grad_score": _case_match_score_helpers,
    "dataio.base.ScoresFilter": _case_scores_filter,
    "dataio.fs.JSONNeuronMatchesReader": _case_matches_reader,
    "results.select_best_matches": _case_select_best_matches,
    "cds.scores": _case_scores,
    "results.normalize_match_scores": _case_normalize,
    "imageproc.colors": _case_colors,
    "imageproc.filters": _case_filters,
    "imageproc.filters.short_planes": _case_filters_short_planes,
    "model.enums.FileType.ppp_suffix": _case_enums_ppp_suffix,
    "mips.loader.filedata_exists": _case_mips_loader,
    "dataio.fs.JSONCDMIPsWriter": _case_json_mips_writer,
    "ppp.raw_reader": _case_ppp_raw_reader,
    "cmd.mipstores": _case_mipstores,
    "jacs.client.neuron_from_mip": _case_jacs_neuron_from_mip,
    "cds.lut": _case_lut,
    "cds.shape_oracle": _case_shape_oracle,
    "cds.oracle.shift_ring_offsets": _case_shift_ring_offsets,
    "cds.exact_ratio.c9_split": _case_c9_split,
    "cmd.args": _case_cmd_args,
    "imageproc.regions": _case_label_regions,
    "imageproc.io": _case_load_image,
    "model": _case_model_entities,
    "dataio.fs": _case_json_reader_writer,
    "results.partition_collection": _case_partition_collection,
    "persist.TimebasedIdGenerator": _case_id_generator,
    "native.mipops": _case_native_pack,
    "mips.MIPsCache": _case_mips_cache,
}


@pytest.mark.parametrize("name", sorted(HOST_COPY_CASES))
def test_host_module_copy(name, tmp_path, fixtures_dir):
    """Each copy of a host module of the JAX package gives the reference's
    results on the same inputs."""
    HOST_COPY_CASES[name](tmp_path, fixtures_dir)
