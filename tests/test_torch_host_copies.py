"""The port's host copies (colormipsearch_torch.cds.{pixel_kernel,
ratio_bounds, pixel_active, prescreen, oracle, exact_ratio} and the host
modules of the colorDepthSearch command) must equal the JAX package's
functions exactly on the same inputs."""

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
    """The copy of mipops packs the words the reference packs, on its
    native path where g++ builds it and on the NumPy path."""
    from colormipsearch_tpu.native import mipops as want
    from colormipsearch_torch.native import mipops as got
    rng = np.random.default_rng(17)
    block = _random_rgb(rng, (3, 40, 70), 0.5)
    for thr in (0, 20, 200):
        w_idx, w_val = want.sparse_pack_block_numpy(block, thr)
        for fn in (got.sparse_pack_block, got.sparse_pack_block_numpy):
            g_idx, g_val = fn(block, thr)
            np.testing.assert_array_equal(g_idx, w_idx)
            np.testing.assert_array_equal(g_val, w_val)
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


HOST_COPY_CASES = {
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
