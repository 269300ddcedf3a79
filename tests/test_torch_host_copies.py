"""The port's host copies (colormipsearch_torch.cds.{pixel_kernel,
ratio_bounds, pixel_active, prescreen}) must equal the JAX package's
functions exactly on the same inputs."""

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
