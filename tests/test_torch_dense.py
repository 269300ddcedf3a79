"""The port's dense engine (`colormipsearch_torch/cds/pixel_kernel.py`) and
factory (`cds/factory.py`) against the JAX package's, exactly, on inputs
made from a seed with numpy and on the golden fixtures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu.cds import factory as ref_factory  # noqa: E402
from colormipsearch_tpu.cds import pixel_kernel as ref  # noqa: E402
from colormipsearch_tpu.cds.oracle import shift_ring_offsets  # noqa: E402
from colormipsearch_tpu.cds.pixel_pallas import _PACK_ZT9_MAX  # noqa: E402
from colormipsearch_tpu.cds.shape_oracle import \
    ShapeScoreOracle  # noqa: E402
from colormipsearch_tpu.imageproc.io import \
    image_from_array as ref_image  # noqa: E402

from colormipsearch_torch.cds import factory  # noqa: E402
from colormipsearch_torch.cds import pixel_kernel as pk  # noqa: E402
from colormipsearch_torch.imageproc.io import (image_from_array,  # noqa: E402
                                               load_image)
from colormipsearch_torch.imageproc.regions import \
    label_regions_mask  # noqa: E402

CPU = torch.device("cpu")


def _random_rgb(rng, shape, zero_frac):
    px = rng.integers(0, 256, size=shape + (3,)).astype(np.uint8)
    px[rng.random(shape) < zero_frac] = 0
    return px


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(2024)
    h, w = 40, 96
    queries = [_random_rgb(rng, (h, w), 0.5) for _ in range(3)]
    targets = _random_rgb(rng, (6, h, w), 0.4)
    targets[4] = targets[1]  # equal targets: tied scores
    return queries, targets


@pytest.mark.parametrize("pad", [1, 2, 4])
def test_pack_targets_equals_jax(small, pad):
    _, targets = small
    want = ref.pack_targets(jnp.asarray(targets), 20, pad)
    got = pk.pack_targets(targets, 20, pad)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the flip is of the padded plane
    np.testing.assert_array_equal(got[1].numpy(),
                                  got[0].numpy()[:, :, ::-1])


# zt9 on each side of the reference's fused-predicate limit
@pytest.mark.parametrize("pcf", [1.0, 6.0])
@pytest.mark.parametrize("xy_shift", [0, 2, 4])
@pytest.mark.parametrize("mirror", [True, False])
def test_pixel_match_packed_equals_jax(small, pcf, xy_shift, mirror):
    queries, targets = small
    zt9 = ref.z_tolerance_to_zt9(pcf)
    assert (zt9 <= _PACK_ZT9_MAX) == (pcf == 1.0)
    q_words = np.stack([ref.prepare_query_planes(ref_image(q), 20).words
                        for q in queries])
    pad = max(xy_shift, 1)
    shifts = np.asarray(shift_ring_offsets(xy_shift), dtype=np.int32)
    tp, tf = ref.pack_targets(jnp.asarray(targets), 20, pad)
    want_s, want_m = ref.pixel_match_packed(
        jnp.asarray(q_words), tp, tf, jnp.asarray(shifts), zt9=zt9,
        mirror=mirror)
    gp, gf = pk.pack_targets(targets, 20, pad)
    # all targets in one chunk; at xyShift 2 also one target per chunk
    for max_elems in ((q_words[0].size * 3, pk.DENSE_CHUNK_ELEMS)
                      if xy_shift == 2 else (pk.DENSE_CHUNK_ELEMS,)):
        got_s, got_m = pk.pixel_match_packed(torch.from_numpy(q_words), gp,
                                             gf, shifts, zt9, mirror,
                                             max_elems=max_elems)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if mirror:
        assert got_m.any() and not got_m.all()


def test_shift_outside_pad_raises(small):
    queries, targets = small
    q = torch.from_numpy(pk.prepare_query_planes(queries[0], 20).words)[None]
    gp, gf = pk.pack_targets(targets, 20, 1)
    with pytest.raises(ValueError, match="exceed the pad"):
        pk.pixel_match_packed(q, gp, gf, [(0, 0), (2, 0)], 10_000_000, True)


def test_engine_equals_jax(small):
    """PixelMatchEngine.score_batch, and a query that selects nothing."""
    queries, targets = small
    for q in queries + [np.zeros_like(queries[0])]:
        want = ref.PixelMatchEngine(ref_image(q), 20, True, 20, 2.0, 2,
                                    None).score_batch(targets)
        got = pk.PixelMatchEngine(image_from_array(q), 20, True, 20, 2.0, 2,
                                  None).score_batch(targets, CPU)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


LMS = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
       "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
       "2483089192251293794-CH2-01_CDM.tif",
       "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01.tif"]


def test_dense_goldens(fixtures_dir):
    """EM 12191 against the three scored LMs: 439 / 414 / 426, the last
    mirrored."""
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    targets = np.stack([load_image(fixtures_dir / "lms" / n).pixels
                        for n in LMS])
    engine = pk.PixelMatchEngine(query, 20, True, 20, 1.0, 2,
                                 label_regions_mask(query.height,
                                                    query.width))
    scores, ratios, mirrored = engine.score_batch(targets, CPU)
    assert scores.tolist() == [439, 414, 426]
    assert mirrored.tolist() == [False, False, True]
    np.testing.assert_array_equal(ratios,
                                  scores / engine.planes.query_size)


@pytest.mark.parametrize("engine", ["dense", "pallas"])
@pytest.mark.parametrize("neg", [False, True])
def test_factory_equals_jax(small, engine, neg):
    """create_pixel_match_engine, with and without a negative query: the
    port's dense and two-phase engines equal the JAX dense engine."""
    queries, targets = small
    q, nq = queries[0], queries[1]
    kw = dict(use_label_regions=False, neg_query_threshold=20,
              mirror_neg_query=True)
    want = ref_factory.create_pixel_match_engine(
        ref_image(q), 20, True, 20, 2.0, 2, engine="dense",
        neg_query=ref_image(nq) if neg else None, **kw).score_batch(targets)
    eng = factory.create_pixel_match_engine(
        image_from_array(q), 20, True, 20, 2.0, 2, engine=engine,
        neg_query=image_from_array(nq) if neg else None, **kw)
    assert isinstance(eng, factory.NegQueryPixelMatchEngine) == neg
    got = eng.score_batch(targets, CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if neg:
        assert eng.query_size == eng.pos.planes.query_size


def test_factory_checks():
    img = image_from_array(np.zeros((16, 128, 3), np.uint8))
    with pytest.raises(ValueError, match="even number"):
        factory.create_pixel_match_engine(img, xy_shift=3)
    with pytest.raises(ValueError, match="engine"):
        factory.create_pixel_match_engine(img, engine="xla")
    # label regions: the default excludes the label boxes
    eng = factory.create_pixel_match_engine(
        image_from_array(np.full((16, 400, 3), 200, np.uint8)), 20,
        engine="dense")
    assert eng.planes.query_size == 16 * 400 - 16 * 330 - 16 * 270 + 16 * 200
    for args in ((0, 0.0, 0.0), (5, 0.01, 1.0), (5, 0.02, 1.0),
                 (5, 0.5, 0.0)):
        assert factory.is_match(*args) == ref_factory.is_match(*args)


@pytest.mark.parametrize("roi", [False, True])
def test_shape_scorer_equals_jax(roi):
    """create_shape_match_scorer on the CPU equals the JAX package's
    ShapeScoreOracle, with and without an ROI mask."""
    rng = np.random.default_rng(9)
    h, w = 72, 136  # the reference's 60 px dilation needs h > 60
    query = _random_rgb(rng, (h, w), 0.7)
    roi_px = np.full((h, w, 3), 255, np.uint8)
    roi_px[:, w // 2:] = 0
    kw = dict(use_label_regions=False, border=2)
    oracle = ShapeScoreOracle(
        ref_image(query), 20, True, None,
        ref_image(roi_px) if roi else None, border=2)
    scorer = factory.create_shape_match_scorer(
        image_from_array(query), 20, True,
        roi_mask=image_from_array(roi_px) if roi else None, **kw)
    for i in range(4):
        target = _random_rgb(rng, (h, w), 0.5)
        grad = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
        if i == 1:
            target = target[:, ::-1].copy()
        want = oracle.score(ref_image(target), ref_image(grad))
        got = scorer.score(image_from_array(target), image_from_array(grad),
                           device="cpu")
        assert (got.gradient_area_gap, got.high_expression_area,
                got.mirrored) == (want.gradient_area_gap,
                                  want.high_expression_area, want.mirrored)
