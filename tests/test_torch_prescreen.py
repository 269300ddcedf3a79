"""The port's prescreen bounds (colormipsearch_torch.cds.prescreen) must
equal the JAX package's exactly: the count-capped bound of
PairPrescreen.bounds_from_words and the target-feature bound
(target_features, then bounds). Each dominates the one before it and the
exact score (a fuzz against the reference oracle): exact <= capped <=
feature."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cds.oracle import PixelMatchOracle  # noqa: E402
from colormipsearch_tpu.cds.pixel_kernel import (  # noqa: E402
    prepare_query_planes, z_tolerance_to_zt9)
from colormipsearch_tpu.cds.prescreen import \
    PairPrescreen as RefPrescreen  # noqa: E402
from colormipsearch_tpu.imageproc import (label_regions_mask,  # noqa: E402
                                          load_image)
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_tpu.cds import prescreen as ref_ps  # noqa: E402

from colormipsearch_torch.cds import prescreen as ps  # noqa: E402
from colormipsearch_torch.cds.pixel_active import \
    ActiveTilePixelEngine  # noqa: E402
from colormipsearch_torch.cds.prescreen import PairPrescreen  # noqa: E402

CPU = torch.device("cpu")


def _bounds(query_words, targets_u8, fluct, xy, h, w):
    zt9 = z_tolerance_to_zt9(fluct)
    # the target pack depends only on the data threshold (20)
    eng = ActiveTilePixelEngine(np.zeros((h, w, 3), np.uint8), 20, True, 20,
                                1.0, 2)
    words = eng.pack_raw_words(targets_u8, CPU)
    screen = PairPrescreen(zt9, xy, h, w)
    u = np.stack([screen.query_features(qw) for qw in query_words])
    got = screen.bounds_from_words(u, words)
    ref = RefPrescreen(zt9, xy, h, w)
    want = np.asarray(ref.bounds_from_words(u, words.numpy()))
    return got, want


@pytest.mark.parametrize("fluct,xy", [(2.0, 2), (1.0, 0), (1.0, 4)])
def test_bounds_equal_reference_and_dominate_exact(fluct, xy):
    rng = np.random.default_rng(17)
    h, w = 48, 160
    qs = []
    for frac in (0.7, 0.9):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < frac] = 0
        qs.append(q)
    t = rng.integers(0, 256, size=(5, h, w, 3)).astype(np.uint8)
    t[rng.random((5, h, w)) < 0.5] = 0
    planes = [prepare_query_planes(image_from_array(q), 20, None)
              for q in qs]
    got, want = _bounds([p.words for p in planes], t, fluct, xy, h, w)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    for qi, q in enumerate(qs):
        oracle = PixelMatchOracle(image_from_array(q), 20, True, 20,
                                  fluct / 100, xy, None)
        for i in range(len(t)):
            exact = oracle.score(image_from_array(t[i])).matching_pixels
            assert got[qi, i] >= exact, (fluct, xy, qi, i, got[qi, i], exact)


def test_bounds_fixture_frames(fixtures_dir):
    """Full 566x1210 frames: the EM fixture against three LM fixtures;
    the bounds equal the reference's and dominate the golden scores."""
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    qp = prepare_query_planes(query, 20, excluded)
    names = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
             "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x"
             "_HR-2483089192251293794-CH2-01_CDM",
             "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01"]
    t = np.stack([load_image(fixtures_dir / "lms" / f"{n}.tif").pixels
                  for n in names])
    got, want = _bounds([qp.words], t, 1.0, 2, query.height, query.width)
    np.testing.assert_array_equal(got, want)
    assert (got[0] >= np.array([439, 414, 426])).all(), got


def test_bounds_restore_tf32_setting():
    """The bound turns TF32 off for its own products only: the caller's
    setting is back after the call."""
    rng = np.random.default_rng(5)
    h, w = 48, 160
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.8] = 0
    t = rng.integers(0, 256, size=(3, h, w, 3)).astype(np.uint8)
    words = [prepare_query_planes(image_from_array(q), 20, None).words]
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got, want = _bounds(words, t, 1.0, 2, h, w)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_array_equal(got, want)


def _pack(targets_u8, h, w):
    eng = ActiveTilePixelEngine(np.zeros((h, w, 3), np.uint8), 20, True, 20,
                                1.0, 2)
    return eng.pack_raw_words(targets_u8, CPU)


def _every_bound(query_words, targets_u8, fluct, xy, h, w):
    """{name: (port, JAX)} for the capped and feature bounds."""
    import jax.numpy as jnp
    zt9 = z_tolerance_to_zt9(fluct)
    words = _pack(targets_u8, h, w)
    screen, ref = PairPrescreen(zt9, xy, h, w), RefPrescreen(zt9, xy, h, w)
    u = np.stack([screen.query_features(qw) for qw in query_words])
    out = {"capped": (screen.bounds_from_words(u, words),
                      np.asarray(ref.bounds_from_words(u, words.numpy())))}
    feats = screen.target_features(words)
    ref_feats = ref.target_features(jnp.asarray(words.numpy()))
    for got, want in zip(feats, ref_feats):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.float32))
    out["feature"] = (screen.bounds(u, feats),
                      np.asarray(ref.bounds(u, ref_feats)))
    return out


@pytest.mark.parametrize("fluct,xy", [(2.0, 2), (1.0, 0), (0.5, 4),
                                     (1.0, 4), (2.0, 0), (0.5, 2)])
def test_feature_bounds_equal_reference(fluct, xy, monkeypatch):
    """Both bounds equal the reference's, and on every pair
    exact <= capped <= feature; the caller's TF32 setting is back after
    each."""
    rng = np.random.default_rng(23)
    h, w = 40, 300  # a partial last tile in both directions
    qs = []
    for frac in (0.6, 0.85, 0.97):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < frac] = 0
        qs.append(q)
    t = rng.integers(0, 256, size=(4, h, w, 3)).astype(np.uint8)
    t[rng.random((4, h, w)) < 0.6] = 0
    t[3] = 0  # an empty target
    words = [prepare_query_planes(image_from_array(q), 20, None).words
             for q in qs]
    # each bound turns TF32 off for its own products only
    seen = []
    real = ps._bounds_matmul

    def spy(*a):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a)

    monkeypatch.setattr(ps, "_bounds_matmul", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        bounds = _every_bound(words, t, fluct, xy, h, w)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False]
    for name, (got, want) in bounds.items():
        assert got.shape == (3, 4) and got.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    capped, feature = bounds["capped"][0], bounds["feature"][0]
    assert (capped <= feature).all()
    assert (feature[:, 3] == 0).all()
    for qi, q in enumerate(qs):
        oracle = PixelMatchOracle(image_from_array(q), 20, True, 20,
                                  fluct / 100, xy, None)
        for i in range(len(t)):
            exact = oracle.score(image_from_array(t[i])).matching_pixels
            assert capped[qi, i] >= exact, (qi, i, capped[qi, i], exact)


@pytest.mark.parametrize("block", [1, 2, 5])
def test_target_features_given_flipped_frames_and_blocks(block, monkeypatch):
    """Mirrored features from pre-flipped frames equal those of the flip
    done here, across FEATURE_BLOCK sub-blocks; an empty block gives
    empty features and bounds."""
    rng = np.random.default_rng(4)
    h, w = 24, 140
    t = rng.integers(0, 256, size=(5, h, w, 3)).astype(np.uint8)
    t[rng.random((5, h, w)) < 0.5] = 0
    words = _pack(t, h, w)
    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2, h, w)
    monkeypatch.setattr(PairPrescreen, "FEATURE_BLOCK", block)
    wd, wm = screen.target_features(words)
    wd2, wm2 = screen.target_features(words, torch.flip(words, dims=(2,)))
    assert torch.equal(wd, wd2) and torch.equal(wm, wm2)
    one = ps.target_features(words[:1], screen.zt9, 2, screen.grid_hw, True)
    assert torch.equal(one, wm[:1])
    ed, em = screen.target_features(words[:0])
    assert ed.shape == (0, wd.shape[1]) and em.shape == ed.shape
    u = np.ones((2, wd.shape[1]), np.float32)
    assert screen.bounds(u, (ed, em)).shape == (2, 0)


@pytest.mark.parametrize("pad", [1, 2, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_or_dilate_matches_reduce_window(pad, dim):
    """The separable OR-dilation equals lax.reduce_window with "same"
    padding, on random bit planes with bit 31 set."""
    import jax
    rng = np.random.default_rng(8)
    x = rng.integers(-2**31, 2**31, size=(2, 3, 9, 21), dtype=np.int64
                     ).astype(np.int32)
    win = [1, 1, 1, 1]
    win[dim] = 2 * pad + 1
    want = jax.lax.reduce_window(x, np.int32(0), jax.lax.bitwise_or,
                                 tuple(win), (1, 1, 1, 1), "same")
    got = ps._or_dilate(torch.from_numpy(x), dim, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 7, 8])
@pytest.mark.parametrize("dim", [0, 2])
def test_or_reduce_equals_numpy(n, dim):
    """or_reduce (halving ORs) equals numpy's bitwise_or.reduce on int32
    with the sign bit set, on odd and even lengths."""
    rng = np.random.default_rng(n)
    shape = [3, 4, 5]
    shape[dim] = n
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64
                     ).astype(np.int32)
    got = ps.or_reduce(torch.from_numpy(x), dim)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bitwise_or.reduce(x, axis=dim))
