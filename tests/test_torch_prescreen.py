"""The port's prescreen bound (colormipsearch_torch.cds.prescreen) must
equal the JAX package's PairPrescreen.bounds_from_words exactly, and
dominate the exact score (a fuzz against the reference oracle)."""

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
