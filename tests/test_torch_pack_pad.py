"""Target pack and pad, signal ranges and live-tile bitmaps of the port
(colormipsearch_torch.cds.{pixel_active,multimask}) must equal the JAX
package's arrays exactly: the 48x160 library of test_multimask.py (dense
and sparse feed) and one full fixture frame."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cds import multimask as ref_mm  # noqa: E402
from colormipsearch_tpu.cds.pixel_pallas import \
    ActiveTilePixelEngine as RefEngine  # noqa: E402
from colormipsearch_tpu.imageproc import load_image  # noqa: E402
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import \
    ActiveTilePixelEngine  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(17)
    h, w = 48, 160
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.8] = 0
    targets = rng.integers(0, 256, size=(29, h, w, 3)).astype(np.uint8)
    targets[rng.random((29, h, w)) < 0.7] = 0
    # banded copy: sparse enough for the sparse feed, with stripes at
    # scattered rows and columns (incl. the frame edges)
    banded = np.zeros_like(targets)
    for i in range(targets.shape[0]):
        b0 = (13 * i) % (h - 10)
        c0 = (41 * i) % (w - 24) if i % 4 else (0 if i % 8 else w - 24)
        banded[i, b0:b0 + 10, c0:c0 + 24] = targets[i, b0:b0 + 10,
                                                    c0:c0 + 24]
    return q, targets, banded


def _engines(q):
    img = image_from_array(q)
    return (RefEngine(img, 20, True, 20, 1.0, 2, None, interpret=True),
            ActiveTilePixelEngine(img, 20, True, 20, 1.0, 2, None))


def _check_frames(ref, eng, targets):
    want_words = np.asarray(ref.pack_raw_words(targets))
    words = eng.pack_raw_words(targets, CPU)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), want_words)
    want_p, want_f = ref.pad_from_words(ref.pack_raw_words(targets))
    got_p, got_f = eng.pad_from_words(words)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(mm.signal_extents(words).numpy(),
                                  ref_mm.signal_ranges_from_words(want_words))
    np.testing.assert_array_equal(mm.row_ranges_from_words(words),
                                  ref_mm.row_ranges_from_words(want_words))
    for got, want in zip(mm.tile_live_dev(words),
                         ref_mm.tile_live_from_words(want_words)):
        np.testing.assert_array_equal(got.numpy(), want)
    return words


@pytest.mark.parametrize("feed", ["dense", "sparse"])
def test_pack_pad_library(library, feed):
    q, targets, banded = library
    ref, eng = _engines(q)
    t = targets if feed == "dense" else banded
    n_sel = int(((t > 20).any(axis=-1)).sum())
    # the reference takes the dense path above 1/4 occupancy
    assert (n_sel > t[..., 0].size // 4) == (feed == "dense")
    _check_frames(ref, eng, t)


def test_dense_pack_block(library):
    """pack_raw_words on a block above a quarter occupancy equals the
    reference's dense pack (used for such blocks)."""
    q, targets, _ = library
    ref, eng = _engines(q)
    assert int((targets > 20).any(axis=-1).sum()) > targets[..., 0].size // 4
    np.testing.assert_array_equal(eng.pack_raw_words(targets, CPU).numpy(),
                                  np.asarray(ref._pack_block(targets)))


def test_pack_pad_fixture_frame(fixtures_dir):
    em = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    lm = load_image(fixtures_dir / "lms" /
                    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01.tif")
    ref = RefEngine(em, 20, True, 20, 1.0, 2, None, interpret=True)
    eng = ActiveTilePixelEngine(em.pixels, 20, True, 20, 1.0, 2, None)
    words = _check_frames(ref, eng, lm.pixels[None])
    assert words.shape == (1, 566, 1210)
    padded, _ = eng.pad_from_words(words)
    assert padded.shape == (1, 584, 1536)
