"""The target pack's plain version (`pixel_active.pack_words_plain`, what
the card's kernel `csrc/target_pack.cu` is held to) and the port's
`pack_raw_words` on the CPU (the chunked staging loop `stage_frames`,
then `pack_words` with the plain pack in the kernel's place) equal the
JAX package's `pack_raw_words` word for word, on both of its feeds (at
most and above a quarter occupancy, and at the rule's edge), with
channels at and just above the threshold (20 / 21), for 1, 3 and one
more than a staging chunk of targets."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cds.pixel_pallas import \
    ActiveTilePixelEngine as RefEngine  # noqa: E402
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import pixel_active as pa  # noqa: E402
from test_torch_cuda import PACK_FEEDS, pack_frames  # noqa: E402

CPU = torch.device("cpu")
SIZES = [1, 3, pa.STAGE_TARGETS + 1]


@pytest.fixture(scope="module")
def engines():
    q = pack_frames(1, "sparse", seed=9)[0]
    return (RefEngine(image_from_array(q), 20, True, 20, 1.0, 2, None,
                      interpret=True),
            pa.ActiveTilePixelEngine(q, 20, True, 20, 1.0, 2))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("feed", PACK_FEEDS)
def test_plain_pack_equals_host_and_reference(engines, feed, n):
    ref, eng = engines
    frames = pack_frames(n, feed)
    n_sel = int((frames > 20).any(axis=-1).sum())
    assert (n_sel > frames[..., 0].size // 4) == (
        feed in ("dense", "quarter+1"))
    assert ((frames == 20).any() and (frames == 21).any())
    got = pa.pack_words_plain(torch.from_numpy(frames), 20)
    assert got.dtype == torch.int32 and got.shape == frames.shape[:3]
    want = np.asarray(ref.pack_raw_words(frames))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(eng.pack_raw_words(frames, CPU).numpy(),
                                  want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("feed", PACK_FEEDS)
def test_staged_plain_pack_equals_host(engines, feed, n):
    """stage_frames' chunks on the CPU, then pack_words (its plain version
    on a CPU tensor): the bytes arrive whole and the words are the JAX
    package's host feed's."""
    ref, _ = engines
    frames = pack_frames(n, feed, seed=11)
    staged = pa.stage_frames(frames, CPU)
    assert staged.dtype == torch.uint8
    np.testing.assert_array_equal(staged.numpy(), frames)
    np.testing.assert_array_equal(pa.pack_words(staged, 20).numpy(),
                                  np.asarray(ref.pack_raw_words(frames)))


@pytest.mark.parametrize("threshold", [-3, 0, 254, 255, 300])
def test_plain_pack_thresholds(threshold):
    """Thresholds at and beyond the channel's range: the plain pack and
    pack_raw_words equal the JAX package's pack at the same threshold."""
    frames = pack_frames(3, "sparse", seed=13)
    ref = RefEngine(image_from_array(frames[0]), 20, True, threshold, 1.0,
                    2, None, interpret=True)
    eng = pa.ActiveTilePixelEngine(frames[0], 20, True, threshold, 1.0, 2)
    want = np.asarray(ref.pack_raw_words(frames))
    np.testing.assert_array_equal(
        pa.pack_words_plain(torch.from_numpy(frames), threshold).numpy(),
        want)
    np.testing.assert_array_equal(eng.pack_raw_words(frames, CPU).numpy(),
                                  want)


def test_pack_words_checks_its_block():
    with pytest.raises(ValueError, match="uint8"):
        pa.pack_words(torch.zeros((2, 4, 4, 3), dtype=torch.int32), 20)
    with pytest.raises(ValueError, match="uint8"):
        pa.pack_words(torch.zeros((4, 4, 3), dtype=torch.uint8), 20)
