"""The launch table built as the card builds it (multimask.launch_table:
its plain PyTorch version on CPU tensors, which the card's kernel
`csrc/launch_table.cu` is held to in tests/test_torch_cuda.py) equals the
host's NumPy `MultiMaskScorer.build_table` array for array, on seeded
random survivors, signal extents and live-tile bitmaps; its room past
row_off[R] changes neither the kernels' window bins nor the exact
counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, pad_for_predicate)

H, W = 48, 300
# case -> (mirror, extent columns (0: none), live bitmaps, survivor share,
# an engine without a listed tile, targets)
CASES = {
    "mirror": (True, 4, True, 0.4, False, 11),
    "direct": (False, 4, True, 0.4, False, 11),
    "row_extents": (True, 2, True, 0.4, False, 11),
    "no_live": (True, 4, False, 0.4, False, 11),
    "no_cut": (True, 0, False, 0.4, False, 11),
    "no_survivors": (True, 4, True, 0.0, False, 11),
    "empty_engine": (True, 4, True, 0.6, True, 11),
    "one_target": (True, 4, True, 0.7, False, 1),
}


def _frames(rng, n, keep):
    f = rng.integers(0, 256, size=(n, H, W, 3)).astype(np.uint8)
    f[rng.random((n, H, W)) > keep] = 0
    return f


def _inputs(case, seed=2020):
    mirror, n_ext, live, share, empty, n_t = CASES[case]
    rng = np.random.default_rng(seed)
    masks = list(_frames(rng, 5, 0.2))
    if empty:
        masks[2] = np.zeros_like(masks[2])
    engines = [ActiveTilePixelEngine(q, 20, mirror, 20, 1.0, 2)
               for q in masks]
    scorer = mm.MultiMaskScorer(engines)
    surv = (rng.random((len(engines), n_t)) < share).astype(np.int32)
    gh, gw = scorer._grid
    # extents: an empty target (0, -1) now and then, else a random span
    r0, c0 = rng.integers(0, H, size=n_t), rng.integers(0, W, size=n_t)
    r1 = np.minimum(r0 + rng.integers(0, 24, size=n_t), H - 1)
    c1 = np.minimum(c0 + rng.integers(0, 160, size=n_t), W - 1)
    ext = np.stack([r0, r1, c0, c1], axis=1)
    ext[rng.random(n_t) < 0.2] = (0, -1, 0, -1)
    ext = ext.astype(np.int32)[:, :n_ext] if n_ext else None
    bitmaps = (tuple(rng.random((n_t, gh, gw)) < 0.6 for _ in range(2))
               if live else None)
    return scorer, surv, ext, bitmaps, _frames(rng, n_t, 0.5)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_table_equals_build_table(case):
    scorer, surv, ext, bitmaps, targets = _inputs(case)
    want = scorer.build_table(surv, ext, bitmaps)
    got = scorer.device_table(
        surv, "cpu", None if ext is None else torch.from_numpy(ext),
        None if bitmaps is None else tuple(map(torch.from_numpy, bitmaps)))
    n = int(got.row_off[-1])
    np.testing.assert_array_equal(got.row_off.numpy(), want.row_off)
    np.testing.assert_array_equal(got.tile_list[:n].numpy(), want.tile_list)
    np.testing.assert_array_equal(got.tgt.numpy(), want.tgt)
    np.testing.assert_array_equal(got.surv.numpy(), want.surv)
    np.testing.assert_array_equal(got.eng.numpy(), want.eng)
    # room for every candidate: each row's listed tiles, the rest 0
    listed = np.diff(scorer._listed_off)
    eng = np.nonzero(surv)[0]
    assert got.tile_list.numel() == int(listed[eng].sum())
    assert not got.tile_list[n:].any()
    if case == "empty_engine":
        assert listed[2] == 0 and (eng == 2).any()
    if case not in ("no_survivors", "no_cut"):
        assert 0 < n < got.tile_list.numel()  # the cut left some out
    # the kernels' bins and the exact counts do not see the room
    planes = pad_for_predicate(
        scorer.engines[0].pack_raw_words(targets, "cpu"), "ratio")
    got_args = scorer.kernel_args(planes, got)
    want_args = scorer.kernel_args(planes, want)
    bins = [mm.window_bins(*a[8:], a[7], scorer.frame_shape, len(targets))
            for a in (got_args, want_args)]
    assert torch.equal(bins[0][0], bins[1][0])
    for b in bins:
        assert int(b[0][-1]) == n
    members = [sorted(zip(b[1][:n].tolist(), b[2][:n].tolist()))
               for b in bins]
    assert members[0] == members[1]
    counts = [scorer.counts(a) for a in (got_args, want_args)]
    assert torch.equal(counts[0], counts[1])
    assert counts[0].any() == (case != "no_survivors")
