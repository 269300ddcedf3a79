"""The launch table (MultiMaskScorer.table through multimask.launch_table:
its plain PyTorch version on CPU tensors, which the card's kernel
`csrc/launch_table.cu` is held to in tests/test_torch_cuda.py) equals a
NumPy build of the same rule (`build_table` below, the oracle) array for
array, on seeded random survivors, signal extents and live-tile bitmaps;
its room past row_off[R] changes neither the kernels' window bins nor the
exact counts."""

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


def _direction_codes(scorer, n_targets, signal_ranges, tile_live):
    """uint8 [n_targets * gh * gw]: for each target and tile position
    (ty * gw + tx) on the mask tile grid, the directions (bit 0 direct,
    bit 1 mirrored) in which a tile there can score against that target."""
    gh, gw = scorer._grid
    s, sx = scorer._reach
    live_d = np.ones((n_targets, gh, gw), bool)
    # the launch's mirror setting, not the engine's
    live_m = live_d if scorer.mirror else np.zeros_like(live_d)
    if tile_live is not None:
        live_d = live_d & tile_live[0]
        live_m = live_m & tile_live[1]
    if signal_ranges is not None:
        # a tile's shifts sample raw rows [cy - s, cy + 8 + s) and cols
        # [cx - sx, cx + 128 + sx); the mirror pass samples the x-flipped
        # raw plane, whose signal cols are the reflection of the target's
        # about (w - 1) / 2
        rr = np.asarray(signal_ranges).astype(np.int64)
        cy = np.arange(gh) * mm.TILE_H
        rok = ((cy >= rr[:, :1] - mm.TILE_H - s + 1)
               & (cy <= rr[:, 1:2] + s))[:, :, None]
        live_d = live_d & rok
        live_m = live_m & rok
        if rr.shape[1] >= 4:
            cx = np.arange(gw) * mm.TILE_W
            c0, c1 = rr[:, 2:3], rr[:, 3:4]
            w = scorer._width
            live_d = live_d & ((cx >= c0 - mm.TILE_W - sx + 1)
                               & (cx <= c1 + sx))[:, None, :]
            live_m = live_m & ((cx >= w - 1 - c1 - mm.TILE_W - sx + 1)
                               & (cx <= w - 1 - c0 + sx))[:, None, :]
    return (live_d.view(np.uint8) | (live_m.view(np.uint8) << 1)).ravel()


def build_table(scorer, survivors, signal_ranges=None, tile_live=None):
    """The oracle: the launch table of `survivors` int [B, T] in NumPy,
    as CPU tensors, its tile_list without room (exactly the kept tiles).

    Rows in engine order, each engine's in target order; a row's tiles
    are its engine's listed tiles in tile order, each with the directions
    _direction_codes leaves it at the row's target, those with none left
    out."""
    survivors = np.asarray(survivors)
    eng, dest = np.nonzero(survivors)
    codes = _direction_codes(scorer, survivors.shape[1], signal_ranges,
                             tile_live)
    # the candidates: every row with every listed tile of its engine
    cnt = np.diff(scorer._listed_off)[eng]
    ends = np.cumsum(cnt)
    starts = ends - cnt
    n_cand = int(ends[-1]) if len(ends) else 0
    idx = np.arange(n_cand) + np.repeat(scorer._listed_off[eng] - starts,
                                        cnt)
    gh, gw = scorer._grid
    code = codes[np.repeat(dest * (gh * gw), cnt) + scorer._listed_pos[idx]]
    keep = np.flatnonzero(code)
    arrays = dict(
        row_off=np.searchsorted(keep, np.append(starts, n_cand)),
        tile_list=scorer._listed[idx[keep]]
        | (code[keep].astype(np.int32) << mm.DIR_SHIFT),
        tgt=dest, surv=np.ones(len(eng)), eng=eng)
    return mm.LaunchTable(**{k: torch.from_numpy(v.astype(np.int32))
                             for k, v in arrays.items()})


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
    want = build_table(scorer, surv, ext, bitmaps)
    got = scorer.table(
        surv, "cpu", None if ext is None else torch.from_numpy(ext),
        None if bitmaps is None else tuple(map(torch.from_numpy, bitmaps)))
    n = int(got.row_off[-1])
    for name in ("row_off", "tgt", "surv", "eng"):
        got_t, want_t = getattr(got, name), getattr(want, name)
        assert got_t.dtype == torch.int32, name
        assert torch.equal(got_t, want_t), name
    assert torch.equal(got.tile_list[:n], want.tile_list)
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
