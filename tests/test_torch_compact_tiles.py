"""The exact kernels' compact lists (pixel_active.compact_selected), their
prepared ratio planes (pad_ratio_planes) and their window bins
(multimask.window_bins), on the CPU.

The masks hold the lists' edges: a tile that is active but has no pixel
that can match (gray, sector 0), a tile with one selected pixel, a full
tile (1024), a sparse mask cut from a fixture neuron, and the whole set
again at zTolerance 0. The plain versions computed from the lists equal
the JAX package's `_multimask_call_ratio` and `_multimask_call` (its
MultiMaskScorer in interpret mode) exactly, and the prepared planes equal
its `_ratio_prep` bit for bit."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu.cds import multimask as ref_mm  # noqa: E402
from colormipsearch_tpu.cds import pixel_pallas as ref_pp  # noqa: E402
from colormipsearch_tpu.imageproc import load_image  # noqa: E402
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds import pixel_active as pa  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, ActiveTiles, pad_for_predicate)
from torch_launch import engine_results  # noqa: E402

H, W = 48, 400
N_T = 8  # targets: one small block keeps the interpreted JAX runs short
EDGE_COUNTS = [0, 1, 1024]  # selected pixels of the edge mask's tiles


def _edge_mask(rng):
    """Tile (0, 0) gray (active, no pixel can match), one coloured pixel in
    tile (0, 1), tile (0, 2) full of r > g > b > 0 (all 1024 selected)."""
    m = np.zeros((H, W, 3), np.uint8)
    m[0:8, 0:128] = 120
    m[3, 130] = (200, 60, 20)
    m[0:8, 256:384] = np.stack([rng.integers(180, 256, (8, 128)),
                                rng.integers(60, 170, (8, 128)),
                                rng.integers(1, 50, (8, 128))], axis=-1)
    m[20:40, 150:278] = m[0:8, 256:384].repeat(3, axis=0)[:20] // 2
    return m


@pytest.fixture(scope="module")
def library(fixtures_dir):
    rng = np.random.default_rng(31)
    em = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif").pixels
    lms = sorted((fixtures_dir / "lms").iterdir())
    # a sparse neuron: the fixture's densest H x W window
    rows = (em > 20).any(axis=2).sum(axis=1)
    r0 = int(np.argmax(np.convolve(rows, np.ones(H), "valid")))
    cols = (em[r0:r0 + H] > 20).any(axis=2).sum(axis=0)
    c0 = int(np.argmax(np.convolve(cols, np.ones(W), "valid")))
    masks = [_edge_mask(rng), np.ascontiguousarray(em[r0:r0 + H, c0:c0 + W])]
    targets = np.zeros((N_T, H, W, 3), np.uint8)
    for i in range(N_T):
        if i < len(lms):
            lm = load_image(lms[i]).pixels
            targets[i] = lm[r0:r0 + H, c0:c0 + W]
        else:
            px = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
            px[rng.random((H, W)) < 0.6] = 0
            targets[i] = px
    targets[N_T - 1, :8, :384] = masks[0][:8, :384]  # the edge tiles' colours
    return masks, targets


def _ref_engines(masks, pcf, ratio):
    saved = ref_pp._RATIO_PRED
    ref_pp._RATIO_PRED = ratio
    try:
        return [ref_pp.ActiveTilePixelEngine(image_from_array(q), 20, True,
                                             20, pcf, 2, None,
                                             interpret=True)
                for q in masks]
    finally:
        ref_pp._RATIO_PRED = saved


def _carry(ref_engine, predicate):
    t = ref_engine.tiles
    return ActiveTilePixelEngine.from_tiles(
        ActiveTiles.from_numpy(t.coords, t.n_active, t.q_tiles,
                               t.query_size, t.height, t.width, t.q_cmp,
                               t.q_f32),
        ref_engine.mirror_query, ref_engine.target_threshold,
        ref_engine.zt9, ref_engine.xy_shift, predicate)


SURV = np.ones((2, N_T), np.int32)
SURV[1, ::3] = 0


def _table(scorer, words=None):
    """scorer's launch table of SURV on the CPU (cut by the signal extents
    and live tiles of `words` when given), as NumPy arrays, its tile_list
    up to row_off[R]."""
    cut = () if words is None else (mm.signal_extents(words),
                                    mm.tile_live_dev(words))
    tab = scorer.table(SURV, "cpu", *cut)
    n = int(tab.row_off[-1])
    return SimpleNamespace(
        row_off=tab.row_off.numpy(), tile_list=tab.tile_list[:n].numpy(),
        tgt=tab.tgt.numpy(), surv=tab.surv.numpy(), eng=tab.eng.numpy())


@pytest.mark.parametrize("pcf", [1.0, 0.0], ids=["zt9_1e7", "zt9_0"])
@pytest.mark.parametrize("predicate", ["ratio", "words"])
def test_compact_lists_score_like_reference(library, predicate, pcf):
    """Plain versions over the compact lists == the JAX package's exact
    kernel in interpret mode (_multimask_call_ratio / _multimask_call)."""
    masks, targets = library
    ratio = predicate == "ratio"
    ref_engines = _ref_engines(masks, pcf, ratio)
    packed = ref_engines[0].prepare_targets(targets)
    scorer = ref_mm.MultiMaskScorer(ref_engines, interpret=True)
    assert scorer.ratio == ratio
    want = ref_pp.drain_deferred(scorer.launch_deferred(packed, SURV))
    engines = [_carry(e, predicate) for e in ref_engines]
    edge = engines[0].tiles
    assert [tuple(c) for c in edge.coords[:3]] == [(0, 0), (0, 128),
                                                   (0, 256)]
    assert list(np.diff(edge.sel_off)[:3]) == EDGE_COUNTS
    frames = tuple(torch.from_numpy(np.array(a)) for a in packed)
    if ratio:  # the ratio kernel's planes of the reference's frames
        (rf, fw), (rf_m, fw_m) = (pa.ratio_prep(f) for f in frames)
        frames = (rf, fw.to(torch.uint8), rf_m, fw_m.to(torch.uint8))
    got = engine_results(mm.MultiMaskScorer(engines), frames, SURV)
    assert any(s.any() for s, _, _ in got)
    for (gs, gr, gm), (ws, wr, wm) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("predicate", ["ratio", "words"])
def test_compact_entries(library, predicate):
    """Each entry is its pixel's constant at its place; every pixel left
    out can never match (all sentinels, or no query-side precondition)."""
    masks, _ = library
    for pcf in (1.0, 0.0):
        for m in masks:
            eng = ActiveTilePixelEngine(m, 20, True, 20, pcf, 2,
                                        predicate=predicate)
            t = eng.tiles
            k = t.n_active
            sel = pa.selected_pixels(t, predicate).reshape(k, -1)
            np.testing.assert_array_equal(np.diff(t.sel_off), sel.sum(1))
            shift = pa.POS_SHIFT[predicate]
            pos = (t.sel_q >> shift) & 1023
            tile = np.repeat(np.arange(k), np.diff(t.sel_off))
            dense = (t.q_cmp if predicate == "ratio" else t.q_words
                     ).reshape(k, -1)
            np.testing.assert_array_equal(t.sel_q & ((1 << shift) - 1),
                                          dense[tile, pos])
            assert sel[tile, pos].all()
            if predicate == "ratio":
                np.testing.assert_array_equal(
                    t.sel_f32, t.q_f32.reshape(k, 4, -1)[tile, :, pos])
                qc = dense[~sel]
                assert ((qc & 31) == 31).all() and \
                    (((qc >> 5) & 31) == 31).all() and \
                    (((qc >> 10) & 63) == 63).all()
            else:
                _, a1, s1, qsel, qcl, qcu = (f[~sel] for f in
                                             pa._unpack(dense))
                assert not ((qsel > 0) & (s1 > 0) & (
                    (a1 > 0) | (qcu > 0) | ((s1 > 1) & (qcl > 0)))).any()


def test_ratio_planes_equal_reference_prep(library):
    """pad_ratio_planes == the reference's _ratio_prep of its padded
    frames and their x-flips, bit for bit (the IEEE divide included)."""
    masks, targets = library
    ref = _ref_engines(masks[:1], 1.0, True)[0]
    frames, flipped = (np.asarray(a) for a in ref.prepare_targets(targets))
    words = ActiveTilePixelEngine(masks[0], 20, True, 20, 1.0, 2
                                  ).pack_raw_words(targets, "cpu")
    got = ActiveTilePixelEngine.pad_ratio_planes(words)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.uint8
    for (rf, fw), frame in ((got[:2], frames), (got[2:], flipped)):
        want_rf = np.empty(frame.shape, np.float32)
        want_fw = np.empty(frame.shape, np.int32)
        ref_pp._ratio_prep(jnp.asarray(frame), want_rf, want_fw)
        np.testing.assert_array_equal(rf.numpy().view(np.uint32),
                                      want_rf.view(np.uint32))
        np.testing.assert_array_equal(fw.numpy().astype(np.int32), want_fw)
        assert (want_rf == -1.0).any() and (want_rf > 0).any()


@pytest.mark.parametrize("mirror", [True, False], ids=["mirror", "direct"])
def test_launch_table_cut_is_exact(library, mirror):
    """The launch table's rows (engine order, then target order) list each
    engine's tiles with an entry, in tile order, with the directions its
    live-tile bitmaps and signal ranges leave; each (row, tile, direction)
    it leaves out counts 0 in the plain version, and it leaves some out."""
    masks, targets = library
    engines = [ActiveTilePixelEngine(m, 20, mirror, 20, 1.0, 2)
               for m in masks]
    words = engines[0].pack_raw_words(targets, "cpu")
    scorer = mm.MultiMaskScorer(engines)
    full = _table(scorer)
    cut = _table(scorer, words)
    eng, dest = np.nonzero(SURV)
    for tab in (full, cut):
        np.testing.assert_array_equal(tab.tgt, dest)
        np.testing.assert_array_equal(tab.eng, eng)
    # every (row, tile) of the full table as a one-tile row
    n_full = len(full.tile_list)
    rows = np.repeat(np.arange(len(full.tgt)), np.diff(full.row_off))
    single = mm.LaunchTable(*(torch.from_numpy(a) for a in (
        np.arange(n_full + 1, dtype=np.int32), full.tile_list,
        full.tgt[rows], np.ones(n_full, np.int32))))
    tiles = full.tile_list & mm.TILE_MASK
    assert (full.tile_list >> mm.DIR_SHIFT == (3 if mirror else 1)).all()
    listed = np.flatnonzero(scorer._n_sel)
    tile_off = np.cumsum([0] + [e.tiles.n_active for e in engines])
    for r, e in enumerate(eng):
        np.testing.assert_array_equal(
            tiles[rows == r],
            listed[(listed >= tile_off[e]) & (listed < tile_off[e + 1])])
    counts = mm.multimask_counts(
        *scorer.kernel_args(pad_for_predicate(words, "ratio"), single),
        *scorer.kernel_tail()).numpy()
    ns = counts.shape[1] // 2
    kept = dict(zip(zip(np.repeat(np.arange(len(cut.tgt)),
                                  np.diff(cut.row_off)).tolist(),
                        (cut.tile_list & mm.TILE_MASK).tolist()),
                    (cut.tile_list >> mm.DIR_SHIFT).tolist()))
    dirs = np.array([kept.get((r, t), 0)
                     for r, t in zip(rows.tolist(), tiles.tolist())])
    assert counts.any()
    assert ((dirs & 1) == 0).any() and (dirs[counts[:, :ns].any(1)] & 1).all()
    if mirror:
        assert ((dirs & 2) == 0).any()
        assert (dirs[counts[:, ns:].any(1)] & 2).all()


def test_window_bins(library):
    """The kernels' bins hold every (row, tile) member once, each in the
    bin of its target and tile position; a member of a row whose survivor
    flag is 0 keeps no direction."""
    masks, targets = library
    engines = [ActiveTilePixelEngine(m, 20, True, 20, 1.0, 2)
               for m in masks]
    words = engines[0].pack_raw_words(targets, "cpu")
    scorer = mm.MultiMaskScorer(engines)
    room = scorer.table(SURV, "cpu", mm.signal_extents(words),
                        mm.tile_live_dev(words))
    tab = _table(scorer, words)
    surv = tab.surv.copy()
    surv[::2] = 0
    coords = torch.from_numpy(scorer._q_host[-1])
    hp, wp = scorer.frame_shape
    bin_off, mem_row, mem_tile = mm.window_bins(
        room.row_off, room.tile_list, room.tgt, torch.from_numpy(surv),
        coords, (hp, wp), N_T)
    gh, gw = hp // 8 - 2, wp // 128 - 2
    assert bin_off.numel() == N_T * gh * gw + 1
    n = len(tab.tile_list)
    assert int(bin_off[-1]) == n < room.tile_list.numel()
    # the room past row_off[R] belongs to no row: it sorts past every bin
    assert (mem_row[n:] == len(tab.tgt)).all()
    mem_row, mem_tile = mem_row[:n], mem_tile[:n]
    rows = np.repeat(np.arange(len(tab.tgt)), np.diff(tab.row_off))
    entry = np.where(surv[rows] != 0, tab.tile_list,
                     tab.tile_list & mm.TILE_MASK)
    want = sorted(zip(rows.tolist(), entry.tolist()))
    assert sorted(zip(mem_row.tolist(), mem_tile.tolist())) == want
    mb = np.repeat(np.arange(bin_off.numel() - 1), np.diff(bin_off.numpy()))
    tiles = mem_tile.numpy() & mm.TILE_MASK
    c = scorer._q_host[-1][tiles]
    np.testing.assert_array_equal(
        mb, tab.tgt[mem_row.numpy()] * gh * gw + c[:, 0] // 8 * gw
        + c[:, 1] // 128)
