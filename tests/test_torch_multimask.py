"""The port's exact multi-mask scorer (colormipsearch_torch.cds.multimask,
plain version on the CPU) must score exactly like the JAX package's
MultiMaskScorer(interpret=True) and its per-mask score_packed_deferred,
over the cases of test_multimask.py. The JAX engines' exact state (query
tiles and packed frames) is carried across with ActiveTiles.from_numpy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cds import multimask as ref_mm  # noqa: E402
from colormipsearch_tpu.cds import pixel_pallas as ref_pp  # noqa: E402
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, ActiveTiles, pad_for_predicate, ratio_prep)
from torch_launch import engine_results  # noqa: E402

N_T = 16  # targets: one 16-target block keeps the interpreted JAX runs short


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(17)
    h, w = 48, 160
    masks = []
    for _ in range(5):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.8] = 0
        masks.append(q)
    targets = rng.integers(0, 256, size=(29, h, w, 3)).astype(np.uint8)
    targets[rng.random((29, h, w)) < 0.7] = 0
    return masks, targets[:N_T]


def _survivors(b, t, dense=False):
    if dense:
        return np.ones((b, t), np.int32)
    rng = np.random.default_rng(3)
    surv = (rng.random((b, t)) < 0.4).astype(np.int32)
    surv[0] = 0          # a mask with zero survivors
    surv[1] = 1          # a mask with all survivors
    surv[2, :] = 0
    surv[2, t - 1] = 1   # a single survivor at the last target
    return surv


def _carry(ref_engine, tiles=None):
    """The port's engine over the reference engine's exact query state."""
    t = tiles or ref_engine.tiles
    return ActiveTilePixelEngine.from_tiles(
        ActiveTiles.from_numpy(t.coords, t.n_active, t.q_tiles,
                               t.query_size, t.height, t.width, t.q_cmp,
                               t.q_f32),
        ref_engine.mirror_query, ref_engine.target_threshold,
        ref_engine.zt9, ref_engine.xy_shift)


def _ratio_planes(packed):
    """The ratio kernel's planes (rf, fw, rf_m, fw_m) of the reference's
    padded word frames, as pad_ratio_planes builds them."""
    (rf, fw), (rf_m, fw_m) = (ratio_prep(f) for f in packed)
    return rf, fw.to(torch.uint8), rf_m, fw_m.to(torch.uint8)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gs, gr, gm), (ws, wr, wm) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gr, wr)


@pytest.fixture(scope="module", params=[True, False], ids=["mirror",
                                                            "no_mirror"])
def ref_run(request, library):
    """Reference engines, frames and scores (multi-mask and per-mask,
    sparse and dense survivors) for one mirror setting."""
    masks, targets = library
    mirror = request.param
    engines = [ref_pp.ActiveTilePixelEngine(image_from_array(q), 20, mirror,
                                            20, 1.0, 2, None, interpret=True)
               for q in masks]
    packed = engines[0].prepare_targets(targets)
    out = {"engines": engines, "mirror": mirror,
           "packed": tuple(torch.from_numpy(np.array(a)) for a in packed)}
    out["planes"] = _ratio_planes(out["packed"])
    for dense in (False, True):
        surv = _survivors(len(engines), N_T, dense)
        scorer = ref_mm.MultiMaskScorer(engines, interpret=True)
        out[dense] = (surv,
                      ref_pp.drain_deferred(scorer.launch_deferred(packed,
                                                                   surv)),
                      ref_pp.drain_deferred([
                          e.score_packed_deferred(
                              packed, survivors=None if dense else surv[i])
                          for i, e in enumerate(engines)]))
    return out


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("order", ["given", "reversed"])
def test_scorer_matches_reference(ref_run, dense, order):
    """Each engine's rows come back to it, whatever its place among the
    stacked query tables."""
    surv, want_mm, want_pm = ref_run[dense]
    perm = np.arange(len(ref_run["engines"]))
    if order == "reversed":
        perm = perm[::-1]
    engines = [_carry(ref_run["engines"][i]) for i in perm]
    scorer = mm.MultiMaskScorer(engines)
    got = engine_results(scorer, ref_run["planes"], surv[perm])
    _assert_same(got, [want_mm[i] for i in perm])
    _assert_same(got, [want_pm[i] for i in perm])


def test_one_mask_launches_match_reference(ref_run):
    """score_packed (the per-mask route, a one-mask launch)."""
    surv, _, want_pm = ref_run[False]
    engines = [_carry(e) for e in ref_run["engines"]]
    got = [e.score_packed(ref_run["planes"], survivors=surv[i])
           for i, e in enumerate(engines)]
    _assert_same(got, want_pm)
    if ref_run["mirror"]:
        _, _, want_dense = ref_run[True]
        _assert_same([e.score_packed(ref_run["planes"]) for e in engines],
                     want_dense)


def test_engines_built_from_images(library, ref_run):
    """Port engines built from the mask images score like the reference
    (their tables equal the reference's, test_torch_host_copies)."""
    masks, targets = library
    surv, want_mm, _ = ref_run[False]
    engines = [ActiveTilePixelEngine(image_from_array(q), 20,
                                     ref_run["mirror"], 20, 1.0, 2, None)
               for q in masks]
    packed = engines[0].prepare_targets(targets, torch.device("cpu"))
    got = engine_results(mm.MultiMaskScorer(engines), packed, surv)
    _assert_same(got, want_mm)


def test_small_rows(library, ref_run):
    """A handful of survivors over two masks."""
    engines_ref = ref_run["engines"][:2]
    surv = np.zeros((2, N_T), np.int32)
    surv[0, 5] = 1
    surv[1, 0] = 1
    surv[1, N_T - 1] = 1
    packed_ref = tuple(a.numpy() for a in ref_run["packed"])
    want = ref_pp.drain_deferred([
        e.score_packed_deferred(packed_ref, survivors=surv[i])
        for i, e in enumerate(engines_ref)])
    scorer = mm.MultiMaskScorer([_carry(e) for e in engines_ref])
    tab = scorer.table(surv, "cpu")
    np.testing.assert_array_equal(tab.tgt.numpy(), [5, 0, N_T - 1])
    got = engine_results(scorer, ref_run["planes"], surv)
    _assert_same(got, want)


def test_k768_bucket_state(ref_run):
    """A reference engine whose tables sit in the K=768 bucket (re-padded
    as in test_multimask.py): from_numpy drops the padding and the scores
    are unchanged."""
    surv, want_mm, _ = ref_run[False]
    e = ref_run["engines"][1]
    t = e.tiles
    k0 = t.q_cmp.shape[0]
    pad = lambda a: np.concatenate(
        [a, np.zeros((768 - k0,) + a.shape[1:], a.dtype)])
    coords = pad(t.coords)
    coords[:, 2] = max(t.n_active, 1)
    padded = ref_pp.ActiveTiles(q_tiles=pad(t.q_tiles), coords=coords,
                                n_active=t.n_active, query_size=t.query_size,
                                height=t.height, width=t.width,
                                q_cmp=pad(t.q_cmp), q_f32=pad(t.q_f32))
    engines = [_carry(x) for x in ref_run["engines"]]
    engines[1] = _carry(e, padded)
    assert engines[1].tiles.q_cmp.shape[0] == t.n_active
    got = engine_results(mm.MultiMaskScorer(engines), ref_run["planes"],
                         surv)
    _assert_same(got, want_mm)


def test_live_tile_restriction_is_exact(library, ref_run):
    """Signal ranges and live-tile bitmaps only drop tiles that score 0:
    on a banded library the restricted launch equals the reference."""
    masks, targets = library
    h, w = targets.shape[1:3]
    banded = np.zeros_like(targets)
    for i in range(N_T):
        b0 = (13 * i) % (h - 10)
        c0 = (41 * i) % (w - 24) if i % 4 else (0 if i % 8 else w - 24)
        banded[i, b0:b0 + 10, c0:c0 + 24] = targets[i, b0:b0 + 10,
                                                    c0:c0 + 24]
    engines_ref = ref_run["engines"]
    packed_ref = engines_ref[0].prepare_targets(banded)
    surv, _, _ = ref_run[False]
    want = ref_pp.drain_deferred([
        e.score_packed_deferred(packed_ref, survivors=surv[i])
        for i, e in enumerate(engines_ref)])
    engines = [_carry(e) for e in engines_ref]
    words = engines[0].pack_raw_words(banded, torch.device("cpu"))
    packed = pad_for_predicate(words, "ratio")
    ranges = mm.signal_extents(words)
    live = mm.tile_live_dev(words)
    scorer = mm.MultiMaskScorer(engines)
    full = scorer.table(surv, "cpu")
    cut = scorer.table(surv, "cpu", ranges, live)
    assert int(cut.row_off[-1]) < int(full.row_off[-1])
    got = engine_results(scorer, packed, surv, signal_ranges=ranges,
                         tile_live=live)
    _assert_same(got, want)


def test_survivor_flag_zero_rows(ref_run):
    """Launch rows whose survivor flag is 0 report 0 and leave the other
    rows' counts unchanged."""
    surv, _, _ = ref_run[True]
    engines = [_carry(e) for e in ref_run["engines"]]
    scorer = mm.MultiMaskScorer(engines)
    tab = scorer.table(surv, "cpu")
    args = scorer.kernel_args(ref_run["planes"], tab)
    full = mm.multimask_counts(*args, 2, ref_run["mirror"])
    off = tab.surv.clone()
    off[::3] = 0
    args[-1] = off
    part = mm.multimask_counts(*args, 2, ref_run["mirror"])
    keep = off != 0
    assert torch.equal(part[keep], full[keep])
    assert not part[~keep].any()
    assert full[~keep].any()
