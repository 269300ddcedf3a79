"""The port's packed-word exact path (plain version on the CPU) against the
JAX package's under CMS_RATIO_PRED=0: MultiMaskScorer (K3a,
`_multimask_call`) and the per-mask score_packed_deferred (K3b,
`_active_tile_call` and its compacted route `_compact_call`), both run
with interpret=True. The reference engines are built while
pixel_pallas._RATIO_PRED is False, so they carry the raw query tiles and
no ratio planes; their exact state is carried across with
ActiveTiles.from_numpy. Every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_tpu.cds import multimask as ref_mm  # noqa: E402
from colormipsearch_tpu.cds import pixel_pallas as ref_pp  # noqa: E402
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, ActiveTiles, drain_deferred)

N_T = 16  # targets: one 16-target block keeps the interpreted JAX runs short


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(23)
    h, w = 48, 160
    masks = []
    for _ in range(5):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.8] = 0
        masks.append(q)
    targets = rng.integers(0, 256, size=(N_T, h, w, 3)).astype(np.uint8)
    targets[rng.random((N_T, h, w)) < 0.7] = 0
    return masks, targets


def _survivors(dense=False):
    if dense:
        return np.ones((5, N_T), np.int32)
    rng = np.random.default_rng(3)
    surv = (rng.random((5, N_T)) < 0.4).astype(np.int32)
    surv[0] = 0          # a mask with zero survivors
    surv[1] = 1          # a mask with all survivors
    surv[2, :] = 0
    surv[2, N_T - 1] = 1  # a single survivor at the last target
    return surv


def _ref_engines(masks, mirror, pcf, xy_shift):
    """Reference engines on the word predicate; _RATIO_PRED is restored
    in a finally (a module-scoped fixture cannot use monkeypatch)."""
    saved = ref_pp._RATIO_PRED
    ref_pp._RATIO_PRED = False
    try:
        engines = [ref_pp.ActiveTilePixelEngine(image_from_array(q), 20,
                                                mirror, 20, pcf, xy_shift,
                                                None, interpret=True)
                   for q in masks]
    finally:
        ref_pp._RATIO_PRED = saved
    assert not engines[0].ratio and engines[0].tiles.q_cmp is None
    return engines


def _carry(ref_engine):
    """The port's word engine over the reference engine's exact state."""
    t = ref_engine.tiles
    return ActiveTilePixelEngine.from_tiles(
        ActiveTiles.from_numpy(t.coords, t.n_active, t.q_tiles,
                               t.query_size, t.height, t.width),
        ref_engine.mirror_query, ref_engine.target_threshold,
        ref_engine.zt9, ref_engine.xy_shift, predicate="words")


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gs, gr, gm), (ws, wr, wm) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gr, wr)


# (mirror, pixColorFluctuation, xyShift) of each reference run
CONFIGS = {"mirror": (True, 1.0, 2), "no_mirror": (False, 1.0, 2),
           "xy0": (True, 1.0, 0), "pcf10": (True, 10.0, 2)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def ref_run(request, library):
    """Reference word engines, frames and multi-mask scores (sparse and
    dense survivors) for one configuration."""
    masks, targets = library
    mirror, pcf, xy = CONFIGS[request.param]
    engines = _ref_engines(masks, mirror, pcf, xy)
    packed = engines[0].prepare_targets(targets)
    out = {"name": request.param, "engines": engines,
           "packed": tuple(torch.from_numpy(np.array(a)) for a in packed)}
    for dense in (False, True):
        surv = _survivors(dense)
        scorer = ref_mm.MultiMaskScorer(engines, interpret=True)
        assert not scorer.ratio
        out[dense] = (surv, ref_pp.drain_deferred(
            scorer.launch_deferred(packed, surv)))
    return out


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_words_scorer_matches_reference(ref_run, dense):
    """K3a: the port's word-mode MultiMaskScorer equals the reference's."""
    surv, want = ref_run[dense]
    engines = [_carry(e) for e in ref_run["engines"]]
    scorer = mm.MultiMaskScorer(engines)
    assert scorer.predicate == "words"
    assert len(scorer._q_for(torch.device("cpu"))) == 2  # q_words, coords
    got = drain_deferred(scorer.launch_deferred(ref_run["packed"], surv))
    _assert_same(got, want)


def test_words_live_tile_restriction_is_exact(ref_run):
    """Signal ranges and live-tile bitmaps only drop tiles that score 0."""
    surv, want = ref_run[False]
    engines = [_carry(e) for e in ref_run["engines"]]
    words = torch.from_numpy(np.array(
        ref_run["packed"][0][:, 8:-8, 128:128 + engines[0].tiles.width]))
    ranges = mm.signal_ranges_from_words(words)
    live = mm.tile_live_from_words(words)
    scorer = mm.MultiMaskScorer(engines)
    assert len(scorer.build_table(surv, ranges, live).tile_list) <= \
        len(scorer.build_table(surv).tile_list)
    got = drain_deferred(scorer.launch_deferred(
        ref_run["packed"], surv, signal_ranges=ranges, tile_live=live))
    _assert_same(got, want)


def test_words_engines_from_images(library, ref_run):
    """Port word engines built from the mask images score like the
    reference (their q_words equal the reference's q_tiles)."""
    masks, targets = library
    mirror, pcf, xy = CONFIGS[ref_run["name"]]
    surv, want = ref_run[False]
    engines = [ActiveTilePixelEngine(image_from_array(q), 20, mirror, 20,
                                     pcf, xy, None, predicate="words")
               for q in masks]
    for e, r in zip(engines, ref_run["engines"]):
        np.testing.assert_array_equal(e.tiles.q_words,
                                      r.tiles.q_tiles[:r.tiles.n_active])
    packed = engines[0].prepare_targets(targets, torch.device("cpu"))
    got = drain_deferred(mm.MultiMaskScorer(engines).launch_deferred(packed,
                                                                     surv))
    _assert_same(got, want)


@pytest.fixture(scope="module")
def per_mask_ref(library):
    """K3b: the reference's per-mask score_packed_deferred, with
    COMPACT_CHUNK = 8 so that masks with at most 4 of the 16 targets
    surviving take the compacted route (_compact_call)."""
    masks, _ = library
    engines = _ref_engines(masks, True, 1.0, 2)
    packed = engines[0].prepare_targets(library[1])
    surv = _survivors()
    surv[3] = 0
    surv[3, [1, 6, 11]] = 1          # 3 survivors: compacted
    surv[4] = 0
    surv[4, [0, 5, 9, 15]] = 1       # 4 survivors: compacted
    saved = ref_pp.ActiveTilePixelEngine.COMPACT_CHUNK
    ref_pp.ActiveTilePixelEngine.COMPACT_CHUNK = 8
    try:
        want = ref_pp.drain_deferred([
            e.score_packed_deferred(packed, survivors=surv[i])
            for i, e in enumerate(engines)])
        want_all = ref_pp.drain_deferred([
            e.score_packed_deferred(packed) for e in engines[:2]])
    finally:
        ref_pp.ActiveTilePixelEngine.COMPACT_CHUNK = saved
    return engines, packed, surv, want, want_all


def test_one_mask_launches_match_reference(per_mask_ref):
    """K3b: score_packed_deferred (a one-mask launch of the word kernel)
    equals the reference's per-mask route, compacted or not, and without
    survivors."""
    engines_ref, packed, surv, want, want_all = per_mask_ref
    assert all(1 <= surv[i].sum() <= 4 for i in (2, 3, 4))
    packed_t = tuple(torch.from_numpy(np.array(a)) for a in packed)
    engines = [_carry(e) for e in engines_ref]
    got = drain_deferred([e.score_packed_deferred(packed_t,
                                                  survivors=surv[i])
                          for i, e in enumerate(engines)])
    _assert_same(got, want)
    _assert_same([e.score_packed(packed_t) for e in engines[:2]], want_all)
