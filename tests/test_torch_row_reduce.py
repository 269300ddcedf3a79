"""The collect's reduction (multimask.row_reduce: its plain PyTorch
version on CPU tensors, which the card's kernel `csrc/row_reduce.cu` is
held to in tests/test_torch_cuda.py) and the sweep's collect built on it
equal the NumPy reduction that the collect ran on the host before
(`old_finalize` below: each mask's rows of the exact counts scattered
into [T, 2S], zeroed outside the survivors, then the direct and mirrored
maxima), scores and mirrored flags array for array, and the one-mask
route's (score_packed) scores, ratios and mirrored flags with them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, pad_for_predicate)
from colormipsearch_torch.cds.prescreen import PairPrescreen  # noqa: E402
from colormipsearch_torch.parallel.twophase_sweep import \
    TwoPhaseSweep  # noqa: E402
from colormipsearch_torch.utils import trace  # noqa: E402

H, W = 48, 160
CASES = ["mirror", "direct", "mixed_mirror", "ties", "empty_engine",
         "no_survivors", "one_target", "words", "two_groups"]


def old_finalize(engine, tsz, counts, rows, dest, surv):
    """The host reduction of one mask's rows of a launch's counts:
    (scores int64 [T], ratios f64 [T], mirrored bool [T])."""
    n = counts.shape[1] // 2
    out = np.zeros((tsz, 2 * n), dtype=np.int64)
    out[dest] = counts[rows]
    out = out * surv.astype(np.int64)[:, None]
    direct = out[:, :n].max(axis=1)
    if engine.mirror_query:
        mirror = out[:, n:].max(axis=1)
        best = np.maximum(direct, mirror)
        mirrored = mirror > direct
    else:
        best = direct
        mirrored = np.zeros_like(direct, dtype=bool)
    if engine.tiles.query_size == 0:
        return (np.zeros_like(best), np.zeros_like(best, dtype=np.float64),
                mirrored)
    return best, best / float(engine.tiles.query_size), mirrored


def _frame(rng, keep):
    f = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    f[rng.random((H, W)) > keep] = 0
    return f


def _inputs(case, seed=2121):
    """(engines, targets, thresholds) of a case."""
    rng = np.random.default_rng(seed)
    masks = [_frame(rng, 0.2) for _ in range(5)]
    targets = np.stack([_frame(rng, 0.5) for _ in range(11)])
    mirror, shifts = [True] * 5, [2] * 5
    if case == "direct":
        mirror = [False] * 5
    elif case == "mixed_mirror":
        mirror = [True, False, True, False, False]
    elif case == "ties":
        # x-symmetric targets: each mirrored count equals its direct one
        targets[:, :, W // 2:] = targets[:, :, :W // 2][:, :, ::-1]
    elif case == "empty_engine":
        masks[2] = np.zeros_like(masks[2])
    elif case == "one_target":
        targets = targets[:1]
    elif case == "two_groups":
        shifts = [2, 0, 2, 0, 2]
    engines = [ActiveTilePixelEngine(q, 20, m, 20, 1.0, s)
               for q, m, s in zip(masks, mirror, shifts)]
    if case == "words":
        engines = [e.with_predicate("words") for e in engines]
    thr = np.maximum(0.05 * np.array([e.tiles.query_size for e in engines]),
                     0.5)
    if case == "no_survivors":
        thr[:] = np.inf
    return engines, targets, thr


def _old_collect(sweep, targets, surv):
    """The sweep's (scores, mirrored, ratios) [B, T] by the host reduction
    of each group's counts."""
    words = sweep.engines[0].pack_raw_words(targets, "cpu")
    ranges = mm.signal_extents(words)
    live = mm.tile_live_dev(words)
    shape = (len(sweep.engines), targets.shape[0])
    scores, ratios = np.zeros(shape, np.int64), np.zeros(shape)
    mirrored = np.zeros(shape, bool)
    for idx, scorer in sweep.groups:
        tab = scorer.table(surv[idx], "cpu", ranges, live)
        packed = pad_for_predicate(words, scorer.predicate)
        counts = scorer.counts(scorer.kernel_args(packed, tab)).numpy()
        for pos, i in enumerate(idx):
            rows = np.flatnonzero(tab.eng.numpy() == pos)
            scores[i], ratios[i], mirrored[i] = old_finalize(
                sweep.engines[i], shape[1], counts, rows,
                tab.tgt.numpy()[rows], surv[i])
    return scores, mirrored, ratios


@pytest.mark.parametrize("case", CASES)
def test_collect_equals_old_finalize(case):
    engines, targets, thr = _inputs(case)
    screen = PairPrescreen(engines[0].zt9, 2, H, W)
    u = np.stack([screen.query_features(e.planes.words) for e in engines])
    sweep = TwoPhaseSweep(engines, ["cpu", "cpu"], screen, u, thr)
    words = engines[0].pack_raw_words(targets, "cpu")
    surv = (screen.bounds_from_words(u, words) > thr[:, None]).astype(
        np.int32)
    want_s, want_m, want_r = _old_collect(sweep, targets, surv)
    if case == "no_survivors":
        assert not surv.any()
    else:
        assert surv.any() and want_s.any()
    if case in ("mirror", "mixed_mirror", "words", "two_groups"):
        assert want_m.any()
    if case == "ties":  # ties of nonzero counts stay direct
        assert not want_m.any()
    # the plain reduction of each group's counts
    ranges = mm.signal_extents(words)
    live = mm.tile_live_dev(words)
    for idx, scorer in sweep.groups:
        tab = scorer.table(surv[idx], "cpu", ranges, live)
        packed = pad_for_predicate(words, scorer.predicate)
        counts = scorer.counts(scorer.kernel_args(packed, tab))
        block = mm.row_reduce(counts, tab.eng, tab.tgt,
                              *scorer._upload(scorer._f_dev, scorer._f_host,
                                              torch.device("cpu")),
                              targets.shape[0]).numpy()
        np.testing.assert_array_equal(block & 0x7FFFFFFF, want_s[idx])
        np.testing.assert_array_equal(block < 0, want_m[idx])
        # the launch's block, read back once
        s, m = scorer.launch_block(packed, surv[idx], ranges, live).result()
        assert s.dtype == np.int64 and m.dtype == bool
        np.testing.assert_array_equal(s, want_s[idx])
        np.testing.assert_array_equal(m, want_m[idx])
        # the one-mask route's triples
        for i in idx:
            s, r, m = sweep.engines[i].score_packed(packed, surv[i])
            assert s.dtype == np.int64 and m.dtype == bool
            np.testing.assert_array_equal(s, want_s[i])
            np.testing.assert_array_equal(r, want_r[i])
            np.testing.assert_array_equal(m, want_m[i])
    # the sweep's collect, over two device blocks: one launch table (and
    # one reduction) per block and group
    trace.enable()
    try:
        got_s, got_m = sweep.sweep(targets)
        spans = trace.drain()["spans"]
    finally:
        trace.disable()
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_m, want_m)
    n_blocks = len(sweep.groups) * min(2, targets.shape[0])
    assert sum(s.name == "sweep.table" for s in spans) == n_blocks
