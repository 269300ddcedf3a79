"""On a CUDA card: the exact multi-mask kernels (ratio and packed-word
predicates) and the op-chain kernel equal their plain PyTorch versions,
and the two-phase sweep on the card equals the sweep on the CPU.

These tests import no JAX, so they run on a machine that has only the
port's dependencies:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Without a card they skip."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds.pixel_active import (  # noqa: E402
    ActiveTilePixelEngine, drain_deferred)
from colormipsearch_torch.cds.prescreen import PairPrescreen  # noqa: E402
from colormipsearch_torch.parallel.twophase_sweep import \
    TwoPhaseSweep  # noqa: E402
from colormipsearch_torch.scripts import op_microbench as ob  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _library(n_masks=5, n_targets=29, h=48, w=160):
    rng = np.random.default_rng(17)
    masks = []
    for _ in range(n_masks):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.8] = 0
        masks.append(q)
    targets = rng.integers(0, 256, size=(n_targets, h, w, 3)).astype(np.uint8)
    targets[rng.random((n_targets, h, w)) < 0.7] = 0
    surv = (rng.random((n_masks, n_targets)) < 0.4).astype(np.int32)
    surv[0] = 0
    surv[1] = 1
    surv[2] = 0
    surv[2, -1] = 1
    return masks, targets, surv


@pytest.mark.cuda
@pytest.mark.parametrize("xy_shift,mirror", [(2, True), (2, False),
                                             (0, True)])
@pytest.mark.parametrize("flags_off", [False, True])
def test_kernel_equals_plain(card, xy_shift, mirror, flags_off):
    masks, targets, surv = _library()
    engines = [ActiveTilePixelEngine(q, 20, mirror, 20, 1.0, xy_shift)
               for q in masks]
    words = engines[0].pack_raw_words(targets, card)
    packed = engines[0].pad_from_words(words)
    scorer = mm.MultiMaskScorer(engines)
    tab = scorer.build_table(surv, mm.signal_ranges_from_words(words),
                             mm.tile_live_from_words(words))
    if flags_off:
        tab.surv[::3] = 0  # rows the kernel must report as 0
    args = list(packed) + list(scorer._q_for(card)) + [
        torch.from_numpy(a).to(card)
        for a in (tab.row_off, tab.tile_list, tab.tgt, tab.surv)]
    before = mm.multimask_counts.launches
    got = mm.multimask_counts(*args, xy_shift, mirror)
    assert mm.multimask_counts.launches == before + 1
    want = mm.multimask_counts_plain(*args, xy_shift, mirror)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[torch.from_numpy(tab.surv).to(card) == 0].any()
    cpu = mm.multimask_counts(*[a.cpu() for a in args], xy_shift, mirror)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_sweep_on_card_equals_cpu(card):
    masks, targets, _ = _library()
    engines = [ActiveTilePixelEngine(q, 20, True, 20, 1.0, 2) for q in masks]
    screen = PairPrescreen(engines[0].zt9, 2, 48, 160)
    u = np.stack([screen.query_features(e.planes.words) for e in engines])
    thr = np.maximum(0.05 * np.array([e.tiles.query_size for e in engines]),
                     0.5)
    cpu = TwoPhaseSweep(engines, ["cpu"], screen, u, thr).sweep(targets)
    got = TwoPhaseSweep(engines, [card], screen, u, thr).sweep(targets)
    for g, c in zip(got, cpu):
        np.testing.assert_array_equal(g, c)
    # the one-mask route (no screen) launches the same kernel
    one = drain_deferred([e.score_packed_deferred(
        e.prepare_targets(targets, card)) for e in engines[:2]])
    one_cpu = drain_deferred([e.score_packed_deferred(
        e.prepare_targets(targets, "cpu")) for e in engines[:2]])
    for (gs, _, gm), (cs, _, cm) in zip(one, one_cpu):
        np.testing.assert_array_equal(gs, cs)
        np.testing.assert_array_equal(gm, cm)


@pytest.mark.cuda
@pytest.mark.parametrize("pcf,xy_shift,mirror", [
    (1.0, 2, True), (1.0, 2, False), (1.0, 0, True), (10.0, 2, True)])
@pytest.mark.parametrize("flags_off", [False, True])
def test_words_kernel_equals_plain(card, pcf, xy_shift, mirror, flags_off):
    masks, targets, surv = _library()
    engines = [ActiveTilePixelEngine(q, 20, mirror, 20, pcf, xy_shift,
                                     predicate="words") for q in masks]
    words = engines[0].pack_raw_words(targets, card)
    packed = engines[0].pad_from_words(words)
    scorer = mm.MultiMaskScorer(engines)
    tab = scorer.build_table(surv, mm.signal_ranges_from_words(words),
                             mm.tile_live_from_words(words))
    if flags_off:
        tab.surv[::3] = 0  # rows the kernel must report as 0
    args = list(packed) + list(scorer._q_for(card)) + [
        torch.from_numpy(a).to(card)
        for a in (tab.row_off, tab.tile_list, tab.tgt, tab.surv)]
    before = mm.multimask_words_counts.launches
    got = mm.multimask_words_counts(*args, xy_shift, mirror, scorer.triples)
    assert mm.multimask_words_counts.launches == before + 1
    want = mm.multimask_words_counts_plain(*args, xy_shift, mirror,
                                           scorer.triples)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.any()
    # the ratio kernel gives the same counts
    ratio = mm.MultiMaskScorer([e.with_predicate("ratio") for e in engines])
    rargs = list(packed) + list(ratio._q_for(card)) + args[4:]
    assert torch.equal(mm.multimask_counts(*rargs, xy_shift, mirror), got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ob.CASE_NAMES)
def test_op_chain_equals_plain(card, name):
    x, y = ob.case_inputs(name, (256, 1024), device=card)
    before = ob.op_chain.launches
    got = ob.op_chain(name, x, y)
    assert ob.op_chain.launches == before + 1
    want = ob.op_chain_plain(name, x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ob.op_chain(name, x, y, 0), x)
    # 100 steps: one main-loop iteration and a remainder of single steps
    assert torch.equal(ob.op_chain(name, x, y, 100),
                       ob.op_chain_plain(name, x, y, 100))


@pytest.mark.cuda
def test_op_chain_sass_main_loop(card):
    """Every case's main loop is found in the built kernel's SASS, with at
    least one instruction per two steps (no fold beyond ptxas's
    three-input merges)."""
    loops = ob.instructions_per_step()
    assert set(loops) == set(ob.CASE_NAMES)
    for name, (per_step, mnemonics) in loops.items():
        assert 0.5 <= per_step <= 4, (name, per_step, mnemonics)
        assert mnemonics["BRA"] == 1, (name, mnemonics)
