"""On a CUDA card: the target pack kernel (with its pinned staging), the
exact multi-mask kernels (ratio and packed-word predicates), their
launch table and their collect's reduction, the two prescreen-bound
kernels, the op-chain kernel and
gradientScores' four kernels (the shape scorer, the dilation, the query
and the target planes) equal their plain PyTorch versions, and the
two-phase sweep and gradientScores' batches (over two device slots, and
on the ROI-mask path) on the card equal their runs on the CPU.

These tests import no JAX, so they run on a machine that has only the
port's dependencies:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Without a card they skip."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from colormipsearch_torch.cds import kernels  # noqa: E402
from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds import pixel_active as pa  # noqa: E402
from colormipsearch_torch.cds import prescreen as ps  # noqa: E402
from colormipsearch_torch.cds import shape_device as sd  # noqa: E402
from colormipsearch_torch.cds import shape_kernel as sk  # noqa: E402
from colormipsearch_torch.cds.oracle import shift_ring_offsets  # noqa: E402
from colormipsearch_torch.cds.pixel_active import \
    ActiveTilePixelEngine  # noqa: E402
from colormipsearch_torch.cds.prescreen import PairPrescreen  # noqa: E402
from colormipsearch_torch.parallel.twophase_sweep import \
    TwoPhaseSweep  # noqa: E402
from colormipsearch_torch.scripts import op_microbench as ob  # noqa: E402
from colormipsearch_torch.utils import trace  # noqa: E402
from test_torch_launch_table import build_table  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "cdsearch"


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


def pack_frames(n, feed, h=23, w=41, seed=5):
    """u8 [n, h, w, 3] frames for the target pack at threshold 20: every
    channel of a sub-threshold pixel is at most 20 (many exactly 20), and
    a selected pixel has a channel at 21 or above (many exactly 21), some
    grey (three equal channels). The selected pixels: "sparse" a tenth,
    "dense" three fifths, "quarter" exactly (n*h*w)//4 (the occupancy
    rule's sparse side) and "quarter+1" one more (its dense side). h * w * 3 is
    odd, so a slice from the second frame on is not 4-byte aligned."""
    rng = np.random.default_rng(seed)
    px = n * h * w
    f = rng.integers(0, 21, size=(px, 3))
    f[rng.random((px, 3)) < 0.3] = 20
    k = {"sparse": px // 10, "dense": px * 3 // 5, "quarter": px // 4,
         "quarter+1": px // 4 + 1}[feed]
    sel = rng.choice(px, size=k, replace=False)
    f[sel] = rng.integers(0, 256, size=(k, 3))
    f[sel, rng.integers(0, 3, size=k)] = np.where(
        rng.random(k) < 0.3, 21, rng.integers(21, 256, size=k))
    grey = sel[::7]
    f[grey] = rng.integers(21, 256, size=(len(grey), 1))
    return f.reshape(n, h, w, 3).astype(np.uint8)


def _host_words(frames):
    """The CPU's words: pack_raw_words on the CPU (the staged frames and
    the plain pack)."""
    eng = ActiveTilePixelEngine(frames[0], 20, True, 20, 1.0, 2)
    return eng.pack_raw_words(frames, "cpu")


PACK_FEEDS = ["sparse", "dense", "quarter", "quarter+1"]


@pytest.mark.cuda
@pytest.mark.parametrize("feed", PACK_FEEDS)
def test_pack_kernel_equals_plain(card, feed):
    """The pack kernel's words equal its plain version's and the CPU's on
    both feeds and at the occupancy rule's edge, through the aligned and
    the unaligned (byte-load) loops, and through the staged path (more
    targets than a staging chunk)."""
    frames = pack_frames(pa.STAGE_TARGETS + 1, feed)
    t = torch.from_numpy(frames).to(card)
    host = _host_words(frames)
    before = pa.pack_words.launches
    got = pa.pack_words(t, 20)
    assert pa.pack_words.launches == before + 1
    want = pa.pack_words_plain(t, 20)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), host)
    assert t[1:].data_ptr() % 4 != 0
    assert torch.equal(pa.pack_words(t[1:], 20),
                       pa.pack_words_plain(t[1:], 20))
    eng = ActiveTilePixelEngine(frames[0], 20, True, 20, 1.0, 2)
    assert torch.equal(eng.pack_raw_words(frames, card).cpu(), host)


@pytest.mark.cuda
def test_pack_kernel_fixture_frames(card):
    """The pack kernel on the LM fixtures at 566 x 1210 (all four frames:
    the sparse feed; one frame with its background lifted to 25: the
    dense feed) equals the CPU's pack."""
    from colormipsearch_torch.imageproc.io import load_image
    frames = np.stack([load_image(str(p)).pixels
                       for p in sorted((FIXTURES / "lms").glob("*.tif"))])
    lifted = frames[:1].copy()
    lifted[lifted < 25] = 25
    for block in (frames, lifted):
        eng = ActiveTilePixelEngine(block[0], 20, True, 20, 1.0, 2)
        got = eng.pack_raw_words(block, card)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), eng.pack_raw_words(block, "cpu"))


@pytest.mark.cuda
def test_pack_back_to_back_keeps_words(card):
    """Two blocks staged and packed back to back behind a busy stream,
    with no synchronize between: the host runs ahead of the copies, so a
    staging buffer is reused only after its copy; each block keeps its
    own words."""
    a = pack_frames(2 * pa.STAGE_TARGETS + 3, "sparse", seed=1)
    b = pack_frames(2 * pa.STAGE_TARGETS + 3, "dense", seed=2)
    eng = ActiveTilePixelEngine(a[0], 20, True, 20, 1.0, 2)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time ahead
    wa = eng.pack_raw_words(a, card)
    wb = eng.pack_raw_words(b, card)
    torch.cuda.synchronize()
    assert torch.equal(wa.cpu(), _host_words(a))
    assert torch.equal(wb.cpu(), _host_words(b))


@pytest.mark.cuda
@pytest.mark.parametrize("xy_shift,mirror", [(2, True), (2, False),
                                             (0, True)])
@pytest.mark.parametrize("flags_off", [False, True])
def test_kernel_equals_plain(card, xy_shift, mirror, flags_off):
    masks, targets, surv = _library()
    engines = [ActiveTilePixelEngine(q, 20, mirror, 20, 1.0, xy_shift)
               for q in masks]
    words = engines[0].pack_raw_words(targets, card)
    packed = engines[0].pad_ratio_planes(words)
    scorer = mm.MultiMaskScorer(engines)
    tab = scorer.table(surv, card, mm.signal_extents(words),
                       mm.tile_live_dev(words))
    if flags_off:
        tab.surv[::3] = 0  # rows the kernel must report as 0
    args = scorer.kernel_args(packed, tab)
    before = mm.multimask_counts.launches
    got = mm.multimask_counts(*args, xy_shift, mirror)
    assert mm.multimask_counts.launches == before + 1
    want = mm.multimask_counts_plain(*args, xy_shift, mirror)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[tab.surv == 0].any()
    cpu = mm.multimask_counts(*[a.cpu() for a in args], xy_shift, mirror)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("xy_shift,mirror", [(2, True), (2, False),
                                             (0, True)])
def test_launch_table_kernel_equals_build_table(card, xy_shift, mirror):
    """The card's launch table (`csrc/launch_table.cu`, from the signal
    extents and live-tile bitmaps where they lie on the card) equals the
    NumPy oracle's (tests/test_torch_launch_table.py:build_table) and the
    CPU's from their host copies bit for bit, its room past row_off[R]
    left 0; the kernel equals its plain version on the same tensors with
    and without each input; K1's counts from both tables are equal."""
    masks, targets, surv = _library()
    engines = [ActiveTilePixelEngine(q, 20, mirror, 20, 1.0, xy_shift)
               for q in masks]
    words = engines[0].pack_raw_words(targets, card)
    scorer = mm.MultiMaskScorer(engines)
    ext, live = mm.signal_extents(words), mm.tile_live_dev(words)
    ext_cpu, live_cpu = ext.cpu(), tuple(t.cpu() for t in live)
    want = build_table(scorer, surv, ext_cpu.numpy(),
                       tuple(t.numpy() for t in live_cpu))
    cpu = scorer.table(surv, "cpu", ext_cpu, live_cpu)
    before = mm.launch_table.launches
    got = scorer.table(surv, card, ext, live)
    assert mm.launch_table.launches == before + 1
    n = int(got.row_off[-1])
    for name in ("row_off", "tile_list", "tgt", "surv", "eng"):
        assert torch.equal(getattr(got, name).cpu(), getattr(cpu, name))
    assert torch.equal(got.tile_list[:n].cpu(), want.tile_list)
    assert not got.tile_list[n:].any()
    for name in ("row_off", "tgt", "surv", "eng"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    eng, dest = np.nonzero(surv)
    rows = torch.from_numpy(np.stack([eng, dest]).astype(np.int32)).to(card)
    common = (rows, *scorer._upload(scorer._l_dev, scorer._l_host, card),
              got.tile_list.numel(), surv.shape[1], scorer._grid,
              scorer._width, scorer._reach, scorer.mirror)
    for e, lv in ((ext, live), (ext[:, :2].contiguous(), live),
                  (ext, None), (None, live), (None, None)):
        k = mm.launch_table(*common, e, lv)
        p = mm.launch_table_plain(*common, e, lv)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    packed = engines[0].pad_ratio_planes(words)
    want = mm.LaunchTable(*(t.to(card) for t in (
        want.row_off, want.tile_list, want.tgt, want.surv)))
    counts = [scorer.counts(scorer.kernel_args(packed, t))
              for t in (got, want)]
    assert torch.equal(counts[0], counts[1])
    assert counts[0].any()


def _banded(targets):
    """A copy of the targets with a 10 x 24 band of each kept (the rest 0):
    below a quarter occupancy, so the pack takes the sparse side of its
    occupancy rule."""
    h, w = targets.shape[1:3]
    banded = np.zeros_like(targets)
    for i in range(targets.shape[0]):
        b0, c0 = (13 * i) % (h - 10), (41 * i) % (w - 24)
        banded[i, b0:b0 + 10, c0:c0 + 24] = targets[i, b0:b0 + 10,
                                                    c0:c0 + 24]
    return banded


@pytest.mark.cuda
@pytest.mark.parametrize("feed", ["dense", "banded"])
def test_sweep_on_card_equals_cpu(card, feed):
    """TwoPhaseSweep's scores and mirrored flags on the card equal the
    CPU's; each launched partition is packed by the card's kernel, gets
    its launch table from the card's and is reduced by the card's (one
    launch each of target_pack, launch_table and row_reduce)."""
    masks, targets, _ = _library()
    if feed == "banded":
        targets = _banded(targets)
    engines = [ActiveTilePixelEngine(q, 20, True, 20, 1.0, 2) for q in masks]
    screen = PairPrescreen(engines[0].zt9, 2, 48, 160)
    u = np.stack([screen.query_features(e.planes.words) for e in engines])
    thr = np.maximum(0.05 * np.array([e.tiles.query_size for e in engines]),
                     0.5)
    cpu = TwoPhaseSweep(engines, ["cpu"], screen, u, thr).sweep(targets)
    sweep = TwoPhaseSweep(engines, [card], screen, u, thr)
    before = kernels.launch_counts()
    got = sweep.sweep(targets)
    for g, c in zip(got, cpu):
        np.testing.assert_array_equal(g, c)
    parts = [(0, targets[:10]), (1, targets[10:20]), (2, targets[20:])]
    for key, s, m in sweep.sweep_parts(parts):
        np.testing.assert_array_equal(s, cpu[0][:, 10 * key:10 * key + 10])
        np.testing.assert_array_equal(m, cpu[1][:, 10 * key:10 * key + 10])
    after = kernels.launch_counts()
    for name in ("target_pack", "launch_table", "row_reduce"):
        assert after[name] - before[name] == 4, name
    # the one-mask route (no screen) launches the same kernel
    one = [e.score_packed(e.prepare_targets(targets, card))
           for e in engines[:2]]
    one_cpu = [e.score_packed(e.prepare_targets(targets, "cpu"))
               for e in engines[:2]]
    for (gs, _, gm), (cs, _, cm) in zip(one, one_cpu):
        np.testing.assert_array_equal(gs, cs)
        np.testing.assert_array_equal(gm, cm)


@pytest.mark.cuda
@pytest.mark.parametrize("predicate", ["ratio", "words"])
def test_row_reduce_kernel_equals_plain(card, predicate):
    """The collect's reduction (`csrc/row_reduce.cu`) equals its plain
    version on partition 0's exact counts of either predicate, with an
    engine that does not mirror inside a mirrored launch and one without a
    query pixel; launch_block's block, copied to pinned memory, equals
    both."""
    masks, targets, surv = _library()
    masks[3] = np.zeros_like(masks[3])
    engines = [ActiveTilePixelEngine(q, 20, i != 1, 20, 1.0, 2)
               for i, q in enumerate(masks)]
    if predicate == "words":
        engines = [e.with_predicate("words") for e in engines]
    words = engines[0].pack_raw_words(targets, card)
    packed = pa.pad_for_predicate(words, predicate)
    scorer = mm.MultiMaskScorer(engines)
    ext, live = mm.signal_extents(words), mm.tile_live_dev(words)
    tab = scorer.table(surv, card, ext, live)
    counts = scorer.counts(scorer.kernel_args(packed, tab))
    args = (counts, tab.eng, tab.tgt,
            *scorer._upload(scorer._f_dev, scorer._f_host, card))
    before = mm.row_reduce.launches
    got = mm.row_reduce(*args, targets.shape[0])
    assert mm.row_reduce.launches == before + 1
    want = mm.row_reduce_plain(*args, targets.shape[0])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    cpu = mm.row_reduce(*[a.cpu() for a in args], targets.shape[0])
    assert torch.equal(got.cpu(), cpu)
    assert (cpu < 0).any() and not (cpu[1] < 0).any() and not cpu[3].any()
    s, m = scorer.launch_block(packed, surv, ext, live).result()
    np.testing.assert_array_equal(s, (cpu & 0x7FFFFFFF).numpy())
    np.testing.assert_array_equal(m, (cpu < 0).numpy())


@pytest.mark.cuda
def test_collect_back_to_back_keeps_blocks(card):
    """Two partitions launched back to back behind a busy stream, with no
    synchronize between: each keeps its own pinned block, so partition
    p's answers are unchanged once p+1 is launched and collected first."""
    masks, targets, _ = _library()
    engines = [ActiveTilePixelEngine(q, 20, True, 20, 1.0, 2) for q in masks]
    sweep = TwoPhaseSweep(engines, [card])
    want = TwoPhaseSweep(engines, ["cpu"]).sweep(targets)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time ahead
    first = sweep.launch(targets[:15])
    second = sweep.launch(targets[15:])
    got2 = sweep.collect(second)
    got1 = sweep.collect(first)
    for g1, g2, w in zip(got1, got2, want):
        np.testing.assert_array_equal(g1, w[:, :15])
        np.testing.assert_array_equal(g2, w[:, 15:])


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
    ext, live = mm.signal_extents(words), mm.tile_live_dev(words)
    tab = scorer.table(surv, card, ext, live)
    if flags_off:
        tab.surv[::3] = 0  # rows the kernel must report as 0
    args = scorer.kernel_args(packed, tab)
    before = mm.multimask_words_counts.launches
    got = mm.multimask_words_counts(*args, xy_shift, mirror, scorer.triples)
    assert mm.multimask_words_counts.launches == before + 1
    want = mm.multimask_words_counts_plain(*args, xy_shift, mirror,
                                           scorer.triples)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.any()
    # the ratio kernel gives the same counts (same rows; its tile lists
    # hold the tiles with a selected pixel under its own predicate)
    ratio = mm.MultiMaskScorer([e.with_predicate("ratio") for e in engines])
    rtab = ratio.table(surv, card, ext, live)
    assert torch.equal(rtab.tgt, tab.tgt)
    rtab.surv = tab.surv
    rargs = ratio.kernel_args(engines[0].pad_ratio_planes(words), rtab)
    rgot = mm.multimask_counts(*rargs, xy_shift, mirror)
    assert torch.equal(rgot, got)


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


def _bound_inputs(card, xy_shift, n_masks, n_targets, h, w, dense_masks):
    """Random masks (every third one empty; dense ones fill most cells
    with many bins, and mask 1 is one colour, one bin in every cell, so
    the capped kernel stages them in chunks) and targets: (screen, query
    CSR, packed target words on the card)."""
    rng = np.random.default_rng(31 + xy_shift)
    engine = ActiveTilePixelEngine(np.zeros((h, w, 3), np.uint8), 20, True,
                                   20, 2.0, 2)
    screen = PairPrescreen(engine.zt9, xy_shift, h, w)
    frames = rng.integers(0, 256, size=(n_masks, h, w, 3)).astype(np.uint8)
    frames[rng.random((n_masks, h, w)) < (0.2 if dense_masks else 0.9)] = 0
    frames[::3] = 0
    if dense_masks:
        frames[1] = (200, 40, 90)
    u = np.stack([screen.query_features(ActiveTilePixelEngine(
        f, 20, True, 20, 2.0, 2).planes.words) for f in frames])
    targets = rng.integers(0, 256, size=(n_targets, h, w, 3)).astype(np.uint8)
    targets[rng.random((n_targets, h, w)) < 0.5] = 0
    words = engine.pack_raw_words(targets, card)
    return screen, ps.sparse_query_rows(u), words


# entries that the capped kernel's warps stage at once for one (mask
# group, band): 16 warps x 64 (csrc/prescreen_bound.cu)
BATCH_ENTS = 16 * 64


@pytest.mark.cuda
@pytest.mark.parametrize("xy_shift,n_masks,n_targets,h,w,dense_masks", [
    (2, 13, 131, 37, 299, False), (2, 9, 5, 64, 1210, True),
    (0, 8, 1, 16, 128, False), (4, 11, 65, 41, 150, True),
    (6, 7, 45, 40, 1210, False), (2, 300, 33, 24, 300, False),
    (6, 5, 70, 33, 1210, True)])
def test_prescreen_kernels_equal_plain(card, xy_shift, n_masks, n_targets,
                                       h, w, dense_masks):
    """Each prescreen kernel equals its plain version: the cell bits and
    counts of every variant (frames of odd size and of the full 1210
    width, xyShift up to 6, T not a multiple of the kernels' target tiles,
    cells not a multiple of the capped kernel's band), then the bounds
    (empty masks, more masks than one mask group, a band's cells staged in
    several chunks), and the composed bound equals the CPU's."""
    screen, rows_cpu, words = _bound_inputs(card, xy_shift, n_masks,
                                            n_targets, h, w, dense_masks)
    offsets = tuple(shift_ring_offsets(xy_shift))
    before = (ps.prescreen_cells.launches, ps.prescreen_capped.launches)
    bits, cnt = ps.prescreen_cells(words, screen.zt9, offsets,
                                   screen.grid_hw)
    want_bits, want_cnt = ps.cell_masks_plain(words, screen.zt9, offsets,
                                              screen.grid_hw)
    torch.cuda.synchronize()
    assert torch.equal(bits, want_bits) and torch.equal(cnt, want_cnt)
    rows = rows_cpu.to(card)
    got = ps.prescreen_capped(rows, bits, cnt)
    want = ps.capped_bounds_plain(rows, bits, cnt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (ps.prescreen_cells.launches,
            ps.prescreen_capped.launches) == (before[0] + 1, before[1] + 1)
    assert (got[::3] == 0).all() and got.max() > 0
    if dense_masks:  # a (mask group, band) over one staged chunk
        bands = rows_cpu.bands
        per_seg = bands.rec_off[bands.seg_off.long()].diff()
        assert int(per_seg.max()) > BATCH_ENTS
    cpu = screen.bounds_from_words(rows_cpu, words.cpu())
    np.testing.assert_array_equal(screen.bounds_from_words(rows, words), cpu)


@pytest.mark.cuda
def test_prescreen_capped_without_survivors(card):
    """A partition whose masks are all empty: each kernel launches once
    and every bound is 0, so no pair survives."""
    screen, rows_cpu, words = _bound_inputs(card, 2, 6, 40, 16, 256, False)
    rows = ps.sparse_query_rows(torch.zeros(
        (6, rows_cpu.npos * ps.N_BINS), dtype=torch.uint8)).to(card)
    before = (ps.prescreen_cells.launches, ps.prescreen_capped.launches)
    bits, cnt = ps.prescreen_cells(words, screen.zt9, screen.offsets,
                                   screen.grid_hw)
    got = ps.prescreen_capped(rows, bits, cnt)
    torch.cuda.synchronize()
    assert (ps.prescreen_cells.launches,
            ps.prescreen_capped.launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (6, 40) and not got.any()
    assert torch.equal(got, ps.capped_bounds_plain(rows, bits, cnt))


def _launched(fn, call):
    """call()'s result, checking it launched fn's kernel once."""
    before = fn.launches
    out = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _shape_planes(rng, t, h, w, dev):
    """Query and target planes in the kernels' dtypes, with slice gaps
    around 80, gaps of 3 and 4 and gradients past 32767."""
    q_nonzero = rng.random((h, w)) < 0.6
    q_slice = np.where(q_nonzero, rng.integers(0, 257, (h, w)), 0)
    q_mask = q_nonzero & (rng.random((h, w)) < 0.7)
    high = rng.random((h, w)) < 0.3
    grad = rng.integers(0, 65536, (t, h, w)).astype(np.uint16)
    grad[rng.random((t, h, w)) < 0.3] = rng.integers(2, 6)
    z_nonzero = rng.random((t, h, w)) < 0.6
    z_slice = np.where(z_nonzero, np.clip(
        q_slice[None] + rng.choice([-81, -80, -79, 0, 79, 80, 81],
                                   (t, h, w)), 0, 256), 0)
    t_above = rng.random((t, h, w)) < 0.4

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    query = [up(q_nonzero, bool), up(q_slice, np.int16), up(q_mask, bool),
             up(high, bool)]
    planes = [up(t_above, bool), up(grad.view(np.int16), np.int16),
              up(z_nonzero, bool), up(z_slice, np.int16)]
    return query, [list(p.unbind(0)) for p in planes]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [45, 1210])
@pytest.mark.parametrize("mirror,flip_z", [(True, False), (False, False),
                                           (False, True)])
def test_shape_rows_equals_plain(card, w, mirror, flip_z):
    """G1 over per-target planes (views of one stack, and tensors of
    their own) in a band with r0 > 0 == its plain version."""
    rng = np.random.default_rng(w + 2 * mirror + flip_z)
    query, lists = _shape_planes(rng, 5, 40, w, card)
    lists = [[p.clone() if i % 2 else p for i, p in enumerate(x)]
             for x in lists]
    got = _launched(sk.shape_rows, lambda: sk.shape_rows(
        *query, *lists, r0=3, r1=37, mirror=mirror, flip_z=flip_z))
    want = sk.shape_rows_plain(*query, *lists, r0=3, r1=37, mirror=mirror,
                               flip_z=flip_z)
    _same(got, want)
    cpu = sk.shape_rows(*[q.cpu() for q in query],
                        *[[p.cpu() for p in x] for x in lists], r0=3,
                        r1=37, mirror=mirror, flip_z=flip_z)
    _same([g.cpu() for g in got], cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,h,w", [(10.0, 40, 150), (20.0, 7, 131),
                                        (60.0, 70, 1210)])
@pytest.mark.parametrize("prologue", ["none", "excluded", "excluded+thr"])
def test_dilate_rgb_equals_plain(card, radius, h, w, prologue):
    """G2 == its plain version, on frames shorter than the radius too,
    clearing and masking its input on the fly."""
    rng = np.random.default_rng(int(radius) + h)
    x = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    x[rng.random((3, h, w)) < 0.97] = 0
    x = torch.from_numpy(x).to(card)
    excluded = (torch.from_numpy(rng.random((h, w)) < 0.2).to(card)
                if prologue != "none" else None)
    thr = 20 if prologue == "excluded+thr" else None
    got = _launched(sd.dilate_rgb, lambda: sd.dilate_rgb(
        x, radius, excluded=excluded, thr=thr))
    want = sd.dilate_rgb_plain(sd.dilate_input_plain(x, excluded, thr),
                               radius)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mirror,flip_z", [(True, False), (False, False),
                                           (False, True)])
def test_shape_rows_edges_equal_plain(card, mirror, flip_z):
    """G1 == its plain version where its design breaks: widths 1, 15, 16,
    17, 33, 1210 and 1211 (odd widths have a middle column), bands that
    start on odd and even rows, 1, 5, 9 and 128 targets (blocks take 8),
    planes that are views of one stack (rows at any alignment) and tensors
    of their own; through shape_rows and the cached-pointer
    shape_rows_cached."""
    from colormipsearch_torch.cds.shape_oracle import TargetShapePlanes
    rng = np.random.default_rng(90 + 2 * mirror + flip_z)
    cases = [(1, 1, 1, 0, 1), (5, 7, 15, 1, 6), (5, 9, 16, 2, 9),
             (1, 6, 17, 3, 4), (128, 12, 33, 1, 12), (9, 10, 1210, 3, 9),
             (128, 8, 1211, 2, 7), (5, 566, 1210, 0, 566)]
    for n_t, h, w, r0, r1 in cases:
        query, lists = _shape_planes(rng, n_t, h, w, card)
        lists = [[p.clone() if i % 3 == 1 else p for i, p in enumerate(x)]
                 for x in lists]
        kw = dict(r0=r0, r1=r1, mirror=mirror, flip_z=flip_z)
        want = sk.shape_rows_plain(*query, *lists, **kw)
        _same(_launched(sk.shape_rows, lambda: sk.shape_rows(
            *query, *lists, **kw)), want)
        entries = [sk.CheckedPlanes(TargetShapePlanes(*(x[i] for x in lists)))
                   for i in range(n_t)]
        _same(_launched(sk.shape_rows, lambda: sk.shape_rows_cached(
            *query, entries, **kw)), want)


def _dilate_case(rng, radius, n_t, h, w, prologue, dev, offset=False):
    """G2 on n_t random frames of h x w (sparse, with channels at the
    threshold) against its plain version; with offset, the frames are a
    view that starts one frame into a larger tensor."""
    x = rng.integers(0, 256, (n_t + offset, h, w, 3), dtype=np.uint8)
    x[rng.random((n_t + offset, h, w)) < 0.97] = 0
    x[x == 19] = 20
    x = torch.from_numpy(x).to(dev)[int(offset):]
    excluded = (torch.from_numpy(rng.random((h, w)) < 0.2).to(dev)
                if prologue != "none" else None)
    thr = 20 if prologue == "excluded+thr" else None
    got = _launched(sd.dilate_rgb, lambda: sd.dilate_rgb(
        x, radius, excluded=excluded, thr=thr))
    want = sd.dilate_rgb_plain(sd.dilate_input_plain(x, excluded, thr),
                               radius)
    assert torch.equal(got, want), (radius, n_t, h, w, prologue, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [10.0, 20.0, 60.0, 5.0, 30.0])
@pytest.mark.parametrize("prologue", ["none", "excluded", "excluded+thr"])
def test_dilate_rgb_edges_equal_plain(card, radius, prologue):
    """G2 == its plain version where the compiled kernel's strips, row
    chunks, stages and ring period break: widths 1, 15, 16, 17, 33, 1210
    and 1211; heights 1, 7, k, 2k + 1, the ring period (21) and a stage
    (7) +- 1, and 566; 1, 2 and 5 frames; a frame view that is not
    16-byte aligned. The compiled radii (10, 20, 60) take the compiled
    kernel, the others (5, 30) the generic one."""
    from colormipsearch_torch.cds import kernels
    from colormipsearch_torch.imageproc.filters import make_line_radii
    import ctypes
    ext = [int(e) for e in make_line_radii(radius)]
    k = len(ext) // 2
    lib = kernels.load_library("shape_planes").lib
    words = lib.cms_dilate_plan(len(ext), (ctypes.c_int * len(ext))(*ext),
                                1, 8, 8)
    assert (words >= 0) == (radius in sd.compiled_footprints())
    rng = np.random.default_rng(int(radius) * 3 + len(prologue))
    shapes = [(1, 1, 1), (2, 7, 15), (1, k, 16), (1, 2 * k + 1, 17),
              (5, 20, 33), (1, 21, 1211), (1, 22, 1210), (2, 6, 130),
              (1, 8, 257), (1, 43, 131), (1, 566, 1210)]
    for n_t, h, w in shapes:
        _dilate_case(rng, radius, n_t, h, w, prologue, card)
    _dilate_case(rng, radius, 2, 9, 45, prologue, card, offset=True)


@pytest.mark.cuda
@pytest.mark.parametrize("border", [0, 4])
@pytest.mark.parametrize("use_excluded", [False, True])
def test_query_planes_equal_plain(card, border, use_excluded):
    """G3 == its plain version, and build_query_planes on the card (G2
    twice, then G3) == its run on the CPU."""
    rng = np.random.default_rng(border + 10 * use_excluded)
    h, w = 90, 333
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb[rng.random((h, w)) < 0.9] = 0
    excluded = rng.random((h, w)) < 0.1 if use_excluded else None
    planes = sd.build_query_planes(rgb, excluded, border, device=card)
    cpu = sd.build_query_planes(rgb, excluded, border, device="cpu")
    names = ("q_nonzero", "q_slice", "q_mask", "high_expr")
    _same([getattr(planes, n).cpu() for n in names],
          [getattr(cpu, n) for n in names])
    np.testing.assert_array_equal(planes.row_any, cpu.row_any)
    x = torch.from_numpy(rgb).to(card)
    ex = torch.from_numpy(excluded).to(card) if use_excluded else None
    d60 = sd.dilate_rgb(x[None], 60.0, excluded=ex)[0]
    d20 = sd.dilate_rgb(x[None], 20.0, excluded=ex)[0]
    got = _launched(sd.query_planes, lambda: sd.query_planes(
        x, ex, d60, d20, border))
    _same(got, sd.query_planes_plain(x, ex, d60, d20, border))


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0, 20, 255, 300])
@pytest.mark.parametrize("grad_is_rgb", [False, True])
def test_target_planes_equal_plain(card, thr, grad_is_rgb):
    """G4 == its plain version, each target's planes in tensors of their
    own, and build_target_plane_sets in both z-gap modes == the CPU's."""
    rng = np.random.default_rng(thr + grad_is_rgb)
    t, h, w = 3, 50, 201
    pool = np.array([0, 1, 19, 20, 21, 127, 254, 255], dtype=np.uint8)
    cdm = pool[rng.integers(0, len(pool), (t, h, w, 3))]
    zgap = pool[rng.integers(0, len(pool), (t, h, w, 3))]
    grad = (rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8) if grad_is_rgb
            else rng.integers(0, 65536, (t, h, w)).astype(np.uint16))
    excluded = rng.random((h, w)) < 0.1
    for mode in ("file", "otf"):
        zg = zgap if mode == "file" else None
        got = sd.build_target_plane_sets(cdm, grad, zg, excluded, thr=thr,
                                         zgap_mode=mode,
                                         grad_is_rgb=grad_is_rgb,
                                         device=card)
        cpu = sd.build_target_plane_sets(cdm, grad, zg, excluded, thr=thr,
                                         zgap_mode=mode,
                                         grad_is_rgb=grad_is_rgb,
                                         device="cpu")
        for g, c in zip(got, cpu):
            _same([p.cpu() for p in g], c)
    args = [torch.from_numpy(a).to(card) for a in (
        cdm, grad if grad_is_rgb else grad.view(np.int16), zgap, excluded)]
    got = _launched(sd.target_planes, lambda: sd.target_planes(
        *args, thr=thr, grad_is_rgb=grad_is_rgb))
    want = sd.target_planes_plain(*args, thr=thr, grad_is_rgb=grad_is_rgb)
    _same([torch.stack(p) for p in zip(*got)], want)


def _gradient_batch(device_slots, roi):
    """gradientScores' score_mask_partitions on the golden fixtures (the
    three LM targets, 40 matches each, in batches of 64) over the given
    device slots: [(gap, high expression)] per match and the plane
    cache."""
    import argparse
    import pathlib

    from colormipsearch_torch.cmd import gradientscores_cmd as gc
    from colormipsearch_torch.cds.shape_oracle import \
        build_mirrored_query_shape_planes
    from colormipsearch_torch.imageproc.io import image_from_array, load_image
    from colormipsearch_torch.mips import MIPsCache
    from colormipsearch_torch.model import (CDMatchEntity, ComputeFileType,
                                            EMNeuronEntity, FileData,
                                            LMNeuronEntity)
    fx = pathlib.Path(__file__).parent / "fixtures" / "cdsearch"
    mask_img = load_image(str(fx / "ems" / "12191_JRC2018U.tif"))
    h, w = mask_img.height, mask_img.width
    excluded = np.zeros((h, w), dtype=bool)
    excluded[:100, :330] = True
    em = EMNeuronEntity(entity_id=1, mip_id="em-0")
    names = sorted(p.stem for p in (fx / "grad").glob("*.png"))
    matches = []
    for i in range(120):
        name = names[i % len(names)]
        lm = LMNeuronEntity(entity_id=100 + i, mip_id=f"lm-{i}")
        files = {ComputeFileType.InputColorDepthImage: fx / "lms" /
                 f"{name}.tif",
                 ComputeFileType.GradientImage: fx / "grad" / f"{name}.png"}
        if i % 3 and (fx / "zgap" / f"{name}.tif").exists():
            files[ComputeFileType.ZGapImage] = fx / "zgap" / f"{name}.tif"
        for cft, path in files.items():
            lm.compute_files[cft] = FileData.from_string(str(path))
        m = CDMatchEntity()
        m.mask_image, m.matched_image = em, lm
        matches.append(m)
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=True, targetsPerBatch=64,
                              planes_threads=2)
    roi_img = qplanes_m = None
    if roi:
        roi_px = np.zeros((h, w, 3), dtype=np.uint8)
        roi_px[:, : w // 2] = 255
        roi_img = image_from_array(roi_px)
    qplanes = gc._build_qplanes(mask_img, excluded, roi_img, 0,
                                device_slots[0])
    if roi:
        qplanes_m = gc._to_device(build_mirrored_query_shape_planes(
            mask_img, excluded, roi_img, 0), device_slots[0])
    planes_cache = gc.PlaneCache(device_slots)
    scored = gc.score_mask_partitions(matches, qplanes, MIPsCache(256),
                                      args, excluded, planes_cache, qplanes_m)
    return [(m.gradient_area_gap, m.high_expression_area)
            for m in scored], planes_cache


@pytest.mark.cuda
@pytest.mark.parametrize("roi", [False, True])
def test_gradient_batch_over_two_slots(card, roi):
    """A batch whose target planes lie on two device slots (two cards
    where the machine has them, else two slots of one) scores, on the
    device of each slot, what the CPU scores; with an ROI mask (two
    passes, the second with flipped z planes) too. G1 and G4 launch, and
    G2 and G3 where the query planes are built on the card."""
    other = torch.device("cuda", 1) if torch.cuda.device_count() > 1 \
        else card
    counters = (sk.shape_rows, sd.dilate_rgb, sd.query_planes,
                sd.target_planes)
    before = [fn.launches for fn in counters]
    got, cache = _gradient_batch([card, other], roi)
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    want, _ = _gradient_batch(["cpu"], roi)
    assert got == want and len(got) == 120
    assert {cache.slot(100 + i) for i in range(120)} == {0, 1}
    assert launched[0] >= 2 * (2 if roi else 1) and launched[3] >= 2
    assert launched[1] >= 2 and (launched[2] == 0 if roi
                                 else launched[2] == 1)


@pytest.mark.cuda
def test_spans_share_the_device_trace_clock(card, tmp_path):
    """A span around a kernel launch and a synchronize, under
    torch.profiler's CUDA activity, mapped as the benchmark maps a device
    trace onto the wall clock (`cdsbench/harness.py:read_trace`): the
    kernel's device interval lies inside the span, and the span ends
    within 1 ms of the kernel."""
    import time

    from cdsbench import harness
    from colormipsearch_torch.utils import trace
    x = torch.ones(1 << 24, device=card)
    torch.cuda.synchronize()
    window = harness.DeviceTrace(str(tmp_path))
    trace.enable()
    try:
        with window:
            time.sleep(0.02)
            with trace.span("launch"):
                x.mul_(2)
                torch.cuda.synchronize()
            time.sleep(0.02)
        (span,) = trace.drain()["spans"]
    finally:
        trace.disable()
    ms = 1_000_000

    def busy(t0, t1):
        return harness.read_trace(window.path, t0, t1, [])["busy_s"]

    around = busy(span.start_ns - 15 * ms, span.end_ns + 15 * ms)
    assert around > 0
    # all of the device time near the span falls inside it
    assert busy(span.start_ns, span.end_ns) == around
    # and the kernel runs in the span's last millisecond
    assert busy(span.end_ns - ms, span.end_ns) > 0
