"""The two stages of the port's count-capped prescreen bound
(colormipsearch_torch.cds.prescreen) against the JAX package, exactly:
the per-variant cell masks and counts (cell_masks_plain) equal the
reference's sliding cell statistics sliced per offset (_sliding_cell_stats,
_cell_slice, compat), the query CSR (sparse_query_rows) round-trips to the
dense features, and the composed plain stages equal the reference's
PairPrescreen.bounds_from_words and the port's dense fp32 formulation.
The wrappers check their inputs before any launch.

On the CPU the wrappers run the plain versions; the kernels themselves are
held against them on a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu.cds import prescreen as ref_ps  # noqa: E402
from colormipsearch_tpu.cds.oracle import shift_ring_offsets  # noqa: E402
from colormipsearch_tpu.cds.pixel_kernel import (  # noqa: E402
    prepare_query_planes, z_tolerance_to_zt9)
from colormipsearch_tpu.imageproc import (label_regions_mask,  # noqa: E402
                                          load_image)
from colormipsearch_tpu.imageproc.io import image_from_array  # noqa: E402

from colormipsearch_torch.cds import prescreen as ps  # noqa: E402
from colormipsearch_torch.cds.pixel_active import \
    ActiveTilePixelEngine  # noqa: E402

CPU = torch.device("cpu")
LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
    "GMR_31G04_AE_01-20190813_66_F3-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2704505419467849826-CH2-07_CDM",
]


def _pack(targets_u8, h, w):
    eng = ActiveTilePixelEngine(np.zeros((h, w, 3), np.uint8), 20, True, 20,
                                1.0, 2)
    return eng.pack_raw_words(targets_u8, CPU)


def _random_frames(rng, n, h, w, empty=0.6):
    t = rng.integers(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    t[rng.random((n, h, w)) < empty] = 0
    return t


def _grid(h, w):
    return (-(-h // ps.TILE_H), -(-w // ps.TILE_W))


def _reference_cells(words, zt9, offsets, grid_hw):
    """(bits, cnt) of every variant from the JAX package's sliding cell
    statistics, sliced per offset, in cell_masks_plain's layout."""
    pad = max(max(abs(dx), abs(dy)) for dx, dy in offsets)
    compat = np.asarray(ref_ps.compat_matrix(zt9), np.int64)      # [J, K]
    weights = np.left_shift(np.int64(1), np.arange(ref_ps.N_BINS))
    bits, cnt = [], []
    for flip in (False, True):
        or_full, cnt_full = ref_ps._sliding_cell_stats(
            jnp.asarray(words.numpy()), flip, pad, grid_hw)
        for dx, dy in offsets:
            pres = np.asarray(ref_ps._presence_from_bits(ref_ps._cell_slice(
                or_full, pad, dx, dy, grid_hw))).astype(np.int64)  # [T,np,K]
            w01 = (pres @ compat.T) > 0                            # [T,np,J]
            bits.append((w01 * weights).sum(axis=2).T)
            cnt.append(np.asarray(ref_ps._cell_slice(
                cnt_full, pad, dx, dy, grid_hw)).T)
    return np.stack(bits), np.stack(cnt)


@pytest.mark.parametrize("xy", [0, 2, 4, 6])
@pytest.mark.parametrize("h,w", [(37, 149), (16, 128), (23, 131)])
def test_cell_masks_equal_reference(xy, h, w):
    """Bits and counts of every variant (both orientations, 1 / 9 / 17 /
    25 offsets) equal the reference's, on frames of odd and aligned sizes
    with signal up to every edge: the flip is of the raw frame, cells and
    shifted windows past the frame read nothing."""
    rng = np.random.default_rng(100 * xy + h)
    t = _random_frames(rng, 3, h, w, empty=0.3)
    t[2] = 0  # an empty target
    words = _pack(t, h, w)
    offsets = tuple(shift_ring_offsets(xy))
    assert len(offsets) == {0: 1, 2: 9, 4: 17, 6: 25}[xy]
    zt9 = z_tolerance_to_zt9(1.0)
    bits, cnt = ps.cell_masks_plain(words, zt9, offsets, _grid(h, w))
    want_bits, want_cnt = _reference_cells(words, zt9, offsets, _grid(h, w))
    assert bits.dtype == torch.int64 and cnt.dtype == torch.uint8
    assert bits.shape == want_bits.shape == cnt.shape
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    assert (cnt[:, :, 2] == 0).all() and (bits[:, :, 2] == 0).all()
    assert int(cnt.max()) > 0


def test_cell_masks_in_target_blocks(monkeypatch):
    """Targets computed in blocks of FEATURE_BLOCK equal one block."""
    rng = np.random.default_rng(9)
    h, w = 24, 140
    words = _pack(_random_frames(rng, 5, h, w), h, w)
    offsets = tuple(shift_ring_offsets(2))
    zt9 = z_tolerance_to_zt9(2.0)
    whole = ps.cell_masks_plain(words, zt9, offsets, _grid(h, w))
    monkeypatch.setattr(ps.PairPrescreen, "FEATURE_BLOCK", 2)
    blocked = ps.cell_masks_plain(words, zt9, offsets, _grid(h, w))
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_col_bits_follow_compat():
    zt9 = z_tolerance_to_zt9(1.0)
    compat = ps.compat_matrix(zt9)
    got = ps.col_bits(zt9)
    for k in range(ps.N_BINS):
        for j in range(ps.N_BINS):
            assert bool((int(got[k]) >> j) & 1) == bool(compat[j, k])


def test_query_rows_round_trip():
    """The CSR holds each mask's non-zero cells in order and, per cell,
    its (bin, count) entries; it gives back the dense features, empty
    masks included, on the CPU and from numpy or a tensor."""
    rng = np.random.default_rng(3)
    npos = 24
    u = rng.integers(0, 129, size=(7, npos * ps.N_BINS))
    u[rng.random(u.shape) < 0.97] = 0
    u[[0, 4, 6]] = 0           # empty masks, the first and the last too
    u[1, :ps.N_BINS] = 128     # a full cell
    u = u.astype(np.uint8)
    rows = ps.sparse_query_rows(u)
    assert rows.n_masks == 7 and rows.npos == npos
    for t in rows.tensors():
        assert t.dtype == torch.int32 and t.device == CPU
    np.testing.assert_array_equal(rows.to_dense().numpy(), u)
    u3 = u.reshape(7, npos, ps.N_BINS)
    mask_off, cell_off = rows.mask_off.numpy(), rows.cell_off.numpy()
    for b in range(7):
        cells = rows.cell_pos.numpy()[mask_off[b]:mask_off[b + 1]]
        np.testing.assert_array_equal(cells,
                                      np.flatnonzero(u3[b].any(axis=1)))
        for c, pos in zip(range(mask_off[b], mask_off[b + 1]), cells):
            ent = rows.entries.numpy()[cell_off[c]:cell_off[c + 1]]
            np.testing.assert_array_equal(ent & 63,
                                          np.flatnonzero(u3[b, pos]))
            np.testing.assert_array_equal(ent >> 8, u3[b, pos][ent & 63])
    again = ps.sparse_query_rows(torch.from_numpy(u))
    for a, b in zip(rows.tensors(), again.tensors()):
        assert torch.equal(a, b)
    empty = ps.sparse_query_rows(np.zeros((3, npos * ps.N_BINS), np.uint8))
    assert empty.mask_off.tolist() == [0, 0, 0, 0]
    assert empty.cell_pos.numel() == 0 and empty.cell_off.tolist() == [0]


def _plain_bands(rows):
    """{(group, band): [(mask in group, cell in band, [(bin, count)])]}
    read off the CSR mask by mask, cell by cell."""
    mask_off, cell_off = rows.mask_off.numpy(), rows.cell_off.numpy()
    cell_pos, entries = rows.cell_pos.numpy(), rows.entries.numpy()
    out = {}
    for b in range(rows.n_masks):
        for c in range(mask_off[b], mask_off[b + 1]):
            g, band = b // ps.MASK_GROUP, cell_pos[c] // ps.BAND_CELLS
            out.setdefault((g, band), []).append(
                (b % ps.MASK_GROUP, cell_pos[c] % ps.BAND_CELLS,
                 [(int(e) & 63, int(e) >> 8)
                  for e in entries[cell_off[c]:cell_off[c + 1]]]))
    return out


def _decoded(recs, rec_off, entries, k):
    """(mask in group, cell in band, [(bin, count)]) of banded record k:
    its n_lo entries test bins below 32, its n_hi the others."""
    rec = int(recs[k])
    n_lo, n_hi = (rec >> 8) & 63, (rec >> 14) & 63
    ent = entries[rec_off[k]:rec_off[k + 1]].astype(np.uint64)
    assert len(ent) == n_lo + n_hi
    bits = (ent & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert (bits & (bits - 1) == 0).all() and (bits > 0).all()
    bins = np.log2(bits).astype(int) + np.where(np.arange(len(ent)) < n_lo,
                                                0, 32)
    return (rec >> 20, rec & 0xFF,
            list(zip(bins.tolist(), (ent >> np.uint64(32)).astype(
                np.int64).tolist())))


@pytest.mark.parametrize("n_masks,npos", [(300, 300), (256, 256), (5, 90),
                                          (1, 129)])
def test_query_bands_follow_csr(n_masks, npos):
    """The capped kernel's banded CSR holds, for each (mask group, band),
    exactly the CSR's cells of those masks in that band, by mask and then
    cell, with their entries: B not a multiple of MASK_GROUP, a last band
    shorter than BAND_CELLS (npos 300, 90, 129), a band no mask touches,
    empty masks (the first and the last among them)."""
    rng = np.random.default_rng(n_masks + npos)
    u = rng.integers(1, 129, size=(n_masks, npos, ps.N_BINS))
    u[rng.random(u.shape) < 0.995] = 0
    u[::4] = 0
    u[-1] = 0
    if npos > 2 * ps.BAND_CELLS:  # band 1 untouched by any mask
        u[:, ps.BAND_CELLS:2 * ps.BAND_CELLS] = 0
    u[min(1, n_masks - 1), -1, 7] = 3  # a cell in the last band
    rows = ps.sparse_query_rows(u.reshape(n_masks, -1).astype(np.uint8))
    bands = rows.bands
    # built once, kept with the rows, also through a move to their device
    assert rows.bands is bands and rows.to(CPU).bands is bands
    n_bands = -(-npos // ps.BAND_CELLS)
    n_groups = -(-n_masks // ps.MASK_GROUP)
    assert bands.n_bands == n_bands
    for t in bands.tensors():
        assert t.device == CPU
    assert [t.dtype for t in bands.tensors()] == [torch.int32] * 3 + [
        torch.int64]
    seg_off, recs = bands.seg_off.numpy(), bands.recs.numpy()
    rec_off, entries = bands.rec_off.numpy(), bands.entries.numpy()
    assert seg_off.shape == (n_groups * n_bands + 1,)
    assert seg_off[0] == 0 and seg_off[-1] == rows.cell_pos.numel()
    assert rec_off[-1] == rows.entries.numel()
    want = _plain_bands(rows)
    for g in range(n_groups):
        for band in range(n_bands):
            seg = range(seg_off[g * n_bands + band],
                        seg_off[g * n_bands + band + 1])
            got = [_decoded(recs, rec_off, entries, k) for k in seg]
            assert got == want.get((g, band), []), (g, band)
    if npos > 2 * ps.BAND_CELLS:
        assert all(seg_off[g * n_bands + 1] == seg_off[g * n_bands + 2]
                   for g in range(n_groups))
    assert (0, n_bands - 1) in want or (n_groups - 1, n_bands - 1) in want
    empty = ps.sparse_query_rows(np.zeros((3, npos * ps.N_BINS), np.uint8))
    assert empty.bands.seg_off.tolist() == [0] * (n_bands + 1)
    assert empty.bands.recs.numel() == empty.bands.entries.numel() == 0


def _queries(rng, n, h, w):
    qs = []
    for i in range(n):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.6 + 0.35 * (i % 3) / 2] = 0
        qs.append(q)
    return [prepare_query_planes(image_from_array(q), 20, None).words
            for q in qs]


def _composed_and_references(u, words, zt9, xy, h, w):
    """The port's bound (the two stages), the JAX package's, and the
    port's dense fp32 formulation, each [B, T]."""
    screen = ps.PairPrescreen(zt9, xy, h, w)
    got = screen.bounds_from_words(u, words)
    want = np.asarray(ref_ps.PairPrescreen(zt9, xy, h, w).bounds_from_words(
        u, words.numpy()))
    u3 = torch.from_numpy(u).to(torch.float32).reshape(u.shape[0], -1,
                                                       ps.N_BINS)
    with ps._fp32_matmul():
        dense = torch.maximum(*(ps._variant_block_bounds_capped(
            u3, words, zt9, screen.offsets, screen.grid_hw, flip)
            for flip in (False, True))).numpy()
    return got, want, dense


@pytest.mark.parametrize("n_targets", [1, 63, 65])
def test_composed_bound_equals_reference(n_targets):
    """cell_masks_plain then capped_bounds_plain equal the JAX package's
    bounds_from_words and the dense formulation on every pair: 11 masks
    (two of them empty), T of 1, 63 and 65 (around the 64-target blocks
    of the reference and of cell_masks_plain)."""
    rng = np.random.default_rng(n_targets)
    h, w = 29, 150
    zt9 = z_tolerance_to_zt9(2.0)
    screen = ps.PairPrescreen(zt9, 2, h, w)
    u = np.stack([screen.query_features(q) for q in _queries(rng, 11, h, w)])
    u[[3, 10]] = 0
    words = _pack(_random_frames(rng, n_targets, h, w), h, w)
    got, want, dense = _composed_and_references(u, words, zt9, 2, h, w)
    assert got.shape == (11, n_targets) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense)
    assert (got[[3, 10]] == 0).all()
    assert got.max() > 0


@pytest.mark.parametrize("xy", [0, 4, 6])
def test_composed_bound_equals_reference_other_shifts(xy):
    rng = np.random.default_rng(40 + xy)
    h, w = 21, 133
    zt9 = z_tolerance_to_zt9(0.5)
    screen = ps.PairPrescreen(zt9, xy, h, w)
    u = np.stack([screen.query_features(q) for q in _queries(rng, 5, h, w)])
    words = _pack(_random_frames(rng, 6, h, w), h, w)
    got, want, dense = _composed_and_references(u, words, zt9, xy, h, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense)


def test_composed_bound_fixture_frames(fixtures_dir):
    """The three EM fixtures (and an empty mask) against the four LM
    fixtures at 566x1210: equal to the reference, and each golden pair's
    bound at least its score."""
    ems = sorted((fixtures_dir / "ems").iterdir())
    queries = []
    for path in ems:
        img = load_image(path)
        excluded = label_regions_mask(img.height, img.width)
        queries.append(prepare_query_planes(img, 20, excluded).words)
    h, w = queries[0].shape
    zt9 = z_tolerance_to_zt9(1.0)
    screen = ps.PairPrescreen(zt9, 2, h, w)
    u = np.stack([screen.query_features(q) for q in queries]
                 + [np.zeros(screen.query_features(queries[0]).shape,
                             np.uint8)])
    rows = ps.sparse_query_rows(u)
    assert np.diff(rows.mask_off.numpy()).tolist()[-1] == 0
    t = np.stack([load_image(fixtures_dir / "lms" / f"{n}.tif").pixels
                  for n in LM_NAMES])
    words = _pack(t, h, w)
    got = screen.bounds_from_words(rows, words)
    want = np.asarray(ref_ps.PairPrescreen(zt9, 2, h, w).bounds_from_words(
        u, words.numpy()))
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == 0).all()
    i12191 = [p.name for p in ems].index("12191_JRC2018U.tif")
    assert (got[i12191, :3] >= np.array([439, 414, 426])).all(), got


def _cells_args(h=16, w=128, n=3):
    rng = np.random.default_rng(1)
    words = _pack(_random_frames(rng, n, h, w), h, w)
    return words, z_tolerance_to_zt9(1.0), tuple(shift_ring_offsets(2)), \
        _grid(h, w)


def _no_plain(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(ps, "cell_masks_plain", fail)
    monkeypatch.setattr(ps, "capped_bounds_plain", fail)


@pytest.mark.parametrize("case", ["dtype", "strided", "mixed", "offsets",
                                  "far"])
def test_cells_wrapper_refuses_before_launch(case, monkeypatch):
    words, zt9, offsets, grid_hw = _cells_args()
    if case == "dtype":
        words = words.to(torch.int64)
    elif case == "strided":
        words = words[:, :, ::2]
    elif case == "mixed":
        words = torch.empty(words.shape, dtype=torch.int32, device="meta")
    elif case == "offsets":
        offsets = tuple(shift_ring_offsets(12))  # 49 > MAX_OFFSETS
    else:
        offsets = ((0, 0), (ps.MAX_PAD + 2, 0))  # beyond MAX_PAD
    _no_plain(monkeypatch)
    before = ps.prescreen_cells.launches
    with pytest.raises(ValueError):
        ps.prescreen_cells(words, zt9, offsets, grid_hw)
    assert ps.prescreen_cells.launches == before


@pytest.mark.parametrize("case", ["bits_dtype", "cnt_dtype", "rows_dtype",
                                  "strided", "mixed", "shape"])
def test_capped_wrapper_refuses_before_launch(case, monkeypatch):
    words, zt9, offsets, grid_hw = _cells_args()
    bits, cnt = ps.cell_masks_plain(words, zt9, offsets, grid_hw)
    npos = bits.shape[1]
    u = np.zeros((3, npos * ps.N_BINS), np.uint8)
    u[:, 5] = 2
    rows = ps.sparse_query_rows(u)
    if case == "bits_dtype":
        bits = bits.to(torch.int32)
    elif case == "cnt_dtype":
        cnt = cnt.to(torch.int32)
    elif case == "rows_dtype":
        rows = ps.QueryRows(rows.mask_off, rows.cell_pos.long(),
                            rows.cell_off, rows.entries, npos)
    elif case == "strided":
        bits = bits.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "mixed":
        cnt = torch.empty(cnt.shape, dtype=torch.uint8, device="meta")
    else:
        cnt = cnt[:, :-1].contiguous()
    _no_plain(monkeypatch)
    before = ps.prescreen_capped.launches
    with pytest.raises(ValueError):
        ps.prescreen_capped(rows, bits, cnt)
    assert ps.prescreen_capped.launches == before


def test_wrappers_run_plain_on_cpu():
    """On CPU tensors both wrappers run their plain versions and count no
    launch."""
    words, zt9, offsets, grid_hw = _cells_args()
    before = (ps.prescreen_cells.launches, ps.prescreen_capped.launches)
    bits, cnt = ps.prescreen_cells(words, zt9, offsets, grid_hw)
    want = ps.cell_masks_plain(words, zt9, offsets, grid_hw)
    assert torch.equal(bits, want[0]) and torch.equal(cnt, want[1])
    rng = np.random.default_rng(2)
    u = rng.integers(0, 5, size=(4, bits.shape[1] * ps.N_BINS))
    u[rng.random(u.shape) < 0.9] = 0
    rows = ps.sparse_query_rows(u.astype(np.uint8))
    assert torch.equal(ps.prescreen_capped(rows, bits, cnt),
                       ps.capped_bounds_plain(rows, bits, cnt))
    assert (ps.prescreen_cells.launches,
            ps.prescreen_capped.launches) == before


class _CudaLike:
    """A stand-in for a contiguous CUDA tensor (this torch has no card):
    the attributes the wrappers check before they build and launch."""

    def __init__(self, shape, dtype):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def numel(self):
        return int(np.prod(self.shape))

    def is_contiguous(self):
        return True


def test_wrappers_never_fall_back_without_nvcc(monkeypatch, tmp_path):
    """CUDA inputs with no buildable kernel raise, for both wrappers; the
    plain version never runs in the kernel's place."""
    from colormipsearch_torch.cds import kernels
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    _no_plain(monkeypatch)
    before = (ps.prescreen_cells.launches, ps.prescreen_capped.launches)
    offsets = tuple(shift_ring_offsets(2))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ps.prescreen_cells(_CudaLike((2, 16, 128), torch.int32),
                           z_tolerance_to_zt9(1.0), offsets, (2, 1))
    npos = 16
    rows = ps.QueryRows(_CudaLike((4,), torch.int32),
                        _CudaLike((5,), torch.int32),
                        _CudaLike((6,), torch.int32),
                        _CudaLike((9,), torch.int32), npos)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ps.prescreen_capped(rows, _CudaLike((18, npos, 3), torch.int64),
                            _CudaLike((18, npos, 3), torch.uint8))
    assert (ps.prescreen_cells.launches,
            ps.prescreen_capped.launches) == before
