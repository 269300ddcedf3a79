"""gradientScores' device stage through the interfaces of its four
kernels (G1 shape_rows, G2 dilate_rgb, G3 query_planes, G4
target_planes), on the CPU where each wrapper runs its plain version:
every result equals the JAX package's function exactly on inputs made
with numpy from a seed, and no wrapper runs its plain version for CUDA
tensors. The kernels themselves are held against these plain versions on
a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu.cds import shape_device as ref_sd  # noqa: E402
from colormipsearch_tpu.cds import shape_kernel as ref_sk  # noqa: E402

from colormipsearch_torch.cds import kernels  # noqa: E402
from colormipsearch_torch.cds import shape_device as sd  # noqa: E402
from colormipsearch_torch.cds import shape_kernel as sk  # noqa: E402

CPU = torch.device("cpu")
_ref_dilate = jax.jit(ref_sd._dilate_rgb, static_argnums=1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- G1 --------------------------------------------------------------------

def _score_inputs(rng, t, h, w):
    """Query planes and t targets' planes with the scorer's edges: slice
    gaps of 79, 80 and 81, gaps of 3 and 4, gradients at and above
    32768."""
    q_nonzero = rng.random((h, w)) < 0.6
    q_slice = np.where(q_nonzero, rng.integers(0, 257, (h, w)), 0)
    q_slice[rng.random((h, w)) < 0.1] = 0
    q_mask = q_nonzero & (rng.random((h, w)) < 0.7)
    high_expr = rng.random((h, w)) < 0.3
    grad = rng.integers(0, 65536, size=(t, h, w)).astype(np.uint16)
    grad[rng.random((t, h, w)) < 0.3] = rng.integers(2, 6)  # gaps 3 and 4
    grad[:, 0, :4] = (3, 4, 32768, 65535)
    z_nonzero = rng.random((t, h, w)) < 0.6
    z_slice = np.where(z_nonzero, rng.integers(0, 257, (t, h, w)), 0)
    # slice gaps of 79, 80 and 81 against the query's slices
    edge = rng.random((t, h, w)) < 0.3
    delta = rng.choice([-81, -80, -79, 79, 80, 81], size=(t, h, w))
    shifted = q_slice[None] + delta
    ok = edge & (q_slice[None] > 0) & (shifted > 0) & (shifted <= 256)
    z_slice = np.where(ok, shifted, z_slice)
    z_nonzero |= ok
    t_above = rng.random((t, h, w)) < 0.4
    query = (q_nonzero, q_slice.astype(np.int16), q_mask, high_expr)
    target = (t_above, grad, z_nonzero, z_slice.astype(np.uint16))
    return query, target


def _target_lists(target):
    """Each target's four planes as [H, W] tensors of their own, in the
    kernel's dtypes (grad and z_slice as int16 bits)."""
    t_above, grad, z_nonzero, z_slice = target
    planes = (t_above, grad.view(np.int16), z_nonzero,
              z_slice.view(np.int16))
    return [[torch.from_numpy(np.ascontiguousarray(p[i]))
             for i in range(p.shape[0])] for p in planes]


@pytest.mark.parametrize("w", [45, 77, 131])
@pytest.mark.parametrize("mirror", [True, False])
def test_shape_rows_equals_jax(w, mirror):
    """The pointer-table scorer over per-target planes, in a band with
    r0 > 0, equals shape_score_stacked and shape_score_kernel."""
    rng = np.random.default_rng(1000 + w + mirror)
    t, h, r0, r1 = 3, 37, 5, 29
    query, target = _score_inputs(rng, t, h, w)
    q = [torch.from_numpy(a) for a in query]
    lists = _target_lists(target)
    got = sk.shape_rows(*q, *lists, r0=r0, r1=r1, mirror=mirror)
    ref_lists = [[jnp.asarray(p[i]) for i in range(t)] for p in target]
    want = ref_sk.shape_score_stacked(
        *[jnp.asarray(a) for a in query], *ref_lists, r0=r0, r1=r1,
        mirror=mirror)
    want_kernel = ref_sk.shape_score_kernel(
        *[a[r0:r1] for a in query], target[1][:, r0:r1],
        target[2][:, r0:r1], target[3][:, r0:r1], target[0][:, r0:r1],
        mirror=mirror)
    for g, w_, wk in zip(got, want, want_kernel):
        assert g.dtype == torch.int32 and tuple(g.shape) == (t, r1 - r0)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
    # the stacked interface and the public one agree with it
    stacked = sk.shape_score_rows(*[a[r0:r1] for a in q],
                                  *[torch.stack(x)[:, r0:r1].contiguous()
                                    for x in (lists[1], lists[2], lists[3],
                                              lists[0])], mirror=mirror)
    for g, s in zip(got, stacked):
        assert torch.equal(g, s)
    for g, s in zip(got, sk.shape_score_stacked(*q, *lists, r0=r0, r1=r1,
                                                mirror=mirror)):
        assert torch.equal(g, s)


@pytest.mark.parametrize("w", [45, 130])
def test_shape_rows_flip_z_equals_jax(w):
    """flip_z (the ROI-mask path's mirrored-query pass) scores the z
    planes read at W-1-x, as the JAX command scores them flipped."""
    rng = np.random.default_rng(77 + w)
    t, h = 4, 24
    query, target = _score_inputs(rng, t, h, w)
    got = sk.shape_rows(*[torch.from_numpy(a) for a in query],
                        *_target_lists(target), r0=0, r1=h, mirror=False,
                        flip_z=True)
    t_above, grad, z_nonzero, z_slice = target
    want = ref_sk.shape_score_kernel(
        *query, grad, z_nonzero[:, :, ::-1], z_slice[:, :, ::-1], t_above,
        mirror=False)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _checked(lists, i):
    from colormipsearch_torch.cds.shape_oracle import TargetShapePlanes
    return sk.CheckedPlanes(TargetShapePlanes(*(x[i] for x in lists)))


@pytest.mark.parametrize("mirror,flip_z", [(True, False), (False, False),
                                           (False, True)])
def test_shape_rows_cached_equals_jax(mirror, flip_z):
    """The cached-pointer path (planes checked once, CheckedPlanes)
    equals the JAX scorer, and each entry's pointers are its planes'."""
    rng = np.random.default_rng(60 + 2 * mirror + flip_z)
    t, h, w, r0, r1 = 5, 30, 61, 4, 27
    query, target = _score_inputs(rng, t, h, w)
    q = [torch.from_numpy(a) for a in query]
    lists = _target_lists(target)
    entries = [_checked(lists, i) for i in range(t)]
    for i, e in enumerate(entries):
        assert e.ptrs.tolist() == [x[i].data_ptr() for x in lists]
        assert e.shape == (h, w) and e.device == CPU
    got = sk.shape_rows_cached(*q, entries, r0=r0, r1=r1, mirror=mirror,
                               flip_z=flip_z)
    t_above, grad, z_nonzero, z_slice = (a[:, r0:r1] for a in target)
    if flip_z:
        z_nonzero, z_slice = z_nonzero[:, :, ::-1], z_slice[:, :, ::-1]
    want = ref_sk.shape_score_kernel(*[a[r0:r1] for a in query], grad,
                                     z_nonzero, z_slice, t_above,
                                     mirror=mirror)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    for g, s in zip(got, sk.shape_rows(*q, *lists, r0=r0, r1=r1,
                                       mirror=mirror, flip_z=flip_z)):
        assert torch.equal(g, s)


def test_checked_planes_refuse_what_g1_cannot_read():
    """CheckedPlanes (the plane cache's check at insert) refuses a plane
    of another dtype, shape or layout, as shape_rows' per-call checks
    do."""
    from colormipsearch_torch.cds.shape_oracle import TargetShapePlanes
    good = [torch.zeros((6, 9), dtype=dt) for dt in sd.TARGET_PLANE_DTYPES]
    sk.CheckedPlanes(TargetShapePlanes(*good))
    bad = [
        (1, torch.zeros((6, 9), dtype=torch.int32), "grad"),
        (2, torch.zeros((6, 8), dtype=torch.bool), "z_nonzero"),
        (3, torch.zeros((9, 6), dtype=torch.int16).t(), "z_slice"),
        (0, torch.zeros((2, 6, 9), dtype=torch.bool), "t_above"),
    ]
    for i, plane, name in bad:
        planes = list(good)
        planes[i] = plane
        with pytest.raises(ValueError, match=name):
            sk.CheckedPlanes(TargetShapePlanes(*planes))


def test_plane_cache_pointers_after_eviction():
    """The plane cache's entries after eviction and a rebuild: a rebuilt
    target's pointers are its new planes', an entry evicted while held
    still holds its own planes (so a queued table never names freed
    memory), and scoring the cache's entries equals the JAX scorer."""
    from colormipsearch_torch.cds.shape_oracle import TargetShapePlanes
    from colormipsearch_torch.cmd.gradientscores_cmd import PlaneCache
    rng = np.random.default_rng(61)
    t, h, w = 4, 20, 33
    query, target = _score_inputs(rng, t, h, w)
    lists = _target_lists(target)

    def planes(i):  # a fresh build of target i's planes
        return TargetShapePlanes(*(x[i].clone() for x in lists))

    cache = PlaneCache("cpu", max_entries=2)
    for i in range(t):
        cache.insert(i, planes(i))
    assert len(cache) == 2 and 0 not in cache
    held = cache.entry(3)
    cache.insert(0, planes(0))   # evicts 2
    cache.insert(3, planes(3))   # 3 rebuilt while `held` is in use
    assert 2 not in cache
    fresh = cache.entry(3)
    assert fresh is not held
    for e in (held, fresh):
        assert e.ptrs.tolist() == [getattr(e.planes, n).data_ptr()
                                   for n in sk.TARGET_PLANE_NAMES]
    assert fresh.ptrs.tolist() != held.ptrs.tolist()
    got = sk.shape_rows_cached(*[torch.from_numpy(a) for a in query],
                               [cache.entry(0), fresh, held], r0=0, r1=h,
                               mirror=True)
    pick = [0, 3, 3]
    want = ref_sk.shape_score_kernel(*query, *(target[j][pick] for j in
                                               (1, 2, 3, 0)), mirror=True)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


# ---- G2 --------------------------------------------------------------------

def _sparse_frames(rng, t, h, w, keep=0.03):
    x = rng.integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)
    x[rng.random((t, h, w)) >= keep] = 0
    x[0, 0, w // 3] = (250, 3, 9)     # signal on the frame's edges
    x[-1, -1, -1] = (1, 2, 3)
    x[-1, h // 2, 0] = (7, 8, 199)
    return x


@pytest.mark.parametrize("radius", [10.0, 20.0, 60.0, 5.0, 30.0])
@pytest.mark.parametrize("prologue", ["none", "excluded", "excluded+thr"])
def test_dilate_rgb_equals_jax(radius, prologue):
    """dilate_rgb, with the clearing and masking it applies to its input,
    equals the JAX dilation of the cleared (and masked) frames, at the
    compiled radii (10, 20, 60) and at two the generic kernel takes."""
    rng = np.random.default_rng(int(radius) * 7 + len(prologue))
    h, w = 66, 97
    x = _sparse_frames(rng, 2, h, w, keep=0.05)
    x[x == 19] = 20  # channels at the threshold
    excluded = thr = None
    want_in = x.copy()
    if prologue != "none":
        excluded = rng.random((h, w)) < 0.2
        want_in[:, excluded] = 0
    if prologue == "excluded+thr":
        thr = 20
        want_in[~(want_in > thr).any(axis=-1)] = 0
    got = sd.dilate_rgb(torch.from_numpy(x), radius,
                        excluded=(torch.from_numpy(excluded)
                                  if excluded is not None else None), thr=thr)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_ref_dilate(want_in, radius)))


def test_compiled_footprints_equal_make_line_radii():
    """G2's compiled footprints (the EXT_R<r> tables of
    csrc/shape_planes.cu) are makeLineRadii at the radii the plane builds
    dilate with (the query's 60 and 20, the z-gap's 10), in both
    packages; 5 and 30 are not compiled (the generic kernel's radii in
    the tests)."""
    from colormipsearch_torch.imageproc.filters import make_line_radii
    from colormipsearch_tpu.imageproc.filters import \
        make_line_radii as ref_radii
    got = sd.compiled_footprints()
    assert sorted(got) == [10.0, 20.0, 60.0]
    for radius, ext in got.items():
        assert ext == tuple(int(e) for e in make_line_radii(radius))
        assert ext == tuple(int(e) for e in ref_radii(radius))
    for radius in (5.0, 30.0):
        assert tuple(int(e) for e in make_line_radii(radius)) not in \
            set(got.values())


# ---- G3 --------------------------------------------------------------------

def _query_frame(rng, h, w):
    pool = np.array([0, 1, 2, 3, 19, 20, 127, 254, 255], dtype=np.uint8)
    rgb = pool[rng.integers(0, len(pool), size=(h, w, 3))]
    rgb[rng.random((h, w)) < 0.85] = 0
    return rgb


@pytest.mark.parametrize("border", [0, 4])
@pytest.mark.parametrize("use_excluded", [False, True])
def test_query_planes_equal_jax(border, use_excluded):
    """query_planes over the frame and its two dilations, and
    build_query_planes around them, equal _build_query_planes_jit."""
    rng = np.random.default_rng(300 + border + 10 * use_excluded)
    h, w = 70, 141
    rgb = _query_frame(rng, h, w)
    excluded = rng.random((h, w)) < 0.15 if use_excluded else None
    ex_t = torch.from_numpy(excluded) if use_excluded else None
    cleared = rgb.copy()
    if use_excluded:
        cleared[excluded] = 0
    d60 = np.asarray(_ref_dilate(cleared[None], 60.0))[0]
    d20 = np.asarray(_ref_dilate(cleared[None], 20.0))[0]
    got = sd.query_planes(torch.from_numpy(rgb), ex_t, torch.from_numpy(d60),
                          torch.from_numpy(d20), border)
    want = ref_sd._build_query_planes_jit(
        jnp.asarray(rgb), jnp.asarray(excluded if use_excluded
                                      else np.zeros((1, 1), bool)),
        ref_sd._device_slice_table(), border=border,
        has_excluded=use_excluded)
    assert [g.dtype for g in got] == [torch.bool, torch.int16, torch.bool,
                                      torch.bool, torch.bool]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(_np(g).astype(np.int32),
                                      np.asarray(w_).astype(np.int32))
    planes = sd.build_query_planes(rgb, excluded, border, device=CPU)
    for g, name in zip(got, ("q_nonzero", "q_slice", "q_mask", "high_expr")):
        assert torch.equal(g, getattr(planes, name))
    np.testing.assert_array_equal(planes.row_any, got[4].numpy())


# ---- G4 --------------------------------------------------------------------

def _target_frames(rng, t, h, w, grad_is_rgb):
    pool = np.array([0, 1, 19, 20, 21, 127, 254, 255], dtype=np.uint8)
    cdm = pool[rng.integers(0, len(pool), size=(t, h, w, 3))]
    cdm[rng.random((t, h, w)) < 0.6] = 0
    zgap = pool[rng.integers(0, len(pool), size=(t, h, w, 3))]
    if grad_is_rgb:
        grad = rng.integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)
    else:
        grad = rng.integers(0, 65536, size=(t, h, w)).astype(np.uint16)
        grad[0, 0, :4] = (0, 32767, 32768, 65535)
    return cdm, grad, zgap


def _check_sets(sets, want, t):
    assert len(sets) == t
    for j, planes in enumerate(sets):
        for g, dt in zip(planes, sd.TARGET_PLANE_DTYPES):
            assert g.dtype == dt and g._base is None  # no view of a batch
        t_above, grad, z_nonzero, z_slice = planes
        np.testing.assert_array_equal(t_above.numpy(), np.asarray(want[0][j]))
        np.testing.assert_array_equal(sd.grad_values(grad).numpy(),
                                      np.asarray(want[1][j]).astype(np.int32))
        np.testing.assert_array_equal(z_nonzero.numpy(),
                                      np.asarray(want[2][j]))
        np.testing.assert_array_equal(z_slice.numpy().astype(np.int32),
                                      np.asarray(want[3][j]).astype(np.int32))


@pytest.mark.parametrize("thr", [0, 254, 255, 300])
@pytest.mark.parametrize("grad_is_rgb", [False, True])
@pytest.mark.parametrize("mode", ["file", "otf"])
def test_target_plane_sets_equal_jax(mode, grad_is_rgb, thr):
    """Each target's planes, in tensors of their own, equal
    _build_target_planes_jit's batch in both z-gap modes, with RGB and
    gray gradients, at thresholds on and past the u8 range."""
    rng = np.random.default_rng(500 + thr + 2 * grad_is_rgb)
    t, h, w = 3, 30, 45
    cdm, grad, zgap = _target_frames(rng, t, h, w, grad_is_rgb)
    excluded = rng.random((h, w)) < 0.1
    zgap_in = zgap if mode == "file" else None
    sets = sd.build_target_plane_sets(cdm, grad, zgap_in, excluded, thr=thr,
                                      zgap_mode=mode,
                                      grad_is_rgb=grad_is_rgb, device=CPU)
    want = ref_sd.build_target_planes_device(
        cdm, grad, zgap_in, jnp.asarray(excluded), thr=thr, zgap_mode=mode,
        grad_is_rgb=grad_is_rgb)
    _check_sets(sets, want, t)


@pytest.mark.parametrize("grad_is_rgb", [False, True])
def test_target_planes_equal_jax(grad_is_rgb):
    """target_planes over given z-gap frames (the kernel's own inputs)
    equals the JAX build in its file mode, without an excluded mask."""
    rng = np.random.default_rng(900 + grad_is_rgb)
    t, h, w = 2, 21, 67
    cdm, grad, zgap = _target_frames(rng, t, h, w, grad_is_rgb)
    grad_t = torch.from_numpy(grad if grad_is_rgb else grad.view(np.int16))
    sets = sd.target_planes(torch.from_numpy(cdm), grad_t,
                            torch.from_numpy(zgap), None, thr=20,
                            grad_is_rgb=grad_is_rgb)
    want = ref_sd.build_target_planes_device(
        cdm, grad, zgap, None, thr=20, zgap_mode="file",
        grad_is_rgb=grad_is_rgb)
    _check_sets(sets, want, t)


# ---- the stage on the CPU, and no fallback for CUDA tensors -----------------

def test_stage_scores_equal_jax():
    """The stage as gradientScores runs it: query planes (G2, G3), target
    planes in both z-gap modes (G2, G4) and the scorer (G1) over the
    cache's per-target planes, against the JAX functions chained the
    same way."""
    rng = np.random.default_rng(4242)
    t, h, w = 4, 68, 101
    rgb = _query_frame(rng, h, w)
    excluded = rng.random((h, w)) < 0.05
    qp = sd.build_query_planes(rgb, excluded, 0, device=CPU)
    ref_q = ref_sd.build_query_planes_device(rgb, excluded, 0,
                                             pull_host=True)
    r0, r1 = qp.active_row_range()
    for mode in ("file", "otf"):
        cdm, grad, zgap = _target_frames(rng, t, h, w, False)
        zgap_in = zgap if mode == "file" else None
        sets = sd.build_target_plane_sets(cdm, grad, zgap_in, excluded,
                                          thr=20, zgap_mode=mode,
                                          grad_is_rgb=False, device=CPU)
        got = sk.shape_rows(qp.q_nonzero, qp.q_slice, qp.q_mask,
                            qp.high_expr, *[list(p) for p in zip(*sets)],
                            r0=r0, r1=r1, mirror=True)
        tp = ref_sd.build_target_planes_device(
            cdm, grad, zgap_in, jnp.asarray(excluded), thr=20,
            zgap_mode=mode, grad_is_rgb=False)
        want = ref_sk.shape_score_kernel(
            ref_q.q_nonzero[r0:r1], ref_q.q_slice[r0:r1],
            ref_q.q_mask[r0:r1], ref_q.high_expr[r0:r1], tp[1][:, r0:r1],
            tp[2][:, r0:r1], tp[3][:, r0:r1], tp[0][:, r0:r1], mirror=True)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        for g, w_ in zip(sk.finish_shape_scores(*got, mirror=True),
                         ref_sk.finish_shape_scores(*want, mirror=True)):
            np.testing.assert_array_equal(g, np.asarray(w_))


def test_shape_wrappers_never_fall_back(monkeypatch, tmp_path):
    """With tensors taken for CUDA ones and no buildable kernel, each of
    G1-G4 raises before any launch (G1 on both its paths, per-call checks
    and cached pointers); its plain version never runs."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sd, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(sk, "_on_cuda", lambda tensors: True)

    def plain(*a, **k):
        raise AssertionError("plain version ran for CUDA tensors")

    for mod, name in ((sk, "shape_rows_plain"), (sk, "score_rows_plain"),
                      (sd, "dilate_rgb_plain"), (sd, "query_planes_plain"),
                      (sd, "target_planes_plain")):
        monkeypatch.setattr(mod, name, plain)
    rng = np.random.default_rng(3)
    h, w = 12, 40
    query, target = _score_inputs(rng, 2, h, w)
    q = [torch.from_numpy(a) for a in query]
    frames = torch.from_numpy(_sparse_frames(rng, 2, h, w))
    rgb = frames[0]
    grad = torch.from_numpy(target[1].view(np.int16))
    lists = _target_lists(target)
    calls = [
        (sk.shape_rows, lambda: sk.shape_rows(
            *q, *lists, r0=2, r1=h, mirror=True)),
        (sk.shape_rows, lambda: sk.shape_rows_cached(
            *q, [_checked(lists, i) for i in range(2)], r0=2, r1=h,
            mirror=True)),
        (sd.dilate_rgb, lambda: sd.dilate_rgb(frames, 20.0)),
        (sd.query_planes, lambda: sd.query_planes(rgb, None, rgb, rgb, 0)),
        (sd.target_planes, lambda: sd.target_planes(
            frames, grad, frames, None, thr=20, grad_is_rgb=False)),
    ]
    for fn, call in calls:
        before = fn.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
        assert fn.launches == before
