"""The port's shape planes and shape scorer (colormipsearch_torch.cds.
shape_device, shape_kernel) against the JAX package's, on the CPU: every
comparison is exact array equality on inputs made from a numpy seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu.cds import shape_device as ref_sd  # noqa: E402
from colormipsearch_tpu.cds import shape_kernel as ref_sk  # noqa: E402
from colormipsearch_tpu.imageproc import (label_regions_mask,  # noqa: E402
                                          load_image)

from colormipsearch_torch.cds import lut  # noqa: E402
from colormipsearch_torch.cds import shape_device as sd  # noqa: E402
from colormipsearch_torch.cds import shape_kernel as sk  # noqa: E402
from colormipsearch_torch.imageproc import colors  # noqa: E402
from colormipsearch_torch.imageproc.filters import max_filter_rgb  # noqa: E402

CPU = torch.device("cpu")
LM_BJD = ("BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_"
          "HR-2483089192251293794-CH2-01_CDM")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _planes_equal(got, want):
    """Port planes (grad as int16 bits) equal the JAX planes' values."""
    t_above, grad, z_nonzero, z_slice = got
    np.testing.assert_array_equal(_np(t_above), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(sd.grad_values(grad)),
                                  np.asarray(want[1]).astype(np.int32))
    np.testing.assert_array_equal(_np(z_nonzero), np.asarray(want[2]))
    np.testing.assert_array_equal(_np(z_slice).astype(np.int32),
                                  np.asarray(want[3]).astype(np.int32))


def test_classify_index_and_slice_plane():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, size=(64, 257, 3), dtype=np.uint8)
    # ties between channels and saturated rows (the branch edges)
    rgb[0] = 200
    rgb[1, :, 0] = rgb[1, :, 1]
    rgb[2, :, 1] = rgb[2, :, 2]
    rgb[3, :, 0] = rgb[3, :, 2]
    rgb[4] = 0
    rgb[5, :, :2] = 255
    got_idx = sd.classify_index(torch.from_numpy(rgb).to(torch.int32))
    want_idx = ref_sd._classify_index(jnp.asarray(rgb, dtype=jnp.int32))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    got = sd.slice_plane(torch.from_numpy(rgb))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  np.asarray(ref_sd.slice_plane_device(rgb)))
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  lut.slice_plane(rgb))


def test_gray_no_gamma_exact_every_sum():
    """Every sum 0..765, each from several channel splits, against JAX's
    integer form and the host's float64 form of the reference."""
    s = np.arange(766)
    splits = [np.stack([np.minimum(s, 255), np.clip(s - 255, 0, 255),
                        np.clip(s - 510, 0, 255)], axis=-1),
              np.stack([np.clip(s - 510, 0, 255), np.minimum(s, 255),
                        np.clip(s - 255, 0, 255)], axis=-1),
              np.stack([(s + 2) // 3, (s + 1) // 3, s // 3], axis=-1)]
    rgb = np.stack(splits).astype(np.uint8)       # [3, 766, 3]
    assert (rgb.astype(np.int32).sum(-1) == s).all()
    got = sd.gray_no_gamma_exact(torch.from_numpy(rgb).to(torch.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_sd._gray_no_gamma_exact(
            jnp.asarray(rgb, dtype=jnp.int32))))
    np.testing.assert_array_equal(got.numpy(),
                                  colors.rgb_to_gray_no_gamma(rgb))


@pytest.mark.parametrize("radius", [10.0, 20.0, 60.0])
def test_dilate_rgb(radius):
    rng = np.random.default_rng(int(radius))
    x = rng.integers(0, 256, size=(2, 70, 150, 3), dtype=np.uint8)
    x[rng.random((2, 70, 150)) < 0.97] = 0
    # signal on every edge of the frame and in its corners
    x[0, 0, 40] = (250, 3, 9)
    x[0, -1, 90] = (4, 240, 1)
    x[1, 33, 0] = (7, 8, 199)
    x[1, 12, -1] = 255
    x[1, -1, -1] = (1, 2, 3)
    got = sd.dilate_rgb(torch.from_numpy(x), radius).numpy()
    want = jax.jit(ref_sd._dilate_rgb, static_argnums=1)(x, radius)
    np.testing.assert_array_equal(got, np.asarray(want))
    for t in range(x.shape[0]):
        np.testing.assert_array_equal(got[t], max_filter_rgb(x[t], radius))


def _small_frames(rng, h, w, n=2):
    pool = np.array([0, 1, 19, 20, 21, 127, 254, 255], dtype=np.uint8)
    cdm = pool[rng.integers(0, len(pool), size=(n, h, w, 3))]
    cdm[rng.random((n, h, w)) < 0.6] = 0
    zgap = pool[rng.integers(0, len(pool), size=(n, h, w, 3))]
    return cdm, zgap


@pytest.mark.parametrize("use_excluded", [False, True])
@pytest.mark.parametrize("grad_is_rgb", [False, True])
@pytest.mark.parametrize("mode", ["file", "otf"])
def test_target_planes_small(mode, grad_is_rgb, use_excluded):
    rng = np.random.default_rng(97 + 2 * grad_is_rgb + use_excluded)
    h, w = 40, 136
    cdm, zgap = _small_frames(rng, h, w)
    if grad_is_rgb:
        grad = rng.integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    else:
        grad = rng.integers(0, 65536, size=(2, h, w)).astype(np.uint16)
        grad[0, 0, :4] = (0, 32767, 32768, 65535)
    excluded = rng.random((h, w)) < 0.1 if use_excluded else None
    zgap_in = zgap if mode == "file" else None
    got = sd.build_target_planes(cdm, grad, zgap_in, excluded, thr=20,
                                 zgap_mode=mode, grad_is_rgb=grad_is_rgb,
                                 device=CPU)
    want = ref_sd.build_target_planes_device(
        cdm, grad, zgap_in,
        jnp.asarray(excluded) if excluded is not None else None,
        thr=20, zgap_mode=mode, grad_is_rgb=grad_is_rgb)
    _planes_equal(got, want)


@pytest.mark.parametrize("thr", [0, 254, 255, 300])
def test_target_planes_threshold_edges(thr):
    """A threshold at or past the u8 range compares as the reference's
    int32 planes do (a uint8 tensor against 300 would wrap)."""
    rng = np.random.default_rng(thr)
    cdm, zgap = _small_frames(rng, 24, 40)
    grad = rng.integers(0, 65536, size=(2, 24, 40)).astype(np.uint16)
    for mode in ("file", "otf"):
        zgap_in = zgap if mode == "file" else None
        got = sd.build_target_planes(cdm, grad, zgap_in, None, thr=thr,
                                     zgap_mode=mode, grad_is_rgb=False,
                                     device=CPU)
        want = ref_sd.build_target_planes_device(
            cdm, grad, zgap_in, None, thr=thr, zgap_mode=mode,
            grad_is_rgb=False)
        _planes_equal(got, want)


@pytest.mark.parametrize("mode", ["file", "otf"])
def test_target_planes_fixture(fixtures_dir, mode):
    """The BJD fixture at the full JRC2018U frame, label regions on."""
    cdm = load_image(fixtures_dir / "lms" / f"{LM_BJD}.tif").pixels[None]
    grad = load_image(fixtures_dir / "grad" / f"{LM_BJD}.png").pixels[None]
    zgap = load_image(fixtures_dir / "zgap" / f"{LM_BJD}.tif").pixels[None]
    assert cdm.shape == (1, 566, 1210, 3) and grad.dtype == np.uint16
    excluded = label_regions_mask(566, 1210)
    zgap_in = zgap if mode == "file" else None
    got = sd.build_target_planes(cdm, grad, zgap_in, excluded, thr=20,
                                 zgap_mode=mode, grad_is_rgb=False,
                                 device=CPU)
    want = ref_sd.build_target_planes_device(
        cdm, grad, zgap_in, jnp.asarray(excluded), thr=20, zgap_mode=mode,
        grad_is_rgb=False)
    _planes_equal(got, want)


@pytest.fixture(scope="module")
def em_fl(fixtures_dir):
    q = load_image(fixtures_dir / "ems" / "12191_JRC2018U_FL.tif")
    return q, label_regions_mask(q.height, q.width)


@pytest.mark.parametrize("border", [0, 4])
def test_query_planes(em_fl, border):
    q, excluded = em_fl
    got = sd.build_query_planes(q.pixels, excluded, border, device=CPU)
    want = ref_sd.build_query_planes_device(q.pixels, excluded, border,
                                            pull_host=True)
    np.testing.assert_array_equal(got.q_nonzero.numpy(), want.q_nonzero)
    np.testing.assert_array_equal(got.q_slice.numpy().astype(np.int32),
                                  want.q_slice)
    np.testing.assert_array_equal(got.q_mask.numpy().astype(np.int32),
                                  want.q_mask)
    np.testing.assert_array_equal(got.high_expr.numpy().astype(np.int32),
                                  want.high_expr)
    np.testing.assert_array_equal(got.row_any, want.row_any)
    # the reference's mask statistics (overExpressesMaskExpression); the
    # border frame crops q_mask only
    assert int(got.high_expr.sum()) == 70640
    if border == 0:
        assert int(got.q_mask.sum()) == 17340
    # the port's band (8-row rounding, no 64-row buckets) holds every
    # active row and lies inside the reference's
    r0, r1 = got.active_row_range()
    rows = np.nonzero(got.row_any)[0]
    w0, w1 = want.active_row_range()
    assert r0 <= rows[0] and rows[-1] < r1 and w0 <= r0 and r1 <= w1
    assert r0 % 8 == 0 and (r1 % 8 == 0 or r1 == got.height)


def _random_query_target(rng, t, h, w):
    q_nonzero = rng.random((h, w)) < 0.5
    q_slice = np.where(q_nonzero, rng.integers(0, 257, (h, w)), 0)
    q_slice[rng.random((h, w)) < 0.1] = 0
    q_mask = (q_nonzero & (rng.random((h, w)) < 0.7)).astype(np.int32)
    high_expr = (rng.random((h, w)) < 0.3).astype(np.int32)
    grad = rng.integers(0, 65536, size=(t, h, w)).astype(np.uint16)
    grad[rng.random((t, h, w)) < 0.3] = rng.integers(0, 5)
    z_nonzero = rng.random((t, h, w)) < 0.5
    z_slice = np.where(z_nonzero, rng.integers(0, 257, (t, h, w)),
                       0).astype(np.uint16)
    t_above = rng.random((t, h, w)) < 0.4
    return ((q_nonzero, q_slice.astype(np.int32), q_mask, high_expr),
            (grad, z_nonzero, z_slice, t_above))


def _torch_planes(query, target):
    q = [torch.from_numpy(np.ascontiguousarray(a)) for a in query]
    grad, znz, zsl, tab = target
    t = [torch.from_numpy(grad.view(np.int16)), torch.from_numpy(znz),
         torch.from_numpy(zsl.astype(np.int16)), torch.from_numpy(tab)]
    return q, t


@pytest.mark.parametrize("mirror", [True, False])
def test_shape_score_rows_and_finish(mirror):
    rng = np.random.default_rng(31 + mirror)
    query, target = _random_query_target(rng, 3, 48, 136)
    q, t = _torch_planes(query, target)
    got = sk.shape_score_rows(*q, *t, mirror=mirror)
    want = ref_sk.shape_score_kernel(*query, *target, mirror=mirror)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    for g, w_ in zip(sk.finish_shape_scores(*got, mirror=mirror),
                     ref_sk.finish_shape_scores(*want, mirror=mirror)):
        np.testing.assert_array_equal(g, np.asarray(w_))
    # stacked over per-target planes, cropped to a row band
    r0, r1 = 8, 40
    got = sk.shape_score_stacked(*q, *[[x[i] for i in range(3)] for x in
                                       (t[3], t[0], t[1], t[2])],
                                 r0=r0, r1=r1, mirror=mirror)
    want = ref_sk.shape_score_stacked(
        *[jnp.asarray(a) for a in query],
        *[[jnp.asarray(x[i]) for i in range(3)] for x in
          (target[3], target[0], target[1], target[2])],
        r0=r0, r1=r1, mirror=mirror)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_finish_tie_keeps_direct():
    """A target symmetric under the x-flip scores the same in both
    orientations: score_m == score_id keeps the direct one."""
    rng = np.random.default_rng(5)
    query, (grad, znz, zsl, tab) = _random_query_target(rng, 2, 32, 64)
    grad = np.concatenate([grad[:, :, :32], grad[:, :, :32][:, :, ::-1]], 2)
    tab = np.concatenate([tab[:, :, :32], tab[:, :, :32][:, :, ::-1]], 2)
    target = (np.ascontiguousarray(grad), znz, zsl, np.ascontiguousarray(tab))
    q, t = _torch_planes(query, target)
    got = sk.shape_score_rows(*q, *t, mirror=True)
    gaps, high, score, use_m = sk.finish_shape_scores(*got, mirror=True)
    want = ref_sk.finish_shape_scores(
        *ref_sk.shape_score_kernel(*query, *target, mirror=True),
        mirror=True)
    for g, w_ in zip((gaps, high, score, use_m), want):
        np.testing.assert_array_equal(g, np.asarray(w_))
    np.testing.assert_array_equal(got[0].sum(1), got[2].sum(1))
    assert (score > 0).all() and not use_m.any()
