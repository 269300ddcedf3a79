"""The plain reference equals the port's CPU path at small sizes (this
test imports both; the reference imports nothing of the port)."""

import os

import numpy as np
import pytest

from cdsbench.reference import pixel as ref
from cdsbench.reference import shape as sref
from cdsbench.traffic import generate as gen

FIX = os.path.join(os.path.dirname(gen.__file__), "fixtures")
REPO_FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    gen.__file__))), "tests", "fixtures", "cdsearch")
KW = dict(mask_threshold=20, data_threshold=20, zt9=10_000_000,
          xy_shift=2, mirror=True)


def _lms():
    names = sorted(os.listdir(os.path.join(FIX, "lms")))
    return names, np.stack([gen.load_rgb(os.path.join(FIX, "lms", n))
                            for n in names])


def test_pixel_goldens():
    """439 / 426 (mirrored) / 414 of the reference's golden test."""
    names, lms = _lms()
    q = gen.load_rgb(os.path.join(FIX, "ems", "12191_JRC2018U.tif"))
    s, m, qs = ref.block_scores([q], lms, **KW)
    got = {n.split("_")[0]: (int(a), bool(b)) for n, a, b in
           zip(names, s[0], m[0])}
    assert got["VT033614"] == (439, False)
    assert got["VT016795"] == (426, True)
    assert got["BJD"] == (414, False)
    assert qs[0] > 0


def test_pixel_equals_the_port():
    """Every pair of a small seeded library: the reference's scores and
    mirrored flags equal the port's two-phase sweep on the CPU (the
    prescreen off, so that every pair is scored)."""
    from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
    from colormipsearch_torch.imageproc.regions import label_regions_mask
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    spec = {"masks": 3, "targets": 8, "mask_band": 224, "target_band": 300}
    masks = gen.mask_frames(spec, 11)
    targets = gen.target_frames(spec, 11)
    excluded = label_regions_mask(*targets.shape[1:3])
    engines = [ActiveTilePixelEngine(m, 20, True, 20, 1.0, 2, excluded)
               for m in masks]
    scores, mirrored = TwoPhaseSweep(engines, ["cpu"]).sweep(targets)
    want, want_m, qs = ref.block_scores(masks, targets, **KW)
    assert np.array_equal(scores, want)
    assert np.array_equal(mirrored[want > 0], want_m[want > 0])
    assert list(qs) == [e.tiles.query_size for e in engines]


def test_float_controls_differ_only_below_float32():
    """float64 replays the exact predicate on these pairs; bfloat16 does
    not (the cells' control)."""
    _, lms = _lms()
    masks = gen.base_frames("ems")
    exact = ref.block_scores(masks, lms, **KW)[0]
    f64 = ref.block_scores(masks, lms, **KW, precision="float64")[0]
    bf16 = ref.block_scores(masks, lms, **KW, precision="bfloat16")[0]
    assert np.array_equal(exact, f64)
    assert not np.array_equal(exact, bf16)


@pytest.mark.parametrize("target", ["BJD", "VT016795", "VT033614"])
def test_shape_planes_equal_the_port(target):
    """The reference's query and target planes equal the port's host
    planes on the fixtures, and its scores equal the port's oracle."""
    from colormipsearch_torch.cds.shape_oracle import (
        build_query_shape_planes, build_target_shape_planes)
    from colormipsearch_torch.imageproc.io import load_image
    from colormipsearch_torch.imageproc.regions import label_regions_mask
    q_img = load_image(os.path.join(REPO_FIX, "ems", "12191_JRC2018U.tif"))
    excluded = label_regions_mask(q_img.height, q_img.width)
    qp = build_query_shape_planes(q_img, excluded)
    q = sref.query_planes(q_img.pixels)
    assert np.array_equal(q["nonzero"].numpy(), qp.q_nonzero)
    assert np.array_equal(q["slice"].numpy(), qp.q_slice)
    assert np.array_equal(q["mask"].numpy(), qp.q_mask)
    assert np.array_equal(q["high"].numpy(), qp.high_expr.astype(bool))
    lm = [n for n in os.listdir(os.path.join(REPO_FIX, "lms"))
          if n.startswith(target)][0]
    stem = lm.rsplit(".", 1)[0]
    grad_name = [n for n in os.listdir(os.path.join(REPO_FIX, "grad"))
                 if n.startswith(stem.split("-CH")[0][:20])][0]
    t_img = load_image(os.path.join(REPO_FIX, "lms", lm))
    g_img = load_image(os.path.join(REPO_FIX, "grad", grad_name))
    zgap = gen.zgap_frame(np.where(excluded[:, :, None], 0, t_img.pixels)
                          .astype(np.uint8))
    from colormipsearch_torch.imageproc.io import Image, ImageKind
    tp = build_target_shape_planes(t_img, g_img, Image(ImageKind.RGB, zgap),
                                   20, excluded)
    t = sref.target_planes(t_img.pixels, g_img.pixels, zgap, 20)
    assert np.array_equal(t["above"].numpy(), tp.t_above)
    assert np.array_equal(t["grad"].numpy(), tp.grad.astype(np.int64))
    assert np.array_equal(t["z_nonzero"].numpy(), tp.z_nonzero)
    assert np.array_equal(t["z_slice"].numpy(), tp.z_slice.astype(np.int64))


def test_shape_goldens():
    """21365 / 731 (VT033614, on-the-fly z-gap) and 40696 / 17253
    mirrored (VT016795): the reference's golden shape scores."""
    from colormipsearch_torch.imageproc.io import load_image
    q_img = load_image(os.path.join(REPO_FIX, "ems", "12191_JRC2018U.tif"))
    q = sref.query_planes(q_img.pixels)
    excl = ref.label_regions(q_img.height, q_img.width)
    got = {}
    for key in ("VT033614", "VT016795"):
        lm = [n for n in os.listdir(os.path.join(REPO_FIX, "lms"))
              if n.startswith(key)][0]
        grad = [n for n in os.listdir(os.path.join(REPO_FIX, "grad"))
                if n.startswith(key)][0]
        t_img = load_image(os.path.join(REPO_FIX, "lms", lm))
        g_img = load_image(os.path.join(REPO_FIX, "grad", grad))
        zgap = gen.zgap_frame(np.where(excl[:, :, None], 0, t_img.pixels)
                              .astype(np.uint8))
        t = sref.target_planes(t_img.pixels, g_img.pixels, zgap, 20)
        got[key] = sref.shape_score(q, t, True)
    assert got["VT033614"][:2] == (21365, 731)
    assert got["VT016795"] == (40696, 17253, True)


def test_normalized_scores():
    """(pixels / max) / clamp(2.5 shape / max shape, 0.002, 1) x 100, as
    a float32; the raw pixels where a score is missing."""
    got = sref.normalized_scores([439, 426, 414], [21365, 40696, 33884],
                                 [731, 17253, 523])
    assert got[0] == float(np.float32(100.0))
    assert round(got[1], 2) == 97.04 and round(got[2], 2) == 94.31
    assert sref.normalized_scores([5], [-1], [-1]) == [5.0]
