"""The port's packed-word predicate (colormipsearch_torch.cds.pixel_active,
plain torch ops) against the JAX package's three bit-identical forms,
the word path against the ratio path, and the CLI under CMS_RATIO_PRED=0.
Every comparison is exact: all scores are integer counts."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from colormipsearch_tpu.cds import pixel_pallas as ref_pp  # noqa: E402

from colormipsearch_torch.cds import multimask as mm  # noqa: E402
from colormipsearch_torch.cds import pixel_active as pa  # noqa: E402
from colormipsearch_torch.cmd.main import main  # noqa: E402
from torch_launch import engine_results  # noqa: E402

ZT9_MAX = 1_008_843_137  # the largest zt9 whose splits c9_split accepts


def _word(b, a, s, sel, cl, cu):
    return (b | (a << 8) | (s << 16) | (sel << 19) | (cl << 20)
            | (cu << 21)).astype(np.int32)


def _word_pairs(zt9, n=6000, seed=5):
    """(query words, target words): every sector pair 0-6, the a/b edge
    values, every flag, and pairs steered to the compare constant that
    their sector pair tests, so that the staged chain's bands are hit."""
    rng = np.random.default_rng(seed)
    edge_b = np.array([1, 2, 127, 128, 254, 255])

    def fields():
        b = np.where(rng.random(n) < 0.3, rng.choice(edge_b, n),
                     rng.integers(1, 256, n))
        a = np.where(rng.random(n) < 0.2, rng.choice([0, 1, 255], n),
                     rng.integers(0, b + 1))
        flags = rng.integers(0, 2, (3, n))
        flags[0] = np.where(rng.random(n) < 0.9, 1, flags[0])  # mostly sel
        return b, a, flags

    b1, a1, f1 = fields()
    b2, a2, f2 = fields()
    s1 = rng.integers(0, 7, n)
    kind = rng.integers(0, 4, n)  # same, up, down, any
    s2 = np.where(kind == 0, s1, np.where(kind == 1, s1 + 1,
                                          np.where(kind == 2, s1 - 1,
                                                   rng.integers(0, 7, n))))
    s2 = np.clip(s2, 0, 6)
    # steer half of the pairs onto the tested ratio: a2 solves
    # |a2*b1 - a1*b2| = zt9*p (same) or a1*b2 + a2*b1 = c9*p (adjacent)
    trip = pa.word_triples(zt9)
    lo = np.where(s2 == s1 + 1, s1, s2)
    c9 = np.array([(q * 10 ** 6 + rh * 64 + rl) for q, rh, rl in trip])
    c = np.where(s1 == s2, c9[0], c9[np.where((lo >= 2) & (lo <= 5), lo,
                                              1)]) / 1e9
    p = b1 * b2
    target = np.where(s1 == s2, a1 * b2 + c * p, c * p - a1 * b2) / b1
    steer = rng.random(n) < 0.5
    a2 = np.where(steer, np.clip(np.round(target) + rng.integers(-1, 2, n),
                                 0, 255).astype(np.int64), a2)
    return (_word(b1, a1, s1, f1[0], f1[1], f1[2]),
            _word(b2, a2, s2, f2[0], f2[1], f2[2]))


@pytest.mark.parametrize("zt9", [0, 10_000_000, 54_000_000, 100_000_000,
                                 800_000_000, ZT9_MAX])
def test_predicate_matches_reference_forms(zt9):
    """The port's predicate equals the reference's general form, and its
    packed-constant and f32-product forms where they apply (zt9 <= 54e6),
    from zt9 = 0 to the largest zt9 the splits accept; from 709,725,490
    up, the reference's geq split of pair 1 is c9 = 0."""
    qw, tw = _word_pairs(zt9)
    got = pa._match_predicate(pa._unpack(torch.from_numpy(qw)),
                              pa._unpack(torch.from_numpy(tw)),
                              zt9).numpy()
    q, t = ref_pp._unpack(jnp.asarray(qw)), ref_pp._unpack(jnp.asarray(tw))
    forms = [ref_pp._match_unpacked]
    if zt9 <= ref_pp._PACK_ZT9_MAX:
        forms += [ref_pp._match_unpacked_fast, ref_pp._match_unpacked_fast2]
    for form in forms:
        np.testing.assert_array_equal(got, np.asarray(form(q, t, zt9)),
                                      err_msg=form.__name__)
    # both outcomes occur for the same-sector and for the adjacent tests
    s1, s2 = (qw >> 16) & 7, (tw >> 16) & 7
    for case in (s1 == s2, np.abs(s1 - s2) == 1):
        assert got[case].any() and not got[case].all()


def test_out_of_range_zt9_raises_like_the_reference():
    qw, tw = _word_pairs(0, n=16)
    with pytest.raises(ValueError, match="too large"):
        ref_pp._match_unpacked(ref_pp._unpack(jnp.asarray(qw)),
                               ref_pp._unpack(jnp.asarray(tw)), ZT9_MAX + 1)
    with pytest.raises(ValueError, match="too large"):
        pa.word_triples(ZT9_MAX + 1)
    rng = np.random.default_rng(1)
    q = rng.integers(0, 256, size=(16, 128, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match="too large"):
        pa.ActiveTilePixelEngine(q, 20, True, 20, 100.89, 2,
                                 predicate="words")


@pytest.mark.parametrize("zt9", [0, 10_000_000, 800_000_000, ZT9_MAX])
def test_word_triples_parity(zt9):
    """Index 0 is the same-sector constant; odd lo tests leq at 2k + zt9,
    even lo geq at max(2k - zt9, 0)."""
    from colormipsearch_tpu.cds.exact_ratio import c9_split
    from colormipsearch_tpu.cds.pixel_kernel import PAIR_K9
    trip = pa.word_triples(zt9)
    assert trip[0] == c9_split(zt9)
    for lo, k in enumerate(PAIR_K9, start=1):
        want = (c9_split(max(2 * k - zt9, 0)) if lo % 2 == 0
                else c9_split(2 * k + zt9))
        assert trip[lo] == want


def _library(seed=17, n_masks=4, n_targets=12, h=48, w=160):
    rng = np.random.default_rng(seed)
    masks = []
    for _ in range(n_masks):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.8] = 0
        masks.append(q)
    targets = rng.integers(0, 256, size=(n_targets, h, w, 3)).astype(
        np.uint8)
    targets[rng.random((n_targets, h, w)) < 0.7] = 0
    surv = (rng.random((n_masks, n_targets)) < 0.5).astype(np.int32)
    surv[0] = 1
    return masks, targets, surv


@pytest.mark.parametrize("pcf,xy_shift,mirror", [
    (1.0, 2, True), (1.0, 2, False), (1.0, 0, True), (10.0, 2, True)])
def test_words_equal_ratio(pcf, xy_shift, mirror):
    """The two predicates give the same counts on the same frames, with
    and without the live-tile cut; word engines made from ratio engines'
    tiles equal word engines made from the images."""
    masks, targets, surv = _library()
    ratio = [pa.ActiveTilePixelEngine(q, 20, mirror, 20, pcf, xy_shift)
             for q in masks]
    words = [e.with_predicate("words") for e in ratio]
    direct = pa.ActiveTilePixelEngine(masks[1], 20, mirror, 20, pcf,
                                      xy_shift, predicate="words")
    np.testing.assert_array_equal(direct.tiles.q_words,
                                  words[1].tiles.q_words)
    assert words[1].tiles.q_cmp is None and words[1].triples == \
        pa.word_triples(ratio[1].zt9)
    back = words[1].with_predicate("ratio")
    np.testing.assert_array_equal(back.tiles.q_f32, ratio[1].tiles.q_f32)
    cpu = torch.device("cpu")
    w = ratio[0].pack_raw_words(targets, cpu)
    packed = {p: pa.pad_for_predicate(w, p) for p in ("ratio", "words")}
    cut = (mm.signal_extents(w), mm.tile_live_dev(w))
    for restrict in (None, cut):
        kw = {} if restrict is None else dict(signal_ranges=restrict[0],
                                              tile_live=restrict[1])
        got = engine_results(mm.MultiMaskScorer(words), packed["words"],
                             surv, **kw)
        want = engine_results(mm.MultiMaskScorer(ratio), packed["ratio"],
                              surv, **kw)
        for (gs, _, gm), (ws, _, wm) in zip(got, want):
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(gm, wm)
        assert any(s.any() for s, _, _ in got)


def test_predicates_never_share_a_launch():
    masks, _, _ = _library(n_masks=2)
    ratio = pa.ActiveTilePixelEngine(masks[0], 20, True, 20, 1.0, 2)
    words = ratio.with_predicate("words")
    assert mm.launch_params(ratio) != mm.launch_params(words)
    with pytest.raises(ValueError, match="one predicate"):
        mm.MultiMaskScorer([ratio, words])
    with pytest.raises(ValueError, match="predicate"):
        pa.ActiveTilePixelEngine(masks[0], 20, True, 20, 1.0, 2,
                                 predicate="f32")


# ---- the CLI under CMS_RATIO_PRED=0 ------------------------------------------

LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]


def _write_workspace(ws, fixtures):
    em = {"class": "org.janelia.colormipsearch.model.EMNeuronEntity",
          "id": "1001", "mipId": "em-12191",
          "alignmentSpace": "JRC2018_Unisex_20x_HR",
          "libraryName": "flyem_test", "publishedName": "12191",
          "computeFiles": {"InputColorDepthImage": str(
              fixtures / "ems" / "12191_JRC2018U.tif")}}
    lms = [{"class": "org.janelia.colormipsearch.model.LMNeuronEntity",
            "id": str(2001 + i), "mipId": f"lm-{i}",
            "alignmentSpace": "JRC2018_Unisex_20x_HR",
            "libraryName": "flylight_test",
            "publishedName": name.split("_")[0],
            "computeFiles": {"InputColorDepthImage": str(
                fixtures / "lms" / f"{name}.tif")},
            "slideCode": f"sc-{i}", "anatomicalArea": "Brain",
            "objective": "40x", "gender": "f"}
           for i, name in enumerate(LM_NAMES)]
    for fname, ents in (("masks.json", [em]), ("targets.json", lms)):
        with open(os.path.join(ws, fname), "w") as f:
            json.dump(ents, f)


def test_cli_word_predicate_goldens(tmp_path, fixtures_dir, monkeypatch,
                                    caplog):
    """CMS_RATIO_PRED=0 runs every engine on the word predicate: goldens
    439 / 414 / 426 with lm-2 mirrored, and the ratio version never
    runs."""
    _write_workspace(str(tmp_path), fixtures_dir)
    monkeypatch.setenv("CMS_RATIO_PRED", "0")
    calls = []
    words_plain = mm.multimask_words_counts_plain

    def spy(*a, **k):
        calls.append(1)
        return words_plain(*a, **k)

    def no_ratio(*a, **k):
        raise AssertionError("ratio predicate ran under CMS_RATIO_PRED=0")

    monkeypatch.setattr(mm, "multimask_words_counts_plain", spy)
    monkeypatch.setattr(mm, "multimask_counts_plain", no_ratio)
    out = str(tmp_path / "out")
    caplog.set_level("INFO")
    assert main(["colorDepthSearch", "-m", str(tmp_path / "masks.json"),
                 "-i", str(tmp_path / "targets.json"), "--maskThreshold",
                 "20", "--dataThreshold", "20", "--pixColorFluctuation", "1",
                 "--xyShift", "2", "--mirrorMask", "--device", "cpu",
                 "-od", out]) == 0
    assert calls
    assert "words predicate" in caplog.text
    with open(os.path.join(out, "masks", "em-12191.json")) as f:
        res = {r["image"]["mipId"]: r for r in json.load(f)["results"]}
    assert [(res[k]["matchingPixels"], res[k]["mirrored"])
            for k in ("lm-0", "lm-1", "lm-2")] == \
        [(439, False), (414, False), (426, True)]
