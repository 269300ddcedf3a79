"""The traffic generator: the same seed gives the same bytes, another
seed other bytes, and every seed the same sizes."""

import hashlib
import os

import numpy as np

from cdsbench.traffic import generate as gen

SPEC = {"kind": "regional", "masks": 4, "targets": 5, "mask_band": 224,
        "target_band": 160, "variants": True}
BIG = 2 ** 31 + 12345   # seeds run past 32 signed bits


def _digest(manifest):
    h = hashlib.sha256()
    d = manifest["dir"]
    for sub, names in (("ems", manifest["masks"]),
                       ("lms", manifest["targets"]),
                       ("grad", manifest["targets"]),
                       ("zgap", manifest["targets"])):
        for n in names:
            with open(os.path.join(d, sub, n), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_library_bytes_follow_the_seed(tmp_path):
    a = gen.write_library_child(SPEC, BIG, str(tmp_path / "a"))
    b = gen.write_library(SPEC, BIG, str(tmp_path / "b"), threads=2)
    c = gen.write_library(SPEC, BIG + 1, str(tmp_path / "c"), threads=2)
    assert a["masks"] == c["masks"] and a["targets"] == c["targets"]
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(c)


def test_adversarial_frames_follow_the_seed():
    spec = {"kind": "adversarial", "masks": 4, "targets": 6,
            "mask_band": 0, "target_band": 160}
    m1, m2, m3 = (gen.mask_frames(spec, s) for s in (BIG, BIG, 7))
    t1, t2, t3 = (gen.target_frames(spec, s) for s in (BIG, BIG, 7))
    assert all(np.array_equal(x, y) for x, y in zip(m1, m2))
    assert np.array_equal(t1, t2)
    assert not np.array_equal(t1, t3)
    assert not all(np.array_equal(x, y) for x, y in zip(m1, m3))
    # the same base frame, the same band height, whatever the seed
    for t in (t1, t3):
        rows = t.reshape(len(t), t.shape[1], -1).any(axis=2).sum(axis=1)
        assert (rows <= 160).all()


def test_aligned_groups_share_their_roll():
    """Mask group k and target group k lie at the same roll (the aligned
    pairs that match), whatever the seed."""
    for seed in (1, BIG):
        rm = gen.rolls(seed, 9, 3, 566, 1210)
        rt = gen.rolls(seed, 12, 4, 566, 1210)
        assert np.array_equal(rm[::3], rt[::4][:3])


def test_every_seed_has_the_same_crops():
    """The seed moves the crops, never what they keep: each item's
    signal is that of its base's densest band."""
    spec = {"masks": 6, "mask_band": 224, "targets": 8, "target_band": 160}
    counts = []
    for seed in (3, BIG):
        counts.append(([int((m > 20).any(2).sum())
                        for m in gen.mask_frames(spec, seed)],
                       [int((t > 20).any(2).sum())
                        for t in gen.target_frames(spec, seed)]))
    assert counts[0] == counts[1]


def test_dilation_is_the_circular_footprint():
    """The generator's radius-10 dilation equals a dense max over the
    circular footprint."""
    rng = np.random.default_rng(3)
    plane = (rng.random((40, 50)) < 0.02).astype(np.uint8) * \
        rng.integers(1, 255, (40, 50), dtype=np.uint8)
    got = gen.dilate_plane(plane, 10.0)
    radii = gen.line_radii(10.0)
    k = (len(radii) - 1) // 2
    pad = np.pad(plane, k)
    want = np.zeros_like(plane)
    for dy in range(-k, k + 1):
        for dx in range(-radii[dy + k], radii[dy + k] + 1):
            want = np.maximum(want, pad[k + dy:k + dy + 40,
                                        k + dx:k + dx + 50])
    assert np.array_equal(got, want)
