"""The benchmark's one traffic generator: seeded MIP libraries.

A workload file's `traffic` block names a library `kind` and its sizes;
this module turns it and `--seed` into pixels. The same seed gives the
same bytes; another seed gives other rolls of the same crops. Every seed
has the same work: item i takes base i mod n, cut to the band of
`*_band` rows that holds most of that base's signal, and is then rolled
by the roll of its group i div n, one table of rolls serving both sides,
so that mask group k lies where target group k lies (the aligned pairs
that match) whatever the seed. The copied generators stepped the rolls by
fixed strides and cut each band after the roll, at a stride of its own;
here the seed draws the rolls, and the band is cut first, so that no
seed changes how much of a neuron an item keeps.

Kinds (frozen copies, rewritten on NumPy/SciPy/PIL and seeded):
- "regional": `colormipsearch_torch/scripts/dress_rehearsal.py:88`
  `generate_library` (its `_roll` :71, `_band` :78). Masks are EM
  fixtures kept in one `mask_band`-row band, targets LM fixtures kept in
  one `target_band`-row band; with `variants`, each target has a true
  distance-transform gradient PNG and a z-gap PNG (mask(20), then the
  radius-10 circular dilation), rolled and banded with it. Written as
  PNGs under the mipstores naming conventions, so that the port's ingest
  indexes them as production stores.
- "adversarial": `chip_smoke.py:583` `adversarial_library` (its
  `roll_frame` :565, `band_frame` :572): whole rolled EM frames as
  masks, LM frames banded to one `target_band`-row band as targets, held
  in memory.

The base frames are copies of the repository's golden fixtures, kept in
`cdsbench/traffic/fixtures/` so that the yardstick does not move with the
test suite. Run as `python -m cdsbench.traffic.generate SPEC.json`, it
writes a regional library in a child process (see `write_library`).
"""

from __future__ import annotations

import json
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
AS = "JRC2018_Unisex_20x_HR"
DATA_THRESHOLD = 20   # the z-gap recipe's mask(20) and the signal of grad
ZGAP_RADIUS = 10.0

# one RNG stream per purpose, so that adding a purpose moves no other
_STREAM = {"masks": 1, "targets": 2, "matches": 3, "sample": 4,
           "rolls": 5}


def rng(seed: int, purpose: str) -> np.random.Generator:
    """The seeded generator of one purpose."""
    return np.random.default_rng([int(seed), _STREAM[purpose]])


def load_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert("RGB"), dtype=np.uint8)


def base_frames(side: str) -> List[np.ndarray]:
    """The base frames of one side ("ems" or "lms"), sorted by name."""
    d = os.path.join(FIXTURES, side)
    return [load_rgb(os.path.join(d, n)) for n in sorted(os.listdir(d))]


def roll(px: np.ndarray, dy: int, dx: int) -> np.ndarray:
    return np.roll(px, (dy, dx), axis=(0, 1))


def band(px: np.ndarray, b0: int, bh: int) -> np.ndarray:
    """The frame kept only in rows [b0, b0 + bh)."""
    out = np.zeros_like(px)
    out[b0:b0 + bh] = px[b0:b0 + bh]
    return out


def rolls(seed: int, n: int, n_base: int, h: int, w: int) -> np.ndarray:
    """int64 [n, 2]: each item's roll (dy, dx), that of its group
    i div n_base in the seed's table of rolls."""
    groups = np.arange(n) // n_base
    table = rng(seed, "rolls").integers(0, [h, w],
                                        (int(groups[-1]) + 1 if n else 0, 2))
    return table[groups]


def densest_band(px: np.ndarray, bh: int) -> int:
    """The first row of the bh-row band that holds the most signal."""
    rows = (px > DATA_THRESHOLD).any(axis=2).sum(axis=1)
    sums = np.convolve(rows, np.ones(bh, np.int64), mode="valid")
    return int(np.argmax(sums))


def crops(frames: List[np.ndarray], bh: int) -> List[np.ndarray]:
    """Each base frame kept in its densest bh-row band (whole for 0)."""
    h = frames[0].shape[0]
    if not 0 < bh < h:
        return frames
    return [band(px, densest_band(px, bh), bh) for px in frames]


# ---- the circular dilation (frozen copy) ----------------------------------
# colormipsearch_torch/imageproc/filters.py:22 make_line_radii and :44
# max_filter_plane (ImageJ RankFilters' kernel, ImageTransformation.java:
# 549-572), outside-image pixels 0.

def line_radii(radius_arg: float) -> np.ndarray:
    if 1.5 <= radius_arg < 1.75:
        radius = 1.75
    elif 2.5 <= radius_arg < 2.85:
        radius = 2.85
    else:
        radius = radius_arg
    r2 = int(radius * radius) + 1
    k = int(math.sqrt(r2 + 1e-10))
    dxs = np.zeros(2 * k + 1, dtype=np.int64)
    dxs[k] = k
    for y in range(1, k + 1):
        dxs[k - y] = dxs[k + y] = int(math.sqrt(r2 - y * y + 1e-10))
    return dxs


def dilate_plane(plane: np.ndarray, radius: float) -> np.ndarray:
    from scipy import ndimage
    dxs = line_radii(radius)
    k = (len(dxs) - 1) // 2
    h = plane.shape[0]
    out = np.zeros_like(plane)
    for extent in np.unique(dxs):
        hmax = ndimage.maximum_filter1d(plane, size=2 * int(extent) + 1,
                                        axis=1, mode="constant", cval=0)
        for off in np.nonzero(dxs == extent)[0] - k:
            if abs(off) >= h:
                continue
            if off >= 0:
                np.maximum(out[:h - off], hmax[off:], out=out[:h - off])
            else:
                np.maximum(out[-off:], hmax[:h + off], out=out[-off:])
    return out


def zgap_frame(px: np.ndarray) -> np.ndarray:
    """The production z-gap recipe on a whole frame: mask(20), then the
    radius-10 dilation per channel."""
    keep = (px > DATA_THRESHOLD).any(axis=2)
    masked = np.where(keep[:, :, None], px, 0).astype(np.uint8)
    return np.stack([dilate_plane(masked[:, :, c], ZGAP_RADIUS)
                     for c in range(3)], axis=2)


def grad_frame(px: np.ndarray) -> np.ndarray:
    """A true gradient file: the distance to the nearest signal pixel,
    capped at 255 (u8 gray)."""
    from scipy import ndimage
    signal = (px > DATA_THRESHOLD).any(axis=2)
    return np.minimum(ndimage.distance_transform_edt(~signal),
                      255).astype(np.uint8)


# ---- libraries --------------------------------------------------------------

def mask_name(i: int) -> str:
    """An EM skeleton's CDM name (cmd/mipstores.py conventions)."""
    return f"{90000000 + i}-{AS}-CDM.png"


def target_stem(i: int) -> str:
    """An LM slide's CDM stem, one line per target."""
    return (f"LINE{i:05d}-20{(i % 25):02d}0{1 + i % 9}{10 + i % 18}_"
            f"{60 + i % 40}_A{1 + i % 9}-f-40x-{AS}-CH1_01")


def mask_frames(spec: dict, seed: int) -> List[np.ndarray]:
    bases = crops(base_frames("ems"), int(spec.get("mask_band", 0)))
    h, w = bases[0].shape[:2]
    return [roll(bases[i % len(bases)], dy, dx) for i, (dy, dx) in
            enumerate(rolls(seed, int(spec["masks"]), len(bases), h, w))]


def target_frames(spec: dict, seed: int) -> np.ndarray:
    """uint8 [T, H, W, 3]: the adversarial kind's targets, in memory."""
    bases = crops(base_frames("lms"), int(spec["target_band"]))
    h, w = bases[0].shape[:2]
    rl = rolls(seed, int(spec["targets"]), len(bases), h, w)
    out = np.empty((len(rl), h, w, 3), np.uint8)
    for i, (dy, dx) in enumerate(rl):
        out[i] = roll(bases[i % len(bases)], dy, dx)
    return out


def write_library(spec: dict, seed: int, out_dir: str,
                  threads: int = 0) -> dict:
    """Write a regional library under out_dir (ems/, lms/, and with
    `variants` grad/ and zgap/) and return its manifest: the file names
    in index order."""
    from PIL import Image
    lms = base_frames("lms")
    h, w = lms[0].shape[:2]
    bh = int(spec["target_band"])
    b0 = [densest_band(px, bh) for px in lms]
    variants = bool(spec.get("variants"))
    sides = {"lms": [band(px, b, bh) for px, b in zip(lms, b0)]}
    if variants:
        sides["grad"] = [band(grad_frame(px), b, bh) for px, b in zip(lms, b0)]
        sides["zgap"] = [band(zgap_frame(px), b, bh) for px, b in zip(lms, b0)]
    for d in ["ems"] + list(sides):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    def png(path, arr):
        Image.fromarray(arr).save(path, compress_level=1)

    masks = mask_frames(spec, seed)
    rl = rolls(seed, int(spec["targets"]), len(lms), h, w)

    def one_mask(i):
        png(os.path.join(out_dir, "ems", mask_name(i)), masks[i])

    def one_target(i):
        dy, dx = rl[i]
        for d, bases in sides.items():
            png(os.path.join(out_dir, d, target_stem(i) + ".png"),
                roll(bases[i % len(lms)], dy, dx))

    with ThreadPoolExecutor(max_workers=threads or os.cpu_count() or 4) as ex:
        list(ex.map(one_mask, range(len(masks))))
        list(ex.map(one_target, range(len(rl))))
    return {"dir": out_dir, "height": h, "width": w,
            "masks": [mask_name(i) for i in range(len(masks))],
            "targets": [target_stem(i) + ".png" for i in range(len(rl))],
            "variants": variants}


def write_library_child(spec: dict, seed: int, out_dir: str) -> dict:
    """write_library in a child process, so that the caller's memory
    holds none of the library."""
    import subprocess
    os.makedirs(out_dir, exist_ok=True)
    job = os.path.join(out_dir, "spec.json")
    with open(job, "w") as f:
        json.dump({"spec": spec, "seed": int(seed), "out": out_dir}, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-m", "cdsbench.traffic.generate", job],
                   check=True, cwd=root, env=env)
    with open(os.path.join(out_dir, "manifest.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        job = json.load(f)
    manifest = write_library(job["spec"], job["seed"], job["out"])
    with open(os.path.join(job["out"], "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
