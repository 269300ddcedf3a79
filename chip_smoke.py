#!/usr/bin/env python3
"""Smoke test of colormipsearch_torch on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card (Hopper, sm_90a) and nvcc; it builds the package's kernels from
the sources in the checkout and drives the colorDepthSearch path on both
exact predicates, gradientScores, the production pipeline and the op
microbench:

1. card: nvidia-smi name and power limit; the six kernel libraries
   (multimask_ratio, multimask_words, op_chain, prescreen_bound,
   shape_score, shape_planes) built in
   parallel, with their build seconds, registers and shared memory; the
   native host word packer of the pack stage (g++), which must build and
   load;
2. each exact kernel against its plain PyTorch version, exactly, on a
   random library of full 566x1210 frames (16 masks x 64 targets): sparse
   and dense survivors, a mask with zero survivors, one survivor at the
   last target, a mask with more than 128 active tiles, mirror off,
   xyShift 0, with and without the live-tile cut, and launch rows whose
   survivor flag is 0; the word kernel also at pixColorFluctuation 10;
   the compact lists' edges (tiles of 0, 1 and 1024 selected pixels, rows
   of hundreds of tiles); and the ratio planes built on the card equal to
   those built on the CPU, bit for bit;
3. the CLI (`colormipsearch_torch colorDepthSearch --device cuda`) on the
   three golden fixtures: 439 / 414 / 426, the last one mirrored, once on
   the ratio kernel and once under CMS_RATIO_PRED=0 on the word kernel
   (which must launch, with no ratio launch in that run);
4. at size: TwoPhaseSweep over 1024 masks x 512 targets (two 256-target
   partitions) of the adversarial library built from the fixtures (rolled
   and banded frames, label-region exclusion, 1% keep threshold), on the
   ratio path, on the word path (word tables from the ratio engines'
   query tiles) and on the ratio path screened by the dense fp32 bound
   (`dense_capped_bounds`, the port's bound before its two kernels): 439
   among mask 0's scores, each path's exact kernel launched and the other
   not, the bound's two kernels once per partition (none on the dense
   path), the three paths' scores equal on all 524,288 pairs, each exact
   kernel equal to its plain version on partition 0's whole table, 32
   masks' one-launch scores equal to the sweep's; pairs/s of the paths in
   turns, survivor rate, stage seconds, peak memory, and each kernel on
   partition 0 over all masks with its work (evaluations that can count,
   staged bytes), its bound and its share of it, and its pixel loop's
   SASS instructions per evaluation by pipe. The timed round is the
   pipelined partition loop of the CLI (`TwoPhaseSweep.sweep_parts`);
5. the op microbench (`python -m colormipsearch_torch.scripts.op_microbench
   --device cuda`): its ten cases, each kernel == plain at 512 and at
   32,768 steps, Top/s at 32,768 steps, and a time ratio of 65,536 to
   32,768 steps within 1.8-2.2, and its bound: each case's main-loop SASS
   instructions at the card's peak rate for the busiest pipe they use;
6. gradientScores on its four kernels (G1 shape_rows, G2 dilate_rgb, G3
   query_planes, G4 target_planes): (a) on the golden fixtures each
   kernel against its plain version on the card (G2 at r = 10 of the
   masked target CDMs and at r = 60 and 20 of the three EM masks, G4 in
   both z-gap modes, G3 at borders 0 and 4, G1 with and without mirror
   and with flipped z planes), and the planes and the scorer's rows
   built on the card equal to the CPU's, bit for bit; (b) the CLI
   (`colormipsearch_torch gradientScores --device cuda`) on phase 3's
   output: 21365/731, 33884/523 (z-gap file) and 40696/17253 (mirrored),
   normalized scores 100.0 and 414/439, 426/439 x 100, with G1-G4 each
   launched (counted from 0 just before); (c) at size, the JAX package's
   two bench.py gradient configurations through `score_mask_partitions`
   (128 targets of 566x1210, 128 per batch): precomputed z-gap files (one
   cold pass, three warm masks) and z-gap on the fly (three cold reps,
   two warm masks). Each prints its cold seconds per target (decode and
   device plane build), warm matches/s, each warm mask's host time split
   (the query planes, the plane cache's lookups, G1's launch with its
   pointer table, the row sums' copy to the host, the rest), each kernel
   against its plain version at size with its device ms by
   torch.profiler, its ms per call with the wrapper's host work and its
   plain version's by CUDA events, beside its bound, the plane builds' ms, the
   kernels' launches (one G3 per mask: no query planes built on the
   host), peak device memory and its host-path plane builds (must be 0);
   mask 0's scores must equal a `--device cpu` run of the same batch.
   Phase 6's numbers are one JSON line before the kernels line;
7. the dense engine and the scale-out layer: (a) the dense engine
   (`cds/pixel_kernel.PixelMatchEngine`) on the card equal to its CPU run
   on the golden fixtures, 439 / 414 / 426; (b) the dense engine at the
   full frame, 8 masks x 256 targets of phase 4's library, equal on every
   pair to the two-phase path without a screen: its ms, peak memory and
   its bound, counted from the evaluations as `kernel_work` counts them
   for the word kernel over the same pairs; (c) `TwoPhaseSweep` over
   [dev, dev] (and every card, where there are more) on both predicates,
   equal to the one-card run on all 524,288 pairs of phase 4, pairs/s of
   each in turns, and each round's kernel launches counted from 0 (one
   per device slot and partition of the predicate's kernel, none of the
   other's); (d) two processes on the card in a gloo group:
   colorDepthSearch --jax-distributed with both engines (process 0 alone
   writes the goldens), the --process-count 2 grid of both commands (the
   goldens and 21365 / 33884 / 40696), and rank 0's gathered two-phase
   grid over 256 masks x 512 targets on both predicates equal to phase
   4's, each rank's own kernel launches checked the same way, pairs/s
   beside one process's pipelined loop; (e) gradientScores'
   `score_mask_partitions` over [dev, dev] at 128 x 566 x 1210 equal to
   the one-device run. Phase 7's numbers are one JSON line
   `{"scale_out": ...}` before the kernels line;
8. the production pipeline (colorDepthSearch -> gradientScores ->
   normalizeGradientScores -> exportData over one SQLite store, with the
   arguments of `colormipsearch_torch/scripts/run_full_precompute.sh`):
   (a) the four commands through the CLI's entry points on
   `--device cuda` on phase 3's workspace: stored pixel scores 439 / 414
   / 426 (lm-2 mirrored), gaps 21365 / 33884 / 40696, exported
   normalizedScore 100.0 / 97.04 / 94.31, the bound's two kernels, K1
   and G1-G4 launched and K3a not (counted from 0 just before the chain),
   and the
   exported files equal
   to the same chain's on the CPU and on per-mask JSON files; (b) at
   size, the port's script (one search block, two gradient processes on
   the card and the store) over 128 of phase 4's masks (cut from 1024 to
   keep the script under 600 s with phase 10) against 512 targets built
   from the three fixtures with a gradient file (rolled and banded with their
   gradients), written as TIFF/PNG files: every stored pixel
   score equal to an in-memory `TwoPhaseSweep` on every pair, the golden
   pairs' scores and gaps, one export file per mask with a match, and
   one gradient process over a copy of the store giving the same rows.
   Its numbers (each stage's seconds, the CLI's pairs/s with decode,
   match building and the store write, rows stored, gradient matches/s,
   peak device memory per process) are one JSON line
   `{"pipeline": ...}` before the kernels line;
9. the rest of the JAX package on the card: (a) the whole pipeline from
   ingest to export through the CLI's entry points:
   createColorDepthSearchDataInput writes the EM and LM libraries of the
   fixtures (the LM one with its gradient and z-gap variants) as JSON
   and into one SQLite store, copyToMipsStore copies the JSON lists into
   a canonical store folder, then colorDepthSearch (--mips-storage db),
   gradientScores and normalizeGradientScores on `--device cuda`,
   importPPPResults (the two raw PPP fixtures, with screenshots), both
   EM exports, tag, validateDBData and deleteCDMatches (a dry run, then
   a run): the goldens of the fixture pairs from the ingested lists, the
   PPP export's screenshot-backed match, the bound's two kernels, K1 and
   G1-G4 launched and K3a not (counted from 0 just before the chain), and the
   exports, the validation report and the rows deleted equal to the same
   chain's on the CPU over a copy of the ingested store; (b) the
   prescreen bound on phase 4's library: each of its two kernels
   (`prescreen_cells`, `prescreen_capped`) equal to its plain version on
   the card on every entry of both partitions (the bits and counts of
   all 18 variants, all 1024 x 256 bounds), each kernel's ms beside its
   plain version's and its bound (operations and bytes from the query
   CSR's sizes); on partition 0 the kernels' bound equal to the dense
   formulation's on every pair, the capped and the target-feature bound
   each equal to its CPU run on a slice, exact <= capped <= feature on
   every pair, and each bound's ms (the capped one through the kernels
   and as the dense products), survivor rate, peak memory and bound. Its
   numbers are one JSON line `{"ingest": ...}` before the kernels line;
10. the port's dress rehearsal (`python -m
   colormipsearch_torch.scripts.dress_rehearsal`) on the card at 256 masks
   x 1024 targets, cut in depth from its 2048 x 2048 (REHEARSAL_CUT): its
   production-shaped library, then one process per stage over one SQLite
   store (EM and LM ingest with grad and zgap variants, colorDepthSearch
   --mips-storage db -ps 500, two full partitions and a ragged 24,
   gradientScores --nBestLines 300 in four process blocks, normalize,
   export). Every stage exits 0, every stored pixel score equals an
   in-memory `TwoPhaseSweep` on every pair, each mask's best 300 lines
   are gradient-scored, the gradient and normalized scores of 4 masks
   equal a `--device cpu` run over a copy of the store, every mask with a
   match has one export file, and the launches each command logs show the
   bound's two kernels and K1 (not K3a) in colorDepthSearch and G1-G4 in
   the gradient blocks, G2 twice per query (r = 60, 20) and never at r =
   10. Each stage's seconds and peak RSS, the device stages' peak device
   memory, pairs/s, gradient matches/s, the store's bytes and counts are
   one JSON line `{"rehearsal": ...}` before the kernels line.

`python3 chip_smoke.py --profile DIR` adds a torch.profiler round of the
phase-4 ratio sweep: device busy share, the bound's (its two kernels
profiled alone on the same partitions) and the exact kernel's device
time, the top device kernels, and a Chrome trace in DIR.

Any failure exits non-zero. The last two lines are a JSON object per
kernel (its launches on the main path, worst error, time, plain time,
bound and what bounds it) and {"ok": true, "device": {...}}. Outside a
checkout of the repo,
or without a CUDA card, it exits with code 2 before printing any result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "cdsearch")
LM_GOLDEN = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-"
    "2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]
# kernel -> (source, the TPU kernel it replaces; the prescreen bound's
# two and gradientScores' four replace XLA functions of the JAX package,
# not Pallas kernels)
KERNELS = {
    "multimask_ratio": ("colormipsearch_torch/csrc/multimask_ratio.cu",
                        "colormipsearch_tpu/cds/multimask.py:326"),
    "multimask_words": ("colormipsearch_torch/csrc/multimask_words.cu",
                        "colormipsearch_tpu/cds/multimask.py:260"),
    "op_chain": ("colormipsearch_torch/csrc/op_chain.cu",
                 "scripts/op_microbench.py:38"),
    "prescreen_cells": ("colormipsearch_torch/csrc/prescreen_bound.cu",
                        "colormipsearch_tpu/cds/prescreen.py:269"),
    "prescreen_capped": ("colormipsearch_torch/csrc/prescreen_bound.cu",
                         "colormipsearch_tpu/cds/prescreen.py:269"),
    # gradientScores' four (G1-G4), replacing its XLA programs
    "shape_rows": ("colormipsearch_torch/csrc/shape_score.cu",
                   "colormipsearch_tpu/cds/shape_kernel.py:79"),
    "dilate_rgb": ("colormipsearch_torch/csrc/shape_planes.cu",
                   "colormipsearch_tpu/cds/shape_device.py:127"),
    "query_planes": ("colormipsearch_torch/csrc/shape_planes.cu",
                     "colormipsearch_tpu/cds/shape_device.py:211"),
    "target_planes": ("colormipsearch_torch/csrc/shape_planes.cu",
                      "colormipsearch_tpu/cds/shape_device.py:164"),
}
SHAPE_KERNELS = ("shape_rows", "dilate_rgb", "query_planes", "target_planes")
# the kernel libraries, one per source (cds/kernels.py)
LIBRARIES = tuple(dict.fromkeys(os.path.basename(src)[:-len(".cu")]
                                for src, _ in KERNELS.values()))


def log(msg):
    print(msg, flush=True)


def load_rgb(path):
    from PIL import Image
    with Image.open(path) as img:
        return np.array(img.convert("RGB"), dtype=np.uint8)


def label_regions(h, w):
    """The CLI's default excluded label regions (colour scale top right,
    line name top left), as the command applies them."""
    mask = np.zeros((h, w), dtype=bool)
    if w > 270:
        mask[:90, w - 270:] = True
    mask[:100, :330] = True
    return mask


class Check:
    """One kernel against its plain version: worst error, cases."""

    def __init__(self, name):
        self.name = name
        self.max_abs_err = 0
        self.cases = 0

    def compare(self, label, got_fn, want_fn, detail=""):
        import torch
        got = got_fn()
        want = want_fn()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
                  ) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        log(f"  {self.name} {label}: {detail}max |kernel - plain| = {err}")
        if not torch.equal(got, want):
            raise SystemExit(f"{self.name} disagrees with its plain version: "
                             f"{label}")
        return got


def compare_scorer(checks, label, scorer, tab, packed):
    from colormipsearch_torch.cds import multimask as mm
    kernel, plain = mm.PREDICATE_KERNELS[scorer.predicate]
    args = scorer.kernel_args(packed, tab)
    tail = scorer.kernel_tail()
    check = checks[f"multimask_{scorer.predicate}"]
    got = check.compare(label, lambda: kernel(*args, *tail),
                        lambda: plain(*args, *tail),
                        f"rows {len(tab.tgt)}, live tiles "
                        f"{len(tab.tile_list)}, ")
    return got, args, tail


# ---- phase 1 ---------------------------------------------------------------

def phase_card():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from colormipsearch_torch.cds import kernels
    t0 = time.perf_counter()
    libs = kernels.load_libraries(LIBRARIES)
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f}s "
        f"(one nvcc each, in parallel)")
    for name, kl in libs.items():
        log(f"[build] {name}: nvcc {kl.build_seconds:.2f}s, {kl.path}")
        fn = ""
        for line in kl.build_log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
                # the template argument: xy_shift, or the op case
                fn = fn[fn.find("ILi"):fn.find("EE")] if "ILi" in fn else fn
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {name}<{fn.replace('ILi', '')}> "
                    f"{line.replace('ptxas info    :', '').strip()}")
    # the pack stage's host word packer: the native copy, never its NumPy
    # path, on the card's host
    from colormipsearch_torch.native import mipops
    t0 = time.perf_counter()
    if not mipops.available():
        raise SystemExit(f"the native word packer did not build or load "
                         f"({mipops.library_path()}): the pack stage would "
                         f"run its NumPy path")
    log(f"[build] native word packer (g++) ready in "
        f"{time.perf_counter() - t0:.2f}s: {mipops.library_path()}")
    return card, libs


# ---- phase 2 ---------------------------------------------------------------

def random_library(rng, n, h, w):
    """Frames of random colour in one random rectangle each; frame 0 is a
    full-frame speckle (every tile active)."""
    out = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        px = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        if i == 0:
            keep = rng.random((h, w)) < 0.05
        else:
            keep = np.zeros((h, w), bool)
            rh, rw = rng.integers(24, 240), rng.integers(64, 700)
            r0, c0 = rng.integers(0, h - rh), rng.integers(0, w - rw)
            keep[r0:r0 + rh, c0:c0 + rw] = rng.random((rh, rw)) < 0.4
        out[i][keep] = px[keep]
    return out


def check_ratio_planes(words, planes):
    """The ratio planes built on the card equal those built on the CPU,
    bit for bit (the IEEE divide of the ratio plane)."""
    import torch
    from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
    want = ActiveTilePixelEngine.pad_ratio_planes(words.cpu())
    for name, got, ref in zip(("rf", "fw", "rf_m", "fw_m"), planes, want):
        same = torch.equal(got.cpu().view(torch.uint8),
                           ref.view(torch.uint8))
        if not same:
            raise SystemExit(f"ratio plane {name} built on the card differs "
                             f"from the CPU's")
    log(f"  ratio planes of {words.shape[0]} targets: card == CPU, bit for "
        f"bit")


def every_tile_table(scorer, n_targets):
    """A launch table that lists every active tile of every mask, in both
    directions, for every target: tiles without a selected pixel too,
    which build_table never lists."""
    from colormipsearch_torch.cds import multimask as mm
    tiles, counts, tgt = [], [], []
    tile_off = 0
    for eng in scorer.engines:
        n = eng.tiles.n_active
        entry = ((tile_off + np.arange(n)).astype(np.int32)
                 | (3 << mm.DIR_SHIFT))
        tile_off += n
        for t in range(n_targets):
            tiles.append(entry)
            counts.append(n)
            tgt.append(t)
    return mm.LaunchTable(
        row_off=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        tile_list=np.concatenate(tiles).astype(np.int32),
        tgt=np.array(tgt, np.int32), surv=np.ones(len(tgt), np.int32))


def edge_mask(h, w):
    """A mask whose first three tiles hold 0, 1 and 1024 selected pixels:
    tile (0, 0) gray (above threshold, but sector 0 never matches), one
    coloured pixel in tile (0, 1), tile (0, 2) full of r > g > b > 0."""
    rng = np.random.default_rng(7)
    m = np.zeros((h, w, 3), np.uint8)
    m[0:8, 0:128] = 120
    m[3, 130] = (200, 60, 20)
    m[0:8, 256:384] = np.stack([rng.integers(180, 256, (8, 128)),
                                rng.integers(60, 170, (8, 128)),
                                rng.integers(1, 50, (8, 128))], axis=-1)
    return m


def compaction_edges(checks, dev, speckle, targets):
    """Each kernel against its plain version on the compact lists' edges:
    tiles with 0, 1 and 1024 selected pixels (the last spans 32 passes of
    a warp), and rows of hundreds of tiles (a full-frame speckle mask)."""
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_active import (ActiveTilePixelEngine,
                                                       pad_for_predicate)
    h, w = speckle.shape[:2]
    words = None
    for predicate in ("ratio", "words"):
        engines = [ActiveTilePixelEngine(m, 20, True, 20, 1.0, 2,
                                         predicate=predicate)
                   for m in (edge_mask(h, w), speckle)]
        t = engines[0].tiles
        n_sel = np.diff(t.sel_off)[:3]
        if list(n_sel) != [0, 1, 1024] or [tuple(c) for c in t.coords[:3]] \
                != [(0, 0), (0, 128), (0, 256)]:
            raise SystemExit(f"edge mask: selected pixels per tile "
                             f"{list(n_sel)} at {t.coords[:3].tolist()}")
        if words is None:
            words = engines[0].pack_raw_words(targets, dev)
        packed = pad_for_predicate(words, predicate)
        scorer = mm.MultiMaskScorer(engines)
        tab = every_tile_table(scorer, len(targets))
        compare_scorer(checks, f"compaction edges ({predicate}): tiles of "
                       f"0, 1 and 1024 selected pixels and rows of "
                       f"{engines[1].tiles.n_active} tiles, every tile in "
                       f"both directions", scorer, tab, packed)
        surv = np.ones((2, len(targets)), np.int32)
        compare_scorer(checks, f"compaction edges ({predicate}), host table",
                       scorer, scorer.build_table(
                           surv, mm.signal_ranges_from_words(words),
                           mm.tile_live_from_words(words)), packed)


def phase_kernel_vs_plain(checks, dev, n_masks=16, n_targets=64):
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_active import (ActiveTilePixelEngine,
                                                       pad_for_predicate)
    rng = np.random.default_rng(20260101)
    h, w = 566, 1210
    masks = random_library(rng, n_masks, h, w)
    targets = random_library(rng, n_targets, h, w)
    surv = (rng.random((n_masks, n_targets)) < 0.3).astype(np.int32)
    surv[1] = 1                     # dense survivors
    surv[2] = 0                     # a mask with zero survivors
    surv[3] = 0
    surv[3, -1] = 1                 # one survivor at the last target
    t0 = time.perf_counter()
    for pcf, xy_shift, mirror in ((1.0, 2, True), (1.0, 2, False),
                                  (1.0, 0, True), (10.0, 2, True)):
        # the ratio kernel as in its first port; the word kernel in every
        # configuration, over the same query tiles
        ratio = pcf == 1.0
        engines = [ActiveTilePixelEngine(m, 20, mirror, 20, pcf, xy_shift,
                                         predicate="ratio" if ratio
                                         else "words") for m in masks]
        if xy_shift == 2 and mirror and ratio:
            n_act = [e.tiles.n_active for e in engines]
            log(f"  active tiles per mask: {n_act}")
            if max(n_act) <= 128:
                raise SystemExit("no mask above 128 active tiles")
        words = engines[0].pack_raw_words(targets, dev)
        planes = {p: pad_for_predicate(words, p) for p in ("ratio", "words")}
        if pcf == 1.0 and xy_shift == 2 and mirror:
            check_ratio_planes(words, planes["ratio"])
        ranges = mm.signal_ranges_from_words(words)
        live = mm.tile_live_from_words(words)
        scorers = [mm.MultiMaskScorer(
            [e.with_predicate("words") for e in engines])]
        if ratio:
            scorers.insert(0, mm.MultiMaskScorer(engines))
        for scorer in scorers:
            label = (f"pixColorFluctuation {pcf}, xyShift {xy_shift}, "
                     f"mirror {mirror}")
            packed = planes[scorer.predicate]
            for restrict in (False, True):
                tab = (scorer.build_table(surv, ranges, live) if restrict
                       else scorer.build_table(surv))
                compare_scorer(checks, f"{label}, live-tile cut {restrict}",
                               scorer, tab, packed)
            tab.surv[::3] = 0  # rows the kernel must report as 0
            compare_scorer(checks, f"{label}, every third row's survivor "
                           f"flag 0", scorer, tab, packed)
    compaction_edges(checks, dev, masks[0], targets)
    log(f"[phase 2] kernel == plain in "
        f"{checks['multimask_ratio'].cases} ratio and "
        f"{checks['multimask_words'].cases} word cases "
        f"({time.perf_counter() - t0:.1f}s)")


# ---- phase 3 ---------------------------------------------------------------

def write_workspace(ws):
    em = {"class": "org.janelia.colormipsearch.model.EMNeuronEntity",
          "id": "1001", "mipId": "em-12191",
          "alignmentSpace": "JRC2018_Unisex_20x_HR",
          "libraryName": "flyem_test", "publishedName": "12191",
          "computeFiles": {"InputColorDepthImage": os.path.join(
              FIXTURES, "ems", "12191_JRC2018U.tif")}}

    def compute_files(name):
        """The CDM, the gradient and (BJD only) the z-gap file."""
        files = {"InputColorDepthImage": os.path.join(FIXTURES, "lms",
                                                      f"{name}.tif"),
                 "GradientImage": os.path.join(FIXTURES, "grad",
                                               f"{name}.png")}
        zgap = os.path.join(FIXTURES, "zgap", f"{name}.tif")
        if os.path.exists(zgap):
            files["ZGapImage"] = zgap
        return files

    lms = [{"class": "org.janelia.colormipsearch.model.LMNeuronEntity",
            "id": str(2001 + i), "mipId": f"lm-{i}",
            "alignmentSpace": "JRC2018_Unisex_20x_HR",
            "libraryName": "flylight_test",
            "publishedName": name.split("_")[0],
            "computeFiles": compute_files(name),
            "slideCode": f"sc-{i}", "anatomicalArea": "Brain",
            "objective": "40x", "gender": "f"}
           for i, name in enumerate(LM_GOLDEN)]
    for fname, ents in (("masks.json", [em]), ("targets.json", lms)):
        with open(os.path.join(ws, fname), "w") as f:
            json.dump(ents, f, indent=2)


def phase_cli(ws, ratio_pred):
    """The CLI on the golden fixtures with CMS_RATIO_PRED=ratio_pred: the
    predicate's kernel launches, the other's does not."""
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cmd.main import main
    write_workspace(ws)
    out = os.path.join(ws, f"out{ratio_pred}")
    used, unused = (mm.PREDICATE_KERNELS[p][0] for p in
                    (("ratio", "words") if ratio_pred == "1"
                     else ("words", "ratio")))
    used.launches = unused.launches = 0
    saved = os.environ.get("CMS_RATIO_PRED")
    os.environ["CMS_RATIO_PRED"] = ratio_pred
    t0 = time.perf_counter()
    try:
        rc = main(["colorDepthSearch", "-m", os.path.join(ws, "masks.json"),
                   "-i", os.path.join(ws, "targets.json"),
                   "--maskThreshold", "20", "--dataThreshold", "20",
                   "--pixColorFluctuation", "1", "--xyShift", "2",
                   "--mirrorMask", "--device", "cuda", "-od", out])
    finally:
        if saved is None:
            del os.environ["CMS_RATIO_PRED"]
        else:
            os.environ["CMS_RATIO_PRED"] = saved
    if rc != 0:
        raise SystemExit(f"colorDepthSearch exited {rc}")
    with open(os.path.join(out, "masks", "em-12191.json")) as f:
        doc = json.load(f)
    res = {r["image"]["mipId"]: r for r in doc["results"]}
    got = [(k, res[k]["matchingPixels"], res[k]["mirrored"])
           for k in ("lm-0", "lm-1", "lm-2")]
    log(f"[phase 3] CMS_RATIO_PRED={ratio_pred}: CLI goldens {got} in "
        f"{time.perf_counter() - t0:.1f}s; kernel launches "
        f"{used.__name__} {used.launches}, {unused.__name__} "
        f"{unused.launches}")
    if got != [("lm-0", 439, False), ("lm-1", 414, False),
               ("lm-2", 426, True)]:
        raise SystemExit(f"CLI goldens wrong: {got}")
    if used.launches == 0 or unused.launches != 0:
        raise SystemExit(f"CMS_RATIO_PRED={ratio_pred}: the CLI did not "
                         f"run through {used.__name__} alone")


# ---- phase 4 ---------------------------------------------------------------

def roll_frame(px, i):
    """The i-th deterministic roll of a frame (none for i == 0)."""
    h, w = px.shape[:2]
    return px if i == 0 else np.roll(
        px, ((37 * i) % h, (151 * i) % w), axis=(0, 1))


def band_frame(px, i, bh=160, step=53):
    """The frame kept only in the i-th 160-row band (whole for i == 0)."""
    if i == 0:
        return px
    h = px.shape[0]
    b0 = (step * i) % (h - bh)
    out = np.zeros_like(px)
    out[b0:b0 + bh] = px[b0:b0 + bh]
    return out


def adversarial_library(n_masks, n_targets):
    """The adversarial two-phase library of the JAX package's bench
    (fixtures rolled by deterministic offsets, targets banded to one
    160-row band; index 0 of each family unrolled, so the golden pairs
    stay in the grid)."""
    ems = sorted(os.listdir(os.path.join(FIXTURES, "ems")))
    lms = sorted(os.listdir(os.path.join(FIXTURES, "lms")))
    em_px = [load_rgb(os.path.join(FIXTURES, "ems", n)) for n in ems]
    lm_px = [load_rgb(os.path.join(FIXTURES, "lms", n)) for n in lms]
    h, w = em_px[0].shape[:2]
    masks = [roll_frame(em_px[i % len(em_px)], i // len(em_px))
             for i in range(n_masks)]
    targets = np.stack([band_frame(roll_frame(lm_px[i % len(lm_px)],
                                              i // len(lm_px)), i)
                        for i in range(n_targets)])
    return masks, targets, h, w


def device_kernel_ms(prof):
    """{kernel name: (device ms, launches)} of a torch.profiler run."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def phase_profile(run, bound_only, trace_dir):
    """One profiled pipelined round: device busy share, the bound's share
    (its ops profiled alone on the same partitions), the exact kernel's."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(None)
        wall = time.perf_counter() - t0
    kernels = device_kernel_ms(prof)
    with profile(activities=acts) as prof_b:
        bound_only()
    dev_ms = sum(ms for ms, _ in kernels.values())
    bound_ms = sum(ms for ms, _ in device_kernel_ms(prof_b).values())
    exact_ms = sum(ms for k, (ms, _) in kernels.items()
                   if "multimask_ratio" in k)
    if dev_ms == 0:
        raise SystemExit("the profiler saw no device time")
    log(f"[profile] round wall {wall:.4f}s, device kernel time "
        f"{dev_ms:.2f} ms: busy {100 * dev_ms / 1e3 / wall:.2f} %, idle "
        f"{100 - 100 * dev_ms / 1e3 / wall:.2f} %")
    log(f"[profile] prescreen bound alone {bound_ms:.2f} ms "
        f"({100 * bound_ms / dev_ms:.2f} % of the round's device time); "
        f"exact kernel {exact_ms:.2f} ms ({100 * exact_ms / dev_ms:.2f} %)")
    for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {ms:9.2f} ms {100 * ms / dev_ms:5.1f} % x{n:<5d} "
            f"{k[:100]}")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "twophase_trace.json")
    prof.export_chrome_trace(path)
    log(f"[profile] trace: {path}")


def pixel_loop(path, xy_shift):
    """Mnemonic counts of the exact kernel's pixel loop for xy_shift (the
    innermost loop with the most shared-memory loads), read from the
    built library's SASS: one pass scores one selected query pixel in
    both directions."""
    from colormipsearch_torch.cds import kernels
    name = f"multimask_{path}"
    for fn, loops in kernels.sass_loops(kernels.sass(name)).items():
        if f"{name}_kernelILi{xy_shift}E" in fn:
            return max(kernels.innermost_loops(loops), key=lambda lp: sum(
                n for m, n in lp.body.items() if m.startswith("LDS"))).body
    raise SystemExit(f"no {name} kernel for xyShift {xy_shift} in its SASS")


# the least time of a kernel: its operations over the card's lane rate
# (67 TFLOP/s of f32 outside the tensor cores, an FMA counted as two: 33.5
# T lane-operations/s) or its bytes, each read or written once, over HBM3's
# 3.35 TB/s (NVIDIA H100 SXM data sheet), whichever is larger
PEAK_LANE_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12
# the operations one (query pixel, variant) evaluation needs at least:
# ratio, 3 flag tests, 4 f32 compares, 2 xors, 2 ors and the add; words,
# the case selection (~10) and the staged-rational chain (~25) of
# match_word. The built kernels issue more (phase 4 reads their SASS).
OPS_PER_EVAL = {"ratio": 12, "words": 35}


def event_ms(fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_work(scorer, tab):
    """What one launch over `tab` must do: evaluations (selected pixels x
    variants over the live (row, tile) pairs, and in live directions
    only), the window bins, the bytes the kernel stages (one aligned
    window per bin and live direction), the bytes it must read or write
    once (each such window's region, the query lists of the tiles it
    reads, the table, the counts) and its bound."""
    from colormipsearch_torch.cds import multimask as mm
    ns = len(scorer.shifts)
    s = max(abs(dy) for _, dy in scorer.shifts)
    tiles = tab.tile_list & mm.TILE_MASK
    dirs = (tab.tile_list >> mm.DIR_SHIFT) & 3
    n_dirs = (dirs & 1) + (dirs >> 1)
    n_sel = scorer._n_sel[tiles]
    elem = 5 if scorer.predicate == "ratio" else 4  # bytes per staged pixel
    win_h = 8 + 2 * s
    coords = scorer._q_host[-1][tiles].astype(np.int64)
    tgt = np.repeat(tab.tgt, np.diff(tab.row_off)).astype(np.int64)
    hp, wp = scorer.frame_shape
    bins = (tgt * hp + coords[:, 0]) * wp + coords[:, 1]
    n_windows = len(np.unique(np.concatenate(
        [bins[(dirs & bit) != 0] * 2 + bit - 1 for bit in (1, 2)])))
    used = np.unique(tiles)
    entry_bytes = 20 if scorer.predicate == "ratio" else 4
    bytes_once = (n_windows * win_h * (128 + 2 * s) * elem
                  + int(scorer._n_sel[used].sum()) * entry_bytes
                  + 4 * (len(tab.row_off) + len(tab.tile_list)
                         + 2 * len(tab.tgt))
                  + 4 * 2 * ns * len(tab.tgt))
    evals_dir = int((n_sel * n_dirs).sum()) * ns
    ops_ms = 1e3 * evals_dir * OPS_PER_EVAL[scorer.predicate] / PEAK_LANE_OPS
    bytes_ms = 1e3 * bytes_once / PEAK_BYTES
    return {"nv": 2 * ns, "evals": int(n_sel.sum()) * 2 * ns,
            "evals_dir": evals_dir, "bins": len(np.unique(bins)),
            "members": len(tiles), "windows": n_windows,
            "staged_bytes": n_windows * win_h * 136 * elem,
            "bytes": bytes_once, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def dense_capped_bounds(screen, u_matrix, t_words):
    """The count-capped bound as the port computed it before its two
    kernels: the dense fp32 products of
    prescreen._variant_block_bounds_capped over every cell and bin, in
    FEATURE_BLOCK target blocks, TF32 off. u_matrix: a QueryRows CSR or a
    dense [B, F] matrix. The yardstick of phases 4 and 9b; no command
    calls it."""
    import torch
    from colormipsearch_torch.cds import prescreen as ps
    u = (u_matrix.to_dense() if isinstance(u_matrix, ps.QueryRows)
         else torch.as_tensor(u_matrix))
    u3 = u.to(device=t_words.device, dtype=torch.float32).reshape(
        u.shape[0], -1, ps.N_BINS)
    outs = []
    with ps._fp32_matmul():
        for i in range(0, t_words.shape[0], screen.FEATURE_BLOCK):
            wb = t_words[i:i + screen.FEATURE_BLOCK]
            outs.append(torch.maximum(*(ps._variant_block_bounds_capped(
                u3, wb, screen.zt9, screen.offsets, screen.grid_hw, flip)
                for flip in (False, True))))
    return torch.cat(outs, dim=1).cpu().numpy()


class DenseBoundScreen:
    """A screen for TwoPhaseSweep whose bound is dense_capped_bounds: the
    same bounds as the package's PairPrescreen, without its kernels."""

    def __init__(self, screen):
        self.screen = screen

    def bounds_from_words(self, u_matrix, t_words):
        return dense_capped_bounds(self.screen, u_matrix, t_words)


# the least operations of the prescreen kernels: cells, an OR and a count
# per pixel of each variant's window, and the bin of each word (field
# extracts, the ratio's multiply and divide, the sector's offset);
# capped, a bit test and a multiply-add per (entry, variant, target), a
# min and an add per (cell, variant, target) and a max per (mask,
# variant, target)
OPS_PER_WINDOW_PX = 2
OPS_PER_BIN = 6
OPS_PER_ENTRY = 2
OPS_PER_CELL = 2


def prescreen_work(words, bits, cnt, rows):
    """{kernel: (ops_ms, bytes_ms)} of the two prescreen kernels on one
    partition: their operations at the card's lane rate and their bytes,
    each input read once and each output written once, at its memory
    rate, from this partition's shapes and the query CSR's sizes."""
    nv, npos, tsz = bits.shape
    n_cells, n_ent = rows.cell_pos.numel(), rows.entries.numel()
    csr_bytes = 4 * sum(t.numel() for t in rows.tensors())
    out_bytes = 4 * rows.n_masks * tsz
    table_bytes = bits.numel() * 8 + cnt.numel()
    cells_ops = (nv * npos * tsz * 8 * 16 * OPS_PER_WINDOW_PX
                 + words.numel() * OPS_PER_BIN)
    capped_ops = nv * tsz * (n_ent * OPS_PER_ENTRY + n_cells * OPS_PER_CELL
                             + rows.n_masks)
    return {"prescreen_cells": (1e3 * cells_ops / PEAK_LANE_OPS,
                                1e3 * (words.numel() * 4 + table_bytes)
                                / PEAK_BYTES),
            "prescreen_capped": (1e3 * capped_ops / PEAK_LANE_OPS,
                                 1e3 * (table_bytes + csr_bytes + out_bytes)
                                 / PEAK_BYTES)}


def phase_at_size(checks, dev, profile_dir=None, n_masks=1024,
                  n_targets=512, part=256):
    import torch
    from colormipsearch_torch.cds import kernels
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_active import (ActiveTilePixelEngine,
                                                       drain_deferred,
                                                       pad_for_predicate)
    from colormipsearch_torch.cds import prescreen as ps
    from colormipsearch_torch.cds.prescreen import PairPrescreen
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    from colormipsearch_torch.scripts.op_microbench import cuda_ms

    masks, targets, h, w = adversarial_library(n_masks, n_targets)
    excluded = label_regions(h, w)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        engines = list(pool.map(
            lambda m: ActiveTilePixelEngine(m, 20, True, 20, 1.0, 2,
                                            excluded), masks))
    screen = PairPrescreen(engines[0].zt9, 2, h, w)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        u_matrix = np.stack(list(pool.map(
            lambda e: screen.query_features(e.planes.words), engines)))
    thr = np.maximum(0.01 * np.array([e.tiles.query_size for e in engines]),
                     0.5)
    sweeps = {"ratio": TwoPhaseSweep(engines, [dev], screen, u_matrix, thr)}
    log(f"[phase 4] {n_masks} masks x {n_targets} targets; engines and "
        f"query features in {time.perf_counter() - t0:.1f}s; mean active "
        f"tiles {np.mean([e.tiles.n_active for e in engines]):.1f}")
    # the word path over the same query tiles: no second query prep
    t0 = time.perf_counter()
    words_engines = [e.with_predicate("words") for e in engines]
    sweeps["words"] = TwoPhaseSweep(words_engines, [dev], screen, u_matrix,
                                    thr)
    log(f"[phase 4] word engines from the ratio engines' tiles in "
        f"{time.perf_counter() - t0:.3f}s")
    # the ratio path screened by the dense fp32 bound, without the
    # prescreen kernels: the yardstick of the bound's kernels
    sweeps["dense"] = TwoPhaseSweep(engines, [dev], DenseBoundScreen(screen),
                                    u_matrix, thr)
    predicate = {"ratio": "ratio", "words": "words", "dense": "ratio"}
    parts = [targets[i:i + part] for i in range(0, n_targets, part)]
    wrappers = {p: fns[0] for p, fns in mm.PREDICATE_KERNELS.items()}
    wrappers.update(prescreen_cells=ps.prescreen_cells,
                    prescreen_capped=ps.prescreen_capped)

    def run(sweep, stage, sync=False):
        """The CLI's partition loop: partition p+1 is launched before p is
        collected."""
        out = list(sweep.sweep_parts(enumerate(parts), stage, sync))
        torch.cuda.synchronize(dev)
        return (np.concatenate([s for _, s, _ in out], axis=1),
                np.concatenate([m for _, _, m in out], axis=1))

    # stage round of each path: every stage synchronizes, so each stage's
    # seconds hold its device work; the main-path kernel launch counts are
    # set to 0 just before this run and read just after it
    results, launches = {}, {}
    pairs = n_masks * n_targets
    for path, sweep in sweeps.items():
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        stage = {}
        t0 = time.perf_counter()
        results[path] = run(sweep, stage, sync=True)
        staged_s = time.perf_counter() - t0
        launches[path] = {p: fn.launches for p, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        own = predicate[path]
        other = "words" if own == "ratio" else "ratio"
        screens = launches[path]["prescreen_cells"], launches[path][
            "prescreen_capped"]
        if launches[path][own] == 0 or launches[path][other] != 0 \
                or screens != ((0, 0) if path == "dense"
                               else (len(parts), len(parts))):
            raise SystemExit(f"the {path} path did not run through its "
                             f"kernels alone: {launches[path]}")
        scores = results[path][0]
        if 439 not in scores[0]:
            raise SystemExit(f"{path}: golden 439 missing from mask 0: "
                             f"{scores[0][:8]}")
        surv_rate = 1.0 - stage.get("screened", 0) / pairs
        true_rate = float(np.mean(scores > thr[:, None]))
        log(f"[phase 4] {path} path: kernel launches {launches[path]}; "
            f"439 in mask 0's scores; stage-synced round {staged_s:.3f}s; "
            f"survivor rate {surv_rate:.4f}, true match rate "
            f"{true_rate:.4f}, peak device memory {peak / 2**30:.2f} GiB")
        log(f"[phase 4] {path} stage seconds: " + json.dumps(
            {k: round(v, 4) for k, v in stage.items() if k != "screened"}))
    for path in ("words", "dense"):
        if not all(np.array_equal(a, b)
                   for a, b in zip(results["ratio"], results[path])):
            raise SystemExit(f"the {path} path's scores differ from the "
                             f"ratio path's")
    log(f"[phase 4] word path == dense-bound path == ratio path on all "
        f"{pairs} pairs (scores and mirrored flags)")
    # timed rounds, no stage syncs, the CLI's loop as it runs; the paths
    # in turns: ratio, dense, words, words, dense, ratio
    walls = {"ratio": [], "dense": [], "words": []}
    for path in ("ratio", "dense", "words", "words", "dense", "ratio"):
        t0 = time.perf_counter()
        got = run(sweeps[path], None)
        walls[path].append(time.perf_counter() - t0)
        if not all(np.array_equal(a, b) for a, b in zip(got, results[path])):
            raise SystemExit(f"two runs of the {path} sweep disagree")
    for path, ws in walls.items():
        log(f"[phase 4] {path} path, pipelined rounds: " + ", ".join(
            f"{w:.3f}s = {pairs / w:.1f} pairs/s" for w in ws))

    # partition 0's tables, as the sweep builds them
    words = engines[0].pack_raw_words(parts[0], dev)
    planes = {p: pad_for_predicate(words, p) for p in ("ratio", "words")}
    ranges = mm.signal_ranges_from_words(words)
    live = mm.tile_live_from_words(words)
    survivors = (screen.bounds_from_words(u_matrix, words)
                 > thr[:, None]).astype(np.int32)
    timing = {name: {"launches": launches["ratio"][name]}
              for name in ("prescreen_cells", "prescreen_capped")}
    for path in ("ratio", "words"):
        (_, everyone), = sweeps[path].groups  # one param group: every mask
        kernel, plain = mm.PREDICATE_KERNELS[path]
        t0 = time.perf_counter()
        tab = everyone.build_table(survivors, ranges, live)
        table_s = time.perf_counter() - t0
        # the main path's launch, against the plain version on the same
        # tensors (the plain version runs once, timed)
        args = everyone.kernel_args(planes[path], tab)
        tail = everyone.kernel_tail()
        plain_run = {}

        def plain_once():
            plain_run["out"], plain_run["ms"] = event_ms(
                lambda: plain(*args, *tail))
            return plain_run["out"]

        checks[f"multimask_{path}"].compare(
            f"at size, all masks of partition 0 ({len(tab.tgt)} survivor "
            f"rows)", lambda: kernel(*args, *tail), plain_once)
        kernel_ms = cuda_ms(lambda: kernel(*args, *tail), 3)
        plain_ms = plain_run["ms"]
        work = kernel_work(everyone, tab)
        log(f"[phase 4] {path}: partition 0, all masks: host launch table "
            f"{table_s:.3f}s, exact kernel {kernel_ms:.3f} ms, plain "
            f"version {plain_ms:.3f} ms ({len(tab.tgt)} rows, "
            f"{len(tab.tile_list)} live (row, tile) pairs)")
        log(f"[phase 4] {path}: partition 0 work: {work['evals']} "
            f"evaluations that can count (selected pixels x "
            f"{work['nv']} over live (row, tile)), {work['evals_dir']} in "
            f"live directions; {work['members']} (row, tile) members in "
            f"{work['bins']} window bins, {work['windows']} windows staged "
            f"({work['staged_bytes'] / 1e9:.3f} GB), "
            f"{work['bytes'] / 1e9:.3f} GB read or written once; bound "
            f"{work['bound_ms']:.3f} ms by {work['bound_by']} (ops "
            f"{work['ops_ms']:.3f} ms at {OPS_PER_EVAL[path]} ops per "
            f"evaluation, bytes {work['bytes_ms']:.3f} ms); kernel at "
            f"{100 * work['bound_ms'] / kernel_ms:.1f} % of its bound")
        # what the kernel issues: its pixel loop's instructions for this
        # launch's evaluations at the busiest pipe's peak rate
        loop = pixel_loop(path, everyone.xy_shift)
        per_eval = {p: n / work["nv"]
                    for p, n in kernels.pipe_counts(loop).items()}
        loop_s, pipe = kernels.issue_bound_s(
            loop, work["evals_dir"] / work["nv"])
        log(f"[phase 4] {path}: pixel loop (SASS, static body over its "
            f"{work['nv']} evaluations): " + ", ".join(
                f"{p} {v:.2f}" for p, v in per_eval.items())
            + f" instructions per evaluation; this launch's "
            f"{work['evals_dir']} take {1e3 * loop_s:.3f} ms on the "
            f"{pipe} pipe at its peak, {100e3 * loop_s / kernel_ms:.1f} % "
            f"of the kernel's time")

        # 32 masks' rows reproduce the sweep's scores of those masks
        sub = list(range(min(32, n_masks)))
        scorer = mm.MultiMaskScorer([everyone.engines[i] for i in sub])
        defs = scorer.launch_deferred(planes[path], survivors[sub], ranges,
                                      live)
        sampled = np.stack([s for s, _, _ in drain_deferred(defs)])
        if not np.array_equal(sampled,
                              results[path][0][sub, :len(parts[0])]):
            raise SystemExit(f"{path}: sampled rows differ from the "
                             f"sweep's scores")
        timing[f"multimask_{path}"] = {
            "launches": launches[path][path], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"], "library_ms": None}
    if profile_dir is not None:
        part_words = [engines[0].pack_raw_words(tp, dev) for tp in parts]
        rows = ps.sparse_query_rows(u_matrix).to(dev)

        def bound_only():
            for wp in part_words:
                screen.bounds_from_words(rows, wp)
        phase_profile(lambda stage: run(sweeps["ratio"], stage), bound_only,
                      profile_dir)
    library = {"engines": engines, "words_engines": words_engines,
               "screen": screen, "u_matrix": u_matrix, "thr": thr,
               "parts": parts, "result": results["ratio"]}
    return timing, library


# ---- phase 5 ---------------------------------------------------------------

def phase_microbench(dev):
    """The microbench's entry point as a user runs it (its launches are
    the path's count), then each case against its plain version."""
    from colormipsearch_torch.scripts import op_microbench as ob
    ob.op_chain.launches = 0
    t0 = time.perf_counter()
    rc = ob.main(["--device", str(dev)])
    launches = ob.op_chain.launches
    log(f"[phase 5] op_microbench exited {rc} in "
        f"{time.perf_counter() - t0:.1f}s; op_chain launches {launches}")
    if rc != 0 or launches == 0:
        raise SystemExit("the op microbench failed or launched no kernel")
    err, ms, plain_ms = 0.0, 0.0, 0.0
    per_step = ob.instructions_per_step()
    bound_ms = 0.0
    for name in ob.CASE_NAMES:
        r = ob.measure(name, dev)
        log(f"  op_chain {name}: max |kernel - plain| = {r['max_abs_err']}; "
            f"{ob.TIMED_STEPS} steps {r['ms']:.4f} ms = {r['tops']:.3f} "
            f"Top/s, 2S/S {r['ratio_2s']:.3f}, plain {r['plain_ms']:.3f} "
            f"ms")
        if not r["ok"]:
            raise SystemExit(f"op_chain {name}: kernel != plain or the 2S/S "
                             f"time ratio is outside {ob.RATIO_BAND}")
        err = max(err, r["max_abs_err"])
        ms += r["ms"]
        plain_ms += r["plain_ms"]
        # the case's main-loop instructions at the busiest pipe's peak
        case_ms, pipe = ob.bound_ms(per_step[name][1])
        bound_ms += case_ms
        log(f"  op_chain {name}: bound {case_ms:.4f} ms by the {pipe} pipe "
            f"({100 * case_ms / r['ms']:.1f} %)")
    log(f"[phase 5] op_chain == plain in {len(ob.CASE_NAMES)} cases; at "
        f"{ob.TIMED_STEPS} steps the ten cases take {ms:.3f} ms on the "
        f"kernel, {plain_ms:.3f} ms plain; bound {bound_ms:.3f} ms by "
        f"operations ({100 * bound_ms / ms:.1f} %)")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None}


# ---- phase 6 ---------------------------------------------------------------

def load_gray16(path):
    from colormipsearch_torch.imageproc.io import load_image
    img = load_image(path)
    if img.pixels.ndim != 2:
        raise SystemExit(f"{path}: expected a gray gradient image")
    return img.pixels.astype(np.uint16)


def golden_target_frames():
    """The three golden LM fixtures: CDM, 16-bit gradient, and a z-gap
    frame (BJD's file; the production 10 px dilation of the CDM for the
    two without one)."""
    from colormipsearch_torch.imageproc.filters import max_filter_rgb
    cdm, grad, zgap = [], [], []
    for name in LM_GOLDEN:
        px = load_rgb(os.path.join(FIXTURES, "lms", f"{name}.tif"))
        cdm.append(px)
        grad.append(load_gray16(os.path.join(FIXTURES, "grad",
                                             f"{name}.png")))
        zpath = os.path.join(FIXTURES, "zgap", f"{name}.tif")
        zgap.append(load_rgb(zpath) if os.path.exists(zpath)
                    else max_filter_rgb(px, 10.0))
    return np.stack(cdm), np.stack(grad), np.stack(zgap)


def same_tensors(label, got, want):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            raise SystemExit(f"{label}: plane {i} built on the card differs "
                             f"from the CPU's")


def shape_wrappers():
    """{name: wrapper} of gradientScores' four kernels (G1-G4)."""
    from colormipsearch_torch.cds import shape_device as sd
    from colormipsearch_torch.cds import shape_kernel as sk
    return {"shape_rows": sk.shape_rows, "dilate_rgb": sd.dilate_rgb,
            "query_planes": sd.query_planes,
            "target_planes": sd.target_planes}


def stacked_sets(sets):
    """target_planes' per-target planes as the plain version's batch."""
    import torch
    return [torch.stack(p) for p in zip(*sets)]


def check_shape(checks, name, label, kernel_fn, plain_fn):
    """checks[name] on kernel_fn() against plain_fn() (a tensor or a
    sequence of them), dtypes included; returns the kernel's tensors."""
    import torch
    out = {}

    def flat(key, fn):
        res = fn()
        out[key] = [res] if torch.is_tensor(res) else list(res)
        return torch.cat([t.reshape(-1).to(torch.int64) for t in out[key]])

    checks[name].compare(label, lambda: flat("got", kernel_fn),
                         lambda: flat("want", plain_fn))
    if [t.dtype for t in out["got"]] != [t.dtype for t in out["want"]]:
        raise SystemExit(f"{name} {label}: dtypes differ from the plain "
                         f"version's")
    return out["got"]


def phase_planes(checks, dev):
    """(a) On the golden fixtures, gradientScores' four kernels against
    their plain versions on the card: G2 at r = 10 of the masked target
    CDMs and at r = 60 and r = 20 of each EM mask, G4 in both z-gap modes,
    G3 at borders 0 and 4 and G1 with and without mirror and with flipped
    z planes; and the planes and the scorer's rows built on the card equal
    to the CPU's, bit for bit."""
    import torch
    from colormipsearch_torch.cds import shape_device as sd
    from colormipsearch_torch.cds import shape_kernel as sk
    from colormipsearch_torch.cds.shape_oracle import QueryShapePlanes
    cpu = torch.device("cpu")
    cdm, grad, zgap = golden_target_frames()
    h, w = cdm.shape[1:3]
    excluded = label_regions(h, w)
    t0 = time.perf_counter()

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cdm_d, grad_d, ex_d = up(cdm), up(grad.view(np.int16)), up(excluded)
    z_otf = check_shape(
        checks, "dilate_rgb", "fixtures, r = 10 of the masked CDMs",
        lambda: sd.dilate_rgb(cdm_d, 10.0, excluded=ex_d, thr=20),
        lambda: sd.dilate_rgb_plain(sd.dilate_input_plain(cdm_d, ex_d, 20),
                                    10.0))[0]
    targets = {}
    for mode, z in (("file", up(zgap)), ("otf", z_otf)):
        got = check_shape(
            checks, "target_planes", f"fixtures, z-gap {mode}",
            lambda: stacked_sets(sd.target_planes(
                cdm_d, grad_d, z, ex_d, thr=20, grad_is_rgb=False)),
            lambda: sd.target_planes_plain(cdm_d, grad_d, z, ex_d, thr=20,
                                           grad_is_rgb=False))
        want = sd.build_target_planes(
            cdm, grad, zgap if mode == "file" else None, excluded, thr=20,
            zgap_mode=mode, grad_is_rgb=False, device=cpu)
        same_tensors(f"target planes ({mode})", got, want)
        targets[mode] = (got, want)
    ems = sorted(os.listdir(os.path.join(FIXTURES, "ems")))
    names = ("q_nonzero", "q_slice", "q_mask", "high_expr")
    rows = []
    for name in ems:
        rgb = load_rgb(os.path.join(FIXTURES, "ems", name))
        x = up(rgb)
        dil = {r: check_shape(
            checks, "dilate_rgb", f"{name}, r = {r:g}",
            lambda: sd.dilate_rgb(x[None], r, excluded=ex_d),
            lambda: sd.dilate_rgb_plain(sd.dilate_input_plain(x[None], ex_d),
                                        r))[0][0] for r in (60.0, 20.0)}
        for border in (0, 4):
            got = check_shape(
                checks, "query_planes", f"{name}, border {border}",
                lambda: sd.query_planes(x, ex_d, dil[60.0], dil[20.0],
                                        border),
                lambda: sd.query_planes_plain(x, ex_d, dil[60.0], dil[20.0],
                                              border))
            want = sd.build_query_planes(rgb, excluded, border, device=cpu)
            same_tensors(f"query planes of {name}, border {border}",
                         got[:4], [getattr(want, n) for n in names])
            if not np.array_equal(got[4].cpu().numpy(), want.row_any):
                raise SystemExit(f"query rows of {name} differ")
            if border == 0:
                rows.append((QueryShapePlanes(
                    *got[:4], height=h, width=w,
                    row_any=got[4].cpu().numpy()), want))
    for (qg, qc), mode in zip(rows, ("file", "otf", "file")):
        r0, r1 = qg.active_row_range()
        lists = [list(p.unbind(0)) for p in targets[mode][0]]
        lists_cpu = [list(p.unbind(0)) for p in targets[mode][1]]
        for mirror, flip_z in ((True, False), (False, False), (False, True)):
            kw = dict(r0=r0, r1=r1, mirror=mirror, flip_z=flip_z)
            q = [getattr(qg, n) for n in names]
            got = check_shape(
                checks, "shape_rows", f"fixtures, z-gap {mode}, mirror "
                f"{mirror}, flip_z {flip_z}",
                lambda: sk.shape_rows(*q, *lists, **kw),
                lambda: sk.shape_rows_plain(*q, *lists, **kw))
            same_tensors(f"scorer rows ({mode}, mirror {mirror}, flip_z "
                         f"{flip_z})", got, sk.shape_rows(
                             *[getattr(qc, n) for n in names], *lists_cpu,
                             **kw))
    log(f"[phase 6a] G1-G4 == their plain versions on the card, and the "
        f"target planes of {len(LM_GOLDEN)} fixtures in both z-gap modes, "
        f"the query planes of {len(ems)} masks at borders 0 and 4 and the "
        f"scorer's rows: card == CPU, bit for bit "
        f"({time.perf_counter() - t0:.1f}s)")


def phase_gradient_cli(ws):
    """(b) The CLI's gradientScores --device cuda on phase 3's output,
    through G1-G4 (counted from 0 just before the run)."""
    from colormipsearch_torch.cmd.main import main
    masks = os.path.join(ws, "out1", "masks")
    counters = shape_wrappers()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = main(["gradientScores", "-md", masks, "--maskThreshold", "20",
               "--mirrorMask", "--computeZGapOnTheFly", "--device", "cuda"])
    launches = {name: fn.launches for name, fn in counters.items()}
    if rc != 0:
        raise SystemExit(f"gradientScores exited {rc}")
    with open(os.path.join(masks, "em-12191.json")) as f:
        res = {r["image"]["mipId"]: r for r in json.load(f)["results"]}
    got = [(k, res[k]["gradientAreaGap"], res[k]["highExpressionArea"],
            res[k]["mirrored"], res[k]["normalizedScore"])
           for k in ("lm-0", "lm-1", "lm-2")]
    log(f"[phase 6b] gradientScores CLI goldens {got}; kernel launches "
        f"{launches} ({time.perf_counter() - t0:.1f}s)")
    want = [("lm-0", 21365, 731, False, 100.0),
            ("lm-1", 33884, 523, False, float(np.float32(414 / 439 * 100))),
            ("lm-2", 40696, 17253, True, float(np.float32(426 / 439 * 100)))]
    if got != want:
        raise SystemExit(f"gradientScores goldens wrong: {got}")
    if not all(launches.values()):
        raise SystemExit(f"gradientScores did not launch all of G1-G4: "
                         f"{launches}")
    return launches


def target_library(ws, n, zgap_files):
    """n LM entities over the golden fixtures that have a gradient file,
    in turn (the JAX package's bench.py gradient configurations); with
    zgap_files, each carries a precomputed 10 px z-gap file."""
    from PIL import Image
    from colormipsearch_torch.imageproc.filters import max_filter_rgb
    from colormipsearch_torch.model import (ComputeFileType, FileData,
                                            LMNeuronEntity)
    sources = [nm for nm in sorted(os.listdir(os.path.join(FIXTURES, "lms")))
               if os.path.exists(os.path.join(
                   FIXTURES, "grad", nm.rsplit(".", 1)[0] + ".png"))]
    zgaps = {}
    if zgap_files:
        for src in sources:
            path = os.path.join(ws, f"zgap_{src}")
            Image.fromarray(max_filter_rgb(load_rgb(os.path.join(
                FIXTURES, "lms", src)), 10.0)).save(path)
            zgaps[src] = path
    targets = []
    for i in range(n):
        src = sources[i % len(sources)]
        lm = LMNeuronEntity(entity_id=100 + i, mip_id=f"lm-{i}")
        files = {ComputeFileType.InputColorDepthImage:
                 os.path.join(FIXTURES, "lms", src),
                 ComputeFileType.GradientImage: os.path.join(
                     FIXTURES, "grad", src.rsplit(".", 1)[0] + ".png")}
        if zgap_files:
            files[ComputeFileType.ZGapImage] = zgaps[src]
        for cft, path in files.items():
            lm.compute_files[cft] = FileData.from_string(path)
        targets.append(lm)
    return targets


# the host functions of a warm mask (gradientscores_cmd), timed apart in
# phase 6c: the query planes (their device work ends in the row vector's
# copy), the plane cache's lookups, G1's launch with the table of its
# cached pointers, and the row sums' copy to the host (which waits for G1)
HOST_SPLIT = ("_build_qplanes", "_prefetch_planes", "shape_rows_cached",
              "finish_shape_scores")


# each kernel's function names in the profiler's records (G2: the compiled
# footprints' kernel and the partials' combine, or the generic kernel)
SHAPE_SYMBOLS = {"shape_rows": ("shape_rows_kernel",),
                 "dilate_rgb": ("ring_kernel", "combine_kernel",
                                "dilate_kernel"),
                 "query_planes": ("query_kernel",),
                 "target_planes": ("target_kernel",)}


def ptxas_report(libs, symbols=SHAPE_SYMBOLS):
    """{kernel: {registers, spill_stores, spill_loads}} of the shape
    kernels, from the libraries' nvcc logs (-Xptxas -v); a template
    kernel is named with its arguments (ring_kernel<101, 0>: r = 10's
    footprint, one group)."""
    import re
    wanted = [sym for syms in symbols.values() for sym in syms]
    out, entry, cur = {}, None, None
    for kl in libs.values():
        for line in kl.build_log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                name = next((w for w in wanted if w in mangled), None)
                if name and "ILi" in mangled:
                    args = mangled[mangled.find("ILi") + 3:
                                   mangled.find("EE")]
                    name += "<" + args.replace("ELb", ", ") + ">"
                entry = (mangled, name) if name else None
            elif "Function properties for" in line:
                cur = entry[1] if entry and entry[0] in line else None
            elif cur and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill", line)
                out.setdefault(cur, {}).update(spill_stores=int(st),
                                               spill_loads=int(ld))
            elif entry and "Used" in line and "registers" in line:
                out.setdefault(entry[1], {})["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    return out


def profiled_ms(fn, symbols, reps=5, sessions=3):
    """Device milliseconds per fn() call in the kernels whose name holds
    one of `symbols`, by torch.profiler over `reps` calls after a warm-up:
    the kernels' time without their wrapper's host work. A session whose
    trace holds no record of them (CUPTI drops one now and then) is taken
    again, up to `sessions` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = sum(t for k, (t, _) in device_kernel_ms(prof).items()
                 if any(sym in k for sym in symbols))
        if ms > 0:
            return ms / reps
    raise SystemExit(f"the profiler saw no device time in {symbols} in "
                     f"{sessions} sessions")


def host_split(gc, fn):
    """Run fn() once, from an idle card; its wall seconds, split into the
    seconds spent in each of gradientscores_cmd's HOST_SPLIT functions
    and the rest."""
    import torch
    spent = dict.fromkeys(HOST_SPLIT, 0.0)
    saved = {name: getattr(gc, name) for name in HOST_SPLIT}

    def timed(name, f):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
        return run

    torch.cuda.synchronize()
    for name, f in saved.items():
        setattr(gc, name, timed(name, f))
    try:
        t0 = time.perf_counter()
        fn()
        total = time.perf_counter() - t0
    finally:
        for name, f in saved.items():
            setattr(gc, name, f)
    spent["rest"] = total - sum(spent.values())
    return {"total_s": round(total, 6),
            **{k: round(v, 6) for k, v in spent.items()}}


def shape_bounds(n, h, w, rows, batch, mode):
    """{kernel: (ops_ms, bytes_ms)} of gradientScores' four kernels on
    phase 6c's shapes: each input read once and each output written once
    at the memory rate; G2 also its operations (two byte-quad maxima per
    footprint row and output pixel, one per doubling level above the
    first and input pixel) at the lane rate. n frames of h x w; G1 over
    `batch` targets in a band of `rows` rows."""
    from colormipsearch_torch.cds import lut
    from colormipsearch_torch.imageproc.filters import make_line_radii
    table = lut.slice_number_table().nbytes
    px = h * w

    def dilate(frames, radius, thr):
        ext = make_line_radii(radius)
        levels = int(2 * ext.max() + 1).bit_length()
        ops = frames * px * (2 * len(ext) + levels - 1)
        return (1e3 * ops / PEAK_LANE_OPS,
                1e3 * (frames * px * 6 + px) / PEAK_BYTES)

    out = {"shape_rows": (0.0, 1e3 * (rows * w * (5 + 6 * batch)
                                      + 16 * batch * rows + 32 * batch)
                          / PEAK_BYTES),
           "query_planes": (0.0, 1e3 * (px * 15 + h + table) / PEAK_BYTES),
           # CDM 3, 16-bit gradient 2, z-gap 3 B/px read; planes 6 written
           "target_planes": (0.0, 1e3 * (n * px * 14 + px + table)
                             / PEAK_BYTES),
           "dilate_rgb": dilate(n, 10.0, 20),
           "query_dilations": tuple(a + b for a, b in zip(
               dilate(1, 60.0, None), dilate(1, 20.0, None)))}
    if mode == "file":
        del out["dilate_rgb"]
    return out


def shape_edges(checks, dev):
    """G1 and G2 against their plain versions where their designs break
    (tests/test_torch_cuda.py holds the same cases): G2 at the compiled
    radii and two generic ones, every prologue, widths 1-1211, heights 1,
    7, k, 2k + 1, the ring's stage and group sizes +- 1 and 566, 1, 2 and 5
    frames, frames that are not 16-byte aligned; G1 at widths 1-1211,
    bands from odd and even rows, 1-128 targets, both orientations and
    flipped z planes, through plane lists and cached pointers. Returns
    the number of cases."""
    import torch
    from colormipsearch_torch.cds import shape_device as sd
    from colormipsearch_torch.cds import shape_kernel as sk
    from colormipsearch_torch.cds.shape_oracle import TargetShapePlanes
    from colormipsearch_torch.imageproc.filters import make_line_radii
    rng = np.random.default_rng(12)
    cases = 0
    for radius in (10.0, 20.0, 60.0, 5.0, 30.0):
        k = len(make_line_radii(radius)) // 2
        shapes = [(1, 1, 1, 0), (2, 7, 15, 0), (1, k, 16, 0),
                  (1, 2 * k + 1, 17, 0), (5, 20, 33, 0), (1, 21, 1211, 0),
                  (1, 22, 1210, 0), (2, 3, 130, 0), (1, 5, 257, 0),
                  (2, 9, 45, 1), (1, 566, 1210, 0)]
        for prologue in ("none", "excluded", "excluded+thr"):
            for n_t, h, w, offset in shapes:
                x = rng.integers(0, 256, (n_t + offset, h, w, 3),
                                 dtype=np.uint8)
                x[rng.random((n_t + offset, h, w)) < 0.97] = 0
                x[x == 19] = 20
                x = torch.from_numpy(x).to(dev)[offset:]
                ex = (torch.from_numpy(rng.random((h, w)) < 0.2).to(dev)
                      if prologue != "none" else None)
                thr = 20 if prologue == "excluded+thr" else None
                check_shape(
                    checks, "dilate_rgb", f"edge r = {radius:g}, "
                    f"{prologue}, {n_t} x {h} x {w}"
                    + (", unaligned" if offset else ""),
                    lambda: sd.dilate_rgb(x, radius, excluded=ex, thr=thr),
                    lambda: sd.dilate_rgb_plain(
                        sd.dilate_input_plain(x, ex, thr), radius))
                cases += 1
    for n_t, h, w, r0, r1 in [(1, 1, 1, 0, 1), (5, 7, 15, 1, 6),
                              (5, 9, 16, 2, 9), (1, 6, 17, 3, 4),
                              (128, 12, 33, 1, 12), (9, 10, 1210, 3, 9),
                              (128, 8, 1211, 2, 7), (5, 566, 1210, 0, 566)]:
        q = [torch.from_numpy(a).to(dev) for a in (
            rng.random((h, w)) < 0.6,
            rng.integers(0, 257, (h, w)).astype(np.int16),
            rng.random((h, w)) < 0.5, rng.random((h, w)) < 0.3)]
        stacks = [torch.from_numpy(a).to(dev) for a in (
            rng.random((n_t, h, w)) < 0.4,
            rng.integers(0, 65536, (n_t, h, w)).astype(np.uint16).view(
                np.int16),
            rng.random((n_t, h, w)) < 0.6,
            rng.integers(0, 257, (n_t, h, w)).astype(np.int16))]
        lists = [[p.clone() if i % 3 == 1 else p
                  for i, p in enumerate(x.unbind(0))] for x in stacks]
        entries = [sk.CheckedPlanes(TargetShapePlanes(*(x[i] for x in lists)))
                   for i in range(n_t)]
        for mirror, flip_z in ((True, False), (False, False), (False, True)):
            kw = dict(r0=r0, r1=r1, mirror=mirror, flip_z=flip_z)
            label = f"edge {n_t} x {h} x {w}, rows {r0}-{r1}, mirror " \
                    f"{mirror}, flip_z {flip_z}"
            check_shape(checks, "shape_rows", label + ", plane lists",
                        lambda: sk.shape_rows(*q, *lists, **kw),
                        lambda: sk.shape_rows_plain(*q, *lists, **kw))
            check_shape(checks, "shape_rows", label + ", cached pointers",
                        lambda: sk.shape_rows_cached(*q, entries, **kw),
                        lambda: sk.shape_rows_plain(*q, *lists, **kw))
            cases += 2
    return cases


def phase_gradient_at_size(checks, dev, ws, n_targets=128, batch=128):
    """(c) The two gradient configurations of bench.py through the port's
    score_mask_partitions at the full frame, through G1-G4: cold decode
    and device plane build, warm matches/s and a warm mask's host time
    split (HOST_SPLIT), peak device memory, host-path plane builds (none,
    and one G3 launch per mask built on the card), mask 0's scores equal
    to a --device cpu run; each kernel against its plain version at size,
    its device ms (torch.profiler) and its ms per call with the wrapper's
    host work and its plain version's (CUDA events) beside its bound, and
    the plane builds' ms. Returns (report, {kernel: timing}) with
    the kernels' launches on these main-path runs, both configurations."""
    import torch
    from colormipsearch_torch.cds import shape_device as sd
    from colormipsearch_torch.cds import shape_kernel as sk
    from colormipsearch_torch.cmd import gradientscores_cmd as gc
    from colormipsearch_torch.imageproc.io import image_from_array
    from colormipsearch_torch.mips import MIPsCache
    from colormipsearch_torch.model import CDMatchEntity, EMNeuronEntity
    from colormipsearch_torch.scripts.op_microbench import cuda_ms
    query = load_rgb(os.path.join(FIXTURES, "ems", "12191_JRC2018U.tif"))
    h, w = query.shape[:2]
    excluded = label_regions(h, w)
    mask_img = image_from_array(query)
    counters = shape_wrappers()
    launches = dict.fromkeys(counters, 0)
    report, timing = {}, {}
    for config, zgap_files in (("production", True), ("otf", False)):
        targets = target_library(ws, n_targets, zgap_files)
        mode = "file" if zgap_files else "otf"
        args = argparse.Namespace(
            maskThreshold=20, mirrorMask=True,
            computeZGapOnTheFly=not zgap_files, targetsPerBatch=batch,
            planes_threads=0)

        def run_mask(mi, cache, planes_cache, device):
            em = EMNeuronEntity(entity_id=1000 + mi, mip_id=f"em-{mi}")
            matches = []
            for t in targets:
                m = CDMatchEntity()
                m.mask_image, m.matched_image = em, t
                matches.append(m)
            t0 = time.perf_counter()
            qplanes = gc._build_qplanes(mask_img, excluded, None, 0, device)
            scored = gc.score_mask_partitions(matches, qplanes, cache, args,
                                              excluded, planes_cache)
            if len(scored) != n_targets:
                raise SystemExit(f"{config}: {len(scored)} of {n_targets} "
                                 f"targets scored")
            return ([(m.gradient_area_gap, m.high_expression_area)
                     for m in scored], time.perf_counter() - t0, qplanes)

        # the main path: counted from 0 just before, read just after
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        cold_s, warm_rates, host_builds, masks = [], [], 0, 0
        # cold passes: fresh image and plane caches (production: one;
        # on the fly: three reps, as bench.py runs them)
        for _ in range(1 if zgap_files else 3):
            planes_cache = gc.PlaneCache(dev)
            planes_cache.sync = True
            cache = MIPsCache(4096)
            scores0, dt, qplanes = run_mask(0, cache, planes_cache, dev)
            masks += 1
            host_builds += planes_cache.host_builds
            cold_s.append((dt, dict(planes_cache.seconds)))
        # warm masks: the plane cache hits; each one's host time split
        planes_cache.sync = False
        splits = []
        for mi in range(1, 4 if zgap_files else 3):
            out = {}
            splits.append(host_split(gc, lambda: out.setdefault(
                "run", run_mask(mi, cache, planes_cache, dev))))
            got, dt, _ = out["run"]
            masks += 1
            if got != scores0:
                raise SystemExit(f"{config}: mask {mi} scored differently")
            warm_rates.append(n_targets / dt)
        peak = torch.cuda.max_memory_allocated(dev)
        ran = {name: fn.launches for name, fn in counters.items()}
        for name, n in ran.items():
            launches[name] += n
        if host_builds:
            raise SystemExit(f"{config}: {host_builds} target plane sets "
                             f"were built on the host")
        if ran["query_planes"] != masks or not all(ran.values()):
            raise SystemExit(f"{config}: {masks} masks, launches {ran}: "
                             f"query planes built on the host, or a kernel "
                             f"of the path did not run")
        # the same batch on the CPU
        t0 = time.perf_counter()
        cpu_scores, _, _ = run_mask(0, MIPsCache(4096),
                                    gc.PlaneCache("cpu"), torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        if cpu_scores != scores0:
            bad = [i for i, (a, b) in enumerate(zip(scores0, cpu_scores))
                   if a != b]
            raise SystemExit(f"{config}: mask 0's scores on the card differ "
                             f"from the CPU's at {bad[:8]}")

        # each kernel against its plain version at size, then timed
        tplanes = [planes_cache.get(t.entity_id) for t in targets[:batch]]
        lists = [[getattr(p, n) for p in tplanes]
                 for n in ("t_above", "grad", "z_nonzero", "z_slice")]
        q = [qplanes.q_nonzero, qplanes.q_slice, qplanes.q_mask,
             qplanes.high_expr]
        r0, r1 = qplanes.active_row_range()
        raws = [gc._decode_raw(t, cache, args) for t in targets[:batch]]
        cdm_d = torch.from_numpy(np.stack([r[0] for r in raws])).to(dev)
        grad_d = torch.from_numpy(np.stack([r[1][0] for r in raws]
                                           ).view(np.int16)).to(dev)
        ex_d = torch.from_numpy(excluded).to(dev)
        query_d = torch.from_numpy(query).to(dev)
        # G1 as the path calls it: the cache's checked planes and pointers
        entries = [planes_cache.entry(t.entity_id) for t in targets[:batch]]
        fns = {"shape_rows": (
            lambda: sk.shape_rows_cached(*q, entries, r0=r0, r1=r1,
                                         mirror=True),
            lambda: sk.shape_rows_plain(*q, *lists, r0=r0, r1=r1,
                                        mirror=True))}
        if zgap_files:
            z_d = torch.from_numpy(np.stack([r[2] for r in raws])).to(dev)
            dil = {r: sd.dilate_rgb(query_d[None], r, excluded=ex_d)[0]
                   for r in (60.0, 20.0)}
            fns["query_dilations"] = (
                lambda: [sd.dilate_rgb(query_d[None], r, excluded=ex_d)
                         for r in (60.0, 20.0)],
                lambda: [sd.dilate_rgb_plain(sd.dilate_input_plain(
                    query_d[None], ex_d), r) for r in (60.0, 20.0)])
            fns["query_planes"] = (
                lambda: sd.query_planes(query_d, ex_d, dil[60.0], dil[20.0],
                                        0),
                lambda: sd.query_planes_plain(query_d, ex_d, dil[60.0],
                                              dil[20.0], 0))
        else:
            fns["dilate_rgb"] = (
                lambda: sd.dilate_rgb(cdm_d, 10.0, excluded=ex_d, thr=20),
                lambda: sd.dilate_rgb_plain(sd.dilate_input_plain(
                    cdm_d, ex_d, 20), 10.0))
            z_d = fns["dilate_rgb"][0]()
        fns["target_planes"] = (
            lambda: stacked_sets(sd.target_planes(
                cdm_d, grad_d, z_d, ex_d, thr=20, grad_is_rgb=False)),
            lambda: sd.target_planes_plain(cdm_d, grad_d, z_d, ex_d, thr=20,
                                           grad_is_rgb=False))
        # G4 is timed as the path calls it, without the check's stack
        launch_only = {"target_planes": lambda: sd.target_planes(
            cdm_d, grad_d, z_d, ex_d, thr=20, grad_is_rgb=False)}
        bounds = shape_bounds(batch, h, w, r1 - r0, batch, mode)
        measured = {}
        for name, (kernel_fn, plain_fn) in fns.items():
            check_shape(checks, "dilate_rgb" if name == "query_dilations"
                        else name, f"{config} at size", kernel_fn, plain_fn)
            ops_ms, bytes_ms = bounds[name]
            call = launch_only.get(name, kernel_fn)
            measured[name] = {
                "ms": profiled_ms(call, SHAPE_SYMBOLS.get(
                    name, SHAPE_SYMBOLS["dilate_rgb"])),
                "call_ms": cuda_ms(call, 5),
                "plain_ms": cuda_ms(plain_fn, 3),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                "library_ms": None}
            measured[name]["share"] = (measured[name]["bound_ms"]
                                       / measured[name]["ms"])
        # G1 through plain tensor lists (a check and a pointer per plane)
        lists_fn = (lambda: sk.shape_rows(*q, *lists, r0=r0, r1=r1,
                                          mirror=True))
        check_shape(checks, "shape_rows", f"{config} at size, plane lists",
                    lists_fn, fns["shape_rows"][1])
        measured["shape_rows"]["lists_call_ms"] = cuda_ms(lists_fn, 5)
        zgap_in = z_d if zgap_files else None
        build_ms = cuda_ms(lambda: sd.build_target_plane_sets(
            cdm_d, grad_d, zgap_in, ex_d, thr=20, zgap_mode=mode,
            grad_is_rgb=False, device=dev), 3)
        query_ms = cuda_ms(lambda: sd.build_query_planes(
            query_d, ex_d, 0, device=dev), 5)
        for name in SHAPE_KERNELS:
            if name in measured and name not in timing:
                timing[name] = measured[name]
        report[config] = {
            "targets": n_targets, "batch": batch, "frame": [h, w],
            "row_band": [r0, r1],
            "cold_s_per_target": [round(dt / n_targets, 6)
                                  for dt, _ in cold_s],
            "cold_decode_s_per_target": [round(s["decode"] / n_targets, 6)
                                         for _, s in cold_s],
            "cold_planes_s_per_target": [round(s["planes"] / n_targets, 6)
                                         for _, s in cold_s],
            "warm_matches_per_s": [round(r, 1) for r in warm_rates],
            "warm_mask_host_split_s": splits,
            "kernels": {k: {kk: (round(vv, 4) if isinstance(vv, float)
                                 else vv) for kk, vv in v.items()}
                        for k, v in measured.items()},
            "build_target_planes_ms_per_batch": round(build_ms, 4),
            "build_query_planes_ms": round(query_ms, 4),
            "launches": ran,
            "peak_device_gib": round(peak / 2**30, 3),
            "host_plane_builds": host_builds,
            "cpu_run_s": round(cpu_s, 2),
            "mask0_head": scores0[:3],
        }
        log(f"[phase 6c] {config}: " + json.dumps(report[config]))
    for name, n in launches.items():
        timing[name]["launches"] = n
    t0 = time.perf_counter()
    report["edge_cases"] = shape_edges(checks, dev)
    log(f"[phase 6c] G1 and G2 == their plain versions at "
        f"{report['edge_cases']} edge shapes "
        f"({time.perf_counter() - t0:.1f}s)")
    return report, timing


# ---- phase 7 ---------------------------------------------------------------

def golden_library():
    """The golden mask 12191 with its label regions and the three golden
    LM frames."""
    query = load_rgb(os.path.join(FIXTURES, "ems", "12191_JRC2018U.tif"))
    targets = np.stack([load_rgb(os.path.join(FIXTURES, "lms", f"{n}.tif"))
                        for n in LM_GOLDEN])
    return query, targets, label_regions(*query.shape[:2])


def phase_dense_fixtures(dev):
    """(a) The dense engine on the card against its CPU run on the golden
    fixtures: 439 / 414 / 426, the last mirrored."""
    import torch
    from colormipsearch_torch.cds.pixel_kernel import PixelMatchEngine
    query, targets, excluded = golden_library()
    eng = PixelMatchEngine(query, 20, True, 20, 1.0, 2, excluded)
    t0 = time.perf_counter()
    got = eng.score_batch(targets, dev)
    card_s = time.perf_counter() - t0
    want = eng.score_batch(targets, torch.device("cpu"))
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("dense engine: the card's scores differ from the "
                         "CPU's on the fixtures")
    goldens = (got[0].tolist(), got[2].tolist())
    log(f"[phase 7a] dense engine on the fixtures: card == CPU, scores "
        f"{goldens[0]}, mirrored {goldens[1]} ({card_s:.2f}s on the card)")
    if goldens != ([439, 414, 426], [False, False, True]):
        raise SystemExit(f"dense engine goldens wrong: {goldens}")
    return {"scores": goldens[0], "mirrored": goldens[1]}


def phase_dense_at_size(dev, library, n_masks=8, n_targets=256):
    """(b) The dense engine at the full frame, 8 masks x 256 targets of
    phase 4's library, equal on every pair to the two-phase path without a
    screen; its ms and peak memory, and its bound from the evaluations
    the word kernel's launch over the same pairs needs (kernel_work)."""
    import torch
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_kernel import (DENSE_CHUNK_ELEMS,
                                                       pack_targets,
                                                       pixel_match_packed)
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    engines = library["engines"][:n_masks]
    targets = np.concatenate(library["parts"])[:n_targets]
    eng0 = engines[0]
    q = torch.from_numpy(np.stack([e.planes.words for e in engines])).to(dev)
    t_dev = torch.from_numpy(targets).to(dev)
    (tp, tf), pack_ms = event_ms(lambda: pack_targets(t_dev, 20, 2))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    runs = [event_ms(lambda: pixel_match_packed(q, tp, tf, eng0.shifts,
                                                eng0.zt9, True))
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated(dev) - base
    scores, mirrored = runs[0][0]
    dense_ms = [ms for _, ms in runs]
    want_s, want_m = TwoPhaseSweep(engines, [dev]).sweep(targets)
    if not (np.array_equal(scores.cpu().numpy(), want_s)
            and np.array_equal(mirrored.cpu().numpy(), want_m)):
        raise SystemExit("dense engine != two-phase path without a screen "
                         "at size")
    # the bound: the word kernel's work over every pair (no screen), as
    # kernel_work counts it from the launch's own table
    words = eng0.pack_raw_words(targets, dev)
    scorer = mm.MultiMaskScorer([e.with_predicate("words") for e in engines])
    tab = scorer.build_table(np.ones((n_masks, n_targets), np.int32),
                             mm.signal_ranges_from_words(words),
                             mm.tile_live_from_words(words))
    work = kernel_work(scorer, tab)
    h, w = targets.shape[1:3]
    out = {"masks": n_masks, "targets": n_targets, "frame": [h, w],
           "pack_ms": round(pack_ms, 3),
           "ms": [round(ms, 3) for ms in dense_ms],
           "peak_device_gib": round(peak / 2**30, 3),
           "chunk_elems": DENSE_CHUNK_ELEMS,
           "dense_evaluations": n_masks * n_targets * h * w * 2
           * len(eng0.shifts),
           "needed_evaluations": work["evals_dir"],
           "bound_ms": round(work["bound_ms"], 4),
           "bound_by": work["bound_by"],
           "share_of_bound": round(work["bound_ms"] / min(dense_ms), 6)}
    log(f"[phase 7b] dense engine, {n_masks} masks x {n_targets} targets "
        f"at {h}x{w}: == two-phase path without a screen on all "
        f"{n_masks * n_targets} pairs; " + json.dumps(out))
    return out


def phase_two_shards(dev, library):
    """(c) TwoPhaseSweep over [dev, dev] on phase 4's library, on each
    predicate's kernel, equals the one-card run on every pair; pairs/s of
    both, in turns (one, two, two, one); over every card too where the
    machine has more than one. Each round's kernel launches are counted
    from 0: the predicate's own kernel launches once per device slot and
    partition, the other kernel never."""
    import torch
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    parts = library["parts"]
    wrappers = {p: fns[0] for p, fns in mm.PREDICATE_KERNELS.items()}
    layouts = {"one card": [dev], "two shards": [dev, dev]}
    if torch.cuda.device_count() > 1:
        layouts["every card"] = [torch.device("cuda", i) for i in
                                 range(torch.cuda.device_count())]
    engines = {"ratio": library["engines"], "words": library["words_engines"]}
    pairs = len(library["engines"]) * sum(len(p) for p in parts)
    order = ["one card", "two shards", "two shards", "one card"]
    order += ["every card"] * 2 if "every card" in layouts else []
    rates, launches = {}, {}
    for pred, other in (("ratio", "words"), ("words", "ratio")):
        sweeps = {k: TwoPhaseSweep(engines[pred], devs, library["screen"],
                                   library["u_matrix"], library["thr"])
                  for k, devs in layouts.items()}
        walls = {k: [] for k in sweeps}
        for name in order:
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            out = list(sweeps[name].sweep_parts(enumerate(parts)))
            for d in layouts[name]:
                torch.cuda.synchronize(d)
            walls[name].append(time.perf_counter() - t0)
            count = {p: fn.launches for p, fn in wrappers.items()}
            want = len(layouts[name]) * len(parts)
            launches[f"{pred}, {name}"] = count[pred]
            if count[pred] != want or count[other] != 0:
                raise SystemExit(f"TwoPhaseSweep over {name} ({pred}): "
                                 f"launches {count}, expected {want} of "
                                 f"{pred} and none of {other}")
            got = (np.concatenate([s for _, s, _ in out], axis=1),
                   np.concatenate([m for _, _, m in out], axis=1))
            if not all(np.array_equal(a, b)
                       for a, b in zip(got, library["result"])):
                raise SystemExit(f"TwoPhaseSweep over {name} ({pred}) != "
                                 f"the one-card run")
        rates[pred] = {k: [round(pairs / w, 1) for w in ws]
                       for k, ws in walls.items()}
    log(f"[phase 7c] TwoPhaseSweep == the one-card run on all {pairs} pairs "
        f"over " + ", ".join(layouts) + " on both predicates; kernel "
        f"launches per round (one per device slot and partition, none of "
        f"the other predicate's kernel): " + json.dumps(launches)
        + "; pipelined rounds, pairs/s: " + json.dumps(rates))
    return {"pairs": pairs, "launches": launches, "pairs_per_s": rates}


def run_ranks(argvs, envs, timeout=600):
    """One `python argv...` subprocess per entry, from the repo root, all
    started together; each is killed at `timeout`. Fails unless every one
    exits 0; returns [(exit code, output)]."""
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, env in zip(argvs, envs)]
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    for r, (rc, text) in enumerate(out):
        if rc != 0:
            raise SystemExit(f"process {r} of {len(out)} exited {rc}:\n"
                             f"{text[-3000:]}")
    return out


def rank_envs(n=2, group=True):
    """Environments of n processes: a gloo group on the loopback interface
    (group), or the grid variables CMS_PROCESS_ID and CMS_PROCESS_COUNT."""
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = {k: v for k, v in os.environ.items() if not k.startswith(
        ("CMS_COORDINATOR", "CMS_NUM_PROCESSES", "CMS_PROCESS_"))}
    base.update(OMP_NUM_THREADS="4", GLOO_SOCKET_IFNAME="lo")
    if group:
        return [dict(base, CMS_COORDINATOR=f"127.0.0.1:{port}",
                     CMS_NUM_PROCESSES=str(n), CMS_PROCESS_ID=str(r))
                for r in range(n)]
    return [dict(base, CMS_PROCESS_ID=str(r), CMS_PROCESS_COUNT=str(n))
            for r in range(n)]


def mask_results(path):
    with open(path) as f:
        return {r["image"]["mipId"]: r for r in json.load(f)["results"]}


CDS_ARGS = ["--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
            "--device", "cuda"]
GRAD_ARGS = ["--maskThreshold", "20", "--mirrorMask",
             "--computeZGapOnTheFly", "--device", "cuda"]
CDS_GOLDENS = [("lm-0", 439, False), ("lm-1", 414, False), ("lm-2", 426, True)]

# one rank of a two-process group: the two-phase sweep of its block of
# every partition of phase 4's library (argv: masks, targets, partition
# size, device), gathered (the CLI's --jax-distributed path), twice per
# predicate, the ranks starting each round together; each rank prints
# its own kernel launches per predicate (counted from 0 before the
# predicate's rounds) and rank 0 writes the gathered grids and the
# rounds' seconds to argv[5]
GATHER_WORKER = """
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from colormipsearch_torch.cds import multimask as mm
from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
from colormipsearch_torch.cds.prescreen import PairPrescreen
from colormipsearch_torch.cmd.colordepthsearch_cmd import _gathered_parts
from colormipsearch_torch.parallel import multihost as mh
from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep

n_masks, n_targets, part = (int(a) for a in sys.argv[1:4])
device, out = torch.device(sys.argv[4]), sys.argv[5]
assert mh.maybe_init_distributed()
try:
    masks, targets, h, w = cs.adversarial_library(n_masks, n_targets)
    excluded = cs.label_regions(h, w)
    with ThreadPoolExecutor(max_workers=4) as pool:
        engines = list(pool.map(lambda m: ActiveTilePixelEngine(
            m, 20, True, 20, 1.0, 2, excluded), masks))
    screen = PairPrescreen(engines[0].zt9, 2, h, w)
    u = np.stack([screen.query_features(e.planes.words) for e in engines])
    thr = np.maximum(0.01 * np.array([e.tiles.query_size for e in engines]),
                     0.5)
    parts = [(i, targets[i:i + part]) for i in range(0, n_targets, part)]
    wrappers = {p: fns[0] for p, fns in mm.PREDICATE_KERNELS.items()}
    saved, launches = {}, {}
    for pred in ("ratio", "words"):
        sweep = TwoPhaseSweep([e.with_predicate(pred) for e in engines],
                              [device], screen, u, thr)
        for fn in wrappers.values():
            fn.launches = 0
        seconds = []
        for _ in range(2):
            mh.gather_objects(None)  # both ranks start the round together
            t0 = time.perf_counter()
            got = list(_gathered_parts(sweep, parts, {}))
            seconds.append(time.perf_counter() - t0)
        launches[pred] = {p: fn.launches for p, fn in wrappers.items()}
        saved[f"{pred}_scores"] = np.concatenate([s for _, s, _ in got], 1)
        saved[f"{pred}_mirrored"] = np.concatenate([m for _, _, m in got], 1)
        saved[f"{pred}_seconds"] = np.array(seconds)
    if mh.process_index() == 0:
        np.savez(out, **saved)
    print("LAUNCHES " + json.dumps({"rank": mh.process_index(),
                                    "rounds": 2, "parts": len(parts),
                                    **launches}), flush=True)
finally:
    mh.shutdown_distributed()
"""


def phase_two_processes(ws, dev, library, n_masks=256):
    """(d) Two processes on the card: colorDepthSearch --jax-distributed
    with both engines (process 0 alone writes: the goldens); the grid of
    both commands (--process-count 2: the union of colorDepthSearch's two
    -od holds the goldens, gradientScores' shared -md holds
    21365/33884/40696); and rank 0's gathered two-phase grid over
    n_masks x 512 targets of phase 4's library on both predicates, equal
    to the one-process run's, each rank's own kernel launches (its
    predicate's kernel once per partition and round, the other's never),
    and the pairs/s of its rounds beside those of one process running the
    CLI's pipelined partition loop (before and after)."""
    import shutil

    import torch
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    cds = ["-m", "colormipsearch_torch", "colorDepthSearch",
           "-m", os.path.join(ws, "masks.json"),
           "-i", os.path.join(ws, "targets.json"), *CDS_ARGS]
    report = {}
    for engine in ("pallas", "dense"):
        od = os.path.join(ws, f"mp_{engine}")
        t0 = time.perf_counter()
        runs = run_ranks([cds + ["--engine", engine, "--jax-distributed",
                                 "-od", od]] * 2, rank_envs())
        res = mask_results(os.path.join(od, "masks", "em-12191.json"))
        got = [(k, res[k]["matchingPixels"], res[k]["mirrored"])
               for k in sorted(res)]
        sessions = [n for n in os.listdir(od) if n.startswith("cdsSession")]
        key = f"distributed_{engine}_s"
        report[key] = round(time.perf_counter() - t0, 2)
        log(f"[phase 7d] colorDepthSearch --jax-distributed --engine "
            f"{engine}, two processes: process 0's goldens {got}, "
            f"{len(sessions)} session file ({report[key]}s)")
        if got != CDS_GOLDENS or len(sessions) != 1 \
                or "results written by process 0" not in runs[1][1]:
            raise SystemExit(f"--jax-distributed --engine {engine}: {got}, "
                             f"sessions {sessions}")
    # the grid: one -od per colorDepthSearch process, then gradientScores
    # over one -md holding the union
    t0 = time.perf_counter()
    ods = [os.path.join(ws, f"grid{r}") for r in range(2)]
    run_ranks([cds + ["-od", od] for od in ods], rank_envs(group=False))
    union = {}
    for od in ods:
        union.update(mask_results(os.path.join(od, "masks",
                                               "em-12191.json")))
    got = [(k, union[k]["matchingPixels"], union[k]["mirrored"])
           for k in sorted(union)]
    log(f"[phase 7d] colorDepthSearch grid of two processes: the union of "
        f"their files {got}")
    if got != CDS_GOLDENS:
        raise SystemExit(f"colorDepthSearch grid: {got}")
    grad_md = os.path.join(ws, "grid_md")
    shutil.copytree(os.path.join(ods[0], "masks"), grad_md)
    path = os.path.join(grad_md, "em-12191.json")
    with open(path) as f:
        doc = json.load(f)
    doc["results"] = list(union.values())
    with open(path, "w") as f:
        json.dump(doc, f)
    runs = run_ranks([["-m", "colormipsearch_torch", "gradientScores", "-md",
                       grad_md, *GRAD_ARGS]] * 2, rank_envs(group=False))
    res = mask_results(path)
    gaps = [(k, res[k]["gradientAreaGap"]) for k in sorted(res)]
    owned = [("owns 1 masks" in t, "owns 0 masks" in t) for _, t in runs]
    report["grid_s"] = round(time.perf_counter() - t0, 2)
    log(f"[phase 7d] gradientScores grid of two processes over one -md: "
        f"{gaps}; (owns 1, owns 0) {owned} ({report['grid_s']}s for both "
        f"grids)")
    if gaps != [("lm-0", 21365), ("lm-1", 33884), ("lm-2", 40696)] \
            or owned != [(True, False), (False, True)]:
        raise SystemExit(f"gradientScores grid: {gaps}, {owned}")
    # rank 0's gathered grid at size on both predicates, against one
    # process's pipelined partition loop (the CLI's, sweep_parts)
    parts = library["parts"]
    one = TwoPhaseSweep(library["engines"][:n_masks], [dev],
                        library["screen"], library["u_matrix"][:n_masks],
                        library["thr"][:n_masks])
    pairs = n_masks * sum(len(p) for p in parts)

    def one_process_rate():
        t0 = time.perf_counter()
        list(one.sweep_parts(enumerate(parts)))
        torch.cuda.synchronize(dev)
        return round(pairs / (time.perf_counter() - t0), 1)

    rates = {"one_process_ratio": [one_process_rate()]}
    out = os.path.join(ws, "gathered.npz")
    t0 = time.perf_counter()
    runs = run_ranks([["-c", GATHER_WORKER, str(n_masks),
                       str(sum(len(p) for p in parts)), str(len(parts[0])),
                       str(dev), out]] * 2, rank_envs())
    report["gathered_s"] = round(time.perf_counter() - t0, 2)
    rates["one_process_ratio"].append(one_process_rate())
    got = np.load(out)
    scores, mirrored = library["result"]
    same = {pred: (np.array_equal(got[f"{pred}_scores"], scores[:n_masks])
                   and np.array_equal(got[f"{pred}_mirrored"],
                                      mirrored[:n_masks]))
            for pred in ("ratio", "words")}
    # each rank's own launches: one per partition and round of its
    # predicate's kernel, none of the other's
    launches = []
    for r, (_, text) in enumerate(runs):
        line = [x for x in text.splitlines() if x.startswith("LAUNCHES ")]
        rank = json.loads(line[-1][len("LAUNCHES "):]) if line else {}
        launches.append(rank)
        want = rank.get("rounds", 0) * rank.get("parts", 0)
        for pred, other in (("ratio", "words"), ("words", "ratio")):
            count = rank.get(pred, {})
            if rank.get("rank") != r or want == 0 \
                    or count.get(pred) != want or count.get(other) != 0:
                raise SystemExit(f"process {r}'s kernel launches: {rank}")
    for pred in ("ratio", "words"):
        rates[f"two_processes_{pred}"] = [
            round(pairs / x, 1) for x in got[f"{pred}_seconds"]]
    report["gathered_pairs"] = int(got["ratio_scores"].size)
    report["launches_per_rank"] = launches
    report["pairs_per_s"] = rates
    log(f"[phase 7d] two processes, each sweeping half of every partition: "
        f"rank 0's gathered {got['ratio_scores'].shape} grid == the "
        f"one-process run: {same} ({report['gathered_s']}s with start-up "
        f"and engine prep); each rank's kernel launches: "
        + json.dumps(launches) + "; pairs/s of the pipelined partition "
        "loop: " + json.dumps(rates))
    if not all(same.values()):
        raise SystemExit("the gathered two-process grid differs from the "
                         "one-process run")
    return report


def phase_gradient_slots(dev, ws, n_targets=128):
    """(e) gradientScores' score_mask_partitions over [dev, dev] (plane
    builds split between the two slots, each batch scored per slot) at
    128 targets of 566 x 1210 equals the one-device run."""
    from colormipsearch_torch.cmd import gradientscores_cmd as gc
    from colormipsearch_torch.imageproc.io import image_from_array
    from colormipsearch_torch.mips import MIPsCache
    from colormipsearch_torch.model import CDMatchEntity, EMNeuronEntity
    query = load_rgb(os.path.join(FIXTURES, "ems", "12191_JRC2018U.tif"))
    excluded = label_regions(*query.shape[:2])
    targets = target_library(ws, n_targets, True)
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=False,
                              targetsPerBatch=128, planes_threads=0)
    out, seconds = {}, {}
    for name, devs in (("one", [dev]), ("two", [dev, dev])):
        em = EMNeuronEntity(entity_id=1, mip_id="em-0")
        matches = []
        for t in targets:
            m = CDMatchEntity()
            m.mask_image, m.matched_image = em, t
            matches.append(m)
        planes_cache = gc.PlaneCache(devs)
        t0 = time.perf_counter()
        qplanes = gc._build_qplanes(image_from_array(query), excluded, None,
                                    0, dev)
        scored = gc.score_mask_partitions(matches, qplanes, MIPsCache(4096),
                                          args, excluded, planes_cache)
        seconds[name] = round(time.perf_counter() - t0, 3)
        out[name] = [(m.gradient_area_gap, m.high_expression_area)
                     for m in scored]
        slots = sorted({planes_cache.slot(t.entity_id) for t in targets})
        if slots != list(range(len(devs))) or len(scored) != n_targets:
            raise SystemExit(f"gradient over {name}: slots {slots}, "
                             f"{len(scored)} scored")
    log(f"[phase 7e] gradientScores over [dev, dev] == the one-device run "
        f"on {n_targets} targets: {out['one'] == out['two']} (cold mask: "
        f"{seconds['one']}s one slot, {seconds['two']}s two)")
    if out["one"] != out["two"]:
        raise SystemExit("gradientScores over two slots differs")
    return {"targets": n_targets, "cold_s": seconds}


# ---- phase 8 ---------------------------------------------------------------

PIPELINE_SCRIPT = os.path.join(REPO, "colormipsearch_torch", "scripts",
                               "run_full_precompute.sh")
# the stage arguments of run_full_precompute.sh
PIPELINE_CDS = ["--maskThreshold", "20", "--dataThreshold", "20",
                "--pixColorFluctuation", "1", "--xyShift", "2",
                "--mirrorMask", "--pctPositivePixels", "1",
                "--processingPartitionSize", "256"]
PIPELINE_GRAD = ["--maskThreshold", "20", "--mirrorMask", "--nBestLines",
                 "300", "--computeZGapOnTheFly"]
GAP_GOLDENS = [("lm-0", 21365), ("lm-1", 33884), ("lm-2", 40696)]
EXPORT_GOLDENS = [("lm-0", 100.0), ("lm-2", 97.04), ("lm-1", 94.31)]
# phase 8b's entity ids: mask i and target t
MASK_ID0, TARGET_ID0 = 1_000_000, 2_000_000


def file_tree(root):
    """{path relative to root: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def pipeline_chain(ws, out, device, backend):
    """The four commands of run_full_precompute.sh, with its arguments, in
    this process: over one SQLite store (backend "sqlite") or over
    per-mask JSON files ("json"). Returns the exported files."""
    from colormipsearch_torch.cmd.main import main
    cache = ["--array-cache", os.path.join(out, "array-cache")]
    if backend == "sqlite":
        store = matches = ["--db", os.path.join(out, "nb.db")]
    else:
        store = ["-od", os.path.join(out, "cds")]
        matches = ["-md", os.path.join(out, "cds", "masks")]
    export = os.path.join(out, "export")
    for argv in (["colorDepthSearch", "-m", os.path.join(ws, "masks.json"),
                  "-i", os.path.join(ws, "targets.json"), *PIPELINE_CDS,
                  *cache, *store, "--processing-tag", "cds-smoke",
                  "--device", device],
                 ["gradientScores", *matches, *PIPELINE_GRAD, *cache,
                  "--device", device],
                 ["normalizeGradientScores", *matches],
                 ["exportData", "--exported-result-type", "EM_CD_MATCHES",
                  *matches, "-od", export]):
        rc = main(argv)
        if rc != 0:
            raise SystemExit(f"{argv[0]} ({device}, {backend}) exited {rc}")
    return file_tree(export)


def ran_shape_path(launches):
    """gradientScores ran through G1-G4."""
    return all(launches[k] > 0 for k in SHAPE_KERNELS)


def ran_k1_path(launches):
    """The default path ran: the bound's kernels and K1, not K3a."""
    return launches["multimask_words"] == 0 and all(
        launches[k] > 0 for k in ("multimask_ratio", "prescreen_cells",
                                  "prescreen_capped"))


def phase_pipeline_fixtures(ws):
    """(a) The production pipeline on the golden fixtures through the
    CLI's entry points on --device cuda, over one SQLite store: the
    stored pixel scores and gaps, the exported normalized scores, the
    bound's two kernels, K1 and G1-G4 launched and K3a not (counted from 0
    just before the chain); the same chain on the CPU and on per-mask JSON
    files exports the same bytes."""
    from colormipsearch_torch.dataio import DataSourceParam
    from colormipsearch_torch.dataio.db import (DBNeuronMatchesReader,
                                                SqliteStore)
    from colormipsearch_torch.cds import kernels
    root = os.path.join(ws, "pipeline")
    seconds = {}
    t0 = time.perf_counter()
    counters = kernels.path_wrappers()
    for fn in counters.values():
        fn.launches = 0
    exported = pipeline_chain(ws, os.path.join(root, "cuda_sqlite"), "cuda",
                              "sqlite")
    launches = {name: fn.launches for name, fn in counters.items()}
    seconds["cuda_sqlite"] = round(time.perf_counter() - t0, 2)
    store = SqliteStore(os.path.join(root, "cuda_sqlite", "nb.db"))
    rows = {m.matched_image.mip_id: m
            for m in DBNeuronMatchesReader(store).read_matches_by_mask(
                DataSourceParam(mip_ids=["em-12191"]))}
    store.close()
    pixels = [(k, rows[k].matching_pixels, rows[k].mirrored)
              for k in sorted(rows)]
    gaps = [(k, rows[k].gradient_area_gap) for k in sorted(rows)]
    scores = [(r["image"]["mipId"], round(r["normalizedScore"], 2))
              for r in json.loads(exported["em-12191.json"])["results"]]
    log(f"[phase 8a] the four commands over one SQLite store on the card: "
        f"stored {pixels}, gaps {gaps}, exported normalizedScore {scores}; "
        f"kernel launches {launches} ({seconds['cuda_sqlite']}s)")
    if pixels != CDS_GOLDENS or gaps != GAP_GOLDENS \
            or scores != EXPORT_GOLDENS or list(exported) != ["em-12191.json"]:
        raise SystemExit("the pipeline's goldens are wrong")
    if not ran_k1_path(launches) or not ran_shape_path(launches):
        raise SystemExit(f"the pipeline did not run through the bound's "
                         f"kernels and K1 alone, and G1-G4: {launches}")
    for device, backend in (("cpu", "sqlite"), ("cuda", "json")):
        t0 = time.perf_counter()
        got = pipeline_chain(ws, os.path.join(root, f"{device}_{backend}"),
                             device, backend)
        seconds[f"{device}_{backend}"] = round(time.perf_counter() - t0, 2)
        log(f"[phase 8a] the chain on {device} over {backend}: exported "
            f"files == the card's SQLite chain's: {got == exported} "
            f"({seconds[f'{device}_{backend}']}s)")
        if got != exported:
            raise SystemExit(f"the {device} {backend} chain exported other "
                             f"files")
    return {"launches": launches, "seconds": seconds}


def write_pipeline_library(root, n_masks, n_targets):
    """Phase 4's masks, and targets built as phase 4's are but only from
    the three LM fixtures that have a gradient file, each target's
    gradient (and BJD's z-gap) rolled and banded with its CDM; index 0 of
    each family kept whole, so the golden pairs stay in the grid. Written
    once as packbits TIFF (CDMs, z-gap) and 16-bit PNG (gradients), with
    masks.json and targets.json. Returns the target frames."""
    from PIL import Image
    ems = sorted(os.listdir(os.path.join(FIXTURES, "ems")))
    em_px = [load_rgb(os.path.join(FIXTURES, "ems", n)) for n in ems]

    def raw(*parts):
        with Image.open(os.path.join(FIXTURES, *parts)) as img:
            return np.array(img)

    families = [{"cdm": load_rgb(os.path.join(FIXTURES, "lms",
                                              f"{name}.tif")),
                 "grad": raw("grad", f"{name}.png"),
                 "zgap": (load_rgb(os.path.join(FIXTURES, "zgap",
                                                f"{name}.tif"))
                          if os.path.exists(os.path.join(
                              FIXTURES, "zgap", f"{name}.tif")) else None)}
                for name in LM_GOLDEN]
    lib = os.path.join(root, "library")
    os.makedirs(lib)

    def save(path, px):
        img = Image.fromarray(px)
        if path.endswith(".png"):
            img.save(path, compress_level=1)
        else:
            img.save(path, compression="packbits")
        return path

    def write_mask(i):
        path = os.path.join(lib, f"em-{i:04d}.tif")
        save(path, roll_frame(em_px[i % len(em_px)], i // len(em_px)))
        return {"class": "org.janelia.colormipsearch.model.EMNeuronEntity",
                "id": str(MASK_ID0 + i), "mipId": f"em-{i:04d}",
                "alignmentSpace": "JRC2018_Unisex_20x_HR",
                "libraryName": "flyem_smoke", "publishedName": f"body{i}",
                "computeFiles": {"InputColorDepthImage": path}}

    def target_frames(t):
        k = t // len(families)
        return {kind: px if px is None or k == 0
                else band_frame(roll_frame(px, k), t)
                for kind, px in families[t % len(families)].items()}

    def write_target(t):
        frames = target_frames(t)
        files = {}
        for kind, cft, ext in (("cdm", "InputColorDepthImage", "tif"),
                               ("grad", "GradientImage", "png"),
                               ("zgap", "ZGapImage", "tif")):
            if frames[kind] is not None:
                files[cft] = save(os.path.join(lib, f"lm-{t}_{kind}.{ext}"),
                                  frames[kind])
        return frames["cdm"], {
            "class": "org.janelia.colormipsearch.model.LMNeuronEntity",
            "id": str(TARGET_ID0 + t), "mipId": f"lm-{t}",
            "alignmentSpace": "JRC2018_Unisex_20x_HR",
            "libraryName": "flylight_smoke", "publishedName": f"line{t}",
            "slideCode": f"sc-{t}", "anatomicalArea": "Brain",
            "objective": "40x", "gender": "f", "computeFiles": files}

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        masks = list(pool.map(write_mask, range(n_masks)))
        written = list(pool.map(write_target, range(n_targets)))
    for fname, ents in (("masks.json", masks),
                        ("targets.json", [e for _, e in written])):
        with open(os.path.join(root, fname), "w") as f:
            json.dump(ents, f)
    return np.stack([px for px, _ in written])


def run_logged(cmd, env, log_path, timeout):
    """Run cmd from the repo root in a session of its own, its output
    copied to log_path; the whole session is killed at `timeout`. Returns
    (exit code, [(seconds since the start, line)])."""
    import signal
    import threading
    p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)

    def kill():
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    timer = threading.Timer(timeout, kill)
    timer.start()
    lines = []
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as f:
            for line in p.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip("\n")))
                f.write(line)
        p.wait()
    finally:
        timer.cancel()
        kill()  # nothing of the session outlives the call
    return p.returncode, lines


def stage_lines(lines):
    """The script's output split at its "=== stage" headers: {stage:
    (seconds from its header to the next one, [its lines])}."""
    import re
    marks = [(t, re.sub(r"^=== (\w+).*", r"\1", ln)) for t, ln in lines
             if ln.startswith("=== ") or ln == "done"]
    out = {}
    for (t, name), (t_next, _) in zip(marks, marks[1:]):
        out[name] = (round(t_next - t, 2),
                     [ln for s, ln in lines if t <= s < t_next])
    return out


def log_numbers(pattern, lines):
    """Each match of `pattern` (one group per number) in lines, as floats."""
    import re
    return [tuple(float(g) for g in m.groups()) for m in
            (re.search(pattern, ln) for ln in lines) if m]


def store_columns(db, columns):
    """{(mask index, target index): (column values)} of every stored
    match of phase 8b's store."""
    import sqlite3
    con = sqlite3.connect(db)
    try:
        rows = con.execute(f"SELECT mask_ref, matched_ref, {columns} FROM "
                           f"cd_matches").fetchall()
    finally:
        con.close()
    return {(r[0] - MASK_ID0, r[1] - TARGET_ID0): tuple(r[2:]) for r in rows}


# phase 8b ran far over ~150 s at 1024 masks, held back by the serial
# prescreen query features of the command (PERF.md, section 5): cut to
# 256, then to 128 when phase 10 brought the script to 593 s at 256 (an
# H100 80GB HBM3 at 700 W)
PIPELINE_CUT = ("masks cut from 1024 to 128: phase 8b ran over ~150 s at "
                "1024, and the script with phase 10 came to 593 s at 256")


def phase_pipeline_at_size(ws, dev, library, n_masks=128, n_targets=512,
                           cut=PIPELINE_CUT):
    """(b) The port's run_full_precompute.sh at size: phase 4's masks
    against targets built from the gradient fixtures, one search block and
    two gradient processes sharing the card and the SQLite store, as in
    production. Every stored pixel score equals an in-memory TwoPhaseSweep
    of the same library on every pair; the golden pairs keep 439 / 414 /
    426 and 21365 / 33884 / 40696; every mask with a match has one export
    file. One gradient process over a copy of the finished store (its
    second gradient pass) gives the same rows, in its own time."""
    import shutil
    import torch
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    root = os.path.join(ws, "at_size")
    os.makedirs(root)
    report = {"masks": n_masks, "targets": n_targets, "frame": [566, 1210],
              "cut": cut}
    t0 = time.perf_counter()
    targets = write_pipeline_library(root, n_masks, n_targets)
    report["library_write_s"] = round(time.perf_counter() - t0, 2)
    env = {k: v for k, v in os.environ.items() if not k.startswith("CMS_")}
    env.update(CMS_PROCESS_COUNT="1", CMS_GA_PROCS="2")
    t0 = time.perf_counter()
    rc, lines = run_logged(["bash", PIPELINE_SCRIPT, root], env,
                           os.path.join(root, "script.log"), timeout=600)
    report["script_s"] = round(time.perf_counter() - t0, 2)
    if rc != 0:
        raise SystemExit(f"run_full_precompute.sh exited {rc}:\n" + "\n".join(
            ln for _, ln in lines[-60:]))
    stages = stage_lines(lines)
    report["stage_s"] = {k: v[0] for k, v in stages.items()}
    cds_lines, ga_lines = stages["colorDepthSearch"][1], \
        stages["gradientScores"][1]
    (found, _, cds_s), = log_numbers(
        r"found (\d+) matches \((\d+) masks\) in ([\d.]+)s", cds_lines)
    pairs = n_masks * n_targets
    report["cds_pairs_per_s"] = round(pairs / report["stage_s"][
        "colorDepthSearch"], 1)
    report["cds_command_s"] = cds_s
    report["cds_prep_s"] = log_numbers(
        r"prepared (\d+) mask engines in ([\d.]+)s", cds_lines)[0][1]
    report["cds_stage_times"] = next(
        json.loads(ln.split("stage times: ", 1)[1].replace("'", '"'))
        for ln in cds_lines if "stage times: " in ln)
    updated = log_numbers(r"updated (\d+) matches in ([\d.]+)s", ga_lines)
    report["gradient_matches"] = int(sum(n for n, _ in updated))
    report["gradient_process_s"] = [s for _, s in updated]
    report["gradient_matches_per_s"] = round(
        report["gradient_matches"] / report["stage_s"]["gradientScores"], 1)
    report["normalize_s"] = report["stage_s"]["normalizeGradientScores"]
    report["normalize_command_s"] = log_numbers(
        r"normalized \d+ matches in ([\d.]+)s",
        stages["normalizeGradientScores"][1])[0][0]
    report["export_s"] = report["stage_s"]["exportData"]
    report["export_command_s"] = log_numbers(
        r"exported \d+ matches .* in ([\d.]+)s", stages["exportData"][1])[0][0]
    report["peak_device_gib"] = {
        "colorDepthSearch": log_numbers(r"peak device memory ([\d.]+) GiB",
                                        cds_lines)[0][0],
        "gradientScores": [p for p, in log_numbers(
            r"peak device memory ([\d.]+) GiB", ga_lines)]}
    if len(updated) != 2 or len(report["peak_device_gib"][
            "gradientScores"]) != 2:
        raise SystemExit("the two gradient processes did not both finish")
    db = os.path.join(root, "nb.db")
    stored = store_columns(db, "matching_pixels, mirrored, "
                               "gradient_area_gap, high_expression_area, "
                               "normalized_score")
    report["rows_stored"] = len(stored)
    # the same library in memory through phase 4's engines
    t0 = time.perf_counter()
    sweep = TwoPhaseSweep(library["engines"][:n_masks], [dev],
                          library["screen"], library["u_matrix"][:n_masks],
                          library["thr"][:n_masks])
    swept = list(sweep.sweep_parts(
        (i, targets[i:i + 256]) for i in range(0, n_targets, 256)))
    torch.cuda.synchronize(dev)
    scores = np.concatenate([s for _, s, _ in swept], axis=1)
    mirrored = np.concatenate([m for _, _, m in swept], axis=1)
    report["reference_sweep_s"] = round(time.perf_counter() - t0, 2)
    q = np.array([e.tiles.query_size for e in library["engines"][:n_masks]])
    want = (scores > 0) & (scores / np.maximum(q, 1)[:, None] > 0.01)
    got = {pair: (pix, bool(mir)) for pair, (pix, mir, *_) in stored.items()}
    expected = {(int(i), int(t)): (int(scores[i, t]), bool(mirrored[i, t]))
                for i, t in zip(*np.nonzero(want))}
    golden = [(f"lm-{t}", *stored.get((0, t), (None,) * 3)[:3])
              for t in range(3)]
    exported = sorted(os.listdir(os.path.join(root, "export")))
    with_rows = sorted({f"em-{i:04d}.json" for i, _ in stored})
    log(f"[phase 8b] run_full_precompute.sh, {n_masks} masks x {n_targets} "
        f"targets: {len(stored)} rows stored == an in-memory TwoPhaseSweep "
        f"on every pair: {got == expected}; golden pairs (pixels, "
        f"mirrored, gap) {golden}; {len(exported)} export files for "
        f"{len(with_rows)} masks with a match")
    if got != expected:
        raise SystemExit(f"the stored pixel scores differ from the sweep's: "
                         f"{len(got)} rows, {len(expected)} expected")
    if golden != [(k, p, m, g) for (k, p, m), (_, g) in
                  zip(CDS_GOLDENS, GAP_GOLDENS)]:
        raise SystemExit(f"phase 8b's golden pairs: {golden}")
    if exported != with_rows:
        raise SystemExit("the export files do not match the masks with "
                         "matches")
    report["export_files"] = len(exported)
    # one gradient process over a copy of the finished store
    one = os.path.join(root, "one.db")
    shutil.copy(db, one)
    rc, lines = run_logged(
        [sys.executable, "-m", "colormipsearch_torch", "gradientScores",
         "--db", one, *PIPELINE_GRAD, "--array-cache",
         os.path.join(root, "array-cache"), "--device", "cuda"], env,
        os.path.join(root, "one_process.log"), timeout=600)
    if rc != 0:
        raise SystemExit(f"one gradient process exited {rc}:\n" + "\n".join(
            ln for _, ln in lines[-40:]))
    report["gradient_one_process_s"] = round(lines[-1][0], 2)
    (n_one, s_one), = log_numbers(r"updated (\d+) matches in ([\d.]+)s",
                                  [ln for _, ln in lines])
    report["gradient_one_process_matches_per_s"] = round(
        n_one / report["gradient_one_process_s"], 1)
    same = store_columns(one, "matching_pixels, mirrored, "
                              "gradient_area_gap, high_expression_area, "
                              "normalized_score") == stored
    log(f"[phase 8b] one gradient process over a copy of the store: rows == "
        f"the two processes' with the normalize pass: {same}; "
        f"{int(n_one)} matches in {report['gradient_one_process_s']}s "
        f"beside two processes' {report['stage_s']['gradientScores']}s")
    if not same or int(n_one) != report["gradient_matches"]:
        raise SystemExit("one gradient process and two disagree")
    return report


# ---- phase 9 ---------------------------------------------------------------

INGEST_LIBRARIES = {
    "flyem_smoke": ["--cdm-location", os.path.join(FIXTURES, "ems")],
    "flylight_smoke": ["--cdm-location", os.path.join(FIXTURES, "lms"),
                       "--variant", "grad:" + os.path.join(FIXTURES, "grad"),
                       "--variant", "zgap:" + os.path.join(FIXTURES, "zgap")],
}
# the two EM bodies of the PPP fixtures with their best LM match
PPP_PAIRS = [("1599747200-PFNp_c-RT_18U",
              "BJD_100A01_AE_01-20170929_62_B1_REG_UNISEX_40x"),
             ("484130600-SMP145-RT_18U",
              "BJD_105A09_AE_01-20180112_62_A2_REG_UNISEX_40x")]


def run_cli(argv, want=0):
    """One command through the port's CLI entry point, in this process."""
    from colormipsearch_torch.cmd.main import main as cli
    rc = cli([str(a) for a in argv])
    if rc != want:
        raise SystemExit(f"{argv[0]} exited {rc} (expected {want})")
    return rc


def ingest_lists(root):
    """createColorDepthSearchDataInput for the EM library (the three EM
    fixtures) and the LM library (the four LM fixtures with their
    gradient and z-gap variants), as JSON lists and into one SQLite
    store; then copyToMipsStore of the JSON lists into a canonical store
    folder (--update-mips). Returns {library: entities} of the lists."""
    db = os.path.join(root, "nb.db")
    for lib, args in INGEST_LIBRARIES.items():
        run_cli(["createColorDepthSearchDataInput", "--library", lib, *args,
                 "-od", os.path.join(root, "mips")])
        run_cli(["createColorDepthSearchDataInput", "--library", lib, *args,
                 "--db", db])
    lists = {}
    for lib in INGEST_LIBRARIES:
        mips = os.path.join(root, "mips", f"{lib}.json")
        with open(mips) as f:
            lists[lib] = json.load(f)
        run_cli(["copyToMipsStore", "--mips-file", mips, "--target-folder",
                 os.path.join(root, "store"), "--update-mips",
                 "--lmIgnoreMissingSegmentation"])
    return lists


def ppp_inputs(root):
    """The raw PPP result fixtures, screenshots of both EM bodies' best
    match, and the published pppm URLs and LM samples of those two."""
    import shutil
    rd = os.path.join(root, "ppp", "00")
    os.makedirs(rd)
    fixtures = os.path.dirname(FIXTURES)
    for name in sorted(os.listdir(fixtures)):
        if name.startswith("cov_scores_"):
            shutil.copy(os.path.join(fixtures, name), rd)
    shots = os.path.join(root, "screenshots")
    os.makedirs(shots)
    for em, lm in PPP_PAIRS:
        for sfx in ("_1_raw.png", "_5_ch.png"):
            with open(os.path.join(shots, f"{em}-{lm}{sfx}"), "wb") as f:
                f.write(b"png")
    urls = os.path.join(root, "pppm_urls.json")
    with open(urls, "w") as f:
        json.dump([{"id": f"{em}-{lm}",
                    "uploadedFiles": {
                        "RAW": f"https://s3/ppp/{em}-{lm}_raw.png",
                        "CH": f"https://s3/ppp/{em}-{lm}_ch.png"},
                    "uploadedThumbnails": {
                        "CH": f"https://s3/ppp/{em}-{lm}_ch.jpg"}}
                   for em, lm in PPP_PAIRS], f)
    samples = os.path.join(root, "samples.json")
    with open(samples, "w") as f:
        json.dump([{"_id": "101", "name": "BJD_100A01_AE_01-20170929_62_B1",
                    "publishingName": "BJD_100A01",
                    "slideCode": "20170929_62_B1", "gender": "f"},
                   {"_id": "102", "name": "BJD_105A09_AE_01-20180112_62_A2",
                    "publishingName": "BJD_105A09",
                    "slideCode": "20180112_62_A2", "gender": "m"}], f)
    return os.path.join(root, "ppp"), shots, urls, samples


def store_rows(db):
    """(neurons by entity id, CD matches) of a store."""
    from colormipsearch_torch.dataio import DataSourceParam
    from colormipsearch_torch.dataio.db import (DBNeuronMatchesReader,
                                                SqliteStore)
    store = SqliteStore(db)
    try:
        neurons = {n.entity_id: n for n in store.find_neurons(
            DataSourceParam())}
        reader = DBNeuronMatchesReader(store)
        mips = reader.list_match_locations([DataSourceParam()])
        matches = reader.read_matches_by_mask(
            DataSourceParam(mip_ids=mips)) if mips else []
    finally:
        store.close()
    return neurons, matches


def ingest_chain(root, device, ppp):
    """Steps 3-8 of phase 9a over the store in root: colorDepthSearch
    (--mips-storage db), gradientScores, normalizeGradientScores,
    importPPPResults, exportData (EM CD and EM PPP matches), tag,
    validateDBData and deleteCDMatches (a dry run, then a run). Returns
    what a chain on another device must reproduce."""
    db = os.path.join(root, "nb.db")
    cache = ["--array-cache", os.path.join(root, "array-cache")]
    rd, shots, urls, samples = ppp
    run_cli(["colorDepthSearch", "--mips-storage", "db", "--db", db,
             "-m", "flyem_smoke", "-i", "flylight_smoke", *PIPELINE_CDS,
             *cache, "--processing-tag", "cds-ingest", "--device", device])
    run_cli(["gradientScores", "--db", db, *PIPELINE_GRAD, *cache,
             "--device", device])
    run_cli(["normalizeGradientScores", "--db", db])
    run_cli(["importPPPResults", "--db", db, "-rd", rd, "--screenshots-dir",
             shots, "-od", os.path.join(root, "ppp_json")])
    # the ingested LM entities carry no anatomical area (the fixtures'
    # names hold none), which the export's validation requires
    run_cli(["exportData", "--exported-result-type", "EM_CD_MATCHES",
             "--db", db, "-od", os.path.join(root, "export_cd"),
             "--validation", "off"])
    run_cli(["exportData", "--exported-result-type", "EM_PPP_MATCHES",
             "--db", db, "-od", os.path.join(root, "export_ppp"),
             "--pppm-urls", urls, "--jacs-samples-file", samples])
    run_cli(["tag", "--db", db, "--tag", "smoke-9a", "--library",
             "flylight_smoke"])
    report = os.path.join(root, "report.json")
    run_cli(["validateDBData", "--db", db, "--error-tag", "invalid",
             "--check-matches", "--error-report", report], want=1)
    neurons, before = store_rows(db)
    delete = ["deleteCDMatches", "--db", db, "--include-matches-with-"
              "gradscore", "--masks-published-names", "1752016801"]
    run_cli(delete + ["--dry-run"])
    if len(store_rows(db)[1]) != len(before):
        raise SystemExit("deleteCDMatches --dry-run deleted matches")
    run_cli(delete)
    _, after = store_rows(db)
    with open(report) as f:
        errors = json.load(f)
    kept = {m.entity_id for m in after}
    return {"export_cd": file_tree(os.path.join(root, "export_cd")),
            "export_ppp": file_tree(os.path.join(root, "export_ppp")),
            "report": errors,
            "deleted": sorted((m.mask_image.mip_id, m.matched_image.mip_id)
                              for m in before if m.entity_id not in kept),
            "rows": len(before), "rows_after": len(after),
            "tagged": sum("smoke-9a" in (n.tags or ())
                          for n in neurons.values()),
            "neurons": neurons, "matches": before}


def phase_ingest(ws, device="cuda"):
    """(a) The whole production pipeline from ingest to export through the
    CLI's entry points: the MIP lists of createColorDepthSearchDataInput,
    copyToMipsStore, then search, gradient, normalize, PPP import, both
    exports, tag, validate and delete over one SQLite store on `device`;
    the goldens of the fixture pairs, the bound's two kernels, K1 and
    G1-G4 launched and K3a not (counted from 0 just before the chain), and the
    exports, the validation report
    and the rows deleted equal to the same chain's on the CPU over a copy
    of the same ingested store."""
    import shutil
    from colormipsearch_torch.cds import kernels
    root = os.path.join(ws, "ingest")
    t0 = time.perf_counter()
    lists = ingest_lists(root)
    report = {"listed": {k: len(v) for k, v in lists.items()},
              "ingest_s": round(time.perf_counter() - t0, 2)}
    copied = file_tree(os.path.join(root, "store"))
    repointed = 0  # list entries that copyToMipsStore pointed at its copies
    for lib in INGEST_LIBRARIES:
        with open(os.path.join(root, "mips", f"{lib}.json")) as f:
            repointed += sum(os.path.join(root, "store") in json.dumps(e)
                             for e in json.load(f))
    report["copied_files"] = len(copied)
    ppp = ppp_inputs(root)
    chains = {}
    for i, dev in enumerate((device, "cpu")):
        croot = os.path.join(root, f"chain{i}-{dev}")
        os.makedirs(croot)
        shutil.copy(os.path.join(root, "nb.db"), croot)  # the same lists
        counters = kernels.path_wrappers()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        chains[i] = ingest_chain(croot, dev, ppp)
        chains[i]["launches"] = {name: fn.launches
                                 for name, fn in counters.items()}
        report[f"chain{i}_{dev}_s"] = round(time.perf_counter() - t0, 2)
    main = chains[0]
    by_file = {}
    for e in main["neurons"].values():
        src = e.compute_files.get(next(
            c for c in e.compute_files if c.name == "SourceColorDepthImage"))
        by_file[os.path.basename(src.file_name)] = e
    mask = by_file["12191_JRC2018U.tif"]
    target_key = {by_file[f"{n}.tif"].mip_id: f"lm-{i}"
                  for i, n in enumerate(LM_GOLDEN)}
    rows = {target_key[m.matched_image.mip_id]: m for m in main["matches"]
            if m.mask_image.mip_id == mask.mip_id
            and m.matched_image.mip_id in target_key}
    pixels = [(k, rows[k].matching_pixels, rows[k].mirrored)
              for k in sorted(rows)]
    gaps = [(k, rows[k].gradient_area_gap) for k in sorted(rows)]
    exported = json.loads(main["export_cd"][f"{mask.mip_id}.json"])
    scores = [(target_key.get(r["image"]["mipId"], r["image"]["mipId"]),
               round(r["normalizedScore"], 2)) for r in exported["results"]]
    ppp_doc = json.loads(main["export_ppp"]["1599747200.json"])
    ppp_results = [(r["image"]["publishedName"], r["files"].get("CDMBest"))
                   for r in ppp_doc["results"]]
    report.update(rows=main["rows"], rows_deleted=main["rows"]
                  - main["rows_after"], report_errors=len(main["report"]),
                  tagged=main["tagged"], launches=main["launches"],
                  export_cd_files=len(main["export_cd"]),
                  export_ppp_files=len(main["export_ppp"]))
    log(f"[phase 9a] ingest: lists {report['listed']}, {len(copied)} files "
        f"copied to the canonical store, {repointed} entities repointed; "
        f"mask 12191 on {device}: stored {pixels}, gaps {gaps}, exported "
        f"normalizedScore {scores}; PPP export {ppp_results}; {main['rows']} "
        f"rows, {report['rows_deleted']} deleted, {report['report_errors']} "
        f"validation errors, {main['tagged']} tagged; kernel launches "
        f"{main['launches']}; chains {report[f'chain0_{device}_s']}s "
        f"({device}), {report['chain1_cpu_s']}s (cpu)")
    if pixels != CDS_GOLDENS or gaps != GAP_GOLDENS \
            or scores != EXPORT_GOLDENS:
        raise SystemExit("phase 9a's goldens are wrong")
    if ppp_results != [("BJD_100A01", "https://s3/ppp/" + "-".join(
            PPP_PAIRS[0]) + "_ch.png")]:
        raise SystemExit(f"the PPP export: {ppp_results}")
    if not copied or not repointed or not main["tagged"] \
            or not main["report"] or not main["deleted"]:
        raise SystemExit("copy, tag, validate or delete did nothing")
    if device != "cpu" and not (ran_k1_path(main["launches"])
                                and ran_shape_path(main["launches"])):
        raise SystemExit(f"phase 9a did not run through the bound's kernels "
                         f"and K1 alone, and G1-G4: {main['launches']}")
    for key in ("export_cd", "export_ppp", "report", "deleted"):
        if main[key] != chains[1][key]:
            raise SystemExit(f"phase 9a: the CPU chain's {key} differs")
    log(f"[phase 9a] the CPU chain over a copy of the ingested store: "
        f"exports, validation report and rows deleted equal")
    return report



def phase_bounds_at_size(checks, dev, library, n_cpu=4):
    """(b) The count-capped bound's two kernels against their plain
    versions on the card, on every entry of both partitions of phase 4's
    library (the bits and counts of every variant, cell and target; every
    mask's bound against every target); on partition 0 (all masks x 256
    targets of 566x1210) the kernels' bound equal to the dense fp32
    formulation's on every pair, each of the capped and the feature bound
    equal to its CPU run on the first n_cpu masks and targets, and exact
    <= capped <= feature on every pair. Times by CUDA events: each kernel
    and its plain version, the capped bound through the kernels and as
    the dense products, the feature bound; each with its survivor rate at
    the 1 % keep threshold, peak device memory and bound (bytes over 3.35
    TB/s, operations over the card's lane rate or, for the products, 67
    TFLOP/s of fp32)."""
    import torch
    from colormipsearch_torch.cds import prescreen as ps
    from colormipsearch_torch.scripts.op_microbench import cuda_ms
    engines, screen, u, thr = (library[k] for k in (
        "engines", "screen", "u_matrix", "thr"))
    rows = ps.sparse_query_rows(u).to(dev)
    stage_args = (screen.zt9, screen.offsets, screen.grid_hw)
    report, kernel_timing = {}, {}
    for p, part in enumerate(library["parts"]):
        words = engines[0].pack_raw_words(part, dev)
        bits, cnt = ps.prescreen_cells(words, *stage_args)
        plain_cells = event_ms(lambda: ps.cell_masks_plain(words,
                                                           *stage_args))
        nv, npos, tsz = bits.shape
        label = f"partition {p}, {nv} variants x {npos} cells x {tsz} targets"
        checks["prescreen_cells"].compare(f"{label}: bits", lambda: bits,
                                          lambda: plain_cells[0][0])
        checks["prescreen_cells"].compare(f"{label}: counts", lambda: cnt,
                                          lambda: plain_cells[0][1])
        got = ps.prescreen_capped(rows, bits, cnt)
        plain_capped = event_ms(lambda: ps.capped_bounds_plain(rows, bits,
                                                               cnt))
        checks["prescreen_capped"].compare(
            f"partition {p}, {rows.n_masks} masks x {tsz} targets: bounds",
            lambda: got, lambda: plain_capped[0])
        if p:
            continue
        work = prescreen_work(words, bits, cnt, rows)
        for name, fn, plain_ms in (
                ("prescreen_cells",
                 lambda: ps.prescreen_cells(words, *stage_args),
                 plain_cells[1]),
                ("prescreen_capped",
                 lambda: ps.prescreen_capped(rows, bits, cnt),
                 plain_capped[1])):
            ops_ms, bytes_ms = work[name]
            kernel_timing[name] = {
                "ms": cuda_ms(fn, 10), "plain_ms": plain_ms,
                "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None}
        # the capped kernel on a one-variant table (13 MB: it stays in the
        # 50 MB L2) beside the full one: how much of its time the table's
        # reads from device memory take
        one = (bits[:1], cnt[:1])
        checks["prescreen_capped"].compare(
            f"partition 0, {rows.n_masks} masks x {tsz} targets, one "
            f"variant: bounds", lambda: ps.prescreen_capped(rows, *one),
            lambda: ps.capped_bounds_plain(rows, *one))
        one_ms = cuda_ms(lambda: ps.prescreen_capped(rows, *one), 10)
        kernel_timing["prescreen_capped"].update(
            one_variant_ms=one_ms,
            one_variant_table_mb=(one[0].numel() * 9) / 1e6)
        exact = library["result"][0][:, :tsz]
        in_bytes = words.numel() * 4 + u.size * 4 + rows.n_masks * tsz * 4
        f = u.shape[1]
        flops = {"capped_dense": 2 * rows.n_masks * tsz * f * nv,
                 "feature": 2 * rows.n_masks * tsz * f * 2}
        u_dev = torch.from_numpy(u).to(dev)
        bounds = {
            "capped": (lambda uu, ww: screen.bounds_from_words(uu, ww),
                       rows),
            "capped_dense": (lambda uu, ww: dense_capped_bounds(screen, uu,
                                                                ww), u_dev),
            "feature": (lambda uu, ww: screen.bounds(
                uu, screen.target_features(ww)), u_dev)}
        values = {}
        for name, (fn, uu) in bounds.items():
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            values[name] = fn(uu, words)
            peak = torch.cuda.max_memory_allocated(dev)
            ms = cuda_ms(lambda fn=fn, uu=uu: fn(uu, words), 2)
            if name == "capped":
                ops_ms = sum(kernel_timing[k]["ops_ms"]
                             for k in kernel_timing)
                bytes_ms = 1e3 * (words.numel() * 4 + 4 * sum(
                    t.numel() for t in rows.tensors())
                    + rows.n_masks * tsz * 4) / PEAK_BYTES
            else:
                ops_ms = 1e3 * flops[name] / (2 * PEAK_LANE_OPS)
                bytes_ms = 1e3 * in_bytes / PEAK_BYTES
            report[name] = {
                "ms": ms, "peak_gib": peak / 2**30,
                "survivor_rate": float(np.mean(values[name] > thr[:, None])),
                "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        for name, uu in (("capped", u), ("feature", u)):
            cpu = bounds[name][0](uu[:n_cpu], words[:n_cpu].cpu())
            if not np.array_equal(cpu, values[name][:n_cpu, :n_cpu]):
                raise SystemExit(f"the {name} bound on the card differs "
                                 f"from its CPU run")
        if not np.array_equal(values["capped"], values["capped_dense"]):
            raise SystemExit("the prescreen kernels' bound differs from the "
                             "dense formulation's")
        chain = [exact, values["capped"], values["feature"]]
        held = all((a <= b).all() for a, b in zip(chain, chain[1:]))
        log(f"[phase 9b] partition 0 ({rows.n_masks} masks x {tsz} targets; "
            f"query CSR {rows.cell_pos.numel()} cells, "
            f"{rows.entries.numel()} entries): the kernels' bound == the "
            f"dense formulation's on every pair; capped and feature bounds "
            f"== their CPU runs on {n_cpu} x {n_cpu}; exact <= capped <= "
            f"feature on every pair: {held}; " + "; ".join(
                f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f} ms by "
                f"{v['bound_by']}), survivors {v['survivor_rate']:.4f}, peak "
                f"{v['peak_gib']:.2f} GiB" for k, v in report.items()))
        for name, v in kernel_timing.items():
            log(f"[phase 9b] {name}: {v['ms']:.4f} ms, plain version "
                f"{v['plain_ms']:.3f} ms; bound {v['bound_ms']:.4f} ms by "
                f"{v['bound_by']} (ops {v['ops_ms']:.4f} ms, bytes "
                f"{v['bytes_ms']:.4f} ms): {100 * v['bound_ms'] / v['ms']:.1f}"
                f" % of its bound")
        one = kernel_timing["prescreen_capped"]
        log(f"[phase 9b] prescreen_capped on one variant's table "
            f"({one['one_variant_table_mb']:.1f} MB): "
            f"{one['one_variant_ms']:.4f} ms, against {one['ms'] / nv:.4f} "
            f"ms per variant of the full {nv}-variant table")
        if not held:
            raise SystemExit("the bounds' chain does not hold")
        del u_dev
    report["kernels"] = kernel_timing
    return report


# ---- phase 10 --------------------------------------------------------------

REHEARSAL = "colormipsearch_torch.scripts.dress_rehearsal"
# the rehearsal's own size is 2048 masks x 2048 targets (its run at that
# size: PERF.md section 5); here cut in depth so that the whole script
# stays under 600 s, keeping both 500-target partitions and a ragged one
REHEARSAL_CUT = ("masks x targets cut from 2048 x 2048 to 256 x 1024 (two "
                 "500-target partitions and a ragged 24): the whole script "
                 "stays under 600 s")
# the gradientScores arguments of the rehearsal's process blocks
REHEARSAL_GA = ["--maskThreshold", "20", "--mirrorMask", "--nBestLines",
                "300", "--targetsPerBatch", "128", "--processing-tag",
                "rehearsal-ga"]
REHEARSAL_STAGES = ("import_em", "import_lm", "cds", "normalize", "export")


def rehearsal_store(db):
    """(names by entity id: (library, index of its file), rows by (mask
    index, target index): (pixels, mirrored, gap, high expression area,
    normalized score), mask ids by index) of the rehearsal's store."""
    import sqlite3
    con = sqlite3.connect(db)
    try:
        neurons = con.execute("SELECT entity_id, mip_id, library_name, "
                              "published_name FROM neuron_metadata").fetchall()
        matches = con.execute(
            "SELECT mask_ref, matched_ref, matching_pixels, mirrored, "
            "gradient_area_gap, high_expression_area, normalized_score FROM "
            "cd_matches").fetchall()
    finally:
        con.close()
    # EM published names are 90000000 + i, LM ones LINE<i:05d>
    index = {eid: int(pub[4:]) if lib == "flylight_rehearsal"
             else int(pub) - 90000000 for eid, _, lib, pub in neurons}
    mip_ids = {int(pub) - 90000000: mip for _, mip, lib, pub in neurons
               if lib == "flyem_rehearsal"}
    rows = {(index[m], index[t]): (p, bool(mir), *rest)
            for m, t, p, mir, *rest in matches}
    return rows, mip_ids


def stage_log(root, stage):
    with open(os.path.join(root, f"{stage}.log")) as f:
        return f.read().splitlines()


def logged_launches(lines):
    """The kernel launches a command logged at its end (its process's)."""
    found = [json.loads(ln.split("kernel launches ", 1)[1])
             for ln in lines if "kernel launches " in ln]
    if len(found) != 1:
        raise SystemExit(f"expected one kernel launch line, found "
                         f"{len(found)}")
    return found[0]


def phase_rehearsal(ws, dev, n_masks=256, n_targets=1024, cut=REHEARSAL_CUT,
                    n_sample=4):
    """The port's dress rehearsal on the card: the library generator, then
    each stage as its own process over one SQLite store (ingest of the EM
    and the LM library with its grad and zgap variants, colorDepthSearch
    --mips-storage db -ps 500, gradientScores --nBestLines 300 in four
    process blocks, normalize, export). Every stage exits 0; every stored
    pixel score equals an in-memory TwoPhaseSweep of the same files on
    every pair; the gradient and normalized scores of n_sample masks equal
    a --device cpu run over a copy of the store; every mask with a match
    has one export file; colorDepthSearch launched the bound's two kernels
    and K1 and not K3a, the gradient blocks G1-G4, G2 twice per query
    (r = 60 and 20; the z-gap files leave r = 10 out), as each command
    logs its own process's launches."""
    import sqlite3
    from collections import Counter
    import torch
    from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
    from colormipsearch_torch.cds.prescreen import PairPrescreen
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    root = os.path.join(ws, "rehearsal")
    env = {k: v for k, v in os.environ.items() if not k.startswith("CMS_")}
    t0 = time.perf_counter()
    rc, lines = run_logged([sys.executable, "-m", REHEARSAL, root, "--masks",
                            str(n_masks), "--targets", str(n_targets)], env,
                           os.path.join(ws, "rehearsal.log"), timeout=600)
    report = {"masks": n_masks, "targets": n_targets, "frame": [566, 1210],
              "cut": cut, "script_s": round(time.perf_counter() - t0, 2)}
    if rc != 0:
        raise SystemExit(f"the rehearsal exited {rc}:\n" + "\n".join(
            ln for _, ln in lines[-60:]))
    with open(os.path.join(root, "rehearsal.json")) as f:
        done = json.load(f)
    blocks = [f"ga_b{b}" for b in range(done["ga"]["blocks"])]
    failed = [s for s in (*REHEARSAL_STAGES, *blocks) if done[s]["rc"] != 0]
    if failed:
        raise SystemExit(f"rehearsal stages failed: {failed}")
    report["stages"] = {s: {k: done[s][k] for k in ("wall_s", "peak_rss_gb")}
                        for s in (*REHEARSAL_STAGES, *blocks)}
    report["generate_s"] = done["generate"]["wall_s"]
    report["library_bytes"] = done["generate"]["library_bytes"]
    for key in ("store_bytes", "matches_written", "ga_matches_scored"):
        report[key] = done[key]
    report["cds_pairs_per_s"] = done["cds"]["pairs_per_s"]
    report["ga_s"] = done["ga"]["wall_s"]
    report["ga_matches_per_s"] = done["ga"]["matches_per_s"]
    report["export_files"] = done["export"]["files_written"]
    cds_lines = stage_log(root, "cds")
    report["cds_command_s"] = log_numbers(
        r"found \d+ matches \(\d+ masks\) in ([\d.]+)s", cds_lines)[0][0]
    report["cds_prep_s"] = log_numbers(
        r"prepared \d+ mask engines in ([\d.]+)s", cds_lines)[0][0]
    report["cds_stage_times"] = next(
        json.loads(ln.split("stage times: ", 1)[1].replace("'", '"'))
        for ln in cds_lines if "stage times: " in ln)
    report["peak_device_gib"] = {
        s: log_numbers(r"peak device memory ([\d.]+) GiB",
                       stage_log(root, s))[0][0] for s in ("cds", *blocks)}
    # the kernels each device stage's process launched
    launches = {s: logged_launches(stage_log(root, s))
                for s in ("cds", *blocks)}
    report["launches"] = launches
    ga = {k: sum(launches[b][k] for b in blocks) for k in launches["cds"]}
    if not ran_k1_path(launches["cds"]) or any(
            launches["cds"][k] for k in SHAPE_KERNELS):
        raise SystemExit(f"colorDepthSearch did not run through the bound's "
                         f"kernels and K1 alone: {launches['cds']}")
    if not ran_shape_path(ga) or any(
            launches[b]["dilate_rgb"] != 2 * launches[b]["query_planes"]
            or launches[b]["multimask_ratio"] or launches[b]["prescreen_cells"]
            for b in blocks):
        raise SystemExit(f"the gradient blocks did not run through G1-G4 "
                         f"with G2 at the query's two radii alone: "
                         f"{launches}")
    db = os.path.join(root, "store.db")
    stored, mip_ids = rehearsal_store(db)
    masked = sorted({i for i, _ in stored})
    if ga["query_planes"] != len(masked):
        raise SystemExit(f"{ga['query_planes']} query plane builds for "
                         f"{len(masked)} masks with a match")
    # the same files in memory through the CLI's engines, 500 per partition
    t0 = time.perf_counter()
    masks = [load_rgb(os.path.join(root, "ems", n))
             for n in sorted(os.listdir(os.path.join(root, "ems")))]
    lm_names = sorted(os.listdir(os.path.join(root, "lms")))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        targets = np.stack(list(pool.map(
            lambda n: load_rgb(os.path.join(root, "lms", n)), lm_names)))
        h, w = masks[0].shape[:2]
        excluded = label_regions(h, w)
        engines = list(pool.map(
            lambda m: ActiveTilePixelEngine(m, 20, True, 20, 1.0, 2,
                                            excluded), masks))
        screen = PairPrescreen(engines[0].zt9, 2, h, w)
        u_matrix = np.stack(list(pool.map(
            lambda e: screen.query_features(e.planes.words), engines)))
    q = np.array([e.tiles.query_size for e in engines])
    thr = np.maximum(0.01 * q, 0.5)
    sweep = TwoPhaseSweep(engines, [dev], screen, u_matrix, thr)
    swept = list(sweep.sweep_parts(
        (i, targets[i:i + 500]) for i in range(0, n_targets, 500)))
    torch.cuda.synchronize(dev)
    scores = np.concatenate([s for _, s, _ in swept], axis=1)
    mirrored = np.concatenate([m for _, _, m in swept], axis=1)
    report["reference_sweep_s"] = round(time.perf_counter() - t0, 2)
    want = (scores > 0) & (scores / np.maximum(q, 1)[:, None] > 0.01)
    expected = {(int(i), int(t)): (int(scores[i, t]), bool(mirrored[i, t]))
                for i, t in zip(*np.nonzero(want))}
    got = {pair: row[:2] for pair, row in stored.items()}
    exported = sorted(os.listdir(os.path.join(root, "export")))
    with_rows = sorted(f"{mip_ids[i]}.json" for i in masked)
    # nBestLines 300: each mask's 300 best lines (one per target here)
    per_mask = Counter(i for i, _ in stored)
    scored = Counter(i for (i, _), row in stored.items() if row[2] is not None)
    unscored = [i for i in masked if scored[i] != min(per_mask[i], 300)]
    log(f"[phase 10] the rehearsal, {n_masks} masks x {n_targets} targets: "
        f"{len(stored)} rows stored == an in-memory TwoPhaseSweep on every "
        f"pair: {got == expected}; {len(exported)} export files for "
        f"{len(masked)} masks with a match; {sum(scored.values())} rows "
        f"gradient-scored, at most 300 per mask: {not unscored}; kernel "
        f"launches {launches}")
    if got != expected:
        raise SystemExit(f"the stored pixel scores differ from the sweep's: "
                         f"{len(got)} rows, {len(expected)} expected")
    if exported != with_rows:
        raise SystemExit("the export files do not match the masks with "
                         "matches")
    if unscored or report["ga_matches_scored"] != sum(scored.values()):
        raise SystemExit(f"the gradient blocks did not score each mask's "
                         f"best 300 lines: masks {unscored[:10]}")
    # n_sample masks spread over those with a match, scored again on the
    # CPU (the plain versions) over a copy of the store whose gradient and
    # normalized scores of those masks are cleared first
    sample = masked[::max(1, len(masked) // n_sample)][:n_sample]
    ids = [mip_ids[i] for i in sample]
    cpu_db = os.path.join(root, "cpu.db")
    src, dst = sqlite3.connect(db), sqlite3.connect(cpu_db)
    try:
        src.backup(dst)
        refs = dst.execute(
            f"SELECT entity_id FROM neuron_metadata WHERE mip_id IN "
            f"({','.join('?' * len(ids))})", ids).fetchall()
        with dst:
            dst.execute(
                f"UPDATE cd_matches SET gradient_area_gap = NULL, "
                f"high_expression_area = NULL, normalized_score = NULL, doc = "
                f"json_remove(doc, '$.gradientAreaGap', "
                f"'$.highExpressionArea', '$.normalizedScore') WHERE "
                f"mask_ref IN ({','.join('?' * len(refs))})",
                [r[0] for r in refs])
    finally:
        src.close()
        dst.close()
    t0 = time.perf_counter()
    run_cli(["gradientScores", "--db", cpu_db, *REHEARSAL_GA,
             "--masks-mip-ids", *ids, "--device", "cpu"])
    run_cli(["normalizeGradientScores", "--db", cpu_db, "--masks-mip-ids",
             *ids])
    report["cpu_sample_s"] = round(time.perf_counter() - t0, 2)
    cpu_rows, _ = rehearsal_store(cpu_db)
    picked = {k: v for k, v in stored.items() if k[0] in sample}
    same = {k: cpu_rows[k] for k in picked} == picked
    report["cpu_sample"] = {"masks": sample, "rows": len(picked)}
    log(f"[phase 10] gradient and normalized scores of masks {sample} "
        f"({len(picked)} rows) == a --device cpu run over a copy of the "
        f"store: {same} ({report['cpu_sample_s']}s)")
    if not same or not picked:
        raise SystemExit("the card's gradient or normalized scores differ "
                         "from the CPU's")
    log(f"[phase 10] " + json.dumps({k: report[k] for k in (
        "stages", "cds_pairs_per_s", "ga_matches_per_s", "peak_device_gib",
        "store_bytes", "matches_written", "ga_matches_scored")}))
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="add a torch.profiler round; write its trace to DIR")
    opts = ap.parse_args()
    import torch
    missing = [p for p in [src for src, _ in KERNELS.values()]
               + ["colormipsearch_torch/cds/oracle.py",
                  "tests/fixtures/cdsearch/ems"]
               if not os.path.exists(os.path.join(REPO, p))]
    if missing:
        print(f"chip_smoke: not in a checkout of the repo (missing "
              f"{missing})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card, libs = phase_card()
    checks = {name: Check(name) for name in
              ("multimask_ratio", "multimask_words", "prescreen_cells",
               "prescreen_capped", *SHAPE_KERNELS)}
    phase_kernel_vs_plain(checks, dev)
    with tempfile.TemporaryDirectory() as ws:
        phase_cli(ws, "1")
        phase_cli(ws, "0")
        timing, library = phase_at_size(checks, dev, opts.profile)
        timing["op_chain"] = phase_microbench(dev)
        t6 = time.perf_counter()
        phase_planes(checks, dev)
        gradient = {"cli_launches": phase_gradient_cli(ws),
                    "ptxas": ptxas_report(libs)}
        gradient["at_size"], shape_timing = phase_gradient_at_size(
            checks, dev, ws)
        timing.update(shape_timing)
        log(f"[phase 6] gradientScores in {time.perf_counter() - t6:.1f}s")
        t7 = time.perf_counter()
        scale_out = {"dense_fixtures": phase_dense_fixtures(dev),
                     "dense_at_size": phase_dense_at_size(dev, library),
                     "two_shards": phase_two_shards(dev, library),
                     "two_processes": phase_two_processes(ws, dev, library),
                     "gradient_two_slots": phase_gradient_slots(dev, ws)}
        log(f"[phase 7] the dense engine and the scale-out layer in "
            f"{time.perf_counter() - t7:.1f}s")
        t8 = time.perf_counter()
        pipeline = {"fixtures": phase_pipeline_fixtures(ws)}
        t8b = time.perf_counter()
        pipeline["at_size"] = phase_pipeline_at_size(ws, dev, library)
        pipeline["at_size"]["phase_s"] = round(time.perf_counter() - t8b, 2)
        log(f"[phase 8] the production pipeline in "
            f"{time.perf_counter() - t8:.1f}s")
        t9 = time.perf_counter()
        ingest = {"pipeline": phase_ingest(ws),
                  "bounds": phase_bounds_at_size(checks, dev, library)}
        ingest["phase_s"] = round(time.perf_counter() - t9, 2)
        log(f"[phase 9] ingest to export and the prescreen bounds in "
            f"{ingest['phase_s']}s")
        for name, measured in ingest["bounds"]["kernels"].items():
            timing[name].update(measured)
        t10 = time.perf_counter()
        rehearsal = phase_rehearsal(ws, dev)
        rehearsal["phase_s"] = round(time.perf_counter() - t10, 2)
        log(f"[phase 10] the rehearsal on the card in {rehearsal['phase_s']}s")
    for name, check in checks.items():
        timing[name]["max_abs_err"] = check.max_abs_err
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f}s")
    print(card)  # the card's name and power limit, again beside the results
    print(json.dumps({"gradient": gradient}))
    print(json.dumps({"scale_out": scale_out}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"ingest": ingest}))
    print(json.dumps({"rehearsal": rehearsal}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **{k: timing[name][k] for k in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
