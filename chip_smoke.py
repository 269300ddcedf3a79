#!/usr/bin/env python3
"""Smoke test of colormipsearch_torch on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card (Hopper, sm_90a) and nvcc; it builds the package's kernels from
the sources in the checkout and drives the colorDepthSearch path on both
exact predicates, and the op microbench:

1. card: nvidia-smi name and power limit; the three kernel libraries
   (multimask_ratio, multimask_words, op_chain) built in parallel, with
   their build seconds, registers and shared memory;
2. each exact kernel against its plain PyTorch version, exactly, on a
   random library of full 566x1210 frames (16 masks x 64 targets): sparse
   and dense survivors, a mask with zero survivors, one survivor at the
   last target, a mask with more than 128 active tiles, mirror off,
   xyShift 0, with and without the live-tile cut, and launch rows whose
   survivor flag is 0; the word kernel also at pixColorFluctuation 10;
3. the CLI (`colormipsearch_torch colorDepthSearch --device cuda`) on the
   three golden fixtures: 439 / 414 / 426, the last one mirrored, once on
   the ratio kernel and once under CMS_RATIO_PRED=0 on the word kernel
   (which must launch, with no ratio launch in that run);
4. at size: TwoPhaseSweep over 1024 masks x 512 targets (two 256-target
   partitions) of the adversarial library built from the fixtures (rolled
   and banded frames, label-region exclusion, 1% keep threshold), on the
   ratio path and on the word path (word tables from the ratio engines'
   query tiles): 439 among mask 0's scores, each path's kernel launches
   > 0, the two paths' scores equal on all 524,288 pairs, 32 masks' rows
   of each kernel equal to its plain version; pairs/s of both paths in
   turns, survivor rate, stage seconds, peak memory, and each kernel on
   partition 0 over all masks. The timed round is the pipelined partition
   loop of the CLI (`TwoPhaseSweep.sweep_parts`);
5. the op microbench (`python -m colormipsearch_torch.scripts.op_microbench
   --device cuda`): its ten cases, each kernel == plain at 512 and at
   32,768 steps, Top/s at 32,768 steps, and a time ratio of 65,536 to
   32,768 steps within 1.8-2.2.

`python3 chip_smoke.py --profile DIR` adds a torch.profiler round of the
phase-4 ratio sweep: device busy share, the bound's and the exact
kernel's device time, the top device kernels, and a Chrome trace in DIR.

Any failure exits non-zero. The last two lines are a JSON object per
kernel and {"ok": true, "device": {...}}. Outside a checkout of the repo,
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
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "multimask_ratio": ("colormipsearch_torch/csrc/multimask_ratio.cu",
                        "colormipsearch_tpu/cds/multimask.py:326"),
    "multimask_words": ("colormipsearch_torch/csrc/multimask_words.cu",
                        "colormipsearch_tpu/cds/multimask.py:260"),
    "op_chain": ("colormipsearch_torch/csrc/op_chain.cu",
                 "scripts/op_microbench.py:37"),
}


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


def table_args(scorer, tab, packed, dev):
    import torch
    return (list(packed) + list(scorer._q_for(dev))
            + [torch.from_numpy(a).to(dev) for a in
               (tab.row_off, tab.tile_list, tab.tgt, tab.surv)])


def compare_scorer(checks, label, scorer, tab, packed, dev):
    from colormipsearch_torch.cds import multimask as mm
    kernel, plain = mm.PREDICATE_KERNELS[scorer.predicate]
    args = table_args(scorer, tab, packed, dev)
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
    libs = kernels.load_libraries(tuple(KERNELS))
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
    return card


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


def phase_kernel_vs_plain(checks, dev, n_masks=16, n_targets=64):
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
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
        packed = engines[0].pad_from_words(words)
        ranges = mm.signal_ranges_from_words(words)
        live = mm.tile_live_from_words(words)
        scorers = [mm.MultiMaskScorer(
            [e.with_predicate("words") for e in engines])]
        if ratio:
            scorers.insert(0, mm.MultiMaskScorer(engines))
        for scorer in scorers:
            label = (f"pixColorFluctuation {pcf}, xyShift {xy_shift}, "
                     f"mirror {mirror}")
            for restrict in (False, True):
                tab = (scorer.build_table(surv, ranges, live) if restrict
                       else scorer.build_table(surv))
                compare_scorer(checks, f"{label}, live-tile cut {restrict}",
                               scorer, tab, packed, dev)
            tab.surv[::3] = 0  # rows the kernel must report as 0
            compare_scorer(checks, f"{label}, every third row's survivor "
                           f"flag 0", scorer, tab, packed, dev)
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
    lms = [{"class": "org.janelia.colormipsearch.model.LMNeuronEntity",
            "id": str(2001 + i), "mipId": f"lm-{i}",
            "alignmentSpace": "JRC2018_Unisex_20x_HR",
            "libraryName": "flylight_test",
            "publishedName": name.split("_")[0],
            "computeFiles": {"InputColorDepthImage": os.path.join(
                FIXTURES, "lms", f"{name}.tif")},
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

    def roll(px, i):
        return px if i == 0 else np.roll(
            px, ((37 * i) % h, (151 * i) % w), axis=(0, 1))

    def band(px, i, bh=160, step=53):
        if i == 0:
            return px
        b0 = (step * i) % (h - bh)
        out = np.zeros_like(px)
        out[b0:b0 + bh] = px[b0:b0 + bh]
        return out

    masks = [roll(em_px[i % len(em_px)], i // len(em_px))
             for i in range(n_masks)]
    targets = np.stack([band(roll(lm_px[i % len(lm_px)], i // len(lm_px)), i)
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


def phase_at_size(checks, dev, profile_dir=None, n_masks=1024,
                  n_targets=512, part=256):
    import torch
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_active import (ActiveTilePixelEngine,
                                                       drain_deferred)
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
    parts = [targets[i:i + part] for i in range(0, n_targets, part)]
    wrappers = {p: fns[0] for p, fns in mm.PREDICATE_KERNELS.items()}

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
        other = "words" if path == "ratio" else "ratio"
        if launches[path][path] == 0 or launches[path][other] != 0:
            raise SystemExit(f"the {path} path did not run through its "
                             f"kernel alone: {launches[path]}")
        scores = results[path][0]
        if 439 not in scores[0]:
            raise SystemExit(f"{path}: golden 439 missing from mask 0: "
                             f"{scores[0][:8]}")
        surv_rate = 1.0 - stage.get("screened", 0) / pairs
        true_rate = float(np.mean(scores > thr[:, None]))
        log(f"[phase 4] {path} path: {launches[path][path]} kernel launches; "
            f"439 in mask 0's scores; stage-synced round {staged_s:.3f}s; "
            f"survivor rate {surv_rate:.4f}, true match rate "
            f"{true_rate:.4f}, peak device memory {peak / 2**30:.2f} GiB")
        log(f"[phase 4] {path} stage seconds: " + json.dumps(
            {k: round(v, 4) for k, v in stage.items() if k != "screened"}))
    for a, b in zip(results["ratio"], results["words"]):
        if not np.array_equal(a, b):
            raise SystemExit("the word path's scores differ from the ratio "
                             "path's")
    log(f"[phase 4] word path == ratio path on all {pairs} pairs "
        f"(scores and mirrored flags)")
    # timed rounds, no stage syncs, the CLI's loop as it runs; the paths
    # in turns: ratio, words, words, ratio
    walls = {"ratio": [], "words": []}
    for path in ("ratio", "words", "words", "ratio"):
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
    packed = engines[0].pad_from_words(words)
    ranges = mm.signal_ranges_from_words(words)
    live = mm.tile_live_from_words(words)
    survivors = (screen.bounds_from_words(u_matrix, words)
                 > thr[:, None]).astype(np.int32)
    timing = {}
    for path, sweep in sweeps.items():
        (_, everyone), = sweep.groups  # one param group: every mask
        kernel, plain = mm.PREDICATE_KERNELS[path]
        t0 = time.perf_counter()
        tab = everyone.build_table(survivors, ranges, live)
        table_s = time.perf_counter() - t0
        args = table_args(everyone, tab, packed, dev)
        full_ms = cuda_ms(lambda: kernel(*args, *everyone.kernel_tail()), 3)
        log(f"[phase 4] {path}: partition 0, all masks: host launch table "
            f"{table_s:.3f}s, exact kernel {full_ms:.3f} ms "
            f"({len(tab.tgt)} rows, {len(tab.tile_list)} live (row, tile) "
            f"pairs)")

        # 32 masks' rows against the plain version
        sub = list(range(min(32, n_masks)))
        scorer = mm.MultiMaskScorer([everyone.engines[i] for i in sub])
        tab = scorer.build_table(survivors[sub], ranges, live)
        counts, args, tail = compare_scorer(
            checks, f"at size, masks 0-{sub[-1]} of partition 0 "
            f"({int(survivors[sub].sum())} survivor rows)", scorer, tab,
            packed, dev)
        # the sampled rows reproduce the sweep's scores of those masks
        defs = scorer.launch_deferred(packed, survivors[sub], ranges, live)
        sampled = np.stack([s for s, _, _ in drain_deferred(defs)])
        if not np.array_equal(sampled,
                              results[path][0][sub, :len(parts[0])]):
            raise SystemExit(f"{path}: sampled rows differ from the "
                             f"sweep's scores")
        kernel_ms = cuda_ms(lambda: kernel(*args, *tail), 5)
        plain_ms = cuda_ms(lambda: plain(*args, *tail), 1)
        log(f"[phase 4] {path}: exact kernel on the {len(sub)}-mask table "
            f"({counts.shape[0]} rows, {int(args[-3].numel())} live "
            f"tiles): {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms")
        timing[f"multimask_{path}"] = {
            "launches": launches[path][path], "ms": kernel_ms,
            "plain_ms": plain_ms}
    if profile_dir is not None:
        part_words = [engines[0].pack_raw_words(tp, dev) for tp in parts]
        u_dev = torch.from_numpy(u_matrix).to(dev)

        def bound_only():
            for wp in part_words:
                screen.bounds_from_words(u_dev, wp)
        phase_profile(lambda stage: run(sweeps["ratio"], stage), bound_only,
                      profile_dir)
    return timing


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
    log(f"[phase 5] op_chain == plain in {len(ob.CASE_NAMES)} cases; at "
        f"{ob.TIMED_STEPS} steps the ten cases take {ms:.3f} ms on the "
        f"kernel, {plain_ms:.3f} ms plain")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="add a torch.profiler round; write its trace to DIR")
    opts = ap.parse_args()
    import torch
    missing = [p for p in [src for src, _ in KERNELS.values()]
               + ["colormipsearch_tpu/cds/oracle.py",
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
    phase_card()
    checks = {name: Check(name) for name in
              ("multimask_ratio", "multimask_words")}
    phase_kernel_vs_plain(checks, dev)
    with tempfile.TemporaryDirectory() as ws:
        phase_cli(ws, "1")
        phase_cli(ws, "0")
    timing = phase_at_size(checks, dev, opts.profile)
    timing["op_chain"] = phase_microbench(dev)
    for name, check in checks.items():
        timing[name]["max_abs_err"] = check.max_abs_err
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": timing[name]["launches"],
         "max_abs_err": timing[name]["max_abs_err"],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
