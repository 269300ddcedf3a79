#!/usr/bin/env python3
"""Smoke test of colormipsearch_torch on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card (Hopper, sm_90a) and nvcc; it builds the package's kernel from
the sources in the checkout and drives the colorDepthSearch path:

1. card: nvidia-smi name and power limit; kernel build time;
2. kernel against its plain PyTorch version, exactly, on a random library
   of full 566x1210 frames (16 masks x 64 targets): sparse and dense
   survivors, a mask with zero survivors, one survivor at the last target,
   a mask with more than 128 active tiles, mirror off, xyShift 0, with
   and without the live-tile cut, and launch rows whose survivor flag is
   0;
3. the CLI (`colormipsearch_torch colorDepthSearch --device cuda`) on the
   three golden fixtures: 439 / 414 / 426, the last one mirrored;
4. at size: TwoPhaseSweep over 1024 masks x 512 targets (two 256-target
   partitions) of the adversarial library built from the fixtures (rolled
   and banded frames, label-region exclusion, 1% keep threshold); 439
   among mask 0's scores, kernel launches > 0, 32 masks' rows equal to
   the plain version; pairs/s, survivor rate, stage seconds, peak memory.
   The timed round is the pipelined partition loop of the CLI
   (`TwoPhaseSweep.sweep_parts`).

`python3 chip_smoke.py --profile DIR` adds a torch.profiler round of the
phase-4 sweep: device busy share, the bound's and the exact kernel's
device time, the top device kernels, and a Chrome trace in DIR.

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
KERNEL_NAME = "multimask_ratio"


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


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Check:
    """Kernel against plain comparisons: worst error and timings."""

    def __init__(self):
        self.max_abs_err = 0
        self.cases = 0

    def compare(self, label, args, xy_shift, mirror):
        import torch
        from colormipsearch_torch.cds import multimask as mm
        got = mm.multimask_counts(*args, xy_shift, mirror)
        want = mm.multimask_counts_plain(*args, xy_shift, mirror)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
                  ) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        log(f"  {label}: rows {got.shape[0]}, live tiles "
            f"{int(args[6].numel())}, max |kernel - plain| = {err}")
        if not torch.equal(got, want):
            raise SystemExit(f"kernel disagrees with its plain version: "
                             f"{label}")
        return got


def table_args(scorer, tab, packed, dev):
    import torch
    return (list(packed) + list(scorer._q_for(dev))
            + [torch.from_numpy(a).to(dev) for a in
               (tab.row_off, tab.tile_list, tab.tgt, tab.surv)])


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
    kl = kernels.load_library()
    log(f"[build] kernel library built in {kl.build_seconds:.2f}s: {kl.path}")
    for line in kl.build_log.splitlines():
        if "registers" in line or "smem" in line or "error" in line:
            log(f"[build] {line.strip()}")
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


def phase_kernel_vs_plain(check, dev, n_masks=16, n_targets=64):
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
    for xy_shift, mirror in ((2, True), (2, False), (0, True)):
        engines = [ActiveTilePixelEngine(m, 20, mirror, 20, 1.0, xy_shift)
                   for m in masks]
        if xy_shift == 2 and mirror:
            n_act = [e.tiles.n_active for e in engines]
            log(f"  active tiles per mask: {n_act}")
            if max(n_act) <= 128:
                raise SystemExit("no mask above 128 active tiles")
        words = engines[0].pack_raw_words(targets, dev)
        packed = engines[0].pad_from_words(words)
        ranges = mm.signal_ranges_from_words(words)
        live = mm.tile_live_from_words(words)
        scorer = mm.MultiMaskScorer(engines)
        for restrict in (False, True):
            tab = (scorer.build_table(surv, ranges, live) if restrict
                   else scorer.build_table(surv))
            check.compare(f"xyShift {xy_shift}, mirror {mirror}, live-tile "
                          f"cut {restrict}",
                          table_args(scorer, tab, packed, dev), xy_shift,
                          mirror)
        tab.surv[::3] = 0  # rows the kernel must report as 0
        check.compare(f"xyShift {xy_shift}, mirror {mirror}, every third "
                      f"row's survivor flag 0",
                      table_args(scorer, tab, packed, dev), xy_shift, mirror)
    log(f"[phase 2] kernel == plain in {check.cases} cases "
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


def phase_cli(ws):
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cmd.main import main
    write_workspace(ws)
    out = os.path.join(ws, "out")
    before = mm.multimask_counts.launches
    t0 = time.perf_counter()
    rc = main(["colorDepthSearch", "-m", os.path.join(ws, "masks.json"),
               "-i", os.path.join(ws, "targets.json"),
               "--maskThreshold", "20", "--dataThreshold", "20",
               "--pixColorFluctuation", "1", "--xyShift", "2",
               "--mirrorMask", "--device", "cuda", "-od", out])
    if rc != 0:
        raise SystemExit(f"colorDepthSearch exited {rc}")
    with open(os.path.join(out, "masks", "em-12191.json")) as f:
        doc = json.load(f)
    res = {r["image"]["mipId"]: r for r in doc["results"]}
    got = [(k, res[k]["matchingPixels"], res[k]["mirrored"])
           for k in ("lm-0", "lm-1", "lm-2")]
    log(f"[phase 3] CLI goldens {got} in {time.perf_counter() - t0:.1f}s, "
        f"kernel launches {mm.multimask_counts.launches - before}")
    if got != [("lm-0", 439, False), ("lm-1", 414, False),
               ("lm-2", 426, True)]:
        raise SystemExit(f"CLI goldens wrong: {got}")
    if mm.multimask_counts.launches == before:
        raise SystemExit("the CLI run launched no kernel")


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


def phase_at_size(check, dev, profile_dir=None, n_masks=1024,
                  n_targets=512, part=256):
    import torch
    from colormipsearch_torch.cds import multimask as mm
    from colormipsearch_torch.cds.pixel_active import (ActiveTilePixelEngine,
                                                       drain_deferred)
    from colormipsearch_torch.cds.prescreen import PairPrescreen
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep

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
    sweep = TwoPhaseSweep(engines, [dev], screen, u_matrix, thr)
    log(f"[phase 4] {n_masks} masks x {n_targets} targets; engines and "
        f"query features in {time.perf_counter() - t0:.1f}s; mean active "
        f"tiles {np.mean([e.tiles.n_active for e in engines]):.1f}")
    parts = [targets[i:i + part] for i in range(0, n_targets, part)]

    def run(stage, sync=False):
        """The CLI's partition loop: partition p+1 is launched before p is
        collected."""
        scores = [s for _, s, _ in sweep.sweep_parts(enumerate(parts), stage,
                                                     sync)]
        torch.cuda.synchronize(dev)
        return np.concatenate(scores, axis=1)

    # stage round: every stage synchronizes, so each stage's seconds hold
    # its device work; the main-path kernel launch count is read around
    # this run
    mm.multimask_counts.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    stage = {}
    t0 = time.perf_counter()
    scores = run(stage, sync=True)
    staged_s = time.perf_counter() - t0
    launches = mm.multimask_counts.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if launches == 0:
        raise SystemExit("the main path launched no kernel")
    # timed round: no stage syncs, the CLI's loop as it runs
    t0 = time.perf_counter()
    scores2 = run(None)
    wall = time.perf_counter() - t0
    if not np.array_equal(scores, scores2):
        raise SystemExit("two runs of the sweep disagree")
    if 439 not in scores[0]:
        raise SystemExit(f"golden 439 missing from mask 0: {scores[0][:8]}")
    pairs = n_masks * n_targets
    surv_rate = 1.0 - stage.get("screened", 0) / pairs
    true_rate = float(np.mean(scores > thr[:, None]))
    log(f"[phase 4] main path: {launches} kernel launches; 439 in mask 0's "
        f"scores; {pairs} pairs in {wall:.3f}s = {pairs / wall:.1f} pairs/s "
        f"(stage-synced round {staged_s:.3f}s)")
    log(f"[phase 4] survivor rate {surv_rate:.4f}, true match rate "
        f"{true_rate:.4f}, peak device memory {peak / 2**30:.2f} GiB")
    log("[phase 4] stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in stage.items() if k != "screened"}))

    # partition 0's tables, as the sweep builds them
    words = engines[0].pack_raw_words(parts[0], dev)
    packed = engines[0].pad_from_words(words)
    ranges = mm.signal_ranges_from_words(words)
    live = mm.tile_live_from_words(words)
    survivors = (screen.bounds_from_words(u_matrix, words)
                 > thr[:, None]).astype(np.int32)
    (_, everyone), = sweep.groups  # one param group: every mask
    t0 = time.perf_counter()
    tab = everyone.build_table(survivors, ranges, live)
    table_s = time.perf_counter() - t0
    args = table_args(everyone, tab, packed, dev)
    full_ms = cuda_ms(lambda: mm.multimask_counts(*args, 2, True), 3)
    log(f"[phase 4] partition 0, all masks: host launch table "
        f"{table_s:.3f}s, exact kernel {full_ms:.3f} ms ({len(tab.tgt)} "
        f"rows, {len(tab.tile_list)} live (row, tile) pairs)")

    # 32 masks' rows against the plain version
    sub = list(range(32))
    scorer = mm.MultiMaskScorer([engines[i] for i in sub])
    tab = scorer.build_table(survivors[sub], ranges, live)
    args = table_args(scorer, tab, packed, dev)
    counts = check.compare(f"at size, masks 0-31 of partition 0 "
                           f"({int(survivors[sub].sum())} survivor rows)",
                           args, 2, True)
    # the sampled rows reproduce the sweep's scores of those masks
    defs = scorer.launch_deferred(packed, survivors[sub], ranges, live)
    sampled = np.stack([s for s, _, _ in drain_deferred(defs)])
    if not np.array_equal(sampled, scores[sub, :len(parts[0])]):
        raise SystemExit("sampled rows differ from the sweep's scores")
    kernel_ms = cuda_ms(lambda: mm.multimask_counts(*args, 2, True), 5)
    plain_ms = cuda_ms(lambda: mm.multimask_counts_plain(*args, 2, True), 1)
    log(f"[phase 4] exact kernel on the 32-mask table ({counts.shape[0]} "
        f"rows, {int(args[6].numel())} live tiles): {kernel_ms:.3f} ms, "
        f"plain version {plain_ms:.3f} ms")
    if profile_dir is not None:
        part_words = [engines[0].pack_raw_words(tp, dev) for tp in parts]
        u_dev = torch.from_numpy(u_matrix).to(dev)

        def bound_only():
            for wp in part_words:
                screen.bounds_from_words(u_dev, wp)
        phase_profile(run, bound_only, profile_dir)
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="add a torch.profiler round; write its trace to DIR")
    opts = ap.parse_args()
    import torch
    missing = [p for p in ("colormipsearch_torch/csrc/multimask_ratio.cu",
                           "colormipsearch_tpu/cds/oracle.py",
                           "tests/fixtures/cdsearch/ems")
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
    check = Check()
    phase_kernel_vs_plain(check, dev)
    with tempfile.TemporaryDirectory() as ws:
        phase_cli(ws)
    timing = phase_at_size(check, dev, opts.profile)
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "colormipsearch_torch/csrc/multimask_ratio.cu",
        "replaces": "colormipsearch_tpu/cds/multimask.py:326",
        "launches": timing["launches"], "max_abs_err": check.max_abs_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
