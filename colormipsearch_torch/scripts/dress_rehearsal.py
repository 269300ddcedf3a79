"""Production-scale dress rehearsal of the port: the whole CLI pipeline,
one process per stage, over one SQLite store.

Counterpart of `scripts/dress_rehearsal.py` (the JAX package's
rehearsal): the same library, the same stages with the same arguments,
run by `python -m colormipsearch_torch` (default 2048 masks x 2048
targets = 4.2M pairs; production is 44,593 x 7,391 = 3.3e8, reference
cdsparams.sh:6-13):

    generate library  ->  createColorDepthSearchDataInput (EM, then LM
                                                   with its grad and zgap
                                                   variants)
                      ->  colorDepthSearch        (--mips-storage db,
                                                   -ps 500)
                      ->  gradientScores          (nBestLines 300, in
                                                   --ga-blocks sequential
                                                   process blocks)
                      ->  normalizeGradientScores
                      ->  exportData EM_CD_MATCHES

Each stage is its own process, as production drives the CLI. Per stage
it records the wall clock and the peak host RSS (VmHWM polled from /proc
every 0.5 s, or the largest VmRSS sample where the kernel keeps no
VmHWM) and writes its output to <workdir>/<stage>.log; at the end
the store's size and counts. Everything goes to <workdir>/rehearsal.json,
which is also written before the script exits on a failed stage.

The library is production-shaped, not adversarial: masks and targets
are regional crops (rolled, then banded: masks to 224 rows, targets to
160) of the golden fixtures. Each target has a true distance-transform
gradient file and a z-gap file (mask(20) then a radius-10 dilation of
the base frame), rolled and banded with it. The files are byte-identical
to those of the JAX package's generator at the same sizes.

The device stages run on the card (`--device cuda`) unless --cpu is
given (`--device cpu`, each kernel's plain version); without a card the
first device stage fails and the script exits non-zero.

Usage:
    python -m colormipsearch_torch.scripts.dress_rehearsal WORKDIR \
        [--masks 2048] [--targets 2048] [--skip-generate] \
        [--skip-through STAGE] [--ga-blocks 4] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sqlite3
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "cdsearch")
AS = "JRC2018_Unisex_20x_HR"
STAGES = ["generate", "import_em", "import_lm", "cds", "ga", "normalize",
          "export"]


def _log(msg: str) -> None:
    print(f"[rehearsal +{time.strftime('%H:%M:%S')}] {msg}", flush=True)


# ---------------------------------------------------------------- library

def _roll(px, i, h, w):
    import numpy as np
    if i == 0:
        return px
    return np.roll(px, ((37 * i) % h, (151 * i) % w), axis=(0, 1))


def _band(px, i, bh, step, h):
    import numpy as np
    if i == 0:
        return px
    b0 = (step * i) % (h - bh)
    out = np.zeros_like(px)
    out[b0:b0 + bh] = px[b0:b0 + bh]
    return out


def generate_library(wd: str, n_masks: int, n_targets: int) -> dict:
    """Write the on-disk library: ems/ lms/ grad/ zgap/ PNG stores with
    the EM-skeleton / LM-slide-code naming conventions
    (cmd/mipstores.py) so createColorDepthSearchDataInput indexes them
    exactly like production stores."""
    import numpy as np
    from PIL import Image as PILImage
    from scipy import ndimage

    from ..cds.shape_oracle import compute_zgap_image
    from ..imageproc.io import Image, ImageKind, load_image

    for d in ("ems", "lms", "grad", "zgap"):
        os.makedirs(os.path.join(wd, d), exist_ok=True)

    em_px = [load_image(os.path.join(FIXTURES, "ems", n)).pixels
             for n in sorted(os.listdir(os.path.join(FIXTURES, "ems")))]
    lm_names = sorted(os.listdir(os.path.join(FIXTURES, "lms")))
    lm_px = [load_image(os.path.join(FIXTURES, "lms", n)).pixels
             for n in lm_names]
    h, w = em_px[0].shape[:2]

    # per-base-LM gradient (true distance transform, capped u8) and
    # z-gap (the real clearRegions->mask(20)->dilate(10) recipe)
    base_grad, base_zgap = [], []
    for px in lm_px:
        signal = (px > 20).any(axis=2)
        dist = ndimage.distance_transform_edt(~signal)
        base_grad.append(np.minimum(dist, 255).astype(np.uint8))
        base_zgap.append(compute_zgap_image(Image(ImageKind.RGB, px), 20,
                                            None))

    t0 = time.perf_counter()

    def write_png(path, arr):
        PILImage.fromarray(arr).save(path, compress_level=1)

    def one_mask(i):
        px = _band(_roll(em_px[i % len(em_px)], i // len(em_px), h, w),
                   i, 224, 71, h)
        write_png(os.path.join(wd, "ems",
                               f"{90000000 + i}-{AS}-CDM.png"), px)

    def one_target(i):
        stem = (f"LINE{i:05d}-20{(i % 25):02d}0{1 + i % 9}{10 + i % 18}_"
                f"{60 + i % 40}_A{1 + i % 9}-f-40x-{AS}-CH1_01")
        b = i % len(lm_px)
        roll_i, band_args = i // len(lm_px), (i, 160, 53, h)
        px = _band(_roll(lm_px[b], roll_i, h, w), *band_args)
        write_png(os.path.join(wd, "lms", stem + ".png"), px)
        write_png(os.path.join(wd, "grad", stem + ".png"),
                  _band(_roll(base_grad[b], roll_i, h, w), *band_args))
        write_png(os.path.join(wd, "zgap", stem + ".png"),
                  _band(_roll(base_zgap[b], roll_i, h, w), *band_args))

    with ThreadPoolExecutor(max_workers=max(4, (os.cpu_count() or 2))) as ex:
        list(ex.map(one_mask, range(n_masks)))
        list(ex.map(one_target, range(n_targets)))
    wall = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for d in ("ems", "lms", "grad", "zgap")
                 for r, _, fs in os.walk(os.path.join(wd, d)) for f in fs)
    _log(f"generated {n_masks} masks + {n_targets} x3 target files "
         f"({nbytes / 1e9:.2f} GB) in {wall:.1f}s")
    return {"wall_s": round(wall, 1), "library_bytes": nbytes}


# ---------------------------------------------------------------- stages

def _checkpoint(results: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump({k: v for k, v in results.items()
                   if not k.startswith("_")}, f, indent=2)


def run_stage(name: str, cmd: list, results: dict) -> None:
    """Run one pipeline stage as a subprocess; record wall + peak RSS
    (VmHWM polled at 0.5 s; where /proc/<pid>/status has no VmHWM, as
    under some container kernels, the largest VmRSS sample) + the live
    log tail."""
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", REPO)
    _log(f"stage {name}: {' '.join(cmd)}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    peak_kb = 0
    stop = threading.Event()

    def poll():
        nonlocal peak_kb
        while not stop.is_set():
            try:
                with open(f"/proc/{proc.pid}/status") as f:
                    status = dict(line.split(":", 1) for line in f
                                  if ":" in line)
            except OSError:
                return
            kb = status.get("VmHWM") or status.get("VmRSS")
            if kb:
                peak_kb = max(peak_kb, int(kb.split()[0]))
            stop.wait(0.5)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    tail = []
    log_f = open(os.path.join(results["_log_dir"], f"{name}.log"), "w") \
        if results.get("_log_dir") else None
    for line in proc.stdout:
        tail.append(line.rstrip())
        if len(tail) > 40:
            tail.pop(0)
        if log_f:
            log_f.write(line)
            log_f.flush()
    if log_f:
        log_f.close()
    rc = proc.wait()
    stop.set()
    th.join(timeout=2)
    wall = time.perf_counter() - t0
    results[name] = {"wall_s": round(wall, 1),
                     "peak_rss_gb": round(peak_kb / 1e6, 2),
                     "rc": rc}
    _log(f"stage {name}: rc={rc} wall={wall:.1f}s "
         f"peakRSS={peak_kb / 1e6:.2f}GB")
    if rc != 0:
        # record the failure in the checkpoint BEFORE bailing (a killed
        # stage, such as an out-of-memory kill, must show up in
        # rehearsal.json)
        _checkpoint(results, os.path.join(results.get("_log_dir", "."),
                                          "rehearsal.json"))
        print("\n".join(tail[-30:]))
        raise SystemExit(f"stage {name} failed rc={rc}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir")
    ap.add_argument("--masks", type=int, default=2048)
    ap.add_argument("--targets", type=int, default=2048)
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--skip-through", default=None, choices=STAGES,
                    help="skip stages up to and including this one "
                         "(resume a partial run)")
    ap.add_argument("--ga-blocks", type=int, default=4,
                    help="sequential gradientScores process blocks "
                         "(--process-id/--process-count), as the "
                         "reference's LSF job sizing")
    ap.add_argument("--cpu", action="store_true",
                    help="run the device stages with --device cpu (each "
                         "kernel's plain version)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    db = os.path.join(wd, "store.db")
    results: dict = {"config": {"masks": args.masks,
                                "targets": args.targets,
                                "pairs": args.masks * args.targets,
                                "cpu": args.cpu}}
    results_path = os.path.join(wd, "rehearsal.json")
    # resume-friendly: keep stage entries an earlier partial run recorded
    if os.path.exists(results_path):
        with open(results_path) as f:
            prior = json.load(f)
        for k, v in prior.items():
            results.setdefault(k, v)
    results["_log_dir"] = wd   # per-stage live logs: <wd>/<stage>.log

    def checkpoint():
        _checkpoint(results, results_path)

    device = ["--device", "cpu" if args.cpu else "cuda"]
    skip_upto = (STAGES.index(args.skip_through) + 1
                 if args.skip_through else 0)

    def due(stage):
        return STAGES.index(stage) >= skip_upto

    if due("generate") and not args.skip_generate:
        results["generate"] = generate_library(wd, args.masks, args.targets)
        checkpoint()

    py = [sys.executable, "-m", "colormipsearch_torch"]
    if due("import_em"):
        run_stage("import_em", py + [
            "createColorDepthSearchDataInput", "--library",
            "flyem_rehearsal", "--cdm-location", os.path.join(wd, "ems"),
            "-as", AS, "--db", db, "--tag", "rehearsal"], results)
        checkpoint()
    if due("import_lm"):
        run_stage("import_lm", py + [
            "createColorDepthSearchDataInput", "--library",
            "flylight_rehearsal", "--cdm-location", os.path.join(wd, "lms"),
            "--variant", f"grad:{os.path.join(wd, 'grad')}",
            "--variant", f"zgap:{os.path.join(wd, 'zgap')}",
            "-as", AS, "--db", db, "--tag", "rehearsal"], results)
        checkpoint()
    if due("cds"):
        # production CDS params (cdsparams.sh:42-46, partition :17)
        run_stage("cds", py + [
            "colorDepthSearch", "--mips-storage", "db", "--db", db,
            "-m", "flyem_rehearsal", "-i", "flylight_rehearsal",
            "--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1", "--xyShift", "2",
            "--mirrorMask", "--pctPositivePixels", "1",
            "--engine", "pallas", "-ps", "500",
            "--processing-tag", "rehearsal", *device], results)
        results["cds"]["pairs_per_s"] = round(
            args.masks * args.targets / results["cds"]["wall_s"], 1)
        checkpoint()
    if due("ga"):
        # production GA selection: top 300 lines/mask (cdsparams.sh:63),
        # run as SEQUENTIAL process grid blocks (--process-id/
        # --process-count) like the reference's LSF job sizing
        # (MIP_IDS_PER_JOB=100, cdsparams.sh:60): bounded blocks also
        # bound each process's host memory
        ga_blocks = args.ga_blocks
        for b in range(ga_blocks):
            run_stage(f"ga_b{b}", py + [
                "gradientScores", "--db", db,
                "--maskThreshold", "20", "--mirrorMask",
                "--nBestLines", "300", "--targetsPerBatch", "128",
                "--process-id", str(b), "--process-count",
                str(ga_blocks), "--processing-tag", "rehearsal-ga",
                *device], results)
            checkpoint()
        results["ga"] = {
            "wall_s": round(sum(results[f"ga_b{b}"]["wall_s"]
                                for b in range(ga_blocks)), 1),
            "peak_rss_gb": max(results[f"ga_b{b}"]["peak_rss_gb"]
                               for b in range(ga_blocks)),
            "rc": 0, "blocks": ga_blocks}
        checkpoint()
    if due("normalize"):
        run_stage("normalize", py + [
            "normalizeGradientScores", "--db", db], results)
        checkpoint()
    if due("export"):
        export_dir = os.path.join(wd, "export")
        run_stage("export", py + [
            "exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--db", db, "-od", export_dir,
            "--default-image-store", "fl:rehearsal:brain",
            "--validation", "off"], results)
        n_files = len(os.listdir(export_dir)) if os.path.isdir(export_dir) \
            else 0
        results["export"]["files_written"] = n_files
        checkpoint()

    if os.path.exists(db):
        results["store_bytes"] = os.path.getsize(db)
    # GA match count for matches/s
    try:
        conn = sqlite3.connect(db)
        try:
            n_matches = conn.execute(
                "SELECT COUNT(*) FROM cd_matches").fetchone()[0]
            n_ga = conn.execute(
                "SELECT COUNT(*) FROM cd_matches WHERE "
                "json_extract(doc, '$.gradientAreaGap') IS NOT NULL"
            ).fetchone()[0]
        finally:
            conn.close()
        results["matches_written"] = n_matches
        results["ga_matches_scored"] = n_ga
        if "ga" in results and results["ga"]["wall_s"]:
            results["ga"]["matches_per_s"] = round(
                n_ga / results["ga"]["wall_s"], 1)
    except sqlite3.Error as e:  # keep the report best-effort
        results["store_query_error"] = str(e)
    checkpoint()
    _log(json.dumps({k: v for k, v in results.items()
                     if not k.startswith("_")}, indent=2))


if __name__ == "__main__":
    main()
