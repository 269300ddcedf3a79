"""Driver: colorDepthSearch grid jobs, one after another, in-process.

Entry: `colormipsearch_torch.cmd.colordepthsearch_cmd.run`, through the
port's own parser, as `python -m colormipsearch_torch colorDepthSearch`
runs it: `--mips-storage db` over the run's SQLite store, one grid block
of masks per job (`--masks-index/--masks-length`) against every target,
in partitions of the configuration's size. Set-up writes the library
(child process), ingests it and runs the first block once (the warm-up:
kernels built, every shape seen); the window takes the next blocks in
turn. Each job stamps its masks with a tag of its own, by which the check
finds the masks that the window searched.

Check: a sample of the window's masks, drawn from the seed, against every
target: the reference's scores say which pairs are matches (pixels > 0,
pixels / query size above pctPositivePixels), and the rows that the last
job to search each mask wrote (the rows carrying its tag; an older job's
row that it did not rewrite counts as missing) must be exactly those,
with the reference's pixels, ratio and mirrored flag. A pair that the
prescreen wrongly drops is a missing row; a wrong count from the exact
kernel or the match building, a wrong value.

Control: the same comparison with the reference's bfloat16 colour test
in the program's place.
"""

from __future__ import annotations

import os

import numpy as np

from cdsbench import stores
from cdsbench.reference import pixel as ref
from cdsbench.traffic import generate as gen


def _argv(run, db: str, block: int, tag: str) -> list:
    p, n = run.params, int(run.traffic["block_masks"])
    argv = ["colorDepthSearch", "--mips-storage", "db", "--db", db,
            "-m", stores.EM_LIB, "-i", stores.LM_LIB,
            "--maskThreshold", str(p["maskThreshold"]),
            "--dataThreshold", str(p["dataThreshold"]),
            "--pixColorFluctuation", str(p["pixColorFluctuation"]),
            "--xyShift", str(p["xyShift"]),
            "--pctPositivePixels", str(p["pctPositivePixels"]),
            "-ps", str(p["processingPartitionSize"]),
            "--prescreen", p["prescreen"],
            "--masks-index", str(block * n), "--masks-length", str(n),
            "--processing-tag", tag, "--device", run.device]
    return argv + (["--mirrorMask"] if p["mirrorMask"] else [])


def setup(run):
    os.environ["CMS_RATIO_PRED"] = "1" if run.params["predicate"] == \
        "ratio" else "0"
    lib, db = stores.build_store(run, run.traffic)
    stores.cli(_argv(run, db, 0, "warmup"))
    return {"lib": lib, "db": db, "next": 1, "tags": [],
            "blocks": int(run.traffic["masks"])
            // int(run.traffic["block_masks"])}


def step(run, state):
    tag = f"window{len(state['tags'])}"
    mark = len(run.logs.records)
    stores.cli(_argv(run, state["db"], state["next"] % state["blocks"], tag))
    state["next"] += 1
    state["tags"].append(tag)
    rec = run.rec
    for n_masks, n_targets in run.logs.since(mark, "read %d masks"):
        rec["pairs"] += n_masks * n_targets
        rec["attempted"] = rec.get("attempted", 0) + n_masks * n_targets
        rec["masks"] = rec.get("masks", 0) + n_masks
        rec["targets"] = rec.get("targets", 0) + n_targets
    for n, secs in run.logs.since(mark, "prepared %d mask engines"):
        rec["prep_s"] = rec.get("prep_s", 0.0) + secs
    for (totals,) in run.logs.since(mark, "stage times"):
        run.add_stage(totals)


def spans(run):
    from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
    from colormipsearch_torch.cds.prescreen import PairPrescreen
    from colormipsearch_torch.cmd import colordepthsearch_cmd as cmd
    from colormipsearch_torch.dataio.db import DBCDMIPsWriter, SqliteStore
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    return [(cmd, "_read_mips", "cds.read"),
            (ActiveTilePixelEngine, "__init__", "cds.prep"),
            (PairPrescreen, "query_features", "cds.features"),
            (cmd, "_load_target_images", "cds.decode"),
            (TwoPhaseSweep, "launch", "sweep.launch"),
            (TwoPhaseSweep, "collect", "sweep.collect"),
            (SqliteStore, "upsert_matches", "store.write"),
            (DBCDMIPsWriter, "add_processing_tags", "store.tags")]


def after(run, state):
    import gc
    gc.collect()


def _rows(run, m_px, t_px, masks, targets,
          precision: str = "exact") -> dict:
    """The rows that a search stores for these masks against these targets,
    by the reference at `precision`: (mask, target) -> (pixels, ratio,
    mirrored)."""
    p = run.params
    scores, mirrored, qsize = ref.block_scores(
        list(m_px), t_px, mask_threshold=p["maskThreshold"],
        data_threshold=p["dataThreshold"],
        zt9=round(p["pixColorFluctuation"] * 10_000_000),
        xy_shift=p["xyShift"], mirror=p["mirrorMask"],
        device=run.device, precision=precision)
    rows = {}
    for i, m in enumerate(masks):
        for j, t in enumerate(targets):
            s = int(scores[i, j])
            if ref.is_match(s, int(qsize[i]), p["pctPositivePixels"]):
                rows[(m, t)] = (s, float(np.float32(s / qsize[i])),
                                bool(mirrored[i, j]))
    return rows


def _sample(run, masks: list) -> list:
    k = min(int(run.traffic["sample_masks"]), len(masks))
    return sorted(gen.rng(run.seed, "sample").choice(
        masks, size=k, replace=False).tolist())


def check(run, state):
    db = state["db"]
    mips = stores.neurons(db)
    window = {t: i for i, t in enumerate(state["tags"])}
    last = {}   # mask -> the tag of the window's last job that searched it
    for e, n in mips.items():
        seen = [window[t] for t in n["tags"].get("ColorDepthSearch", [])
                if t in window]
        if n["library"] == stores.EM_LIB and seen:
            last[e] = state["tags"][max(seen)]
    targets = sorted((e for e, n in mips.items()
                      if n["library"] == stores.LM_LIB),
                     key=lambda e: mips[e]["file"])
    sample = _sample(run, sorted(last))
    d = state["lib"]["dir"]
    m_px = stores.decode([os.path.join(d, "ems", mips[e]["file"])
                          for e in sample])
    t_px = stores.decode([os.path.join(d, "lms", mips[e]["file"])
                          for e in targets])
    want = _rows(run, m_px, t_px, sample, targets)
    got = {(r[0], r[1]): (r[2], r[3], bool(r[4]))
           for r in stores.match_rows(db, sample)
           if last[r[0]] in r[9]}
    run.rec["failed"] = stores.error_rows(db)
    run.rec["checked"] = len(sample) * len(targets)
    return {"mismatched_pairs": (stores.mismatches(want, got), 0)}


def control(run, precision: str):
    tr = run.traffic
    masks = gen.mask_frames(tr, run.seed)
    targets = gen.target_frames(tr, run.seed)
    sample = _sample(run, list(range(len(masks))))
    names = list(range(len(targets)))
    m_px = [masks[i] for i in sample]
    want = _rows(run, m_px, targets, sample, names)
    got = _rows(run, m_px, targets, sample, names, precision)
    run.rec["checked"] = len(sample) * len(targets)
    return {"mismatched_pairs": (stores.mismatches(want, got), 0)}
