"""The job cells' libraries and stores: PNG libraries written by a child
process, ingested by the port's own command into an SQLite store under the
run's working directory, and read back by the store's schema (the
production store's tables, `neuron_metadata` and `cd_matches`).
"""

from __future__ import annotations

import json
import os
import sqlite3
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from .traffic import generate as gen

EM_LIB = "flyem_bench"
LM_LIB = "flylight_bench"


def cli(argv: List[str]) -> int:
    """One command of the port, in this process, as `python -m
    colormipsearch_torch` runs it (parsed by its own parser; the store
    connections it opened closed when it returns)."""
    from colormipsearch_torch.cmd.backends import close_stores
    from colormipsearch_torch.cmd.main import build_parser
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    finally:
        close_stores()


def build_store(run, spec: dict):
    """Write the cell's library (child process) and ingest it: masks as
    the EM library, targets (with their gradient and z-gap variants) as
    the LM library. Returns (manifest, store path)."""
    lib = gen.write_library_child(spec, run.seed,
                                  os.path.join(run.workdir, "lib"))
    db = os.path.join(run.workdir, "store.db")
    d = lib["dir"]
    cli(["createColorDepthSearchDataInput", "--library", EM_LIB,
         "--cdm-location", os.path.join(d, "ems"), "-as", gen.AS,
         "--db", db])
    lm = ["createColorDepthSearchDataInput", "--library", LM_LIB,
          "--cdm-location", os.path.join(d, "lms"), "-as", gen.AS,
          "--db", db]
    if lib["variants"]:
        lm += ["--variant", f"grad:{os.path.join(d, 'grad')}",
               "--variant", f"zgap:{os.path.join(d, 'zgap')}"]
    cli(lm)
    return lib, db


def neurons(db: str) -> Dict[int, dict]:
    """entity id -> {library, mip_id, file (its CDM's base name),
    processed tags} of every MIP in the store."""
    out = {}
    with sqlite3.connect(db) as conn:
        for eid, mip, lib, doc in conn.execute(
                "SELECT entity_id, mip_id, library_name, doc "
                "FROM neuron_metadata"):
            d = json.loads(doc)
            out[int(eid)] = {
                "library": lib, "mip_id": mip,
                "file": os.path.basename(
                    d["computeFiles"]["InputColorDepthImage"]),
                "tags": d.get("processedTags") or {}}
    return out


def match_rows(db: str, mask_refs) -> List[tuple]:
    """(mask_ref, matched_ref, matching_pixels, matching_pixels_ratio,
    mirrored, gradient_area_gap, high_expression_area, normalized_score,
    errors, tags) of the store's matches of these masks."""
    refs = [int(r) for r in mask_refs]
    with sqlite3.connect(db) as conn:
        rows = []
        for r in conn.execute(
                "SELECT mask_ref, matched_ref, matching_pixels, "
                "matching_pixels_ratio, mirrored, gradient_area_gap, "
                "high_expression_area, normalized_score, doc "
                f"FROM cd_matches WHERE mask_ref IN "
                f"({','.join('?' * len(refs))})", refs):
            doc = json.loads(r[8])
            rows.append(r[:8] + (doc.get("errors"), doc.get("tags") or []))
        return rows


def mismatches(want: dict, got: dict) -> int:
    """Keys whose answers differ, or that one side lacks."""
    return sum(want.get(k) != got.get(k) for k in set(want) | set(got))


def error_rows(db: str) -> int:
    """Matches the search or the scorer recorded as failed."""
    with sqlite3.connect(db) as conn:
        return int(conn.execute(
            "SELECT COUNT(*) FROM cd_matches WHERE "
            "json_extract(doc, '$.errors') IS NOT NULL").fetchone()[0])


def decode(paths: List[str], gray: bool = False) -> np.ndarray:
    """Decode PNGs on a thread pool into one stacked array."""
    from PIL import Image

    def one(p):
        with Image.open(p) as im:
            return np.array(im.convert("L" if gray else "RGB"), np.uint8)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return np.stack(list(pool.map(one, paths)))


def draw_matches(run, n_masks: int, n_targets: int) -> list:
    """Each mask's CDS matches, drawn from the seed: `matches_per_mask`
    targets without replacement and a pixel score for each. [(target
    indices, pixel scores)] by mask index."""
    g = gen.rng(run.seed, "matches")
    k = int(run.traffic["matches_per_mask"])
    return [(g.choice(n_targets, size=k, replace=False),
             g.integers(100, 5000, size=k)) for _ in range(n_masks)]


def write_matches(db: str, lib: dict, drawn: list) -> List[str]:
    """Write the drawn matches through the port's store API, as a
    colorDepthSearch run would leave them; returns each mask's mip id."""
    from colormipsearch_torch.cmd.backends import (close_stores, get_store,
                                                   matches_writer)
    from colormipsearch_torch.dataio import DataSourceParam
    from colormipsearch_torch.dataio.db import DBCDMIPsReader
    from colormipsearch_torch.model import CDMatchEntity, ComputeFileType
    reader = DBCDMIPsReader(get_store(db))

    def by_file(library):
        return {os.path.basename(e.compute_files[
            ComputeFileType.InputColorDepthImage].name): e
            for e in reader.read_mips(DataSourceParam(libraries=[library]))}

    em, lm = by_file(EM_LIB), by_file(LM_LIB)
    masks = [em[f] for f in lib["masks"]]
    targets = [lm[f] for f in lib["targets"]]
    rows = []
    for mask, (t_idx, pixels) in zip(masks, drawn):
        for t, px in zip(t_idx, pixels):
            m = CDMatchEntity()
            m.mask_image, m.matched_image = mask, targets[int(t)]
            m.matching_pixels = int(px)
            m.matching_pixels_ratio = float(np.float32(px / 10000))
            m.match_found = True
            m.session_ref_id = "bench"
            rows.append(m)
    matches_writer(db, None).write(rows)
    close_stores()
    return [m.mip_id for m in masks]


def ga_expected(run, lib: dict, mask_i: int, drawn: list,
                precision: str = "exact") -> dict:
    """The reference's scores of one mask's matches: target index ->
    (gradientAreaGap, highExpressionArea, normalizedScore)."""
    from .reference import shape as ref
    p = run.params
    d = lib["dir"]
    t_idx, pixels = drawn[mask_i]
    names = [lib["targets"][int(t)] for t in t_idx]
    q = ref.query_planes(decode([os.path.join(d, "ems",
                                              lib["masks"][mask_i])])[0],
                         run.device, precision)
    cdm = decode([os.path.join(d, "lms", n) for n in names])
    grad = decode([os.path.join(d, "grad", n) for n in names], gray=True)
    zgap = decode([os.path.join(d, "zgap", n) for n in names])
    gaps, highs = [], []
    for c, g, z in zip(cdm, grad, zgap):
        t = ref.target_planes(c, g, z, p["maskThreshold"], run.device,
                              precision)
        gap, high, _ = ref.shape_score(q, t, p["mirrorMask"])
        gaps.append(gap)
        highs.append(high)
    norm = ref.normalized_scores(pixels, gaps, highs, precision)
    return {int(t): (g, h, n)
            for t, g, h, n in zip(t_idx, gaps, highs, norm)}


def ga_control(run, precision: str) -> dict:
    """The gradient cells' control: a sample of the masks, drawn from the
    seed, scored by the reference at `precision` in the program's place,
    against the exact reference."""
    lib = gen.write_library_child(run.traffic, run.seed,
                                  os.path.join(run.workdir, "lib"))
    drawn = draw_matches(run, len(lib["masks"]), len(lib["targets"]))
    wrong = n = 0
    for i in gen.rng(run.seed, "sample").choice(
            len(lib["masks"]), size=int(run.traffic["sample_masks"]),
            replace=False):
        want = ga_expected(run, lib, int(i), drawn)
        wrong += mismatches(want, ga_expected(run, lib, int(i), drawn,
                                              precision))
        n += len(want)
    run.rec["checked"] = n
    return {"mismatched_matches": (wrong, 0)}
