"""Driver: gradientScores' warm path, mask after mask over cached target
planes.

Entry: `colormipsearch_torch.cmd.gradientscores_cmd.score_mask_partitions`,
as the command's mask loop calls it: the mask's gradient scores cleared,
its query planes on the card (`gradientscores_cmd._build_qplanes`), its
selected matches scored in `targetsPerBatch` batches against the plane
cache, then normalized per mask. Set-up writes the library (child process), ingests it, writes the
CDS matches (drawn from the seed) through the port's store API, reads
each mask's matches back and selects the best lines as the command does,
and scores every mask once (the warm-up), which fills the plane cache
with every target: a window step is one mask, in turn, and decodes
nothing.

Check: a sample of the masks, drawn from the seed: the gradientAreaGap,
highExpressionArea and normalizedScore that their last scoring gave
every match, against the reference's from the PNGs. A match that a
scoring skipped keeps no score and is counted as failed.

Control: the same comparison with the reference at float32, one step
below the configuration's float64, in the program's place.
"""

from __future__ import annotations

import os

from cdsbench import stores
from cdsbench.traffic import generate as gen


def setup(run):
    from colormipsearch_torch.cmd import gradientscores_cmd as gsc
    from colormipsearch_torch.cmd.args import excluded_regions_for
    from colormipsearch_torch.cmd.backends import close_stores, matches_reader
    from colormipsearch_torch.cmd.main import build_parser
    from colormipsearch_torch.dataio import DataSourceParam
    from colormipsearch_torch.device import resolve_devices
    from colormipsearch_torch.mips import MIPsCache
    from colormipsearch_torch.results import (group_matches_by_mask,
                                              select_best_matches)
    p = run.params
    lib, db = stores.build_store(run, run.traffic)
    drawn = stores.draw_matches(run, len(lib["masks"]), len(lib["targets"]))
    mip_ids = stores.write_matches(db, lib, drawn)
    argv = ["gradientScores", "--db", db,
            "--maskThreshold", str(p["maskThreshold"]),
            "--nBestLines", str(p["nBestLines"]),
            "--targetsPerBatch", str(p["targetsPerBatch"]),
            "--device", run.device]
    argv += ["--mirrorMask"] if p["mirrorMask"] else []
    args = build_parser().parse_args(argv)
    reader = matches_reader(db, None)
    masks = []
    for mid in mip_ids:
        selected = select_best_matches(
            reader.read_matches_by_mask(DataSourceParam(mip_ids=[mid])),
            args.nBestLines, args.nBestSamplesPerLine,
            args.nBestMatchesPerSample)
        masks.extend(group_matches_by_mask(selected).values())
    close_stores()
    state = {"lib": lib, "drawn": drawn, "args": args, "masks": masks,
             "cache": MIPsCache(args.cacheSize),
             "planes": gsc.PlaneCache(resolve_devices(run.device)),
             "next": 0, "done": []}
    state["excluded"] = excluded_regions_for(
        args, lib["height"], lib["width"])
    for i in range(len(masks)):
        _score(run, state, i)
    return state


def _score(run, state, i: int) -> int:
    """Score mask i's matches as the command's mask loop does, their
    gradient scores cleared first (as `--cancel-previous-gradient-scores`
    clears them), so that what the check reads is this scoring's."""
    from colormipsearch_torch import results
    from colormipsearch_torch.cmd import gradientscores_cmd as gsc
    from colormipsearch_torch.model import ComputeFileType
    args, planes = state["args"], state["planes"]
    mask_matches = state["masks"][i]
    for m in mask_matches:
        m.reset_gradient_scores()
    img = state["cache"].load_mip(mask_matches[0].mask_image,
                                  ComputeFileType.InputColorDepthImage).image
    qplanes = gsc._build_qplanes(img, state["excluded"], None, args.border,
                                 planes.devices[0])
    scored = gsc.score_mask_partitions(mask_matches, qplanes, state["cache"],
                                       args, state["excluded"], planes)
    results.normalize_match_scores(scored)
    return len(scored)


def step(run, state):
    i = state["next"] % len(state["masks"])
    state["next"] += 1
    n = _score(run, state, i)
    state["done"].append(i)
    rec = run.rec
    rec["matches"] += n
    rec["attempted"] = rec.get("attempted", 0) + len(state["masks"][i])
    rec["failed"] = rec.get("failed", 0) + len(state["masks"][i]) - n


def spans(run):
    from colormipsearch_torch import results
    from colormipsearch_torch.cmd import gradientscores_cmd as gsc
    return [(gsc, "_build_qplanes", "ga.query_planes"),
            (gsc, "_prefetch_planes", "ga.plane_lookup"),
            (gsc, "shape_rows_cached", "ga.score"),
            (gsc, "finish_shape_scores", "ga.finish"),
            (results, "normalize_match_scores", "ga.normalize")]


def _index(state, m) -> int:
    """The library index of a match's target."""
    from colormipsearch_torch.model import ComputeFileType
    name = os.path.basename(m.matched_image.compute_files[
        ComputeFileType.InputColorDepthImage].name)
    return state["target_index"][name]


def _mask_index(state, group) -> int:
    from colormipsearch_torch.model import ComputeFileType
    name = os.path.basename(group[0].mask_image.compute_files[
        ComputeFileType.InputColorDepthImage].name)
    return state["lib"]["masks"].index(name)


def after(run, state):
    """Free the program's state; in a traced run, count G1's and G2's
    bytes over the masks that the window scored."""
    import gc

    import torch
    from cdsbench.reference import shape as ref
    from cdsbench.roofline import work
    state["target_index"] = {n: i for i, n in
                             enumerate(state["lib"]["targets"])}
    del state["planes"], state["cache"]
    gc.collect()
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    if not run.trace:
        return
    lib, d = state["lib"], state["lib"]["dir"]
    h, w, batch = lib["height"], lib["width"], run.params["targetsPerBatch"]
    rows = {}
    for i in sorted(set(state["done"])):
        px = stores.decode([os.path.join(d, "ems", lib["masks"][
            _mask_index(state, state["masks"][i])])])[0]
        rows[i] = work.active_rows(ref.query_planes(px, run.device))
    g1 = 0
    for i in state["done"]:
        n = len(state["masks"][i])
        for off in range(0, n, batch):
            g1 += work.g1_bytes(rows[i], w, min(batch, n - off))
    run.rec["g1_bytes"] = g1
    run.rec["g2_bytes"] = len(state["done"]) * work.g2_query_bytes(h, w)


def check(run, state):
    done = sorted(set(state["done"]))
    k = min(int(run.traffic["sample_masks"]), len(done))
    wrong = 0
    for i in sorted(gen.rng(run.seed, "sample").choice(
            done, size=k, replace=False).tolist()):
        group = state["masks"][i]
        want = stores.ga_expected(run, state["lib"],
                                  _mask_index(state, group), state["drawn"])
        got = {_index(state, m): (m.gradient_area_gap,
                                  m.high_expression_area, m.normalized_score)
               for m in group}
        wrong += stores.mismatches(want, got)
        run.rec["checked"] = run.rec.get("checked", 0) + len(want)
    return {"mismatched_matches": (wrong, 0)}


def control(run, precision: str):
    return stores.ga_control(run, precision)
