"""Driver: the streaming phase of a colorDepthSearch job whose mask block
is prepared: target partitions through the pipelined two-phase sweep,
pass after pass.

Entry: `colormipsearch_torch.parallel.twophase_sweep.TwoPhaseSweep
.sweep_parts`, built as the command builds it: one engine per mask, the
prescreen's query features (on the harness's thread pool), keep
thresholds of pctPositivePixels of each query's size. Set-up makes the
adversarial library in memory, prepares the masks and sweeps every
partition once (the warm-up); a window step is one pass over all
partitions, partition p + 1 launched before p is collected.

Check: pairs drawn from the seed out of the window's last pass (masks,
and targets for each): a pair that the program scored has the
reference's pixels (and, when above 0, its mirrored flag); a pair left
at 0 has a reference score at or under its keep threshold,
pctPositivePixels of the reference's query size (the bound may only drop
pairs that cannot match).

Control: the same comparison with the reference's bfloat16 colour test
in the program's place.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cdsbench.traffic import generate as gen


class _Recorded:
    """The program's screen with its bounds kept (traced runs: the K1
    roofline counts the work of the pairs that the bound lets through)."""

    def __init__(self, screen):
        self.screen = screen
        self.bounds = []
        self.keep = True

    def bounds_from_words(self, u_matrix, t_words):
        b = self.screen.bounds_from_words(u_matrix, t_words)
        if self.keep:
            self.bounds.append(b)
        return b


def setup(run):
    import torch
    from colormipsearch_torch.cds.pixel_active import ActiveTilePixelEngine
    from colormipsearch_torch.cds.prescreen import PairPrescreen
    from colormipsearch_torch.cmd.args import excluded_regions_for
    from colormipsearch_torch.cmd.main import build_parser
    from colormipsearch_torch.device import resolve_devices
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    p, tr = run.params, run.traffic
    masks = gen.mask_frames(tr, run.seed)
    targets = gen.target_frames(tr, run.seed)
    h, w = targets.shape[1:3]
    args = build_parser().parse_args(["colorDepthSearch", "-m", "-", "-i",
                                      "-"])
    excluded = excluded_regions_for(args, h, w)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        engines = list(pool.map(lambda m: ActiveTilePixelEngine(
            m, p["maskThreshold"], p["mirrorMask"], p["dataThreshold"],
            p["pixColorFluctuation"], p["xyShift"], excluded,
            p["predicate"]), masks))
        screen = PairPrescreen(engines[0].zt9, p["xyShift"], h, w)
        u_matrix = np.stack(list(pool.map(
            lambda e: screen.query_features(e.planes.words), engines)))
    thresholds = np.array([max(p["pctPositivePixels"] / 100.0
                               * e.tiles.query_size, 0.5) for e in engines])
    recorded = _Recorded(screen) if run.trace else None
    sweep = TwoPhaseSweep(engines, resolve_devices(run.device),
                          recorded or screen, u_matrix, thresholds)
    n = int(tr["partition"])
    parts = [(i, targets[i:i + n]) for i in range(0, len(targets), n)]
    state = {"sweep": sweep, "parts": parts, "masks": masks,
             "targets": targets, "thresholds": thresholds,
             "recorded": recorded, "survivors": None}
    _pass(run, state, {})
    if run.device.startswith("cuda"):
        torch.cuda.synchronize()
    if recorded:
        recorded.bounds.clear()
    return state


def _pass(run, state, stage):
    state["last"] = {key: (s, m) for key, s, m in
                     state["sweep"].sweep_parts(iter(state["parts"]), stage)}


def step(run, state):
    stage = {}
    _pass(run, state, stage)
    run.add_stage(stage)
    n = len(state["masks"]) * len(state["targets"])
    run.rec["pairs"] += n
    run.rec["attempted"] = run.rec.get("attempted", 0) + n
    run.rec["targets"] = run.rec.get("targets", 0) + len(state["targets"])
    rec = state["recorded"]
    if rec is not None and state["survivors"] is None:
        state["survivors"] = np.concatenate(
            [b > state["thresholds"][:, None] for b in rec.bounds], axis=1)
        rec.keep = False


def spans(run):
    from colormipsearch_torch.cds.multimask import MultiMaskScorer
    from colormipsearch_torch.cds.prescreen import PairPrescreen
    from colormipsearch_torch.parallel import twophase_sweep as tps
    return [(tps.TwoPhaseSweep, "launch", "sweep.launch"),
            (tps.TwoPhaseSweep, "collect", "sweep.collect"),
            (tps, "pad_for_predicate", "sweep.pad"),
            (PairPrescreen, "bounds_from_words", "sweep.bound"),
            (tps, "signal_ranges_from_words", "sweep.live"),
            (tps, "tile_live_from_words", "sweep.live"),
            (MultiMaskScorer, "launch_deferred", "sweep.exact_launch"),
            (tps, "drain_deferred", "sweep.drain")]


def after(run, state):
    """Free the program's state; in a traced run, count K1's and P1's
    work."""
    import gc

    import torch
    from cdsbench.roofline import work
    state["scores"] = np.concatenate(
        [state["last"][k][0] for k, _ in state["parts"]], axis=1)
    state["mirrored"] = np.concatenate(
        [state["last"][k][1] for k, _ in state["parts"]], axis=1)
    del state["sweep"], state["last"]
    gc.collect()
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    if state["survivors"] is not None:
        p = run.params
        fp = work.variant_footprints(state["masks"], p["maskThreshold"],
                                     p["xyShift"], p["mirrorMask"],
                                     run.device)
        per_pass = work.k1_evaluations(fp, state["targets"],
                                       state["survivors"],
                                       p["dataThreshold"])
        del fp
        run.rec["k1_evaluations"] = per_pass * run.rec["steps"]
        h, w = state["targets"].shape[1:3]
        run.rec["p1_bytes"] = work.p1_bytes(run.rec["targets"], h, w)


def _judge(run, masks, targets, program) -> int:
    """Pairs drawn from the seed (masks, and targets for each) whose
    answer from `program(b, ts, query, planes)` -> (scores, mirrored) the
    reference refutes: a scored pair with other pixels or mirrored flag,
    or a pair left at 0 whose reference score passes its keep threshold."""
    import torch
    from cdsbench.reference import pixel as ref
    p, tr = run.params, run.traffic
    n_b, n_t = len(masks), len(targets)
    g = gen.rng(run.seed, "sample")
    by_mask = {int(b): sorted(g.choice(n_t, size=min(
        int(tr["sample_targets"]), n_t), replace=False).tolist())
        for b in g.choice(n_b, size=min(int(tr["sample_masks"]), n_b),
                          replace=False)}
    wrong = 0
    zt9 = round(p["pixColorFluctuation"] * 10_000_000)
    for b, ts in by_mask.items():
        q = ref.PixelQuery(masks[b], p["maskThreshold"], run.device)
        planes = ref.TargetPlanes(torch.from_numpy(
            targets[ts]).to(run.device), p["dataThreshold"])
        s, m = ref.pixel_scores(q, planes, zt9, p["xyShift"],
                                p["mirrorMask"])
        keep = max(p["pctPositivePixels"] / 100.0 * q.size, 0.5)
        got_s, got_m = program(b, ts, q, planes)
        for rs, rm, ps, pm in zip(s.tolist(), m.tolist(), got_s, got_m):
            if int(ps) == 0:
                wrong += rs > keep
            else:
                wrong += int(ps) != rs or bool(pm) != rm
    run.rec["checked"] = sum(len(ts) for ts in by_mask.values())
    return int(wrong)


def check(run, state):
    scores, mirrored = state["scores"], state["mirrored"]
    wrong = _judge(run, state["masks"], state["targets"],
                   lambda b, ts, q, planes: (scores[b, ts], mirrored[b, ts]))
    return {"mismatched_pairs": (wrong, 0)}


def control(run, precision: str):
    from cdsbench.reference import pixel as ref
    p = run.params
    zt9 = round(p["pixColorFluctuation"] * 10_000_000)

    def lower(b, ts, q, planes):
        s, m = ref.pixel_scores(q, planes, zt9, p["xyShift"],
                                p["mirrorMask"], precision)
        return s.tolist(), m.tolist()

    wrong = _judge(run, gen.mask_frames(run.traffic, run.seed),
                   gen.target_frames(run.traffic, run.seed), lower)
    return {"mismatched_pairs": (wrong, 0)}
