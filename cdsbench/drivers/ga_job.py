"""Driver: gradientScores jobs, one after another, in-process.

Entry: `colormipsearch_torch.cmd.gradientscores_cmd.run`, through the
port's own parser, as `python -m colormipsearch_torch gradientScores`
runs it over the run's SQLite store: the best `nBestLines` lines of each
of the job's masks (`--masks-mip-ids`) scored against the targets'
precomputed gradient and z-gap files, `targetsPerBatch` targets per
device batch, the scores normalized per mask and written back. Every job
is a fresh `run`, so its plane cache starts empty and each target it
reads is cold, as in each production process. Set-up writes the library
(child process), ingests it, writes each mask's CDS matches (drawn from
the seed) through the port's store API and runs the first job once.

Check: a sample of the window's masks, drawn from the seed: every one of
their matches' stored gradientAreaGap, highExpressionArea and
normalizedScore against the reference's, computed from the PNGs.

Control: the same comparison with the reference at float32, one step
below the configuration's float64, in the program's place.
"""

from __future__ import annotations

from cdsbench import stores
from cdsbench.traffic import generate as gen


def _argv(run, db: str, mip_ids, tag: str) -> list:
    p = run.params
    argv = ["gradientScores", "--db", db,
            "--maskThreshold", str(p["maskThreshold"]),
            "--nBestLines", str(p["nBestLines"]),
            "--targetsPerBatch", str(p["targetsPerBatch"]),
            "--processing-tag", tag, "--device", run.device,
            "--masks-mip-ids", *mip_ids]
    if p["computeZGapOnTheFly"]:
        argv.append("--computeZGapOnTheFly")
    return argv + (["--mirrorMask"] if p["mirrorMask"] else [])


def _job(run, state, job: int, tag: str) -> list:
    """Run the job-th block of masks; its mask indices."""
    n = int(run.traffic["job_masks"])
    first = (job * n) % len(state["mip_ids"])
    idx = list(range(first, first + n))
    stores.cli(_argv(run, state["db"], [state["mip_ids"][i] for i in idx],
                     tag))
    return idx


def setup(run):
    lib, db = stores.build_store(run, run.traffic)
    drawn = stores.draw_matches(run, len(lib["masks"]), len(lib["targets"]))
    state = {"lib": lib, "db": db, "drawn": drawn, "next": 1,
             "done": []}
    state["mip_ids"] = stores.write_matches(db, lib, drawn)
    _job(run, state, 0, "warmup")
    return state


def step(run, state):
    mark = len(run.logs.records)
    idx = _job(run, state, state["next"], f"window{state['next']}")
    state["next"] += 1
    state["done"].extend(idx)
    rec = run.rec
    for args in run.logs.since(mark, "updated %d matches"):
        # (matches, s, cached, host builds, decode s, plane-build s)
        rec["matches"] += args[0]
        rec["attempted"] = rec.get("attempted", 0) + args[0]
        rec["decode_s"] = rec.get("decode_s", 0.0) + args[4]
        rec["planes_s"] = rec.get("planes_s", 0.0) + args[5]
    # every job's plane cache starts empty: its distinct targets are cold
    rec["cold_targets"] = rec.get("cold_targets", 0) + len(
        {int(t) for i in idx for t in state["drawn"][i][0]})


def spans(run):
    from colormipsearch_torch.cmd import gradientscores_cmd as cmd
    from colormipsearch_torch.dataio.db import (DBNeuronMatchesReader,
                                                DBNeuronMatchesWriter)
    return [(DBNeuronMatchesReader, "read_matches_by_mask", "ga.read"),
            (cmd, "_build_qplanes", "ga.query_planes"),
            (cmd, "_decode_raw", "ga.decode"),
            (cmd, "_build_planes_device", "ga.plane_build"),
            (cmd, "shape_rows_cached", "ga.score"),
            (cmd, "finish_shape_scores", "ga.finish"),
            (cmd, "normalize_match_scores", "ga.normalize"),
            (DBNeuronMatchesWriter, "write_updates", "ga.write")]


def after(run, state):
    import gc
    gc.collect()


def check(run, state):
    mips = stores.neurons(state["db"])
    files = {e: n["file"] for e, n in mips.items()}
    index = {f: i for i, f in enumerate(state["lib"]["targets"])}
    mask_ref = {n["file"]: e for e, n in mips.items()
                if n["library"] == stores.EM_LIB}
    done = sorted(set(state["done"]))
    k = min(int(run.traffic["sample_masks"]), len(done))
    wrong = 0
    for i in sorted(gen.rng(run.seed, "sample").choice(
            done, size=k, replace=False).tolist()):
        want = stores.ga_expected(run, state["lib"], i, state["drawn"])
        got = {index[files[r[1]]]: (r[5], r[6], r[7])
               for r in stores.match_rows(
                   state["db"], [mask_ref[state["lib"]["masks"][i]]])}
        wrong += stores.mismatches(want, got)
        run.rec["checked"] = run.rec.get("checked", 0) + len(want)
    run.rec["failed"] = stores.error_rows(state["db"])
    return {"mismatched_matches": (wrong, 0)}


def control(run, precision: str):
    return stores.ga_control(run, precision)
