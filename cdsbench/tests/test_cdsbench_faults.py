"""A run on the CPU, past the harness's look for a card, with the timed
path broken underneath: `correct` comes out false for each fault that a
cell can have (an answer altered where it is produced; half of a batch
left out), and true on the unbroken path. Each fault is planted once
before set-up and once after it, in the window alone, where the answers
that the warm-up left behind must not stand in for the window's (the
block cell's window searches the warm-up's block again; the warm cell's
window rescores masks that the warm-up scored). The cells have one card
and no state that a step carries, so no exchange or unchanged step is
planted."""

import numpy as np
import pytest

from cdsbench import harness as H
from cdsbench import run as R

TINY = {
    "cds.block_regional": {"masks": 3, "targets": 12, "block_masks": 3,
                           "sample_masks": 3, "mask_band": 0,
                           "target_band": 400},
    "cds.stream_adversarial": {"masks": 6, "targets": 16, "partition": 8,
                               "sample_masks": 6, "sample_targets": 16,
                               "target_band": 400},
    "ga.job_cold": {"masks": 4, "targets": 24, "matches_per_mask": 10,
                    "job_masks": 2, "sample_masks": 2},
    "ga.score_warm": {"masks": 3, "targets": 20, "matches_per_mask": 8,
                      "sample_masks": 2},
}
BENCH = {"end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}


def _run(cell, monkeypatch=None, plant=None):
    """One tiny run; `plant` breaks the path once set-up has returned."""
    wl = H.load_json("workloads", cell)
    wl["traffic"].update(TINY[cell])
    if plant is not None:
        load = H.load_plugin

        def loading(kind, name):
            mod = load(kind, name)
            if kind == "drivers":
                setup = mod.setup

                def set_up_then_break(run):
                    state = setup(run)
                    plant(monkeypatch)
                    return state

                mod.setup = set_up_then_break
            return mod

        monkeypatch.setattr(H, "load_plugin", loading)
    run = R.Run(cell, 2 ** 32 + 17, 0.1, False, device="cpu", workload=wl)
    try:
        return R.run_cell(run, BENCH)
    finally:
        run.close()


def _sweep_fault(monkeypatch, kind):
    from colormipsearch_torch.parallel.twophase_sweep import TwoPhaseSweep
    collect = TwoPhaseSweep.collect

    def broken(self, handle):
        scores, mirrored = collect(self, handle)
        if kind == "altered":
            scores = np.where(scores > 0, scores + 1, scores)
        else:   # the second half of the partition's targets left out
            scores = scores.copy()
            scores[:, scores.shape[1] // 2:] = 0
        return scores, mirrored

    monkeypatch.setattr(TwoPhaseSweep, "collect", broken)


def _shape_fault(monkeypatch, kind):
    from colormipsearch_torch.cmd import gradientscores_cmd as gsc
    if kind == "altered":
        finish = gsc.finish_shape_scores

        def broken(*a, **k):
            gaps, high, score, mirrored = finish(*a, **k)
            return gaps + 1, high, score, mirrored

        monkeypatch.setattr(gsc, "finish_shape_scores", broken)
    else:   # half of each mask's matches left unscored
        score = gsc.score_mask_partitions

        def broken(mask_matches, *a, **k):
            return score(mask_matches[:len(mask_matches) // 2], *a, **k)

        monkeypatch.setattr(gsc, "score_mask_partitions", broken)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_unbroken_path_is_correct(cell):
    got = _run(cell)
    assert got["correct"], got["compared"]


@pytest.mark.parametrize("when", ["from_set_up", "window_only"])
@pytest.mark.parametrize("kind", ["altered", "half_left_out"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_caught(cell, kind, when, monkeypatch):
    fault = _sweep_fault if cell.startswith("cds") else _shape_fault

    def plant(mp):
        fault(mp, kind)

    if when == "from_set_up":
        plant(monkeypatch)
        got = _run(cell)
    else:
        got = _run(cell, monkeypatch, plant)
    assert not got["correct"], got["compared"]
    assert list(got)[-1] == "compared"
