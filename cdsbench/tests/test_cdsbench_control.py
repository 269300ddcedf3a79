"""The controls: the plain reference in the program's place, one
precision below the configuration's (gradientScores: float32) or with its
exact colour test broken (colorDepthSearch: bfloat16), comes out not
correct by the cell's own comparison, which each driver's `control` runs.
Small here; at the cells' own sizes on the card (`cuda`), where `python
-m cdsbench.control` reads the upper readings that PERF.md gives."""

import pytest
import torch

from cdsbench import control as C

SMALL = {
    "cds.block_regional": ({"masks": 3, "targets": 40, "sample_masks": 3,
                            "mask_band": 0, "target_band": 400},
                           "bfloat16"),
    "cds.stream_adversarial": ({"masks": 6, "targets": 40,
                                "sample_masks": 3, "sample_targets": 40},
                               "bfloat16"),
    "ga.job_cold": ({"masks": 2, "targets": 30, "matches_per_mask": 30,
                     "sample_masks": 1}, "float32"),
    "ga.score_warm": ({"masks": 2, "targets": 30, "matches_per_mask": 30,
                       "sample_masks": 1}, "float32"),
}
CELL = {"cds.block_regional": "bfloat16",
        "cds.stream_adversarial": "bfloat16",
        "ga.job_cold": "float32", "ga.score_warm": "float32"}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_small(cell):
    traffic, precision = SMALL[cell]
    got = C.control(cell, 2 ** 32 + 3, precision, "cpu", traffic)
    assert got["of"] > 0 and not got["correct"], got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL))
def test_control_fails_at_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (101, 102, 103):
        got = C.control(cell, seed, CELL[cell], "cuda")
        assert not got["correct"], got
