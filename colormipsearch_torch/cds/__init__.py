"""Color depth search scoring: host tables, torch ops and the CUDA kernels.

Counterpart of `colormipsearch_tpu/cds/` for the colorDepthSearch path
and the gradientScores shape planes and scorer.
"""
