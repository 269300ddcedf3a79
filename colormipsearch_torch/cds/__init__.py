"""Color depth search scoring: host tables, torch ops and the CUDA kernel.

Counterpart of `colormipsearch_tpu/cds/` for the colorDepthSearch path.
"""
