"""colormipsearch_torch — the colorDepthSearch path in PyTorch and CUDA.

A port of `colormipsearch_tpu/` (JAX, Pallas on a TPU) to PyTorch with a
hand-written CUDA kernel for NVIDIA Hopper (sm_90a). The JAX package is
the reference: every module here names its counterpart and is held to
exact equality with it by the `tests/test_torch_*.py` suite.

What is here:
- `cds/`: host query tables, target pack and pad, the prescreen bound,
  live-tile bitmaps and the exact multi-mask scorer with its CUDA kernel
  (`csrc/multimask_ratio.cu`, built at first use by `cds/kernels.py`);
- `parallel/twophase_sweep.py`: the two-phase sweep over CUDA devices;
- `cmd/`: the CLI. colorDepthSearch runs here; the JAX-free commands of
  the reference (normalize, exportData, ...) are dispatched to it.

The package imports `torch` and never `jax`. Devices are explicit: a
`--device` argument or a `device=` parameter, never guessed.
"""

__version__ = "0.1.0"
