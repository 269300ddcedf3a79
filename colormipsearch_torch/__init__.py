"""colormipsearch_torch — the colormipsearch pipeline on PyTorch/CUDA.

A port of `colormipsearch_tpu/` (JAX, Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). The JAX package is
the reference: every module here names its counterpart and is held to
exact equality with it by the `tests/test_torch_*.py` suite.

What is here:
- `cds/`: host query tables, target pack and pad, the prescreen bound,
  live-tile bitmaps and the exact multi-mask scorer with its CUDA kernels
  (`csrc/multimask_ratio.cu`, `csrc/multimask_words.cu`, built at first
  use by `cds/kernels.py`);
- `cds/shape_device.py`, `cds/shape_kernel.py`: the gradientScores
  shape planes and scorer as torch ops on the card;
- `parallel/twophase_sweep.py`: the two-phase sweep over CUDA devices;
- `cmd/`: the CLI. The production pipeline runs here (colorDepthSearch,
  gradientScores, normalizeGradientScores and exportData, over JSON
  files or a SQLite/Mongo store; `scripts/run_full_precompute.sh`); the
  reference's six other commands refuse with a pointer to the JAX
  package;
- `model/`, `dataio/`, `jacs/`, `mips/`, `imageproc/`, `persist/`,
  `results/`, `native/`, `utils/`: the port's own copies of the host
  modules the commands need, each pinned to its reference by
  `tests/test_torch_host_copies.py`.

The package imports `torch` and never `jax`, nor any module of the JAX
package. Devices are explicit: a `--device` argument or a `device=`
parameter, never guessed.
"""

__version__ = "0.1.0"
