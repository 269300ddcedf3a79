"""The benchmark of colormipsearch_torch, the PyTorch and CUDA port, on
one NVIDIA H100: `python -m cdsbench --workload CELL --seed N --seconds S
--trace 0|1` (see `cdsbench/run.py`)."""
