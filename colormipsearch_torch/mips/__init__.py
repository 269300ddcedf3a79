"""MIP loading and caching (counterpart of `colormipsearch_tpu/mips/`)."""

from .loader import MIPsCache, NeuronMIP, load_compute_file
