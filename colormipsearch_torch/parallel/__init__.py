"""Device-parallel sweeps (counterpart of `colormipsearch_tpu/parallel/`)."""
