"""Command-line entry points (counterpart of `colormipsearch_tpu/cmd/`)."""
