"""Host utilities (counterpart of `colormipsearch_tpu/utils/`)."""
