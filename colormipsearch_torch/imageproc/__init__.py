"""Image decoding, label regions and the packed array cache (counterpart
of `colormipsearch_tpu/imageproc/`)."""
