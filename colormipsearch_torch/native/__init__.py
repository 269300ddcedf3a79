"""Native host helpers (counterpart of `colormipsearch_tpu/native/`)."""

from .mipops import available, pack_planes_native
