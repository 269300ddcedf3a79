"""PatchPerPix import (counterpart of `colormipsearch_tpu/ppp/`)."""

from .raw_reader import read_raw_ppp_matches
