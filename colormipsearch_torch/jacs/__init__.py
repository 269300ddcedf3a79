"""JACS data-service client (counterpart of `colormipsearch_tpu/jacs/`)."""

from .client import (CachedDataHelper, CDMIPBody, CDMIPSample, ColorDepthMIP,
                     JacsClient, em_neuron_from_mip, lm_neuron_from_mip,
                     retrieve_library_name_mapping)

__all__ = ["JacsClient", "ColorDepthMIP", "CDMIPSample", "CDMIPBody",
           "CachedDataHelper", "em_neuron_from_mip", "lm_neuron_from_mip",
           "retrieve_library_name_mapping"]
