"""JACS data-service client of the export (counterpart of
`colormipsearch_tpu/jacs/`)."""

from .client import (CachedDataHelper, CDMIPBody, CDMIPSample, ColorDepthMIP,
                     JacsClient, retrieve_library_name_mapping)

__all__ = ["JacsClient", "ColorDepthMIP", "CDMIPSample", "CDMIPBody",
           "CachedDataHelper", "retrieve_library_name_mapping"]
