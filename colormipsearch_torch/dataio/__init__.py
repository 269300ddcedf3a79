"""JSON data I/O of the colorDepthSearch command (counterpart of
`colormipsearch_tpu/dataio/`; the database stores are not ported yet)."""

from .base import DataSourceParam
from .fs import (JSONCDMIPsReader, JSONCDSSessionWriter,
                 JSONNeuronMatchesWriter)
