"""JSON data I/O of the colorDepthSearch and gradientScores commands
(counterpart of `colormipsearch_tpu/dataio/`; the database stores are not
ported yet)."""

from .base import DataSourceParam, ScoresFilter, SortCriteria
from .fs import (JSONCDMIPsReader, JSONCDSSessionWriter,
                 JSONNeuronMatchesReader, JSONNeuronMatchesWriter)
