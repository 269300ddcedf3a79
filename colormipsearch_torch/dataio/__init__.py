"""Data I/O: the JSON files and the SQLite/Mongo stores (counterpart of
`colormipsearch_tpu/dataio/`)."""

from .base import (AppendField, CDMIPsReader, CDMIPsWriter, DataSourceParam,
                   FieldUpdate, IncField, NeuronMatchesReader,
                   NeuronMatchesWriter, RemoveField, ScoresFilter,
                   SetField, SetOnCreateField, SortCriteria, UnsetField,
                   apply_field_updates)
from .db import (DBCDMIPsReader, DBCDMIPsWriter, DBNeuronMatchesReader,
                 DBNeuronMatchesWriter, SqliteStore)
from .db_mongo import MongoStore, open_store
from .fs import (JSONCDMIPsReader, JSONCDMIPsWriter, JSONCDSSessionWriter,
                 JSONNeuronMatchesReader, JSONNeuronMatchesWriter)
