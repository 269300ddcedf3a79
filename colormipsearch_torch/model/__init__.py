"""Domain model: entities, enums and file references (counterpart of
`colormipsearch_tpu/model/`)."""

from .entities import (CDMatchEntity, CDSSessionEntity, EMNeuronEntity,
                       LMNeuronEntity, NeuronEntity, PPPMatchEntity,
                       entity_from_dict)
from .enums import (ComputeFileType, FileType, Gender, PPPScreenshotType,
                    ProcessingType)
from .filedata import FileData, FileDataType
