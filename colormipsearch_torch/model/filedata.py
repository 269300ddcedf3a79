"""FileData: a file or zip-entry reference (model/FileData.java).

JSON form matches the reference's FileDataSerializer/Deserializer
(model/json/FileDataSerializer.java): plain files serialize as a bare
string; zip entries as {"dataType": "zipEntry", "fileName": ..,
"entryName": ..}.

Copy of `colormipsearch_tpu/model/filedata.py`.
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Optional, Union


class FileDataType(enum.Enum):
    file = "file"
    zipEntry = "zipEntry"


@dataclass(frozen=True)
class FileData:
    file_name: str
    data_type: FileDataType = FileDataType.file
    entry_name: Optional[str] = None

    @staticmethod
    def from_string(fn: Optional[str]) -> Optional["FileData"]:
        if not fn:
            return None
        return FileData(file_name=fn)

    @staticmethod
    def from_components(data_type: FileDataType, parent: str, name: str) -> "FileData":
        if data_type == FileDataType.zipEntry:
            return FileData(file_name=parent, data_type=data_type, entry_name=name)
        return FileData(file_name=os.path.join(parent, name))

    @property
    def name(self) -> str:
        return self.entry_name if self.entry_name else self.file_name

    @property
    def name_component(self) -> str:
        return os.path.basename(self.name)

    @property
    def name_without_ext(self) -> str:
        base = self.name_component
        stem, ext = os.path.splitext(base)
        return stem if stem else base

    def to_json(self) -> Union[str, dict]:
        if self.data_type == FileDataType.file:
            return self.file_name
        return {"dataType": self.data_type.value,
                "fileName": self.file_name,
                "entryName": self.entry_name}

    @staticmethod
    def from_json(value) -> Optional["FileData"]:
        if value is None:
            return None
        if isinstance(value, str):
            return FileData.from_string(value)
        return FileData(file_name=value.get("fileName"),
                        data_type=FileDataType(value.get("dataType", "file")),
                        entry_name=value.get("entryName"))
