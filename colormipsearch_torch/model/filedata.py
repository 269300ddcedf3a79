"""FileData: a file or zip-entry reference (model/FileData.java).

Copy of `colormipsearch_tpu/model/filedata.py`.

JSON form matches the reference's FileDataSerializer/Deserializer
(model/json/FileDataSerializer.java): plain files serialize as a bare
string; zip entries as {"dataType": "zipEntry", "fileName": ..,
"entryName": ..}.
"""

from __future__ import annotations

import enum
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

    @property
    def name(self) -> str:
        return self.entry_name if self.entry_name else self.file_name

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
