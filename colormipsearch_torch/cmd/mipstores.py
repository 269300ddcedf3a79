"""MIP store indexing and variant lookup.

Counterpart of cmd/MIPsHandlingUtils.java:31-349: index image stores
(directories or zip archives) by neuron id extracted with the EM-skeleton
or LM-slide-code naming conventions, then look up searchable/variant
images per neuron with channel/objective matching.

Copy of `colormipsearch_tpu/cmd/mipstores.py`.
"""

from __future__ import annotations

import os
import re
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..imageproc.io import is_image_file
from ..model.filedata import FileData, FileDataType

# naming-convention patterns (MIPsHandlingUtils.java:102,198,278-284)
EM_SKELETON_RE = re.compile(r"([0-9]{5,})([_-]|\D).*")
LM_SLIDECODE_RE = re.compile(
    r"[-_](\d{8}_[a-zA-Z0-9]+_[a-zA-Z0-9]+)([-_][mf])?[-_](.+[_-])ch?(\d+)([_-]|(\.))",
    re.IGNORECASE)
CHANNEL_RE = re.compile(r"[_-]ch?(\d+)([_-]|(\.))", re.IGNORECASE)
OBJECTIVE_RE = re.compile(r"[_-]([0-9]+x)[_-]", re.IGNORECASE)


def is_em_library(library_name: Optional[str]) -> bool:
    """MIPsHandlingUtils.isEmLibrary (:121-125)."""
    return bool(library_name) and library_name.lower().startswith(("flyem", "flywire"))


def extract_em_body_id(name: str) -> Optional[str]:
    m = EM_SKELETON_RE.match(name)
    return m.group(1) if m else None


def extract_lm_slide_code(name: str) -> Optional[str]:
    m = LM_SLIDECODE_RE.search(name)
    return m.group(1) if m else None


def extract_channel(name: str, channel_base: int = 1) -> int:
    m = CHANNEL_RE.search(name)
    return int(m.group(1)) - channel_base if m else -1


def extract_objective(name: str, alignment_space: str = "") -> Optional[str]:
    m = OBJECTIVE_RE.search(name.replace(alignment_space or "", ""))
    return m.group(1) if m else None


@dataclass
class MIPStoreEntry:
    store_base_path: str
    store_entry_type: FileDataType
    image_path: str

    @property
    def entry_name(self) -> str:
        return os.path.basename(self.image_path)

    def file_data(self) -> FileData:
        return FileData.from_components(self.store_entry_type,
                                        self.store_base_path, self.image_path)


def list_store_images(location: str) -> List[MIPStoreEntry]:
    """List image entries of a directory or zip store
    (MIPsHandlingUtils.listLibraryImageFiles)."""
    entries: List[MIPStoreEntry] = []
    if os.path.isdir(location):
        for root, _, files in os.walk(location):
            for f in files:
                if is_image_file(f):
                    rel = os.path.relpath(os.path.join(root, f), location)
                    entries.append(MIPStoreEntry(location, FileDataType.file, rel))
    elif zipfile.is_zipfile(location):
        with zipfile.ZipFile(location) as zf:
            for name in zf.namelist():
                if is_image_file(name):
                    entries.append(MIPStoreEntry(location, FileDataType.zipEntry, name))
    return entries


def index_mip_stores(locations: List[str],
                     em_library: bool) -> Dict[str, List[MIPStoreEntry]]:
    """Index store entries by extracted neuron id
    (MIPsHandlingUtils.indexMIPStores, :78-100)."""
    index: Dict[str, List[MIPStoreEntry]] = {}
    for loc in locations:
        for e in list_store_images(loc):
            stem = re.sub(r"\..*$", "", e.entry_name)
            if em_library:
                key = extract_em_body_id(stem) or stem
            else:
                key = extract_lm_slide_code(stem) or stem
            index.setdefault(key, []).append(e)
    return index


# EM neuron-state component: "<bodyId>[_-]<STATE>_..." (the state may
# carry a suffix, e.g. LV vs L — startswith matches them,
# MIPsHandlingUtils.java:138-148)
EM_STATE_RE = re.compile(r"[0-9]+[_-]([0-9A-Z]*)_.*", re.IGNORECASE)


def extract_em_neuron_state(name: str) -> str:
    m = EM_STATE_RE.match(name)
    return m.group(1) if m else ""


def match_objectives(source_objective: Optional[str],
                     variant_objective: Optional[str]) -> bool:
    """matchMIPObjectiveWithSegmentedImageObjective
    (MIPsHandlingUtils.java:213-226): a variant WITH an objective never
    matches a source without one; a variant without one matches any."""
    if not source_objective and not variant_objective:
        return True
    if not source_objective:
        return False
    if not variant_objective:
        return True
    return source_objective.lower() == variant_objective.lower()


def lookup_variant_images(neuron_id: str, index: Dict[str, List[MIPStoreEntry]],
                          em_library: bool,
                          source_channel: int = -1,
                          source_objective: Optional[str] = None,
                          alignment_space: str = "",
                          match_neuron_state: bool = False,
                          source_cdm_name: str = "") -> List[MIPStoreEntry]:
    """Find variant images for a neuron with channel/objective matching
    (MIPsHandlingUtils.lookupSearchableNeuronImages, :128-187). EM
    libraries optionally match the neuron-STATE filename component
    against the source CDM's (--match-neuron-state); LM libraries match
    channel and objective."""
    candidates = index.get(neuron_id, [])
    if em_library:
        if not match_neuron_state:
            return list(candidates)
        src_state = extract_em_neuron_state(
            re.sub(r"\.\D*$", "", os.path.basename(source_cdm_name)))
        out = []
        for e in candidates:
            st = extract_em_neuron_state(e.entry_name)
            if (not st and not src_state) or \
                    (src_state and st.startswith(src_state)):
                out.append(e)
        return out
    out = []
    for e in candidates:
        name = e.entry_name.replace(neuron_id, "")
        ch = extract_channel(name)
        obj = extract_objective(name, alignment_space)
        ch_ok = source_channel == -1 or ch == -1 or source_channel == ch
        if ch_ok and match_objectives(source_objective, obj):
            out.append(e)
    return out
