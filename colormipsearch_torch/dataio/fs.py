"""Filesystem (JSON) persistence backends.

Counterparts of colormipsearch-persist dataio/fs/*.java. File formats are
wire-compatible with the reference:

- MIP lists: a flat JSON array of class-discriminated neuron entities
  (JSONCDMIPsReader/Writer.java).
- Matches: one file per group keyed by mip ID, shaped
  {"inputImage": <mask entity sans mask-side compute files>,
   "results": [<match sans maskImage, with matchComputeFiles
                Mask{ColorDepth,Gradient,ZGap}Image copied from the
                mask>]}
  written under a per-masks dir and optionally a per-targets dir with
  mask/target roles swapped (JSONNeuronMatchesWriter.java:43-90,
  MatchEntitiesGrouping.groupByMaskFields/expandResultsByMask).

Copy of `colormipsearch_tpu/dataio/fs.py`.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, Dict, List, Optional, Set

from ..model.entities import (CDMatchEntity, CDSSessionEntity, NeuronEntity,
                              entity_from_dict)
from ..model.enums import ComputeFileType, ProcessingType
from .base import (CDMIPsReader, CDMIPsWriter, DataSourceParam,
                   NeuronMatchesReader, NeuronMatchesWriter, ScoresFilter,
                   SortCriteria)

_MASK_SIDE_COMPUTE_FILES = (ComputeFileType.InputColorDepthImage,
                            ComputeFileType.GradientImage,
                            ComputeFileType.ZGapImage)
_MATCH_COMPUTE_KEYS = {
    ComputeFileType.InputColorDepthImage: "MaskColorDepthImage",
    ComputeFileType.GradientImage: "MaskGradientImage",
    ComputeFileType.ZGapImage: "MaskZGapImage",
}


class JSONCDMIPsReader(CDMIPsReader):
    """Read MIP entity lists from JSON files (JSONCDMIPsReader.java)."""

    def __init__(self, path: str):
        self.path = path

    def read_mips(self, param: DataSourceParam) -> List[NeuronEntity]:
        with open(self.path) as f:
            raw = json.load(f)
        entities = [entity_from_dict(d) for d in raw]
        selected = [e for e in entities if param.matches_entity(e)]
        return param.apply_slice(selected)


class JSONCDMIPsWriter(CDMIPsWriter):
    """Write MIP entity lists to a JSON file (JSONCDMIPsWriter.java)."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self.append = append
        self._items: List[NeuronEntity] = []

    def open(self) -> None:
        self._items = []
        if self.append and os.path.exists(self.path):
            with open(self.path) as f:
                self._items = [entity_from_dict(d) for d in json.load(f)]

    def write(self, entities: List[NeuronEntity]) -> None:
        self._items.extend(entities)

    def add_processing_tags(self, entities: List[NeuronEntity],
                            processing_type: ProcessingType,
                            tags: Set[str]) -> None:
        for e in entities:
            for t in tags:
                e.add_processed_tag(processing_type, t)

    def close(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump([e.to_dict() for e in self._items], f, indent=2)


def _group_matches(matches: List[CDMatchEntity], by_target: bool):
    """Group and strip as groupByMaskFields/groupByTargetFields do."""
    groups: Dict[str, dict] = {}
    for m in matches:
        mask = m.matched_image if by_target else m.mask_image
        target = m.mask_image if by_target else m.matched_image
        if mask is None or target is None:
            continue
        key = mask.mip_id or (str(mask.entity_id) if mask.entity_id else "unknown")
        if key not in groups:
            input_image = copy.deepcopy(mask)
            for cft in _MASK_SIDE_COMPUTE_FILES:
                input_image.compute_files.pop(cft, None)
            groups[key] = {"inputImage": input_image, "results": []}
        md = m.to_dict(include_images=False)
        md.pop("maskImage", None)
        md["image"] = target.to_dict()
        match_compute = {}
        for cft, mk in _MATCH_COMPUTE_KEYS.items():
            fd = mask.compute_files.get(cft)
            if fd is not None:
                match_compute[mk] = fd.to_json()
        if match_compute:
            md["matchComputeFiles"] = match_compute
        groups[key]["results"].append((m, md))
    return groups


class JSONNeuronMatchesWriter(NeuronMatchesWriter):
    """Grouped per-mask (and optionally per-target) JSON match files
    (JSONNeuronMatchesWriter.java), sorted desc by matching pixels."""

    def __init__(self, per_masks_dir: Optional[str],
                 per_targets_dir: Optional[str] = None,
                 score_key: Callable[[CDMatchEntity], float] = None):
        self.per_masks_dir = per_masks_dir
        self.per_targets_dir = per_targets_dir
        self.score_key = score_key or (lambda m: m.matching_pixels or 0)

    def _write_groups(self, matches: List[CDMatchEntity], out_dir: str,
                      by_target: bool) -> int:
        os.makedirs(out_dir, exist_ok=True)
        groups = _group_matches(matches, by_target)
        for key, group in groups.items():
            results = sorted(group["results"], key=lambda t: -self.score_key(t[0]))
            doc = {"inputImage": group["inputImage"].to_dict(),
                   "results": [md for _, md in results]}
            with open(os.path.join(out_dir, f"{key}.json"), "w") as f:
                json.dump(doc, f, indent=2)
        return len(groups)

    def write(self, matches: List[CDMatchEntity]) -> int:
        n = 0
        if self.per_masks_dir:
            n += self._write_groups(matches, self.per_masks_dir, by_target=False)
        if self.per_targets_dir:
            n += self._write_groups(matches, self.per_targets_dir, by_target=True)
        return n

    def write_updates(self, matches: List[CDMatchEntity],
                      fields: List[str]) -> int:
        """FS backend rewrites whole per-mask files
        (JSONNeuronMatchesWriter.writeUpdates, :57-59)."""
        if self.per_masks_dir:
            return self._write_groups(matches, self.per_masks_dir, by_target=False)
        return 0


class JSONNeuronMatchesReader(NeuronMatchesReader):
    """Read grouped match files (JSONNeuronMatchesReader.java), expanding
    each result back into a full match (expandResultsByMask)."""

    def __init__(self, per_masks_dir: str):
        self.per_masks_dir = per_masks_dir

    def list_match_locations(self, params: List[DataSourceParam]) -> List[str]:
        if not os.path.isdir(self.per_masks_dir):
            return []
        names = sorted(os.path.splitext(f)[0]
                       for f in os.listdir(self.per_masks_dir)
                       if f.endswith(".json"))
        out = []
        for p in params:
            if p.mip_ids:
                out.extend(n for n in names if n in set(p.mip_ids))
            else:
                out.extend(names)
        return sorted(set(out)) if params else names

    def _read_group_file(self, path: str) -> List[CDMatchEntity]:
        with open(path) as f:
            doc = json.load(f)
        mask_dict = doc.get("inputImage") or {}
        matches = []
        for md in doc.get("results", []):
            m = CDMatchEntity.from_dict(md)
            mask = entity_from_dict(mask_dict)
            # restore mask-side compute files from matchComputeFiles
            for cft, mk in _MATCH_COMPUTE_KEYS.items():
                fd = m.match_compute_files.get(mk)
                if fd is not None:
                    mask.compute_files[cft] = fd
            m.mask_image = mask
            m.match_compute_files = {}
            matches.append(m)
        return matches

    def read_matches_by_mask(self, mask_selector: DataSourceParam,
                             target_selector: Optional[DataSourceParam] = None,
                             scores_filter: Optional[ScoresFilter] = None,
                             sort: Optional[SortCriteria] = None
                             ) -> List[CDMatchEntity]:
        matches: List[CDMatchEntity] = []
        for mip_id in self.list_match_locations([mask_selector]):
            path = os.path.join(self.per_masks_dir, f"{mip_id}.json")
            if os.path.exists(path):
                matches.extend(self._read_group_file(path))
        if mask_selector is not None:
            matches = [m for m in matches
                       if m.mask_image is None
                       or mask_selector.matches_entity(m.mask_image)]
        if target_selector is not None:
            matches = [m for m in matches
                       if m.matched_image is None
                       or target_selector.matches_entity(m.matched_image)]
        if scores_filter is not None and not scores_filter.empty:
            matches = [m for m in matches if scores_filter.matches(m)]
        if sort is not None:
            getter = ScoresFilter._FIELD_GETTERS.get(sort.field_name)
            if getter:
                matches.sort(key=lambda m: (getter(m) is None,
                                            getter(m) or 0),
                             reverse=not sort.ascending)
        return matches


class JSONCDSSessionWriter:
    """Persist CDS run parameters for provenance (JSONCDSSessionWriter.java;
    ColorDepthSearchCmd.java:255-278)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir

    def create_session(self, session: CDSSessionEntity) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        sid = str(session.entity_id or "session")
        path = os.path.join(self.out_dir, f"cdsSession-{sid}.json")
        with open(path, "w") as f:
            json.dump(session.to_dict(), f, indent=2)
        return sid
