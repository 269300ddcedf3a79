"""Domain entities: neurons, matches, sessions.

Copy of `colormipsearch_tpu/model/entities.py` without
`NeuronEntity.has_compute_file`, which no ported command calls.

Counterparts of the reference model layer (model/AbstractNeuronEntity
.java:25-50, EMNeuronEntity.java, LMNeuronEntity.java:17-28,
AbstractMatchEntity.java:22-30, CDMatchEntity.java:12-170,
PPPMatchEntity.java:15-35, CDSSessionEntity.java). JSON round-trips use
the reference's fs-store field names (class-discriminated entities) so
the two toolsets can read each other's JSON results.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from .enums import ComputeFileType, FileType, Gender, ProcessingType
from .filedata import FileData

_EM_CLASS = "org.janelia.colormipsearch.model.EMNeuronEntity"
_LM_CLASS = "org.janelia.colormipsearch.model.LMNeuronEntity"
_CDMATCH_CLASS = "org.janelia.colormipsearch.model.CDMatchEntity"
_PPPMATCH_CLASS = "org.janelia.colormipsearch.model.PPPMatchEntity"


@dataclass
class NeuronEntity:
    """Base neuron MIP entity (AbstractNeuronEntity.java:25-50)."""
    entity_id: Optional[int] = None
    mip_id: Optional[str] = None
    alignment_space: Optional[str] = None
    library_name: Optional[str] = None
    published_name: Optional[str] = None
    source_ref_id: Optional[str] = None
    neuron_terms: Optional[List[str]] = None
    compute_files: Dict[ComputeFileType, FileData] = field(default_factory=dict)
    processed_tags: Dict[ProcessingType, Set[str]] = field(default_factory=dict)
    dataset_labels: Set[str] = field(default_factory=set)
    tags: Set[str] = field(default_factory=set)
    files: Dict[FileType, str] = field(default_factory=dict)
    # persisted data-consistency findings (AbstractNeuronEntity.java:50,
    # written by validateDBData and cleared when re-validation passes)
    validation_errors: Set[str] = field(default_factory=set)

    JSON_CLASS = ""

    @property
    def neuron_id(self) -> Optional[str]:
        return self.published_name

    def compute_file(self, ftype: ComputeFileType) -> Optional[FileData]:
        return self.compute_files.get(ftype)

    def add_processed_tag(self, ptype: ProcessingType, tag: str) -> None:
        self.processed_tags.setdefault(ptype, set()).add(tag)

    def has_processed_tag(self, ptype: ProcessingType, tag: str) -> bool:
        return tag in self.processed_tags.get(ptype, set())

    # --- JSON ---
    def _base_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"class": self.JSON_CLASS}
        if self.entity_id is not None:
            d["id"] = str(self.entity_id)
        for k, v in (("mipId", self.mip_id),
                     ("alignmentSpace", self.alignment_space),
                     ("libraryName", self.library_name),
                     ("publishedName", self.published_name),
                     ("sourceRefId", self.source_ref_id)):
            if v is not None:
                d[k] = v
        if self.neuron_terms:
            d["neuronTerms"] = list(self.neuron_terms)
        if self.compute_files:
            d["computeFiles"] = {t.name: f.to_json()
                                 for t, f in sorted(self.compute_files.items(),
                                                    key=lambda kv: kv[0].name)}
        if self.files:
            d["files"] = {t.name: v for t, v in sorted(self.files.items(),
                                                       key=lambda kv: kv[0].name)}
        if self.processed_tags:
            d["processedTags"] = {p.name: sorted(tags)
                                  for p, tags in self.processed_tags.items()}
        if self.dataset_labels:
            d["datasetLabels"] = sorted(self.dataset_labels)
        if self.tags:
            d["tags"] = sorted(self.tags)
        if self.validation_errors:
            d["validationErrors"] = sorted(self.validation_errors)
        return d

    def to_dict(self) -> Dict[str, Any]:
        return self._base_dict()

    def _load_base(self, d: Dict[str, Any]) -> None:
        self.entity_id = int(d["id"]) if d.get("id") else None
        self.mip_id = d.get("mipId")
        self.alignment_space = d.get("alignmentSpace")
        self.library_name = d.get("libraryName")
        self.published_name = d.get("publishedName")
        self.source_ref_id = d.get("sourceRefId")
        self.neuron_terms = d.get("neuronTerms")
        for name, value in (d.get("computeFiles") or {}).items():
            ft = ComputeFileType.from_name(name)
            if ft:
                self.compute_files[ft] = FileData.from_json(value)
        for name, value in (d.get("files") or {}).items():
            ft = FileType.from_name(name)
            if ft:
                self.files[ft] = value
        for name, tags in (d.get("processedTags") or {}).items():
            try:
                self.processed_tags[ProcessingType(name)] = set(tags)
            except ValueError:
                pass
        self.dataset_labels = set(d.get("datasetLabels") or [])
        self.tags = set(d.get("tags") or [])
        self.validation_errors = set(d.get("validationErrors") or [])


@dataclass
class EMNeuronEntity(NeuronEntity):
    """EM body MIP (EMNeuronEntity.java:11-15)."""
    neuron_type: Optional[str] = None
    neuron_instance: Optional[str] = None
    state: Optional[str] = None

    JSON_CLASS = _EM_CLASS

    def to_dict(self) -> Dict[str, Any]:
        d = self._base_dict()
        for k, v in (("neuronType", self.neuron_type),
                     ("neuronInstance", self.neuron_instance),
                     ("state", self.state)):
            if v is not None:
                d[k] = v
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EMNeuronEntity":
        e = cls()
        e._load_base(d)
        e.neuron_type = d.get("neuronType")
        e.neuron_instance = d.get("neuronInstance")
        e.state = d.get("state")
        return e


@dataclass
class LMNeuronEntity(NeuronEntity):
    """LM sample MIP (LMNeuronEntity.java:17-28)."""
    internal_line_name: Optional[str] = None
    slide_code: Optional[str] = None
    anatomical_area: Optional[str] = None
    gender: Optional[Gender] = None
    objective: Optional[str] = None

    JSON_CLASS = _LM_CLASS

    @property
    def neuron_id(self) -> Optional[str]:
        return self.slide_code

    def to_dict(self) -> Dict[str, Any]:
        d = self._base_dict()
        for k, v in (("internalLineName", self.internal_line_name),
                     ("slideCode", self.slide_code),
                     ("anatomicalArea", self.anatomical_area),
                     ("objective", self.objective)):
            if v is not None:
                d[k] = v
        if self.gender is not None:
            d["gender"] = self.gender.name
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LMNeuronEntity":
        e = cls()
        e._load_base(d)
        e.internal_line_name = d.get("internalLineName")
        e.slide_code = d.get("slideCode")
        e.anatomical_area = d.get("anatomicalArea")
        e.gender = Gender.from_val(d.get("gender"))
        e.objective = d.get("objective")
        return e


def entity_from_dict(d: Dict[str, Any]) -> NeuronEntity:
    cls_name = d.get("class", "")
    if cls_name.endswith("EMNeuronEntity"):
        return EMNeuronEntity.from_dict(d)
    if cls_name.endswith("LMNeuronEntity"):
        return LMNeuronEntity.from_dict(d)
    # default by presence of EM-ish fields
    if "neuronType" in d or "neuronInstance" in d:
        return EMNeuronEntity.from_dict(d)
    return LMNeuronEntity.from_dict(d)


@dataclass
class AbstractMatchEntity:
    """Base match (AbstractMatchEntity.java:22-30)."""
    entity_id: Optional[int] = None
    session_ref_id: Optional[str] = None
    mask_image: Optional[NeuronEntity] = None
    matched_image: Optional[NeuronEntity] = None
    mask_image_ref_id: Optional[int] = None
    matched_image_ref_id: Optional[int] = None
    mirrored: bool = False
    match_compute_files: Dict[str, FileData] = field(default_factory=dict)
    match_files: Dict[FileType, str] = field(default_factory=dict)
    tags: Set[str] = field(default_factory=set)

    def mask_ref(self) -> Optional[int]:
        if self.mask_image_ref_id is not None:
            return self.mask_image_ref_id
        return self.mask_image.entity_id if self.mask_image else None

    def matched_ref(self) -> Optional[int]:
        if self.matched_image_ref_id is not None:
            return self.matched_image_ref_id
        return self.matched_image.entity_id if self.matched_image else None


@dataclass
class CDMatchEntity(AbstractMatchEntity):
    """Color depth search match (CDMatchEntity.java:12-170)."""
    normalized_score: Optional[float] = None
    matching_pixels: Optional[int] = None
    matching_pixels_ratio: Optional[float] = None
    bidirectional_area_gap: Optional[int] = None
    gradient_area_gap: Optional[int] = None
    high_expression_area: Optional[int] = None
    match_found: bool = False
    errors: Optional[str] = None

    JSON_CLASS = _CDMATCH_CLASS

    @property
    def grad_score(self) -> int:
        """getGradScore (CDMatchEntity.java:76-86)."""
        from ..cds.scores import calculate_2d_shape_score
        if not self.has_grad_score:
            return -1
        if self.bidirectional_area_gap is not None and self.bidirectional_area_gap >= 0:
            return self.bidirectional_area_gap
        return calculate_2d_shape_score(self.gradient_area_gap, self.high_expression_area)

    @property
    def has_grad_score(self) -> bool:
        if self.bidirectional_area_gap is not None and self.bidirectional_area_gap >= 0:
            return True
        return (self.gradient_area_gap is not None and self.gradient_area_gap >= 0
                and self.high_expression_area is not None and self.high_expression_area >= 0)

    def reset_gradient_scores(self) -> None:
        self.gradient_area_gap = None
        self.high_expression_area = None
        self.bidirectional_area_gap = None
        self.normalized_score = None

    def to_dict(self, include_images: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {"class": self.JSON_CLASS}
        if self.entity_id is not None:
            d["id"] = str(self.entity_id)
        if include_images and self.mask_image is not None:
            d["maskImage"] = self.mask_image.to_dict()
        if include_images and self.matched_image is not None:
            d["image"] = self.matched_image.to_dict()
        if self.mask_image_ref_id is not None:
            d["maskImageRefId"] = str(self.mask_image_ref_id)
        if self.matched_image_ref_id is not None:
            d["matchedImageRefId"] = str(self.matched_image_ref_id)
        if self.session_ref_id is not None:
            d["sessionRefId"] = str(self.session_ref_id)
        d["mirrored"] = self.mirrored
        if self.match_compute_files:
            d["matchComputeFiles"] = {k: f.to_json()
                                      for k, f in self.match_compute_files.items()}
        if self.match_files:
            d["files"] = {t.name: v for t, v in self.match_files.items()}
        for k, v in (("normalizedScore", self.normalized_score),
                     ("matchingPixels", self.matching_pixels),
                     ("matchingPixelsRatio", self.matching_pixels_ratio),
                     ("bidirectionalAreaGap", self.bidirectional_area_gap),
                     ("gradientAreaGap", self.gradient_area_gap),
                     ("highExpressionArea", self.high_expression_area),
                     ("errors", self.errors)):
            if v is not None:
                d[k] = v
        if self.tags:
            d["tags"] = sorted(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CDMatchEntity":
        m = cls()
        m.entity_id = int(d["id"]) if d.get("id") else None
        if d.get("maskImage"):
            m.mask_image = entity_from_dict(d["maskImage"])
        if d.get("image"):
            m.matched_image = entity_from_dict(d["image"])
        if d.get("maskImageRefId"):
            m.mask_image_ref_id = int(d["maskImageRefId"])
        if d.get("matchedImageRefId"):
            m.matched_image_ref_id = int(d["matchedImageRefId"])
        if d.get("sessionRefId"):
            m.session_ref_id = d["sessionRefId"]
        m.mirrored = bool(d.get("mirrored", False))
        for k, v in (d.get("matchComputeFiles") or {}).items():
            m.match_compute_files[k] = FileData.from_json(v)
        for name, v in (d.get("files") or {}).items():
            ft = FileType.from_name(name)
            if ft:
                m.match_files[ft] = v
        m.normalized_score = d.get("normalizedScore")
        m.matching_pixels = d.get("matchingPixels")
        m.matching_pixels_ratio = d.get("matchingPixelsRatio")
        m.bidirectional_area_gap = d.get("bidirectionalAreaGap")
        m.gradient_area_gap = d.get("gradientAreaGap")
        m.high_expression_area = d.get("highExpressionArea")
        m.errors = d.get("errors")
        m.tags = set(d.get("tags") or [])
        return m


_LM_REG_UNISEX_RE = re.compile(r"(.+)_REG_UNISEX_(.+)", re.IGNORECASE)
_OBJECTIVE_RE = re.compile(r"\d+x", re.IGNORECASE)
_DEFAULT_PPP_OBJECTIVE = "40x"


@dataclass
class PPPMatchEntity(AbstractMatchEntity):
    """PatchPerPix match (PPPMatchEntity.java:15-35)."""
    source_em_name: Optional[str] = None
    source_em_library: Optional[str] = None
    source_lm_name: Optional[str] = None
    source_lm_library: Optional[str] = None
    cov_score: Optional[float] = None
    aggregate_coverage: Optional[float] = None
    rank: Optional[float] = None
    skeleton_matches: List[Dict[str, Any]] = field(default_factory=list)
    # PPPScreenshotType name -> screenshot image name
    # (PPPMatchEntity.sourceImageFiles, set at import by
    # addSourceImageFile; the EXPORT-side match files come from the
    # pppmURL published store, not from here)
    source_image_files: Dict[str, str] = field(default_factory=dict)

    JSON_CLASS = _PPPMATCH_CLASS

    def add_source_image_file(self, image_name: str) -> None:
        """PPPMatchEntity.addSourceImageFile:129-137 — classify the
        screenshot by suffix; unknown suffixes are ignored."""
        from .enums import PPPScreenshotType
        t = PPPScreenshotType.find_screenshot_type(image_name)
        if t is not None:
            self.source_image_files[t.name] = image_name

    @property
    def has_source_image_files(self) -> bool:
        """PPPMatchEntity.hasSourceImageFiles:139-141."""
        return bool(self.source_image_files)

    def extract_lm_sample_name(self) -> Optional[str]:
        """Strip the `_REG_UNISEX_<objective>` registration suffix
        (PPPMatchEntity.extractLMSampleName:189-196)."""
        if not self.source_lm_name:
            return self.source_lm_name
        m = _LM_REG_UNISEX_RE.match(self.source_lm_name)
        return m.group(1) if m else self.source_lm_name

    def source_objective(self) -> str:
        """Objective parsed from the LM name's registration suffix,
        defaulting to 40x (PPPMatchEntity.updateLMSampleInfo:198-216)."""
        if self.source_lm_name:
            m = _LM_REG_UNISEX_RE.match(self.source_lm_name)
            if m and _OBJECTIVE_RE.search(m.group(2)):
                return m.group(2)
        return _DEFAULT_PPP_OBJECTIVE

    def matched_target_metadata(self) -> Dict[str, Any]:
        """PPPMatchedTarget DTO scaffold (PPPMatchEntity.metadata()
        :174-187 + dto/PPPMatchedTarget.java:28-48): pppmRank/pppmScore
        with score = int(abs(coverageScore)); targetImage and match
        files are filled by the exporter from sample + pppmURL data."""
        d: Dict[str, Any] = {"type": "PPPMatch",
                             "mirrored": bool(self.mirrored),
                             "pppmRank": self.rank,
                             "pppmScore": int(abs(self.cov_score))
                             if self.cov_score is not None else 0}
        return d

    def to_dict(self, include_images: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {"class": self.JSON_CLASS}
        if self.entity_id is not None:
            d["id"] = str(self.entity_id)
        if include_images and self.mask_image is not None:
            d["maskImage"] = self.mask_image.to_dict()
        if include_images and self.matched_image is not None:
            d["image"] = self.matched_image.to_dict()
        for k, v in (("sourceEmName", self.source_em_name),
                     ("sourceEmLibrary", self.source_em_library),
                     ("sourceLmName", self.source_lm_name),
                     ("sourceLmLibrary", self.source_lm_library),
                     ("coverageScore", self.cov_score),
                     ("aggregateCoverage", self.aggregate_coverage),
                     ("rank", self.rank)):
            if v is not None:
                d[k] = v
        d["mirrored"] = self.mirrored
        if self.skeleton_matches:
            d["sourceSkeletonMatches"] = self.skeleton_matches
        if self.source_image_files:
            d["sourceImageFiles"] = dict(self.source_image_files)
        if self.match_files:
            d["files"] = {t.name: v for t, v in self.match_files.items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PPPMatchEntity":
        m = cls()
        m.entity_id = int(d["id"]) if d.get("id") else None
        if d.get("maskImage"):
            m.mask_image = entity_from_dict(d["maskImage"])
        if d.get("image"):
            m.matched_image = entity_from_dict(d["image"])
        m.source_em_name = d.get("sourceEmName")
        m.source_em_library = d.get("sourceEmLibrary")
        m.source_lm_name = d.get("sourceLmName")
        m.source_lm_library = d.get("sourceLmLibrary")
        m.cov_score = d.get("coverageScore")
        m.aggregate_coverage = d.get("aggregateCoverage")
        m.rank = d.get("rank")
        m.mirrored = bool(d.get("mirrored", False))
        m.skeleton_matches = d.get("sourceSkeletonMatches") or []
        m.source_image_files = dict(d.get("sourceImageFiles") or {})
        for name, v in (d.get("files") or {}).items():
            ft = FileType.from_name(name)
            if ft:
                m.match_files[ft] = v
        return m


@dataclass
class CDSSessionEntity:
    """CDS run provenance (CDSSessionEntity.java; persisted per run,
    ColorDepthSearchCmd.java:255-278)."""
    entity_id: Optional[int] = None
    username: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)
    masks: List[Dict[str, Any]] = field(default_factory=list)
    targets: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.entity_id is not None:
            d["id"] = str(self.entity_id)
        if self.username:
            d["username"] = self.username
        d["params"] = self.params
        d["masks"] = self.masks
        d["targets"] = self.targets
        return d
