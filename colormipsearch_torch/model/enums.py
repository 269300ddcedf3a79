"""Domain enums, mirroring the reference's model enums.

- ComputeFileType: model/ComputeFileType.java:5-17
- FileType: model/FileType.java:5-27 (incl. PPP suffix mapping)
- ProcessingType: model/ProcessingType.java
- Gender: model/Gender.java

Copy of `colormipsearch_tpu/model/enums.py`.
"""

from __future__ import annotations

import enum
from typing import Optional


class ComputeFileType(enum.Enum):
    SourceColorDepthImage = "SourceColorDepthImage"
    InputColorDepthImage = "InputColorDepthImage"
    GradientImage = "GradientImage"
    ZGapImage = "ZGapImage"
    Vol3DSegmentation = "Vol3DSegmentation"
    SkeletonSWC = "SkeletonSWC"
    SkeletonOBJ = "SkeletonOBJ"
    JunkImage = "JunkImage"

    @classmethod
    def from_name(cls, name: str) -> Optional["ComputeFileType"]:
        for v in cls:
            if v.name.lower() == name.lower():
                return v
        return None


class FileType(enum.Enum):
    # (unique key, optional PPP file suffix) — keys must be distinct or
    # enum members with equal values silently alias each other
    store = ("store", None)
    CDM = ("CDM", None)
    CDMThumbnail = ("CDMThumbnail", None)
    CDMInput = ("CDMInput", None)
    CDMMatch = ("CDMMatch", None)
    CDMBest = ("CDMBest", "_5_ch.png")
    CDMBestThumbnail = ("CDMBestThumbnail", "_5_ch.jpg")
    CDMSkel = ("CDMSkel", "_6_ch_skel.png")
    SignalMip = ("SignalMip", "_1_raw.png")
    SignalMipMasked = ("SignalMipMasked", "_2_masked_raw.png")
    SignalMipMaskedSkel = ("SignalMipMaskedSkel", "_3_skel.png")
    Gal4Expression = ("Gal4Expression", None)
    VisuallyLosslessStack = ("VisuallyLosslessStack", None)
    AlignedBodySWC = ("AlignedBodySWC", None)
    AlignedBodyOBJ = ("AlignedBodyOBJ", None)
    CDSResults = ("CDSResults", None)
    PPPMResults = ("PPPMResults", None)

    def __init__(self, _key, suffix):
        self.file_suffix = suffix

    @classmethod
    def from_name(cls, name: str) -> Optional["FileType"]:
        for v in cls:
            if v.name.lower() == name.lower():
                return v
        return None

    @classmethod
    def find_by_ppp_suffix(cls, fname: str) -> Optional["FileType"]:
        for v in cls:
            if v.file_suffix and fname.endswith(v.file_suffix):
                return v
        return None

    @property
    def display_ppp_suffix(self) -> str:
        # strips the ordering prefix _n_ (FileType.getDisplayPPPSuffix)
        return "" if not self.file_suffix else self.file_suffix[3:]


class PPPScreenshotType(enum.Enum):
    """PPP screenshot kinds and the export FileTypes they publish as
    (model/PPPScreenshotType.java:5-40). A CH screenshot publishes both
    the MIP and its thumbnail reference."""
    RAW = (FileType.SignalMip, None)
    MASKED_RAW = (FileType.SignalMipMasked, None)
    SKEL = (FileType.SignalMipMaskedSkel, None)
    CH = (FileType.CDMBest, FileType.CDMBestThumbnail)
    CH_SKEL = (FileType.CDMSkel, None)

    def __init__(self, file_type, thumbnail_file_type):
        self.file_type = file_type
        self.thumbnail_file_type = thumbnail_file_type

    @property
    def has_thumbnail(self) -> bool:
        return self.thumbnail_file_type is not None

    @classmethod
    def find_screenshot_type(cls, image_name: str
                             ) -> Optional["PPPScreenshotType"]:
        """Match by the FileType's PPP file suffix
        (PPPScreenshotType.findScreenshotType)."""
        for t in cls:
            if t.file_type.file_suffix and \
                    image_name.endswith(t.file_type.file_suffix):
                return t
        return None

    @classmethod
    def from_name(cls, name: str) -> Optional["PPPScreenshotType"]:
        try:
            return cls[name]
        except KeyError:
            return None


class ProcessingType(enum.Enum):
    ColorDepthSearch = "ColorDepthSearch"
    GradientScore = "GradientScore"
    NormalizeGradientScore = "NormalizeGradientScore"
    PPPMatch = "PPPMatch"


class Gender(enum.Enum):
    f = "female"
    m = "male"

    @classmethod
    def from_val(cls, s: Optional[str]) -> Optional["Gender"]:
        if not s:
            return None
        for g in cls:
            if s.lower() in (g.name.lower(), g.value.lower()):
                return g
        return None
