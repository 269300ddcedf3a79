"""JACS REST data client.

Counterpart of cmd/jacsdata/*.java and cmd/HttpHelper.java: paged
retrieval of color depth MIPs with sample/body metadata from the JACS
data service, with retries and an auth header, plus the entity mapping
used by createColorDepthSearchDataInput
(CreateCDSDataInputCmd.java:569-614 asEMNeuron/asLMNeuron and
:646-666 retrieveColorDepthMipsWithSamples).

Pure stdlib (urllib) — no Jersey analogue needed; the service speaks
plain JSON over GET. All calls are synchronous; the import command
pages through results so memory stays bounded.

Copy of `colormipsearch_tpu/jacs/client.py`.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..model import (ComputeFileType, EMNeuronEntity, FileData, Gender,
                     LMNeuronEntity)

LOG = logging.getLogger(__name__)


@dataclass
class CDMIPSample:
    """LM sample metadata (cmd/jacsdata/CDMIPSample.java subset)."""
    id: Optional[str] = None
    name: Optional[str] = None
    line: Optional[str] = None
    publishing_name: Optional[str] = None
    slide_code: Optional[str] = None
    gender: Optional[str] = None
    mounting_protocol: Optional[str] = None
    release_label: Optional[str] = None
    published_to_staging: bool = True
    publishing_error: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> Optional["CDMIPSample"]:
        if d is None:
            return None
        return cls(id=d.get("_id"),
                   name=d.get("name"),
                   line=d.get("line"),
                   publishing_name=d.get("publishingName"),
                   slide_code=d.get("slideCode"),
                   gender=d.get("gender"),
                   mounting_protocol=d.get("mountingProtocol"),
                   release_label=d.get("releaseLabel"),
                   published_to_staging=d.get("publishedToStaging", True),
                   publishing_error=d.get("publishingError"))

    def ref(self) -> str:
        """Reference key (CDMIPSample.indexByRef: "Sample#" + id)."""
        return f"Sample#{self.id}"

    def lm_line_name(self) -> Optional[str]:
        """Published line name (CDMIPSample.lmLineName:78-80)."""
        return self.publishing_name if self.publishing_name else self.line


@dataclass
class CDMIPBody:
    """EM body metadata (cmd/jacsdata/CDMIPBody.java subset)."""
    id: Optional[str] = None
    dataset_identifier: Optional[str] = None
    neuron_terms: Optional[List[str]] = None
    files: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> Optional["CDMIPBody"]:
        if d is None:
            return None
        return cls(id=d.get("_id"),
                   dataset_identifier=d.get("datasetIdentifier"),
                   neuron_terms=d.get("neuronTerms"),
                   files=d.get("files") or {})

    def ref(self) -> str:
        """Reference key (CDMIPBody.indexByRef: "EMBody#" + id)."""
        return f"EMBody#{self.id}"


@dataclass
class ColorDepthMIP:
    """A JACS color depth MIP record with its sample/body joins
    (cmd/jacsdata/ColorDepthMIP.java; accessor semantics :86-199)."""
    id: Optional[str] = None
    name: Optional[str] = None
    filepath: Optional[str] = None
    alignment_space: Optional[str] = None
    library_name: Optional[str] = None
    anatomical_area: Optional[str] = None
    objective: Optional[str] = None
    channel: Optional[str] = None
    body_id: Optional[int] = None
    neuron_type: Optional[str] = None
    neuron_instance: Optional[str] = None
    sample_ref: Optional[str] = None
    em_body_ref: Optional[str] = None
    public_image_url: Optional[str] = None
    public_thumbnail_url: Optional[str] = None
    sample: Optional[CDMIPSample] = None
    em_body: Optional[CDMIPBody] = None
    libraries: List[str] = None  # ALL JACS libraries holding this MIP
                                 # (ColorDepthMIP.java `libraries`)
    sample_3d_stack: Optional[str] = None       # sample3DImageStack
    sample_gal4_expression: Optional[str] = None  # sampleGen1Gal4ExpressionImage

    @classmethod
    def from_dict(cls, d: Dict) -> "ColorDepthMIP":
        return cls(id=d.get("id"), name=d.get("name"),
                   libraries=list(d.get("libraries") or []),
                   sample_3d_stack=d.get("sample3DImageStack"),
                   sample_gal4_expression=d.get("sampleGen1Gal4ExpressionImage"),
                   filepath=d.get("filepath"),
                   alignment_space=d.get("alignmentSpace"),
                   library_name=d.get("libraryName"),
                   anatomical_area=d.get("anatomicalArea"),
                   objective=d.get("objective"),
                   channel=d.get("channel"),
                   body_id=d.get("bodyId"),
                   neuron_type=d.get("neuronType"),
                   neuron_instance=d.get("neuronInstance"),
                   sample_ref=d.get("sampleRef"),
                   em_body_ref=d.get("emBodyRef"),
                   public_image_url=d.get("publicImageUrl"),
                   public_thumbnail_url=d.get("publicThumbnailUrl"),
                   sample=CDMIPSample.from_dict(d.get("sample")),
                   em_body=CDMIPBody.from_dict(d.get("emBody")))

    # accessor semantics mirrored from ColorDepthMIP.java:86-199
    def em_body_id(self) -> Optional[str]:
        return str(self.body_id) if self.body_id is not None else None

    def em_dataset(self) -> Optional[str]:
        return self.em_body.dataset_identifier if self.em_body else None

    def em_terms(self) -> Optional[List[str]]:
        return self.em_body.neuron_terms if self.em_body else None

    def lm_internal_line_name(self) -> Optional[str]:
        return self.sample.line if self.sample else None

    def lm_line_name(self) -> Optional[str]:
        return self.sample.publishing_name if self.sample else None

    def lm_slide_code(self) -> Optional[str]:
        return self.sample.slide_code if self.sample else None

    def lm_gender(self) -> Optional[str]:
        return self.sample.gender if self.sample else None

    def lm_release_names(self) -> List[str]:
        if self.sample and self.sample.release_label:
            return [self.sample.release_label]
        return []


def http_get_json(url: str, auth: Optional[str] = None, timeout: float = 60.0,
                  retries: int = 3, backoff: float = 2.0):
    """GET with retry/backoff (cmd/HttpHelper.java analogue)."""
    last_err: Optional[Exception] = None
    for attempt in range(retries + 1):
        req = urllib.request.Request(url)
        req.add_header("Accept", "application/json")
        if auth:
            req.add_header("Authorization", auth)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status} from {url}")
                return json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 - retried, then re-raised
            last_err = e
            if attempt < retries:
                LOG.warning("request %s failed (%s), retry %d/%d",
                            url, e, attempt + 1, retries)
                time.sleep(backoff * (attempt + 1))
    raise RuntimeError(f"JACS request failed after {retries + 1} "
                       f"attempts: {url}") from last_err


class JacsClient:
    """Paged JACS data-service reader
    (CreateCDSDataInputCmd.java:646-678)."""

    def __init__(self, base_url: str, authorization: Optional[str] = None,
                 page_size: int = 10000, retries: int = 3):
        self.base_url = base_url.rstrip("/")
        self.authorization = authorization
        self.page_size = page_size
        self.retries = retries

    def _get(self, path: str, **params):
        qs = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v not in (None, "", [])})
        url = f"{self.base_url}{path}?{qs}" if qs else f"{self.base_url}{path}"
        return http_get_json(url, auth=self.authorization,
                             retries=self.retries)

    def count_color_depth_mips(self, library_name: str,
                               alignment_space: str) -> int:
        out = self._get("/data/colorDepthMIPsCount",
                        libraryName=library_name,
                        alignmentSpace=alignment_space)
        return int(out)

    def retrieve_color_depth_mips_with_samples(
            self, library_name: str, alignment_space: str,
            datasets: Sequence[str] = (), releases: Sequence[str] = (),
            mip_ids: Sequence[str] = ()) -> List[ColorDepthMIP]:
        """All pages of /data/colorDepthMIPsWithSamples
        (query params per CreateCDSDataInputCmd.java:655-664)."""
        out: List[ColorDepthMIP] = []
        offset = 0
        while True:
            batch = self._get(
                "/data/colorDepthMIPsWithSamples",
                libraryName=library_name, alignmentSpace=alignment_space,
                dataset=",".join(d for d in datasets if d) or None,
                release=",".join(r for r in releases if r) or None,
                id=",".join(m for m in mip_ids if m) or None,
                offset=offset, length=self.page_size)
            if not batch:
                break
            out.extend(ColorDepthMIP.from_dict(d) for d in batch)
            if len(batch) < self.page_size:
                break
            offset += len(batch)
        return out

    def retrieve_color_depth_mips_by_ids(
            self, mip_ids: Sequence[str]) -> List[ColorDepthMIP]:
        """One `/data/colorDepthMIPsWithSamples?id=...` fetch for an
        id set (JacsDataGetter.httpRetrieveCDMIPs; the caller batches
        ids to the read batch size)."""
        if not mip_ids:
            return []
        batch = self._get("/data/colorDepthMIPsWithSamples",
                          id=",".join(mip_ids))
        return [ColorDepthMIP.from_dict(d) for d in (batch or [])]

    def retrieve_lm_samples_by_refs(
            self, sample_refs: Sequence[str]) -> List[CDMIPSample]:
        """`/data/samples?refs=...` for a sample-ref set
        (JacsDataGetter.httpRetrieveLMSamplesByRefs)."""
        if not sample_refs:
            return []
        batch = self._get("/data/samples", refs=",".join(sample_refs))
        return [CDMIPSample.from_dict(d) for d in (batch or [])]

    def retrieve_em_bodies_by_refs(
            self, em_body_refs: Sequence[str]) -> List[CDMIPBody]:
        """`/emdata/emBodies?refs=...` for an EM-body-ref set
        (JacsDataGetter.httpRetrieveEMBodiesByRefs)."""
        if not em_body_refs:
            return []
        batch = self._get("/emdata/emBodies", refs=",".join(em_body_refs))
        return [CDMIPBody.from_dict(d) for d in (batch or [])]

    def retrieve_lm_samples_by_name(
            self, sample_names: Sequence[str]) -> List["CDMIPSample"]:
        """`/data/samples?name=...` for a sample-name set
        (JacsDataGetter.httpRetrieveLMSamplesByName:43-59)."""
        if not sample_names:
            return []
        batch = self._get("/data/samples", name=",".join(sample_names))
        return [CDMIPSample.from_dict(d) for d in (batch or [])]


def retrieve_library_name_mapping(config_url: str,
                                  retries: int = 3) -> Dict[str, str]:
    """Internal-library-id -> display-name map from the NeuronBridge
    config service `{configURL}/cdm_library` (no auth;
    JacsDataGetter.retrieveLibraryNameMapping)."""
    doc = http_get_json(config_url.rstrip("/") + "/cdm_library",
                        retries=retries)
    config = doc.get("config")
    if not isinstance(config, dict):
        raise RuntimeError(f"Config entry not found in {config_url}")
    return {lid: (ldata or {}).get("name")
            for lid, ldata in config.items()}


class CachedDataHelper:
    """MIP-by-id cache shared across export passes
    (cmd/jacsdata/CachedDataHelper.java)."""

    def __init__(self, client: Optional[JacsClient] = None,
                 read_batch_size: int = 5000):
        self.client = client
        self.read_batch_size = read_batch_size
        self._mips: Dict[str, ColorDepthMIP] = {}
        self._library_names: Dict[str, str] = {}

    def cache_mips(self, mips: Sequence[ColorDepthMIP]) -> None:
        for m in mips:
            if m.id:
                self._mips[m.id] = m

    def cache_cdmips(self, mip_ids: Sequence[str]) -> None:
        """Fetch-and-cache the not-yet-cached MIPs by id in
        read-batch-size groups (CachedDataHelper.cacheCDMIPs +
        JacsDataGetter.httpRetrieveCDMIPs, batched `id` field values),
        then hydrate MIPs that carry a sample/EM-body REF without the
        embedded doc (JacsDataGetter.retrieveCDMIPs:126-151 via
        needsEMBody/needsLMSample) — without this, enrichment fields
        (publishedName, gender, neuronType, terms) would silently stay
        None and export validation would drop those matches."""
        if self.client is None:
            return
        missing = sorted({m for m in mip_ids if m and m not in self._mips})
        fetched: List[ColorDepthMIP] = []
        for i in range(0, len(missing), self.read_batch_size):
            fetched.extend(self.client.retrieve_color_depth_mips_by_ids(
                missing[i:i + self.read_batch_size]))
        self.cache_mips(fetched)
        self._hydrate_refs(fetched)

    def _hydrate_refs(self, mips: Sequence[ColorDepthMIP]) -> None:
        """Attach LM samples / EM bodies fetched by ref. Mirrors the
        reference's else-if priority: a MIP needing an EM body does not
        also fetch its sample (JacsDataGetter.retrieveCDMIPs:129-136)."""
        need_bodies = sorted({m.em_body_ref for m in mips
                              if m.em_body_ref and m.em_body is None})
        need_samples = sorted({m.sample_ref for m in mips
                               if m.sample_ref and m.sample is None
                               and not (m.em_body_ref and m.em_body is None)})
        bodies: Dict[str, CDMIPBody] = {}
        samples: Dict[str, CDMIPSample] = {}
        for i in range(0, len(need_bodies), self.read_batch_size):
            for b in self.client.retrieve_em_bodies_by_refs(
                    need_bodies[i:i + self.read_batch_size]):
                bodies[b.ref()] = b
        for i in range(0, len(need_samples), self.read_batch_size):
            for s in self.client.retrieve_lm_samples_by_refs(
                    need_samples[i:i + self.read_batch_size]):
                samples[s.ref()] = s
        for m in mips:
            if m.em_body_ref and m.em_body is None:
                m.em_body = bodies.get(m.em_body_ref)
            elif m.sample_ref and m.sample is None:
                m.sample = samples.get(m.sample_ref)

    def get_color_depth_mip(self, mip_id: str) -> Optional[ColorDepthMIP]:
        return self._mips.get(mip_id)

    # dict-compatible accessors: the export enrichment overlay accepts
    # either the offline fixture dict or this live helper
    def get(self, mip_id: str) -> Optional[ColorDepthMIP]:
        return self._mips.get(mip_id)

    def prefetch(self, mip_ids: Sequence[str]) -> None:
        self.cache_cdmips(mip_ids)

    def set_library_name_mapping(self, mapping: Dict[str, str]) -> None:
        self._library_names = dict(mapping)

    def get_library_name(self, internal_name: Optional[str]) -> Optional[str]:
        if internal_name is None:
            return None
        return self._library_names.get(internal_name, internal_name)


def em_neuron_from_mip(mip: ColorDepthMIP, library_name: str,
                       alignment_space: str) -> EMNeuronEntity:
    """ColorDepthMIP -> EMNeuronEntity
    (CreateCDSDataInputCmd.java:569-592)."""
    e = EMNeuronEntity()
    e.mip_id = mip.id
    e.alignment_space = mip.alignment_space or alignment_space
    e.library_name = library_name
    e.source_ref_id = mip.em_body_ref
    e.published_name = mip.em_body_id()
    e.neuron_instance = mip.neuron_instance
    e.neuron_type = mip.neuron_type
    terms = mip.em_terms()
    if terms:
        e.neuron_terms = list(terms)
    ds = mip.em_dataset()
    if ds:
        e.dataset_labels.add(ds)
    if mip.filepath:
        e.compute_files[ComputeFileType.SourceColorDepthImage] = \
            FileData.from_string(mip.filepath)
    if mip.em_body:
        for key, ftype in (("SkeletonSWC", ComputeFileType.SkeletonSWC),
                           ("SkeletonOBJ", ComputeFileType.SkeletonOBJ)):
            if mip.em_body.files.get(key):
                e.compute_files[ftype] = FileData.from_string(
                    mip.em_body.files[key])
    return e


def lm_neuron_from_mip(mip: ColorDepthMIP, library_name: str,
                       alignment_space: str) -> LMNeuronEntity:
    """ColorDepthMIP -> LMNeuronEntity
    (CreateCDSDataInputCmd.java:594-614)."""
    e = LMNeuronEntity()
    e.mip_id = mip.id
    e.alignment_space = mip.alignment_space or alignment_space
    e.library_name = library_name
    e.source_ref_id = mip.sample_ref
    e.internal_line_name = mip.lm_internal_line_name()
    e.published_name = mip.lm_line_name()
    e.slide_code = mip.lm_slide_code()
    e.anatomical_area = mip.anatomical_area
    g = mip.lm_gender()
    e.gender = Gender.from_val(g) if g else None
    e.objective = mip.objective
    for r in mip.lm_release_names():
        e.dataset_labels.add(r)
    if mip.filepath:
        e.compute_files[ComputeFileType.SourceColorDepthImage] = \
            FileData.from_string(mip.filepath)
    return e
