"""Export-side URL and image-store transformations.

Copy of `colormipsearch_tpu/cmd/dataexport.py`.

Counterparts of cmd/dataexport/URLTransformer.java:21-99 and
cmd/dataexport/ImageStoreMapping.java:7-35 (plus the wiring in
cmd/ExportData4NBCmd.java:115-172,285-293):

- URLTransformer rewrites absolute URLs into relative ones starting at a
  configured path-component index, with per-FileType overrides; http(s)
  URLs always transform, other strings only when change_non_http is set
  for that file type; URLs with fewer components than the index are left
  as-is (with a warning).
- ImageStoreMapping picks the NeuronBridge image store for a neuron by
  (alignmentSpace, libraryName), falling back to alignmentSpace alone,
  then to the default store; the result is published as the neuron's
  FileType.store entry.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple
from urllib.parse import urlparse

LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class URLTransformerParams:
    relative_url_start: int
    change_non_http_urls: bool = False


class URLTransformer:
    """Relativize asset URLs (URLTransformer.java:52-99)."""

    def __init__(self, default_relative_url_start: int = -1,
                 per_file_type: Optional[Mapping[str, URLTransformerParams]] = None):
        self._default = URLTransformerParams(default_relative_url_start, False)
        self._per_type = dict(per_file_type or {})

    def _params(self, file_type: Optional[str]) -> URLTransformerParams:
        return self._per_type.get(file_type or "", self._default)

    def relativize_url(self, file_type: Optional[str], url: Optional[str]) -> str:
        params = self._params(file_type)
        if not url or not url.strip():
            return ""
        if params.relative_url_start < 0:
            return url
        low = url.lower()
        if low.startswith("https://") or low.startswith("http://"):
            path = urlparse(url.replace(" ", "+")).path
        elif params.change_non_http_urls:
            path = url
        else:
            return url
        parts = [p for p in path.split("/") if p]
        if params.relative_url_start >= len(parts):
            LOG.warning("URL %s for %s has fewer components than "
                        "configured start %d; left as is",
                        url, file_type, params.relative_url_start)
            return url
        return "/".join(parts[params.relative_url_start:])


class ImageStoreMapping:
    """(alignmentSpace[, libraryName]) -> image store name
    (ImageStoreMapping.java:16-26). Keys are tuples; a 1-tuple (or
    (alignmentSpace, None)) matches any library in that space."""

    def __init__(self, default_image_store: str,
                 stores: Optional[Mapping[Tuple[str, ...], str]] = None):
        self.default_image_store = default_image_store
        self._stores: Dict[Tuple[str, Optional[str]], str] = {}
        for key, store in (stores or {}).items():
            if len(key) == 1:
                self._stores[(key[0], None)] = store
            else:
                self._stores[(key[0], key[1])] = store

    def get_image_store(self, alignment_space: Optional[str],
                        library_name: Optional[str]) -> str:
        return self._stores.get(
            (alignment_space, library_name),
            self._stores.get((alignment_space, None),
                             self.default_image_store))


# uploaded-URL key -> published FileType name
# (ColorDepthMIP.java:28-31, updateEMNeuron :269-272 / updateLMNeuron
# :218-221; skeleton uploads are EM-only)
UPLOADED_KEY_TO_FILE_TYPE = (
    ("cdm", "CDM", None),
    ("cdm_thumbnail", "CDMThumbnail", None),
    ("skeletonswc", "AlignedBodySWC", "EM"),
    ("skeletonobj", "AlignedBodyOBJ", "EM"),
)


def apply_published_urls(files: Dict[str, str], uploaded: Mapping[str, str],
                         is_em: bool) -> Dict[str, str]:
    """Merge a neuron's uploaded published URLs into its files map
    (ColorDepthMIP.updateEMNeuron/updateLMNeuron)."""
    out = dict(files)
    for key, file_type, scope in UPLOADED_KEY_TO_FILE_TYPE:
        if scope == "EM" and not is_em:
            continue
        url = (uploaded or {}).get(key)
        if url:
            out[file_type] = url
    return out


def load_published_urls(path: str) -> Dict[str, Dict[str, str]]:
    """Read a published-URLs JSON file: a list of
    {"_id"|"id": neuronId, "uploaded": {key: url}} records (the shape of
    the reference's publishedURLs Mongo collection,
    model/NeuronPublishedURLs.java:10-15)."""
    import json
    with open(path) as f:
        docs = json.load(f)
    out = {}
    for d in docs:
        nid = d.get("_id", d.get("id"))
        if nid is not None:
            out[str(nid)] = d.get("uploaded") or {}
    return out


def load_published_lm_stacks(path: str) -> Dict[str, Dict[str, str]]:
    """Published LM image stacks keyed by slideCode (or mipId): records
    {"slideCode"|"id": ..., "files": {"VisuallyLosslessStack": url,
    "Gal4Expression": url}} — the publishedLMImages collection analogue
    (model/PublishedLMImage.java; applied at
    ColorDepthMIP.updateLMNeuron:220-221)."""
    import json
    with open(path) as f:
        docs = json.load(f)
    out = {}
    for d in docs:
        key = d.get("slideCode") or d.get("id")
        if key is not None:
            out[str(key)] = d.get("files") or {}
    return out


def apply_published_lm_stacks(files: Dict[str, str],
                              stacks: Mapping[str, str]) -> Dict[str, str]:
    out = dict(files)
    for ft in ("VisuallyLosslessStack", "Gal4Expression"):
        if stacks.get(ft):
            out[ft] = stacks[ft]
    return out


def parse_file_type_indexes(pairs) -> Dict[str, URLTransformerParams]:
    """--relative-url-indexes-by-filetype values: FileType=index[,nonhttp]."""
    out: Dict[str, URLTransformerParams] = {}
    for spec in pairs or []:
        name, _, val = spec.partition("=")
        if not val:
            raise ValueError(f"expected FileType=index, got {spec!r}")
        idx, _, flag = val.partition(",")
        out[name.strip()] = URLTransformerParams(
            int(idx), flag.strip().lower() in ("1", "true", "nonhttp"))
    return out


def parse_image_store_mapping(default_store: str, specs) -> ImageStoreMapping:
    """--image-stores-per-neuron-meta values:
    alignmentSpace[:libraryName]=storeName."""
    stores: Dict[Tuple[str, ...], str] = {}
    for spec in specs or []:
        key, _, store = spec.partition("=")
        if not store:
            raise ValueError(f"expected key=store, got {spec!r}")
        parts = tuple(p for p in key.split(":") if p)
        stores[parts] = store.strip()
    return ImageStoreMapping(default_store, stores)
