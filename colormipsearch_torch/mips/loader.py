"""MIP loading: FileData -> decoded Image, with caching.

Copy of `colormipsearch_tpu/mips/loader.py` without `filedata_exists`
(used by validateDBData only). Counterparts of
mips/NeuronMIPUtils.java:62-236 (loadComputeFile / loadImageFromFileData
/ openInputStream: plain file, directory entry, or zip entry with a
fallback archive scan) and cmd/CachedMIPsUtils.java:19-112 (the bounded
MIP cache keyed on (neuron, computeFileType)).
"""

from __future__ import annotations

import logging
import os
import threading
import zipfile
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from ..imageproc.io import Image, is_image_file, load_image
from ..model.entities import NeuronEntity
from ..model.enums import ComputeFileType
from ..model.filedata import FileData, FileDataType


@dataclass
class NeuronMIP:
    """A neuron entity paired with a loaded image
    (mips/NeuronMIP.java)."""
    neuron: NeuronEntity
    file_data: Optional[FileData]
    image: Optional[Image]


def _load_from_zip(archive: str, entry: str) -> Optional[Image]:
    with zipfile.ZipFile(archive) as zf:
        try:
            data = zf.read(entry)
        except KeyError:
            # fallback scan by basename (NeuronMIPUtils.openInputStream's
            # full-archive scan, NeuronMIPUtils.java:177-199)
            base = os.path.basename(entry)
            data = None
            for name in zf.namelist():
                if os.path.basename(name) == base and is_image_file(name):
                    data = zf.read(name)
                    break
            if data is None:
                return None
    return load_image(data)


def load_image_from_filedata(fd: Optional[FileData]) -> Optional[Image]:
    """loadImageFromFileData (NeuronMIPUtils.java:103-141).

    Decode failures return None instead of raising: one bad image must
    never kill a run (the reference's per-pair error capture,
    AbstractColorMIPSearchProcessor.java:80-83)."""
    if fd is None:
        return None
    try:
        if fd.data_type == FileDataType.zipEntry:
            if not os.path.exists(fd.file_name):
                return None
            return _load_from_zip(fd.file_name, fd.entry_name)
        path = fd.file_name
        if os.path.isdir(path) or not os.path.exists(path):
            return None
        return load_image(path)
    except Exception as e:
        logging.getLogger(__name__).warning("failed to decode %s: %s",
                                            fd.name, e)
        return None


def load_compute_file(neuron: NeuronEntity,
                      file_type: ComputeFileType) -> NeuronMIP:
    """loadComputeFile (NeuronMIPUtils.java:62-84)."""
    fd = neuron.compute_file(file_type)
    return NeuronMIP(neuron, fd, load_image_from_filedata(fd))


def _default_image_cache_bytes() -> int:
    """Byte budget for decoded images: CMS_IMAGE_CACHE_MB, else 20% of
    host RAM. The reference bounds its cache by ENTRY COUNT and budgets
    170 GB hosts for it (cdsparams.sh:22-25); an entry cap alone let
    the r5 dress rehearsal's GA stage grow past 100 GB RSS on a 125 GB
    host — decoded production frames are ~2 MB each and 100K entries is
    a ~200 GB license."""
    import os
    mb = os.environ.get("CMS_IMAGE_CACHE_MB")
    if mb:
        return int(mb) << 20
    from ..utils.memguard import host_memory
    _, total = host_memory()
    return min(total // 5, 64 << 30)


class MIPsCache:
    """Bounded LRU image cache keyed on (entity/mip id, compute file type)
    (CachedMIPsUtils.java:19-112; production sizes 100k-200k entries,
    scripts/cdsparams.sh:22-25). Bounded BOTH by entry count (the
    reference's --cacheSize semantics) and by decoded bytes."""

    def __init__(self, max_size: int = 100_000, array_store=None,
                 memory_guard=None, max_bytes: int | None = None):
        self.max_size = max_size
        self.max_bytes = (_default_image_cache_bytes()
                          if max_bytes is None else max_bytes)
        self._nbytes = 0
        # optional imageproc.store.PackedArrayStore for cross-run
        # decode-once caching
        self.array_store = array_store
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        if memory_guard is None:
            from ..utils.memguard import shared_guard
            memory_guard = shared_guard()
        self.memory_guard = memory_guard

    def _key(self, neuron: NeuronEntity, file_type: ComputeFileType):
        return (neuron.entity_id or neuron.mip_id, file_type)

    def _load(self, neuron: NeuronEntity,
              file_type: ComputeFileType) -> NeuronMIP:
        if self.array_store is not None:
            fd = neuron.compute_file(file_type)
            return NeuronMIP(neuron, fd, self.array_store.load(fd))
        return load_compute_file(neuron, file_type)

    def load_mip(self, neuron: NeuronEntity,
                 file_type: ComputeFileType) -> NeuronMIP:
        if self.max_size <= 0:
            return self._load(neuron, file_type)
        key = self._key(neuron, file_type)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                img = self._cache[key]
                return NeuronMIP(neuron, neuron.compute_file(file_type), img)
        mip = self._load(neuron, file_type)
        with self._lock:
            # two threads can race the same miss (e.g. the lookahead
            # prefetch vs the inline path); only count bytes for the
            # entry actually ADDED, or _nbytes drifts upward until the
            # byte budget evicts the cache into permanent thrash
            if key not in self._cache:
                self._nbytes += self._image_nbytes(mip.image)
            self._cache[key] = mip.image
            self._cache.move_to_end(key)
            while len(self._cache) > self.max_size or \
                    (self._nbytes > self.max_bytes and len(self._cache) > 1):
                _, old = self._cache.popitem(last=False)
                self._nbytes -= self._image_nbytes(old)
        # host memory-pressure reaction (AbstractCmd.java:52-62 analogue):
        # shrink instead of growing into an OOM — the cache refills
        # lazily once pressure clears
        self.memory_guard.relieve(self._evict_half, "image-cache")
        return mip

    @staticmethod
    def _image_nbytes(img) -> int:
        px = getattr(img, "pixels", None)
        return int(px.nbytes) if px is not None else 0

    def _evict_half(self) -> int:
        with self._lock:
            n = len(self._cache) // 2
            for _ in range(n):
                _, old = self._cache.popitem(last=False)
                self._nbytes -= self._image_nbytes(old)
        return n

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._nbytes = 0
