"""Packed preprocessed array cache (`--array-cache`).

Copy of `colormipsearch_tpu/imageproc/store.py`. SURVEY.md §7 flags host
decode throughput as a hard part: production sweeps touch 100k+ TIFFs.
This store converts decoded images to .npy files once (a one-time
ingest), after which steady-state loads are memory-mapped at memcpy
speed; the PIL decoder remains the ingest path (the reference's ranged
packbits read, ImageArrayUtils.java:184-258, plays the same role for its
Java pipeline).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np

from ..model.filedata import FileData
from .io import Image, image_from_array

LOG = logging.getLogger(__name__)


class PackedArrayStore:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, fd: FileData) -> str:
        ident = f"{fd.file_name}::{fd.entry_name or ''}"
        return hashlib.sha1(ident.encode()).hexdigest()

    def load(self, fd: Optional[FileData]) -> Optional[Image]:
        if fd is None:
            return None
        path = os.path.join(self.cache_dir, self._key(fd) + ".npy")
        if os.path.exists(path):
            try:
                return image_from_array(np.load(path, mmap_mode="r"))
            except (OSError, ValueError) as e:
                LOG.warning("corrupt array cache entry %s: %s", path, e)
        from ..mips.loader import load_image_from_filedata
        img = load_image_from_filedata(fd)
        if img is None:
            return None
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, np.ascontiguousarray(img.pixels))
        os.replace(tmp, path)
        return img
