"""ctypes bindings for the port's copy of the mipops native library.

Counterpart of `colormipsearch_tpu/native/mipops.py`, for the entry
point that the colorDepthSearch path calls (`pack_planes_native`, the
query's words). The shared library is built on first use from
`mipops.cpp` with g++ (-O3, OpenMP) into `build/native/` beside the
package (ignored by git), named by a hash of the source and the flags,
never beside the source. This is host code: where g++ is missing or the
build fails, `pack_planes_native` returns None and its caller keeps the
reference's NumPy path, with the same output.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

LOG = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mipops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        blob = f.read()
    digest = hashlib.sha1(blob + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libcms_mipops_{digest[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        LOG.warning("native mipops build failed (%s); using NumPy paths", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            LOG.warning("native mipops load failed: %s", e)
            return None
        lib.pack_planes_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def pack_planes_native(rgb: np.ndarray, threshold: int,
                       excluded: Optional[np.ndarray] = None
                       ) -> Optional[np.ndarray]:
    """Packed scorer words from interleaved RGB u8 [H, W, 3]."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), dtype=np.int32)
    exc_ptr = None
    if excluded is not None:
        excluded = np.ascontiguousarray(excluded, dtype=np.uint8)
        exc_ptr = excluded.ctypes.data
    lib.pack_planes_rgb(rgb.ctypes.data, out.ctypes.data, h * w,
                        threshold, exc_ptr)
    return out
