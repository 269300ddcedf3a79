"""Build and bind the package's CUDA kernels.

The sources under `colormipsearch_torch/csrc/` are compiled with nvcc
into a shared library with a plain C interface and loaded with ctypes
(no PyTorch headers, so a build takes seconds). The build happens at
first use, from the sources in the checkout only, into
`build/torch_kernels/` beside the package (ignored by git through
`build/`). The library's file name carries a hash of the source and the
flags, so a stale build is never loaded. A failed build raises; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "multimask_ratio.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str        # nvcc's output (-Xptxas -v: registers, smem)


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.cms_multimask_ratio
    fn.argtypes = [p, p, i, i,          # frames, flipped, hp, wp
                   p, p, p,             # q_cmp, q_f32, coords
                   p, p, i,             # row_off, tile_list, n_rows
                   p, p, i, i,          # tgt, surv, xy_shift, mirror
                   p, p, i]             # out, stream, device
    fn.restype = ctypes.c_int


def load_library() -> KernelLibrary:
    """The built and bound kernel library (built on first call)."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                "kernels of colormipsearch_torch cannot be built")
        with open(SOURCE, "rb") as f:
            src = f.read()
        digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libcms_multimask_ratio_{digest}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True,
                                  timeout=600)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _bind(lib)
        _loaded = KernelLibrary(lib, path, seconds, log)
        return _loaded
