"""Build and bind the package's CUDA kernels.

Each source `colormipsearch_torch/csrc/<name>.cu` is compiled with nvcc
into its own shared library with a plain C interface and loaded with
ctypes (no PyTorch headers, so a build takes seconds). The build happens
at first use, from the sources in the checkout only, into
`build/torch_kernels/` beside the package (ignored by git through
`build/`). A library's file name carries a hash of its source, of every
local header it includes and of the flags, so a stale build is never
loaded. A failed build raises; nothing falls back to a plain version.
`load_libraries` builds several at once, one nvcc process each; `sass`
disassembles a built library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# library name -> {C entry point: argument types}; every entry returns
# the launch's cudaError_t as an int (0 on success)
BINDINGS = {
    "multimask_ratio": {"cms_multimask_ratio": [
        _P, _P, _I, _I,          # frames, flipped, hp, wp
        _P, _P, _P,              # q_cmp, q_f32, coords
        _P, _P, _I,              # row_off, tile_list, n_rows
        _P, _P, _I, _I,          # tgt, surv, xy_shift, mirror
        _P, _P, _I]},            # out, stream, device
    "multimask_words": {"cms_multimask_words": [
        _P, _P, _I, _I,          # frames, flipped, hp, wp
        _P, _P,                  # q_words, coords
        _P, _P, _I,              # row_off, tile_list, n_rows
        _P, _P, _I, _I,          # tgt, surv, xy_shift, mirror
        ctypes.POINTER(_I),      # triples: 6 x (Q, Rhi, Rlo), host ints
        _P, _P, _I]},            # out, stream, device
    "op_chain": {"cms_op_chain": [
        _I, _P, _P, _P,          # op case, x, y, out
        _I, _I, _P, _I],         # n elements, steps, stream, device
        "cms_op_chain_loop_steps": []},  # returns a count, not an error
}
LIBRARIES = tuple(BINDINGS)


@dataclass
class KernelLibrary:
    name: str
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str        # nvcc's output (-Xptxas -v: registers, smem)


_locks = {name: threading.Lock() for name in LIBRARIES}
_loaded: Dict[str, KernelLibrary] = {}


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _with_headers(path: str, seen: set) -> bytes:
    """The file's bytes followed by those of every local header it
    includes (#include "..." under csrc/), recursively."""
    with open(path, "rb") as f:
        src = f.read()
    out = [src]
    for inc in re.findall(rb'#include\s+"([^"]+)"', src):
        hdr = os.path.join(CSRC, inc.decode())
        if hdr not in seen:
            seen.add(hdr)
            out.append(_with_headers(hdr, seen))
    return b"".join(out)


def library_path(name: str) -> str:
    """Where the library of `name` is built: its file name holds the hash
    of the source, its headers and the flags."""
    blob = _with_headers(source_path(name), set())
    digest = hashlib.sha1(blob + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcms_{name}_{digest}.so")


def load_library(name: str) -> KernelLibrary:
    """The built and bound library of csrc/<name>.cu (built on first
    call)."""
    if name not in BINDINGS:
        raise ValueError(f"unknown kernel library {name!r}; "
                         f"known: {LIBRARIES}")
    with _locks[name]:
        got = _loaded.get(name)
        if got is not None:
            return got
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                "kernels of colormipsearch_torch cannot be built")
        path = library_path(name)
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                                   source_path(name)],
                                  capture_output=True, text=True,
                                  timeout=600)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"({proc.returncode}):\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in BINDINGS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        got = KernelLibrary(name, lib, path, seconds, log)
        _loaded[name] = got
        return got


def sass(name: str) -> str:
    """The SASS of the built library of `name` (cuobjdump -sass, from
    PATH or beside nvcc); builds the library first if needed."""
    path = load_library(name).path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (PATH or beside nvcc)")
    proc = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {path} "
                           f"({proc.returncode}):\n{proc.stderr}")
    return proc.stdout


def load_libraries(names: Sequence[str] = LIBRARIES
                   ) -> Dict[str, KernelLibrary]:
    """Build (one nvcc process per source, all started together) and
    load the named libraries; raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
