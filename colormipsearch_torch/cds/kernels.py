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
disassembles a built library, `sass_loops` finds its loops, and
`issue_bound_s` puts a loop's instructions against the card's peak issue
rates.
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
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_PTRS = ctypes.POINTER(ctypes.c_ulonglong)  # a host array of device pointers
# library name -> {C entry point: argument types}; every entry returns
# the launch's cudaError_t as an int (0 on success), or a count where the
# comment says so (RESTYPES: the counts wider than an int)
BINDINGS = {
    "multimask_ratio": {"cms_multimask_ratio": [
        _P, _P, _P, _P,          # rf, fw, rf_m, fw_m
        _I, _I,                  # hp, wp
        _P, _P, _P,              # sel_off, sel_q, sel_f32
        _P, _I,                  # bin_off, n_bins
        _P, _P, _I, _I,          # mem_row, mem_tile, xy_shift, mirror
        _P, _P, _I]},            # out, stream, device
    "multimask_words": {"cms_multimask_words": [
        _P, _P, _I, _I,          # frames, flipped, hp, wp
        _P, _P,                  # sel_off, sel_q
        _P, _I,                  # bin_off, n_bins
        _P, _P, _I, _I,          # mem_row, mem_tile, xy_shift, mirror
        ctypes.POINTER(_I),      # triples: 6 x (Q, Rhi, Rlo), host ints
        _P, _P, _I]},            # out, stream, device
    "op_chain": {"cms_op_chain": [
        _I, _P, _P, _P,          # op case, x, y, out
        _I, _I, _P, _I],         # n elements, steps, stream, device
        "cms_op_chain_loop_steps": []},  # returns a count, not an error
    "prescreen_bound": {
        "cms_prescreen_cells": [
            _P, _I, _I, _I,      # words, n targets, h, w
            _I, _I,              # cell grid rows, cols
            ctypes.POINTER(ctypes.c_longlong),  # colbits: N_BINS host ints
            _I, ctypes.POINTER(_I),  # n offsets, (dx, dy) host ints
            _P, _P, _P, _I],     # bits, cnt, stream, device
        "cms_prescreen_capped": [
            _P, _P, _P, _P,      # seg_off, recs, rec_off, entries
            _I, _I,              # entries, B
            _I, _I, _I,          # mask group, band cells, bands
            _P, _P, _I, _I, _I,  # bits, cnt, variants, cells, targets
            _P, _P, _I]},        # out, stream, device
    "shape_score": {"cms_shape_rows": [
        _PTRS, _P, _I,           # plane pointers (host), their copy, targets
        _P, _P, _P, _P,          # q_nonzero, q_slice, q_mask, high_expr
        _I, _I, _I,              # band's first row, rows, w
        _I, _I,                  # mirror, flip_z
        _P, _P, _I]},            # out, stream, device
    "shape_planes": {
        "cms_dilate_plan": [
            _I, ctypes.POINTER(_I),  # footprint rows, their extents
            _I, _I, _I],         # frames, h, w (returns scratch words)
        "cms_dilate_rgb": [
            _P, _P, _I, _I,      # x, excluded, has_thr, thr
            _I, _I, _I,          # frames, h, w
            _I, ctypes.POINTER(_I),  # footprint rows, their extents
            _P, _P, _P, _I],     # out, scratch, stream, device
        "cms_query_planes": [
            _P, _P, _P, _P,      # rgb, excluded, d60, d20
            _P, _I, _I, _I, _I,  # slice table, its size, h, w, border
            _P, _P, _P, _P, _P,  # q_nonzero, q_slice, q_mask, high, row_any
            _P, _I],             # stream, device
        "cms_target_planes": [
            _P, _P, _I, _P,      # cdm, grad, grad_is_rgb, z-gap frames
            _P, _I, _P, _I,      # excluded, thr, slice table, its size
            _I, _I, _I,          # frames, h, w
            _PTRS, _P,           # output pointers (host), their copy
            _P, _I]},            # stream, device
    "target_pack": {"cms_target_pack": [
        _P, ctypes.c_longlong, _I,   # rgb, pixels, threshold
        _P, _P, _P, _I]},        # count, out, stream, device
    "launch_table": {
        "cms_launch_table_count": [
            _P, _I, _P, _P,      # extents, their columns, live_d, live_m
            _I, _I, _I, _I,      # targets, grid rows, cols, width
            _I, _I, _I,          # reach y, reach x, mirror
            _P, _I, _P, _P,      # rows, n rows, listed_off, listed_pos
            _P, _P, _P, _I],     # codes, counts, stream, device
        "cms_launch_table_write": [
            _P, _I, _P, _I,      # codes, grid positions, rows, n rows
            _P, _P, _P,          # listed, listed_off, listed_pos
            _P, _P, _P, _I]},    # row_off, tile_list, stream, device
    "row_reduce": {"cms_row_reduce": [
        _P, _I, _I,              # counts, n rows, variants a row
        _P, _P, _P, _I,          # eng, tgt, engine flags, targets
        _P, _P, _I]},            # out, stream, device
}
LIBRARIES = tuple(BINDINGS)
# entry points that return a count, not an error
RESTYPES = {"cms_dilate_plan": ctypes.c_longlong}


@dataclass
class KernelLibrary:
    name: str
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str        # nvcc's output (-Xptxas -v: registers, smem),
                          # kept beside the library for later loads


_locks = {name: threading.Lock() for name in LIBRARIES}
_loaded: Dict[str, KernelLibrary] = {}


def path_wrappers() -> Dict[str, object]:
    """{kernel: wrapper} of every kernel the production pipeline can
    launch: colorDepthSearch's target pack, exact kernels of both
    predicates, their launch table and their collect's reduction, the
    prescreen bound's two, and gradientScores' four (G1-G4). Each
    wrapper's `.launches` counts its kernel's launches in this process."""
    from . import (multimask, pixel_active, prescreen, shape_device,
                   shape_kernel)
    return {"target_pack": pixel_active.pack_words,
            "multimask_ratio": multimask.multimask_counts,
            "multimask_words": multimask.multimask_words_counts,
            "launch_table": multimask.launch_table,
            "row_reduce": multimask.row_reduce,
            "prescreen_cells": prescreen.prescreen_cells,
            "prescreen_capped": prescreen.prescreen_capped,
            "shape_rows": shape_kernel.shape_rows,
            "dilate_rgb": shape_device.dilate_rgb,
            "query_planes": shape_device.query_planes,
            "target_planes": shape_device.target_planes}


def launch_counts() -> Dict[str, int]:
    """{kernel: launches in this process} of path_wrappers()."""
    return {name: fn.launches for name, fn in path_wrappers().items()}


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
        if os.path.exists(path) and os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:
                log = f.read()
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
            with open(f"{tmp}.log", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.log", f"{path}.log")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in BINDINGS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(fn_name, ctypes.c_int)
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


# ---- reading the built code ------------------------------------------------

_SASS_INSN = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(\S[^;]*?)\s*;",
                        re.MULTILINE)
_SASS_BRA = re.compile(r"\bBRA\s+0x([0-9a-f]+)")


@dataclass
class SassLoop:
    start: int        # address of the branch target
    end: int          # address of the backward branch
    body: Counter     # mnemonic counts from start to end, guards dropped


def sass_loops(sass_text: str) -> Dict[str, List[SassLoop]]:
    """{function name: its loops} of a cuobjdump -sass listing: the body
    of every backward branch."""
    out: Dict[str, List[SassLoop]] = {}
    for func in sass_text.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        raw = _SASS_INSN.findall(func)
        insns = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t).split()[0])
                 for a, t in raw]
        loops = []
        for addr, text in raw:
            bra = _SASS_BRA.search(text)
            if bra and int(bra.group(1), 16) < int(addr, 16):
                lo, hi = int(bra.group(1), 16), int(addr, 16)
                loops.append(SassLoop(lo, hi, Counter(
                    m for a, m in insns if lo <= a <= hi)))
        out[name] = loops
    return out


def innermost_loops(loops: List[SassLoop]) -> List[SassLoop]:
    """The loops that hold no other loop."""
    return [lp for lp in loops if not any(
        lp.start <= o.start and o.end <= lp.end and o is not lp
        for o in loops)]


# Peak issue rates of one H100 SXM: 132 SMs at the 1.98 GHz boost clock
# (67 TFLOP/s of f32), in lane-instructions per SM per clock, from the
# CUDA C++ Programming Guide's arithmetic-instruction throughput table for
# compute capability 9.0: the four schedulers issue one warp instruction
# each (128); f32 add, multiply and fma and the packed 16-bit HFMA2, HMUL2
# and HADD2 (256 results) take the two FMA pipes (128); integer
# multiply-add (IMAD and its MOV/SHL/IADD forms) the heavy one of them
# (64); integer add, logic, shift, compare, min/max and select, and f32
# compare, the ALU pipe (64). Other instructions (memory, branches,
# uniform and warp ops) take an issue slot only.
H100_SM_CLOCKS = 132 * 1.98e9
PIPE_LANES = {"issue": 128, "fma": 128, "imad": 64, "alu": 64}
_FMA_OPS = frozenset(("FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2"))
_ALU_OPS = frozenset((
    "IADD3", "VIADD", "LOP3", "SHF", "LEA", "SEL", "ISETP", "FSETP", "PLOP3",
    "IMNMX", "VIMNMX", "VIMNMX3", "FMNMX", "PRMT", "MOV", "IABS", "FSEL",
    "P2R", "R2P"))


def pipe_counts(mix: Counter) -> Dict[str, int]:
    """The instructions of a mix that each pipe takes (the FMA pipes'
    count holds IMAD's too)."""
    by_op = Counter()
    for mnemonic, n in mix.items():
        by_op[mnemonic.split(".")[0]] += n
    imad = by_op["IMAD"]
    return {"issue": sum(by_op.values()),
            "fma": imad + sum(by_op[op] for op in _FMA_OPS),
            "imad": imad, "alu": sum(by_op[op] for op in _ALU_OPS)}


def issue_bound_s(mix: Counter, executions: float):
    """(seconds, pipe): the least time `executions` lane-executions of the
    instruction mix take on the card at the pipes' peak rates, and the
    busiest pipe, which sets it."""
    clocks = {p: n / PIPE_LANES[p] for p, n in pipe_counts(mix).items()}
    pipe = max(clocks, key=clocks.get)
    return executions * clocks[pipe] / H100_SM_CLOCKS, pipe
