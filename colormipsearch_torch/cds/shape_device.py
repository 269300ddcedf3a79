"""Target and query shape planes on the device: G2, G3 and G4, three
hand-written kernels.

Counterpart of `colormipsearch_tpu/cds/shape_device.py`, whose plane
builds are XLA programs (no Pallas kernel): raw u8 frames upload once
per target (or mask) and the device derives the planes that
`shape_kernel.shape_rows` consumes. Each kernel has its wrapper and its
plain version (the eager torch ops) here: CPU tensors run the plain
version, CUDA tensors launch the kernel (`csrc/shape_planes.cu`, built at
first use) or raise.

- `dilate_rgb` (G2; plain `dilate_rgb_plain`): the circular makeLineRadii
  dilation, on the fly of the cleared (and, for the z-gap, masked) frame;
- `query_planes` (G3; plain `query_planes_plain`): the query's planes from
  its frame and its two dilations;
- `target_planes` (G4; plain `target_planes_plain`): a batch's target
  planes, each target's four in tensors of their own.

All of it is integer-exact:

- plane algebra: Shape2DMatchColorDepthSearchAlgorithm.java:150-161
  (target CDM above-threshold plane, z-gap masking at queryThreshold);
- slice numbers: GradientAreaGapUtils.java:107-197 via the precomputed
  6x256x256 table (`cds/lut.py`), uploaded once per device, as a gather
  whose index is clamped (the reference's `jnp.take(mode="clip")`; an
  index out of range is a device assert on CUDA);
- gray conversion of RGB images: ColorTransformation.java:40-54 as
  floor((2(r+g+b) + 3) / 6) (proof at `gray_no_gamma_exact`);
- dilations: the circular makeLineRadii footprint
  (ImageTransformation.java:549-572) as, per distinct row half-extent e,
  a horizontal running max of width 2e+1, then the max of those maxima
  shifted by each row offset of extent e: identical to the dense
  footprint max because every footprint row is an interval [-e, e]. The
  running maxima stay in uint8 (windows of 2**j by doubling, each window
  the max of two overlapping ones), so no op needs a type the card
  lacks for uint8.

Plane dtypes (values equal the JAX planes; dtypes may differ): t_above,
z_nonzero, q_nonzero, q_mask and high_expr are bool; grad is int16
holding the bits of the uint16 gradient (0..65535; `grad_values` widens
it); z_slice and q_slice are int16 (0..256).
"""

from __future__ import annotations

import ctypes
import re
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..imageproc.filters import make_line_radii
from ..utils import trace
from . import kernels
from .lut import slice_number_table
from .multimask import _check, _on_cuda
from .shape_oracle import QueryShapePlanes

# the largest footprint half-height G2 takes (csrc/shape_planes.cu MAX_K)
MAX_DILATION_K = 63
# the planes' dtypes: query (q_nonzero, q_slice, q_mask, high_expr) and
# target (t_above, grad, z_nonzero, z_slice)
QUERY_PLANE_DTYPES = (torch.bool, torch.int16, torch.bool, torch.bool)
TARGET_PLANE_DTYPES = (torch.bool, torch.int16, torch.bool, torch.int16)

_SLICE_TABLES: dict = {}


def slice_table(device) -> torch.Tensor:
    """The flat int16 [6*256*256] slice table on `device`, uploaded once
    per device."""
    device = torch.device(device)
    table = _SLICE_TABLES.get(device)
    if table is None:
        table = torch.from_numpy(
            np.ascontiguousarray(slice_number_table().reshape(-1))).to(device)
        _SLICE_TABLES[device] = table
    return table


def classify_index(rgb_i32: torch.Tensor) -> torch.Tensor:
    """Flat (order, max, second) table index per pixel of int32 [..., 3].

    Classification replicates the reference's >=-comparison branch order
    (GradientAreaGapUtils.java:31-93): R-max checked first, then G,
    then B; within each branch the second channel by >=.
    """
    r, g, b = rgb_i32.unbind(-1)
    r_branch = (r >= g) & (r >= b)
    g_branch = ~r_branch & (g >= r) & (g >= b)
    ge_gb = g >= b
    ge_rb = r >= b
    ge_rg = r >= g
    # order ids match cds/lut.py: 0:(R,G) 1:(R,B) 2:(G,R) 3:(G,B)
    # 4:(B,R) 5:(B,G)
    order = torch.where(
        r_branch, (~ge_gb).int(),
        torch.where(g_branch, 2 + (~ge_rb).int(), 4 + (~ge_rg).int()))
    maxv = torch.where(r_branch, r, torch.where(g_branch, g, b))
    secv = torch.where(r_branch, torch.where(ge_gb, g, b),
                       torch.where(g_branch, torch.where(ge_rb, r, b),
                                   torch.where(ge_rg, r, g)))
    return (order * 256 + maxv) * 256 + secv


def slice_plane(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Per-pixel depth-slice numbers, int16 [...], of RGB u8 [..., 3]."""
    table = slice_table(rgb_u8.device)
    idx = classify_index(rgb_u8.to(torch.int32))
    return table[idx.clamp_(0, table.numel() - 1)]


def gray_no_gamma_exact(rgb_i32: torch.Tensor) -> torch.Tensor:
    """rgbToGrayNoGammaCorrection (ColorTransformation.java:40-54) as
    exact integer arithmetic, int32 [...] of int32 [..., 3].

    Java computes floor(r/3 + g/3 + b/3 + 0.5) in double with
    maxGray=255 (scale exactly 1.0). The true rational value
    (r+g+b)/3 + 1/2 is NEVER an integer: (r+g+b)/3 + 1/2 = m would
    need 2(r+g+b) + 3 = 6m, impossible by parity (LHS odd, RHS even).
    The nearest integer is therefore at distance >= 1/6, while the
    double rounding error of the Java expression is < 1e-12 — so
    floor((2(r+g+b) + 3) / 6) is bit-identical to the reference for
    every u8 triple.
    """
    s = rgb_i32.sum(dim=-1, dtype=torch.int32)
    return torch.div(2 * s + 3, 6, rounding_mode="floor")


def grad_values(grad: torch.Tensor) -> torch.Tensor:
    """The gradient plane's values as int32 (int16 planes hold the bits
    of a uint16)."""
    if grad.dtype == torch.int16:
        return grad.to(torch.int32) & 0xFFFF
    return grad.to(torch.int32)


def above(x_u8: torch.Tensor, thr: int) -> torch.Tensor:
    """x > thr for a uint8 tensor and any integer threshold (a Python
    scalar outside 0..255 would wrap to the tensor's type)."""
    if thr >= 255:
        return torch.zeros_like(x_u8, dtype=torch.bool)
    if thr < 0:
        return torch.ones_like(x_u8, dtype=torch.bool)
    return x_u8 > thr


def dilate_rgb_plain(x_u8: torch.Tensor, radius: float) -> torch.Tensor:
    """Circular-footprint dilation of u8 [T, H, W, 3], borders clip to 0
    (counterpart of `_dilate_rgb`), as eager torch ops: G2's plain
    version."""
    dxs = make_line_radii(radius)
    k_radius = (len(dxs) - 1) // 2
    by_extent: dict = {}
    for row, dx in enumerate(dxs):
        by_extent.setdefault(int(dx), []).append(row - k_radius)
    h, w = x_u8.shape[1], x_u8.shape[2]
    pad = max(by_extent)
    # levels[j][:, :, i] = max of the padded row over [i, i + 2**j)
    levels = [F.pad(x_u8, (0, 0, pad, pad))]
    out = torch.zeros_like(x_u8)
    for extent, offsets in sorted(by_extent.items()):
        n = 2 * extent + 1
        j = n.bit_length() - 1
        while len(levels) <= j:
            prev, step = levels[-1], 1 << (len(levels) - 1)
            length = prev.shape[2] - step
            levels.append(torch.maximum(prev[:, :, :length],
                                        prev[:, :, step:step + length]))
        # window [x - e, x + e] of output x starts at padded x + pad - e
        a, b = pad - extent, pad - extent + n - (1 << j)
        hmax = torch.maximum(levels[j][:, :, a:a + w],
                             levels[j][:, :, b:b + w])
        for off in offsets:
            if abs(off) >= h:
                continue
            # out[y] takes hmax[y + off]
            if off >= 0:
                dst, src = out[:, :h - off], hmax[:, off:]
            else:
                dst, src = out[:, -off:], hmax[:, :h + off]
            torch.maximum(dst, src, out=dst)
    return out


def dilate_input_plain(x_u8: torch.Tensor, excluded=None,
                       thr: Optional[int] = None) -> torch.Tensor:
    """The frames G2 dilates: x with the excluded pixels (bool [H, W]) set
    to 0 (clearRegions) and, with thr, the pixels with no channel above
    thr too (maskRGB)."""
    if excluded is not None:
        x_u8 = x_u8.masked_fill(excluded[None, :, :, None], 0)
    if thr is not None:
        x_u8 = x_u8.masked_fill(~above(x_u8, thr).any(dim=-1)[..., None], 0)
    return x_u8


def compiled_footprints() -> dict:
    """{radius: extents} of the footprints compiled into G2's kernel (the
    EXT_R<r> tables of csrc/shape_planes.cu, read from the source): the
    radii the system dilates with. A footprint equal to one of them runs
    the compiled kernel, any other the generic one."""
    with open(kernels.source_path("shape_planes")) as f:
        src = f.read()
    return {float(r): tuple(int(v) for v in body.replace(",", " ").split())
            for r, body in re.findall(
                r"constexpr int EXT_R(\d+)\[\d+\] = \{([^}]*)\}", src)}


def dilate_rgb(x_u8: torch.Tensor, radius: float, *, excluded=None,
               thr: Optional[int] = None) -> torch.Tensor:
    """G2: the circular-footprint dilation of u8 [T, H, W, 3] (borders
    clip to 0) of dilate_input_plain(x_u8, excluded, thr). CPU tensors run
    the plain versions; CUDA tensors launch `cms_dilate_rgb`, which clears
    and masks its input as it reads it, or raise."""
    tensors = [x_u8] + ([excluded] if excluded is not None else [])
    if not _on_cuda(tensors):
        return dilate_rgb_plain(dilate_input_plain(x_u8, excluded, thr),
                                radius)
    dev = x_u8.device
    _check("x", x_u8, torch.uint8, 4, dev)
    n_t, h, w, c = x_u8.shape
    if c != 3:
        raise ValueError(f"x: expected RGB frames [T, H, W, 3], got "
                         f"{tuple(x_u8.shape)}")
    if excluded is not None:
        _check("excluded", excluded, torch.bool, 2, dev)
        if tuple(excluded.shape) != (h, w):
            raise ValueError(f"excluded {tuple(excluded.shape)} does not "
                             f"match the frames' {h}x{w}")
    ext = [int(e) for e in make_line_radii(radius)]
    if len(ext) > 2 * MAX_DILATION_K + 1:
        raise ValueError(f"radius {radius}: a footprint of {len(ext)} rows, "
                         f"more than the kernel's {2 * MAX_DILATION_K + 1}")
    out = torch.empty_like(x_u8)
    if out.numel() == 0:
        return out
    if x_u8.data_ptr() % 16:
        x_u8 = x_u8.clone()  # the kernel reads the frames as aligned words
    lib = kernels.load_library("shape_planes").lib
    ext_c = (ctypes.c_int * len(ext))(*ext)
    words = lib.cms_dilate_plan(len(ext), ext_c, n_t, h, w)
    scratch = (torch.empty(words, dtype=torch.int32, device=dev)
               if words > 0 else None)
    rc = lib.cms_dilate_rgb(
        x_u8.data_ptr(), excluded.data_ptr() if excluded is not None
        else None, int(thr is not None), _clamp_thr(thr or 0), n_t, h, w,
        len(ext), ext_c, out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"dilate_rgb kernel launch failed: cudaError {rc}")
    dilate_rgb.launches += 1
    return out


dilate_rgb.launches = 0


def _clamp_thr(thr: int) -> int:
    """A threshold clamped to -1..255: a u8 channel compares against it
    as against the unclamped one (and it fits a C int)."""
    return max(-1, min(int(thr), 255))


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray) and x.dtype == np.uint16:
        x = x.view(np.int16)    # the bits; grad_values widens them
    return torch.as_tensor(x, device=device).contiguous()


def target_planes_plain(cdm, grad, z_rgb, excluded, *, thr: int,
                        grad_is_rgb: bool):
    """G4's plain version: the four target planes of a batch, [T, H, W]
    each (t_above bool, grad int16, z_nonzero bool, z_slice int16), from
    the CDM frames u8 [T, H, W, 3], the gradient (int16 bits [T, H, W],
    or u8 [T, H, W, 3] with grad_is_rgb), the z-gap frames u8
    [T, H, W, 3] and the excluded mask (bool [H, W] or None)."""
    if excluded is not None:
        cdm = cdm.masked_fill(excluded[None, :, :, None], 0)
    t_above = above(cdm, thr).any(dim=-1)
    if grad_is_rgb:
        grad = gray_no_gamma_exact(grad.to(torch.int32)).to(torch.int16)
    # targetZGapMaskImage = zgap masked at queryThreshold
    # (Shape2DMatchColorDepthSearchAlgorithm.java:161)
    z_nonzero = above(z_rgb, thr).any(dim=-1)
    z_slice = slice_plane(z_rgb).masked_fill_(~z_nonzero, 0)
    return t_above, grad, z_nonzero, z_slice


def target_planes(cdm, grad, z_rgb, excluded, *, thr: int,
                  grad_is_rgb: bool) -> List[Tuple[torch.Tensor, ...]]:
    """G4: each target's four planes (t_above, grad, z_nonzero, z_slice),
    [H, W] tensors of their own, of target_planes_plain. CPU tensors run
    the plain version (each target's planes copied out of the batch);
    CUDA tensors launch `cms_target_planes`, which writes every target's
    planes where a table of output pointers says, or raise."""
    tensors = [cdm, grad, z_rgb] + ([excluded] if excluded is not None
                                    else [])
    if not _on_cuda(tensors):
        planes = target_planes_plain(cdm, grad, z_rgb, excluded, thr=thr,
                                     grad_is_rgb=grad_is_rgb)
        return [tuple(p[j].clone() for p in planes)
                for j in range(cdm.shape[0])]
    dev = cdm.device
    _check("cdm", cdm, torch.uint8, 4, dev)
    _check("z_rgb", z_rgb, torch.uint8, 4, dev)
    if grad_is_rgb:
        _check("grad", grad, torch.uint8, 4, dev)
    else:
        _check("grad", grad, torch.int16, 3, dev)
    n_t, h, w, _ = cdm.shape
    rgb_shape = (n_t, h, w, 3)
    for name, t, want in (("cdm", cdm, rgb_shape), ("z_rgb", z_rgb, rgb_shape),
                          ("grad", grad, rgb_shape if grad_is_rgb
                           else rgb_shape[:3])):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)}: expected {want}")
    if excluded is not None:
        _check("excluded", excluded, torch.bool, 2, dev)
        if tuple(excluded.shape) != (h, w):
            raise ValueError(f"excluded {tuple(excluded.shape)} does not "
                             f"match the frames' {h}x{w}")
    out = [tuple(torch.empty((h, w), dtype=dt, device=dev)
                 for dt in TARGET_PLANE_DTYPES) for _ in range(n_t)]
    if n_t == 0 or h * w == 0:
        return out
    ptrs = [t.data_ptr() for planes in out for t in planes]
    table = slice_table(dev)
    scratch = torch.empty(len(ptrs), dtype=torch.int64, device=dev)
    lib = kernels.load_library("shape_planes").lib
    rc = lib.cms_target_planes(
        cdm.data_ptr(), grad.data_ptr(), int(grad_is_rgb), z_rgb.data_ptr(),
        excluded.data_ptr() if excluded is not None else None,
        _clamp_thr(thr), table.data_ptr(), table.numel(), n_t, h, w,
        (ctypes.c_ulonglong * len(ptrs))(*ptrs), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"target_planes kernel launch failed: "
                           f"cudaError {rc}")
    target_planes.launches += 1
    return out


target_planes.launches = 0


def build_target_plane_sets(cdm, grad, zgap, excluded, *, thr: int,
                            zgap_mode: str, grad_is_rgb: bool, device
                            ) -> List[Tuple[torch.Tensor, ...]]:
    """Every target's four shape planes, on `device`, each in tensors of
    its own (counterpart of `_build_target_planes_jit`):

    cdm      u8 [T, H, W, 3] raw target CDM frames
    grad     16-bit gray [T, H, W] (uint16 array, or int16 bits) or u8
             [T, H, W, 3] (RGB gradient, grad_is_rgb)
    zgap     u8 [T, H, W, 3] precomputed z-gap frames (zgap_mode
             "file") or None (zgap_mode "otf": derived from the CDM by
             the production 10 px dilation recipe, G2)
    excluded bool [H, W] label-region mask or None

    Arrays are uploaded to `device`. Returns [(t_above bool, grad int16,
    z_nonzero bool, z_slice int16)], each [H, W], one per target: the
    planes of shape_oracle.build_target_shape_planes (G4). The uploads
    are the span ga.upload.
    """
    if zgap_mode not in ("file", "otf"):
        raise ValueError(f"unknown zgap_mode {zgap_mode!r}")
    with trace.span("ga.upload"):
        cdm = _as_tensor(cdm, device)
        grad = _as_tensor(grad, device)
        ex = _as_tensor(excluded, device) if excluded is not None else None
        if zgap_mode == "file":
            z_rgb = _as_tensor(zgap, device)
    if not grad_is_rgb and grad.dtype != torch.int16:
        raise ValueError(f"a gray gradient must be a uint16 array or an "
                         f"int16 tensor of its bits, not {grad.dtype}")
    if zgap_mode == "otf":
        # compute_zgap_image: clearRegions -> maskRGB(thr) -> dilate(10)
        z_rgb = dilate_rgb(cdm, 10.0, excluded=ex, thr=thr)
    return target_planes(cdm, grad, z_rgb, ex, thr=thr,
                         grad_is_rgb=grad_is_rgb)


def build_target_planes(cdm, grad, zgap, excluded, *, thr: int,
                        zgap_mode: str, grad_is_rgb: bool, device):
    """All four target shape planes of a batch, on `device`, stacked
    (counterpart of `_build_target_planes_jit`; arguments as
    build_target_plane_sets). Returns (t_above bool, grad int16,
    z_nonzero bool, z_slice int16), each [T, H, W]."""
    sets = build_target_plane_sets(cdm, grad, zgap, excluded, thr=thr,
                                   zgap_mode=zgap_mode,
                                   grad_is_rgb=grad_is_rgb, device=device)
    if not sets:
        raise ValueError("no target frames")
    return tuple(torch.stack(p) for p in zip(*sets))


def query_planes_plain(rgb, excluded, d60, d20, border: int):
    """G3's plain version: (q_nonzero bool, q_slice int16, q_mask bool,
    high_expr bool, each [H, W]; row_any bool [H]) of the query frame u8
    [H, W, 3], its excluded mask (bool [H, W] or None) and the r = 60 and
    r = 20 dilations of its cleared frame."""
    if excluded is not None:
        rgb = rgb.masked_fill(excluded[:, :, None], 0)
    hem = d60.masked_fill((d20 > 0).any(dim=-1)[..., None], 0)
    high_expr = gray_no_gamma_exact(hem.to(torch.int32)) > 0
    q_mask = gray_no_gamma_exact(rgb.to(torch.int32)) > 2
    q_nonzero = (rgb > 0).any(dim=-1)
    q_slice = slice_plane(rgb)
    if border > 0:
        h, w = q_nonzero.shape
        frame = torch.zeros((h, w), dtype=torch.bool, device=rgb.device)
        frame[border:h - border, border:w - border] = True
        q_nonzero = q_nonzero & frame
        q_mask = q_mask & frame
    row_any = q_nonzero.any(dim=1) | high_expr.any(dim=1)
    return q_nonzero, q_slice, q_mask, high_expr, row_any


def query_planes(rgb, excluded, d60, d20, border: int):
    """G3: query_planes_plain's five planes. CPU tensors run the plain
    version; CUDA tensors launch `cms_query_planes` or raise."""
    tensors = [rgb, d60, d20] + ([excluded] if excluded is not None else [])
    if not _on_cuda(tensors):
        return query_planes_plain(rgb, excluded, d60, d20, border)
    dev = rgb.device
    for name, t in (("rgb", rgb), ("d60", d60), ("d20", d20)):
        _check(name, t, torch.uint8, 3, dev)
        if t.shape[2] != 3 or t.shape != rgb.shape:
            raise ValueError(f"{name}: expected u8 [H, W, 3] of the query's "
                             f"shape, got {tuple(t.shape)}")
    h, w, _ = rgb.shape
    if excluded is not None:
        _check("excluded", excluded, torch.bool, 2, dev)
        if tuple(excluded.shape) != (h, w):
            raise ValueError(f"excluded {tuple(excluded.shape)} does not "
                             f"match the query's {h}x{w}")
    q_nonzero, q_mask, high_expr = (
        torch.empty((h, w), dtype=torch.bool, device=dev) for _ in range(3))
    q_slice = torch.empty((h, w), dtype=torch.int16, device=dev)
    row_any = torch.empty(h, dtype=torch.bool, device=dev)
    if h * w == 0:
        return q_nonzero, q_slice, q_mask, high_expr, row_any.fill_(False)
    table = slice_table(dev)
    lib = kernels.load_library("shape_planes").lib
    rc = lib.cms_query_planes(
        rgb.data_ptr(), excluded.data_ptr() if excluded is not None
        else None, d60.data_ptr(), d20.data_ptr(), table.data_ptr(),
        table.numel(), h, w, int(border), q_nonzero.data_ptr(),
        q_slice.data_ptr(), q_mask.data_ptr(), high_expr.data_ptr(),
        row_any.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        dev.index)
    if rc != 0:
        raise RuntimeError(f"query_planes kernel launch failed: "
                           f"cudaError {rc}")
    query_planes.launches += 1
    return q_nonzero, q_slice, q_mask, high_expr, row_any


query_planes.launches = 0


def build_query_planes(rgb, excluded=None, border: int = 0, *,
                       device) -> QueryShapePlanes:
    """The per-mask QUERY shape planes on `device` (counterpart of
    `build_query_planes_device`; ColorDepthSearchAlgorithmProviderFactory
    .java:96-121):
      cleared   = clearRegions(query)
      high_expr = signal0(gray16(where(dilate20 != 0, black, dilate60)))
      q_mask    = signal2(gray16(cleared))
      q_nonzero = any-channel > 0; q_slice = depth-slice LUT
    then the border frame on q_nonzero and q_mask: two G2 dilations of
    the cleared frame, then G3. The planes stay on the device; only the
    [H] active-rows vector comes to the host (its wait is the span
    ga.wait). ROI-mask runs keep the host path (`shape_oracle`)."""
    rgb = _as_tensor(rgb, device)
    ex = _as_tensor(excluded, device) if excluded is not None else None
    d60 = dilate_rgb(rgb[None], 60.0, excluded=ex)[0]
    d20 = dilate_rgb(rgb[None], 20.0, excluded=ex)[0]
    q_nonzero, q_slice, q_mask, high_expr, row_any = query_planes(
        rgb, ex, d60, d20, border)
    with trace.span("ga.wait"):
        row_any = row_any.cpu().numpy()
    return QueryShapePlanes(
        q_nonzero=q_nonzero, q_slice=q_slice, q_mask=q_mask,
        high_expr=high_expr, height=int(rgb.shape[0]),
        width=int(rgb.shape[1]), row_any=row_any)
