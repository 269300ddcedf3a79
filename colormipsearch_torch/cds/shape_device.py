"""Target and query shape planes as torch ops on the device.

Counterpart of `colormipsearch_tpu/cds/shape_device.py`, whose plane
builds are XLA programs (no Pallas kernel): raw u8 frames upload once
per target (or mask) and eager torch ops derive the planes that
`shape_kernel.shape_score_rows` consumes. All of it is integer-exact:

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

import numpy as np
import torch
import torch.nn.functional as F

from ..imageproc.filters import make_line_radii
from .lut import slice_number_table
from .shape_oracle import QueryShapePlanes

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


def dilate_rgb(x_u8: torch.Tensor, radius: float) -> torch.Tensor:
    """Circular-footprint dilation of u8 [T, H, W, 3], borders clip to 0
    (counterpart of `_dilate_rgb`)."""
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


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray) and x.dtype == np.uint16:
        x = x.view(np.int16)    # the bits; grad_values widens them
    return torch.as_tensor(x, device=device)


def build_target_planes(cdm, grad, zgap, excluded, *, thr: int,
                        zgap_mode: str, grad_is_rgb: bool, device):
    """All four target shape planes of a batch, on `device` (counterpart
    of `_build_target_planes_jit`).

    cdm      u8 [T, H, W, 3] raw target CDM frames
    grad     16-bit gray [T, H, W] (uint16 array, or int16 bits) or u8
             [T, H, W, 3] (RGB gradient, grad_is_rgb)
    zgap     u8 [T, H, W, 3] precomputed z-gap frames (zgap_mode
             "file") or None (zgap_mode "otf": derived from the CDM by
             the production 10 px dilation recipe)
    excluded bool [H, W] label-region mask or None

    Arrays are uploaded to `device`. Returns (t_above bool, grad int16,
    z_nonzero bool, z_slice int16), each [T, H, W]: the planes of
    shape_oracle.build_target_shape_planes.
    """
    build_target_planes.calls += 1
    cdm = _as_tensor(cdm, device)
    if excluded is not None:
        t_clear = cdm.masked_fill(
            _as_tensor(excluded, device)[None, :, :, None], 0)
    else:
        t_clear = cdm
    t_above = above(t_clear, thr).any(dim=-1)

    grad = _as_tensor(grad, device)
    if grad_is_rgb:
        grad = gray_no_gamma_exact(grad.to(torch.int32)).to(torch.int16)
    elif grad.dtype != torch.int16:
        raise ValueError(f"a gray gradient must be a uint16 array or an "
                         f"int16 tensor of its bits, not {grad.dtype}")

    if zgap_mode == "file":
        z_rgb = _as_tensor(zgap, device)
    elif zgap_mode == "otf":
        # compute_zgap_image: clearRegions -> maskRGB(thr) -> dilate(10)
        z_rgb = dilate_rgb(t_clear.masked_fill(~t_above[..., None], 0), 10.0)
    else:
        raise ValueError(f"unknown zgap_mode {zgap_mode!r}")

    # targetZGapMaskImage = zgap masked at queryThreshold
    # (Shape2DMatchColorDepthSearchAlgorithm.java:161)
    z_nonzero = above(z_rgb, thr).any(dim=-1)
    z_slice = slice_plane(z_rgb).masked_fill_(~z_nonzero, 0)
    return t_above, grad, z_nonzero, z_slice


build_target_planes.calls = 0


def build_query_planes(rgb, excluded=None, border: int = 0, *,
                       device) -> QueryShapePlanes:
    """The per-mask QUERY shape planes on `device` (counterpart of
    `build_query_planes_device`; ColorDepthSearchAlgorithmProviderFactory
    .java:96-121):
      cleared   = clearRegions(query)
      high_expr = signal0(gray16(where(dilate20 != 0, black, dilate60)))
      q_mask    = signal2(gray16(cleared))
      q_nonzero = any-channel > 0; q_slice = depth-slice LUT
    then the border frame on q_nonzero and q_mask. The planes stay on the
    device; only the [H] active-rows vector comes to the host. ROI-mask
    runs keep the host path (`shape_oracle`)."""
    build_query_planes.calls += 1
    rgb = _as_tensor(rgb, device)
    if excluded is not None:
        rgb = rgb.masked_fill(_as_tensor(excluded, device)[:, :, None], 0)
    d60 = dilate_rgb(rgb[None], 60.0)[0]
    d20 = dilate_rgb(rgb[None], 20.0)[0]
    hem = d60.masked_fill((d20 > 0).any(dim=-1)[..., None], 0)
    high_expr = gray_no_gamma_exact(hem.to(torch.int32)) > 0
    rgb_i = rgb.to(torch.int32)
    q_mask = gray_no_gamma_exact(rgb_i) > 2
    q_nonzero = (rgb > 0).any(dim=-1)
    q_slice = slice_plane(rgb)
    if border > 0:
        h, w = q_nonzero.shape
        frame = torch.zeros((h, w), dtype=torch.bool, device=rgb.device)
        frame[border:h - border, border:w - border] = True
        q_nonzero = q_nonzero & frame
        q_mask = q_mask & frame
    row_any = q_nonzero.any(dim=1) | high_expr.any(dim=1)
    return QueryShapePlanes(
        q_nonzero=q_nonzero, q_slice=q_slice, q_mask=q_mask,
        high_expr=high_expr, height=int(rgb.shape[0]),
        width=int(rgb.shape[1]), row_any=row_any.cpu().numpy())


build_query_planes.calls = 0
