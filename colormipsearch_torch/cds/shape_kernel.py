"""The shape/gradient scorer on the device: G1, a hand-written kernel.

Counterpart of `colormipsearch_tpu/cds/shape_kernel.py`, an XLA program
(no Pallas kernel) re-designing Shape2DMatchColorDepthSearchAlgorithm
(cds/Shape2DMatchColorDepthSearchAlgorithm.java:23-247): a match is two
elementwise passes and row sums over precomputed integer planes, the
query's planes once per mask and the target's once per target
(`shape_device.py`, or the host builds of `shape_oracle.py`).

`shape_rows` scores a list of targets' [H, W] planes, where they lie, in
the query's row band: CPU tensors run its plain version
(`shape_rows_plain`, the eager torch ops: stack, crop, score); CUDA
tensors launch `cms_shape_rows` (`csrc/shape_score.cu`, built at first
use) with a table of the planes' pointers, or raise. `shape_score_rows`
(stacked [T, R, W] planes) and `shape_score_stacked` keep the JAX
package's interfaces over it.

Mirror-pass equivalence (proof in shape_oracle.py): the mirrored
orientation only flips the gradient plane (gap sum) and the target plane
(high-expression sum), so both orientations run over the same query
planes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from . import kernels
from .multimask import _on_cuda
from .shape_device import QUERY_PLANE_DTYPES, TARGET_PLANE_DTYPES, grad_values

GAP_THRESHOLD = 3


def score_rows_plain(q_nonzero, q_slice, q_mask, high_expr,
                     grad, z_nonzero, z_slice, t_above, *,
                     mirror: bool, flip_z: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """Batched shape scores as eager torch ops: query planes [R, W],
    target planes [T, R, W], all on one device (counterpart of
    `shape_score_kernel`); with flip_z the z planes are read at column
    W-1-x (the ROI-mask path's mirrored-query pass).

    Returns per-ROW int32 sums [T, R] for (gaps_id, high_id, gaps_m,
    high_m). A per-pixel gap is at most max(slice gap 216, grad 65535),
    so a row sum fits int32 (1210 * 65535 < 2**31) but a whole-image sum
    may not; finish_shape_scores adds the rows in int64.
    """
    q_nonzero = q_nonzero.to(torch.bool)[None]
    q_slice = q_slice.to(torch.int32)[None]
    q_mask = q_mask.to(torch.bool)[None]
    high_expr = high_expr.to(torch.bool)[None]
    z_nonzero = z_nonzero.to(torch.bool)
    z_slice = z_slice.to(torch.int32)
    if flip_z:
        z_nonzero, z_slice = z_nonzero.flip(2), z_slice.flip(2)

    # calculateSliceGap (GradientAreaGapUtils.java:100-104): 0 where the
    # target has no slice, the target's slice where the query has none
    sg = (q_slice - z_slice).abs()
    sg = torch.where(q_slice == 0, z_slice, sg).masked_fill_(z_slice == 0, 0)
    # PIXEL_GAP_OP (Shape2DMatchColorDepthSearchAlgorithm.java:28-42):
    # both images present and slices >= 80 apart -> sg - 40, else
    # queryMask * grad; zeroed unless > GAP_THRESHOLD
    use_slice = q_nonzero & z_nonzero & (sg >= 80)
    slice_gap = sg - 40

    def gap_rows(grad_plane):
        gap = torch.where(use_slice, slice_gap,
                          grad_plane.masked_fill(~q_mask, 0))
        return gap.masked_fill_(gap <= GAP_THRESHOLD, 0).sum(
            dim=2, dtype=torch.int32)

    def high_rows(t_above_plane):
        return (high_expr & t_above_plane.to(torch.bool)).sum(
            dim=2, dtype=torch.int32)

    grad = grad_values(grad)
    gaps_id = gap_rows(grad)
    high_id = high_rows(t_above)
    if not mirror:
        return gaps_id, high_id, gaps_id, high_id
    return gaps_id, high_id, gap_rows(grad.flip(2)), high_rows(t_above.flip(2))


def shape_rows_plain(q_nonzero, q_slice, q_mask, high_expr,
                     t_above_list: Sequence[torch.Tensor],
                     grad_list: Sequence[torch.Tensor],
                     znz_list: Sequence[torch.Tensor],
                     zsl_list: Sequence[torch.Tensor],
                     *, r0: int, r1: int, mirror: bool, flip_z: bool = False):
    """G1's plain version: crop every plane to the row band [r0, r1),
    stack the targets' planes and score them with score_rows_plain."""

    def stack(planes):
        return torch.stack([p[r0:r1] for p in planes])

    return score_rows_plain(q_nonzero[r0:r1], q_slice[r0:r1],
                            q_mask[r0:r1], high_expr[r0:r1],
                            stack(grad_list), stack(znz_list),
                            stack(zsl_list), stack(t_above_list),
                            mirror=mirror, flip_z=flip_z)


def _check_plane(name, t, dtype, hw, device):
    """Raise unless t is a contiguous dtype plane of shape hw on device
    (one test first: a 128-target batch checks 512 planes per call)."""
    if t.dtype is dtype and t.shape == hw and t.is_contiguous() \
            and t.device == device:
        return
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(f"{name}: expected a {dtype} [H, W] plane, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    raise ValueError(f"{name}: a contiguous plane of the query's shape "
                     f"{tuple(hw)} expected, got {tuple(t.shape)} strides "
                     f"{t.stride()}")


TARGET_PLANE_NAMES = ("t_above", "grad", "z_nonzero", "z_slice")


class CheckedPlanes:
    """A target's four planes (TargetShapePlanes: t_above bool, grad
    int16, z_nonzero bool, z_slice int16), checked once, here: each a
    contiguous [H, W] tensor, all of one shape on one device. Holds their
    data pointers for G1's pointer table (`shape_rows_cached`) and keeps
    the tensors alive as long as the object lives, so a table built from
    it never names freed memory."""

    __slots__ = ("planes", "ptrs", "device", "shape")

    def __init__(self, planes):
        tensors = [getattr(planes, n) for n in TARGET_PLANE_NAMES]
        if tensors[0].dim() != 2:
            raise ValueError(f"t_above: expected an [H, W] plane, got "
                             f"{tuple(tensors[0].shape)}")
        hw, dev = tensors[0].shape, tensors[0].device
        for name, t, dt in zip(TARGET_PLANE_NAMES, tensors,
                               TARGET_PLANE_DTYPES):
            _check_plane(name, t, dt, hw, dev)
        self.planes = planes
        self.ptrs = np.array([t.data_ptr() for t in tensors],
                             dtype=np.uint64)
        self.device = dev
        self.shape = tuple(hw)


def _check_query(query, hw, dev, r0, r1):
    h, w = hw
    if not 0 <= r0 <= r1 <= h:
        raise ValueError(f"row band [{r0}, {r1}) outside {h} rows")
    for name, t, dt in zip(("q_nonzero", "q_slice", "q_mask", "high_expr"),
                           query, QUERY_PLANE_DTYPES):
        _check_plane(name, t, dt, hw, dev)


def _launch_rows(query, table: np.ndarray, n_t: int, r0: int, r1: int,
                 mirror: bool, flip_z: bool):
    """Launch `cms_shape_rows` over the checked query planes and a host
    table of 4 n_t plane pointers (uint64, each plane at row 0)."""
    dev = query[0].device
    w = query[0].shape[1]
    rows = r1 - r0
    out = torch.empty((4 if mirror else 2, n_t, rows), dtype=torch.int32,
                      device=dev)
    if n_t and rows:
        lib = kernels.load_library("shape_score").lib
        dev_table = torch.empty(4 * n_t, dtype=torch.int64, device=dev)
        rc = lib.cms_shape_rows(
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_ulonglong)),
            dev_table.data_ptr(), n_t, *(t.data_ptr() for t in query), r0,
            rows, w, int(mirror), int(flip_z), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if rc != 0:
            raise RuntimeError(f"shape_rows kernel launch failed: "
                               f"cudaError {rc}")
        shape_rows.launches += 1
    if not mirror:
        return out[0], out[1], out[0], out[1]
    return out[0], out[1], out[2], out[3]


def shape_rows(q_nonzero, q_slice, q_mask, high_expr,
               t_above_list: Sequence[torch.Tensor],
               grad_list: Sequence[torch.Tensor],
               znz_list: Sequence[torch.Tensor],
               zsl_list: Sequence[torch.Tensor],
               *, r0: int, r1: int, mirror: bool, flip_z: bool = False):
    """G1: the int32 row sums [T, r1 - r0] (gaps_id, high_id, gaps_m,
    high_m) of the query's planes [H, W] against each target's four
    planes (contiguous, of the query's shape), in the row band [r0, r1).
    CPU tensors run shape_rows_plain; CUDA tensors launch
    `cms_shape_rows` on their device, reading each target's planes where
    they lie, or raise. Without mirror the mirrored sums are the direct
    ones. Every plane is checked on every call; `shape_rows_cached` takes
    planes checked once."""
    lists = (t_above_list, grad_list, znz_list, zsl_list)
    n_t = len(t_above_list)
    if any(len(x) != n_t for x in lists):
        raise ValueError("the four target plane lists differ in length")
    query = (q_nonzero, q_slice, q_mask, high_expr)
    if not _on_cuda([*query, *(p for x in lists for p in x)]):
        return shape_rows_plain(*query, *lists, r0=r0, r1=r1, mirror=mirror,
                                flip_z=flip_z)
    dev = q_nonzero.device
    hw = q_nonzero.shape
    _check_query(query, hw, dev, r0, r1)
    ptrs = []
    for planes in zip(*lists):
        for name, t, dt in zip(TARGET_PLANE_NAMES, planes,
                               TARGET_PLANE_DTYPES):
            _check_plane(name, t, dt, hw, dev)
            ptrs.append(t.data_ptr())
    return _launch_rows(query, np.array(ptrs, dtype=np.uint64), n_t, r0,
                        r1, mirror, flip_z)


shape_rows.launches = 0


def shape_rows_cached(q_nonzero, q_slice, q_mask, high_expr,
                      targets: Sequence[CheckedPlanes], *, r0: int, r1: int,
                      mirror: bool, flip_z: bool = False):
    """shape_rows over targets whose planes were checked once
    (CheckedPlanes, as the plane cache holds them): on a card the
    pointer table is the targets' cached pointers, so a call checks the
    query's four planes and each target's device and shape, not its 512
    planes. CPU planes run shape_rows_plain. Counted as shape_rows'
    launches."""
    query = (q_nonzero, q_slice, q_mask, high_expr)
    if not _on_cuda(query):
        if any(t.device.type != "cpu" for t in targets):
            raise ValueError("CPU query planes against CUDA target planes")
        lists = [[getattr(t.planes, n) for t in targets]
                 for n in TARGET_PLANE_NAMES]
        return shape_rows_plain(*query, *lists, r0=r0, r1=r1, mirror=mirror,
                                flip_z=flip_z)
    dev = q_nonzero.device
    hw = tuple(q_nonzero.shape)
    _check_query(query, q_nonzero.shape, dev, r0, r1)
    for t in targets:
        if t.device != dev or t.shape != hw:
            raise ValueError(f"target planes {t.shape} on {t.device}: "
                             f"expected {hw} on {dev}")
    table = (np.concatenate([t.ptrs for t in targets]) if targets
             else np.zeros(0, dtype=np.uint64))
    return _launch_rows(query, table, len(targets), r0, r1, mirror, flip_z)


def shape_score_rows(q_nonzero, q_slice, q_mask, high_expr,
                     grad, z_nonzero, z_slice, t_above, *,
                     mirror: bool) -> Tuple[torch.Tensor, ...]:
    """Batched shape scores: query planes [R, W], target planes
    [T, R, W], all on one device (counterpart of `shape_score_kernel`):
    score_rows_plain on the CPU, G1 over the stack's [R, W] slices on a
    card. Returns per-ROW int32 sums [T, R] for (gaps_id, high_id,
    gaps_m, high_m)."""
    stacked = (t_above, grad, z_nonzero, z_slice)
    if not _on_cuda([q_nonzero, q_slice, q_mask, high_expr, *stacked]):
        return score_rows_plain(q_nonzero, q_slice, q_mask, high_expr,
                                grad, z_nonzero, z_slice, t_above,
                                mirror=mirror)
    return shape_rows(q_nonzero, q_slice, q_mask, high_expr,
                      *(list(x.unbind(0)) for x in stacked),
                      r0=0, r1=q_nonzero.shape[0], mirror=mirror)


def shape_score_stacked(q_nonzero, q_slice, q_mask, high_expr,
                        t_above_list: Sequence[torch.Tensor],
                        grad_list: Sequence[torch.Tensor],
                        znz_list: Sequence[torch.Tensor],
                        zsl_list: Sequence[torch.Tensor],
                        *, r0: int, r1: int, mirror: bool):
    """Score the targets' [H, W] planes in the query's active row band
    [r0, r1) (counterpart of `shape_score_stacked`): shape_rows."""
    return shape_rows(q_nonzero, q_slice, q_mask, high_expr, t_above_list,
                      grad_list, znz_list, zsl_list, r0=r0, r1=r1,
                      mirror=mirror)


def finish_shape_scores(gaps_id, high_id, gaps_m, high_m, mirror: bool):
    """Row totals in int64 and the orientation choice
    (Shape2DMatchColorDepthSearchAlgorithm.java:171-185: keep the mirrored
    result only when its combined score is strictly lower). Takes the
    row sums as tensors on any device (or arrays); returns NumPy int64
    (gaps, high, score) and bool use_m, each [T]."""
    rows = [torch.as_tensor(x) for x in (gaps_id, high_id, gaps_m, high_m)]
    totals = torch.stack([x.to(torch.int64).sum(dim=1) for x in rows])
    with trace.span("ga.wait"):
        totals = totals.cpu().numpy()
    gaps_id, high_id, gaps_m, high_m = totals
    score_id = gaps_id + high_id // 3
    if not mirror:
        return gaps_id, high_id, score_id, np.zeros(len(gaps_id), dtype=bool)
    score_m = gaps_m + high_m // 3
    use_m = score_m < score_id
    gaps = np.where(use_m, gaps_m, gaps_id)
    high = np.where(use_m, high_m, high_id)
    score = np.where(use_m, score_m, score_id)
    return gaps, high, score, use_m
