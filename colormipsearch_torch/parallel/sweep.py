"""Mesh-sharded mask x target pair sweeps of the dense engine.

Counterpart of `colormipsearch_tpu/parallel/sweep.py` (:25-147). The
pair grid is block-partitioned over a ("mask", "target") mesh
(`mesh.PairMesh`): entry (i, j) scores mask block i against target
block j on its device. The JAX package runs the blocks as one shard_map
program with pmax/pmin collectives over the "target" axis; here, in one
process, the blocks are queued on their devices in turn and drained
together; over several processes, each process scores the entries it
owns (its target slab on a `global_pair_mesh`) and the blocks are
gathered on every process. Per-mask maxima (and the shape scores'
minimum) are taken over the whole target axis after the gather, which
is what the reference's cross-chip reductions compute.

Inputs are full arrays (NumPy or tensors), available on every process,
or `multihost.Sharded` blocks already placed by `multihost.distribute`;
results are NumPy arrays, the same on every process.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..cds.pixel_kernel import pixel_match_packed
from .mesh import PairMesh
from .multihost import Sharded, distribute, gather_objects, process_index

_MASKS = ("mask", None, None)
_TARGETS = ("target", None, None)


def local_pixel_sweep(q_words, t_padded, t_flipped, shifts, zt9: int,
                      mirror: bool):
    """Single-device pair block: scores [B, T], mirrored [B, T]."""
    return pixel_match_packed(q_words, t_padded, t_flipped, shifts,
                              zt9=zt9, mirror=mirror)


def _placed(mesh: PairMesh, spec, x) -> Sharded:
    return x if isinstance(x, Sharded) else distribute(mesh, spec, x)


def _run(mesh: PairMesh, block: Callable, rows=None) -> Dict:
    """block(position) -> tuple of device tensors, for every entry this
    process owns (in mesh rows `rows` only, when given): all queued
    before any is copied to the host. Returns {position: tuple of NumPy
    arrays} over every process's entries."""
    mine = [p for p in mesh.local_positions(process_index())
            if rows is None or p[0] in rows]
    pending = {p: block(p) for p in mine}
    host = {p: tuple(t.cpu().numpy() for t in out)
            for p, out in pending.items()}
    if mesh.ranks is None:
        return host
    merged = {}
    for got in gather_objects(host):
        merged.update(got)
    return merged


def _starts(blocks: Dict, k: int, a: int, ax: int) -> np.ndarray:
    """Where each block along mesh axis a begins on array axis ax of
    output k (the blocks' lengths may differ: `distribute` cuts balanced
    blocks); the last entry is the full length."""
    sizes = {pos[a]: arrs[k].shape[ax] for pos, arrs in blocks.items()}
    return np.cumsum([0] + [sizes[i] for i in range(len(sizes))])


def _assemble(blocks: Dict, k: int, axes: Dict[int, int]) -> np.ndarray:
    """Output k of every block placed in the full array: mesh axis a
    (0 "mask", 1 "target") splits array axis axes[a]."""
    some = next(iter(blocks.values()))[k]
    shape = list(some.shape)
    starts = {a: _starts(blocks, k, a, ax) for a, ax in axes.items()}
    for a, ax in axes.items():
        shape[ax] = starts[a][-1]
    out = np.zeros(shape, dtype=some.dtype)
    for pos, arrs in blocks.items():
        index = [slice(None)] * out.ndim
        for a, ax in axes.items():
            index[ax] = slice(starts[a][pos[a]], starts[a][pos[a] + 1])
        out[tuple(index)] = arrs[k]
    return out


_GRID = {0: 0, 1: 1}


def sharded_pixel_sweep(mesh: PairMesh, q_words, t_padded, t_flipped,
                        shifts, zt9: int, mirror: bool
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pair sweep sharded over the mesh.

    Args:
      q_words: [B, H, W] query planes, split over the mesh's "mask" axis
      t_padded/t_flipped: [T, Hp, Wp] target planes, split over its
        "target" axis
    Returns (scores [B, T] int32, mirrored [B, T] bool, per_mask_max [B]),
    the maximum over the whole target axis."""
    q = _placed(mesh, _MASKS, q_words)
    tp = _placed(mesh, _TARGETS, t_padded)
    tf = _placed(mesh, _TARGETS, t_flipped)
    blocks = _run(mesh, lambda p: pixel_match_packed(
        q.shards[p], tp.shards[p], tf.shards[p], shifts, zt9=zt9,
        mirror=mirror))
    scores = _assemble(blocks, 0, _GRID)
    return scores, _assemble(blocks, 1, _GRID), scores.max(axis=1)


def sharded_pixel_sweep_topk(mesh: PairMesh, q_words, t_padded, t_flipped,
                             shifts, zt9: int, mirror: bool, k: int):
    """Pair sweep returning per-mask top-k survivors instead of the full
    score grid: each entry keeps the top-k of its target block, so only
    B x k x target-blocks scores leave the devices, and merge_topk
    finishes the global top-k on the host. Ties keep the lower target
    index first, as lax.top_k.

    Returns (top_scores [B, P, k], top_target_idx [B, P, k], mirrored
    [B, P, k]) with P = number of target blocks, k capped at the largest
    block; indices refer to the full target axis. A block shorter than
    that fills its row with score -1 and index -1, which never outrank a
    target (the JAX package's equal blocks need no filling)."""
    q = _placed(mesh, _MASKS, q_words)
    tp = _placed(mesh, _TARGETS, t_padded)
    tf = _placed(mesh, _TARGETS, t_flipped)

    def block(pos):
        scores, mirrored = pixel_match_packed(
            q.shards[pos], tp.shards[pos], tf.shards[pos], shifts, zt9=zt9,
            mirror=mirror)
        kk = min(k, scores.shape[1])
        # a stable descending sort: equal scores keep index order
        idx = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :kk]
        top = torch.gather(scores, 1, idx)
        mtop = torch.gather(mirrored, 1, idx)
        # the block's own scores carry its length, for the offsets below
        return top[:, None], idx.to(torch.int32)[:, None], mtop[:, None], \
            scores[:1]

    blocks = _run(mesh, block)
    starts = _starts(blocks, 3, 1, 1)
    kk = max(b[0].shape[2] for b in blocks.values())

    def fill(x, v):
        return np.pad(x, ((0, 0), (0, 0), (0, kk - x.shape[2])),
                      constant_values=v)

    blocks = {p: (fill(top, -1), fill(idx + starts[p[1]], -1),
                  fill(mtop, False))
              for p, (top, idx, mtop, _) in blocks.items()}
    return tuple(_assemble(blocks, i, _GRID) for i in range(3))


def merge_topk(top_scores, top_idx, top_mirrored, k: int):
    """Host-side merge of per-shard top-k into the global per-mask top-k.
    Returns (scores [B, k], target_idx [B, k], mirrored [B, k])."""
    s = np.asarray(top_scores).reshape(top_scores.shape[0], -1)
    i = np.asarray(top_idx).reshape(s.shape)
    m = np.asarray(top_mirrored).reshape(s.shape)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    take = np.take_along_axis
    return take(s, order, 1), take(i, order, 1), take(m, order, 1)


def sharded_shape_scores(mesh: PairMesh, q_nonzero, q_slice, q_mask,
                         high_expr, grad, z_nonzero, z_slice, t_above,
                         mirror: bool):
    """Shape-score re-ranking sharded over the mesh's "target" axis.

    Query planes [H, W] are replicated; target planes [T, H, W] are split
    over the target axis (planes as `shape_kernel.shape_score_rows` takes
    them). Returns per-target (score [T] int64, mirrored [T] bool: the
    mirrored orientation only where its combined score is strictly
    lower) and the minimum combined score over all targets, [1]. The
    mask axis only replicates: its row 0 computes."""
    from ..cds.shape_kernel import shape_score_rows
    qp = [_placed(mesh, (), x) for x in (q_nonzero, q_slice, q_mask,
                                          high_expr)]
    tp = [_placed(mesh, _TARGETS, x) for x in (grad, z_nonzero, z_slice,
                                               t_above)]

    def block(pos):
        rows = shape_score_rows(*(x.shards[pos] for x in qp),
                                *(x.shards[pos] for x in tp), mirror=mirror)
        gaps_id, high_id, gaps_m, high_m = (r.to(torch.int64).sum(dim=1)
                                            for r in rows)
        score_id = gaps_id + high_id // 3
        score_m = gaps_m + high_m // 3
        use_m = (score_m < score_id) & mirror
        return torch.where(use_m, score_m, score_id), use_m

    blocks = _run(mesh, block, rows=(0,))
    score = _assemble(blocks, 0, {1: 0})
    return score, _assemble(blocks, 1, {1: 0}), score.min(keepdims=True)
