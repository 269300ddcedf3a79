"""Multi-process execution over torch.distributed.

Counterpart of `colormipsearch_tpu/parallel/multihost.py` (:34-112). The
reference scales across machines with LSF job arrays and shared Mongo
state (submitCDSBatch.sh:10-36); the JAX package keeps that restartable
block model (`distributed.block_for_process`, the CLI's
--process-id/--process-count) and adds one sweep over every process's
devices through `jax.distributed`. Here the processes join a
`torch.distributed` group with the gloo backend: every collective on
these paths moves results that are already on the host, and gloo, unlike
NCCL, lets two processes share one card.

Usage (one command per process, mirroring a job array):

    CMS_COORDINATOR=host0:8476 CMS_NUM_PROCESSES=4 CMS_PROCESS_ID=$i \\
        python -m colormipsearch_torch colorDepthSearch ... --jax-distributed

maybe_init_distributed() is a no-op for single-process runs, so the same
CLI works standalone. A group of several processes without a coordinator,
or one that does not form within its timeout, raises: the run never
carries on as one process.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import PairMesh, grid_of

LOG = logging.getLogger(__name__)

# seconds a process waits for the others to join the group (and for any
# collective afterwards)
INIT_TIMEOUT_S = 300.0


def maybe_init_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: Optional[float] = None) -> bool:
    """Join a gloo process group from args or CMS_* env vars.

    Returns True when a multi-process group is active. Safe to call
    repeatedly; single-process (or unset) configurations are a no-op.
    Env vars: CMS_COORDINATOR (host:port of process 0),
    CMS_NUM_PROCESSES, CMS_PROCESS_ID (mirroring LSB_JOBINDEX-style
    job-array variables, submitCDSJob.sh:58-66). Raises when several
    processes are asked for without a coordinator, and when the group
    does not form within timeout_s (default INIT_TIMEOUT_S)."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("CMS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("CMS_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("CMS_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    if not coordinator:
        raise RuntimeError(f"CMS_NUM_PROCESSES={num_processes} but no "
                           f"coordinator: set CMS_COORDINATOR=host:port "
                           f"(process 0's address)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s
                                              or INIT_TIMEOUT_S))
    LOG.info("torch.distributed (gloo): process %d/%d", process_id,
             num_processes)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_block(n_items: int) -> tuple:
    """This process's contiguous block of a work list (the job-array
    offset semantics, submitCDSBatch.sh:19-33) based on CMS_PROCESS_*
    env vars. Returns (start, stop)."""
    num = int(os.environ.get("CMS_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("CMS_PROCESS_ID", "0"))
    per = -(-n_items // num)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def process_allgather(arrays):
    """Every process's copy of a NumPy array (or of each array of a tuple),
    stacked along a new leading process axis: the counterpart of
    `multihost_utils.process_allgather(x)` for host results. Each array
    must have the same shape and dtype on every process."""
    single = not isinstance(arrays, (tuple, list))
    arrays = (arrays,) if single else tuple(arrays)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if process_count() == 1:
            out.append(a[None])
            continue
        # gloo has no bool type
        t = torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a)
        bufs = [torch.empty_like(t) for _ in range(process_count())]
        dist.all_gather(bufs, t)
        got = torch.stack(bufs).numpy()
        out.append(got.view(bool) if a.dtype == bool else got)
    return out[0] if single else tuple(out)


def gather_objects(obj) -> list:
    """[obj of process 0, obj of process 1, ...] on every process."""
    if process_count() == 1:
        return [obj]
    got = [None] * process_count()
    dist.all_gather_object(got, obj)
    return got


def global_pair_mesh(devices: Sequence,
                     mask_shards: Optional[int] = None) -> PairMesh:
    """Global ("mask", "target") mesh over every process's devices
    (`devices`: this process's own; every process calls this).

    With N global devices, defaults to the most-square factorization
    with target-major ordering. Single-process callers get the same mesh
    over their devices: identical code path either way."""
    local = [str(torch.device(d)) for d in devices]
    per_process = gather_objects(local)
    flat = [(r, torch.device(d)) for r, devs in enumerate(per_process)
            for d in devs]
    n = len(flat)
    if mask_shards is None:
        mask_shards = 1
        for m in range(int(np.sqrt(n)), 0, -1):
            if n % m == 0:
                mask_shards = m
                break
    if n % mask_shards:
        raise ValueError(f"{n} devices do not split into {mask_shards} "
                         f"mask shards")
    shape = (mask_shards, n // mask_shards)
    grid = grid_of([d for _, d in flat], shape)
    if len(per_process) == 1:
        return PairMesh(grid)
    return PairMesh(grid, np.array([r for r, _ in flat]).reshape(shape))


@dataclass
class Sharded:
    """This process's blocks of an array placed on a mesh:
    {(mask block, target block): tensor on that entry's device}."""
    shards: dict

    def map(self, fn) -> "Sharded":
        """fn applied to every block, on its device."""
        return Sharded({p: fn(t) for p, t in self.shards.items()})


def distribute(mesh: PairMesh, spec: Sequence, arr) -> Sharded:
    """Place a full array, available on every process, on the mesh: each
    entry this process owns gets its block on its device. spec names the
    mesh axis each leading dimension is split over ("mask", "target") or
    None (whole); () replicates. This is how pair-sweep inputs cross the
    process boundary, as the JAX package's distribute (a NumPy array or
    a tensor). A dimension split over an axis is cut into balanced
    contiguous blocks (`device_blocks`), so it need not divide evenly:
    the JAX package pads to one static shape, eager torch ops need none."""
    from .twophase_sweep import device_blocks
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    n_blocks = mesh.shape
    shards = {}
    for pos in mesh.local_positions(process_index()):
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            k = pos[mesh.axis_names.index(axis)]
            off, ln = device_blocks(arr.shape[dim], n_blocks[axis])[k]
            index.append(slice(off, off + ln))
        shards[pos] = arr[tuple(index)].contiguous().to(mesh.devices[pos])
    return Sharded(shards)
