"""The ("mask", "target") grid of devices the pair sweeps shard over.

Counterpart of `colormipsearch_tpu/parallel/mesh.py` (:20-40). The
reference scales out by block-partitioning the pair grid over an LSF job
array (scripts/submitCDSBatch.sh:10-36); here the mesh is that grid:
entry (i, j) scores mask block i against target block j. The JAX
package's mesh is a `jax.sharding.Mesh`; this one is a grid of
`torch.device`s, with the process that owns each entry when it spans
processes (`multihost.global_pair_mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _factor_grid(n: int) -> Tuple[int, int]:
    """Squarest (mask, target) factorization of n devices."""
    best = (1, n)
    for m in range(1, int(np.sqrt(n)) + 1):
        if n % m == 0:
            best = (m, n // m)
    return best


@dataclass(frozen=True)
class PairMesh:
    """devices: object [mask shards, target shards] of torch.device.
    ranks: int array of the same shape, the process owning each entry, or
    None when every entry belongs to this process."""
    devices: np.ndarray
    ranks: Optional[np.ndarray] = None
    axis_names: ClassVar[Tuple[str, str]] = ("mask", "target")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self) -> List[Tuple[int, int]]:
        """Every (mask block, target block) entry, row-major."""
        return [tuple(int(x) for x in p) for p in np.ndindex(self.devices.shape)]

    def local_positions(self, rank: int = 0) -> List[Tuple[int, int]]:
        """The entries process `rank` computes (all of them when the mesh
        is local)."""
        return [p for p in self.positions()
                if self.ranks is None or int(self.ranks[p]) == rank]


def grid_of(devices: Sequence, shape: Tuple[int, int]) -> np.ndarray:
    """An object array of `shape` holding `devices` in row-major order."""
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid.reshape(shape)


def make_pair_mesh(devices: Sequence,
                   shape: Optional[Tuple[int, int]] = None) -> PairMesh:
    """A ("mask", "target") mesh over the given devices of this process
    (torch.devices or specs such as "cuda:0"; an entry may repeat)."""
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = _factor_grid(len(devices))
    return PairMesh(grid_of(devices, shape))
