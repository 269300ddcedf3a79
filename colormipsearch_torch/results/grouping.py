"""Result partitioning.

Copy of `partition_collection` from `colormipsearch_tpu/results/grouping.py`
(ItemsHandling.partitionCollection, results/ItemsHandling.java); the
top-ranked selection of that module serves other commands.
"""

from __future__ import annotations

from typing import List, Sequence, TypeVar

T = TypeVar("T")


def partition_collection(items: Sequence[T], partition_size: int) -> List[List[T]]:
    """Chunk into fixed-size partitions (ItemsHandling.partitionCollection)."""
    size = partition_size if partition_size > 0 else 1
    return [list(items[i:i + size]) for i in range(0, len(items), size)]
