"""Result partitioning (counterpart of `colormipsearch_tpu/results/`)."""

from .grouping import partition_collection
