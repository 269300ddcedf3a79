"""Persistence helpers (counterpart of `colormipsearch_tpu/persist/`)."""

from .idgenerator import TimebasedIdGenerator
