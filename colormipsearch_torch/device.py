"""Explicit device selection.

Counterpart of the JAX package's platform pin (`cmd/main.py`
CMS_PLATFORM and `pallas_sweep.TwoPhaseSweep(devices=None)` picking
`jax.local_devices()`): here the device always comes from the caller —
a `--device` CLI argument or a `device=` parameter. Nothing is guessed
and nothing falls back to the CPU. `resolve_devices` is the commands'
reading of `--device`: "cuda" is every visible card, as the JAX package
drives every local device.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def resolve_device(spec) -> torch.device:
    """torch.device for `spec` ("cuda", "cuda:1", "cpu" or a device).

    Raises when a CUDA device is asked for and no card (or not that
    card) is visible."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {spec!r} requested but torch sees no CUDA card")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {spec!r} requested but only "
                f"{torch.cuda.device_count()} CUDA card(s) are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {spec!r}: use cuda[:N] or cpu")
    return dev


def resolve_devices(spec) -> List[torch.device]:
    """The devices a command runs on: "cuda" is every visible card,
    "cuda:N" that one card, "cpu" the CPU. Raises as resolve_device when
    a card is asked for and not there."""
    dev = resolve_device(spec)
    if dev.type == "cuda" and torch.device(spec).index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def peak_memory_gib(devices) -> Optional[float]:
    """The most memory any CUDA device of `devices` held at once in this
    process (torch.cuda.max_memory_allocated), in GiB; None when none is
    a CUDA device."""
    peaks = [torch.cuda.max_memory_allocated(d) for d in devices
             if torch.device(d).type == "cuda"]
    return max(peaks) / 2**30 if peaks else None
