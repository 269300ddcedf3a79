"""Host memory-pressure guard.

Counterpart of the reference's low-memory reaction
(cmd/AbstractCmd.java:52-62: `checkMemoryUsage` forces a System.gc()
when free memory drops below the configurable `Memory.LowPercThreshold`
fraction). A JVM can only hint the collector; here the big consumers
are bounded caches (decoded images, device-resident shape planes,
decode prefetch), so the guard makes them SHRINK under pressure —
graceful degradation (more recomputation) instead of an OOM kill.

Copy of `colormipsearch_tpu/utils/memguard.py`; the bounded image cache
(`mips/loader.py:MIPsCache`) is its one user here.
"""

from __future__ import annotations

import gc
import logging
import os
import time
from typing import Callable, Optional, Tuple

LOG = logging.getLogger(__name__)

# fraction of total host memory that must stay available; below it the
# guard reports pressure (Memory.LowPercThreshold analogue)
LOW_MEM_PCT = float(os.environ.get("CMS_LOW_MEM_PCT", "0.08"))


def malloc_trim() -> bool:
    """Release free glibc arenas back to the OS. Large mixed-size
    per-item host buffers across threads make glibc retain freed arenas
    (measured: ~8 GB RSS growth per 100 GA masks OUTSIDE every cache in
    the r5 dress rehearsal, OOM at 125 GB); a trim keeps RSS tracking
    live data. No-op (False) off glibc."""
    try:
        import ctypes
        return bool(ctypes.CDLL("libc.so.6").malloc_trim(0))
    except Exception:  # pragma: no cover - non-glibc platform
        return False


def host_memory() -> Tuple[int, int]:
    """(available, total) bytes from /proc/meminfo; (large, large) when
    unavailable (non-Linux) so the guard never false-triggers."""
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                fields[key] = int(rest.strip().split()[0]) * 1024
        return (fields.get("MemAvailable", fields.get("MemFree", 1 << 62)),
                fields.get("MemTotal", 1 << 62))
    except Exception:  # pragma: no cover - non-procfs platform
        return (1 << 62, 1 << 62)


class MemoryGuard:
    """Probe + reaction policy shared by the bounded caches.

    probe: injectable () -> (available, total) for tests.
    Probes are rate-limited (min_interval seconds) so per-item cache
    inserts don't pay a procfs read each.
    """

    def __init__(self, low_pct: float = LOW_MEM_PCT,
                 probe: Optional[Callable[[], Tuple[int, int]]] = None,
                 min_interval: float = 1.0):
        self.low_pct = low_pct
        self.probe = probe or host_memory
        self.min_interval = min_interval
        self._last_probe = 0.0
        self._last_state = False
        self._last_gc = 0.0

    def under_pressure(self) -> bool:
        now = time.monotonic()
        if now - self._last_probe < self.min_interval:
            return self._last_state
        self._last_probe = now
        avail, total = self.probe()
        self._last_state = avail < self.low_pct * max(total, 1)
        return self._last_state

    def relieve(self, evict_half: Callable[[], int], what: str) -> None:
        """If under pressure, release free malloc arenas first (the r5
        dress rehearsal OOM'd with near-EMPTY caches: glibc arena bloat
        from large mixed-size per-item temporaries held the RSS, so
        evicting cache entries alone could not relieve anything), then
        ask the cache to drop ~half its entries (evict_half returns the
        number evicted) and collect; repeats until pressure clears or
        the cache is empty."""
        if not self.under_pressure():
            return
        malloc_trim()
        self._last_probe = 0.0
        while self.under_pressure():
            n = evict_half()
            now = time.monotonic()
            if now - self._last_gc > 5.0:
                gc.collect()
                malloc_trim()
                self._last_gc = now
            self._last_probe = 0.0  # re-probe after the eviction
            LOG.warning("low host memory: evicted %d %s entries", n, what)
            if n == 0:
                break


_SHARED: Optional[MemoryGuard] = None


def shared_guard() -> MemoryGuard:
    global _SHARED
    if _SHARED is None:
        _SHARED = MemoryGuard()
    return _SHARED
