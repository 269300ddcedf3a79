"""Distributed time-based unique ID generator.

Copy of `colormipsearch_tpu/persist/idgenerator.py`. Counterpart of
dao/TimebasedIdGenerator.java:16-132: IDs are
(millis - epoch_offset) << 22 | block_index << 12
| deployment_context << 8 | last_ip_octet, handed out in blocks of up to
1024 per millisecond, with an optional cross-process file lock for
multi-process uniqueness (the reference's --use-id-generator-lock).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import List, Optional

_EPOCH_OFFSET_MS = 921700000000  # same fixed offset style as the reference
_BLOCK_SIZE = 1024


def _last_ip_octet() -> int:
    try:
        host = socket.gethostbyname(socket.gethostname())
        return int(host.rsplit(".", 1)[-1]) & 0xFF
    except Exception:
        return (os.getpid() & 0xFF)


class TimebasedIdGenerator:
    def __init__(self, deployment_context: int = 0,
                 lock_file: Optional[str] = None):
        if not 0 <= deployment_context < 16:
            raise ValueError("deployment context must be in [0, 16)")
        self.deployment_context = deployment_context
        self.ip_component = _last_ip_octet()
        self.lock_file = lock_file
        self._lock = threading.Lock()
        self._current_ms = 0
        self._index = 0

    def _next_block(self, n: int) -> List[int]:
        ids = []
        while n > 0:
            now = int(time.time() * 1000)
            if now != self._current_ms:
                self._current_ms = now
                self._index = 0
            avail = _BLOCK_SIZE - self._index
            if avail <= 0:
                time.sleep(0.001)
                continue
            take = min(n, avail)
            base = (now - _EPOCH_OFFSET_MS) << 22
            for i in range(take):
                ids.append(base | ((self._index + i) << 12)
                           | (self.deployment_context << 8)
                           | self.ip_component)
            self._index += take
            n -= take
        return ids

    def generate_id(self) -> int:
        return self.generate_ids(1)[0]

    def generate_ids(self, n: int) -> List[int]:
        with self._lock:
            if self.lock_file:
                # cross-process file lock (TimebasedIdGenerator.java:81-103)
                import fcntl
                os.makedirs(os.path.dirname(os.path.abspath(self.lock_file)),
                            exist_ok=True)
                with open(self.lock_file, "a+") as lf:
                    fcntl.flock(lf, fcntl.LOCK_EX)
                    try:
                        return self._next_block(n)
                    finally:
                        fcntl.flock(lf, fcntl.LOCK_UN)
            return self._next_block(n)
