"""Device memory pool (counterpart of ``trino_tpu/memory.py``).

Operators reserve before they allocate device state (group-by tables, join
builds) and learn from a refusal that the state would not fit.  On the card
the pool is sized from ``torch.cuda.mem_get_info``, or by ``max_bytes``.
Reservations may carry a tag (the buffer pool's ``page-cache``,
``build-cache`` and ``result-cache``), summed per tag in ``info()``.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["MemoryPool", "device_memory_budget"]


def device_memory_budget(device="cpu", fraction: float = 0.75) -> int:
    """Usable bytes of device memory: ``fraction`` of the card's free memory,
    or a conservative default off the card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free * fraction)
    return 4 << 30


class MemoryPool:
    """Node-level pool: operators reserve before allocating device state."""

    def __init__(self, device="cpu", max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes if max_bytes is not None \
            else device_memory_budget(device)
        self.reserved = 0
        self._by_tag: dict = {}
        self._lock = threading.Lock()

    def try_reserve(self, nbytes: int, tag: str = "") -> bool:
        """Reserve ``nbytes``; False when they would not fit."""
        with self._lock:
            if self.reserved + nbytes > self.max_bytes:
                return False
            self.reserved += nbytes
            if tag:
                self._by_tag[tag] = self._by_tag.get(tag, 0) + nbytes
            return True

    def free(self, nbytes: int, tag: str = "") -> None:
        with self._lock:
            self.reserved = max(self.reserved - nbytes, 0)
            if tag and tag in self._by_tag:
                self._by_tag[tag] = max(self._by_tag[tag] - nbytes, 0)

    def info(self) -> dict:
        """Snapshot dict: what /v1/status and /v1/metrics serve."""
        with self._lock:
            return {"max_bytes": self.max_bytes, "reserved": self.reserved,
                    "free": self.max_bytes - self.reserved,
                    "by_tag": dict(self._by_tag)}
