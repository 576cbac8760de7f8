"""Device memory pool (counterpart of ``trino_tpu/memory.py``).

Operators reserve before they allocate device state (group-by tables, join
builds) and learn from a refusal that the state would not fit.  On the card
the pool is sized from ``torch.cuda.mem_get_info``, or by ``max_bytes``.
Reservations may carry a tag (the buffer pool's ``page-cache``,
``build-cache`` and ``result-cache``), summed per tag in ``info()``.

Per-query limit (``query_max_memory``), as in the reference: the engine
calls ``begin_query(limit)`` before each plan execution, and a reservation
that would take the query past its limit raises ``QueryMemoryLimitError``
(a kill, not a refusal: a refusal makes the operator pick a smaller
strategy).  The reference gives each pooled executor a pool of its own and
runs one query on it at a time; the port's engine shares one pool between
the statements that run at once on the server's threads, and a statement
runs on one thread, so ``query_limit`` and ``query_reserved`` are kept per
thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["MemoryPool", "QueryMemoryLimitError", "device_memory_budget"]


class QueryMemoryLimitError(MemoryError):
    """The query exceeded its query_max_memory limit: a hard kill, not a
    spill trigger (reference: ExceededMemoryLimitException)."""


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
        self._query = threading.local()  # this thread's query: limit, reserved

    def begin_query(self, limit: Optional[int]) -> None:
        """Start this thread's query under ``limit`` bytes (None: no limit)."""
        self._query.limit = limit
        self._query.reserved = 0

    @property
    def query_limit(self) -> Optional[int]:
        return getattr(self._query, "limit", None)

    @property
    def query_reserved(self) -> int:
        return getattr(self._query, "reserved", 0)

    def try_reserve(self, nbytes: int, tag: str = "") -> bool:
        """Reserve ``nbytes``; False when they would not fit the pool.
        Raises QueryMemoryLimitError past this thread's query limit."""
        limit, held = self.query_limit, self.query_reserved
        if limit is not None and held + nbytes > limit:
            raise QueryMemoryLimitError(
                f"query exceeded query_max_memory: requested {nbytes} bytes with "
                f"{held} already reserved of {limit}")
        with self._lock:
            if self.reserved + nbytes > self.max_bytes:
                return False
            self.reserved += nbytes
            if tag:
                self._by_tag[tag] = self._by_tag.get(tag, 0) + nbytes
        self._query.reserved = held + nbytes
        return True

    def free(self, nbytes: int, tag: str = "") -> None:
        with self._lock:
            self.reserved = max(self.reserved - nbytes, 0)
            if tag and tag in self._by_tag:
                self._by_tag[tag] = max(self._by_tag[tag] - nbytes, 0)
        self._query.reserved = max(self.query_reserved - nbytes, 0)

    def info(self) -> dict:
        """Snapshot dict: what /v1/status and /v1/metrics serve
        (``query_reserved`` is the calling thread's)."""
        with self._lock:
            return {"max_bytes": self.max_bytes, "reserved": self.reserved,
                    "free": self.max_bytes - self.reserved,
                    "query_reserved": self.query_reserved,
                    "by_tag": dict(self._by_tag)}
