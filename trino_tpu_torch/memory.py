"""Device memory pool and memory contexts (counterpart of
``trino_tpu/memory.py``).

Operators reserve before they allocate device state (group-by tables, join
builds) and learn from a refusal that the state would not fit: they switch
to their Grace-partitioned strategy, whose buffers walk the tiered spill
(``exec/spill.py``: device, host RAM under this pool's ``spill`` tag, disk).
On the card the pool is sized from ``torch.cuda.mem_get_info``, or by
``max_bytes``.  Reservations may carry a tag (the buffer pool's
``page-cache``, ``build-cache``, ``result-cache`` and ``spill``; the
executor's ``group-by``, ``join-build`` and ``spill``), summed per tag in
``info()["by_tag"]``.  ``blocked(fraction)`` is the one definition of a
pressured pool that the engine's admission gate reads
(``execution/memory_killer.BLOCKED_FRACTION``).

Per-query limit (``query_max_memory``), as in the reference: the engine
calls ``begin_query(limit)`` before each plan execution, and a reservation
that would take the query past its limit raises ``QueryMemoryLimitError``
(a kill, not a refusal: a refusal makes the operator pick a smaller
strategy).  The reference gives each pooled executor a pool of its own and
runs one query on it at a time; the port's engine shares one pool between
the statements that run at once on the server's threads, and a statement
runs on one thread, so ``query_limit`` and ``query_reserved`` are kept per
thread.

The cluster killer's surfaces, as in the reference: a worker task runs in
its query's ``query_scope(key)``, which attributes the thread's
reservations to the query (``by_query``, what the coordinator's kill policy
reads); ``kill_query(key)`` poisons a query on the node, so its next
reservation or preemption point (``check_killed``) raises
``QueryKilledError``.  Poison entries outlive ``clear_query`` (a bounded
FIFO retires them), so re-offered tasks of a victim die here too.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from .execution import faults

__all__ = ["AggregatedMemoryContext", "LocalMemoryContext", "MemoryPool",
           "MemoryPoolExhaustedError", "QueryKilledError", "QueryMemoryLimitError",
           "device_memory_budget"]


class MemoryPoolExhaustedError(MemoryError):
    pass


class QueryMemoryLimitError(MemoryError):
    """The query exceeded its query_max_memory limit: a hard kill, not a
    spill trigger (reference: ExceededMemoryLimitException)."""


class QueryKilledError(MemoryError):
    """The cluster low-memory policy chose this query as its victim
    (reference: LowMemoryKiller, ClusterMemoryManager.java:92).
    Deterministic: a retry would meet the same pressure."""


_SCOPE = threading.local()  # this thread's query key, for per-query attribution


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
        # per-query attribution under query_scope, and the killed queries
        # (insertion-ordered; the oldest goes past _killed_cap)
        self._by_query: dict = {}
        self._killed: dict = {}
        self._killed_cap = 64

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

    # -- the cluster killer's surfaces ------------------------------------------
    @contextlib.contextmanager
    def query_scope(self, key: str):
        """Reservations on this thread attribute to ``key`` until exit."""
        prev = getattr(_SCOPE, "key", None)
        _SCOPE.key = key
        try:
            yield
        finally:
            _SCOPE.key = prev

    def kill_query(self, key: str) -> None:
        """Poison ``key`` on this node: its next reservation, on any thread,
        raises QueryKilledError; its memory frees as its tasks unwind."""
        with self._lock:
            self._killed[key] = True
            while len(self._killed) > self._killed_cap:
                self._killed.pop(next(iter(self._killed)))

    def check_killed(self) -> None:
        """Raise QueryKilledError if this thread's query was killed (the
        preemption points call it, so a phase that reserves nothing ends
        too)."""
        key = getattr(_SCOPE, "key", None)
        with self._lock:
            if key is not None and key in self._killed:
                raise QueryKilledError(
                    f"query {key} killed by the cluster low-memory policy")

    def clear_query(self, key: str) -> None:
        """Drop a finished query's attribution on this node (its poison
        entry stays, see kill_query)."""
        with self._lock:
            self._by_query.pop(key, None)

    def by_query(self) -> dict:
        with self._lock:
            return dict(self._by_query)

    def try_reserve(self, nbytes: int, tag: str = "") -> bool:
        """Reserve ``nbytes``; False when they would not fit the pool.
        Raises QueryMemoryLimitError past this thread's query limit.  A
        ``reserve`` fault point (``execution/faults``, site = the tag):
        ``deny`` refuses, and the caller takes its smaller strategy."""
        if faults.maybe_inject("reserve", tag) == "deny":
            return False
        qkey = getattr(_SCOPE, "key", None)
        if qkey is not None and qkey in self._killed:
            raise QueryKilledError(
                f"query {qkey} killed by the cluster low-memory policy")
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
            if qkey is not None:
                self._by_query[qkey] = self._by_query.get(qkey, 0) + nbytes
        self._query.reserved = held + nbytes
        return True

    def reserve(self, nbytes: int, tag: str = "") -> None:
        if not self.try_reserve(nbytes, tag):
            raise MemoryPoolExhaustedError(
                f"memory pool exhausted: requested {nbytes} bytes, "
                f"{self.max_bytes - self.reserved} free of {self.max_bytes}")

    def free(self, nbytes: int, tag: str = "") -> None:
        # a free attributes to the freeing thread's query scope, as in the
        # reference: poll-grade, clamped at zero, cleared by clear_query
        qkey = getattr(_SCOPE, "key", None)
        with self._lock:
            self.reserved = max(self.reserved - nbytes, 0)
            if tag and tag in self._by_tag:
                self._by_tag[tag] = max(self._by_tag[tag] - nbytes, 0)
            if qkey is not None and qkey in self._by_query:
                self._by_query[qkey] = max(self._by_query[qkey] - nbytes, 0)
        self._query.reserved = max(self.query_reserved - nbytes, 0)

    def hold(self, nbytes: int, tag: str) -> None:
        """Count ``nbytes`` that already sit on the device and outlive any
        one query (the scan-fused runners' static tensors and graph pool):
        node-level only, never refused (the pool may go past its maximum,
        and the next reservations are refused instead), no query's."""
        with self._lock:
            self.reserved += nbytes
            self._by_tag[tag] = self._by_tag.get(tag, 0) + nbytes

    def release(self, nbytes: int, tag: str) -> None:
        """Give back what ``hold`` counted."""
        with self._lock:
            self.reserved = max(self.reserved - nbytes, 0)
            if tag in self._by_tag:
                self._by_tag[tag] = max(self._by_tag[tag] - nbytes, 0)

    def free_bytes(self) -> int:
        with self._lock:
            return self.max_bytes - self.reserved

    def blocked(self, fraction: float) -> bool:
        """Is this pool past ``fraction`` of its capacity?"""
        with self._lock:
            return bool(self.max_bytes) and self.reserved > fraction * self.max_bytes

    def info(self) -> dict:
        """Snapshot dict: what /v1/status and /v1/metrics serve
        (``query_reserved`` is the calling thread's)."""
        with self._lock:
            return {"max_bytes": self.max_bytes, "reserved": self.reserved,
                    "free": self.max_bytes - self.reserved,
                    "query_reserved": self.query_reserved,
                    "by_tag": dict(self._by_tag),
                    "by_query": dict(self._by_query)}


class AggregatedMemoryContext:
    """Parent context summing its children; the root feeds a MemoryPool."""

    def __init__(self, pool: Optional[MemoryPool] = None,
                 parent: Optional["AggregatedMemoryContext"] = None, tag: str = ""):
        self.pool = pool
        self.parent = parent
        self.tag = tag
        self.bytes = 0
        self._lock = threading.Lock()

    def new_child(self, tag: str = "") -> "AggregatedMemoryContext":
        return AggregatedMemoryContext(parent=self, tag=tag or self.tag)

    def new_local(self, tag: str = "") -> "LocalMemoryContext":
        return LocalMemoryContext(self, tag or self.tag)

    def _root(self) -> "AggregatedMemoryContext":
        root = self
        while root.parent is not None:
            root = root.parent
        return root

    def _add(self, delta: int) -> None:
        node = self
        while node is not None:
            with node._lock:
                node.bytes += delta
            node = node.parent

    def _update(self, delta: int) -> None:
        """Add ``delta`` up the chain; the root reserves or frees it in the
        pool under the root's tag, raising when the pool refuses."""
        with self._lock:
            self.bytes += delta
        if self.parent is not None:
            self.parent._update(delta)
        elif self.pool is not None:
            if delta > 0:
                self.pool.reserve(delta, self.tag)
            elif delta < 0:
                self.pool.free(-delta, self.tag)

    def try_update(self, delta: int) -> bool:
        """Reserve without raising, under this context's tag: False when the
        pool refuses."""
        pool = self._root().pool
        if delta > 0 and pool is not None and not pool.try_reserve(delta, self.tag):
            return False
        self._add(delta)
        if delta < 0 and pool is not None:
            pool.free(-delta, self.tag)
        return True


class LocalMemoryContext:
    """Leaf context with set-bytes semantics."""

    def __init__(self, parent: AggregatedMemoryContext, tag: str = ""):
        self.parent = parent
        self.tag = tag
        self.bytes = 0

    def set_bytes(self, nbytes: int) -> None:
        delta = nbytes - self.bytes
        self.parent._update(delta)
        self.bytes = nbytes

    def try_set_bytes(self, nbytes: int) -> bool:
        if self.parent.try_update(nbytes - self.bytes):
            self.bytes = nbytes
            return True
        return False

    def close(self) -> None:
        self.set_bytes(0)
