"""Device buffer pool: page, join-build and result caching across queries
(counterpart of ``trino_tpu/execution/bufferpool.py``).

A cached scan skips generation (on the card, the ``splitmix64`` chains that
take most of TPC-H's device time) and is served as ONE device page holding
the whole scan, so every downstream per-split loop collapses to a single pass
per stage.  Three tiers, one LRU:

- **Page tier**: a completed scan's pages, concatenated into one page on the
  engine's device, keyed on (catalog, table, split list, column set,
  connector ``plan_version``).  Raw pre-transform pages, so queries with
  different filters and projections over the same scan share the entry.
  Only a scan that ran to completion is stored (``exec/local_executor``'s
  ``_scan_pages_source``): a LIMIT that stops early, or an error, stores
  nothing.
- **Build tier**: a join's finished build state (the build page, its
  dictionaries, the null statistics and the built hash table, or the
  multi-match table), keyed on a structural fingerprint of the build
  fragment plus the catalogs it reads.
- **Result tier**: completed ``MaterializedResult``s keyed on (structural
  plan fingerprint, catalogs, plan-shaping session properties).  Entries are
  host-resident numpy columns; a hit answers a statement with no launch, no
  host read and no H2D copy.  Admission (deterministic plans, cacheable
  connectors, no volatile function) is the engine's job: the pool stores
  what it is handed.

Reservations flow through a private labeled :class:`~..memory.MemoryPool`
(pool ``buffer-pool`` in ``Engine.memory_info()``, tags ``page-cache``,
``build-cache`` and ``result-cache``).  Pressure LRU-evicts instead of
raising, and ``clear()`` releases every reservation (``Engine._invalidate``
calls it after every DDL and DML statement).  ``epoch`` counts invalidations:
every store presents the epoch its statement (a result) or its executor (a
page or a build) started under, and a mismatch refuses the store.

Budgets, each read at first use, never at import:

- the page and build tiers: ``TRINO_TPU_PAGE_CACHE`` bytes when set (0 turns
  them off); unset, 0 on a CPU device and a quarter of the card's memory
  (``torch.cuda.mem_get_info`` on the engine's device) on a CUDA device;
- the result tier: ``TRINO_TPU_RESULT_CACHE`` bytes, 0 (off) when unset, on
  every device.

The ``page_cache`` and ``result_cache`` session properties opt single
queries out of (or back into) a configured pool.

The tiered spill's first tier (``exec/spill.py``) claims device memory
from the page and build budget (``reserve_spill`` / ``release_spill``, under
the ``spill`` tag): page and build entries evict, oldest first, to make
room, since the cache gives way to live query state; a spill chunk never
takes the pool past its budget (it overflows to the host tier instead).

Fault points (``execution/faults``), as in the reference: ``cache_checkout``
in ``get_page`` / ``get_build`` / ``get_result`` (sites ``page.<table>``,
``build``, ``result``; ``deny`` serves a miss) and ``cache_store`` in the
three puts, past their early exits (``deny`` skips the admission; a raised
fault reaches the caller's store guard, which keeps the statement
successful and the entry absent).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from . import faults

__all__ = ["DeviceBufferPool", "page_cache_budget", "result_cache_budget"]


def _env_bytes(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None:
        return None
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def page_cache_budget(device="cpu") -> int:
    """The page and build tiers' byte budget: ``TRINO_TPU_PAGE_CACHE`` when
    set (0 disables), else 0 on a CPU device and a quarter of the card's
    memory on a CUDA device."""
    env = _env_bytes("TRINO_TPU_PAGE_CACHE")
    if env is not None:
        return env
    if torch.device(device).type != "cuda":
        return 0
    from ..memory import device_memory_budget

    return device_memory_budget(device, 0.25)


def result_cache_budget() -> int:
    """The result tier's byte budget: ``TRINO_TPU_RESULT_CACHE`` (0
    disables), 0 when unset on every device: results live in host memory,
    and a default would turn every warm run into a cache hit."""
    env = _env_bytes("TRINO_TPU_RESULT_CACHE")
    return 0 if env is None else env


def _result_nbytes(result) -> int:
    """Host bytes a cached MaterializedResult pins: decoded and raw columns,
    deduplicated by identity (undecoded columns alias their raw array);
    object columns count a pointer and the text of each value."""
    total = 0
    seen: set = set()
    for cols in (result.columns, result.raw_columns):
        for c in cols:
            if id(c) in seen:
                continue
            seen.add(id(c))
            a = np.asarray(c)
            if a.dtype == object:
                total += 8 * a.size + sum(len(str(v)) for v in a.ravel() if v is not None)
            else:
                total += a.nbytes
    return total


def _tensor_nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _page_nbytes(page) -> int:
    """Device bytes a cached page pins (columns, null masks, valid)."""
    total = sum(_tensor_nbytes(c) for c in page.columns)
    total += sum(_tensor_nbytes(m) for m in page.null_masks if m is not None)
    return total + _tensor_nbytes(page.valid)


def _table_nbytes(table) -> int:
    """Device bytes of a join table's tensors (``JoinTable``,
    ``DirectJoinTable`` and the multi-match layouts).  Build columns alias
    the build page's: the double count is a deliberate over-estimate
    (earlier eviction, never a silent overcommit)."""
    if table is None:
        return 0
    total = 0
    for f in dataclasses.fields(table):
        v = getattr(table, f.name)
        for leaf in (v if isinstance(v, (tuple, list)) else (v,)):
            total += _tensor_nbytes(leaf)
    return total


class _Entry:
    __slots__ = ("kind", "catalog", "table", "payload", "nbytes", "anchor")

    def __init__(self, kind, catalog, table, payload, nbytes, anchor=None):
        self.kind = kind  # "page" | "build" | "result"
        self.catalog = catalog
        self.table = table  # "" for build and result entries
        self.payload = payload
        self.nbytes = nbytes
        # the plan fragment a build or result key was fingerprinted from,
        # held so that no value the fingerprint printed by identity is freed
        # (and its id reused) while the entry lives
        self.anchor = anchor


class DeviceBufferPool:
    """Engine-owned three-tier cache with one LRU, accounted through a
    labeled MemoryPool.  One instance is shared by every executor the
    engine makes, under its lock."""

    PAGE_TAG = "page-cache"
    BUILD_TAG = "build-cache"
    RESULT_TAG = "result-cache"
    SPILL_TAG = "spill"

    def __init__(self, budget_bytes: Optional[int] = None,
                 result_budget_bytes: Optional[int] = None, device="cpu"):
        self._budget = budget_bytes  # None = read at first use
        self._result_budget = result_budget_bytes  # None = read at first use
        self.device = torch.device(device)
        # per-group resident bytes: the shared MemoryPool's max is the SUM of
        # both budgets, so each group holds to its own (device entries never
        # grow into the result budget's headroom, nor results into theirs)
        self._result_bytes = 0
        self._device_bytes = 0
        # invalidation epoch: clear() and invalidate_catalog() bump it
        self.epoch = 0
        self._lock = threading.RLock()
        self._entries: OrderedDict = OrderedDict()  # key -> _Entry (LRU order)
        self.memory_pool = None  # made at the first store
        # lifetime counts (the /v1/metrics *_total series)
        self.hits = 0
        self.misses = 0
        self.build_hits = 0
        self.build_misses = 0
        self.result_hits = 0
        self.result_misses = 0
        self.evictions = 0

    # -- gating ----------------------------------------------------------------
    def budget(self) -> int:
        with self._lock:
            if self._budget is None:
                self._budget = page_cache_budget(self.device)
            return self._budget

    @property
    def enabled(self) -> bool:
        return self.budget() > 0

    def result_budget(self) -> int:
        with self._lock:
            if self._result_budget is None:
                self._result_budget = result_cache_budget()
            return self._result_budget

    @property
    def result_enabled(self) -> bool:
        return self.result_budget() > 0

    def result_entry_cap(self) -> int:
        """Largest result one entry may hold: a quarter of the result
        budget, so one full-table SELECT cannot take (or thrash) the tier."""
        return max(self.result_budget() // 4, 1)

    @staticmethod
    def cacheable(conn) -> bool:
        """Only connectors whose pages are fixed for a given ``plan_version``
        may cache (generators, the memory catalog, whose every write
        through the engine invalidates, and the file connectors).  Volatile
        sources (the system tables, a remote dbapi database) never opt in."""
        return bool(getattr(conn, "CACHEABLE_SCANS", False))

    def _pool(self):
        if self.memory_pool is None:
            from ..memory import MemoryPool

            self.memory_pool = MemoryPool(max_bytes=self.budget() + self.result_budget())
        return self.memory_pool

    @classmethod
    def _tag_of(cls, kind: str) -> str:
        return {"page": cls.PAGE_TAG, "build": cls.BUILD_TAG,
                "result": cls.RESULT_TAG}[kind]

    # -- keys ------------------------------------------------------------------
    @staticmethod
    def page_key(catalog: str, conn, table: str, splits, columns) -> tuple:
        ver = conn.plan_version() if hasattr(conn, "plan_version") else 0
        return ("page", catalog, table,
                tuple((s.lo, s.hi) if hasattr(s, "lo") and hasattr(s, "hi")
                      else repr(s) for s in splits),
                tuple(columns), ver)

    # -- page tier -------------------------------------------------------------
    def get_page(self, key):
        """(page, nbytes) or None; a hit refreshes its LRU place."""
        if faults.maybe_inject("cache_checkout", f"page.{key[2]}") == "deny":
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.payload, e.nbytes

    def has_page(self, key) -> bool:
        """Presence, without touching the LRU order or the counts."""
        with self._lock:
            return key in self._entries

    def put_page(self, key, page, epoch: Optional[int] = None) -> bool:
        """Store a completed scan staged as one device page.  ``epoch`` is
        the pool epoch the executor started under: a mismatch means a write
        invalidated the pool while the scan ran, so the page may predate it
        and the store is refused."""
        if not self.enabled or page is None:
            return False
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return False
            if key in self._entries:
                return True  # another executor stored it first
        # past the early exits: a fire means a store was attempted
        if faults.maybe_inject("cache_store", f"page.{key[2]}") == "deny":
            return False
        return self._store(key, _Entry("page", key[1], key[2], page, _page_nbytes(page)),
                           self.PAGE_TAG, epoch)

    # -- build tier ------------------------------------------------------------
    def get_build(self, key):
        """The build payload dict, or None."""
        if faults.maybe_inject("cache_checkout", "build") == "deny":
            with self._lock:
                self.build_misses += 1
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.build_misses += 1
                return None
            self._entries.move_to_end(key)
            self.build_hits += 1
            return e.payload

    def put_build(self, key, payload, epoch: Optional[int] = None, anchor=None) -> bool:
        """``key`` is ("build", fingerprint, right keys, catalogs, ...): the
        catalogs tuple (key[3]) is what invalidate_catalog matches.
        ``epoch`` refuses a stale store, as in ``put_page``; ``anchor`` is
        the build fragment the fingerprint was taken of."""
        if not self.enabled:
            return False
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return False
            if key in self._entries:
                return True
        if faults.maybe_inject("cache_store", "build") == "deny":
            return False
        nbytes = _page_nbytes(payload["page"]) + _table_nbytes(payload.get("table")) \
            + _table_nbytes(payload.get("multi"))
        payload["nbytes"] = nbytes
        return self._store(key, _Entry("build", ",".join(key[3]), "", payload, nbytes,
                                       anchor), self.BUILD_TAG, epoch)

    # -- result tier -----------------------------------------------------------
    def get_result(self, key):
        """(MaterializedResult, nbytes) or None.  Served results are shared
        numpy arrays: every engine surface treats results as immutable."""
        if faults.maybe_inject("cache_checkout", "result") == "deny":
            with self._lock:
                self.result_misses += 1
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.result_misses += 1
                return None
            self._entries.move_to_end(key)
            self.result_hits += 1
            return e.payload, e.nbytes

    def put_result(self, key, result, epoch: Optional[int] = None, anchor=None) -> bool:
        """Store a completed MaterializedResult.  ``key[2]`` is the catalogs
        tuple invalidate_catalog matches.  ``epoch`` is the pool epoch the
        statement started under: a mismatch means an invalidation landed
        while it ran, and its result may predate the write, so the store is
        refused.  ``anchor`` is the plan the key was fingerprinted from.
        Entries past the per-entry cap are skipped; the tier evicts its own
        entries, oldest first, to stay inside its budget."""
        if not self.result_enabled or result is None:
            return False
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return False
            if key in self._entries:
                return True  # a concurrent statement stored it first
        if faults.maybe_inject("cache_store", "result") == "deny":
            return False
        nbytes = _result_nbytes(result)
        if nbytes > self.result_entry_cap():
            return False
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return False
            while self._result_bytes + nbytes > self.result_budget():
                if not self._evict_oldest(("result",)):
                    return False
            cats = ",".join(key[2]) if key[2] else ""
            return self._store(key, _Entry("result", cats, "", result, nbytes, anchor),
                               self.RESULT_TAG, epoch)

    # -- storage and eviction --------------------------------------------------
    def _store(self, key, entry: _Entry, tag: str, epoch: Optional[int] = None) -> bool:
        """Admit ``entry``, evicting to fit.  The epoch is checked again
        under the lock that ``clear`` takes, so no store lands after an
        invalidation its statement started before."""
        pool = self._pool()
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return False
            if key in self._entries:
                return True
            if entry.nbytes > pool.max_bytes:
                return False  # can never fit: evict nothing for it
            if entry.kind in ("page", "build"):
                while self._device_usage() + entry.nbytes > self.budget():
                    if not self._evict_oldest(("page", "build")):
                        return False
            while not pool.try_reserve(entry.nbytes, tag):
                if not self._entries:
                    return False
                self._evict_lru()
            self._entries[key] = entry
            if entry.kind == "result":
                self._result_bytes += entry.nbytes
            else:
                self._device_bytes += entry.nbytes
            return True

    def _device_usage(self) -> int:
        """Caller holds the lock: resident page and build bytes plus the live
        device spill reservations, what the page and build budget bounds."""
        spill = 0
        if self.memory_pool is not None:
            spill = self.memory_pool.info()["by_tag"].get(self.SPILL_TAG, 0)
        return self._device_bytes + spill

    def _forget(self, e: _Entry) -> None:
        """Caller holds the lock: a removed entry's bytes and reservation."""
        if e.kind == "result":
            self._result_bytes -= e.nbytes
        else:
            self._device_bytes -= e.nbytes
        if self.memory_pool is not None:
            self.memory_pool.free(e.nbytes, self._tag_of(e.kind))

    def _evict_oldest(self, kinds) -> bool:
        """Caller holds the lock: evict the least recently used entry of one
        of ``kinds``; False when there is none."""
        oldest = next((k for k, e in self._entries.items() if e.kind in kinds), None)
        if oldest is None:
            return False
        self.evictions += 1
        self._forget(self._entries.pop(oldest))
        return True

    def _evict_lru(self) -> None:
        """Caller holds the lock.  The tensors free when the last query
        holding them lets go (torch tensors are reference-counted)."""
        _key, e = self._entries.popitem(last=False)
        self.evictions += 1
        self._forget(e)

    # -- the spill's device tier ------------------------------------------------
    def reserve_spill(self, nbytes: int) -> bool:
        """Claim device memory for one spill chunk: page and build entries
        evict, oldest first, to make room; False when the chunk cannot fit
        the page and build budget (the spill overflows to the host)."""
        if not self.enabled or nbytes <= 0:
            return False
        pool = self._pool()
        with self._lock:
            if nbytes > self.budget():
                return False
            while self._device_usage() + nbytes > self.budget():
                if not self._evict_oldest(("page", "build")):
                    return False
            while not pool.try_reserve(nbytes, self.SPILL_TAG):
                if not self._entries:
                    return False
                self._evict_lru()
            return True

    def release_spill(self, nbytes: int) -> None:
        """Return a spill reservation (the spill closed)."""
        if nbytes and self.memory_pool is not None:
            self.memory_pool.free(nbytes, self.SPILL_TAG)

    def evict_bytes(self, nbytes: int) -> int:
        """Evict entries, oldest first, until ``nbytes`` are freed or the
        pool is empty; returns the bytes freed."""
        freed = 0
        with self._lock:
            while freed < nbytes and self._entries:
                freed += next(iter(self._entries.values())).nbytes
                self._evict_lru()
        return freed

    # -- invalidation ----------------------------------------------------------
    def invalidate_catalog(self, catalog: str) -> None:
        """Drop every entry that reads ``catalog`` (a catalog's plan_version
        moved).  Build and result entries fingerprint the versions, so a
        stale one never serves: this releases its memory too."""
        with self._lock:
            self.epoch += 1
            dead = [k for k, e in self._entries.items()
                    if e.catalog == catalog
                    or (e.kind == "build" and catalog in k[3])
                    or (e.kind == "result" and catalog in k[2])]
            for k in dead:
                self._forget(self._entries.pop(k))

    def clear(self) -> None:
        """Release everything (``Engine._invalidate``: DDL, DML,
        ``register_catalog``)."""
        with self._lock:
            self.epoch += 1
            for e in self._entries.values():
                if self.memory_pool is not None:
                    self.memory_pool.free(e.nbytes, self._tag_of(e.kind))
            self._entries.clear()
            self._result_bytes = 0
            self._device_bytes = 0

    # -- observability ---------------------------------------------------------
    def info(self) -> dict:
        """Snapshot for /v1/status's ``buffer_pool`` and the /v1/metrics
        gauges.  ``bytes`` counts every tier, ``device_bytes`` the page and
        build tiers."""
        with self._lock:
            per_table: dict = {}
            total = 0
            pages = builds = results = 0
            for e in self._entries.values():
                total += e.nbytes
                if e.kind == "page":
                    pages += 1
                elif e.kind == "build":
                    builds += 1
                else:
                    results += 1
                kind_label = "<build>" if e.kind == "build" else "<result>"
                label = f"{e.catalog}.{e.table}" if e.table else \
                    (f"{e.catalog}.{kind_label}" if e.catalog else kind_label)
                t = per_table.setdefault(label, {"entries": 0, "bytes": 0})
                t["entries"] += 1
                t["bytes"] += e.nbytes
            return {"budget_bytes": self._budget,
                    "enabled": bool(self._budget) if self._budget is not None else None,
                    "entries": len(self._entries),
                    "page_entries": pages, "build_entries": builds,
                    "result_entries": results,
                    "device_bytes": self._device_bytes,
                    "result_bytes": self._result_bytes,
                    "result_budget_bytes": self._result_budget,
                    "bytes": total,
                    "hits": self.hits, "misses": self.misses,
                    "build_hits": self.build_hits,
                    "build_misses": self.build_misses,
                    "result_hits": self.result_hits,
                    "result_misses": self.result_misses,
                    "evictions": self.evictions,
                    "per_table": per_table}
