"""Typed system session properties with validation.

Reference: SystemSessionProperties.java (2,069 LoC of property definitions) +
metadata/SessionPropertyManager.java — per-query overrides of engine behavior,
validated at SET time.  The catalog here covers the knobs this engine actually
reads; unknown names raise, values are parsed/validated against the declared
type, exactly like `SET SESSION x = y` in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

__all__ = ["PropertyMetadata", "SessionPropertyManager", "SYSTEM_SESSION_PROPERTIES"]


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    description: str
    type: str  # 'boolean' | 'integer' | 'double' | 'varchar'
    default: Any
    validate: Optional[Callable[[Any], Optional[str]]] = None  # returns error or None

    def parse(self, value):
        if self.type == "boolean":
            if isinstance(value, bool):
                v = value
            elif str(value).lower() in ("true", "false"):
                v = str(value).lower() == "true"
            else:
                raise ValueError(f"{self.name} must be a boolean, got {value!r}")
        elif self.type == "integer":
            try:
                v = int(value)
            except (TypeError, ValueError):
                raise ValueError(f"{self.name} must be an integer, got {value!r}")
        elif self.type == "double":
            try:
                v = float(value)
            except (TypeError, ValueError):
                raise ValueError(f"{self.name} must be a double, got {value!r}")
        else:
            v = str(value)
        if self.validate is not None:
            err = self.validate(v)
            if err:
                raise ValueError(f"{self.name}: {err}")
        return v


def _positive(v):
    return None if v > 0 else "must be positive"


SYSTEM_SESSION_PROPERTIES = {p.name: p for p in [
    PropertyMetadata("query_max_run_time", "Maximum query run time in seconds",
                     "double", 3600.0, _positive),
    PropertyMetadata("join_distribution_type",
                     "AUTOMATIC | PARTITIONED | BROADCAST (reference: "
                     "DetermineJoinDistributionType.java:51)", "varchar", "AUTOMATIC",
                     lambda v: None if str(v).upper() in
                     ("AUTOMATIC", "PARTITIONED", "BROADCAST")
                     else "must be AUTOMATIC, PARTITIONED or BROADCAST"),
    PropertyMetadata("task_concurrency", "Local parallelism hint", "integer", 8,
                     _positive),
    PropertyMetadata("hash_partition_count",
                     "Number of partitions for distributed hash exchanges "
                     "(reference: DeterminePartitionCount.java:88)", "integer", 8,
                     _positive),
    PropertyMetadata("group_by_capacity",
                     "Initial group-by hash table capacity (0 = stats-derived)",
                     "integer", 0, lambda v: None if v >= 0 else "must be >= 0"),
    PropertyMetadata("dynamic_filtering_enabled",
                     "Prune probe-side splits from join build domains "
                     "(reference: DynamicFilterService)", "boolean", True),
    PropertyMetadata("spill_enabled",
                     "Allow partitioned re-execution when state exceeds device "
                     "memory (reference: spiller/*)", "boolean", True),
    PropertyMetadata("query_priority", "Scheduling priority", "integer", 1, _positive),
    PropertyMetadata("dispatch_batch",
                     "Coalesce up to K shape-uniform scan splits into one "
                     "device dispatch (0 = engine default from "
                     "TRINO_TPU_DISPATCH_BATCH, 1 = exact per-split "
                     "execution).  Plan-shaping: rides the plan-cache key",
                     "integer", 0, lambda v: None if v >= 0 else "must be >= 0"),
    PropertyMetadata("page_cache",
                     "Serve scans / join builds from the device buffer pool "
                     "(execution/bufferpool; pool budget from "
                     "TRINO_TPU_PAGE_CACHE).  NON-plan-shaping: flipping it "
                     "never re-plans or re-compiles", "boolean", True),
    PropertyMetadata("result_cache",
                     "Serve repeated deterministic statements from the "
                     "buffer pool's result tier (execution/bufferpool; tier "
                     "budget from TRINO_TPU_RESULT_CACHE).  NON-plan-"
                     "shaping: flipping it never re-plans or re-compiles",
                     "boolean", True),
    PropertyMetadata("adaptive_execution",
                     "Let the adaptive advisor (execution/adaptive) divert "
                     "statements to history-corrected plans (env default "
                     "TRINO_TPU_ADAPTIVE).  Plan-shaping: rides the "
                     "plan-cache key, so flipping it escapes (or re-enters) "
                     "the corrected plan", "boolean", True),
    PropertyMetadata("query_max_memory",
                     "Per-query device memory limit in bytes (0 = node limit "
                     "only; reference: query.max-memory + "
                     "ExceededMemoryLimitException)", "integer", 0,
                     lambda v: None if v >= 0 else "must be >= 0"),
]}


class SessionPropertyManager:
    def __init__(self, catalog: Optional[dict] = None):
        self.catalog = dict(catalog or SYSTEM_SESSION_PROPERTIES)

    def set_property(self, session, name: str, value) -> None:
        meta = self.catalog.get(name)
        if meta is None:
            raise ValueError(f"Session property '{name}' does not exist")
        session.properties[name] = meta.parse(value)

    def reset_property(self, session, name: str) -> None:
        if name not in self.catalog:
            raise ValueError(f"Session property '{name}' does not exist")
        session.properties.pop(name, None)

    def get(self, session, name: str):
        meta = self.catalog.get(name)
        if meta is None:
            raise ValueError(f"Session property '{name}' does not exist")
        return session.properties.get(name, meta.default)

    def rows(self, session) -> list[tuple]:
        """(name, value, default, type, description) — SHOW SESSION."""
        out = []
        for name in sorted(self.catalog):
            m = self.catalog[name]
            v = session.properties.get(name, m.default)
            out.append((name, str(v), str(m.default), m.type, m.description))
        return out
