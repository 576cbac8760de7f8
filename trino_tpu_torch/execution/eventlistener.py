"""Event listener SPI: query lifecycle events fan out to registered listeners.

Reference: spi/eventlistener/EventListener.java + QueryCreatedEvent /
QueryCompletedEvent / SplitCompletedEvent (spi/eventlistener/
QueryCompletedEvent.java), dispatched by eventlistener/EventListenerManager.java:56.
Listener failures never fail the query (reference behavior).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

__all__ = ["EventListener", "EventListenerManager", "QueryCreatedEvent",
           "QueryCompletedEvent", "SplitCompletedEvent"]


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str
    catalog: Optional[str]
    create_time_s: float


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    sql: str
    user: str
    catalog: Optional[str]
    state: str  # FINISHED | FAILED | CANCELED
    create_time_s: float
    end_time_s: float
    wall_s: Optional[float]
    rows: Optional[int]
    error: Optional[str]
    # device-boundary profile of the statement (QueryCounters.as_dict(),
    # including per-site attribution and the dispatch-latency histogram);
    # None for statements that executed no plan (DDL, SET SESSION).
    # Reference: QueryCompletedEvent.statistics (QueryStatistics carries
    # cpu/scheduled time and operator summaries)
    counters: Optional[dict] = None
    # duration of the query's root tracing span (parse->results, seconds)
    root_span_s: Optional[float] = None
    # round 15: the statement's est-vs-actual cardinality record —
    # {"fingerprint": <short plan fingerprint>, "nodes": {node_path ->
    # {op, est_rows, actual_rows, wall_s, spilled_bytes, ...}}}, the same
    # per-execution payload engine.plan_history merged.  None for DDL,
    # non-local execution paths, or a disabled history store.
    plan_actuals: Optional[dict] = None
    # the adaptive advisor's admission-time decision for the statement
    # (verdict, corrections, predicted win and price, reasons), or None
    adaptive: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class SplitCompletedEvent:
    query_id: str
    table: str
    split: object
    rows: int
    wall_s: float


class EventListener:
    """Subclass and override any subset (reference: EventListener default methods)."""

    def query_created(self, event: QueryCreatedEvent) -> None:  # noqa: B027
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:  # noqa: B027
        pass

    def split_completed(self, event: SplitCompletedEvent) -> None:  # noqa: B027
        pass


class EventListenerManager:
    def __init__(self):
        self.listeners: list[EventListener] = []

    def add(self, listener: EventListener) -> None:
        self.listeners.append(listener)

    def _fire(self, method: str, event) -> None:
        for l in self.listeners:
            try:
                getattr(l, method)(event)
            except Exception:
                pass  # listener errors never fail the query

    def query_created(self, qsm) -> None:
        self._fire("query_created", QueryCreatedEvent(
            qsm.query_id, qsm.sql, qsm.user, qsm.catalog, qsm.created_s))

    def query_completed(self, qsm) -> None:
        info = qsm.info()
        self._fire("query_completed", QueryCompletedEvent(
            qsm.query_id, qsm.sql, qsm.user, qsm.catalog, info.state,
            qsm.created_s, qsm.ended_s or time.time(), info.wall_s, info.rows,
            qsm.error,
            counters=getattr(qsm, "counters", None),
            root_span_s=getattr(qsm, "root_span_duration_s", None),
            plan_actuals=getattr(qsm, "plan_actuals", None),
            adaptive=getattr(qsm, "adaptive", None)))
