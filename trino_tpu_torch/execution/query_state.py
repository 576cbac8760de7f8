"""Query lifecycle: state machine, per-query info, tracker.

Reference: execution/QueryState.java:21-58 (QUEUED → WAITING_FOR_RESOURCES →
DISPATCHING → PLANNING → STARTING → RUNNING → FINISHING → FINISHED/FAILED),
execution/QueryStateMachine.java, execution/QueryTracker.java (expiration).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Optional

from .statemachine import StateMachine

__all__ = ["QueryState", "QueryStateMachine", "QueryInfo", "QueryTracker"]


class QueryState(enum.Enum):
    QUEUED = "QUEUED"
    WAITING_FOR_RESOURCES = "WAITING_FOR_RESOURCES"
    DISPATCHING = "DISPATCHING"
    PLANNING = "PLANNING"
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    FINISHING = "FINISHING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


TERMINAL_STATES = {QueryState.FINISHED, QueryState.FAILED, QueryState.CANCELED}


@dataclasses.dataclass
class QueryInfo:
    """Snapshot surfaced by system.runtime.queries and the client protocol
    (reference: execution/QueryInfo.java, heavily reduced)."""

    query_id: str
    sql: str
    state: str
    user: str
    catalog: Optional[str]
    created_s: float
    started_s: Optional[float]
    ended_s: Optional[float]
    error: Optional[str]
    rows: Optional[int]
    wall_s: Optional[float]
    resource_group: Optional[str] = None
    # wall since CREATION (queued time included) — still ticking for live
    # queries; wall_s above only starts at RUNNING
    elapsed_s: Optional[float] = None

    @property
    def queued_s(self) -> Optional[float]:
        if self.started_s is None:
            return None
        return self.started_s - self.created_s


class QueryStateMachine:
    def __init__(self, query_id: str, sql: str, user: str = "user",
                 catalog: Optional[str] = None, resource_group: Optional[str] = None):
        self.query_id = query_id
        self.sql = sql
        self.user = user
        self.catalog = catalog
        self.resource_group = resource_group
        self.created_s = time.time()
        self.started_s: Optional[float] = None
        self.ended_s: Optional[float] = None
        self.error: Optional[str] = None
        self.rows: Optional[int] = None
        # device-boundary profile set at completion by the engine
        # (QueryCounters.as_dict(); None for statements that executed no
        # plan) — system.runtime.queries falls back to it once the live
        # counters deregister
        self.counters: Optional[dict] = None
        self.root_span_duration_s: Optional[float] = None
        self.machine: StateMachine[QueryState] = StateMachine(
            f"query {query_id}", QueryState.QUEUED, TERMINAL_STATES)

    # transitions (reference: QueryStateMachine.transitionTo*) -----------------
    def transition(self, state: QueryState) -> bool:
        if state == QueryState.RUNNING and self.started_s is None:
            self.started_s = time.time()
        if state in TERMINAL_STATES and self.ended_s is None:
            self.ended_s = time.time()
        return self.machine.set(state)

    def fail(self, error: str) -> bool:
        self.error = error
        return self.transition(QueryState.FAILED)

    def cancel(self) -> bool:
        return self.transition(QueryState.CANCELED)

    @property
    def state(self) -> QueryState:
        return self.machine.get()

    @property
    def is_done(self) -> bool:
        return self.machine.is_terminal

    def info(self) -> QueryInfo:
        wall = None
        if self.started_s is not None:
            wall = (self.ended_s or time.time()) - self.started_s
        return QueryInfo(
            query_id=self.query_id, sql=self.sql, state=self.state.value,
            user=self.user, catalog=self.catalog, created_s=self.created_s,
            started_s=self.started_s, ended_s=self.ended_s, error=self.error,
            rows=self.rows, wall_s=wall, resource_group=self.resource_group,
            elapsed_s=(self.ended_s or time.time()) - self.created_s)


class QueryTracker:
    """Holds live + recently-finished queries with bounded history
    (reference: execution/QueryTracker.java — expiration by age and count)."""

    def __init__(self, max_history: int = 200):
        self.max_history = max_history
        self._queries: dict[str, QueryStateMachine] = {}
        self._lock = threading.Lock()

    def register(self, q: QueryStateMachine) -> None:
        with self._lock:
            self._queries[q.query_id] = q
            done = [k for k, v in self._queries.items() if v.is_done]
            excess = len(done) - self.max_history
            for k in done[:max(excess, 0)]:
                del self._queries[k]

    def get(self, query_id: str) -> Optional[QueryStateMachine]:
        with self._lock:
            return self._queries.get(query_id)

    def all_queries(self) -> list[QueryStateMachine]:
        with self._lock:
            return list(self._queries.values())
