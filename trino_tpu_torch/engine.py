"""Engine facade of the PyTorch port (counterpart of ``trino_tpu/engine.py``, slim):
catalogs + session + the SELECT entry point.

``execute_sql`` parses, plans with the planner copied from the reference
(``Planner(self, session).plan_query``) and runs the plan on one device
through ``LocalExecutor``.  The reference's services (result and plan caches,
buffer pool, plan templates, batching, adaptive advice, history, flight
recorder, fault-tolerant and distributed execution) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["Engine", "Session"]


@dataclasses.dataclass
class Session:
    catalog: Optional[str] = None
    schema: Optional[str] = None
    user: str = "user"
    properties: dict = dataclasses.field(default_factory=dict)


def _resolve_device(device) -> torch.device:
    """``None`` means the card; without one the caller must ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run trino_tpu_torch on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


class Engine:
    def __init__(self, device=None):
        from .memory import MemoryPool

        self.device = _resolve_device(device)
        self.catalogs: dict = {}
        self.memory_pool = MemoryPool(device=self.device)
        # device -> host reads and bytes of the most recent execute_sql (its
        # plan-time subqueries included) or bare execute_plan
        self.last_query_counters: dict = {}
        self._sql_totals: Optional[dict] = None

    def register_catalog(self, name: str, connector) -> None:
        """Register a connector; one without a device generates on the engine's."""
        if getattr(connector, "device", False) is None:
            connector.device = self.device
        self.catalogs[name] = connector

    def create_session(self, catalog: Optional[str] = None,
                       schema: str = "default") -> Session:
        return Session(catalog=catalog, schema=schema)

    def execute_plan(self, plan, cache: bool = True):
        """Run a plan to a host-side ``MaterializedResult`` (also the
        planner's entry point for eager subqueries, which pass
        ``cache=False``; the port keeps no plan caches either way)."""
        from .exec.local_executor import LocalExecutor

        ex = LocalExecutor(self.catalogs, self.device, memory_pool=self.memory_pool)
        try:
            return ex.execute(plan)
        finally:
            self.last_query_counters = {"host_reads": ex.host_reads,
                                        "host_bytes": ex.host_bytes}
            if self._sql_totals is not None:
                for k, v in self.last_query_counters.items():
                    self._sql_totals[k] += v

    def execute_sql(self, sql: str, session: Optional[Session] = None):
        """SELECT entry point: parse -> plan -> execute."""
        from .sql import parser as A
        from .sql.frontend import Planner

        sess = session or Session()
        ast = A.parse(sql)
        if not isinstance(ast, (A.Select, A.SetOp)):
            raise NotImplementedError(
                f"{type(ast).__name__} statements are not ported to trino_tpu_torch")
        self._sql_totals = totals = {"host_reads": 0, "host_bytes": 0}
        try:
            # scalar and EXISTS subqueries execute while the query plans
            plan = Planner(self, sess).plan_query(ast)
            return self.execute_plan(plan)
        finally:
            self._sql_totals = None
            self.last_query_counters = totals
