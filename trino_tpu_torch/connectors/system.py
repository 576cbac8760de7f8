"""System connector of the PyTorch port (counterpart of
``trino_tpu/connectors/system.py``): engine runtime state as queryable tables.

Reference: connector/system/ (GlobalSystemConnector) — system.runtime.queries,
system.runtime.nodes, system.metadata.catalogs etc., backed live by coordinator
state.  Flat table namespace here: `queries`, `nodes`, `catalogs`, `tables`,
`resource_groups`, `query_log`, `compilations`, `plan_history`; and
`InformationSchemaConnector`'s `schemata`, `tables`, `columns`, `views`.

Pages are built fresh per scan as torch tensors on the engine's device,
padded to power-of-two buckets as in the reference.  String columns keep ONE
persistent Dictionary per column whose values array grows in place — plans
keep decoding correctly.  `query_log` reads the flight recorder and
`compilations` the compile log (kernel builds in the port); their counter
columns carry the port's own counters under the reference's names, as
``/v1/metrics`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..page import Field, Page, Schema
from ..types import BIGINT, DOUBLE, VarcharType, torch_dtype
from .tpch import Dictionary

__all__ = ["SystemConnector", "InformationSchemaConnector"]

_V = VarcharType.of(None)

SCHEMAS = {
    "queries": Schema((
        Field("query_id", _V), Field("state", _V), Field("user", _V),
        Field("catalog", _V), Field("resource_group", _V), Field("query", _V),
        Field("rows", BIGINT), Field("queued_s", DOUBLE), Field("wall_s", DOUBLE),
        Field("error", _V),
        # boundary spend visible to SQL clients: live counters for running
        # queries (execution/tracing), the completion snapshot afterwards
        # (device_dispatches: kernel launches plus host reads); elapsed_s
        # ticks from creation
        Field("device_dispatches", BIGINT), Field("host_bytes_pulled", BIGINT),
        Field("elapsed_s", DOUBLE),
        # statements answered whole from the result tier (result_cache_hits
        # > 0: no launch, no host read)
        Field("result_cache_hits", BIGINT),
    )),
    "nodes": Schema((
        Field("node_id", _V), Field("http_uri", _V), Field("node_version", _V),
        Field("coordinator", BIGINT), Field("state", _V),
    )),
    "catalogs": Schema((
        Field("catalog_name", _V), Field("connector_name", _V),
    )),
    "tables": Schema((
        Field("table_catalog", _V), Field("table_name", _V), Field("table_rows", BIGINT),
    )),
    "resource_groups": Schema((
        Field("name", _V), Field("running", BIGINT), Field("queued", BIGINT),
        Field("hard_concurrency_limit", BIGINT), Field("max_queued", BIGINT),
        Field("scheduling_weight", BIGINT),
    )),
    # the flight recorder (execution/flightrecorder.py): one row per
    # recorded statement, completed or errored, with its counters and the
    # wall breakdown flattened into per-bucket seconds (NULL buckets: no
    # breakdown could be established, never a fabricated zero).  The skew
    # columns are NULL on one device
    "query_log": Schema((
        Field("query_id", _V), Field("state", _V), Field("query", _V),
        Field("user", _V), Field("error", _V),
        Field("wall_s", DOUBLE), Field("queued_s", DOUBLE),
        Field("device_dispatches", BIGINT), Field("host_transfers", BIGINT),
        Field("host_bytes_pulled", BIGINT),
        Field("compiles", BIGINT),
        Field("faults_injected", BIGINT), Field("task_retries", BIGINT),
        Field("pressure_rung", _V), Field("spans", BIGINT),
        Field("plan_s", DOUBLE), Field("compile_s", DOUBLE),
        Field("split_generation_s", DOUBLE),
        Field("h2d_s", DOUBLE), Field("device_dispatch_s", DOUBLE),
        Field("host_pull_s", DOUBLE), Field("exchange_wait_s", DOUBLE),
        Field("retry_backoff_s", DOUBLE), Field("unattributed_s", DOUBLE),
        Field("skew_ratio", DOUBLE), Field("skew_imbalance_s", DOUBLE),
    )),
    # the compile log (execution/tracing.CompileLog): one row per retained
    # kernel build, the kernel wrapper that triggered it, the query that
    # paid it, the library's source digest, its nvcc seconds and its bytes
    "compilations": Schema((
        Field("site", _V), Field("label", _V), Field("query_id", _V),
        Field("signature", _V), Field("duration_s", DOUBLE),
        Field("exe_bytes", BIGINT), Field("recorded_at", DOUBLE),
    )),
    # the plan-actuals history (execution/history.py): one row per recorded
    # plan node, merged across executions; est_rows is NULL where the CBO
    # could not estimate the node
    "plan_history": Schema((
        Field("fingerprint", _V), Field("node_path", _V), Field("op", _V),
        Field("plan_executions", BIGINT), Field("executions", BIGINT),
        Field("est_rows", DOUBLE), Field("actual_rows", BIGINT),
        Field("actual_rows_ewma", DOUBLE),
        Field("misestimate_ratio", DOUBLE), Field("direction", _V),
        Field("wall_s", DOUBLE), Field("spilled_bytes", BIGINT),
        Field("cache_hits", BIGINT),
    )),
}


@dataclasses.dataclass(frozen=True)
class SystemSplit:
    table: str


class _Growable:
    """value<->id map exposing ONE Dictionary whose array grows in place."""

    def __init__(self):
        self.ids: dict = {}
        self.values: list = []
        self.dictionary = Dictionary(values=np.array([""], dtype=object))

    def encode(self, vals):
        out = np.empty(len(vals), np.int32)
        grew = False
        for i, v in enumerate(vals):
            if v is None:
                out[i] = 0
                continue
            v = str(v)
            ix = self.ids.get(v)
            if ix is None:
                ix = len(self.values)
                self.ids[v] = ix
                self.values.append(v)
                grew = True
            out[i] = ix
        if grew or len(self.dictionary.values) != max(len(self.values), 1):
            self.dictionary.values = np.array(self.values or [""], dtype=object)
        return out


class SystemConnector:
    name = "system"

    def __init__(self, engine):
        self.engine = engine
        self.device = engine.device
        self._dicts: dict = {}  # (table, column) -> _Growable

    # -- metadata ----------------------------------------------------------------
    def tables(self):
        return sorted(SCHEMAS)

    def schema(self, table: str) -> Schema:
        return SCHEMAS[table]

    def dictionaries(self, table: str) -> dict:
        # encode the CURRENT rows first: string literals in predicates resolve to
        # dictionary ids at plan time, so values must be present before planning.
        # Growth is serialized under the engine's plan lock: statements on
        # several threads encode into one dictionary.
        with self.engine._plan_lock:
            rows = self._rows(table)
            schema = self.schema(table)
            out = {}
            for ci, f in enumerate(schema.fields):
                if f.type.is_string:
                    g = self._growable(table, f.name)
                    g.encode([r[ci] for r in rows])
                    out[f.name] = g.dictionary
            return out

    def _growable(self, table, column) -> _Growable:
        g = self._dicts.get((table, column))
        if g is None:
            g = _Growable()
            self._dicts[(table, column)] = g
        return g

    def plan_version(self) -> int:
        """Growable dictionaries grow in place across queries, while a cached
        plan embeds string-predicate tables sized to the dictionary at plan
        time: a new id would gather past them.  The engine keys its plan
        cache on this value, so any growth replans the plans that read
        these tables."""
        return sum(len(g.values) for g in self._dicts.values())

    def row_count(self, table: str) -> int:
        return len(self._rows(table))

    def column_range(self, table: str, column: str):
        return (None, None)

    def splits(self, table: str, n_hint: int = 0):
        return [SystemSplit(table)]

    # -- data --------------------------------------------------------------------
    def _rows(self, table: str) -> list[tuple]:
        e = self.engine
        if table == "queries":
            from ..execution.tracing import live_query_counters

            live = live_query_counters()
            out = []
            for q in e.query_tracker.all_queries():
                i = q.info()
                c = live.get(i.query_id) or getattr(q, "counters", None) or {}
                out.append((i.query_id, i.state, i.user, i.catalog, i.resource_group,
                            i.sql, i.rows, i.queued_s, i.wall_s, i.error,
                            c.get("device_dispatches"),
                            c.get("host_bytes_pulled"), i.elapsed_s,
                            c.get("result_cache_hits")))
            return out
        if table == "nodes":
            # the engine's one device (the port runs on one card)
            dev = torch.device(self.device)
            return [(f"{dev.type}-{dev.index or 0}", "local://in-process",
                     "trino-tpu-0.1", 1, "active")]
        if table == "catalogs":
            return [(name, getattr(c, "name", type(c).__name__))
                    for name, c in sorted(e.catalogs.items())]
        if table == "tables":
            out = []
            for cname, c in sorted(e.catalogs.items()):
                for t in c.tables():
                    try:
                        n = c.row_count(t)
                    except Exception:
                        n = None
                    out.append((cname, t, n))
            return out
        if table == "resource_groups":
            return [(g["name"], g["running"], g["queued"], g["hard_concurrency_limit"],
                     g["max_queued"], g["scheduling_weight"])
                    for g in e.resource_groups.info()]
        if table == "query_log":
            out = []
            for rec in e.flight_recorder.snapshot(kind="query"):
                c = rec.get("counters") or {}
                bd = rec.get("wall_breakdown") or {}
                shard = rec.get("shard_stats") or c.get("shard_stats") or []
                skew_ratio = skew_imb = None
                if shard:
                    skew_ratio = max(float(x.get("ratio") or 1.0) for x in shard)
                    skew_imb = sum(float(x.get("imbalance_s") or 0.0) for x in shard)
                out.append((
                    rec.get("query_id"), rec.get("state"), rec.get("sql"),
                    rec.get("user"), rec.get("error"),
                    rec.get("wall_s"), rec.get("queued_s"),
                    c.get("device_dispatches"), c.get("host_transfers"),
                    c.get("host_bytes_pulled"), c.get("compiles"),
                    c.get("faults_injected"), c.get("task_retries"),
                    rec.get("pressure_rung"),
                    len((rec.get("trace") or {}).get("spans") or ()),
                    bd.get("plan"), bd.get("compile"), bd.get("split_generation"),
                    bd.get("h2d"), bd.get("device_dispatch"), bd.get("host_pull"),
                    bd.get("exchange_wait"), bd.get("retry_backoff"),
                    bd.get("unattributed"), skew_ratio, skew_imb))
            return out
        if table == "compilations":
            return [(r.get("site"), r.get("label"), r.get("query_id"), r.get("signature"),
                     r.get("duration_s"), r.get("exe_bytes"), r.get("at"))
                    for r in e.compile_log.snapshot()]
        if table == "plan_history":
            ph = getattr(e, "plan_history", None)
            if ph is None:
                return []
            return [(r["fingerprint"], r["node_path"], r["op"],
                     r["plan_executions"], r["executions"], r["est_rows"],
                     r["actual_rows"], r["actual_rows_ewma"],
                     r["misestimate_ratio"], r["direction"], r["wall_s"],
                     r["spilled_bytes"], r["cache_hits"])
                    for r in ph.rows()]
        raise KeyError(table)

    def generate(self, split: SystemSplit, columns=None) -> Page:
        with self.engine._plan_lock:  # growth serialized (see dictionaries)
            return self._generate_locked(split, columns)

    def _generate_locked(self, split: SystemSplit, columns=None) -> Page:
        schema = self.schema(split.table)
        names = columns if columns is not None else schema.names
        rows = self._rows(split.table)
        n = len(rows)
        cap = max(1 << max(n - 1, 1).bit_length(), 16)  # pow2 bucket, min 16
        out_schema = Schema(tuple(schema.field(c) for c in names))
        cols, nulls = [], []
        for cname in names:
            ci = schema.index(cname)
            f = schema.fields[ci]
            vals = [r[ci] for r in rows]
            nullmask = np.array([v is None for v in vals] + [True] * (cap - n))
            if f.type.is_string:
                ids = self._growable(split.table, cname).encode(vals)
                arr = np.zeros(cap, np.int32)
                arr[:n] = ids
            else:
                arr = np.zeros(cap, f.type.dtype)
                arr[:n] = [0 if v is None else v for v in vals]
            dev = self.device
            cols.append(torch.as_tensor(arr, dtype=torch_dtype(f.type), device=dev))
            nulls.append(torch.as_tensor(nullmask, device=dev) if nullmask.any() else None)
        valid = torch.as_tensor(np.arange(cap) < n, device=self.device)
        return Page(out_schema, tuple(cols), tuple(nulls), valid)


# ---------------------------------------------------------------------------- information_schema
IS_SCHEMAS = {
    "schemata": Schema((
        Field("catalog_name", _V), Field("schema_name", _V),
    )),
    "tables": Schema((
        Field("table_catalog", _V), Field("table_schema", _V),
        Field("table_name", _V), Field("table_type", _V),
    )),
    "columns": Schema((
        Field("table_catalog", _V), Field("table_schema", _V),
        Field("table_name", _V), Field("column_name", _V),
        Field("ordinal_position", BIGINT), Field("data_type", _V),
        Field("is_nullable", _V),
    )),
    "views": Schema((
        Field("table_catalog", _V), Field("table_name", _V),
    )),
}


class InformationSchemaConnector(SystemConnector):
    """ANSI information_schema over the engine's catalogs (reference:
    connector/informationschema/InformationSchemaMetadata — per-catalog there,
    one flat catalog here to match the engine's flat namespace; the surface BI
    tools introspect: schemata/tables/columns/views)."""

    name = "information_schema"

    def tables(self):
        return sorted(IS_SCHEMAS)

    def schema(self, table: str) -> Schema:
        return IS_SCHEMAS[table]

    def _rows(self, table: str) -> list:
        e = self.engine
        cats = sorted((n, c) for n, c in e.catalogs.items())
        if table == "schemata":
            return [(name, "default") for name, _ in cats]
        if table == "tables":
            out = []
            for name, c in cats:
                for t in sorted(c.tables()):
                    out.append((name, "default", t, "BASE TABLE"))
            for v in sorted(getattr(e, "views", ())):
                out.append(("", "default", v, "VIEW"))
            return out
        if table == "columns":
            out = []
            for name, c in cats:
                for t in sorted(c.tables()):
                    try:
                        sch = c.schema(t)
                    except Exception:
                        continue  # discovery failure must not hide the rest
                    for i, f in enumerate(sch.fields, 1):
                        out.append((name, "default", t, f.name, i,
                                    f.type.name, "YES"))
            return out
        if table == "views":
            return [("", v) for v in sorted(getattr(e, "views", ()))]
        raise KeyError(table)
