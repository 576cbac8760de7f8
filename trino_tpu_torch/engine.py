"""Engine facade of the PyTorch port (counterpart of ``trino_tpu/engine.py``, slim):
catalogs, sessions, the control plane and the statement entry point.

``execute_sql`` is the coordinator's entry path, as in the reference: the
access check, a query id, admission through the resource groups, the query
state machine, listener events and the ``query`` / ``planner`` /
``execution`` spans around parse -> plan -> execute.  SELECTs are planned with
the planner copied from the reference (``Planner(self, session).plan_query``)
and run on one device through ``LocalExecutor``.  Every other statement goes
to ``_execute_statement``: PREPARE / EXECUTE / DEALLOCATE, SET / RESET
SESSION, SHOW, EXPLAIN [ANALYZE], GRANT / REVOKE, views, SQL routines,
tables (CREATE, CTAS, INSERT, DROP), materialized views and row-level DML
(DELETE, UPDATE, MERGE) over a writable catalog such as
``connectors/memory.MemoryConnector``.  DDL returns ``None`` and DML the
affected-row count, as in the reference.  ``engine.access_control`` (allow-all
by default, ``spi/security.py``) is consulted where the reference consults it.

Accounting is per statement and per thread: each statement counts its host
reads, their bytes, its H2D bytes and its kernel launches in its own
``QueryCounters`` (``execution/tracing.py``) on the thread that runs it, and
publishes them there (``last_query_counters``, ``last_query_trace``), so
statements running at once on several threads (the server's dispatch pool)
never read each other's counts.  ``counters_total`` sums every statement for
``/v1/metrics``.

Writes are vectorised with numpy where the reference walks python lists:
a query result whose column type equals the target's is written from its
raw (storage-form) columns, and the per-value coercion of the reference
(``_coerce_host``) runs only where a coercion happens (``INSERT ... VALUES``,
mismatched types).

Not ported: the reference's plan, result and buffer caches that its
``_invalidate`` clears, plan templates (EXECUTE always substitutes its
parameters as literals), batching, adaptive execution, plan history, the
flight recorder, the memory ladder, fault-tolerant and distributed execution.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Optional

import numpy as np
import torch

__all__ = ["Engine", "Session"]

_query_ids = itertools.count(1)


@dataclasses.dataclass
class Session:
    catalog: Optional[str] = None
    schema: Optional[str] = None
    user: str = "user"
    properties: dict = dataclasses.field(default_factory=dict)
    prepared: dict = dataclasses.field(default_factory=dict)  # name -> sql text


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
        from .connectors.system import InformationSchemaConnector, SystemConnector
        from .execution.eventlistener import EventListenerManager
        from .execution.query_state import QueryTracker
        from .execution.resourcegroups import ResourceGroupManager
        from .execution.session_properties import SessionPropertyManager
        from .execution.tracing import QueryCounters, Tracer
        from .memory import MemoryPool
        from .spi.security import AllowAllAccessControl

        self.device = _resolve_device(device)
        self.catalogs: dict = {}
        self.sql_routines: dict = {}  # name -> (params, return_type, body AST)
        self.views: dict = {}  # name -> (column_aliases, Select AST)
        # name -> {"query": AST, "storage": table, "catalog": name,
        # "session_catalog": name}
        self.materialized_views: dict = {}
        self.memory_pool = MemoryPool(device=self.device)
        self._totals_lock = threading.Lock()  # guards counters_total
        # serializes the system connector's dictionary growth (RLock: the
        # planner asks for dictionaries while a scan of the same table may
        # hold it on this thread)
        self._plan_lock = threading.RLock()
        # control plane (reference: DispatchManager + QueryTracker + resource
        # groups + EventListenerManager + TracingModule)
        self.query_tracker = QueryTracker()
        self.resource_groups = ResourceGroupManager()
        self.event_listeners = EventListenerManager()
        self.session_properties = SessionPropertyManager()
        self.tracer = Tracer()
        # every statement's counters summed, for /v1/metrics
        self.counters_total = QueryCounters()
        # per-thread slots: the running statement's counters (stmt) and the
        # last finished statement's counters (snap) and trace
        self._thread_accounting = threading.local()
        self.access_control = AllowAllAccessControl()
        # the system catalog is always present (reference: GlobalSystemConnector
        # registered at server bootstrap), and the information_schema BI tools
        # introspect
        self.catalogs["system"] = SystemConnector(self)
        self.catalogs["information_schema"] = InformationSchemaConnector(self)

    def register_catalog(self, name: str, connector) -> None:
        """Register a connector; one without a device works on the engine's."""
        if getattr(connector, "device", False) is None:
            connector.device = self.device
        self.catalogs[name] = connector

    def create_session(self, catalog: Optional[str] = None,
                       schema: str = "default") -> Session:
        return Session(catalog=catalog, schema=schema)

    # -- per-thread accounting (reference: Engine._thread_accounting) ------------
    @property
    def last_query_counters(self) -> dict:
        """Host reads and bytes, H2D bytes and kernel launches of the last
        ``execute_sql`` this thread ran (its plan-time subqueries and a
        statement's inner queries included), or of its last bare
        ``execute_plan``."""
        snap = getattr(self._thread_accounting, "snap", None)
        return {} if snap is None else snap.as_dict()

    @property
    def last_query_trace(self) -> dict:
        """{"query_id", "root_span_s", "spans", "wall_breakdown"} of the last
        statement this thread ran."""
        return getattr(self._thread_accounting, "trace", None) or {}

    def _account_counters(self, counters) -> None:
        """Fold one finished plan execution into the statement running on this
        thread, or, outside any statement, publish it and add it to the
        engine's totals."""
        acct = self._thread_accounting
        stmt = getattr(acct, "stmt", None)
        if stmt is not None:
            stmt.merge(counters)
            return
        with self._totals_lock:
            self.counters_total.merge(counters)
        acct.snap = counters

    def _run_plan(self, plan):
        """(result, counters) of one plan on a fresh executor."""
        from .exec.local_executor import LocalExecutor
        from .execution import tracing

        ex = LocalExecutor(self.catalogs, self.device, memory_pool=self.memory_pool)
        counters = tracing.QueryCounters()
        try:
            with tracing.track_counters(counters):
                return ex.execute(plan), counters
        finally:
            counters.host_reads += ex.host_reads
            counters.host_bytes += ex.host_bytes
            counters.h2d_bytes += ex.h2d_bytes
            self._account_counters(counters)

    def execute_plan(self, plan, cache: bool = True):
        """Run a plan to a host-side ``MaterializedResult`` (also the
        planner's entry point for eager subqueries, which pass
        ``cache=False``; the port keeps no plan caches either way)."""
        return self._run_plan(plan)[0]

    # -- introspection ------------------------------------------------------------
    def memory_info(self) -> list:
        """The memory pool's snapshot (labeled ``pool0``), with the card's
        allocator counters on a CUDA engine: the /v1/status and /v1/metrics
        pool surface."""
        d = self.memory_pool.info()
        d["pool"] = "pool0"
        if self.device.type == "cuda":
            st = torch.cuda.memory_stats(self.device)
            d["device_allocated_bytes"] = int(st.get("allocated_bytes.all.current", 0))
            d["device_reserved_bytes"] = int(st.get("reserved_bytes.all.current", 0))
            d["device_peak_allocated_bytes"] = int(st.get("allocated_bytes.all.peak", 0))
        return [d]

    def health(self) -> dict:
        """Live health verdict.  The port has no stall watchdog yet: always
        "ok", with the watchdog reported as disabled."""
        return {"status": "ok", "stalled": 0, "compiling": 0, "inflight": 0,
                "watchdog": {"enabled": False}}

    def _check_select_access(self, plan, user: str) -> None:
        """Every table the plan scans needs SELECT (reference: the analyzer's
        per-table checkCanSelectFromColumns during StatementAnalyzer)."""
        from .sql import plan as P

        storage_to_mv = {m["storage"]: name
                         for name, m in self.materialized_views.items()}

        def walk(n):
            if isinstance(n, P.TableScan) and not n.source_tables:
                # MV storage tables check under the MV's own name; scans of
                # virtual pushdown handles check their source_tables instead
                self.access_control.check_can_select(
                    user, n.catalog, storage_to_mv.get(n.table, n.table))
            for cat, tab in getattr(n, "source_tables", ()):
                self.access_control.check_can_select(
                    user, cat, storage_to_mv.get(tab, tab))
            for c in n.children:
                walk(c)

        walk(plan)

    # -- the statement entry point (reference: Engine.execute_sql) ---------------
    def execute_sql(self, sql: str, session: Optional[Session] = None,
                    parameters: Optional[list] = None):
        """Statement entry point (reference: DispatchManager.createQuery ->
        resource-group admission -> SqlQueryExecution for queries;
        coordinator-only tasks for the other statements).  Every statement
        moves through the query state machine and fires listener events.

        ``parameters`` is the protocol-level EXECUTE form: ``sql`` carries
        ``?`` markers and ``parameters`` the python values, substituted as
        literals."""
        from .execution import tracing
        from .execution.query_state import QueryState, QueryStateMachine

        sess = session or Session()
        acct = self._thread_accounting
        # cleared first: a statement that fails admission must not leave this
        # thread holding the previous statement's counters or trace
        acct.snap = None
        acct.trace = None
        self.access_control.check_can_execute_query(sess.user)
        qid = f"query_{next(_query_ids)}"
        group = self.resource_groups.get_or_create(f"global.{sess.user}")
        qsm = QueryStateMachine(qid, sql, sess.user, sess.catalog, group.full_name)
        self.query_tracker.register(qsm)
        self.event_listeners.query_created(qsm)
        admitted = threading.Event()
        self.resource_groups.submit(
            group, admitted.set,
            queued=lambda: qsm.transition(QueryState.WAITING_FOR_RESOURCES))
        admitted.wait()
        totals = tracing.QueryCounters()
        outer = getattr(acct, "stmt", None)
        acct.stmt = totals
        try:
            qsm.transition(QueryState.DISPATCHING)
            with tracing.query_scope(qid), tracing.activate_tracer(self.tracer), \
                    tracing.track_counters(totals), \
                    self.tracer.span("query", trace_id=qid, sql=sql):
                result = self._execute_admitted(sql, sess, qsm, parameters)
            if result is not None and hasattr(result, "__len__"):
                qsm.rows = len(result)
            qsm.transition(QueryState.FINISHING)
            qsm.transition(QueryState.FINISHED)
            return result
        except BaseException as e:
            qsm.fail(str(e))
            raise
        finally:
            acct.stmt = outer
            with self._totals_lock:
                self.counters_total.merge(totals)
            acct.snap = totals
            root = self._finish_query_trace(qid, queued_s=qsm.info().queued_s or 0)
            qsm.counters = totals.as_dict()
            qsm.root_span_duration_s = root.duration_s if root else None
            self.resource_groups.finish(group)
            self.event_listeners.query_completed(qsm)

    def _finish_query_trace(self, qid: str, queued_s: float = 0.0):
        """Publish the finished span tree on this thread as
        ``last_query_trace`` (span summaries and the wall-clock breakdown,
        what GET /v1/query/{id}/trace serves); returns the root span."""
        from .execution import tracing

        spans = self.tracer.spans_for(qid)
        root = next((s for s in spans if s.parent_id is None), None)
        trace = {"query_id": qid, "root_span_s": root.duration_s if root else None,
                 "spans": [tracing.span_dict(s) for s in spans]}
        bd = tracing.wall_breakdown(trace["spans"], queued_s=queued_s)
        if bd is not None:
            trace["wall_breakdown"] = bd
        self._thread_accounting.trace = trace
        return root

    def _execute_admitted(self, sql: str, sess: Session, qsm, parameters=None):
        from .execution.query_state import QueryState
        from .sql import parser as A
        from .sql.frontend import Planner

        if parameters is not None:
            # protocol-level EXECUTE: the values arrived out of band and
            # substitute as literals (the port has no plan templates)
            from .server.dbapi import _substitute
            from .sql import params as PRM

            vals = [PRM.literal_param_value(PRM.value_to_literal_ast(v))
                    for v in parameters]
            return self._execute_admitted(_substitute(sql, vals), sess, qsm)
        qsm.transition(QueryState.PLANNING)
        ast = A.parse(sql)
        if isinstance(ast, (A.Select, A.SetOp)):
            # scalar and EXISTS subqueries execute while the query plans
            with self.tracer.span("planner", trace_id=qsm.query_id):
                plan = Planner(self, sess).plan_query(ast)
            self._check_select_access(plan, sess.user)
            qsm.transition(QueryState.STARTING)
            qsm.transition(QueryState.RUNNING)
            with self.tracer.span("execution", trace_id=qsm.query_id):
                return self.execute_plan(plan)
        qsm.transition(QueryState.RUNNING)
        return self._execute_statement(ast, sess)

    # -- statements (reference: Engine._execute_statement) ----------------------
    def _execute_statement(self, ast, sess: Session):
        from .sql import parser as A

        kind = type(ast).__name__
        if isinstance(ast, A.Prepare):
            # session-scoped prepared statements (reference: QueryPreparer +
            # Session.preparedStatements; parameters substitute at EXECUTE)
            sess.prepared[ast.name] = ast.sql
            return None
        if isinstance(ast, A.ExecutePrepared):
            return self._execute_prepared(ast, sess)
        if isinstance(ast, A.Deallocate):
            if ast.name not in sess.prepared:
                raise ValueError(f"prepared statement {ast.name} not found")
            del sess.prepared[ast.name]
            return None
        if isinstance(ast, A.Delete):
            return self._delete(ast, sess)
        if isinstance(ast, A.Update):
            return self._update(ast, sess)
        if isinstance(ast, A.Merge):
            return self._merge(ast, sess)
        if isinstance(ast, A.SetSession):
            self.access_control.check_can_set_session_property(sess.user, ast.name)
            self.session_properties.set_property(sess, ast.name, ast.value)
            return None
        if isinstance(ast, A.ResetSession):
            self.session_properties.reset_property(sess, ast.name)
            return None
        if isinstance(ast, A.Show):
            return self._show(ast, sess)
        if isinstance(ast, A.Explain):
            if isinstance(ast.query, A.ExecutePrepared):
                return self._explain_execute(ast, sess)
            if not isinstance(ast.query, (A.Select, A.SetOp)):
                raise ValueError(
                    f"EXPLAIN of {type(ast.query).__name__} is not supported")
            return self._explain(ast, sess)
        if isinstance(ast, A.CreateView):
            if not ast.or_replace and ast.name in self.views:
                raise ValueError(f"view {ast.name} already exists")
            self.views[ast.name] = ((), ast.query)
            return None
        if isinstance(ast, A.CreateFunction):
            # inline SQL routine (reference: CreateFunctionTask + sql/routine/
            # SqlRoutineCompiler -- an expression body inlines at call sites)
            from .sql import functions as FN
            from .sql.frontend import AGG_FUNCS, Planner

            if FN.lookup(ast.name) is not None or ast.name in AGG_FUNCS \
                    or ast.name in Planner._COLLECTION_FUNCS:
                # built-ins resolve first at call sites, so a shadowing
                # routine would be silently dead: reject it up front
                raise ValueError(f"function {ast.name} conflicts with a built-in")
            if not ast.or_replace and ast.name in self.sql_routines:
                raise ValueError(f"function {ast.name} already exists")
            self.sql_routines[ast.name] = (ast.params, ast.return_type, ast.body)
            return None
        if isinstance(ast, A.DropFunction):
            if ast.name not in self.sql_routines and not ast.if_exists:
                raise ValueError(f"function {ast.name} does not exist")
            self.sql_routines.pop(ast.name, None)
            return None
        if isinstance(ast, A.DropView):
            if ast.name not in self.views and not ast.if_exists:
                raise ValueError(f"view {ast.name} does not exist")
            self.views.pop(ast.name, None)
            return None
        if isinstance(ast, A.CreateTable):
            return self._create_table(ast, sess)
        if isinstance(ast, A.InsertInto):
            return self._insert(ast, sess)
        if isinstance(ast, A.CreateMaterializedView):
            return self._create_materialized_view(ast, sess)
        if isinstance(ast, A.RefreshMaterializedView):
            return self._refresh_materialized_view(ast, sess)
        if isinstance(ast, A.DropMaterializedView):
            mv = self.materialized_views.get(ast.name)
            if mv is None:
                if ast.if_exists:
                    return None
                raise ValueError(f"materialized view {ast.name} does not exist")
            self.access_control.check_can_write(sess.user, mv["catalog"],
                                                ast.name, "drop table")
            del self.materialized_views[ast.name]
            self.catalogs[mv["catalog"]].drop_table(mv["storage"], True)
            return None
        if isinstance(ast, A.Grant):
            return self._grant(ast, sess)
        if isinstance(ast, A.DropTable):
            conn = self._writable_catalog(sess)
            self.access_control.check_can_write(
                sess.user, self._catalog_name_of(conn), ast.name, "drop table")
            conn.drop_table(ast.name, ast.if_exists)
            return None
        raise ValueError(f"unsupported statement {kind}")

    def _grant(self, ast, sess: Session):
        """GRANT / REVOKE on the table's catalog (reference: GrantTask,
        RevokeTask); the access control decides who may administer."""
        conn = None
        cat = sess.catalog
        if cat in self.catalogs and ast.table in self.catalogs[cat].tables():
            conn = self.catalogs[cat]
        else:
            for name, c in self.catalogs.items():
                if ast.table in c.tables():
                    cat, conn = name, c
                    break
        if conn is None:
            raise ValueError(f"table {ast.table!r} not found")
        op = self.access_control.revoke if ast.revoke else self.access_control.grant
        try:
            op(sess.user, ast.grantee, cat, ast.table, set(ast.privileges))
        except NotImplementedError as e:
            raise ValueError(str(e))
        return None

    def _execute_prepared(self, ast, sess: Session):
        """EXECUTE name [USING ...]: the parameters substitute as literals
        into the prepared text, which runs inside this statement (no second
        admission)."""
        from .server.dbapi import _substitute
        from .sql import params as PRM

        text = sess.prepared.get(ast.name)
        if text is None:
            raise ValueError(f"prepared statement {ast.name} not found")
        # literal extraction raises a typed error for unsupported parameter
        # AST kinds (sql/params) instead of silently mis-substituting
        vals = [PRM.literal_param_value(p) for p in ast.parameters]
        return self._run_sql_inline(_substitute(text, vals), sess)

    def _run_sql_inline(self, sql: str, sess: Session):
        """Run a statement without re-entering admission (EXECUTE runs inside
        the outer statement's resource-group slot)."""
        from .sql import parser as A
        from .sql.frontend import Planner

        ast = A.parse(sql)
        if not isinstance(ast, (A.Select, A.SetOp)):
            return self._execute_statement(ast, sess)
        plan = Planner(self, sess).plan_query(ast)
        self._check_select_access(plan, sess.user)
        return self.execute_plan(plan)

    def _show(self, ast, sess: Session):
        """SHOW SESSION/CATALOGS/SCHEMAS/TABLES/COLUMNS/STATS/CREATE TABLE/
        FUNCTIONS (reference: the ShowQueriesRewrite-backed SHOW statements
        over information_schema)."""
        from .exec.local_executor import MaterializedResult
        from .types import VarcharType

        def result(names, rows):
            cols = [np.array([r[i] for r in rows], dtype=object)
                    for i in range(len(names))]
            return MaterializedResult(tuple(names),
                                      tuple(VarcharType.of(None) for _ in names),
                                      cols, cols)

        def find_table(target):
            cat = sess.catalog
            if cat in self.catalogs and target in self.catalogs[cat].tables():
                return cat, self.catalogs[cat]
            for name, c in self.catalogs.items():
                if target in c.tables():
                    return name, c
            raise ValueError(f"table {target!r} not found")

        if ast.what == "session":
            return result(("name", "value", "default", "type", "description"),
                          self.session_properties.rows(sess))
        if ast.what == "catalogs":
            return result(("catalog",), [(c,) for c in sorted(self.catalogs)])
        if ast.what == "tables":
            conn = self.catalogs.get(sess.catalog)
            if conn is None:
                raise ValueError(f"catalog {sess.catalog!r} not found")
            names = sorted((set(conn.tables()) | set(self.views)
                            | set(self.materialized_views))
                           - {m["storage"] for m in self.materialized_views.values()})
            names = self.access_control.filter_tables(sess.user, sess.catalog, names)
            return result(("table",), [(t,) for t in names])
        if ast.what == "schemas":
            return result(("schema",), [(n,) for n in sorted(self.catalogs)])
        if ast.what == "columns":
            conn = self.catalogs.get(sess.catalog)
            if conn is None or ast.target not in conn.tables():
                raise ValueError(f"table {ast.target!r} not found")
            return result(("column", "type"),
                          [(f.name, f.type.name) for f in conn.schema(ast.target).fields])
        if ast.what == "stats":
            # reference: SHOW STATS FOR table -- the same TableStats the CBO
            # consumes (spi/statistics.py), per-column rows + summary row
            from .spi.statistics import connector_table_stats

            _, conn = find_table(ast.target)
            ts = connector_table_stats(conn, ast.target)
            fmt = lambda v: "" if v is None else (  # noqa: E731
                str(int(v)) if float(v).is_integer() else str(v))
            rows = []
            for f in conn.schema(ast.target).fields:
                cs = ts.column(f.name)
                rows.append((f.name, None if cs.ndv is None else fmt(cs.ndv),
                             fmt(cs.lo), fmt(cs.hi), ""))
            rows.append(("", None, "", "", fmt(ts.row_count)))
            return result(("column_name", "distinct_values_count", "low_value",
                           "high_value", "row_count"), rows)
        if ast.what == "create_table":
            cat, conn = find_table(ast.target)
            cols = ",\n".join(f"   {f.name} {f.type.name}"
                               for f in conn.schema(ast.target).fields)
            return result(("create table",), [(f"CREATE TABLE {cat}.{ast.target} (\n"
                                               f"{cols}\n)",)])
        if ast.what == "functions":
            # one source of truth: the function registry
            from .sql import functions as FN

            FN.ensure_legacy_registered()
            rows = FN.catalog_rows()
            for name, (params, rt, _body) in sorted(self.sql_routines.items()):
                rows.append((name, "routine", str(len(params)),
                             f"SQL routine returning {rt[0]}"))
            return result(("function", "category", "arity", "description"), rows)
        raise ValueError(f"unsupported SHOW {ast.what!r}")

    def _explain(self, ast, sess: Session):
        """EXPLAIN renders the physical plan (the distribution pass's
        Exchange markers included); EXPLAIN ANALYZE runs the plan and adds
        its counters, wall breakdown and timing."""
        import time

        from .exec.local_executor import MaterializedResult
        from .sql.frontend import Planner
        from .sql.planprinter import format_plan
        from .types import VarcharType

        plan = Planner(self, sess).plan_query(ast.query)
        self._check_select_access(plan, sess.user)  # ANALYZE executes the query
        if ast.analyze:
            t0 = time.perf_counter()
            t0_wall = time.time()
            res, counters = self._run_plan(plan)
            dt = time.perf_counter() - t0
            lines = format_plan(plan, counters=counters,
                                breakdown=self._analyze_breakdown(t0_wall, time.time())
                                ).split("\n")
            lines += [f"-- executed in {dt * 1000:.1f} ms, {len(res)} output rows"]
        else:
            from .sql.exchanges import physical_plan

            phys = physical_plan(plan, self.catalogs, getattr(sess, "properties", None))
            lines = format_plan(phys).split("\n")
        rows = np.array(lines, dtype=object)
        return MaterializedResult(("query plan",), (VarcharType.of(None),), [rows], [rows])

    def _analyze_breakdown(self, t0_wall: float, t1_wall: float):
        """Wall decomposition of an EXPLAIN ANALYZE execution window from the
        statement's spans; None outside a statement."""
        from .execution import tracing

        qid = tracing.current_query_id()
        if qid is None:
            return None
        spans = [tracing.span_dict(s) for s in self.tracer.spans_for(qid)]
        return tracing.wall_breakdown(spans, window=(t0_wall, t1_wall))

    def _explain_execute(self, ast, sess: Session):
        """EXPLAIN [ANALYZE] EXECUTE name [USING ...]: the plan of the
        statement its parameters make (ANALYZE runs it), and the template
        line the reference's serving path exposes: the port has no plan
        templates, so every EXECUTE takes the substitution path."""
        import time

        from .exec.local_executor import MaterializedResult
        from .server.dbapi import _substitute
        from .sql import params as PRM
        from .sql import parser as A
        from .sql.frontend import Planner
        from .sql.planprinter import format_plan
        from .types import VarcharType

        ex_ast = ast.query
        text = sess.prepared.get(ex_ast.name)
        if text is None:
            raise ValueError(f"prepared statement {ex_ast.name} not found")
        sql = _substitute(text, [PRM.literal_param_value(p) for p in ex_ast.parameters])
        inner = A.parse(sql)
        if not isinstance(inner, (A.Select, A.SetOp)):
            raise ValueError(f"EXPLAIN of {type(inner).__name__} is not supported")
        plan = Planner(self, sess).plan_query(inner)
        self._check_select_access(plan, sess.user)
        if ast.analyze:
            t0 = time.perf_counter()
            res, counters = self._run_plan(plan)
            dt = time.perf_counter() - t0
            lines = format_plan(plan, counters=counters).split("\n")
            lines += ["Plan template: none -- substitution path",
                      f"-- executed in {dt * 1000:.1f} ms, {len(res)} output rows"]
        else:
            lines = format_plan(plan).split("\n")
            lines.append("Plan template: none -- substitution path")
        rows = np.array(lines, dtype=object)
        return MaterializedResult(("query plan",), (VarcharType.of(None),), [rows], [rows])

    def _writable_catalog(self, sess: Session):
        cand = self.catalogs.get(sess.catalog)
        if cand is not None and hasattr(cand, "create_table"):
            return cand
        for c in self.catalogs.values():
            if hasattr(c, "create_table"):
                return c
        raise ValueError("no writable catalog registered (register a MemoryConnector)")

    def _catalog_name_of(self, conn) -> str:
        for name, c in self.catalogs.items():
            if c is conn:
                return name
        return "?"

    def _create_table(self, ast, sess: Session):
        from .page import Field, Schema
        from .sql.frontend import Planner, _type_from_name

        conn = self._writable_catalog(sess)
        self.access_control.check_can_write(
            sess.user, self._catalog_name_of(conn), ast.name, "create table")
        if ast.as_query is not None:  # CTAS
            src_plan = Planner(self, sess).plan_query(ast.as_query)
            self._check_select_access(src_plan, sess.user)
            res = self.execute_plan(src_plan, cache=False)
            schema = Schema(tuple(Field(n, t) for n, t in zip(res.names, res.types)))
            created = conn.create_table(ast.name, schema, ast.if_not_exists)
            if created is not False:  # IF NOT EXISTS on an existing table: skip insert
                conn.append(ast.name, [_write_column(res, i) for i in range(len(res.names))])
        else:
            fields = tuple(Field(n, _type_from_name(tn, params))
                           for n, tn, params in ast.columns)
            props = dict(getattr(ast, "properties", ()) or ())
            part = props.pop("partitioned_by", None)
            if props:
                raise ValueError(f"unsupported table properties: {sorted(props)}")
            if part is not None:
                if not isinstance(part, (tuple, list)):
                    raise ValueError("partitioned_by must be ARRAY['col', ...]")
                # no connector of the port takes partitions (hive and iceberg
                # are not ported)
                raise ValueError("this catalog does not support partitioned_by")
            conn.create_table(ast.name, Schema(fields), if_not_exists=ast.if_not_exists)
        return None

    def _create_materialized_view(self, ast, sess: Session):
        """Materialize the query into a storage table in the writable catalog
        and record the definition (reference: CreateMaterializedViewTask;
        queries read the STORAGE table, so results are as of the last
        refresh)."""
        from .page import Field, Schema
        from .sql.frontend import Planner

        existing = self.materialized_views.get(ast.name)
        if existing is not None and not ast.or_replace:
            raise ValueError(f"materialized view {ast.name} already exists")
        if existing is not None:
            # replace/refresh stays in the DEFINING catalog
            conn = self.catalogs[existing["catalog"]]
            cat = existing["catalog"]
        else:
            conn = self._writable_catalog(sess)
            cat = self._catalog_name_of(conn)
        storage = f"__mv_{ast.name}"
        self.access_control.check_can_write(sess.user, cat, ast.name, "create table")
        src_plan = Planner(self, sess).plan_query(ast.query)
        self._check_select_access(src_plan, sess.user)
        res = self.execute_plan(src_plan, cache=False)
        conn.drop_table(storage, True)
        conn.create_table(storage, Schema(tuple(Field(n, t)
                                                for n, t in zip(res.names, res.types))))
        conn.append(storage, [_write_column(res, i) for i in range(len(res.names))])
        self.materialized_views[ast.name] = {
            "query": ast.query, "storage": storage, "catalog": cat,
            "session_catalog": sess.catalog}
        return None

    def _refresh_materialized_view(self, ast, sess: Session):
        from .sql import parser as A

        mv = self.materialized_views.get(ast.name)
        if mv is None:
            raise ValueError(f"materialized view {ast.name} does not exist")
        # the definition re-plans under the DEFINING session catalog
        refresh_sess = Session(catalog=mv.get("session_catalog"), user=sess.user)
        return self._create_materialized_view(
            A.CreateMaterializedView(ast.name, mv["query"], or_replace=True), refresh_sess)

    def _insert(self, ast, sess: Session):
        from .sql import parser as A
        from .sql.frontend import Planner

        conn = self._writable_catalog(sess)
        self.access_control.check_can_write(
            sess.user, self._catalog_name_of(conn), ast.name, "insert into")
        schema = conn.schema(ast.name)
        names = ast.columns or schema.names
        if isinstance(ast.query, A.ValuesRows):
            cols = _literal_rows_to_columns(ast.query.rows,
                                            [schema.field(n).type for n in names])
        else:
            src_plan = Planner(self, sess).plan_query(ast.query)
            self._check_select_access(src_plan, sess.user)
            res = self.execute_plan(src_plan, cache=False)
            if len(res.columns) != len(names):
                raise ValueError(
                    f"INSERT has {len(names)} target columns but the query "
                    f"produces {len(res.columns)}")
            cols = [_write_column(res, i, schema.field(n).type) for i, n in enumerate(names)]
        n_rows = len(cols[0]) if cols else 0
        if tuple(names) != schema.names:
            by_name = dict(zip(names, cols))
            cols = [by_name.get(f.name, [None] * n_rows) for f in schema.fields]
        conn.append(ast.name, cols)
        return _dml_count_result(n_rows)

    # -- row-level DML (reference: spi/connector/ConnectorMergeSink -- DELETE
    # and UPDATE funnel through the merge surface; the engine evaluates the
    # per-row predicate/assignments and the connector applies them) ----------
    def _eval_rowwise(self, table: str, exprs, sess: Session):
        """Evaluate expressions per row of `table` in storage order."""
        from .sql import parser as A
        from .sql.frontend import Planner

        items = tuple(A.SelectItem(e, f"c{i}") for i, e in enumerate(exprs))
        sel = A.Select(items=items, from_=A.TableRef((table,), None), where=None,
                       group_by=(), having=None, order_by=(), limit=None)
        return self.execute_plan(Planner(self, sess).plan_query(sel), cache=False)

    def _dml_target(self, table: str, sess: Session):
        conn = self._writable_catalog(sess)
        if table not in conn.tables():
            raise ValueError(f"table {table} does not exist")
        return conn

    @staticmethod
    def _dml_mask(col) -> np.ndarray:
        """A predicate column as a row mask: NULL is False."""
        from .connectors.memory import is_none

        col = np.asarray(col)
        if col.dtype != object:
            return col.astype(bool)
        none = is_none(col)
        return np.where(none, False, col).astype(bool)

    def _delete(self, ast, sess: Session):
        from .sql import parser as A

        conn = self._dml_target(ast.table, sess)
        self.access_control.check_can_write(
            sess.user, self._catalog_name_of(conn), ast.table, "delete from")
        res = self._eval_rowwise(ast.table, [ast.where or A.BoolLit(True)], sess)
        return _dml_count_result(conn.delete_rows(ast.table, self._dml_mask(res.columns[0])))

    @staticmethod
    def _assignment_casts(schema, assignments, rewrite=lambda e: e):
        """Split SET assignments into constant strings/NULLs (which bypass
        row-wise planning: strings live as dictionary ids bound to a column)
        and expressions cast to the column's type."""
        from .sql import parser as A

        const, exprs = {}, []
        for col, e in assignments:
            f = schema.field(col)  # raises on unknown column
            if isinstance(e, A.StringLit):
                const[col] = e.value
            elif isinstance(e, A.NullLit):
                const[col] = None
            else:
                base = f.type.name.split("(")[0]
                params = ()
                if "(" in f.type.name:
                    params = tuple(int(x) for x in
                                   f.type.name[f.type.name.index("(") + 1:-1].split(","))
                exprs.append((col, A.Cast(rewrite(e), base, params)))
        return const, exprs

    def _update(self, ast, sess: Session):
        from .sql import parser as A

        conn = self._dml_target(ast.table, sess)
        self.access_control.check_can_write(
            sess.user, self._catalog_name_of(conn), ast.table, "update")
        const_assigns, expr_assigns = self._assignment_casts(conn.schema(ast.table),
                                                             ast.assignments)
        exprs = [ast.where or A.BoolLit(True)] + [e for _, e in expr_assigns]
        res = self._eval_rowwise(ast.table, exprs, sess)
        mask = self._dml_mask(res.columns[0])
        values = {col: _constant_column(v, len(mask)) for col, v in const_assigns.items()}
        for j, (col, _) in enumerate(expr_assigns):
            values[col] = _write_column(res, j + 1)
        return _dml_count_result(conn.update_rows(ast.table, mask, values))

    def _merge(self, ast, sess: Session):
        """MERGE INTO: match target rows against a source relation on
        equi-keys, then apply WHEN MATCHED updates/deletes and WHEN NOT
        MATCHED inserts.

        As in the reference, the pairing happens on the host and each
        clause's conditions and assignments are evaluated by the engine
        itself over scratch memory tables (``pairs``: one row per target row
        with its matched source row beside it; ``src``: the source rows),
        which live on the engine's device.  The pairing is vectorised
        (``_pair_rows``); ``pairs`` is built only when a WHEN MATCHED clause
        has matched rows to route, the only reader of it."""
        from .connectors.memory import MemoryConnector
        from .page import Field, Schema
        from .sql import parser as A

        conn = self._dml_target(ast.target, sess)
        self.access_control.check_can_write(
            sess.user, self._catalog_name_of(conn), ast.target, "merge into")
        tgt_schema = conn.schema(ast.target)
        tgt_cols = list(tgt_schema.names)

        # ---- the source relation (decoded + raw)
        if isinstance(ast.source, str):
            if ast.source not in conn.tables():
                raise ValueError(f"table {ast.source} does not exist")
            self.access_control.check_can_select(
                sess.user, self._catalog_name_of(conn), ast.source)
            src_cols = list(conn.schema(ast.source).names)
            src_res = self._eval_rowwise(
                ast.source, [A.Identifier((c,)) for c in src_cols], sess)
        else:
            from .sql.frontend import Planner

            plan = Planner(self, sess).plan_query(ast.source)
            self._check_select_access(plan, sess.user)
            src_res = self.execute_plan(plan, cache=False)
            src_cols = list(src_res.names)

        # ---- equi-key pairs from the ON condition
        def conjuncts(e):
            if isinstance(e, A.BinaryOp) and e.op == "and":
                return conjuncts(e.left) + conjuncts(e.right)
            return [e]

        def classify(ident):
            parts = ident.parts
            if len(parts) == 2:
                alias, c = parts
                if alias == ast.target_alias and c in tgt_cols:
                    return ("t", c)
                if alias == ast.source_alias and c in src_cols:
                    return ("s", c)
                raise ValueError(f"MERGE: cannot resolve {'.'.join(parts)}")
            c = parts[0]
            in_t, in_s = c in tgt_cols, c in src_cols
            if in_t and in_s:
                raise ValueError(f"MERGE: column {c} is ambiguous")
            if in_t:
                return ("t", c)
            if in_s:
                return ("s", c)
            raise ValueError(f"MERGE: unknown column {c}")

        keys = []
        for cj in conjuncts(ast.on):
            if not (isinstance(cj, A.BinaryOp) and cj.op == "eq"
                    and isinstance(cj.left, A.Identifier)
                    and isinstance(cj.right, A.Identifier)):
                raise ValueError("MERGE ON must be a conjunction of column equalities")
            a, b = classify(cj.left), classify(cj.right)
            if a[0] == b[0]:
                raise ValueError("MERGE ON equality must pair target with source")
            keys.append((a[1], b[1]) if a[0] == "t" else (b[1], a[1]))

        # DECODED values compare: raw storage differs across decimal scales
        tgt_key_res = self._eval_rowwise(
            ast.target, [A.Identifier((tc,)) for tc, _ in keys], sess)
        tgt_keys = list(tgt_key_res.columns)
        src_keys = [src_res.columns[src_cols.index(sc)] for _, sc in keys]
        n_tgt = len(tgt_key_res)
        n_src = len(src_res)
        match_of, src_matched = _pair_rows(tgt_keys, src_keys)

        # ---- scratch relations the engine evaluates clause exprs over
        scratch = MemoryConnector(device=self.device)
        src_fields = [Field(f"s_{c}", src_res.types[src_cols.index(c)]) for c in src_cols]
        scratch.create_table("src", Schema(tuple(src_fields)))
        if n_src:
            scratch.append("src", [_write_column(src_res, src_cols.index(c))
                                   for c in src_cols])

        def build_pairs():
            if "pairs" in scratch.tables():
                return
            tgt_res = self._eval_rowwise(
                ast.target, [A.Identifier((c,)) for c in tgt_cols], sess)
            fields = [Field(f"t_{c}", tgt_schema.field(c).type) for c in tgt_cols] + src_fields
            scratch.create_table("pairs", Schema(tuple(fields)))
            cols = [_write_column(tgt_res, i) for i in range(len(tgt_cols))]
            cols += [_take(_write_column(src_res, src_cols.index(c)), match_of)
                     for c in src_cols]
            if n_tgt:
                scratch.append("pairs", cols)

        import uuid

        # unique per statement: a shared name would let one MERGE read
        # another's scratch rows
        cat_name = f"__merge_scratch_{uuid.uuid4().hex[:12]}__"
        self.catalogs[cat_name] = scratch
        scratch_sess = dataclasses.replace(sess, catalog=cat_name)
        try:
            def rewrite(e, in_matched):
                if isinstance(e, A.Identifier):
                    side, c = classify(e)
                    if side == "t" and not in_matched:
                        raise ValueError("WHEN NOT MATCHED cannot reference the target")
                    return A.Identifier(((f"{side}_{c}"),))
                if dataclasses.is_dataclass(e) and not isinstance(e, type):
                    ch = {}
                    for f in dataclasses.fields(e):
                        v = getattr(e, f.name)
                        nv = rewrite_any(v, in_matched)
                        if nv is not v:
                            ch[f.name] = nv
                    return dataclasses.replace(e, **ch) if ch else e
                return e

            def rewrite_any(v, in_matched):
                if isinstance(v, tuple):
                    return tuple(rewrite_any(x, in_matched) for x in v)
                if dataclasses.is_dataclass(v) and not isinstance(v, type):
                    return rewrite(v, in_matched)
                return v

            for cl in ast.clauses:  # arity errors must precede ANY mutation
                if cl.action == "insert":
                    names = list(cl.columns) or tgt_cols
                    if len(cl.values) != len(names):
                        raise ValueError(f"MERGE INSERT has {len(names)} columns but "
                                         f"{len(cl.values)} values")

            remaining = match_of >= 0
            delete_mask = np.zeros(n_tgt, bool)
            update_ops = []  # (mask, clause) applied after clause routing
            src_remaining = ~src_matched
            inserts = []  # (mask, clause)
            for cl in ast.clauses:
                if cl.matched:
                    if not remaining.any():
                        continue
                    if cl.condition is not None:
                        build_pairs()
                        cres = self._eval_rowwise(
                            "pairs", [rewrite(cl.condition, True)], scratch_sess)
                        cm = self._dml_mask(cres.columns[0])
                    else:
                        cm = np.ones(n_tgt, bool)
                    mask = remaining & cm
                    remaining &= ~mask
                    if cl.action == "delete":
                        delete_mask |= mask
                    else:
                        update_ops.append((mask, cl))
                else:
                    if cl.condition is not None and n_src:
                        cres = self._eval_rowwise(
                            "src", [rewrite(cl.condition, False)], scratch_sess)
                        cm = self._dml_mask(cres.columns[0])
                    else:
                        cm = np.ones(n_src, bool)
                    mask = src_remaining & cm
                    src_remaining &= ~mask
                    inserts.append((mask, cl))

            # ---- apply updates (row count unchanged), then deletes, then inserts
            for mask, cl in update_ops:
                if not mask.any():
                    continue
                const, expr_assigns = self._assignment_casts(
                    tgt_schema, cl.assignments, lambda e: rewrite(e, True))
                values = {col: _constant_column(v, n_tgt) for col, v in const.items()}
                if expr_assigns:  # one scan evaluates every assignment of the clause
                    build_pairs()
                    vres = self._eval_rowwise("pairs", [e for _, e in expr_assigns],
                                              scratch_sess)
                    for j, (col, _) in enumerate(expr_assigns):
                        values[col] = _write_column(vres, j)
                conn.update_rows(ast.target, mask, values)
            if delete_mask.any():
                conn.delete_rows(ast.target, delete_mask)
            for mask, cl in inserts:
                if not mask.any():
                    continue
                names = list(cl.columns) or tgt_cols
                vres = self._eval_rowwise(
                    "src", [rewrite(e, False) for e in cl.values], scratch_sess)
                rows = np.flatnonzero(mask)
                cols_by_name = {nm: _take(_write_column(vres, j, tgt_schema.field(nm).type),
                                          rows)
                                for j, nm in enumerate(names)}
                conn.append(ast.target, [cols_by_name.get(f.name, [None] * len(rows))
                                         for f in tgt_schema.fields])
        finally:
            del self.catalogs[cat_name]
        return None


# -- the write path ----------------------------------------------------------------------


def _write_column(res, i, dst_t=None):
    """Column ``i`` of a query result in the form a connector writes.  Where
    the result's type is the target's (``dst_t`` None: the same type), the
    raw column is taken as it is (``Raw``, or ``Coded`` for strings: each
    distinct dictionary id's decoded string), nulls from the decoded
    column's ``None``; otherwise the decoded values through the reference's
    per-value coercion (``_coerce_host``)."""
    from .connectors.memory import Coded, Raw, first_seen, is_none
    from .types import ArrayType, MapType

    t = res.types[i]
    dec = res.columns[i]
    if dst_t is not None and dst_t != t:
        return _coerce_host(list(dec), t, dst_t)
    if isinstance(t, (ArrayType, MapType)):
        # the reference's per-value coercion, which takes no list (its known
        # gap: CTAS and INSERT ... SELECT of an array-valued query raise)
        return _coerce_host(list(dec), t, t)
    nulls = is_none(dec)
    raw = np.asarray(res.raw_columns[i])
    if t.is_string:
        codes = np.zeros(len(raw), np.int64)
        live = np.flatnonzero(~nulls)
        values = np.empty(0, object)
        if len(live):
            _, first, codes[live] = first_seen(raw[live])
            values = np.asarray(dec)[live[first]]
        return Coded(codes, values, nulls)
    return Raw(raw, nulls)


def _constant_column(value, n: int):
    """One SET value (a string or NULL) for each of ``n`` rows."""
    from .connectors.memory import Coded

    if value is None:
        return [None] * n
    return Coded(np.zeros(n, np.int64), np.array([value], dtype=object), np.zeros(n, bool))


def _take(col, rows):
    """Rows ``rows`` of a written column; a row index below 0 is NULL."""
    from .connectors.memory import Coded, Raw

    rows = np.asarray(rows, np.int64)
    miss = rows < 0
    at = np.where(miss, 0, rows)
    if isinstance(col, Raw):
        if not len(col):
            return Raw(np.zeros(len(rows), col.values.dtype), np.ones(len(rows), bool))
        return Raw(np.where(miss, 0, col.values[at]), miss | col.nulls[at])
    if isinstance(col, Coded):
        if not len(col):
            return Coded(np.zeros(len(rows), np.int64), col.values, np.ones(len(rows), bool))
        return Coded(np.where(miss, 0, col.codes[at]), col.values, miss | col.nulls[at])
    return [None if r < 0 else col[r] for r in rows.tolist()]


def _key_array(col):
    """(values, usable) of a decoded ON-key column for pairing: values as a
    typed numpy array where they are numbers of one kind, else as python
    objects (strings, dates); usable False where the key is NULL or NaN
    (neither matches anything, as in the reference, where two NaN objects
    never compare equal).  An unusable slot holds a usable value of the
    column, so that every slot sorts."""
    from .connectors.memory import is_none

    col = np.asarray(col)
    none = is_none(col)
    if col.dtype == object:
        live = col[~none]
        typed = np.asarray(live.tolist()) if len(live) else np.zeros(0, np.int64)
        if typed.ndim != 1 or typed.dtype.kind in "USO":
            typed = live
        out = np.zeros(len(col), typed.dtype)
        out[~none] = typed
        col = out
    if col.dtype.kind in "US":
        col = col.astype(object)
    usable = ~none
    if col.dtype.kind == "f":
        usable &= ~np.isnan(col)
    if usable.any() and not usable.all():
        col = np.where(usable, col, col[usable][0])
    return col, usable


def _pair_rows(tgt_keys, src_keys):
    """(match_of, src_matched): the source row each target row matches on
    all key columns (-1: none) and which source rows some target row
    matched.  Keys compare by decoded value, as python compares them; NULL
    keys never match; a target row that matches two source rows raises.
    Each key column's values on both sides get one dense code through
    ``np.unique``: as typed arrays where both sides are numbers of one kind,
    else as python objects, which compare an integer and a float exactly
    (an int64 key against a DECIMAL's float past 2^53)."""
    n_t = len(tgt_keys[0]) if tgt_keys else 0
    n_s = len(src_keys[0]) if src_keys else 0
    match_of = np.full(n_t, -1, np.int64)
    src_matched = np.zeros(n_s, bool)
    t_code = np.zeros(n_t, np.int64)
    s_code = np.zeros(n_s, np.int64)
    t_ok = np.ones(n_t, bool)
    s_ok = np.ones(n_s, bool)
    for tk, sk in zip(tgt_keys, src_keys):
        (a, a_ok), (b, b_ok) = _key_array(tk), _key_array(sk)
        t_ok &= a_ok
        s_ok &= b_ok
        if not t_ok.any() or not s_ok.any():
            return match_of, src_matched
        if a.dtype.kind != b.dtype.kind or a.dtype == object:
            a, b = a.astype(object), b.astype(object)
            if not _comparable(a[a_ok][0], b[b_ok][0]):
                return match_of, src_matched  # a string never equals a number
        _, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
        card = int(inv.max()) + 1
        _, comb = np.unique(np.concatenate([t_code, s_code]) * card + inv, return_inverse=True)
        comb = comb.reshape(-1).astype(np.int64)
        t_code, s_code = comb[:n_t], comb[n_t:]
    s_rows = np.flatnonzero(s_ok)
    uniq, first, counts = np.unique(s_code[s_rows], return_index=True, return_counts=True)
    pos = np.minimum(np.searchsorted(uniq, t_code), len(uniq) - 1)
    found = t_ok & (uniq[pos] == t_code)
    if (counts[pos[found]] > 1).any():
        raise ValueError("MERGE: one target row matched more than one source row")
    match_of[found] = s_rows[first[pos[found]]]
    src_matched[match_of[found]] = True
    return match_of, src_matched


def _comparable(x, y) -> bool:
    """Whether python may find two key values equal: two numbers (an int, a
    float and a Decimal compare exactly) or two values of one type.  A key
    column's values are of one SQL type, so one value of each side decides."""
    import numbers

    both_numbers = isinstance(x, numbers.Number) and isinstance(y, numbers.Number)
    return both_numbers or type(x) is type(y)


def _coerce_host(values, src_t, dst_t):
    """Host-side value coercion for writes (decoded python objects -> storage
    repr: decimals as raw scaled ints, strings as str, dates as epoch days)."""
    import datetime

    from .types import DecimalType, TimestampType

    if isinstance(dst_t, DecimalType):
        from decimal import Decimal

        s = dst_t.scale
        out = []
        for v in values:
            if v is None:
                out.append(None)
                continue
            if isinstance(v, float):
                raw = round(v * 10**s)
            else:
                # int / str / Decimal: exact scaling, no float round-trip
                raw = int(Decimal(str(v)).scaleb(s).to_integral_value())
            if not -(1 << 63) <= raw < (1 << 63):
                raise ValueError(
                    f"decimal value {v} beyond 2^63: Int128 column storage "
                    "is not supported (declared wide precision is, for "
                    "values that fit)")
            out.append(raw)
        return out
    if dst_t.is_string:
        return [None if v is None else str(v) for v in values]
    if dst_t.is_floating:
        return [None if v is None else float(v) for v in values]
    if dst_t.name == "date":
        out = []
        for v in values:
            if v is None:
                out.append(None)
            elif isinstance(v, np.datetime64):
                out.append(int(v.astype("datetime64[D]").astype(np.int64)))
            elif isinstance(v, datetime.date):
                out.append((v - datetime.date(1970, 1, 1)).days)
            else:
                out.append(int(v))
        return out
    if isinstance(dst_t, TimestampType):
        unit = "us" if dst_t.precision <= 6 else "ns"
        back = 10 ** ((6 if unit == "us" else 9) - dst_t.precision)
        return [None if v is None else
                (int(v.astype(f"datetime64[{unit}]").astype(np.int64)) // back
                 if isinstance(v, np.datetime64) else int(v))
                for v in values]
    return [None if v is None else int(v) for v in values]


def _literal_rows_to_columns(rows, types):
    """INSERT ... VALUES literal evaluation (coordinator-side, like the
    reference's ValuesNode constant folding)."""
    cols = [[] for _ in types]
    for row in rows:
        if len(row) != len(types):
            raise ValueError(f"VALUES row has {len(row)} fields, expected {len(types)}")
        for i, (e, t) in enumerate(zip(row, types)):
            cols[i].append(_literal_value(e, t))
    return cols


def _dml_count_result(n: int, label: str = "rows"):
    """Affected-row count surface for DML (reference: the protocol's
    updateCount / UPDATE n rows output)."""
    from .exec.local_executor import MaterializedResult
    from .types import BIGINT

    col = np.array([int(n)], np.int64)
    return MaterializedResult((label,), (BIGINT,), [col], [col])


def _ts_rescale(text: str, t):
    """Parse a timestamp literal and rescale to the column's precision."""
    from .types import parse_timestamp_literal

    v, ty = parse_timestamp_literal(text)
    diff = t.precision - ty.precision
    return (v * 10 ** diff if diff >= 0 else round(v / 10 ** -diff)), t


def _literal_value(e, t):
    from .sql import parser as A
    from .types import DecimalType, parse_date_literal

    neg = False
    while isinstance(e, A.UnaryOp) and e.op == "negate":
        neg = not neg
        e = e.operand
    if isinstance(e, A.NullLit):
        return None
    if isinstance(e, A.NumberLit):
        if isinstance(t, DecimalType):
            # exact decimal parse: float64 loses digits past ~15 significant
            # figures
            from decimal import ROUND_HALF_UP, Decimal

            d = Decimal(e.text)
            if neg:
                d = -d
            raw = int((d * (10 ** t.scale)).to_integral_value(rounding=ROUND_HALF_UP))
            if not -(1 << 63) <= raw < (1 << 63):
                raise ValueError(
                    f"decimal value {d} beyond 2^63 at scale {t.scale}: "
                    "Int128 column storage is not supported")
            return raw
        v = float(e.text) if ("." in e.text or "e" in e.text.lower()) else int(e.text)
        if neg:
            v = -v
        return float(v) if t.is_floating else int(v)
    if isinstance(e, A.StringLit):
        from .types import CharType

        if isinstance(t, CharType):
            # char(n) stores SPACE-PADDED to n (Chars.padSpaces)
            return e.value[:t.length].ljust(t.length)
        if t.name == "date":
            return parse_date_literal(e.value)
        if t.name.startswith("timestamp"):
            v, _ = _ts_rescale(e.value, t)
            return v
        return e.value
    if isinstance(e, A.DateLit):
        return parse_date_literal(e.value)
    if isinstance(e, A.TimestampLit):
        if t.name.startswith("timestamp"):
            v, _ = _ts_rescale(e.value, t)
            return v
        return parse_date_literal(e.value.split(" ")[0])
    if isinstance(e, A.BoolLit):
        return bool(e.value)
    if isinstance(e, A.ArrayLiteral):
        from .types import ArrayType

        et = t.element if isinstance(t, ArrayType) else t
        return [_literal_value(item, et) for item in e.items]
    raise ValueError(f"unsupported VALUES literal {e}")
