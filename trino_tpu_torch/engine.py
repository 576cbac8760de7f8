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

Caches, as in the reference:

- the plan cache: a SELECT's plan keyed on its normalized text, the session
  catalog, the user and the plan-shaping session properties
  (``_plan_shape_props``); a hit skips parse, analyze and plan (no
  ``planner`` span).  A catalog with a ``plan_version`` (the system
  catalog's growable dictionaries) replans the plans that read it when the
  version moves.  Unlike the reference's, it keeps at most
  ``PLAN_CACHE_ENTRIES`` plans, least recently used out first: a statement
  that substitutes its values (an aggregate EXECUTE, a binding a template
  cannot take) is still a new text and a new plan for every value;
- plan templates (``_template_cache``, on unless
  ``TRINO_TPU_PLAN_TEMPLATES=0``): EXECUTE, protocol ``parameters`` and
  auto-parameterized point SELECTs (``sql/params.parameterize_text``, after
  a plan-cache miss) plan a statement shape once with ``ir.Parameter``
  runtime inputs and bind each request's values at execution, keyed on the
  plan cache's tuple without ``distributed``.  A filter over a parameter
  prunes splits per binding.  A template whose first execution fails is
  dropped and its text substitutes; an unbindable text (aggregates, a value
  consumed while planning, a volatile function) is negative-cached for the
  literal kinds that failed;
- the template batcher (``execution/batcher.py``, ``template_batcher``):
  concurrent requests of one confirmed template fuse into one execution
  (``LocalExecutor.execute_batched``) where the plan is in the streaming
  subset;
- the device buffer pool (``execution/bufferpool.py``, ``buffer_pool``):
  the page and build tiers, read by every executor the engine makes (plan
  time subqueries and the statements' row evaluations included), and the
  result tier, consulted before a SELECT reaches an executor.

``_invalidate`` clears the plan cache, the templates and the pool after
every DDL and DML statement and at ``register_catalog``: no cache serves
rows from before a write.  The reference's executor pool, whose executors
keep jitted pipelines, has no counterpart: the port has no compiled
pipelines to keep, and makes a fresh executor per plan.  What the
reference's executors memoize per plan root (node paths, CBO estimates,
the structural fingerprint) lives on the engine instead (``_plan_memo``,
bounded, cleared by ``_invalidate``), so a warm statement walks none of it.

Plan history and adaptive execution, as in the reference: every clean
completion of a cached-plan path (``execute_plan``) folds its per-node
actuals into ``plan_history`` (``execution/history.py``;
``TRINO_TPU_PLAN_HISTORY``, 256 plans, 0 off), published as
``last_plan_actuals`` and on the completion event.  Before the plan-cache
lookup a SELECT asks ``adaptive_advisor`` (``execution/adaptive.py``;
``TRINO_TPU_ADAPTIVE=0`` or the ``adaptive_execution`` session property
off); a frozen "replan" decision runs the plan the planner makes with the
advisor's corrections, cached under the key plus the decision's token.
The advisor's price of a re-plan is the statement's planning seconds on a
plan-cache miss (a CUDA engine compiles no plans; see
``execution/adaptive.py``).

Observability, as in the reference: ``flight_recorder``
(``execution/flightrecorder.py``) keeps one record per completed or
errored statement (``_record_flight``) and the stall watchdog's reports;
``compile_log`` is the process's log of kernel builds; ``inflight`` the
registry of launches, host reads, split generation and cache stores in
progress, which ``stall_watchdog`` samples (``TRINO_TPU_STALL_S``) and
``health()`` reads.  ``query_max_memory`` is enforced per statement by the
memory pool (``QueryMemoryLimitError``).

The memory ladder, as in the reference: an operator whose device state
does not fit the pool Grace-partitions over the tiered spill
(``exec/spill.py``: device, host RAM, disk), and while the engine's pool is
past ``execution/memory_killer.BLOCKED_FRACTION`` a new statement queues at
its resource group (``_memory_admission_ok``) until a running one finishes;
a statement that queued so carries ``admission_queued`` 1 on its counters.

Distributed execution, as in the reference: ``execute_sql(...,
distributed=True, mesh=...)`` runs the plan on ``exec/distributed.py``'s
executor over a worker mesh (``parallel/mesh.py``) whose devices are all
the engine's (positions on one card form a virtual mesh).  Such statements
take their own plan-cache and result-tier keys, and skip the advisor, the
plan templates and auto-parameterization.

Fault-tolerant execution: ``execute_sql(..., fault_tolerant=True)`` runs a
SELECT through ``exec/fte.py``'s task-retrying executor over a spooled
exchange (one per engine, over a temporary spool, sharing the engine's
pools).  The multi-process cluster (``server/cluster.py``) plans on this
engine and runs its fragments on worker processes; its coordinator walks
the cluster rungs of the memory ladder (cache eviction, then the
low-memory killer).
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import threading
import time
from collections import OrderedDict
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
        import os

        from .connectors.system import InformationSchemaConnector, SystemConnector
        from .exec.local_executor import FusedGraphCache, PlanMemo
        from .execution.adaptive import AdaptiveAdvisor
        from .execution.batcher import TemplateBatcher
        from .execution.bufferpool import DeviceBufferPool
        from .execution.history import PlanHistoryStore
        from .execution.eventlistener import EventListenerManager
        from .execution.flightrecorder import FlightRecorder
        from .execution.query_state import QueryTracker
        from .execution.resourcegroups import ResourceGroupManager
        from .execution.session_properties import SessionPropertyManager
        from .execution.tracing import (COMPILE_LOG, INFLIGHT, QueryCounters,
                                        StallWatchdog, Tracer)
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
        # page, build and result tiers shared by every executor of this
        # engine; budgets read at first use (TRINO_TPU_PAGE_CACHE,
        # TRINO_TPU_RESULT_CACHE)
        self.buffer_pool = DeviceBufferPool(device=self.device)
        self._totals_lock = threading.Lock()  # guards counters_total
        # plan cache: key -> (plan, plan_versions of the catalogs it reads),
        # least recently used first, at most PLAN_CACHE_ENTRIES plans
        self._plan_cache: OrderedDict = OrderedDict()
        # plan templates: key -> (_PlanTemplate, plan_versions), or
        # (_TEMPLATE_UNBINDABLE, the literal kinds that failed); least
        # recently used first, at most PLAN_CACHE_ENTRIES entries, since
        # every new ad-hoc statement shape adds one
        self._template_cache: OrderedDict = OrderedDict()
        self.plan_templates_enabled = os.environ.get(
            "TRINO_TPU_PLAN_TEMPLATES", "1") not in ("0", "false", "no")
        # fuses concurrent requests of one template (TRINO_TPU_TEMPLATE_BATCH,
        # TRINO_TPU_BATCH_WINDOW_MS, TRINO_TPU_BATCH_MAX); on by default as in
        # the reference, though on the card it lowers same-shape throughput
        # (execution/batcher.py)
        self.template_batcher = TemplateBatcher()
        # per plan root: node paths, CBO estimates and the structural
        # fingerprint its executions compute (LocalExecutor.begin_plan,
        # plan_fingerprint), bounded like the plan and template caches
        self._plan_memo = PlanMemo(max_entries=2 * PLAN_CACHE_ENTRIES)
        # the scan-fused runners' CUDA graphs and chain layouts for the plans
        # that run again, keyed by plan node (LocalExecutor._fused_scan);
        # cleared with the plan cache: a graph holds its plan's node
        self._fused_cache = FusedGraphCache(memory_pool=self.memory_pool)
        # per-node est-vs-actual records, merged per structural plan
        # fingerprint on every clean completion (TRINO_TPU_PLAN_HISTORY);
        # the advisor turns them into plan decisions at admission
        self.plan_history = PlanHistoryStore()
        self.last_plan_actuals: Optional[dict] = None
        # one record per completed or errored statement, and the stall
        # reports (TRINO_TPU_FLIGHT_RECORDS, TRINO_TPU_FLIGHT_DIR,
        # TRINO_TPU_FLIGHT_BYTES)
        self.flight_recorder = FlightRecorder()
        # the process's kernel builds (TRINO_TPU_COMPILE_LOG)
        self.compile_log = COMPILE_LOG
        self.adaptive_advisor = AdaptiveAdvisor(history=self.plan_history,
                                                compile_log=self.compile_log)
        # serializes plan-cache lookup, planning and store, and the system
        # connector's dictionary growth (RLock: the planner asks for
        # dictionaries while a scan of the same table may hold it on this
        # thread)
        self._plan_lock = threading.RLock()
        # control plane (reference: DispatchManager + QueryTracker + resource
        # groups + EventListenerManager + TracingModule)
        self.query_tracker = QueryTracker()
        # the ladder's admission rung: new statements queue while the pool is
        # blocked, and finished ones drain the queue as memory frees
        self.resource_groups = ResourceGroupManager(
            admission_gate=self._memory_admission_ok)
        self.event_listeners = EventListenerManager()
        self.session_properties = SessionPropertyManager()
        self.tracer = Tracer()
        # every statement's counters summed, for /v1/metrics
        self.counters_total = QueryCounters()
        # launches, host reads, split generation and cache stores in
        # progress; the watchdog samples it when TRINO_TPU_STALL_S is set
        # (unset: no thread), a build's launch judged against
        # TRINO_TPU_STALL_COMPILE_S
        self.inflight = INFLIGHT
        self.last_stall_report: Optional[dict] = None
        self.stall_watchdog = StallWatchdog(on_stall=self._on_stall,
                                            extra_info=self._stall_extra)
        if self.stall_watchdog.enabled:
            self.stall_watchdog.start()
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
        self._invalidate()

    # -- the plan cache (reference: Engine._plan_cache) ---------------------------
    def _invalidate(self) -> None:
        """Drop every cached plan and template and release the buffer pool:
        after DDL, DML or a new catalog, no cache may serve what was there
        before, nor hold device memory for it."""
        with self._plan_lock:
            self._plan_cache.clear()
            self._template_cache.clear()
        self._plan_memo.clear()
        self._fused_cache.clear()
        self.buffer_pool.clear()

    def _plan_versions(self, plan) -> tuple:
        """(catalog, plan_version) of each versioned catalog the plan scans,
        stored beside the cached plan: a moved version replans only the
        plans that read that catalog."""
        from .sql import plan as P

        names: set = set()

        def walk(n):
            if isinstance(n, P.TableScan):
                names.add(n.catalog)
            for c in n.children:
                walk(c)

        walk(plan)
        return tuple((nm, self.catalogs[nm].plan_version()) for nm in sorted(names)
                     if nm in self.catalogs and hasattr(self.catalogs[nm], "plan_version"))

    def _stale_catalog(self, versions):
        """The first catalog whose plan_version moved past ``versions``, or
        None while the snapshot is current."""
        for name, ver in versions:
            conn = self.catalogs.get(name)
            if conn is None or conn.plan_version() != ver:
                return name
        return None

    def _evict_stale_plan(self, name) -> None:
        """A catalog's version moved: the pool's entries over it can never
        serve again, so they release their memory now (shared by the plan
        and template caches)."""
        self.buffer_pool.invalidate_catalog(name)

    def _cache_lookup(self, key):
        """The cached plan, or None when absent or version-stale (a stale
        entry is evicted).  The caller holds ``_plan_lock``."""
        entry = self._plan_cache.get(key)
        if entry is None:
            return None
        plan, versions = entry
        stale = self._stale_catalog(versions)
        if stale is not None:
            self._evict_stale_plan(stale)
            self._plan_cache.pop(key, None)
            return None
        self._plan_cache.move_to_end(key)
        return plan

    def _cache_store(self, key, plan) -> None:
        """Store a fresh plan, dropping the least recently used past
        ``PLAN_CACHE_ENTRIES``: a statement that substitutes its values
        (outside the template subset) is a new key for every new value.  The
        caller holds ``_plan_lock``."""
        # the versions are read AFTER planning: planning itself encodes the
        # current rows into the growable dictionaries
        self._plan_cache[key] = (plan, self._plan_versions(plan))
        self._plan_cache.move_to_end(key)
        while len(self._plan_cache) > PLAN_CACHE_ENTRIES:
            self._plan_cache.popitem(last=False)

    # -- plan templates (reference: Engine._template_*) ---------------------------
    def _template_key(self, text: str, sess) -> tuple:
        from .sql.params import normalize_sql

        return (normalize_sql(text), sess.catalog, sess.user, _plan_shape_props(sess))

    def _template_lookup(self, key, kinds=None):
        """-> _PlanTemplate, _TEMPLATE_UNBINDABLE, or None (absent or stale,
        with the plan cache's version check).  The negative entry holds the
        literal kinds that failed: an ill-typed binding does not poison a
        well-typed one of the same text.  The caller holds ``_plan_lock``."""
        entry = self._template_cache.get(key)
        if entry is None:
            return None
        tpl, versions = entry
        if tpl is _TEMPLATE_UNBINDABLE:
            return tpl if kinds is None or versions == kinds else None
        stale = self._stale_catalog(versions)
        if stale is not None:
            self._evict_stale_plan(stale)
            self._template_cache.pop(key, None)
            return None
        self._template_cache.move_to_end(key)
        return tpl

    def _template_store(self, key, entry) -> None:
        """Store a template or a negative entry, dropping the least recently
        used past ``PLAN_CACHE_ENTRIES``.  The caller holds ``_plan_lock``."""
        self._template_cache[key] = entry
        self._template_cache.move_to_end(key)
        while len(self._template_cache) > PLAN_CACHE_ENTRIES:
            self._template_cache.popitem(last=False)

    def _maybe_template_execute(self, text: str, param_asts, sess, qsm=None):
        """Run parameterized statement ``text`` with the EXECUTE literal ASTs
        through its plan template.  Returns (handled, result); (False, None)
        sends the caller to the substitution path.  A hit plans nothing: the
        cache probe and the binding are its only work before execution."""
        if not self.plan_templates_enabled:
            return False, None
        from .sql import params as PRM

        key = self._template_key(text, sess)
        kinds = PRM.literal_kinds(param_asts)
        with self._plan_lock:
            tpl = self._template_lookup(key, kinds)
        if tpl is _TEMPLATE_UNBINDABLE:
            return False, None
        created = False
        if tpl is None:
            tpl, created = self._create_template(key, text, param_asts, sess, qsm)
            if tpl is None:
                return False, None
        if tpl.n_params != len(param_asts):
            # arity errors are the substitution path's to report
            return False, None
        try:
            runtime = PRM.bind_values(tpl.binders, param_asts)
        except PRM.BindError:
            # this binding cannot take the template (a value past the slot's
            # type, a finer timestamp): substitution runs it, the template
            # stays for the bindings it takes
            return False, None
        try:
            result = self._execute_template(tpl, runtime, param_asts, sess, qsm,
                                            created, key=key)
        except BaseException as e:
            if isinstance(e, (KeyboardInterrupt, SystemExit, GeneratorExit)):
                raise
            if not tpl.confirmed:
                # probation: a template whose first execution fails is never
                # trusted.  A deterministic failure negative-caches for these
                # literal kinds, a transient one lets the next request retry
                from .exec.fte import is_retryable_failure

                with self._plan_lock:
                    if is_retryable_failure(e):
                        self._template_cache.pop(key, None)
                    else:
                        self._template_store(key, (_TEMPLATE_UNBINDABLE, kinds))
                return False, None
            raise
        tpl.confirmed = True
        self._stamp_template(hits=0 if created else 1, misses=1 if created else 0)
        return True, result

    def _create_template(self, key, text, param_asts, sess, qsm=None):
        """Plan ``text`` with its markers bound to representative literals
        and store a _PlanTemplate.  Returns (template or None, created);
        ``created`` is False where a concurrent creator's template is reused
        (a hit).  Structural failures (a value consumed while planning, a plan
        outside the template subset, parse or semantic errors) negative-cache;
        transient ones (a NULL first binding, a malformed value) and arity
        problems only fall back."""
        from .execution.query_state import QueryState
        from .sql import params as PRM
        from .sql import parser as A
        from .sql.frontend import Planner

        kinds = PRM.literal_kinds(param_asts)

        def reject():
            with self._plan_lock:
                self._template_store(key, (_TEMPLATE_UNBINDABLE, kinds))
            return None, False

        if _VOLATILE_SQL_RE.search(text):
            # volatile calls fold to plan-time constants: a template would
            # serve the first execution's fold to every later binding
            return reject()
        try:
            ast = A.parse(text)
        except A.ParseError:
            return reject()
        if not isinstance(ast, (A.Select, A.SetOp)):
            return reject()  # prepared DML substitutes; only SELECTs template
        ords = PRM.marker_ordinals(ast)
        if not ords:
            return None, False  # nothing to bind: the plan cache owns it
        if ords != set(range(len(param_asts))):
            return None, False  # arity mismatch: substitution reports it
        if isinstance(ast, A.Select) and (ast.group_by or ast.distinct
                                          or ast.having is not None):
            # outside the template subset (the plan-shape check below decides;
            # this skips planning twice for the common shapes)
            return reject()
        if qsm is not None:
            qsm.transition(QueryState.PLANNING)
        reg = PRM.ParamRegistry(len(param_asts))
        try:
            bound = PRM.bind_markers(ast, tuple(param_asts))
            span = (self.tracer.span("planner", trace_id=qsm.query_id)
                    if qsm is not None else _null_ctx())
            with span:
                with self._plan_lock:
                    # a concurrent creator may have won while this thread
                    # waited: take its template
                    cur = self._template_lookup(key, kinds)
                    if isinstance(cur, _PlanTemplate):
                        return cur, False
                    if cur is _TEMPLATE_UNBINDABLE:
                        return None, False
                    planner = Planner(self, sess)
                    planner.param_registry = reg
                    plan = planner.plan_query(bound)
                    if not _template_plan_ok(plan):
                        raise PRM.Unbindable(
                            "plan shape outside the streaming template subset")
                    tpl = _PlanTemplate(text=text, plan=plan, binders=tuple(reg.binders),
                                        n_params=len(param_asts))
                    self._template_store(key, (tpl, self._plan_versions(plan)))
        except PRM.Unbindable as e:
            return (None, False) if e.transient else reject()
        except Exception:  # noqa: BLE001 - substitution succeeds or reports it
            return reject()
        return tpl, True

    def _execute_template(self, tpl, runtime, param_asts, sess, qsm, created, key=None):
        """A bound template: the result tier first (its key carries the bound
        values, so a hit never serves another binding's answer; volatility
        was tested on the template's text), then the plan with the bound
        slots, through the batcher where the template may fuse."""
        from .execution.query_state import QueryState
        from .sql import params as PRM

        self._check_select_access(tpl.plan, sess.user)
        if qsm is not None:
            if created:
                qsm.transition(QueryState.STARTING)
            qsm.transition(QueryState.RUNNING)
        rkey = self._result_cache_key(tpl.text, tpl.plan, sess)
        if rkey is not None:
            rkey = rkey + (PRM.values_cache_key(param_asts),)
        epoch = self.buffer_pool.epoch if rkey is not None else None
        if rkey is not None:
            served = self._result_cache_fetch(rkey)
            if served is not None:
                return served
        span = (self.tracer.span("execution", trace_id=qsm.query_id)
                if qsm is not None else _null_ctx())
        with span:
            bt = self.template_batcher
            if bt.enabled and key is not None and tpl.confirmed and tpl.batchable \
                    and runtime:
                result, batched_with = bt.execute(
                    key, runtime,
                    lambda rt: self._template_serial_execute(tpl, rt, sess),
                    lambda rts: self._execute_template_batch(tpl, rts, sess))
                if batched_with:
                    # a rider's own counters stay empty: the driver's carry
                    # the batch's device work, once
                    self._stamp_batched(batched_with)
            else:
                result = self._template_serial_execute(tpl, runtime, sess)
        self._result_cache_finish(rkey, result, epoch, tpl.plan)
        return result

    def _template_serial_execute(self, tpl, runtime, sess):
        """One request of a template on its own: the plan with the bound
        slots staged once for the query."""
        return self.execute_plan(tpl.plan, page_cache=_effective_page_cache(sess),
                                 params=runtime,
                                 query_max_memory=_query_mem_limit(self, sess),
                                 dispatch_batch=_effective_dispatch_batch(sess))

    def _execute_template_batch(self, tpl, runtimes, sess):
        """One fused execution for a whole window, on the driver's thread:
        per-member results or exceptions, in member order.  A plan or page
        outside the fused path (``BatchUnsupported``) demotes the template
        to serial lanes for good; the batcher re-runs every member."""
        from .exec.local_executor import BatchUnsupported

        ex = self._executor(_effective_page_cache(sess))
        ex.plan_memo = self._plan_memo
        ex.use_fused_cache(self._fused_cache)
        ex.dispatch_batch = _effective_dispatch_batch(sess)
        ex.memory_pool.begin_query(_query_mem_limit(self, sess))
        try:
            return self._run_counted(ex, lambda: ex.execute_batched(tpl.plan, runtimes))[0]
        except BatchUnsupported:
            tpl.batchable = False
            raise

    def _stamp_template(self, hits: int = 0, misses: int = 0) -> None:
        """Count a template hit or creation on the running statement."""
        from .execution.tracing import QueryCounters

        self._account_counters(QueryCounters(plan_template_hits=hits,
                                             plan_template_misses=misses))

    def _stamp_batched(self, batched_with: int) -> None:
        """Every request a fused batch served, driver and riders alike,
        counts one ``batched_requests``; the batch's size stays in the
        thread's slot (``last_batched_with``)."""
        from .execution.tracing import QueryCounters

        self._account_counters(QueryCounters(batched_requests=1))
        self._thread_accounting.batched_with = batched_with

    @property
    def last_batched_with(self):
        """The size of the fused batch that served this thread's last
        statement, or None where it ran on its own."""
        return getattr(self._thread_accounting, "batched_with", None)

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
    def last_exec_trace(self):
        """The fragment modes of the last distributed plan this thread ran,
        ``[(node label, "mesh" | "coordinator" | "local", reason)]`` (what
        EXPLAIN ANALYZE prints for a distributed run), or None after a
        statement that ran none."""
        return getattr(self._thread_accounting, "exec_trace", None)

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

    def _executor(self, page_cache: Optional[bool] = None):
        """A fresh executor over the engine's buffer pool (``page_cache``:
        the session's override)."""
        from .exec.local_executor import LocalExecutor

        ex = LocalExecutor(self.catalogs, self.device, memory_pool=self.memory_pool,
                           buffer_pool=self.buffer_pool)
        ex.page_cache = page_cache
        return ex

    def _run_counted(self, ex, run):
        """(run(), counters): ``run`` drives ``ex`` while its launches, host
        reads and H2D bytes count in one set, folded into the statement."""
        from .execution import tracing

        counters = tracing.QueryCounters()
        try:
            with tracing.track_counters(counters):
                return run(), counters
        finally:
            counters.host_reads += ex.host_reads
            counters.host_bytes += ex.host_bytes
            counters.h2d_bytes += ex.h2d_bytes
            self._account_counters(counters)

    def _run_plan(self, plan, page_cache: Optional[bool] = None, params=None,
                  memo: bool = False, query_max_memory: Optional[int] = None,
                  dispatch_batch: Optional[int] = None):
        """(result, counters, executor) of one plan on a fresh executor;
        ``params``: a template's bound slots; ``memo``: the plan runs again
        (a statement's cached plan), so its estimates and fingerprint go
        through the engine's plan memo.  One-off plans (eager subqueries,
        DML row evaluation, EXPLAIN ANALYZE) compute them for the run
        alone, and push no statement's plan out of the memo.
        ``query_max_memory``: the statement's limit in bytes (None: none).
        ``dispatch_batch``: the statement's coalescing width (None: the
        process default); the executor is the statement's own, so the width
        ends with it.  A plan that runs again keeps its captured scan-fused
        graphs in the engine's cache; a one-off plan's end with its run."""
        ex = self._executor(page_cache)
        ex.memory_pool.begin_query(query_max_memory)
        ex.exec_params = params
        ex.dispatch_batch = dispatch_batch
        if memo:
            ex.plan_memo = self._plan_memo
            ex.use_fused_cache(self._fused_cache)
        result, counters = self._run_counted(ex, lambda: ex.execute(plan))
        return result, counters, ex

    def execute_plan(self, plan, cache: bool = True, page_cache: Optional[bool] = None,
                     params: Optional[tuple] = None,
                     query_max_memory: Optional[int] = None,
                     distributed: bool = False, mesh=None, fault_tolerant: bool = False,
                     dispatch_batch: Optional[int] = None):
        """Run a plan to a host-side ``MaterializedResult`` (also the
        planner's entry point for eager subqueries, which pass
        ``cache=False``).  As in the reference, ``cache=False`` still reads
        and fills the buffer pool's page and build tiers: the reference's
        flag keeps the plan's compiled pipelines out of its executor pool,
        and the port keeps none.  As in the reference, only ``cache=True``
        runs feed the plan history, on clean completion.  ``params`` is a
        plan template's bound slot tuple; ``query_max_memory`` the
        statement's limit in bytes, as in the reference.  ``distributed``
        runs the plan on the worker mesh ``mesh`` (``exec/distributed.py``);
        ``fault_tolerant`` through the task-retrying executor over a spooled
        exchange (``exec/fte.py``; reference: RetryPolicy.TASK), one per
        engine over a temporary spool, sharing the engine's pools; templates
        execute locally only, as in the reference.  ``dispatch_batch`` is
        the statement's coalescing width on every path (None: the process
        default, ``TRINO_TPU_DISPATCH_BATCH``)."""
        if params is not None and (distributed or fault_tolerant):
            raise ValueError("parameterized template plans execute locally only")
        if fault_tolerant:
            return self._execute_fault_tolerant(plan, dispatch_batch)
        if distributed:
            ex = self._distributed_executor(mesh, dispatch_batch)
            try:
                result = ex.execute(plan)
                self._thread_accounting.exec_trace = list(ex.exec_trace)
                # clean completion only: the per-exchange shard skew joins
                # the plan history under the actuals' node paths
                self._record_shard_skew(plan, ex)
                return result
            finally:
                self._account_counters(ex.counters)
        result, _, ex = self._run_plan(plan, page_cache, params, memo=cache,
                                       query_max_memory=query_max_memory,
                                       dispatch_batch=dispatch_batch)
        if cache:
            self._record_plan_history(plan, ex)
        return result

    def _execute_fault_tolerant(self, plan, dispatch_batch: Optional[int] = None):
        import tempfile

        from .exec.fte import FaultTolerantExecutor
        from .execution import tracing

        with self._totals_lock:  # statements run on several threads
            if getattr(self, "_fte_executor", None) is None:
                self._fte_spool = tempfile.mkdtemp(prefix="trino_tpu_torch_spool_")
                self._fte_executor = FaultTolerantExecutor(
                    self.catalogs, self._fte_spool, device=self.device,
                    memory_pool=self.memory_pool, buffer_pool=self.buffer_pool)
        # the executor drives its private LocalExecutor past execute(), so
        # the query's spend records on a counter set of its own here
        counters = tracing.QueryCounters()
        try:
            with tracing.track_counters(counters):
                return self._fte_executor.execute(plan, dispatch_batch=dispatch_batch)
        finally:
            self._account_counters(counters)

    def _distributed_executor(self, mesh, dispatch_batch: Optional[int] = None):
        """A fresh distributed executor over ``mesh`` (None: every visible
        card), whose devices must all be the engine's; its local executor
        coalesces at ``dispatch_batch``."""
        from .exec.distributed import DistributedExecutor
        from .parallel.mesh import same_device, worker_mesh

        mesh = mesh if mesh is not None else worker_mesh()
        stray = [str(d) for d in mesh.devices if not same_device(d, self.device)]
        if stray:
            raise ValueError(f"mesh devices {sorted(set(stray))} differ from the "
                             f"engine's device {self.device}")
        return DistributedExecutor(self.catalogs, mesh=mesh, memory_pool=self.memory_pool,
                                   dispatch_batch=dispatch_batch)

    def _record_shard_skew(self, plan, ex) -> None:
        """Fold a clean distributed run's per-exchange shard skew
        (``DistributedExecutor.skew_by_node``) into ``plan_history`` under
        the node paths the cardinality actuals use.  A host walk of records
        the exchange already made: no launch, no read; a failure leaves the
        statement successful and the store unchanged."""
        skew = getattr(ex, "skew_by_node", None)
        ph = self.plan_history
        if not skew or ph is None or not ph.enabled:
            return
        try:
            from .exec.local_executor import _plan_fingerprint
            from .execution.history import plan_node_paths

            paths = plan_node_paths(plan)
            recs = {}
            for nid, rec in skew.items():
                path = paths.get(nid)
                if path is None:
                    continue
                recs[path] = {"skew": {
                    "ratio": float(rec.get("ratio", 1.0)),
                    "worker": int(rec.get("worker", 0)),
                    "workers": int(rec.get("workers", 0)),
                    "imbalance_s": float(rec.get("imbalance_s", 0.0)),
                }}
            if recs:
                ph.record(_plan_fingerprint(plan, self.catalogs), recs)
        except Exception:  # noqa: BLE001 - observability never fails a statement
            pass

    # -- plan history and adaptive execution (reference: Engine._record_plan_history)
    def _record_plan_history(self, plan, ex, extra_records: Optional[dict] = None) -> None:
        """Fold one cleanly completed execution's per-node actuals into
        ``plan_history`` and publish the statement's payload (this thread's
        slot for the completion event, and ``last_plan_actuals``).  A host
        walk plus one batched read of the row counts the executor kept on
        the device: no launch, no counted host read.  ``extra_records``
        folds in records from elsewhere under the same fingerprint (the
        cluster coordinator's harvest of its workers).  A failure here
        leaves the statement successful and the store unchanged."""
        acct = self._thread_accounting
        sql = getattr(acct, "history_sql", None)
        acct.history_sql = None
        ph = self.plan_history
        if ph is None or not ph.enabled:
            return
        try:
            from .execution.history import collect_plan_actuals, fold_records

            recs = collect_plan_actuals(
                plan, ex.stats, boundary=ex.boundary, catalogs=self.catalogs,
                paths=ex._node_paths, ests=ex._node_ests, facts=ex._plan_facts)
            for path, rec in (extra_records or {}).items():
                fold_records(recs, path, rec)
            if not recs:
                return
            fp = ex.plan_fingerprint(plan)
            payload = ph.record(fp, recs, sql=sql)
            acct.plan_actuals = payload
            with self._totals_lock:
                self.last_plan_actuals = payload
            self._adaptive_observe(fp, recs, sql)
        except Exception:  # noqa: BLE001 - history never fails a statement
            pass

    def _adaptive_observe(self, fp, recs, sql) -> None:
        """Feed one clean completion back to the advisor: the node walls'
        sum is the wall, and the price of a re-plan is what this statement
        spent planning on a plan-cache miss (``compiles=1``, ``compile_s``
        the planner's seconds) and nothing on a hit.  The key, corrected and
        planning slots are one-shot: read and cleared here."""
        acct = self._thread_accounting
        akey = getattr(acct, "adaptive_key", None)
        corrected = bool(getattr(acct, "adaptive_corrected", False))
        plan_s = getattr(acct, "plan_s", None)
        acct.adaptive_key = None
        acct.adaptive_corrected = False
        acct.plan_s = None
        adv = self.adaptive_advisor
        if adv is None or akey is None:
            return
        try:
            wall = sum(float(r.get("wall_s") or 0.0)
                       for r in recs.values() if isinstance(r, dict))
            adv.observe(akey, fp, corrected=corrected, wall_s=wall,
                        compiles=1 if plan_s is not None else 0,
                        compile_s=float(plan_s or 0.0), sql=sql)
        except Exception:  # noqa: BLE001 - advisory
            pass

    def _adaptive_consult(self, key, sess, peek: bool = False):
        """The advisor's decision for this statement key: None unless
        adaptive execution is on for the session and history holds a
        material, actionable misestimate."""
        adv = self.adaptive_advisor
        if adv is None or not _effective_adaptive(sess):
            return None
        try:
            return adv.consult(key, peek=peek)
        except Exception:  # noqa: BLE001 - advisory
            return None

    def _adaptive_note_base(self, key, sess) -> None:
        """Mark this execution as the statement's uncorrected run: the
        observe hook anchors the advisor's history address, wall EWMA and
        price on it."""
        if self.adaptive_advisor is None or not _effective_adaptive(sess):
            return
        self._thread_accounting.adaptive_key = key
        self._thread_accounting.adaptive_corrected = False

    def _plan_timed(self, sess, ast, key, qsm):
        """Plan ``ast`` under a ``planner`` span and store it under ``key``;
        its seconds are this statement's re-plan price for the advisor."""
        from .sql.frontend import Planner

        with self.tracer.span("planner", trace_id=qsm.query_id) as span:
            # planning and the version snapshot are atomic with respect to
            # the system catalog's dictionary growth
            with self._plan_lock:
                plan = Planner(self, sess).plan_query(ast)
                self._cache_store(key, plan)
        self._thread_accounting.plan_s = span.duration_s
        return plan

    def _execute_corrected(self, sql, key, adaptive, sess, qsm):
        """Run the statement on its corrected plan: the frozen corrections
        ride the planner's session as ``_adaptive_corrections``
        (``sql/exchanges``), and the plan caches under ``key`` plus the
        correction token, so corrected and uncorrected plans never share a
        plan-cache or result-tier entry.  NotImplemented when the statement
        is not a SELECT after all."""
        from .execution.query_state import QueryState
        from .sql import parser as A

        akey = key + (("adaptive", adaptive["token"]),)
        with self._plan_lock:
            plan = self._cache_lookup(akey)
        if plan is None:
            if qsm.state != QueryState.RUNNING:
                qsm.transition(QueryState.PLANNING)
            ast = A.parse(sql)
            if not isinstance(ast, (A.Select, A.SetOp)):
                return NotImplemented
            plan = self._plan_timed(
                _session_with_corrections(sess, adaptive.get("corrections") or {}),
                ast, akey, qsm)
        self._check_select_access(plan, sess.user)
        acct = self._thread_accounting
        acct.adaptive = adaptive
        acct.adaptive_key = key
        acct.adaptive_corrected = True
        if qsm.state != QueryState.RUNNING:
            qsm.transition(QueryState.STARTING)
        return self._run_select(sql, plan, sess, qsm, adaptive=adaptive)

    # -- introspection ------------------------------------------------------------
    def memory_info(self) -> list:
        """The memory pool's snapshot (labeled ``pool0``), with the card's
        allocator counters on a CUDA engine, and the buffer pool's labeled
        reservations (``buffer-pool``, once it stored an entry): the
        /v1/status and /v1/metrics pool surface."""
        d = self.memory_pool.info()
        d["pool"] = "pool0"
        if self.device.type == "cuda":
            st = torch.cuda.memory_stats(self.device)
            d["device_allocated_bytes"] = int(st.get("allocated_bytes.all.current", 0))
            d["device_reserved_bytes"] = int(st.get("reserved_bytes.all.current", 0))
            d["device_peak_allocated_bytes"] = int(st.get("allocated_bytes.all.peak", 0))
        out = [d]
        bpool = self.buffer_pool.memory_pool
        if bpool is not None:
            b = bpool.info()
            b["pool"] = "buffer-pool"
            out.append(b)
        return out

    def _memory_admission_ok(self) -> bool:
        """The resource groups' admission gate: False while the engine's
        pool, which every executor the engine makes reserves from, is past
        the killer's ``BLOCKED_FRACTION``.  Called under the group manager's
        lock; the pool's own lock is the only one it takes."""
        from .execution.memory_killer import BLOCKED_FRACTION

        return not self.memory_pool.blocked(BLOCKED_FRACTION)

    def _on_stall(self, report: dict) -> None:
        """The watchdog's report: kept for /v1/status, and recorded as a
        flight event so it outlives the process in the disk ring."""
        self.last_stall_report = report
        self.flight_recorder.record_event(dict(report, kind="stall"))

    def _stall_extra(self) -> dict:
        """Memory context attached to every stall report."""
        return {"memory": self.memory_info()}

    def health(self) -> dict:
        """Live health verdict: "stalled" when the watchdog's threshold is
        set and an in-flight entry is past it (recomputed from the registry,
        not the last poll); "compiling" when everything past it is a launch
        that triggered the kernel build, still under the build threshold;
        else "ok"."""
        wd = self.stall_watchdog
        status, stalled_n, compiling_n = wd.status()
        return {"status": status, "stalled": stalled_n, "compiling": compiling_n,
                "inflight": self.inflight.depth(),
                "watchdog": {"enabled": wd.enabled, "stall_s": wd.stall_s,
                             "compile_stall_s": wd.compile_stall_s,
                             "kill_s": wd.kill_s, "reports": wd.reports,
                             "kills": wd.kills}}

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
                    distributed: bool = False, mesh=None,
                    fault_tolerant: bool = False,
                    parameters: Optional[list] = None):
        """Statement entry point (reference: DispatchManager.createQuery ->
        resource-group admission -> SqlQueryExecution for queries;
        coordinator-only tasks for the other statements).  Every statement
        moves through the query state machine and fires listener events.

        ``parameters`` is the protocol-level EXECUTE form: ``sql`` carries
        ``?`` markers and ``parameters`` the python values to bind, through
        the statement's plan template where it has one, else substituted as
        literals.  ``distributed`` runs a SELECT on the worker mesh ``mesh``
        (``parallel/mesh.worker_mesh``; None: every visible card), whose
        devices must be the engine's.  ``fault_tolerant`` runs a SELECT
        through the task-retrying executor (``execute_plan``)."""
        from .execution import tracing

        from .execution.query_state import QueryState, QueryStateMachine

        sess = session or Session()
        acct = self._thread_accounting
        # cleared first: a statement that fails admission must not leave this
        # thread holding the previous statement's counters or trace
        acct.snap = None
        acct.trace = None
        acct.batched_with = None
        acct.exec_trace = None
        # the statement's plan-history payload, and the advisor's slots: its
        # admission decision, the key its feedback keys on, whether this
        # execution runs a corrected plan, and the planning seconds (the
        # re-plan price); the statement text for consumers that see the AST
        acct.plan_actuals = None
        acct.adaptive = None
        acct.adaptive_key = None
        acct.adaptive_corrected = False
        acct.plan_s = None
        acct.stmt_sql = None
        self.access_control.check_can_execute_query(sess.user)
        qid = f"query_{next(_query_ids)}"
        group = self.resource_groups.get_or_create(f"global.{sess.user}")
        qsm = QueryStateMachine(qid, sql, sess.user, sess.catalog, group.full_name)
        self.query_tracker.register(qsm)
        self.event_listeners.query_created(qsm)
        admitted = threading.Event()
        queued_on_memory: list = []  # the admission gate deferred it
        self.resource_groups.submit(
            group, admitted.set,
            queued=lambda: qsm.transition(QueryState.WAITING_FOR_RESOURCES),
            queued_on_memory=lambda: queued_on_memory.append(1))
        admitted.wait()
        totals = tracing.QueryCounters()
        outer = getattr(acct, "stmt", None)
        acct.stmt = totals
        try:
            qsm.transition(QueryState.DISPATCHING)
            with tracing.query_scope(qid), tracing.activate_tracer(self.tracer), \
                    tracing.track_counters(totals), \
                    self.tracer.span("query", trace_id=qid, sql=sql):
                result = self._execute_admitted(sql, sess, qsm, parameters,
                                                distributed, mesh, fault_tolerant)
            if result is not None and hasattr(result, "__len__"):
                qsm.rows = len(result)
            qsm.transition(QueryState.FINISHING)
            qsm.transition(QueryState.FINISHED)
            return result
        except BaseException as e:
            qsm.fail(str(e))
            # a corrected plan that fails is demoted at once (the advisor's
            # cooldown); the bookkeeping never masks the error
            if acct.adaptive_corrected and acct.adaptive_key is not None:
                try:
                    self.adaptive_advisor.failed(acct.adaptive_key)
                except Exception:  # noqa: BLE001
                    pass
            raise
        finally:
            acct.stmt = outer
            acct.history_sql = None
            if queued_on_memory:
                # deferred before the statement's counters existed
                totals.admission_queued += 1
            adec = acct.adaptive
            if adec is not None:
                # decided at admission, stamped on the statement's counters
                field = "adaptive_replans" if adec.get("verdict") == "replan" \
                    else "adaptive_holds"
                setattr(totals, field, getattr(totals, field) + 1)
            with self._totals_lock:
                self.counters_total.merge(totals)
            acct.snap = totals
            root = self._finish_query_trace(qid, queued_s=qsm.info().queued_s or 0)
            qsm.counters = totals.as_dict()
            qsm.plan_actuals = acct.plan_actuals
            qsm.adaptive = adec
            qsm.root_span_duration_s = root.duration_s if root else None
            # completed and errored statements alike; a recorder failure
            # never fails the statement
            try:
                self._record_flight(qsm, totals)
            except Exception:  # noqa: BLE001
                pass
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

    def _record_flight(self, qsm, snap) -> None:
        """One flight record of a finished statement, from what this thread
        already holds: the counters, the trace and its wall breakdown, the
        plan actuals, the advisor's decision, the fused batch size, and the
        statement's kernel builds from the compile log.  Dict assembly on
        the host: no launch, no host read."""
        from .execution.flightrecorder import pressure_rung

        fr = self.flight_recorder
        if not fr.enabled:
            return
        acct = self._thread_accounting
        info = qsm.info()
        trace = getattr(acct, "trace", None) or {}
        try:
            sql = _normalize_statement(qsm.sql)
        except Exception:  # noqa: BLE001
            sql = qsm.sql
        try:
            compile_events = self.compile_log.for_query(qsm.query_id)
        except Exception:  # noqa: BLE001
            compile_events = []
        counters = snap.as_dict()
        fr.record_query({
            "query_id": qsm.query_id,
            "state": info.state,
            "sql": sql,
            "user": info.user,
            "catalog": info.catalog,
            "error": info.error,
            "created_s": info.created_s,
            "ended_s": info.ended_s,
            "wall_s": info.wall_s,
            "queued_s": info.queued_s,
            "rows": info.rows,
            "counters": counters,
            "compiles": snap.compiles,
            "compile_s": round(snap.compile_s, 6),
            "compile_events": compile_events,
            "shard_stats": [dict(r) for r in snap.shard_stats] or None,
            "pressure_rung": pressure_rung(counters),
            "trace": {"root_span_s": trace.get("root_span_s"),
                      "spans": trace.get("spans") or []},
            "wall_breakdown": trace.get("wall_breakdown"),
            "plan_actuals": getattr(acct, "plan_actuals", None),
            "adaptive": getattr(acct, "adaptive", None),
            "batched_with": getattr(acct, "batched_with", None),
            "stall_report": self.last_stall_report
            if self.health().get("status") == "stalled" else None,
        })

    def _execute_admitted(self, sql: str, sess: Session, qsm, parameters=None,
                          distributed: bool = False, mesh=None, fault_tolerant: bool = False):
        from .execution.query_state import QueryState
        from .sql import parser as A

        if parameters is not None:
            # protocol-level EXECUTE: ``sql`` carries ? markers and the values
            # arrived out of band.  The template path first; else the values
            # substitute as literals and the statement runs as any other
            from .server.dbapi import _substitute
            from .sql import params as PRM

            param_asts = tuple(PRM.value_to_literal_ast(v) for v in parameters)
            if not distributed and not fault_tolerant:  # templates run locally only
                handled, res = self._maybe_template_execute(sql, param_asts, sess,
                                                            qsm=qsm)
                if handled:
                    return res
            vals = [PRM.literal_param_value(p) for p in param_asts]
            return self._execute_admitted(_substitute(sql, vals), sess, qsm,
                                          distributed=distributed, mesh=mesh,
                                          fault_tolerant=fault_tolerant)
        # the user is in the key (row filters and column masks make plans
        # user-specific), and so are the plan-shaping session properties and
        # whether the statement runs distributed; the text is normalized, so
        # reformatted repeats share a plan
        key = (_normalize_statement(sql), sess.catalog, distributed, sess.user,
               _plan_shape_props(sess))
        local = not distributed and not fault_tolerant
        # the advisor first (local statements only): a frozen "replan"
        # diverts even a warm statement to its corrected plan
        adaptive = self._adaptive_consult(key, sess) if local else None
        if adaptive is not None and adaptive.get("verdict") == "replan":
            res = self._execute_corrected(sql, key, adaptive, sess, qsm)
            if res is not NotImplemented:
                return res
            adaptive = None  # not a SELECT after all
        if adaptive is not None:
            # a counted hold: a material misestimate the advisor declined
            self._thread_accounting.adaptive = adaptive
        with self._plan_lock:
            plan = self._cache_lookup(key)
        if plan is not None:
            self._check_select_access(plan, sess.user)
            if local:
                self._adaptive_note_base(key, sess)
            return self._run_select(sql, plan, sess, qsm, distributed=distributed,
                                    mesh=mesh, fault_tolerant=fault_tolerant)
        if local and self.plan_templates_enabled:
            # auto-parameterization: SELECTs equal up to their literals share
            # one template; the extraction is token-level and conservative,
            # and a misjudged text fails template creation and plans below
            from .sql import params as PRM

            ext = PRM.parameterize_text(sql)
            if ext is not None:
                handled, res = self._maybe_template_execute(ext[0], ext[1], sess, qsm=qsm)
                if handled:
                    return res
        if qsm.state != QueryState.RUNNING:
            # a failed template probation already moved the machine to
            # RUNNING: planning again must not move it back
            qsm.transition(QueryState.PLANNING)
        ast = A.parse(sql)
        if isinstance(ast, (A.Select, A.SetOp)):
            # scalar and EXISTS subqueries execute while the query plans
            plan = self._plan_timed(sess, ast, key, qsm)
            self._check_select_access(plan, sess.user)
            if local:
                self._adaptive_note_base(key, sess)
            if qsm.state != QueryState.RUNNING:
                qsm.transition(QueryState.STARTING)
            return self._run_select(sql, plan, sess, qsm, distributed=distributed,
                                    mesh=mesh, fault_tolerant=fault_tolerant)
        qsm.transition(QueryState.RUNNING)
        # the statement's text for consumers that see only its AST (EXPLAIN
        # recovers its inner statement's plan-cache key from it)
        self._thread_accounting.stmt_sql = sql
        return self._execute_statement(ast, sess, distributed=distributed, mesh=mesh)

    def _run_select(self, sql: str, plan, sess: Session, qsm, adaptive=None,
                    distributed: bool = False, mesh=None, fault_tolerant: bool = False):
        """A planned SELECT, cached plan or fresh: the result tier first (a
        hit answers with no launch, no host read and no H2D copy, after
        admission, so the statement is tracked and access-checked like any
        other), else the plan runs and its result is stored on clean
        completion.  A corrected run (``adaptive``) keys its result by the
        correction token.  ``distributed`` runs the plan on the mesh
        ``mesh``, with a result key of its own."""
        from .execution.query_state import QueryState

        rkey = self._result_cache_key(sql, plan, sess, distributed=distributed,
                                      fault_tolerant=fault_tolerant)
        if rkey is not None and adaptive is not None:
            rkey = rkey + (("adaptive", adaptive["token"]),)
        # the epoch the statement starts under: an invalidation while it runs
        # refuses its late store
        epoch = self.buffer_pool.epoch if rkey is not None else None
        if rkey is not None:
            served = self._result_cache_fetch(rkey)
            if served is not None:
                qsm.transition(QueryState.RUNNING)
                return served
        qsm.transition(QueryState.RUNNING)
        # the statement text for the plan-history record (read and cleared
        # by _record_plan_history)
        self._thread_accounting.history_sql = sql
        # the advisor's dispatch_batch correction, where it made one, is the
        # statement's width (as in the reference, it overrides the session's)
        adv_batch = ((adaptive or {}).get("corrections") or {}).get("dispatch_batch")
        with self.tracer.span("execution", trace_id=qsm.query_id):
            result = self.execute_plan(plan, page_cache=_effective_page_cache(sess),
                                       query_max_memory=_query_mem_limit(self, sess),
                                       distributed=distributed, mesh=mesh,
                                       fault_tolerant=fault_tolerant,
                                       dispatch_batch=int(adv_batch) if adv_batch
                                       else _effective_dispatch_batch(sess))
        self._result_cache_finish(rkey, result, epoch, plan)
        return result

    # -- the result tier (reference: Engine._result_cache_*) ---------------------
    def _result_cache_key(self, sql: str, plan, sess: Session, distributed: bool = False,
                          fault_tolerant: bool = False):
        """The result-tier key, or None when the statement may not be served
        or stored: the tier is off (its budget, or the ``result_cache``
        session property), a scanned catalog is volatile (no
        CACHEABLE_SCANS: the system tables), or the text names a volatile
        function (they fold to constants while planning, so only the text
        shows them).  The key is (structural plan fingerprint, catalogs,
        distributed, fault-tolerant, plan-shaping properties); the
        fingerprint embeds each scan's plan_version."""
        bp = self.buffer_pool
        if not bp.result_enabled or _effective_result_cache(sess) is False:
            return None
        if _VOLATILE_SQL_RE.search(sql):
            return None
        from .exec.local_executor import _plan_fingerprint
        from .sql import plan as P

        catalogs: set = set()

        def walk(n):
            if isinstance(n, P.TableScan):
                catalogs.add(n.catalog)
            for cat, _tab in getattr(n, "source_tables", ()):
                catalogs.add(cat)
            for c in n.children:
                walk(c)

        walk(plan)
        for name in catalogs:
            conn = self.catalogs.get(name)
            if conn is None or not bp.cacheable(conn):
                return None
        return ("result", _plan_fingerprint(plan, self.catalogs), tuple(sorted(catalogs)),
                distributed, fault_tolerant, _plan_shape_props(sess))

    def _result_cache_fetch(self, rkey):
        """``rkey``'s cached result, or None.  A hit is accounted as a
        counter set of its own holding result_cache_hits=1 and nothing else:
        no launch, no host read, no H2D byte."""
        from .execution import tracing

        hit = self.buffer_pool.get_result(rkey)
        if hit is None:
            return None
        result, nbytes = hit
        counters = tracing.QueryCounters()
        with tracing.track_counters(counters):
            tracing.record_result_cache(hits=1, bytes_saved=nbytes)
        self._account_counters(counters)
        return result

    def _result_cache_finish(self, rkey, result, epoch, plan) -> None:
        """After a clean run of a statement the tier would take: count the
        miss and store the result (an error unwinds past this, so a failed
        statement never stores).  A store that fails leaves the statement
        successful and the entry absent; only the store is guarded."""
        if rkey is None:
            return
        from .execution import tracing

        counters = tracing.QueryCounters()
        with tracing.track_counters(counters):
            tracing.record_result_cache(misses=1)
        self._account_counters(counters)
        try:
            self.buffer_pool.put_result(rkey, result, epoch=epoch, anchor=plan)
        except Exception:  # noqa: BLE001 - uncached, not failed
            pass

    # -- statements (reference: Engine._execute_statement) ----------------------
    def _execute_statement(self, ast, sess: Session, distributed: bool = False, mesh=None):
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
            return self._explain(ast, sess, distributed=distributed, mesh=mesh)
        if isinstance(ast, A.CreateView):
            if not ast.or_replace and ast.name in self.views:
                raise ValueError(f"view {ast.name} already exists")
            self.views[ast.name] = ((), ast.query)
            self._invalidate()
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
            self._invalidate()  # cached plans may now resolve differently
            return None
        if isinstance(ast, A.DropFunction):
            if ast.name not in self.sql_routines and not ast.if_exists:
                raise ValueError(f"function {ast.name} does not exist")
            self.sql_routines.pop(ast.name, None)
            self._invalidate()
            return None
        if isinstance(ast, A.DropView):
            if ast.name not in self.views and not ast.if_exists:
                raise ValueError(f"view {ast.name} does not exist")
            self.views.pop(ast.name, None)
            self._invalidate()
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
            self._invalidate()
            return None
        if isinstance(ast, A.Grant):
            return self._grant(ast, sess)
        if isinstance(ast, A.DropTable):
            conn = self._writable_catalog(sess)
            self.access_control.check_can_write(
                sess.user, self._catalog_name_of(conn), ast.name, "drop table")
            conn.drop_table(ast.name, ast.if_exists)
            self._invalidate()
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
        """EXECUTE name [USING ...]: through the statement's plan template
        (no parse, analyze or plan once it exists), else the parameters
        substitute as literals into the prepared text, which runs inside
        this statement (no second admission)."""
        from .server.dbapi import _substitute
        from .sql import params as PRM

        text = sess.prepared.get(ast.name)
        if text is None:
            raise ValueError(f"prepared statement {ast.name} not found")
        handled, result = self._maybe_template_execute(text, tuple(ast.parameters), sess)
        if handled:
            return result
        # literal extraction raises a typed error for unsupported parameter
        # AST kinds (sql/params) instead of silently mis-substituting
        vals = [PRM.literal_param_value(p) for p in ast.parameters]
        return self._run_sql_inline(_substitute(text, vals), sess)

    def _run_sql_inline(self, sql: str, sess: Session):
        """Run a statement without re-entering admission (EXECUTE runs inside
        the outer statement's resource-group slot)."""
        from .sql import parser as A
        from .sql.frontend import Planner

        key = (_normalize_statement(sql), sess.catalog, False, sess.user,
               _plan_shape_props(sess))
        with self._plan_lock:
            plan = self._cache_lookup(key)
        if plan is None:
            ast = A.parse(sql)
            if not isinstance(ast, (A.Select, A.SetOp)):
                return self._execute_statement(ast, sess)
            with self._plan_lock:
                plan = Planner(self, sess).plan_query(ast)
                self._cache_store(key, plan)
        self._check_select_access(plan, sess.user)
        return self.execute_plan(plan, page_cache=_effective_page_cache(sess))

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

    def _explain(self, ast, sess: Session, distributed: bool = False, mesh=None):
        """EXPLAIN renders the physical plan (the distribution pass's
        Exchange markers included; under a frozen correction, the corrected
        plan the next execution runs); EXPLAIN ANALYZE runs the plan, feeds
        the plan history as any clean run does, and adds the per-node rows,
        walls, estimates and boundary records, its counters, the advisor's
        decision, the wall breakdown and the timing."""
        from .exec.local_executor import MaterializedResult
        from .sql.frontend import Planner
        from .sql.planprinter import format_plan
        from .types import VarcharType

        plan = Planner(self, sess).plan_query(ast.query)
        self._check_select_access(plan, sess.user)  # ANALYZE executes the query
        # the advisor keys the inner statement by its plan-cache key,
        # recovered from the statement text; plain EXPLAIN only peeks
        decision, akey = None, None
        acct = self._thread_accounting
        stmt = getattr(acct, "stmt_sql", None)
        if stmt is not None and not distributed:
            m = re.match(r"\s*EXPLAIN\s+(?:ANALYZE\s+)?", stmt, re.IGNORECASE)
            if m:
                akey = (_normalize_statement(stmt[m.end():]), sess.catalog, False,
                        sess.user, _plan_shape_props(sess))
                decision = self._adaptive_consult(akey, sess, peek=not ast.analyze)
        if ast.analyze and distributed:
            # run through the mesh executor and report each fragment's ACTUAL
            # mode: mesh, coordinator, or local with the reason
            ex = self._distributed_executor(mesh)
            t0 = time.perf_counter()
            try:
                res = ex.execute(plan)
            finally:
                self._account_counters(ex.counters)
            dt = time.perf_counter() - t0
            self._record_shard_skew(plan, ex)
            lines = format_plan(plan, counters=ex.counters,
                                skew=ex.skew_by_node).split("\n")
            lines += ["", "Fragment execution (distributed run):"]
            for label, mode, reason in ex.exec_trace:
                note = f" — {reason}" if reason else ""
                lines += [f"  [{mode}] {label}{note}"]
            lines += [f"-- executed in {dt * 1000:.1f} ms, {len(res)} output rows"]
        elif ast.analyze:
            if decision is not None and decision.get("verdict") == "replan":
                # ANALYZE runs what the serving path would: the corrected plan
                plan = Planner(self, _session_with_corrections(
                    sess, decision.get("corrections") or {})).plan_query(ast.query)
                self._check_select_access(plan, sess.user)
                acct.adaptive = decision
                acct.adaptive_key = akey
                acct.adaptive_corrected = True
            elif akey is not None:
                if decision is not None:
                    acct.adaptive = decision
                self._adaptive_note_base(akey, sess)
            t0 = time.perf_counter()
            t0_wall = time.time()
            res, counters, ex = self._run_plan(plan, _effective_page_cache(sess),
                                               dispatch_batch=_effective_dispatch_batch(sess))
            dt = time.perf_counter() - t0
            t1_wall = time.time()
            self._record_plan_history(plan, ex)
            lines = format_plan(plan, ex.stats, counters=counters, boundary=ex.boundary,
                                ests=ex._node_ests, paths=ex._node_paths,
                                breakdown=self._analyze_breakdown(t0_wall, t1_wall),
                                adaptive=decision).split("\n")
            lines += [f"-- executed in {dt * 1000:.1f} ms, {len(res)} output rows"]
        else:
            from .sql.exchanges import physical_plan

            props = getattr(sess, "properties", None)
            if decision is not None and decision.get("verdict") == "replan":
                props = dict(props or {})
                props["_adaptive_corrections"] = decision.get("corrections") or {}
            phys = physical_plan(plan, self.catalogs, props)
            lines = format_plan(phys, adaptive=decision).split("\n")
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
        """EXPLAIN [ANALYZE] EXECUTE name [USING ...]: the statement's plan
        template disposition.  With a template, its plan and the cached line
        (ANALYZE runs it, and its counters show the hit); an unbindable text,
        the substitution line; otherwise the line of a template the first
        EXECUTE creates."""
        import time

        from .exec.local_executor import MaterializedResult
        from .sql.planprinter import format_plan
        from .types import VarcharType

        ex_ast = ast.query
        text = sess.prepared.get(ex_ast.name)
        if text is None:
            raise ValueError(f"prepared statement {ex_ast.name} not found")
        key = self._template_key(text, sess)
        if ast.analyze:
            t0 = time.perf_counter()
            res = self._execute_prepared(ex_ast, sess)
            dt = time.perf_counter() - t0
            with self._plan_lock:
                tpl = self._template_lookup(key)
            if isinstance(tpl, _PlanTemplate):
                lines = format_plan(tpl.plan, counters=self._thread_accounting.stmt
                                    ).split("\n")
            else:
                lines = ["Plan template: unbindable — substitution path"]
            lines += [f"-- executed in {dt * 1000:.1f} ms, "
                      f"{len(res) if res is not None else 0} output rows"]
        else:
            with self._plan_lock:
                tpl = self._template_lookup(key)
            if isinstance(tpl, _PlanTemplate):
                lines = format_plan(tpl.plan).split("\n")
                lines.append(f"Plan template: cached, {len(tpl.binders)} bound "
                             f"slot(s) over {tpl.n_params} parameter(s)")
            elif tpl is _TEMPLATE_UNBINDABLE:
                lines = ["Plan template: unbindable — substitution path"]
            else:
                lines = ["Plan template: not yet created (first EXECUTE plans it)"]
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
            if part is not None and not isinstance(part, (tuple, list)):
                raise ValueError("partitioned_by must be ARRAY['col', ...]")
            if part is not None:
                import inspect

                if "partitioned_by" not in inspect.signature(
                        conn.create_table).parameters:
                    raise ValueError("this catalog does not support partitioned_by")
                conn.create_table(ast.name, Schema(fields), partitioned_by=tuple(part),
                                  if_not_exists=ast.if_not_exists)
            else:
                conn.create_table(ast.name, Schema(fields), if_not_exists=ast.if_not_exists)
        self._invalidate()
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
        self._invalidate()
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
        self._invalidate()
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
        n = conn.delete_rows(ast.table, self._dml_mask(res.columns[0]))
        self._invalidate()
        return _dml_count_result(n)

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
        n = conn.update_rows(ast.table, mask, values)
        self._invalidate()
        return _dml_count_result(n)

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
            self._invalidate()

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
            self._invalidate()
        return None


# -- cache keys and the session properties they read -------------------------------------


def _normalize_statement(sql: str) -> str:
    """Plan-cache key form of a statement: comments stripped, whitespace
    collapsed, so reformatted repeats share a plan."""
    from .sql.params import normalize_sql

    return normalize_sql(sql)


def _query_mem_limit(engine, sess):
    """query_max_memory session property -> bytes limit (None = unlimited)."""
    try:
        v = int(engine.session_properties.get(sess, "query_max_memory"))
    except Exception:  # noqa: BLE001
        return None
    return v if v > 0 else None


def _plan_shape_props(sess) -> tuple:
    """The session properties that change a plan, in every plan-cache and
    result-tier key: SET SESSION of one of them must replan a cached
    statement.  The tuple is the reference's: ``join_distribution_type``
    (the physical plan's joins), ``dispatch_batch`` (which the port's
    executor does not act on) and ``adaptive_execution``, resolved as the
    reference resolves them (the session, else ``TRINO_TPU_DISPATCH_BATCH``,
    4, and ``TRINO_TPU_ADAPTIVE``, on), so that the keys of both packages
    move together."""
    props = getattr(sess, "properties", None) or {}
    return (str(props.get("join_distribution_type", "AUTOMATIC")).upper(),
            _effective_dispatch_batch(sess), _effective_adaptive(sess))


def _effective_dispatch_batch(sess) -> int:
    """``dispatch_batch`` when the session set it above 0, else the process
    default ``TRINO_TPU_DISPATCH_BATCH`` (4), as the reference resolves it."""
    from .exec.local_executor import _dispatch_batch_default

    props = getattr(sess, "properties", None) or {}
    try:
        v = int(props.get("dispatch_batch", 0) or 0)
    except (TypeError, ValueError):
        v = 0
    return v if v > 0 else _dispatch_batch_default()


def _effective_adaptive(sess) -> bool:
    """``adaptive_execution`` when the session set it, else the
    ``TRINO_TPU_ADAPTIVE`` process default (on unless "0").  Plan-shaping:
    sessions with the advisor on and off never share a cache key, so SET
    SESSION adaptive_execution = false escapes a corrected plan."""
    import os

    props = getattr(sess, "properties", None) or {}
    v = props.get("adaptive_execution")
    if v is not None:
        return bool(v)
    return os.environ.get("TRINO_TPU_ADAPTIVE", "1") != "0"


def _session_with_corrections(sess, corrections):
    """A shallow copy of ``sess`` carrying the advisor's frozen corrections
    for the planner (``sql/exchanges`` reads ``_adaptive_corrections``).  The
    session itself is never changed: the corrected plan's cache key carries
    the correction token instead."""
    import copy

    corr_sess = copy.copy(sess)
    props = dict(getattr(sess, "properties", None) or {})
    props["_adaptive_corrections"] = corrections
    corr_sess.properties = props
    return corr_sess


def _effective_page_cache(sess):
    """The ``page_cache`` session property: True or False where the session
    set it, None (the pool's budget decides) otherwise.  Not plan-shaping:
    where scan pages come from never changes the plan."""
    v = (getattr(sess, "properties", None) or {}).get("page_cache")
    return None if v is None else bool(v)


def _effective_result_cache(sess):
    """The ``result_cache`` session property, as ``page_cache``."""
    v = (getattr(sess, "properties", None) or {}).get("result_cache")
    return None if v is None else bool(v)


# plans the plan cache keeps (least recently used out first)
PLAN_CACHE_ENTRIES = 256


@dataclasses.dataclass
class _PlanTemplate:
    """A plan template: the plan holds ``ir.Parameter`` runtime inputs where
    the statement had its values; ``binders`` (``sql/params.Binder``, slot
    order) encode each request's literals into the domain its slot was
    planned in.  ``confirmed`` flips after the first successful execution:
    until then any failure demotes the text to substitution.  ``batchable``
    flips off the first time a fused batch raises ``BatchUnsupported``."""

    text: str
    plan: object
    binders: tuple
    n_params: int
    confirmed: bool = False
    batchable: bool = True


# negative entry: this text cannot template (a parameter consumed while
# planning, a plan outside the subset); the entry holds the literal kinds
_TEMPLATE_UNBINDABLE = object()


def _template_plan_ok(plan) -> bool:
    """The template subset, the reference's: scan, filter and project
    chains, TopN, Sort, Limit, Values and Union.  Aggregates, joins and
    windows stay on the substitution path."""
    from .sql import plan as P

    allowed = (P.Output, P.Project, P.Filter, P.TableScan, P.Limit, P.Sort,
               P.Union, P.Values)

    def walk(n) -> bool:
        return isinstance(n, allowed) and all(walk(c) for c in n.children)

    return walk(plan)


def _null_ctx():
    import contextlib

    return contextlib.nullcontext()


# Volatile functions fold to constants while the statement plans, so the
# result tier tests the TEXT for them: a word match, which may keep a column
# named "random" out of the tier and never lets a volatile call in.
_VOLATILE_SQL = ("now", "current_timestamp", "current_date", "current_time",
                 "localtimestamp", "localtime", "random", "rand", "uuid")
_VOLATILE_SQL_RE = re.compile(r"\b(" + "|".join(_VOLATILE_SQL) + r")\b", re.IGNORECASE)


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
