"""The port's control plane against the JAX package on the CPU.

Restates, against ``trino_tpu_torch``:

- tests/test_control_plane.py: the state machines, resource groups, listener
  events, admission, session properties, SHOW, the system tables, the span
  tree, PREPARE / EXECUTE / DEALLOCATE and SHOW STATS;
- the engine cases of tests/test_security.py: rule-based SELECT and write
  checks, filtered SHOW TABLES, GRANT / REVOKE, row filters and column masks;
- tests/test_dbapi_verifier.py: the in-process DB-API and the verifier, whose
  control is the reference engine and whose test is the port.

Where the reference and the port both answer a statement, the results must
agree: integers, decimals, dates and strings exactly, DOUBLE within rtol 1e-9.
Also the per-statement accounting under concurrent statements (ROADMAP C5):
two threads inside ``execute_plan`` at once each read their own counters;
and the plan-cache key's process defaults (ROADMAP C9): with
``TRINO_TPU_ADAPTIVE`` and ``TRINO_TPU_DISPATCH_BATCH`` set, both packages
resolve the plan-shaping properties alike; and the retry classification of
a template's probation failure (ROADMAP C11): a first run killed by
``query_max_memory``, or failed by a fatal injected fault, stores the
template as unbindable in both packages.
"""

import datetime
import os
import sys
import threading

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from trino_tpu_torch.execution.eventlistener import EventListener
from trino_tpu_torch.execution.query_state import QueryState, QueryStateMachine
from trino_tpu_torch.execution.resourcegroups import (QueryQueueFullError, ResourceGroup,
                                                      ResourceGroupManager)
from trino_tpu_torch.execution.statemachine import StateMachine
from trino_tpu_torch.server import dbapi
from trino_tpu_torch.spi.security import (AccessDeniedError, AllowAllAccessControl,
                                          GrantBasedAccessControl, RuleBasedAccessControl)
from trino_tpu_torch.verifier import Verifier, VerifierQuery

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _engine(sf=0.001, split_rows=1 << 12):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(sf=sf, split_rows=split_rows))
    return e


@pytest.fixture(scope="module")
def ref():
    """One reference engine for the file, over the scale of
    tests/test_control_plane.py."""
    e = JaxEngine()
    e.register_catalog("tpch", JaxTpch(sf=0.001, split_rows=1 << 12))
    return e


def _same(a, b, sql):
    chip_smoke.same_outcome_result(a, b, sql, sql)


# -- tests/test_control_plane.py -----------------------------------------------------------


def test_state_machine_listeners_and_terminal():
    sm = StateMachine("t", "A", terminal_states=["C"])
    seen = []
    sm.add_state_change_listener(seen.append)
    assert seen == ["A"]  # fires with current state on registration
    assert sm.set("B")
    assert sm.compare_and_set("B", "C")
    assert not sm.set("A")  # terminal
    assert seen == ["A", "B", "C"]
    assert sm.is_terminal


def test_query_state_machine_flow():
    q = QueryStateMachine("q1", "select 1")
    for s in (QueryState.DISPATCHING, QueryState.PLANNING, QueryState.RUNNING,
              QueryState.FINISHING, QueryState.FINISHED):
        assert q.transition(s)
    assert q.is_done and q.state == QueryState.FINISHED
    assert q.info().wall_s is not None
    q2 = QueryStateMachine("q2", "select 1")
    q2.fail("boom")
    assert q2.state == QueryState.FAILED and q2.error == "boom"


def test_engine_tracks_queries_and_fires_events():
    e = _engine()
    s = e.create_session("tpch")
    events = []

    class L(EventListener):
        def query_created(self, ev):
            events.append(("created", ev.query_id))

        def query_completed(self, ev):
            events.append(("completed", ev.query_id, ev.state, ev.rows))

    e.event_listeners.add(L())
    r = e.execute_sql("select count(*) from nation", s)
    assert r.rows()[0][0] == 25
    infos = [q.info() for q in e.query_tracker.all_queries()]
    assert any(i.state == "FINISHED" and i.rows == 1 for i in infos)
    assert [ev[0] for ev in events] == ["created", "completed"]
    assert events[1][2] == "FINISHED" and events[1][3] == 1
    with pytest.raises(Exception):
        e.execute_sql("select no_such_column from nation", s)
    infos = [q.info() for q in e.query_tracker.all_queries()]
    assert any(i.state == "FAILED" and i.error for i in infos)
    assert events[-1][2] == "FAILED"


def test_resource_group_queueing_and_fairness():
    mgr = ResourceGroupManager(ResourceGroup("global", hard_concurrency_limit=1))
    g = mgr.get_or_create("global.user")
    order = []

    def mk(i):
        return lambda: order.append(i)

    mgr.submit(g, mk(0))
    mgr.submit(g, mk(1))  # queued (limit 1)
    mgr.submit(g, mk(2))  # queued
    assert order == [0]
    mgr.finish(g)  # releases slot -> starts 1
    assert order == [0, 1]
    mgr.finish(g)
    assert order == [0, 1, 2]
    mgr.finish(g)
    info = {i["name"]: i for i in mgr.info()}
    assert info["global.user"]["running"] == 0 and info["global.user"]["queued"] == 0


def test_resource_group_queue_full():
    mgr = ResourceGroupManager(ResourceGroup("global", hard_concurrency_limit=1))
    g = mgr.get_or_create("global.u")
    g.max_queued = 1
    mgr.submit(g, lambda: None)
    mgr.submit(g, lambda: None)
    with pytest.raises(QueryQueueFullError):
        mgr.submit(g, lambda: None)


def test_engine_concurrent_queries_respect_admission():
    e = _engine()
    e.resource_groups.root.hard_concurrency_limit = 2
    s = e.create_session("tpch")
    e.execute_sql("select count(*) from region", s)
    results = []

    def run():
        results.append(e.execute_sql("select count(*) from region", s).rows()[0][0])

    ts = [threading.Thread(target=run) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert results == [5, 5, 5, 5]


def test_session_properties_sql():
    e = _engine()
    s = e.create_session("tpch")
    e.execute_sql("set session task_concurrency = 4", s)
    assert e.session_properties.get(s, "task_concurrency") == 4
    e.execute_sql("set session join_distribution_type = 'BROADCAST'", s)
    assert e.session_properties.get(s, "join_distribution_type") == "BROADCAST"
    d = {r[0]: r[1] for r in e.execute_sql("show session", s).rows()}
    assert d["task_concurrency"] == "4"
    e.execute_sql("reset session task_concurrency", s)
    assert e.session_properties.get(s, "task_concurrency") == 8
    with pytest.raises(ValueError):
        e.execute_sql("set session no_such_prop = 1", s)
    with pytest.raises(ValueError):
        e.execute_sql("set session task_concurrency = 'abc'", s)


def test_session_properties_are_the_references():
    """The same names, types and defaults; SHOW SESSION equal row for row."""
    from trino_tpu.execution.session_properties import SYSTEM_SESSION_PROPERTIES as REF
    from trino_tpu_torch.execution.session_properties import SYSTEM_SESSION_PROPERTIES as PORT

    assert {k: (m.type, m.default) for k, m in REF.items()} == \
        {k: (m.type, m.default) for k, m in PORT.items()}


@pytest.mark.parametrize("mode", ["PARTITIONED", "BROADCAST"])
def test_join_distribution_type_reaches_explain(ref, mode):
    """The one session property the port acts on changes the plan as the
    reference's does: EXPLAIN of Q3 under it equals the reference's."""
    e = _engine()
    sql = "explain " + chip_smoke.QUERIES["q3"]
    default = e.execute_sql(sql, e.create_session("tpch")).rows()
    got = []
    for eng in (ref, e):
        s = eng.create_session("tpch")
        eng.execute_sql(f"set session join_distribution_type = '{mode}'", s)
        got.append(eng.execute_sql(sql, s).rows())
    assert got[0] == got[1]
    markers = chip_smoke.join_markers(got[1])
    assert got[1] != default and set(markers["joins"]) == {mode.lower()}


@pytest.mark.parametrize("sql", [
    "show catalogs", "show tables", "show schemas", "show columns from nation",
    "show functions", "show stats for orders", "show stats for lineitem",
    "show create table nation", "show session",
    "explain select n_name from nation where n_regionkey = 1 order by n_name",
    "explain select o_orderpriority, count(*) from orders group by o_orderpriority",
    "explain select count(*) from orders, customer where o_custkey = c_custkey "
    "and c_mktsegment = 'BUILDING'",
])
def test_show_and_explain_equal_the_reference(ref, sql):
    e = _engine()
    a = ref.execute_sql(sql, ref.create_session("tpch"))
    b = e.execute_sql(sql, e.create_session("tpch"))
    assert a.rows() == b.rows(), sql


@pytest.mark.parametrize("sql", [
    "explain execute p",
    "explain execute p using 3",
    "explain analyze execute p using 3",
], ids=["explain", "explain_using", "explain_analyze"])
def test_explain_execute_equals_the_reference(monkeypatch, sql):
    """ROADMAP C6: EXPLAIN [ANALYZE] EXECUTE prints the reference's lines for
    a statement without a plan template (templates off in both packages;
    tests/test_torch_plan_templates.py holds the lines with one).  The time
    in ANALYZE's last line is masked."""
    import re

    monkeypatch.setenv("TRINO_TPU_PLAN_TEMPLATES", "0")
    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=0.01, split_rows=1 << 14))
    t = TorchEngine(device="cpu")
    t.register_catalog("tpch", TorchTpch(sf=0.01, split_rows=1 << 14))
    got = []
    for e in (j, t):
        s = e.create_session("tpch")
        e.execute_sql("prepare p from select c_name from customer where c_custkey = ?", s)
        got.append([re.sub(r"executed in [0-9.]+ ms", "executed in T ms", r[0])
                    for r in e.execute_sql(sql, s).rows()])
    assert got[0] == got[1], got
    assert got[1][0].startswith("Plan template: ")


def test_show_statements():
    e = _engine()
    s = e.create_session("tpch")
    cats = [r[0] for r in e.execute_sql("show catalogs", s).rows()]
    assert "tpch" in cats and "system" in cats
    assert "lineitem" in [r[0] for r in e.execute_sql("show tables", s).rows()]
    cols = e.execute_sql("show columns from nation", s).rows()
    assert ("n_name", "varchar(25)") in [(c, t) for c, t in cols]
    fns = [r[0] for r in e.execute_sql("show functions", s).rows()]
    assert "sum" in fns and "substring" in fns


def test_explain_analyze_reports_the_run():
    e = _engine()
    r = e.execute_sql("explain analyze select count(*) c from orders where o_orderkey < 50",
                      e.create_session("tpch"))
    text = "\n".join(r.columns[0].tolist())
    assert "executed in" in text and "1 output rows" in text
    assert "Device boundary:" in text and "Wall breakdown:" in text


def test_system_tables():
    e = _engine()
    s = e.create_session("tpch")
    e.execute_sql("select count(*) from region", s)
    rows = e.execute_sql(
        "select state, count(*) c from system.queries group by state order by state",
        s).rows()
    assert "FINISHED" in {r[0] for r in rows}
    cats = e.execute_sql("select catalog_name from system.catalogs order by 1", s).rows()
    assert ("system",) in cats and ("tpch",) in cats
    t = e.execute_sql(
        "select table_name from system.tables where table_catalog = 'tpch' order by 1",
        s).rows()
    assert ("lineitem",) in t
    rg = e.execute_sql("select name, running from system.resource_groups", s).rows()
    assert any(r[0] == "global" for r in rg)
    # re-execution sees NEW queries (dictionaries grow in place, plans stay valid)
    n1 = e.execute_sql("select count(*) from system.queries", s).rows()[0][0]
    e.execute_sql("select count(*) from nation", s)
    n2 = e.execute_sql("select count(*) from system.queries", s).rows()[0][0]
    assert n2 > n1


def test_system_queries_carry_each_statements_counters():
    """device_dispatches of a finished statement: its kernel launches plus
    host reads (no launch on the CPU), as its counters recorded them."""
    e = _engine()
    s = e.create_session("tpch")
    e.execute_sql("select count(*) from lineitem", s)
    reads = e.last_query_counters["host_reads"]
    rows = e.execute_sql("select query, device_dispatches from system.queries", s).rows()
    assert ("select count(*) from lineitem", reads) in [(q, int(d)) for q, d in rows
                                                        if d is not None]


def test_information_schema_equals_the_reference(ref):
    e = _engine()
    sql = ("select table_catalog, table_name, column_name, ordinal_position, data_type "
           "from information_schema.columns where table_catalog = 'tpch' "
           "order by 1, 2, 4")
    # by value: the system dictionaries number the strings as each engine
    # met them
    assert _rows(ref.execute_sql(sql, ref.create_session("tpch"))) == \
        _rows(e.execute_sql(sql, e.create_session("tpch")))


def test_tracing_spans():
    e = _engine()
    s = e.create_session("tpch")
    e.execute_sql("select count(*) from part", s)
    qid = [q.query_id for q in e.query_tracker.all_queries()][-1]
    spans = e.tracer.spans_for(qid)
    assert {"query", "planner", "execution"} <= {sp.name for sp in spans}
    q = next(sp for sp in spans if sp.name == "query")
    pl = next(sp for sp in spans if sp.name == "planner")
    assert pl.parent_id == q.span_id
    assert q.duration_s is not None and q.status == "OK"
    assert e.last_query_trace["query_id"] == qid
    assert e.last_query_trace["wall_breakdown"]["wall_s"] >= 0


def test_prepared_statements(ref):
    e = _engine()
    s = e.create_session("tpch")
    rs = ref.create_session("tpch")
    for eng, sess in ((ref, rs), (e, s)):
        eng.execute_sql("prepare q from select count(*) from orders where o_orderkey <= ?",
                        sess)
        eng.execute_sql("prepare seg from "
                        "select count(*) from customer where c_mktsegment = ?", sess)
    assert e.execute_sql("execute q using 50", s).rows()[0][0] == 50
    assert e.execute_sql("execute q using 10", s).rows()[0][0] == 10
    n = e.execute_sql("execute seg using 'BUILDING'", s).rows()[0][0]
    assert n == e.execute_sql(
        "select count(*) from customer where c_mktsegment = 'BUILDING'", s).rows()[0][0]
    assert n == ref.execute_sql("execute seg using 'BUILDING'", rs).rows()[0][0]
    e.execute_sql("deallocate prepare q", s)
    with pytest.raises(Exception):
        e.execute_sql("execute q using 5", s)
    with pytest.raises(Exception):
        e.execute_sql("deallocate prepare nope", s)


def test_protocol_parameters_substitute_as_literals(ref):
    e = _engine()
    sql = "select count(*) c from orders where o_orderdate < ? and o_orderpriority = ?"
    vals = ["1995-03-15", "1-URGENT"]
    a = ref.execute_sql(sql, ref.create_session("tpch"), parameters=vals)
    b = e.execute_sql(sql, e.create_session("tpch"), parameters=vals)
    assert a.rows() == b.rows() and b.rows()[0][0] > 0


def test_show_stats():
    e = _engine()
    by_col = {r[0]: r for r in e.execute_sql("show stats for orders",
                                             e.create_session("tpch")).rows()}
    assert "o_orderkey" in by_col
    assert by_col[""][4] != ""
    lo, hi = by_col["o_orderkey"][2], by_col["o_orderkey"][3]
    assert lo in ("0", "1") and int(hi) > 0


# -- C5: per-statement accounting under concurrent statements ------------------------------


class _BarrierTpch(TorchTpch):
    """TPC-H whose first scan of each statement on a thread waits at a
    barrier, so that two statements are inside ``execute_plan`` at once."""

    barrier = None

    def generate(self, split, columns=None):
        b = self.barrier
        local = _BarrierTpch._seen
        if b is not None and not getattr(local, "done", False):
            local.done = True
            b.wait(timeout=60)
        return super().generate(split, columns)

    _seen = threading.local()


def test_concurrent_statements_read_their_own_counters():
    """C5: on the engine of 7eb1979 the two statements shared one
    ``_sql_totals`` slot, so one thread read the other's totals or zeros."""
    e = TorchEngine(device="cpu")
    conn = _BarrierTpch(sf=0.01, split_rows=1 << 12)
    e.register_catalog("tpch", conn)
    queries = ["select count(*) c from lineitem where l_quantity < 10",
               "select l_returnflag, sum(l_quantity) q, count(*) n from lineitem "
               "group by l_returnflag order by l_returnflag"]
    serial = []
    for sql in queries:
        e.execute_sql(sql, e.create_session("tpch"))
        serial.append(dict(e.last_query_counters))
    assert serial[0] != serial[1] and serial[0]["host_reads"] > 0
    conn.barrier = threading.Barrier(2)
    got, errors = [None, None], []

    def run(i):
        try:
            _BarrierTpch._seen.done = False
            e.execute_sql(queries[i], e.create_session("tpch"))
            got[i] = dict(e.last_query_counters)
        except Exception as ex:  # noqa: BLE001 - reported by the assertion
            errors.append(ex)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert got == serial
    # the lifetime totals hold both statements of each run
    for k in ("host_reads", "host_bytes", "h2d_bytes"):
        assert getattr(e.counters_total, k) == 2 * (serial[0][k] + serial[1][k])


def test_kernel_launch_counts_are_atomic_and_per_statement():
    """Launch counts from eight threads lose no increment, and each launch is
    charged to the counter set open on its own thread."""
    from trino_tpu_torch.execution import tracing
    from trino_tpu_torch.ops import cuda_kernels as ck

    stats = ck.KernelStats("probe_case", "", "")
    per_thread = []

    def launch():
        c = tracing.QueryCounters()
        with tracing.track_counters(c):
            for _ in range(2000):
                stats.record((1, 2), 1e-6)
        per_thread.append(c.launches)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert stats.launches == 16000
    assert per_thread == [{"probe_case": 2000}] * 8


# -- tests/test_security.py, the engine cases ----------------------------------------------

_RULES = {
    "catalogs": [
        {"user": "admin", "catalog": ".*", "allow": "all"},
        {"user": "analyst", "catalog": "tpch", "allow": "read-only"},
        {"user": "analyst", "catalog": "mem", "allow": "all"},
        {"user": "analyst", "catalog": "system", "allow": "read-only"},
    ],
    "tables": [
        {"user": "analyst", "catalog": "tpch", "table": "supplier", "allow": "none"},
    ],
}


@pytest.fixture()
def secured_engine():
    e = _engine(sf=0.01, split_rows=1 << 21)
    e.register_catalog("mem", TorchMemory())
    e.access_control = RuleBasedAccessControl(_RULES)
    return e


def _sess(e, user, catalog="tpch"):
    s = e.create_session(catalog)
    s.user = user
    return s


def test_select_rules(secured_engine):
    e = secured_engine
    assert e.execute_sql("select count(*) c from nation",
                         _sess(e, "analyst")).rows() == [(25,)]
    with pytest.raises(AccessDeniedError, match="supplier"):
        e.execute_sql("select count(*) from supplier", _sess(e, "analyst"))
    with pytest.raises(AccessDeniedError, match="supplier"):
        e.execute_sql("select count(*) from nation, supplier "
                      "where n_nationkey = s_nationkey", _sess(e, "analyst"))
    with pytest.raises(AccessDeniedError):
        e.execute_sql("select count(*) from nation", _sess(e, "intern"))
    assert e.execute_sql("select count(*) c from supplier",
                         _sess(e, "admin")).rows()[0][0] > 0


def test_read_only_blocks_writes(secured_engine):
    e = secured_engine
    s = _sess(e, "analyst", "mem")
    e.execute_sql("create table notes (id bigint)", s)  # mem: allow all
    e.execute_sql("insert into notes values (1)", s)
    assert e.execute_sql("select count(*) c from notes", s).rows() == [(1,)]
    with pytest.raises(AccessDeniedError):
        e.execute_sql("select count(*) c from notes", _sess(e, "intern", "mem"))
    # a read-only catalog refuses every write statement
    e.execute_sql("create table w (id bigint)", _sess(e, "admin", "mem"))
    for sql in ("insert into w values (1)", "delete from w", "update w set id = 2",
                "drop table w", "create table w2 as select 1 x"):
        with pytest.raises(AccessDeniedError):
            e.execute_sql(sql, _sess(e, "intern", "mem"))


def test_show_tables_filtered(secured_engine):
    e = secured_engine
    names = [t for (t,) in e.execute_sql("show tables", _sess(e, "analyst")).rows()]
    assert "nation" in names and "supplier" not in names


def test_grant_revoke():
    e = TorchEngine(device="cpu")
    e.register_catalog("mem", TorchMemory())
    e.access_control = GrantBasedAccessControl(admins=("admin",))
    admin = _sess(e, "admin", "mem")
    e.execute_sql("create table t1 (x bigint)", admin)
    e.execute_sql("insert into t1 values (7)", admin)
    bob = _sess(e, "bob", "mem")
    with pytest.raises(AccessDeniedError):
        e.execute_sql("select * from t1", bob)
    e.execute_sql("grant select on t1 to bob", admin)
    assert e.execute_sql("select x from t1", bob).rows() == [(7,)]
    with pytest.raises(AccessDeniedError):  # select does not confer insert
        e.execute_sql("insert into t1 values (8)", bob)
    e.execute_sql("grant insert on table t1 to bob", admin)
    e.execute_sql("insert into t1 values (8)", bob)
    e.execute_sql("revoke all privileges on t1 from bob", admin)
    with pytest.raises(AccessDeniedError):
        e.execute_sql("select * from t1", bob)
    with pytest.raises(AccessDeniedError):
        e.execute_sql("grant select on t1 to eve", bob)
    # the default access control refuses GRANT, as the reference's does
    e.access_control = AllowAllAccessControl()
    with pytest.raises(ValueError):
        e.execute_sql("grant select on t1 to bob", admin)


def test_row_filter_and_column_mask(ref):
    rules = {"tables": [{"user": "analyst", "table": "nation",
                         "filter": "n_regionkey = 1",
                         "column_masks": {"n_comment": "null"}}]}
    e = _engine()
    e.access_control = RuleBasedAccessControl(rules)
    sql = "select n_name, n_comment, n_regionkey from nation order by n_name"
    admin_rows = e.execute_sql(sql, _sess(e, "admin")).rows()
    assert len(admin_rows) == 25 and any(r[1] is not None for r in admin_rows)
    rows = e.execute_sql(sql, _sess(e, "analyst")).rows()
    assert len(rows) == 5 and {int(r[2]) for r in rows} == {1}
    assert all(r[1] is None for r in rows)
    assert len(e.execute_sql(sql, _sess(e, "admin")).rows()) == 25
    ref.access_control = RuleBasedAccessControl(rules)
    try:
        _same(ref.execute_sql(sql, _sess(ref, "analyst")),
              e.execute_sql(sql, _sess(e, "analyst")), sql)
    finally:
        ref.access_control = AllowAllAccessControl()


# -- tests/test_dbapi_verifier.py ----------------------------------------------------------


@pytest.fixture(scope="module")
def dbapi_engine():
    return _engine(sf=0.005, split_rows=1 << 11)


def test_dbapi_basic(dbapi_engine):
    conn = dbapi.connect(engine=dbapi_engine, catalog="tpch")
    cur = conn.cursor()
    cur.execute("select n_name, n_regionkey from nation order by n_nationkey limit 3")
    assert [d[0] for d in cur.description] == ["n_name", "n_regionkey"]
    rows = cur.fetchall()
    assert rows[0] == ("ALGERIA", 0) and len(rows) == 3
    assert all(isinstance(v, (str, int)) for r in rows for v in r)  # python scalars
    cur.execute("select count(*) from region")
    assert cur.fetchone() == (5,)
    assert cur.fetchone() is None
    conn.close()
    with pytest.raises(dbapi.InterfaceError):
        conn.cursor()


def test_dbapi_parameters(dbapi_engine):
    cur = dbapi.connect(engine=dbapi_engine, catalog="tpch").cursor()
    cur.execute("select count(*) from orders where o_orderdate < ? and o_orderkey > ?",
                (datetime.date(1995, 3, 15), 100))
    n = cur.fetchone()[0]
    cur.execute("""select count(*) from orders
                   where o_orderdate < date '1995-03-15' and o_orderkey > 100""")
    assert cur.fetchone()[0] == n
    cur.execute("select count(*) from nation where n_name = 'what?'")
    assert cur.fetchone()[0] == 0
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select ? ", ())


def test_dbapi_fetch_shapes_and_iter(dbapi_engine):
    cur = dbapi.connect(engine=dbapi_engine, catalog="tpch").cursor()
    cur.execute("select n_nationkey from nation order by n_nationkey")
    assert cur.rowcount == 25
    assert len(cur.fetchmany(10)) == 10
    assert len(cur.fetchall()) == 15
    cur.execute("select n_nationkey from nation order by n_nationkey limit 4")
    assert [r[0] for r in cur] == [0, 1, 2, 3]


def _rows(res):
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in r)
            for r in res.rows()]


def test_verifier_match_and_mismatch(ref):
    e = _engine()
    s, rs = e.create_session("tpch"), ref.create_session("tpch")
    control = lambda q: _rows(ref.execute_sql(q, rs))  # noqa: E731

    def broken(q):
        rows = _rows(e.execute_sql(q, s))
        return rows[:-1] if "region" in q else rows

    qs = [VerifierQuery("count_nation", "select count(*) from nation"),
          VerifierQuery("regions", "select r_name from region order by r_name"),
          VerifierQuery("bad_sql", "select nope from nowhere")]
    by = {r.name: r for r in Verifier(control, broken).run(qs)}
    assert by["count_nation"].status == "MATCH"
    assert by["regions"].status == "MISMATCH"
    assert by["bad_sql"].status == "CONTROL_FAILED"
    rep = Verifier.report(list(by.values()))
    assert "MISMATCH" in rep and "MATCH=1" in rep


def test_verifier_reference_control_port_test(ref):
    """The verifier qualifies the port against the reference: the control is
    the JAX engine, the test the port, over TPC-H shapes of both tests."""
    e = _engine()
    s, rs = e.create_session("tpch"), ref.create_session("tpch")
    qs = [VerifierQuery("q1ish", """select l_returnflag, count(*), sum(l_quantity)
                                    from lineitem group by l_returnflag
                                    order by l_returnflag"""),
          VerifierQuery("orders_by_prio", """select o_orderpriority, count(*)
                                             from orders group by o_orderpriority
                                             order by 1"""),
          VerifierQuery("q6ish", """select sum(l_extendedprice * l_discount) revenue
                                    from lineitem where l_discount between 0.05 and 0.07
                                    and l_quantity < 24""")]
    results = Verifier(lambda q: _rows(ref.execute_sql(q, rs)),
                       lambda q: _rows(e.execute_sql(q, s))).run(qs)
    assert all(r.status == "MATCH" for r in results), Verifier.report(results)


@pytest.mark.parametrize("env,props", [
    ({"TRINO_TPU_ADAPTIVE": "0", "TRINO_TPU_DISPATCH_BATCH": "8"}, {}),
    ({"TRINO_TPU_ADAPTIVE": "0", "TRINO_TPU_DISPATCH_BATCH": "8"},
     {"adaptive_execution": True, "dispatch_batch": 2}),
    ({"TRINO_TPU_ADAPTIVE": "1", "TRINO_TPU_DISPATCH_BATCH": "1"}, {}),
    ({"TRINO_TPU_DISPATCH_BATCH": "junk"}, {}),
    ({}, {}),
], ids=["env_off_8", "session_overrides", "env_on_1", "junk_batch", "unset"])
def test_plan_shape_env_defaults_equal_the_reference(monkeypatch, env, props):
    """ROADMAP C9: the port ignored both variables, giving ('AUTOMATIC', 4,
    True) where the reference gives ('AUTOMATIC', 8, False)."""
    from trino_tpu.engine import Session as JaxSession
    from trino_tpu.engine import _plan_shape_props as jax_props
    from trino_tpu_torch.engine import Session as TorchSession
    from trino_tpu_torch.engine import _plan_shape_props as torch_props

    for name in ("TRINO_TPU_ADAPTIVE", "TRINO_TPU_DISPATCH_BATCH"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = jax_props(JaxSession(catalog="tpch", properties=dict(props)))
    got = torch_props(TorchSession(catalog="tpch", properties=dict(props)))
    assert got == want
    if env.get("TRINO_TPU_ADAPTIVE") == "0" and not props:
        assert got == ("AUTOMATIC", 8, False)


def test_query_max_memory_kills_query_as_the_reference(tpch_sf001):
    """C10: tests/test_memory_spill.py's per-query kill.  Past
    ``query_max_memory`` both packages raise QueryMemoryLimitError naming
    the property; after a reset the join's count is the reference's; the
    limit is the statement's own and leaves the pool as it found it."""
    from trino_tpu.memory import QueryMemoryLimitError as JaxLimit
    from trino_tpu_torch.memory import QueryMemoryLimitError

    sql = ("select count(*) c from lineitem, orders "
           "where l_orderkey = o_orderkey")
    j = JaxEngine()
    j.register_catalog("tpch", tpch_sf001)
    t = TorchEngine(device="cpu")
    t.register_catalog("tpch", TorchTpch(sf=0.01))
    counts = []
    for e, err in ((j, JaxLimit), (t, QueryMemoryLimitError)):
        s = e.create_session("tpch")
        e.execute_sql("set session query_max_memory = 1024", s)
        with pytest.raises(err, match="query_max_memory"):
            e.execute_sql(sql, s)
        e.execute_sql("reset session query_max_memory", s)
        counts.append(int(e.execute_sql(sql, s).rows()[0][0]))
    assert counts[1] == counts[0] > 0
    assert t.memory_pool.reserved == 0
    assert t.flight_recorder.snapshot(kind="query")[-3]["state"] == "FAILED"
    j._invalidate()


@pytest.mark.parametrize("failure", ["query_max_memory", "fatal_fault"])
def test_template_probation_failure_is_classified_as_the_reference(monkeypatch, failure):
    """C11: a template whose first execution fails deterministically (a
    QueryMemoryLimitError, a FatalInjectedFaultError) is stored as
    unbindable for those literal kinds, as in the reference; the statement
    itself is answered by substitution.  The port's classifier is
    ``exec/fte.is_retryable_failure``, the reference's."""
    import trino_tpu.engine as JE
    import trino_tpu_torch.engine as TE
    from trino_tpu.exec.local_executor import LocalExecutor as JaxExecutor
    from trino_tpu.execution import faults as jfaults
    from trino_tpu.memory import QueryMemoryLimitError as JaxLimit
    from trino_tpu.sql.params import parameterize_text as jax_parameterize
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.execution import faults
    from trino_tpu_torch.memory import QueryMemoryLimitError
    from trino_tpu_torch.sql.params import parameterize_text

    sql = "select c_name from customer where c_custkey = 7"
    sides = (("jax", JaxEngine(), JaxTpch, JaxExecutor, JaxLimit, jfaults, JE,
              jax_parameterize),
             ("torch", TorchEngine(device="cpu"), TorchTpch, LocalExecutor,
              QueryMemoryLimitError, faults, TE, parameterize_text))
    rows = []
    for _pkg, e, conn, ex_cls, limit, mod, eng_mod, parameterize in sides:
        e.register_catalog("tpch", conn(sf=0.01, split_rows=1 << 11))
        s = e.create_session("tpch")
        with pytest.MonkeyPatch.context() as mp:
            if failure == "query_max_memory":
                real, calls = ex_cls.execute, []

                def execute(self, *a, _real=real, _calls=calls, _limit=limit, **k):
                    _calls.append(1)
                    if len(_calls) == 1:
                        raise _limit("query exceeded query_max_memory: the first run")
                    return _real(self, *a, **k)

                mp.setattr(ex_cls, "execute", execute)
                r = e.execute_sql(sql, s)
            else:
                with mod.injected("point=dispatch,action=fatal,nth=1") as plan:
                    r = e.execute_sql(sql, s)
                assert plan.total_fires() == 1
        entry = e._template_cache.get(e._template_key(parameterize(sql)[0], s))
        assert entry is not None and entry[0] is eng_mod._TEMPLATE_UNBINDABLE, entry
        assert entry[1] == ("NumberLit",)
        rows.append(r.rows())
    assert [str(v) for v in rows[1][0]] == [str(v) for v in rows[0][0]]
