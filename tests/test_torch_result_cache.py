"""The buffer pool's result tier of the port (``trino_tpu_torch/engine.py``
``_result_cache_*``, ``execution/bufferpool.py``) against the JAX package on
the CPU.

Restates tests/test_result_cache.py: a warm hit byte-identical to the run it
stored, with no launch, no host read, no H2D byte and no executor; INSERT and
DDL invalidate; a catalog's version bump invalidates; a plan-shaping session
property misses; volatile functions and connectors stay out; LRU and the
per-entry cap under a tiny budget; concurrent runs of one statement store
once; a store is refused after an invalidation while the statement ran;
errors never store; the EXPLAIN ANALYZE line, the /v1/metrics series and
``system.queries``; the tier off by default; the chaos matrix's three
``RESULT_SCENARIOS`` (checkout and store faults recover byte-identical, no
entry is admitted under a store fault, the leak check is clean).

Budgets are set with ``monkeypatch.setenv`` on both packages before their
engines first use the pool.  Where both packages answer a statement, their
results agree: integers, decimals, dates and strings exactly, DOUBLE within
rtol 1e-9.  test_cluster_coordinator_serves_from_result_cache is restated
in tests/test_torch_cluster.py.
"""

import os
import sys
import threading

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution.chaos_matrix import (RESULT_SCENARIOS, result_signature,
                                                    run_result_scenario)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 14
BUDGET = 64 << 20

Q_AGG = """
select l_returnflag, l_linestatus, sum(l_quantity) s, count(*) c
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""

Q_JOIN = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10"""

Q_POINT = "select c_name, c_acctbal from customer where c_custkey = 7"


@pytest.fixture(scope="module")
def ref():
    """The reference's result of a statement over TPC-H, its result tier
    on and its page tier off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRINO_TPU_RESULT_CACHE", str(BUDGET))
        mp.setenv("TRINO_TPU_PAGE_CACHE", "0")
        e = JaxEngine()
        e.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
        e.buffer_pool.budget()
        e.buffer_pool.result_budget()
    memo = {}

    def run(sql, props=()):
        if (sql, props) not in memo:
            s = e.create_session("tpch")
            for k, v in props:
                e.session_properties.set_property(s, k, v)
            memo[(sql, props)] = e.execute_sql(sql, s)
        return memo[(sql, props)]

    return run


def _engine(monkeypatch, budget=BUDGET, conn=None):
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(budget))
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn or TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e


def _assert_same(a, b):
    """Byte-identical: each decoded and raw column's dtype and values."""
    cols = lambda r: [np.asarray(c) for c in r.columns] + \
        [np.asarray(c) for c in r.raw_columns]  # noqa: E731
    for x, y in zip(cols(a), cols(b), strict=True):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f")


def _same_ref(got, want, sql):
    chip_smoke.same_outcome_result(got, want, sql, sql)


def _hit_only(c):
    """A result-tier hit's counters: the hit and nothing else."""
    assert c["result_cache_hits"] == 1 and c["result_cache_misses"] == 0, c
    assert c["launches"] == {} and c["host_reads"] == 0 and c["host_bytes"] == 0 \
        and c["h2d_bytes"] == 0, c
    assert c["page_cache_hits"] == c["page_cache_misses"] == 0
    assert c["build_cache_hits"] == c["build_cache_misses"] == 0
    assert c["result_cache_bytes_saved"] > 0


@pytest.mark.parametrize("sql", [Q_AGG, Q_JOIN, Q_POINT], ids=["agg", "join", "point"])
def test_warm_hit_counts_nothing_and_is_byte_identical(monkeypatch, ref, sql):
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    off = e.create_session("tpch")
    e.session_properties.set_property(off, "result_cache", False)
    r_off = e.execute_sql(sql, off)
    c = e.last_query_counters
    assert c["result_cache_hits"] == 0 and c["result_cache_misses"] == 0
    r1 = e.execute_sql(sql, s)  # a miss the tier takes: runs and stores
    c = e.last_query_counters
    assert c["result_cache_misses"] == 1 and c["result_cache_hits"] == 0
    r2 = e.execute_sql(sql, s)
    _hit_only(e.last_query_counters)
    _assert_same(r_off, r1)
    _assert_same(r_off, r2)
    _same_ref(r2, ref(sql), sql)


def test_hit_makes_no_executor(monkeypatch, ref):
    import trino_tpu_torch.exec.local_executor as LE

    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    e.execute_sql(Q_POINT, s)
    made = []
    real = LE.LocalExecutor.__init__
    monkeypatch.setattr(LE.LocalExecutor, "__init__",
                        lambda self, *a, **k: made.append(1) or real(self, *a, **k))
    r = e.execute_sql(Q_POINT, s)
    _hit_only(e.last_query_counters)
    assert not made, "a served statement made an executor"
    _same_ref(r, ref(Q_POINT), Q_POINT)


@pytest.mark.parametrize("write", [
    "insert into t values (3, 70)",
    "delete from t where k = 1",
    "update t set v = v + 1 where k = 2",
    "merge into t using (select 2 k2, 5 v2) s on k = k2 "
    "when matched then update set v = v2",
    "create table u (x bigint)",
], ids=["insert", "delete", "update", "merge", "ddl"])
def test_writes_invalidate(monkeypatch, write):
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(BUDGET))
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", str(1 << 30))
    outs = []
    for e in (JaxEngine(), Engine(device="cpu")):
        torch_side = isinstance(e, Engine)
        e.register_catalog("mem", MemoryConnector() if torch_side else JaxMemory())
        s = e.create_session("mem")
        e.execute_sql("create table t (k bigint, v bigint)", s)
        e.execute_sql("insert into t values (1, 10), (2, 20)", s)
        e.execute_sql("select sum(v) s, count(*) c from t", s)
        e.execute_sql("select sum(v) s, count(*) c from t", s)
        if torch_side:
            _hit_only(e.last_query_counters)
            info = e.buffer_pool.info()
            assert info["result_entries"] == 1 and info["page_entries"] == 1
        e.execute_sql(write, s)
        if torch_side:  # every tier is empty, and every byte released
            assert e.buffer_pool.info()["entries"] == 0
            assert e.buffer_pool.memory_pool.reserved == 0
        outs.append(e.execute_sql("select sum(v) s, count(*) c from t", s))
        if torch_side:
            assert e.last_query_counters["result_cache_misses"] == 1
    _same_ref(outs[1], outs[0], "select sum(v) s, count(*) c from t")
    assert outs[1].rows() != [(30, 2)] or write.startswith("create"), \
        "stale result served after the write"


class _VersionedTpch(TpchConnector):
    """A cacheable connector with a plan_version to bump (the shape of a
    growable catalog)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.version = 0

    def plan_version(self) -> int:
        return self.version


def test_catalog_version_bump_invalidates(monkeypatch, ref):
    conn = _VersionedTpch(sf=SF, split_rows=SPLIT_ROWS)
    e = _engine(monkeypatch, conn=conn)
    s = e.create_session("tpch")
    e.execute_sql(Q_POINT, s)
    e.execute_sql(Q_POINT, s)
    _hit_only(e.last_query_counters)
    conn.version += 1
    # the stale plan replans and the catalog's entries go: the old one can
    # neither serve (its fingerprint holds version 0) nor keep its bytes
    r = e.execute_sql(Q_POINT, s)
    c = e.last_query_counters
    assert c["result_cache_hits"] == 0 and c["result_cache_misses"] == 1
    assert e.buffer_pool.info()["result_entries"] == 1
    e.execute_sql(Q_POINT, s)
    _hit_only(e.last_query_counters)
    _same_ref(r, ref(Q_POINT), Q_POINT)


@pytest.mark.parametrize("prop,value", [("join_distribution_type", "PARTITIONED"),
                                        ("dispatch_batch", 1)])
def test_plan_shaping_property_change_misses(monkeypatch, ref, prop, value):
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    e.execute_sql(Q_JOIN, s)
    e.execute_sql(Q_JOIN, s)
    _hit_only(e.last_query_counters)
    e.session_properties.set_property(s, prop, value)
    r = e.execute_sql(Q_JOIN, s)
    c = e.last_query_counters
    assert c["result_cache_hits"] == 0 and c["result_cache_misses"] == 1
    _same_ref(r, ref(Q_JOIN, ((prop, value),)), Q_JOIN)


def test_volatile_functions_and_connectors_excluded(monkeypatch):
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    for sql in ("select n_name, now() t from nation",
                "select count(*) c from system.queries"):
        e.execute_sql(sql, s)
        e.execute_sql(sql, s)
        c = e.last_query_counters
        assert c["result_cache_hits"] == 0 and c["result_cache_misses"] == 0
    assert e.buffer_pool.info()["result_entries"] == 0


def test_lru_eviction_and_entry_cap_under_tiny_budget(monkeypatch, ref):
    e = _engine(monkeypatch, budget=2048)
    s = e.create_session("tpch")
    for sql in ("select count(*) c from region group by r_regionkey",
                "select count(*) c from nation group by n_nationkey",
                "select count(*) c from region group by r_regionkey"):
        _same_ref(e.execute_sql(sql, s), ref(sql), sql)
    info = e.buffer_pool.info()
    assert info["result_bytes"] <= 2048
    assert e.buffer_pool.memory_pool.reserved == info["bytes"]
    # past the per-entry cap (a quarter of the budget): skipped, not an error
    big = "select c_custkey, c_name, c_acctbal from customer"
    _same_ref(e.execute_sql(big, s), ref(big), big)
    assert e.buffer_pool.info()["result_bytes"] <= 2048
    assert e.buffer_pool.memory_pool.reserved == e.buffer_pool.info()["bytes"]


def test_concurrent_runs_of_one_statement_store_once(monkeypatch, ref):
    e = _engine(monkeypatch)
    first = e.execute_sql(Q_JOIN, e.create_session("tpch"))
    results, errors = [None] * 6, []

    def run(i):
        try:
            results[i] = e.execute_sql(Q_JOIN, e.create_session("tpch"))
        except Exception as ex:  # noqa: BLE001 - raised in the main thread below
            errors.append(ex)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for r in results:
        _assert_same(first, r)
    _same_ref(first, ref(Q_JOIN), Q_JOIN)
    info = e.buffer_pool.info()
    assert info["result_entries"] == 1 and info["result_hits"] >= 1, info
    assert e.buffer_pool.memory_pool.reserved == info["bytes"]
    e._invalidate()
    assert e.buffer_pool.info()["entries"] == 0
    assert e.buffer_pool.memory_pool.reserved == 0


def test_store_refused_after_invalidation_mid_statement(monkeypatch, ref):
    """An invalidation that lands while a SELECT runs refuses its late
    store: its result may predate the write."""
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    bp = e.buffer_pool
    r = e.execute_sql(Q_POINT, s)
    key = ("result", "fp-under-test", (), False, False, ())
    epoch = bp.epoch
    bp.clear()
    assert bp.put_result(key, r, epoch=epoch) is False
    assert bp.put_result(key, r, epoch=bp.epoch) is True
    bp.clear()
    # through the engine: a write's invalidation while the plan runs
    real = e.execute_plan

    def concurrent_write(plan, *a, **k):
        out = real(plan, *a, **k)
        e._invalidate()
        return out

    monkeypatch.setattr(e, "execute_plan", concurrent_write)
    got = e.execute_sql(Q_POINT, s)
    assert e.last_query_counters["result_cache_misses"] == 1
    assert bp.info()["result_entries"] == 0
    monkeypatch.setattr(e, "execute_plan", real)
    e.execute_sql(Q_POINT, s)
    assert bp.info()["result_entries"] == 1
    _same_ref(got, ref(Q_POINT), Q_POINT)


def test_errors_never_store(monkeypatch, ref):
    import trino_tpu_torch.exec.local_executor as LE

    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    real = LE.LocalExecutor._materialize

    def failing(self, *a, **k):
        raise RuntimeError("materialization failed")

    monkeypatch.setattr(LE.LocalExecutor, "_materialize", failing)
    with pytest.raises(RuntimeError, match="materialization failed"):
        e.execute_sql(Q_AGG, s)
    assert e.buffer_pool.info()["result_entries"] == 0, "an errored statement stored"
    monkeypatch.setattr(LE.LocalExecutor, "_materialize", real)
    e.execute_sql(Q_AGG, s)
    r = e.execute_sql(Q_AGG, s)
    _hit_only(e.last_query_counters)
    _same_ref(r, ref(Q_AGG), Q_AGG)


@pytest.mark.parametrize("scenario", [n for n, _s, _k in RESULT_SCENARIOS])
def test_chaos_result_scenarios(monkeypatch, ref, scenario):
    """The chaos matrix's result-tier rows: checkout and store faults are
    recoverable and byte-identical, no entry is admitted under a store
    fault, the leak check passes, and the result is the reference's."""
    spec, kind = next((s, k) for n, s, k in RESULT_SCENARIOS if n == scenario)
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    e.execute_sql(Q_AGG, s)  # cold
    r = e.execute_sql(Q_AGG, s)
    base = result_signature(r)
    rec = run_result_scenario(e, Q_AGG, s, base, scenario, spec, kind)
    assert rec.get("ok"), rec
    assert rec["fires"] >= 1
    _same_ref(r, ref(Q_AGG), Q_AGG)
    e._invalidate()


def test_explain_analyze_metrics_and_system_queries(monkeypatch):
    from trino_tpu_torch.server.server import CoordinatorServer
    from trino_tpu_torch.sql import parser as A
    from trino_tpu_torch.sql.frontend import Planner
    from trino_tpu_torch.sql.planprinter import format_plan

    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    e.execute_sql(Q_AGG, s)
    e.execute_sql(Q_AGG, s)
    _hit_only(e.last_query_counters)
    snap = e.query_tracker.all_queries()[-1].counters
    from trino_tpu_torch.execution.tracing import QueryCounters

    counters = QueryCounters(**{k: v for k, v in snap.items()
                                if k in QueryCounters.__dataclass_fields__})
    text = format_plan(Planner(e, s).plan_query(A.parse(Q_AGG)), counters=counters)
    assert f"Result cache: 1 hits, 0 misses, {snap['result_cache_bytes_saved']} " \
           "bytes saved" in text, text
    body = CoordinatorServer(e)._metrics_text()
    assert "trino_tpu_result_cache_hits_total 1" in body
    assert "trino_tpu_result_cache_misses_total 1" in body
    assert "trino_tpu_result_cache_entries 1" in body
    rows = e.execute_sql("select query_id, result_cache_hits from system.queries "
                         "where result_cache_hits > 0", s).rows()
    assert len(rows) == 1, rows


def test_off_by_default_without_env(monkeypatch, ref):
    monkeypatch.delenv("TRINO_TPU_RESULT_CACHE", raising=False)
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    s = e.create_session("tpch")
    e.execute_sql(Q_POINT, s)
    r = e.execute_sql(Q_POINT, s)
    c = e.last_query_counters
    assert c["result_cache_hits"] == 0 and c["result_cache_misses"] == 0
    assert c["host_reads"] > 0
    assert e.buffer_pool.info()["result_entries"] == 0
    _same_ref(r, ref(Q_POINT), Q_POINT)
