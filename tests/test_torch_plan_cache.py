"""The port's plan cache and ``Engine._invalidate`` (``trino_tpu_torch/engine.py``)
against the JAX package on the CPU.

Restates tests/test_plan_templates.py::test_plan_cache_key_normalization (a
reformatted repeat of a cached statement does not plan again) and
tests/test_dispatch_batch.py::test_set_session_rides_plan_cache (SET SESSION
of a plan-shaping property replans a cached statement, RESET finds the first
plan again), with plan templates off in both packages
(``TRINO_TPU_PLAN_TEMPLATES=0``: a template would serve these statements
before the plan cache sees them; tests/test_torch_plan_templates.py holds
the templates).  Adds
one case for each statement after which the reference calls ``_invalidate``:
the plan cache and the buffer pool are empty after it, and the next SELECT
plans again and sees the write.  Where both packages answer a statement,
their results agree: integers, decimals, dates and strings exactly, DOUBLE
within rtol 1e-9.
"""

import os
import sys

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 14


def _spans(e):
    """Span names of the last statement this thread ran."""
    trace = e.last_query_trace if isinstance(e, Engine) else e._thread_accounting.trace
    return [s.get("name") for s in (trace or {}).get("spans", ())]


@pytest.fixture()
def engines(monkeypatch):
    """(reference, port) over TPC-H and a memory catalog, the tiers of the
    buffer pool on in both."""
    monkeypatch.setenv("TRINO_TPU_PLAN_TEMPLATES", "0")
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", str(1 << 30))
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(64 << 20))
    j, t = JaxEngine(), Engine(device="cpu")
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    t.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    j.register_catalog("memory", JaxMemory())
    t.register_catalog("memory", MemoryConnector())
    return j, t


def _both(engines, sql, sessions):
    """One statement in both packages; the results equal; the port's."""
    (j, t), (sj, st) = engines, sessions
    a, b = j.execute_sql(sql, sj), t.execute_sql(sql, st)
    assert (a is None) == (b is None), sql
    if a is not None:
        chip_smoke.same_outcome_result(b, a, sql, sql)
    return b


def test_plan_cache_key_normalization(engines):
    sessions = tuple(e.create_session("tpch") for e in engines)
    a = _both(engines, "select c_name from customer where c_custkey = 123", sessions)
    assert all("planner" in _spans(e) for e in engines)
    # the same statement reformatted and commented reuses the cached plan
    b = _both(engines, "select  c_name\n  from customer   -- trailing comment\n"
                       " where /* block\n comment */ c_custkey =     123", sessions)
    chip_smoke.same_outcome_result(a, b, "normalized", "normalized")
    for e in engines:
        assert "planner" not in _spans(e), "a reformatted repeat planned again"


def test_set_session_rides_plan_cache(engines):
    sql = chip_smoke.QUERIES["q3"]
    sessions = tuple(e.create_session("tpch") for e in engines)
    planned = []

    def run(stmt):
        _both(engines, stmt, sessions)
        planned.append(tuple("planner" in _spans(e) for e in engines))

    run(sql)
    run(sql)
    for stmt in ("set session dispatch_batch = 1", "reset session dispatch_batch",
                 "set session join_distribution_type = 'PARTITIONED'"):
        for e, s in zip(engines, sessions):
            e.execute_sql(stmt, s)
        run(sql)
        run(sql)
    # cold, warm; a new key plans, then hits; RESET finds the first plan;
    # the partitioned joins plan once more
    assert planned == [(True, True), (False, False), (True, True), (False, False),
                       (False, False), (False, False), (True, True), (False, False)]


# each statement after which the reference calls _invalidate, run over a
# memory table ``t`` of three rows that a SELECT has just read twice (its plan,
# its page and its result cached)
WRITES = {
    "insert": ["insert into t values (4, 40)"],
    "insert_select": ["insert into t select k + 10, v from t"],
    "delete": ["delete from t where k = 1"],
    "update": ["update t set v = v * 2 where k > 1"],
    "merge": ["merge into t using (select 2 sk, 7 sv) s on k = sk "
              "when matched then update set v = sv"],
    "create_table": ["create table u (x bigint)"],
    "ctas": ["create table u as select k from t"],
    "drop_table": ["create table u (x bigint)", "drop table u"],
    "create_view": ["create view w as select k from t"],
    "drop_view": ["create view w as select k from t", "drop view w"],
    "create_function": ["create function twice(x bigint) returns bigint return x * 2"],
    "drop_function": ["create function twice(x bigint) returns bigint return x * 2",
                      "drop function twice"],
    "create_mv": ["create materialized view m as select sum(v) s from t"],
    "refresh_mv": ["create materialized view m as select sum(v) s from t",
                   "refresh materialized view m"],
    "drop_mv": ["create materialized view m as select sum(v) s from t",
                "drop materialized view m"],
}


@pytest.mark.parametrize("name", list(WRITES))
def test_every_write_clears_the_caches(engines, name):
    sessions = tuple(e.create_session("memory") for e in engines)
    for stmt in ("create table t (k bigint, v bigint)",
                 "insert into t values (1, 10), (2, 20), (3, 30)"):
        _both(engines, stmt, sessions)
    read = "select count(*) c, sum(v) s from t"
    _both(engines, read, sessions)
    _both(engines, read, sessions)
    t = engines[1]
    assert t._plan_cache and t.buffer_pool.info()["entries"] > 0
    for stmt in WRITES[name]:
        t.execute_sql(read, sessions[1])  # the caches hold it again
        _both(engines, stmt, sessions)
        assert not t._plan_cache, f"{stmt} left cached plans"
        assert t.buffer_pool.info()["entries"] == 0, f"{stmt} left cached bytes"
    _both(engines, read, sessions)
    assert "planner" in _spans(t)
    assert t.last_query_counters["result_cache_hits"] == 0


@pytest.mark.parametrize("form", ["execute", "parameters"])
def test_substituted_statements_keep_the_plan_cache_bounded(engines, form, monkeypatch):
    """EXECUTE and protocol parameters substitute each value into new text
    where no plan template serves them (templates are off in this file):
    every new value is a new plan, and the cache keeps at most
    ``PLAN_CACHE_ENTRIES`` of them, the newest warm."""
    from trino_tpu_torch import engine as port_engine
    from trino_tpu_torch.sql.frontend import Planner

    plans = []
    real = Planner.plan_query
    monkeypatch.setattr(Planner, "plan_query",
                        lambda self, ast: plans.append(1) or real(self, ast))
    j, t = engines
    sj, st = j.create_session("tpch"), t.create_session("tpch")
    sql = "select n_name, n_regionkey + ? r from nation where n_nationkey = ?"
    if form == "execute":
        for e, s in ((j, sj), (t, st)):
            e.execute_sql(f"prepare p from {sql}", s)

    def run(e, s, a, b):
        if form == "execute":
            return e.execute_sql(f"execute p using {a}, {b}", s)
        return e.execute_sql(sql, s, parameters=[a, b])

    cap = port_engine.PLAN_CACHE_ENTRIES
    for i in range(cap + 40):
        got = run(t, st, i, i % 25)
        if i % 60 == 0:
            want = run(j, sj, i, i % 25)
            chip_smoke.same_outcome_result(got, want, sql, sql)
        assert len(t._plan_cache) <= cap
    assert len(t._plan_cache) == cap and len(plans) == cap + 40
    run(t, st, cap + 39, (cap + 39) % 25)  # the newest plan is still cached
    assert len(plans) == cap + 40
    run(t, st, 0, 0)  # the oldest was dropped: it plans again
    assert len(plans) == cap + 41
