"""The buffer pool's page and build tiers of the port
(``trino_tpu_torch/execution/bufferpool.py``, ``exec/local_executor.py``)
against the JAX package on the CPU.

Restates tests/test_page_cache.py: results byte-identical with the tiers on
and off, a warm hit that collapses host reads and H2D bytes, hits charged to
the query's own counters, concurrent statements sharing one pool, a build
checked out across executors, LRU eviction under a tiny budget, writes that
invalidate, the tiers off by default on the CPU, and the EXPLAIN ANALYZE
line.  Adds what the port must hold besides: a scan that stops early or
fails stores nothing, a split-pruned scan keys its own entry, a build is
reserved once, and a kernel that fails on a cached page fails the statement.

Budgets are set with ``monkeypatch.setenv`` on both packages before their
engines first use the pool (each reads its budget then).  Where both packages
answer a statement, their results agree: integers, decimals, dates and
strings exactly, DOUBLE within rtol 1e-9.  test_worker_owns_its_pool is
restated in tests/test_torch_cluster.py.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# small but multi-split: lineitem's ~60k rows over 7 splits
SF, SPLIT_ROWS = 0.01, 1 << 14
BUDGET = 1 << 30

Q_JOIN = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10"""

Q_AGG = """
select l_returnflag, l_linestatus, sum(l_quantity) s, count(*) c
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""

Q_SEMI = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem group by l_orderkey
                     having sum(l_quantity) > 100)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate limit 50"""

# a two-column join key: the build goes through the hash insert
Q_HASH = """
select count(*) c, sum(ps_supplycost) s from lineitem, partsupp
where l_partkey = ps_partkey and l_suppkey = ps_suppkey and l_quantity > 45"""

# a residual join filter: the multi-match layout
Q_MULTI = """
select count(*) c from nation, customer
where c_nationkey = n_nationkey and c_acctbal > n_regionkey * 1000"""


@pytest.fixture(scope="module")
def ref():
    """The reference's result of a statement over TPC-H, its page tier on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRINO_TPU_PAGE_CACHE", str(BUDGET))
        e = JaxEngine()
        e.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
        e.buffer_pool.budget()  # read while the variable is set
    memo = {}

    def run(sql):
        if sql not in memo:
            memo[sql] = e.execute_sql(sql, e.create_session("tpch"))
        return memo[sql]

    return run


def _engine(monkeypatch, budget=BUDGET):
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", str(budget))
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e


def _off(e):
    s = e.create_session("tpch")
    e.session_properties.set_property(s, "page_cache", False)
    return s


def _assert_same(a, b):
    """Byte-identical: each decoded and raw column's dtype and values."""
    cols = lambda r: [np.asarray(c) for c in r.columns] + \
        [np.asarray(c) for c in r.raw_columns]  # noqa: E731
    for x, y in zip(cols(a), cols(b), strict=True):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f")


def _same_ref(got, want, sql):
    chip_smoke.same_outcome_result(got, want, sql, sql)


@pytest.mark.parametrize("sql", [Q_JOIN, Q_SEMI, Q_AGG, Q_HASH, Q_MULTI],
                         ids=["join", "semi", "agg", "hash", "multi"])
def test_results_byte_identical_cache_on_off(monkeypatch, ref, sql):
    e = _engine(monkeypatch)
    on = e.create_session("tpch")
    r_off = e.execute_sql(sql, _off(e))
    assert e.last_query_counters["page_cache_misses"] == 0  # the property holds
    r1 = e.execute_sql(sql, on)  # fills the pool
    r2 = e.execute_sql(sql, on)  # warm: whole-scan hits
    assert e.last_query_counters["page_cache_hits"] >= 1
    _assert_same(r_off, r1)
    _assert_same(r_off, r2)
    _same_ref(r2, ref(sql), sql)


def test_warm_hit_collapses_reads_and_h2d(monkeypatch, ref):
    e = _engine(monkeypatch)
    on = e.create_session("tpch")
    e.execute_sql(Q_JOIN, on)  # stores
    e.execute_sql(Q_JOIN, _off(e))
    base = e.last_query_counters
    r = e.execute_sql(Q_JOIN, on)
    c = e.last_query_counters
    assert c["page_cache_hits"] >= 1 and c["page_cache_bytes_saved"] > 0
    assert c["build_cache_hits"] >= 1 and c["build_cache_bytes_saved"] > 0
    # the probe scan arrives as ONE page: its per-page reads collapse
    assert c["host_reads"] < base["host_reads"], (c, base)
    assert c["h2d_bytes"] <= base["h2d_bytes"]
    _same_ref(r, ref(Q_JOIN), Q_JOIN)


def test_hits_attributed_to_the_querys_own_counters(monkeypatch, ref):
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    e.execute_sql(Q_AGG, s)  # stores the lineitem entry
    r = e.execute_sql("select count(*) from nation", s)
    assert e.last_query_counters["page_cache_hits"] == 0, "nation charged a lineitem hit"
    _same_ref(r, ref("select count(*) from nation"), "select count(*) from nation")
    e.execute_sql(Q_AGG, s)
    assert e.last_query_counters["page_cache_hits"] == 1


def test_concurrent_statements_share_the_pool(monkeypatch, ref):
    e = _engine(monkeypatch)
    first = e.execute_sql(Q_JOIN, e.create_session("tpch"))
    results, errors = [None] * 4, []

    def run(i):
        try:
            results[i] = e.execute_sql(Q_JOIN, e.create_session("tpch"))
        except Exception as ex:  # noqa: BLE001 - raised in the main thread below
            errors.append(ex)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for r in results:
        _assert_same(first, r)
    _same_ref(first, ref(Q_JOIN), Q_JOIN)
    info = e.buffer_pool.info()
    assert info["hits"] >= 4 and info["build_hits"] >= 4, info
    # invalidation releases every byte
    e._invalidate()
    assert e.buffer_pool.info()["entries"] == 0
    assert e.buffer_pool.memory_pool.reserved == 0


def test_build_checked_out_across_executors(monkeypatch, ref):
    """A second executor over the same pool checks the build out: no build
    insert runs (on the card: no ``hash_insert_`` launch for it)."""
    import trino_tpu_torch.exec.local_executor as LE
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.sql import parser as A
    from trino_tpu_torch.sql.frontend import Planner

    e = _engine(monkeypatch)
    inserts = []
    for name in ("build_insert", "multi_build"):  # the two hashed builds
        real = getattr(LE, name)
        monkeypatch.setattr(LE, name, lambda *a, _f=real, **k: inserts.append(1) or _f(*a, **k))
    plan = Planner(e, e.create_session("tpch")).plan_query(A.parse(Q_HASH))
    bp = e.buffer_pool
    r1 = LocalExecutor(e.catalogs, "cpu", buffer_pool=bp).execute(plan)
    assert inserts and bp.build_misses == 1
    inserts.clear()
    r2 = LocalExecutor(e.catalogs, "cpu", buffer_pool=bp).execute(plan)
    assert bp.build_hits == 1 and not inserts, "the second executor rebuilt the build"
    _assert_same(r1, r2)
    _same_ref(r2, ref(Q_HASH), Q_HASH)


def test_a_build_is_reserved_once(monkeypatch):
    """A fresh build's query reservation returns once the pool holds the
    build; a checked-out build reserves nothing on the query's pool."""
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    calls = []
    pool = e.memory_pool
    real_reserve, real_free = pool.try_reserve, pool.free
    monkeypatch.setattr(pool, "try_reserve",
                        lambda n, tag="": calls.append(("reserve", n)) or real_reserve(n, tag))
    monkeypatch.setattr(pool, "free",
                        lambda n, tag="": calls.append(("free", n)) or real_free(n, tag))
    e.execute_sql(Q_HASH, s)
    assert e.last_query_counters["build_cache_misses"] == 1
    assert len(calls) == 2 and calls[0][0] == "reserve" and calls[1] == ("free", calls[0][1])
    assert e.buffer_pool.info()["build_entries"] == 1
    calls.clear()
    e.execute_sql(Q_HASH, s)
    assert e.last_query_counters["build_cache_hits"] == 1
    assert calls == [], calls
    assert pool.reserved == 0


def test_lru_eviction_under_tiny_budget(monkeypatch, ref):
    e = _engine(monkeypatch, budget=64 << 10)
    s = e.create_session("tpch")
    for sql in ("select count(*) c from region group by r_regionkey",
                "select count(*) c from nation group by n_nationkey",
                "select count(*) c from region group by r_regionkey"):
        _same_ref(e.execute_sql(sql, s), ref(sql), sql)
    info = e.buffer_pool.info()
    assert info["evictions"] >= 1 or info["bytes"] <= 64 << 10
    assert e.buffer_pool.memory_pool.reserved <= 64 << 10
    # a scan larger than the whole budget is skipped, not an error
    r = e.execute_sql(Q_AGG, s)
    _same_ref(r, ref(Q_AGG), Q_AGG)
    assert e.buffer_pool.memory_pool.reserved <= 64 << 10
    assert e.buffer_pool.info()["bytes"] <= 64 << 10


def test_insert_invalidates_stale_pages(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", str(BUDGET))
    outs = []
    for e in (JaxEngine(), Engine(device="cpu")):
        e.register_catalog("mem", JaxMemory() if isinstance(e, JaxEngine)
                           else MemoryConnector())
        s = e.create_session("mem")
        e.execute_sql("create table t (k bigint, v bigint)", s)
        e.execute_sql("insert into t values (1, 10), (2, 20)", s)
        first = e.execute_sql("select sum(v) s from t", s)
        e.execute_sql("select sum(v) s from t", s)  # a cached read
        e.execute_sql("insert into t values (3, 70)", s)  # clears the pool
        assert e.buffer_pool.info()["entries"] == 0
        assert e.buffer_pool.memory_pool is None or e.buffer_pool.memory_pool.reserved == 0
        outs.append((first, e.execute_sql("select sum(v) s from t", s)))
    (j1, j2), (t1, t2) = outs
    assert t1.rows() == [(30,)] and t2.rows() == [(100,)], "stale page after INSERT"
    _same_ref(t1, j1, "select sum(v) s from t")
    _same_ref(t2, j2, "select sum(v) s from t")


def test_page_tier_off_by_default_on_the_cpu(monkeypatch, ref):
    monkeypatch.delenv("TRINO_TPU_PAGE_CACHE", raising=False)
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    s = e.create_session("tpch")
    e.execute_sql(Q_AGG, s)
    r = e.execute_sql(Q_AGG, s)
    c = e.last_query_counters
    assert c["page_cache_hits"] == 0 and c["page_cache_misses"] == 0
    assert c["build_cache_hits"] == 0 and c["build_cache_misses"] == 0
    assert e.buffer_pool.budget() == 0 and e.buffer_pool.info()["entries"] == 0
    _same_ref(r, ref(Q_AGG), Q_AGG)


def test_explain_analyze_shows_buffer_pool_line(monkeypatch):
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    e.execute_sql(Q_AGG, s)  # stores
    text = [row[0] for row in e.execute_sql(f"explain analyze {Q_AGG}", s).rows()]
    nbytes = e.buffer_pool.info()["per_table"]["tpch.lineitem"]["bytes"]
    assert f"Buffer pool: 1 page hits, 0 page misses, {nbytes} bytes saved, " \
           "0 build hits" in text, text


def test_early_stop_and_errors_store_nothing(monkeypatch):
    """A LIMIT that stops the scan early, or an error while the scan runs,
    stores no page; a kernel failing on a cached page fails the statement."""
    import trino_tpu_torch.exec.local_executor as LE

    e = _engine(monkeypatch)
    # the statement's own plan: a plan template whose first execution fails
    # is dropped and the statement runs again by substitution (probation),
    # which would answer past the one failure injected below
    e.plan_templates_enabled = False
    s = e.create_session("tpch")
    assert len(e.execute_sql("select l_orderkey from lineitem limit 5", s)) == 5
    assert e.buffer_pool.info()["page_entries"] == 0
    sql = "select l_orderkey, l_partkey from lineitem where l_quantity > 49"
    real = LE.evaluate_predicate

    def fails_on_the_first_group(*a, **k):
        # the first coalesced group holds four of the scan's seven splits:
        # the scan has not run to its end when the filter fails
        raise RuntimeError("filter failed")

    monkeypatch.setattr(LE, "evaluate_predicate", fails_on_the_first_group)
    with pytest.raises(RuntimeError, match="filter failed"):
        e.execute_sql(sql, s)
    assert e.buffer_pool.info()["page_entries"] == 0
    monkeypatch.setattr(LE, "evaluate_predicate", real)
    e.execute_sql(sql, s)  # stores
    assert e.buffer_pool.info()["page_entries"] == 1

    def failing(*a, **k):
        raise RuntimeError("compaction failed")

    monkeypatch.setattr(LE, "compact_rows", failing)
    with pytest.raises(RuntimeError, match="compaction failed"):
        e.execute_sql(sql, s)  # the cached page's compaction fails the statement


def test_failed_template_attempt_stores_nothing(monkeypatch):
    """Templates on (the default): an error mid-scan in a template's first
    execution is retried by substitution (probation).  With the error on
    both attempts the statement raises, and neither attempt stores a page."""
    import trino_tpu_torch.exec.local_executor as LE

    e = _engine(monkeypatch)
    assert e.plan_templates_enabled
    s = e.create_session("tpch")
    sql = "select l_orderkey, l_partkey from lineitem where l_quantity > 49"
    real = LE.evaluate_predicate
    seen = []

    def fails_on_every_first_group(*a, **k):
        # each attempt's first coalesced group holds four of the scan's
        # seven splits: the scan has not run to its end when it fails
        seen.append(1)
        raise RuntimeError("filter failed")

    monkeypatch.setattr(LE, "evaluate_predicate", fails_on_every_first_group)
    with pytest.raises(RuntimeError, match="filter failed"):
        e.execute_sql(sql, s)
    # the template attempt ran to its failure on its first group, then the
    # substitution attempt (templates off) to its own
    assert len(seen) == 2, seen
    assert e.buffer_pool.info()["page_entries"] == 0
    monkeypatch.setattr(LE, "evaluate_predicate", real)
    e.execute_sql(sql, s)  # stores
    assert e.buffer_pool.info()["page_entries"] == 1


def test_pruned_scans_key_their_own_splits(monkeypatch, ref):
    """A statically pruned scan and a dynamically pruned probe scan store the
    splits they kept, never the whole table, and serve only them."""
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    n_splits = len(e.catalogs["tpch"].splits("lineitem"))
    whole = "select count(*) c, sum(l_quantity) q from lineitem where l_orderkey > 0"
    for sql in ("select count(*) c, sum(l_quantity) q from lineitem where l_orderkey < 2000",
                "select count(*) c, sum(l_quantity) q from lineitem, orders "
                "where l_orderkey = o_orderkey and o_orderkey < 2000"):
        e._invalidate()
        for _ in range(2):
            r = e.execute_sql(sql, s)
            _same_ref(r, ref(sql), sql)
        keys = [k for k in e.buffer_pool._entries if k[0] == "page" and k[2] == "lineitem"]
        assert len(keys) == 1 and 0 < len(keys[0][3]) < n_splits, keys
        assert keys[0][4] == ("l_orderkey", "l_quantity")
        assert e.last_query_counters["page_cache_hits"] >= 1
        # the whole table, over the same columns, is another entry
        r = e.execute_sql(whole, s)
        assert e.last_query_counters["page_cache_misses"] == 1
        _same_ref(r, ref(whole), whole)


@pytest.mark.parametrize("tier", ["page", "build"])
def test_a_write_during_a_scan_refuses_its_store(monkeypatch, tier):
    """A write that lands after a statement's executor started, and before
    its scan's page (or its join's build) is stored, invalidates the pool:
    the late store, which may hold the pre-write rows, is refused, and the
    next statement reads the write.  The write runs on another thread, as a
    concurrent statement on the engine would."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor

    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", str(BUDGET))
    outs = []
    for e in (JaxEngine(), Engine(device="cpu")):
        port = isinstance(e, Engine)
        e.register_catalog("mem", MemoryConnector() if port else JaxMemory())
        s = e.create_session("mem")
        for stmt in ("create table t (k bigint, v bigint)",
                     "insert into t values (1, 10), (2, 20)",
                     "create table u (k bigint, w bigint)",
                     "insert into u values (1, 3), (2, 4)"):
            e.execute_sql(stmt, s)
        read = "select sum(v) s from t" if tier == "page" else \
            "select sum(v * w) s from t join u on t.k = u.k"
        before = e.execute_sql(read, s)
        if port:
            fired = []

            def write(*_):
                if not fired:
                    fired.append(1)
                    w = threading.Thread(target=e.execute_sql, args=(
                        "insert into u values (1, 5)" if tier == "build"
                        else "insert into t values (3, 70)", e.create_session("mem")))
                    w.start()
                    w.join(60)
                    assert not w.is_alive()

            hook = "_stage_scan_entry" if tier == "page" else "_build_null_stats"
            real = getattr(LocalExecutor, hook)
            monkeypatch.setattr(LocalExecutor, hook,
                                lambda self, *a: write() or real(self, *a))
            e._invalidate()
            e.execute_sql(read, s)
            monkeypatch.setattr(LocalExecutor, hook, real)
            assert fired, "the write did not land mid-statement"
            assert e.buffer_pool.info()["entries"] == 0, e.buffer_pool.info()
        else:
            e.execute_sql("insert into u values (1, 5)" if tier == "build"
                          else "insert into t values (3, 70)", s)
        outs.append((before, e.execute_sql(read, s), e.execute_sql(read, s)))
    (j0, j1, _), (t0, t1, t2) = outs
    assert t1.rows() == t2.rows() == ([(100,)] if tier == "page" else [(160,)]), t1.rows()
    _same_ref(t0, j0, "before")
    _same_ref(t2, j1, "after")


def test_fingerprint_prints_values_not_identities():
    """The build and result tiers key on ``_plan_fingerprint``: object arrays
    print by content, numpy scalars, decimals and dates by value, so a
    fragment freed and another made with the same identity never share a
    key, and equal contents in distinct objects do."""
    import datetime
    import re
    from decimal import Decimal

    from trino_tpu_torch.exec.local_executor import _plan_fingerprint
    from trino_tpu_torch.page import Field, Schema
    from trino_tpu_torch.sql import plan as P
    from trino_tpu_torch.types import BIGINT

    schema = Schema((Field("x", BIGINT),))

    def fp(*values):
        return _plan_fingerprint(P.Values(((*values,),), schema), {})

    # each array is freed once printed: a reused identity must not print
    # a different content alike
    prints = [fp(np.array([c, None], dtype=object)) for c in "abcdef"]
    assert len(set(prints)) == len(prints)
    assert fp(np.array(["a", None], dtype=object)) == prints[0]
    assert fp(np.array([None, "a"], dtype=object)) != prints[0]
    assert fp(np.int64(1)) != fp(np.int64(2)) and fp(np.int64(1)) == fp(np.int64(1))
    assert fp(Decimal("1.5")) != fp(Decimal("2.5"))
    assert fp(Decimal("1.5")) == fp(Decimal("1.5"))
    assert fp(datetime.date(2020, 1, 1)) != fp(datetime.date(2020, 1, 2))
    assert not re.search(r"#\d", fp(np.int64(1), Decimal("1"), datetime.date(2020, 1, 1),
                                    np.array([Decimal("1")], dtype=object)))


def test_freed_subquery_plans_never_serve_another_build(monkeypatch, ref):
    """Plan-time subqueries run their joins through the build tier and drop
    their plans; a near-identical statement after them (another literal)
    gets its own builds.  No fragment of these plans prints an identity."""
    import gc
    import re

    import trino_tpu_torch.exec.local_executor as LE

    prints = []
    real = LE._plan_fingerprint
    monkeypatch.setattr(LE, "_plan_fingerprint",
                        lambda n, c: prints.append(real(n, c)) or prints[-1])
    e = _engine(monkeypatch)
    s = e.create_session("tpch")
    sub = ("select count(*) c, sum(o_totalprice) p from orders where o_custkey = "
           "(select max(c_custkey) from customer, nation "
           "where c_nationkey = n_nationkey and n_name = '{}')")
    for nation in ("BRAZIL", "CANADA", "BRAZIL", "EGYPT"):
        sql = sub.format(nation)
        with e._plan_lock:
            e._plan_cache.clear()  # the subquery plans (and runs) again
        got = e.execute_sql(sql, s)
        gc.collect()
        _assert_same(got, e.execute_sql(sql, _off(e)))
        _same_ref(got, ref(sql), sql)
    # the second BRAZIL's fresh subquery plan checked out the first's build.
    # One more miss: the first statement also tried to plan a template,
    # whose subquery looked its build up (the nation fragment over the
    # parameter) before the parameter, which has no value while planning,
    # stopped it; the text is then unbindable and no later statement tries
    info = e.buffer_pool.info()
    assert info["build_hits"] == 1 and info["build_misses"] == 4, info
    for sql in (Q_JOIN, Q_SEMI, Q_HASH, Q_MULTI):
        e.execute_sql(sql, s)
    assert prints and not [p for p in prints if re.search(r"[A-Za-z_]#\d", p)]
