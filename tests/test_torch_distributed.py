"""The port's distributed executor over a worker mesh
(``trino_tpu_torch/exec/distributed.py``, ``parallel/mesh.py``) on the CPU,
against the port's local executor and the JAX package.

The mesh is ``worker_mesh(8, devices=["cpu"] * 8)``: eight positions on the
CPU, the port's counterpart of the conftest's eight virtual jax devices.
At TPC-H SF0.01 unless stated:

- **distributed against local**: each of tests/test_distributed.py's 16
  ``QUERIES`` (``chip_smoke.DIST_QUERIES``, held equal to that file's)
  through the port's distributed run and its local run.  Integers,
  decimals, dates and strings equal; DOUBLE within rtol 1e-9; rows in order
  where the statement orders them, the rows tied on its ORDER BY columns as
  multisets (``chip_smoke.same_result(..., order_by=...)``);
- **against the reference's distributed run**: q3, q18, window_dist and
  full_sort_dict equal the reference's distributed result, and the port's
  ``exec_trace`` equals the reference's entry for entry;
- **no local fallback**: Q1, Q9 and Q18 at SF0.001 in 2^12-row splits run
  no fragment locally (tests/test_distributed_hostfed.py:162);
- **restated reference tests**: the multi-match, partitioned-join and
  probe-overflow-retry tests and the NOT IN cases of
  tests/test_distributed.py; the rollup, EXPLAIN ANALYZE, TPC-DS, memory
  and parquet host-fed tests of tests/test_distributed_hostfed.py;
  tests/test_distributed_budgets.py's warm-site ceilings and forbidden
  sites for q3, q9 and q18 at SF0.02 (its ``CEILINGS`` as they stand) and
  its ``TRINO_TPU_DEVICE_EXCHANGE`` default;
- **skew**: tests/test_shard_skew.py's hot-key and uniform cases and the
  ``system.runtime.query_log`` skew columns;
- **the duplicate-key join** of
  tests/test_subquery_edges.py::test_distributed_dup_key_join_falls_back:
  the reference's distributed run aborts its process (ROADMAP C), so the
  port's five rows are held against the reference's LOCAL result, and the
  fallback's reason stands in ``exec_trace``;
- **the engine's guards**: a distributed statement and a local one of the
  same text share no plan-cache, template or result-tier entry; a mesh
  off the engine's device and parameters with a distributed plan raise,
  and ``fault_tolerant`` (ported since) runs, equal to the local result.
"""

import os
import sys

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.exec.distributed import DistributedExecutor as JaxDistributed
from trino_tpu.parallel.mesh import worker_mesh as jax_mesh
from trino_tpu.sql.frontend import compile_sql as jax_compile
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec.distributed import DistributedExecutor
from trino_tpu_torch.parallel.mesh import worker_mesh
from trino_tpu_torch.sql.frontend import compile_sql
from torch_threads import one_torch_thread  # noqa: F401  (autouse module fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the statements and the comparison helpers)

W = 8


@pytest.fixture(scope="module")
def mesh8():
    return worker_mesh(W, devices=["cpu"] * W)


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01))
    return e, e.create_session("tpch")


def _same(a, b, what, order_by=None):
    chip_smoke.same_result(a, b, what, order_by=order_by)


def test_queries_are_the_reference_tests():
    from test_distributed import QUERIES

    assert chip_smoke.DIST_QUERIES == QUERIES
    assert set(chip_smoke.DIST_ORDER_BY) == set(QUERIES)


@pytest.mark.parametrize("name", list(chip_smoke.DIST_QUERIES))
def test_distributed_matches_local(port, mesh8, name):
    e, s = port
    sql = chip_smoke.DIST_QUERIES[name]
    local = e.execute_sql(sql, s)
    dist = e.execute_sql(sql, s, distributed=True, mesh=mesh8)
    _same(dist, local, name, order_by=chip_smoke.DIST_ORDER_BY[name])


@pytest.fixture(scope="module")
def reference(engine):
    return engine, engine.create_session("tpch")


@pytest.mark.parametrize("name", ["q3", "q18", "window_dist", "full_sort_dict"])
def test_distributed_matches_the_reference(reference, port, mesh8, name):
    je, js = reference
    e, s = port
    sql = chip_smoke.DIST_QUERIES[name]
    jx = JaxDistributed(je.catalogs, mesh=jax_mesh(W))
    want = jx.execute(jax_compile(sql, je, js))
    px = DistributedExecutor(e.catalogs, mesh=mesh8)
    got = px.execute(compile_sql(sql, e, s))
    _same(got, want, name, order_by=chip_smoke.DIST_ORDER_BY[name])
    assert px.exec_trace == jx.exec_trace


@pytest.mark.parametrize("sql", [
    "select c_name, c_custkey from customer order by c_name desc limit 5",
    "select c_name, c_custkey from customer order by c_name",
], ids=["topn", "sort"])
def test_unrankable_string_sort_key_sorts_on_the_coordinator(port, mesh8, sql):
    """``c_name``'s dictionary formats names from keys and keeps no value
    list, so no device sort can rank it: the TopN or sort declines to the
    coordinator (its reason in ``exec_trace``), the scan still runs on the
    mesh, and the result equals the local run."""
    e, s = port
    local = e.execute_sql(sql, s)
    _same(e.execute_sql(sql, s, distributed=True, mesh=mesh8), local, sql)
    trace = e.last_exec_trace
    assert trace[0][1] == "coordinator" and "cannot rank" in trace[0][2], trace
    assert trace[-1] == ("Project", "mesh", None)


def test_north_star_runs_no_fragment_locally(mesh8):
    import __graft_entry__ as G

    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.001, split_rows=1 << 12))
    s = e.create_session("tpch")
    for sql in (G.Q1, G.Q9, G.Q18):
        ex = DistributedExecutor(e.catalogs, mesh=mesh8)
        ex.execute(compile_sql(sql, e, s))
        assert not [t for t in ex.exec_trace if t[1] == "local"], (sql[:60], ex.exec_trace)
        assert any(t[1] == "mesh" for t in ex.exec_trace), sql[:60]


# -- tests/test_distributed.py ---------------------------------------------------------

DUP_KEY_Q = ("select l_partkey, count(*) n, sum(ps_supplycost) sc "
             "from lineitem, partsupp where l_partkey = ps_partkey "
             "group by l_partkey order by l_partkey limit 30")


def _via_executor(e, s, mesh, sql, **kw):
    ex = DistributedExecutor(e.catalogs, mesh=mesh, **kw)
    return ex.execute(compile_sql(sql, e, s)), ex


@pytest.mark.parametrize("threshold", [8, 1 << 30], ids=["partitioned", "broadcast"])
def test_multi_match_join_matches_local(port, mesh8, threshold):
    e, s = port
    dist, ex = _via_executor(e, s, mesh8, DUP_KEY_Q, partition_threshold=threshold)
    _same(dist, e.execute_sql(DUP_KEY_Q, s), "dup-key join", order_by=("l_partkey",))
    assert ("Aggregate", "mesh", None) in ex.exec_trace


def test_multi_match_left_join_matches_local(port, mesh8):
    e, s = port
    sql = ("select count(*) c, sum(ps_availqty) q from part "
           "left join partsupp on p_partkey = ps_partkey and ps_supplycost > 500")
    dist, _ = _via_executor(e, s, mesh8, sql, partition_threshold=8)
    _same(dist, e.execute_sql(sql, s), "multi-match left join")


def test_probe_bucket_overflow_retries(port, mesh8):
    """A constant join key routes every probe row to one position, so the
    first rung's ~2n/W probe bucket overflows and the ladder retries."""
    e, s = port
    sql = ("select count(*) c from "
           "(select 1 k, l_quantity from lineitem) l "
           "join (select 1 k, n_nationkey from nation) n on l.k = n.k")
    ex = DistributedExecutor(e.catalogs, mesh=mesh8, partition_threshold=8)
    factors = []
    run_once = ex._retry_exchange

    def spy(fn):
        def once():
            factors.append(ex._probe_factor)
            return fn()
        return run_once(once)

    ex._retry_exchange = spy
    dist = ex.execute(compile_sql(sql, e, s))
    _same(dist, e.execute_sql(sql, s), "skewed partitioned join")
    assert len(factors) > 1  # the first rung overflowed


def test_partitioned_join_matches_local(port, mesh8):
    e, s = port
    q = ("select l_orderkey, count(*) n, sum(l_quantity) q from lineitem, orders "
         "where l_orderkey = o_orderkey and o_orderdate < date '1994-01-01' "
         "group by l_orderkey order by l_orderkey limit 50")
    dist, _ = _via_executor(e, s, mesh8, q, partition_threshold=8)
    _same(dist, e.execute_sql(q, s), "partitioned join", order_by=("l_orderkey",))


@pytest.mark.parametrize("sql", [
    "select count(*) c from orders where "
    "(case when o_custkey < 5 then null else o_custkey end) not in "
    "(select c_custkey from customer where c_acctbal > 99999999)",
    "select count(*) c from orders where o_custkey not in "
    "(select case when c_custkey < 5 then null else c_custkey end from customer)",
], ids=["empty-build-null-probe", "null-build"])
def test_null_aware_anti_matches_local(port, mesh8, sql):
    e, s = port
    local = e.execute_sql(sql, s)
    _same(e.execute_sql(sql, s, distributed=True, mesh=mesh8), local, "NOT IN")
    assert int(local.columns[0][0]) in (0, 15000)


def test_ungrouped_variance_over_every_position(mesh8):
    """Rows on every position: the ungrouped variance family adds the
    positions' partial sums of squares (the reference's distributed run
    takes their maximum, a known gap: ROADMAP C) and equals the local run."""
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 13))
    s = e.create_session("tpch")
    sql = "select var_pop(l_discount) v, stddev_samp(l_quantity) s, sum(l_tax) t from lineitem"
    dist, ex = _via_executor(e, s, mesh8, sql)
    _same(dist, e.execute_sql(sql, s), "ungrouped variance")
    assert float(dist.columns[0][0]) > 0 and ("Aggregate", "mesh", None) in ex.exec_trace


# -- tests/test_distributed_hostfed.py -------------------------------------------------


def test_tpcds_global_agg_distributed(mesh8):
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector

    e = Engine(device="cpu")
    e.register_catalog("tpcds", TpcdsConnector(sf=0.01, split_rows=1 << 13))
    s = e.create_session("tpcds")
    sql = ("select count(*) c, sum(ss_quantity) q from store_sales "
           "where ss_quantity between 1 and 50")
    _same(e.execute_sql(sql, s, distributed=True, mesh=mesh8), e.execute_sql(sql, s),
          "tpcds global")


@pytest.fixture(scope="module")
def mem_engine():
    e = Engine(device="cpu")
    mem = MemoryConnector()
    e.register_catalog("mem", mem)
    s = e.create_session("mem")
    e.execute_sql("create table t (k bigint, v double, tag varchar)", s)
    rng = np.random.default_rng(7)
    n = 30000
    ks = (rng.integers(0, 251, n)).tolist()
    vs = np.round(rng.uniform(0, 1000, n), 3).tolist()
    mem.append("t", [ks, vs, [f"tag{int(x) % 7}" for x in ks]])
    e._invalidate()
    return e, s


@pytest.mark.parametrize("sql,order_by", [
    ("select k, sum(v) sv, count(*) c from t group by k order by k", ("k",)),
    ("select k, v from t where v > 500 order by v desc, k limit 25", ("v", "k")),
], ids=["groupby", "filter-topn"])
def test_memory_hostfed(mem_engine, mesh8, sql, order_by):
    """Memory pages live on the engine's device: the host-fed scan slices
    them per position there, with no host read of the pages."""
    e, s = mem_engine
    local = e.execute_sql(sql, s)
    dist = e.execute_sql(sql, s, distributed=True, mesh=mesh8)
    _same(dist, local, sql, order_by=order_by)
    sites = e.last_query_counters["sites"]
    assert not [k for k in sites if "hostfed" in k], sites
    assert e.last_query_counters["h2d_bytes"] < 1000  # constants only: no page staged


def test_parquet_hostfed_distributed(tmp_path, mesh8):
    """Host-decoded pages stage through the executor's _page_to_device."""
    pytest.importorskip("pyarrow")
    from trino_tpu_torch.connectors.parquet import ParquetConnector

    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 13))
    e.register_catalog("pq", ParquetConnector(str(tmp_path)))
    s = e.create_session("pq")
    e.execute_sql("create table po as select o_custkey, o_totalprice, "
                  "o_orderkey from tpch.orders", s)
    sql = ("select o_custkey, sum(o_totalprice) sp, count(*) c from po "
           "group by o_custkey order by o_custkey limit 40")
    local = e.execute_sql(sql, s)
    dist = e.execute_sql(sql, s, distributed=True, mesh=mesh8)
    _same(dist, local, "parquet", order_by=("o_custkey",))
    # the two scanned columns of every row, staged (pad lanes included)
    assert e.last_query_counters["h2d_bytes"] >= 15000 * 16


def test_explain_analyze_reports_fragment_modes(mem_engine, mesh8):
    e, s = mem_engine
    r = e.execute_sql("explain analyze select k, sum(v) sv from t group by k order by k",
                      s, distributed=True, mesh=mesh8)
    text = "\n".join(r.columns[0].tolist())
    assert "Fragment execution (distributed run):" in text
    assert "[mesh] Aggregate" in text


def test_rollup_distributes_per_branch(mesh8):
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.005, split_rows=1 << 12))
    s = e.create_session("tpch")
    sql = ("select l_returnflag, l_linestatus, sum(l_quantity) q, count(*) c "
           "from lineitem group by rollup (l_returnflag, l_linestatus) "
           "order by l_returnflag, l_linestatus")
    local = e.execute_sql(sql, s)
    dist, ex = _via_executor(e, s, mesh8, sql)
    _same(dist, local, "rollup", order_by=("l_returnflag", "l_linestatus"))
    agg_modes = [m for label, m, _ in ex.exec_trace if label == "Aggregate"]
    assert agg_modes and all(m == "mesh" for m in agg_modes)
    assert ("Union", "coordinator") in [(lb, m) for lb, m, _ in ex.exec_trace]


# -- tests/test_distributed_budgets.py -------------------------------------------------


@pytest.fixture(scope="module")
def budget_env(mesh8):
    from test_distributed_budgets import QUERIES, SF, SPLIT_ROWS

    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    s = e.create_session("tpch")
    plans = {name: compile_sql(sql, e, s) for name, sql in QUERIES.items()}
    locals_ = {name: e.execute_sql(sql, s) for name, sql in QUERIES.items()}
    return e, plans, locals_


@pytest.mark.parametrize("name", ["q3", "q9", "q18"])
def test_mesh_warm_budget(budget_env, mesh8, name):
    """Warm, device-exchange mode: equal to the local run, no host-spool
    site, and the bytes read at dist.* sites and in all under the
    reference's ceilings."""
    from test_distributed_budgets import CEILINGS, FORBIDDEN_WARM_SITES

    e, plans, locals_ = budget_env
    ex = DistributedExecutor(e.catalogs, mesh=mesh8, device_exchange=True)
    ex.execute(plans[name])
    warm = ex.execute(plans[name])
    _same(warm, locals_[name], name)
    sites = ex.counters.sites
    for bad in FORBIDDEN_WARM_SITES:
        assert not [k for k in sites if bad in k], sites
    dist_bytes = sum(v["bytes"] for k, v in sites.items() if "dist." in k)
    assert dist_bytes > 0  # the flag reads are counted
    assert dist_bytes <= CEILINGS[name]["dist_bytes"], sites
    assert ex.counters.host_bytes_pulled <= CEILINGS[name]["host_bytes_pulled"], sites


def test_device_exchange_defaults_on(monkeypatch, mesh8):
    monkeypatch.delenv("TRINO_TPU_DEVICE_EXCHANGE", raising=False)
    assert DistributedExecutor({}, mesh=mesh8).device_exchange
    monkeypatch.setenv("TRINO_TPU_DEVICE_EXCHANGE", "0")
    assert not DistributedExecutor({}, mesh=mesh8).device_exchange


@pytest.mark.parametrize("name", ["window_dist", "q3", "full_sort"])
def test_host_spool_equals_device_exchange(port, mesh8, name):
    """``TRINO_TPU_DEVICE_EXCHANGE=0``: the host spool gives the device
    exchange's result, and reads at its spool sites."""
    e, s = port
    plan = compile_sql(chip_smoke.DIST_QUERIES[name], e, s)
    dev = DistributedExecutor(e.catalogs, mesh=mesh8, device_exchange=True)
    spool = DistributedExecutor(e.catalogs, mesh=mesh8, device_exchange=False)
    _same(spool.execute(plan), dev.execute(plan), name,
          order_by=chip_smoke.DIST_ORDER_BY[name])
    assert sum(v["bytes"] for v in spool.counters.sites.values()) \
        > sum(v["bytes"] for v in dev.counters.sites.values())


# -- tests/test_shard_skew.py ----------------------------------------------------------

N_ROWS = 20000


@pytest.fixture(scope="module")
def skew_engine():
    e = Engine(device="cpu")
    mem = MemoryConnector()
    e.register_catalog("mem", mem)
    s = e.create_session("mem")
    rng = np.random.default_rng(20)
    n_hot = int(N_ROWS * 0.85)
    e.execute_sql("create table hot (k bigint, v double)", s)
    hot_k = np.concatenate([np.full(n_hot, 7, np.int64),
                            rng.integers(1000, 2000, N_ROWS - n_hot).astype(np.int64)])
    vs = np.round(rng.uniform(0, 1000, N_ROWS), 3)
    mem.append("hot", [hot_k.tolist(), vs.tolist()])
    e.execute_sql("create table uni (k bigint, v double)", s)
    mem.append("uni", [rng.permutation(N_ROWS).astype(np.int64).tolist(), vs.tolist()])
    e._invalidate()
    return e, s


@pytest.mark.parametrize("table,lo,hi", [("hot", 4.0, None), ("uni", None, 1.5)])
def test_routing_skew_is_recorded(skew_engine, mesh8, table, lo, hi):
    """>= 80 % of rows on one sort key: the range exchange reports a skew
    ratio >= 4x; a uniform control stays <= 1.5x; both equal local."""
    e, s = skew_engine
    sql = f"select k, v from {table} order by k, v"
    local = e.execute_sql(sql, s)
    dist = e.execute_sql(sql, s, distributed=True, mesh=mesh8)
    _same(dist, local, table, order_by=("k", "v"))
    recs = [r for r in e.last_query_counters.get("shard_stats", []) if r.get("kind") == "exchange"]
    assert recs
    worst = max(recs, key=lambda r: r["ratio"])
    if lo is not None:
        assert worst["ratio"] >= lo, recs
        assert worst["rows"][worst["worker"]] >= 0.5 * sum(worst["rows"])
    else:
        assert worst["ratio"] <= hi, recs


def test_system_query_log_skew_columns(skew_engine, mesh8):
    """The hot run's skew reaches system.runtime.query_log and, under the
    node paths of the cardinality actuals, the plan history."""
    e, s = skew_engine
    e.execute_sql("select k, v from hot order by k, v", s, distributed=True, mesh=mesh8)
    skews = [r["skew"] for ent in e.plan_history.snapshot()
             for r in ent["nodes"].values() if "skew" in r]
    assert skews and max(sk["ratio"] for sk in skews) >= 4.0, skews
    rows = e.execute_sql("select skew_ratio, skew_imbalance_s from "
                         "system.runtime.query_log order by skew_ratio desc", s)
    assert float(rows.columns[0][0]) >= 4.0
    assert float(rows.columns[1][0]) >= 0.0


# -- tests/test_subquery_edges.py::test_distributed_dup_key_join_falls_back ------------


def test_dup_key_join_falls_back(mesh8):
    """The statement's duplicate-key join expands ~80 partsupp rows per
    lineitem row: each ladder rung re-runs with a bigger expansion bucket,
    the LIMIT above it falls back to the coordinator with its reason in
    ``exec_trace``, and five rows come back.  The reference's distributed
    run aborts its process (ROADMAP C), so the reference's LOCAL run is the
    oracle: a LIMIT without ORDER BY may return any five rows of the join,
    so each must be a row of the reference's local join.  Restated at
    SF0.001 in 2^12-row splits (the same ~80-way expansion) to keep the
    reference's local join and the port's CPU expansion cheap."""
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.001, split_rows=1 << 12))
    s = e.create_session("tpch")
    sql = "select l_orderkey from lineitem, partsupp where ps_suppkey = l_suppkey limit 5"
    ex = DistributedExecutor(e.catalogs, mesh=mesh8)
    got = ex.execute(compile_sql(sql, e, s))
    assert len(got) == 5
    ref = JaxEngine()
    ref.register_catalog("tpch", JaxTpch(sf=0.001, split_rows=1 << 12))
    full = ref.execute_sql("select l_orderkey from lineitem, partsupp "
                           "where ps_suppkey = l_suppkey")
    assert set(got.columns[0].tolist()) <= set(np.asarray(full.columns[0]).tolist())
    assert ex.exec_trace[0] == ("Project", "coordinator", "Limit: operator is not part "
                                "of a streamable fragment (blocking or unsupported shape)")
    assert ("Join", "mesh", None) in ex.exec_trace


# -- the engine's distributed guards ---------------------------------------------------


def test_distributed_and_local_share_no_cached_entry(mesh8, monkeypatch):
    """A distributed run after a local run of the same text hits no local
    plan-cache, template or result-tier entry, and the reverse: the two
    kinds never run one plan object, a distributed statement makes no
    template, and each kind's second run hits its own result entry."""
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(64 << 20))
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01))
    s = e.create_session("tpch")
    plans = {False: set(), True: set()}
    run_plan = e.execute_plan

    def spy(plan, *a, distributed=False, **kw):
        if kw.get("cache", True):
            plans[distributed].add(id(plan))
        return run_plan(plan, *a, distributed=distributed, **kw)

    monkeypatch.setattr(e, "execute_plan", spy)
    texts = ("select o_totalprice from orders where o_orderkey = 7",  # a template shape
             "select o_orderstatus, count(*) c from orders group by o_orderstatus")
    for first in (False, True):
        e._invalidate()
        for sql in texts:
            for dist in (first, not first):
                e.execute_sql(sql, s, distributed=dist, mesh=mesh8 if dist else None)
                c = e.last_query_counters
                assert c["result_cache_hits"] == 0 and c["plan_template_hits"] == 0, (sql, dist)
                if dist:
                    assert c["plan_template_misses"] == 0, sql  # no template made
            for dist in (first, not first):
                e.execute_sql(sql, s, distributed=dist, mesh=mesh8 if dist else None)
                assert e.last_query_counters["result_cache_hits"] == 1, (sql, dist)
    assert plans[True] and plans[False] and not plans[True] & plans[False]
    assert all(k[2] is True for k in e._plan_cache if k[2] is not False)


def test_distributed_guards_raise(port):
    e, s = port
    with pytest.raises(ValueError, match="differ from the engine"):
        e.execute_sql("select 1", s, distributed=True,
                      mesh=worker_mesh(2, devices=["meta", "meta"]))
    # fault-tolerant execution is ported: the statement runs, equal to local
    sql = "select n_regionkey, count(*) c from nation group by n_regionkey order by 1"
    _same(e.execute_sql(sql, s, fault_tolerant=True), e.execute_sql(sql, s), "fte guard")
    plan = compile_sql("select count(*) from nation", e, s)
    with pytest.raises(ValueError, match="locally only"):
        e.execute_plan(plan, params=(), distributed=True,
                       mesh=worker_mesh(1, devices=["cpu"]))
