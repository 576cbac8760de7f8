"""The port's scan-fused whole-scan runners (``LocalExecutor._run_aggregate_scan_fused``,
``_run_global_scan_fused``, ``_concat_traced``) against the JAX package on
the CPU.

Restates the five cases of tests/test_scan_fused.py at its size (SF0.02,
2^13-row splits) with ``TRINO_TPU_SCAN_FUSED=1`` in both packages (the runners
are off on the CPU by default, on a CUDA engine on): the direct group-by, the
hash group-by after a join, the global aggregate, a session
``group_by_capacity`` of 64, and the semi-join whose kept splits feed the
fused scan.  Each case counts that the port's fused runner took the query,
and holds the port's result against the reference's fused run and against
the port's page loop (``TRINO_TPU_SCAN_FUSED=0``): integers, decimals, dates
and strings exactly, DOUBLE within rtol 1e-9.  Adds a case for the traced
concat on a join build, one where a 64-slot hash table overflows inside
the fused scan and the scan runs again at 4x, one for the tensor split
offset the runners give the generators, one for the nation table's region
keys, which the generator now computes on the device, and two for the
runners' own structures (the fused cache's bounds, a body's input
structure).  On the CPU the runners run their body in a plain
loop over the split offsets; the CUDA graph that replays it on the card is
held against that loop in tests/test_torch_gpu.py.
"""

import os
import sys

import pytest
import torch

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors import tpch as port_tpch
from trino_tpu_torch.connectors.tpcds import TpcdsConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
import trino_tpu_torch.exec.local_executor as LE

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.02, 1 << 13

Q_DIRECT = ("select l_returnflag, l_linestatus, sum(l_quantity) q, count(*) c "
            "from lineitem where l_shipdate <= date '1998-09-02' "
            "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
Q_HASH_JOIN = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) rev "
               "from orders, lineitem "
               "where l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
               "and l_shipdate > date '1995-03-15' "
               "group by l_orderkey order by rev desc, l_orderkey limit 10")
Q_GLOBAL = ("select count(*) c, sum(l_extendedprice) se, min(l_discount) mn, "
            "max(l_tax) mx from lineitem where l_discount > 0.03")
Q_GROWTH = ("select l_suppkey, count(*) c from lineitem "
            "group by l_suppkey order by l_suppkey limit 20")
Q_HASH_GROWTH = ("select l_suppkey * 3 k, count(*) c from lineitem "
                 "group by l_suppkey * 3 order by k limit 20")
Q_SEMI = ("select o_orderpriority, count(*) c from orders "
          "where o_orderdate >= date '1993-07-01' and o_orderdate < date '1993-10-01' "
          "and exists (select 1 from lineitem where l_orderkey = o_orderkey "
          "and l_commitdate < l_receiptdate) "
          "group by o_orderpriority order by o_orderpriority")
# a join whose build side (filtered orders) materializes through the traced
# concat, probed by a fused global aggregation over lineitem
Q_BUILD = ("select count(*) c, sum(o_totalprice) tp, sum(l_quantity) q "
           "from lineitem, orders where l_orderkey = o_orderkey "
           "and o_orderdate < date '1993-06-01'")
ORDER_BY = {Q_DIRECT: ("l_returnflag", "l_linestatus"), Q_HASH_JOIN: ("rev", "l_orderkey"),
            Q_GROWTH: ("l_suppkey",), Q_HASH_GROWTH: ("k",), Q_SEMI: ("o_orderpriority",)}


@pytest.fixture(scope="module")
def ref():
    """The reference's fused run of each statement, computed once."""
    old = os.environ.get("TRINO_TPU_SCAN_FUSED")
    os.environ["TRINO_TPU_SCAN_FUSED"] = "1"
    e = JaxEngine()
    e.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    cache = {}

    def get(sql, setup=()):
        if sql not in cache:
            s = e.create_session("tpch")
            for st in setup:
                e.execute_sql(st, s)
            cache[sql] = e.execute_sql(sql, s)
        return cache[sql]

    try:
        yield get
    finally:
        if old is None:
            os.environ.pop("TRINO_TPU_SCAN_FUSED", None)
        else:
            os.environ["TRINO_TPU_SCAN_FUSED"] = old


@pytest.fixture()
def feng(monkeypatch):
    """A port engine with the runners forced on, and a count of the runs
    each runner took (returned a result)."""
    monkeypatch.setenv("TRINO_TPU_SCAN_FUSED", "1")
    calls = {"agg": 0, "global": 0, "concat": 0}
    for name, key in (("_run_aggregate_scan_fused", "agg"),
                      ("_run_global_scan_fused", "global"), ("_concat_traced", "concat")):
        orig = getattr(LE.LocalExecutor, name)

        def counting(self, *a, _o=orig, _k=key, **k):
            out = _o(self, *a, **k)
            if out is not None:
                calls[_k] += 1
            return out

        monkeypatch.setattr(LE.LocalExecutor, name, counting)
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e, calls


def _page_loop(sql, setup=()):
    """The port's result with the runners off."""
    old = os.environ.get("TRINO_TPU_SCAN_FUSED")
    os.environ["TRINO_TPU_SCAN_FUSED"] = "0"
    try:
        e = Engine(device="cpu")
        e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
        s = e.create_session("tpch")
        for st in setup:
            e.execute_sql(st, s)
        return e.execute_sql(sql, s)
    finally:
        if old is None:
            os.environ.pop("TRINO_TPU_SCAN_FUSED", None)
        else:
            os.environ["TRINO_TPU_SCAN_FUSED"] = old


def _run(feng, ref, sql, setup=()):
    e, calls = feng
    s = e.create_session("tpch")
    for st in setup:
        e.execute_sql(st, s)
    got = e.execute_sql(sql, s)
    order = ORDER_BY.get(sql)
    chip_smoke.same_result(got, ref(sql, setup), "fused port vs fused reference",
                           order_by=order)
    chip_smoke.same_result(got, _page_loop(sql, setup), "fused vs page loop",
                           order_by=order)
    return e, calls


def test_fused_direct_groupby(feng, ref):
    e, calls = _run(feng, ref, Q_DIRECT)
    assert calls["agg"] == 1, "the fused runner did not take the grouped aggregation"
    assert e.last_query_counters["coalesced_splits"] == 0  # no page loop ran


def test_fused_hash_groupby_after_join(feng, ref):
    _, calls = _run(feng, ref, Q_HASH_JOIN)
    assert calls["agg"] >= 1, "the fused runner did not take the join + aggregation"


def test_fused_global_agg(feng, ref):
    _, calls = _run(feng, ref, Q_GLOBAL)
    assert calls["global"] == 1, "the fused runner did not take the global aggregation"


def test_fused_growth_on_undersized_capacity(feng, ref):
    """``group_by_capacity = 64``, as the reference's case sets it: the fused
    runner takes the aggregation and the result stays exact.  (Neither
    package's planner reads the property, and l_suppkey's range is known,
    so the runner takes the direct table; the next case makes a hash table
    grow.)"""
    _, calls = _run(feng, ref, Q_GROWTH, ("set session group_by_capacity = 64",))
    assert calls["agg"] >= 1


def test_fused_hash_growth_runs_the_scan_again(feng, ref, monkeypatch):
    """A key of unknown range takes the hash table; sized at 64 slots (no
    estimate) it overflows inside the fused scan, grows 4x and the scan runs
    again until it fits."""
    monkeypatch.setattr(LE, "DEFAULT_GROUP_CAPACITY", 64)
    monkeypatch.setattr(LE.LocalExecutor, "_agg_capacity_estimate", lambda *a: None)
    runs = []
    orig = LE.LocalExecutor._fused_scan

    def counting(self, key, *a, **k):
        runs.append(key[0])
        return orig(self, key, *a, **k)

    monkeypatch.setattr(LE.LocalExecutor, "_fused_scan", counting)
    _, calls = _run(feng, ref, Q_HASH_GROWTH)
    assert calls["agg"] >= 1
    assert runs.count("agg") >= 2, runs  # at least one run again at 4x


def test_fused_semi_join_agg(feng, ref):
    """The semi join's dynamic filter prunes the probe's splits: the kept
    splits feed the fused scan."""
    _, calls = _run(feng, ref, Q_SEMI)
    assert calls["agg"] >= 1


def test_fused_concat_on_join_build(feng, ref):
    _, calls = _run(feng, ref, Q_BUILD)
    assert calls["concat"] >= 1, "the traced concat did not take the build side"
    assert calls["global"] == 1


def test_generators_take_a_device_offset():
    """``generate_traced`` reads a split's first row from a 0-d tensor as
    from a host int, in both generator connectors (lineitem from an order
    range)."""
    for conn, table, cols in (
            (TpchConnector(sf=0.01, split_rows=1 << 12), "lineitem",
             ["l_orderkey", "l_extendedprice", "l_shipdate"]),
            (TpchConnector(sf=0.01, split_rows=1 << 12), "orders", ["o_orderkey", "o_custkey"]),
            (TpcdsConnector(sf=0.01, split_rows=1 << 12), "store_sales",
             ["ss_item_sk", "ss_sold_date_sk", "ss_net_paid"])):
        sp = conn.splits(table)[1]
        a, va = conn.generate_traced(table, sp.lo, sp.hi - sp.lo, cols)
        b, vb = conn.generate_traced(table, torch.tensor(sp.lo), sp.hi - sp.lo, cols)
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(va, vb)


def test_nation_regions_on_the_device():
    assert port_tpch._nation_region(torch.arange(25)).tolist() == \
        [r for _, r in port_tpch.NATIONS]


def test_fused_cache_drops_the_least_recently_used_past_its_bounds():
    """The fused cache keeps at most ``max_entries`` entries and
    ``max_bytes`` of static tensors, least recently used out first."""
    cache = LE.FusedGraphCache(max_entries=3, max_bytes=100)
    for k in "abc":
        cache.put(k, k.upper(), 30)
    assert cache.get("a") == "A"  # now the most recent
    cache.put("d", "D", 30)  # 120 bytes: "b" goes
    assert cache.get("b") is None and cache.get("a") == "A"
    cache.put("e", "E", 0)  # four entries: "c" goes
    assert [cache.get(k) for k in "acde"] == [
        "A", None, "D", "E"]
    cache.clear()
    assert len(cache) == 0 and cache.get("a") is None


def test_a_body_input_structure_round_trips():
    """``_tree_sig`` / ``_tree_build``: a stage's state (tuples, dataclasses,
    host and numpy scalars around tensors) rebuilds over new tensors, and a
    host array makes the stream ineligible."""
    import numpy as np

    from trino_tpu_torch.ops.hashjoin import DirectJoinTable

    t = DirectJoinTable(torch.arange(4), torch.ones(4, dtype=torch.bool),
                        (torch.arange(3),), (None,), torch.zeros((), dtype=torch.int32),
                        np.int64(5))
    leaves = []
    sig = LE._tree_sig(((), (t, 3)), leaves)
    assert sig is not None and len(leaves) == 4
    new = [x.clone() + 1 for x in leaves]
    got = LE._tree_build(sig, iter(new))
    assert got[0] == () and got[1][1] == 3 and got[1][0].lo == 5
    assert got[1][0].rows is new[0] and got[1][0].build_columns[0] is new[2]
    assert LE._tree_sig((np.arange(3),), []) is None


def test_the_fused_cache_holds_its_bytes_in_the_memory_pool():
    """A fused cache with a memory pool holds its static bytes there while
    their entries stay, and what captures added to the graph pool until it
    is cleared; none of it is a query's."""
    from trino_tpu_torch.memory import MemoryPool

    pool = MemoryPool(max_bytes=1000)
    cache = LE.FusedGraphCache(max_entries=2, max_bytes=100, memory_pool=pool)
    cache.put("a", "A", 30)
    cache.put("b", "B", 40)
    cache.add_pool_bytes(200)
    assert pool.reserved == 270 and pool.info()["by_tag"]["fused-graphs"] == 270
    assert pool.query_reserved == 0
    cache.put("c", "C", 10)  # three entries: "a" goes
    assert pool.reserved == 250
    cache.put("b", "B", 5)  # replaced: its bytes as they are now
    assert pool.reserved == 215
    cache.clear()
    assert pool.reserved == 0 and pool.info()["by_tag"]["fused-graphs"] == 0


@pytest.mark.parametrize("mode", ["hash", "direct", "onehot"])
def test_in_place_inserts_equal_the_functional_ones(mode):
    """``inplace=True`` (the fused bodies' form) writes the state it is
    given and returns those tensors, with the values the functional insert
    computes, page after page."""
    import numpy as np

    from trino_tpu_torch.ops import hashagg
    from trino_tpu_torch.types import BIGINT, DOUBLE

    gen = np.random.default_rng(7)
    hi = {"hash": 5000, "direct": 3000, "onehot": 100}[mode]
    specs = [(BIGINT, 0), (DOUBLE, 0.0), (BIGINT, np.iinfo(np.int64).max)]
    kinds = ("count_star", "sum", "min")
    if mode == "hash":
        cfg = None
        init = lambda: hashagg.groupby_init(1 << 12, (BIGINT,), specs)  # noqa: E731
    else:
        cfg = hashagg.direct_config(((0, hi - 1),), (False,))
        init = lambda: hashagg.direct_groupby_init(cfg, (BIGINT,), specs)  # noqa: E731
    fun, inp = init(), init()
    held = [inp.table, *inp.key_cols, *inp.key_nulls, *inp.accs, inp.overflow]
    for _ in range(3):
        keys = torch.as_tensor(gen.integers(0, hi, 700), dtype=torch.int64)
        valid = torch.as_tensor(gen.random(700) < 0.9)
        vals = torch.as_tensor(gen.integers(-50, 50, 700), dtype=torch.int64)
        inputs = [(None, None), (vals.to(torch.float64), None), (vals, None)]
        if cfg is None:
            def step(st, inplace):
                return hashagg.groupby_insert(st, (keys,), (BIGINT,), valid, inputs, kinds,
                                              inplace=inplace)
        else:
            def step(st, inplace):
                return hashagg.direct_groupby_insert(st, cfg, (keys,), valid, inputs, kinds,
                                                     inplace=inplace)
        fun = step(fun, False)
        inp = step(inp, True)
        now = [inp.table, *inp.key_cols, *inp.key_nulls, *inp.accs, inp.overflow]
        assert all(a is b for a, b in zip(now, held))
    if cfg is None:  # slots follow the claim order: compare the groups
        def groups(st):
            occ = st.table[:-1] != hashagg.EMPTY_KEY
            order = torch.argsort(st.table[:-1][occ])
            return [x[:-1][occ][order] for x in (st.table, *st.key_cols, *st.accs)]
        for a, b in zip(groups(fun), groups(inp)):
            assert torch.equal(a, b)
    else:
        for a, b in zip([fun.table, *fun.accs], [inp.table, *inp.accs]):
            assert torch.equal(a, b)
    assert bool(fun.overflow) == bool(inp.overflow)
