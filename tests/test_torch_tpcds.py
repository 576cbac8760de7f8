"""The port's TPC-DS slice against the JAX package at SF0.01.

- The generator (``trino_tpu_torch/connectors/tpcds.py``): all 24 tables
  split by split, equal in value and dtype, with the same dictionaries
  (element for element), metadata, row counts, split lists, ``column_range``
  and ``split_range``.
- The corpus loader keys the SQL of tests/test_tpcds*.py by test name.
- SQL parity for a named subset of the corpus and for the window shapes of
  tests/test_window_setops.py and tests/test_window_frames2.py restated over
  TPC-H tables; between them they run all 17 window kinds, every frame shape
  the corpus reaches (ROWS 2 preceding..current, 1 preceding..1 following,
  1..2 following, 3..4 following, unbounded..unbounded; RANGE 10
  preceding..current and 5 preceding..5 following on int, decimal, DOUBLE,
  date and nullable keys), Union, Values, Limit over a TableScan and over a
  Join, stddev_samp, and the calls is_null, coalesce, in_array and abs.
- UNION ALL with VALUES and over two string dictionaries, LIMIT over an
  aggregate, the variance aggregates, grouped and ungrouped, avg over
  integer columns (finalized in float64), and a TopN's host-side rows
  feeding a join build and a window.

Tolerances: integer, decimal, date and dictionary-id columns exactly, and
NULL masks exactly; DOUBLE within rtol 1e-9.  Row order is compared where
the statement orders its rows, else the rows are compared as sorted lists.
"""

import re

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpcds import TpcdsConnector as JaxTpcds
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.tpcds import TpcdsConnector as TorchTpcds
from trino_tpu_torch.connectors.tpcds_queries import corpus
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF = 0.01
SPLIT = 1 << 14  # the corpus tests' split size

TABLES = sorted(JaxTpcds(sf=SF).tables())
TPCDS_QUERIES = corpus()


# -- the generator ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conns():
    # pages of 2^18 rows: the reference compiles one program per split
    return JaxTpcds(sf=SF, split_rows=1 << 18), TorchTpcds(sf=SF, split_rows=1 << 18,
                                                           device="cpu")


def test_every_table_is_ported(conns):
    j, t = conns
    assert len(TABLES) == 24
    assert t.tables() == j.tables()


@pytest.mark.parametrize("table", TABLES)
def test_table_equal_split_by_split(table):
    # about three splits a table, so every table of two rows or more has a
    # split at a nonzero offset (where the generators' ticket and row
    # groupings start mid-stream) and most a last split padded past the end
    # (the reference compiles one program per split)
    split = -(-JaxTpcds(sf=SF).row_count(table) // 3) + 1
    j, t = JaxTpcds(sf=SF, split_rows=split), TorchTpcds(sf=SF, split_rows=split, device="cpu")
    js, ts = j.splits(table), t.splits(table)
    assert [(s.table, s.lo, s.hi) for s in js] == [(s.table, s.lo, s.hi) for s in ts]
    for a, b in zip(js, ts):
        pa, pb = j.generate(a), t.generate(b)
        assert pa.schema.names == pb.schema.names
        assert (pa.valid is None) == (pb.valid is None)
        if pa.valid is not None:
            np.testing.assert_array_equal(np.asarray(pa.valid), pb.valid.numpy())
        for name, ca, cb in zip(pa.schema.names, pa.columns, pb.columns):
            ca, cb = np.asarray(ca), cb.numpy()
            assert ca.dtype == cb.dtype, name
            np.testing.assert_array_equal(ca, cb, err_msg=f"{table}.{name} {a}")


@pytest.mark.parametrize("table", TABLES)
def test_metadata_and_dictionaries_equal(conns, table):
    j, t = conns
    assert t.row_count(table) == j.row_count(table)
    assert t.exact_row_count(table) == j.exact_row_count(table)
    js, ts = j.schema(table), t.schema(table)
    assert js.names == ts.names
    assert [f.type.name for f in js.fields] == [f.type.name for f in ts.fields]
    try:
        pk = j.primary_key(table)
    except KeyError:
        with pytest.raises(KeyError):
            t.primary_key(table)
    else:
        assert t.primary_key(table) == pk
    for f in js.fields:
        assert t.column_range(table, f.name) == j.column_range(table, f.name)
    for s_j, s_t in zip(j.splits(table), t.splits(table)):
        for f in js.fields:
            assert t.split_range(s_t, f.name) == j.split_range(s_j, f.name)
    jd, td = j.dictionaries(table), t.dictionaries(table)
    assert set(jd) == set(td)
    for k in jd:
        np.testing.assert_array_equal(jd[k].values, td[k].values, err_msg=k)
        assert jd[k].values.dtype == td[k].values.dtype, k


def test_column_subset_and_generate_traced(conns):
    j, t = conns
    cols = ["ss_net_profit", "ss_sold_date_sk", "ss_item_sk"]
    sj, st = j.splits("store_sales")[-1], t.splits("store_sales")[-1]
    pa, pb = j.generate(sj, cols), t.generate(st, cols)
    assert pb.schema.names == tuple(cols)
    for ca, cb in zip(pa.columns, pb.columns):
        np.testing.assert_array_equal(np.asarray(ca), cb.numpy())
    (jc, jv), (tc, tv) = (c.generate_traced("inventory", 100, 333, ["inv_item_sk"])
                          for c in (j, t))
    np.testing.assert_array_equal(np.asarray(jc[0]), tc[0].numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


# -- the corpus ---------------------------------------------------------------------------


def test_corpus_keys_follow_the_tests(tmp_path):
    """The loader keys each statement by its test's name without ``test_``,
    numbered from 1 where a test runs several, in source order; functions
    that are not tests are skipped."""
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_tpcds9.py").write_text(
        "def helper(e):\n"
        "    e.execute_sql('select 0')\n"
        "def test_two(e):\n"
        "    for s in (e.create_session('tpcds'),):\n"
        "        e.execute_sql('select 1', s)\n"
        "    e.execute_sql('select 2')\n"
        "def test_one(e):\n"
        "    check(e.execute_sql('select 3'))\n")
    assert corpus(str(tmp_path)) == {"two_1": "select 1", "two_2": "select 2",
                                     "one": "select 3"}
    with pytest.raises(FileNotFoundError):
        corpus(str(tmp_path / "nowhere"))
    assert len(TPCDS_QUERIES) == 89
    assert set(SUBSET) - {"window_kinds_and_rows_frames",
                          "window_range_frames_and_limits"} <= set(TPCDS_QUERIES)


# -- SQL parity ---------------------------------------------------------------------------

# the window shapes of tests/test_window_setops.py and tests/test_window_frames2.py
# over TPC-H tables (NULLs from CASE), every kind and frame in two statements
W_KINDS = """
    select o_custkey, o_orderkey,
           row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) rn,
           rank() over (partition by o_custkey order by o_orderpriority) rk,
           dense_rank() over (partition by o_custkey order by o_orderpriority) drk,
           ntile(3) over (partition by o_custkey order by o_orderkey) nt,
           percent_rank() over (partition by o_custkey order by o_orderpriority) pr,
           cume_dist() over (partition by o_custkey order by o_orderpriority desc) cd,
           count(*) over (partition by o_custkey) cnt,
           count(v) over (partition by o_custkey order by o_orderkey) cv,
           sum(o_totalprice) over (partition by o_custkey order by o_orderkey
                                   rows between 2 preceding and current row) s3,
           avg(o_totalprice) over (partition by o_custkey order by o_orderkey
                                   rows between 1 preceding and 1 following) a3,
           min(v) over (partition by o_custkey order by o_orderkey
                        rows between 1 following and 2 following) mn,
           max(v) over (partition by o_custkey order by o_orderkey) mx,
           count(*) over (partition by o_custkey order by o_orderkey
                          rows between 3 following and 4 following) cf,
           avg(v) over (partition by o_custkey order by o_orderkey
                        rows between unbounded preceding and unbounded following) aa,
           lag(v) over (partition by o_custkey order by o_orderkey) l1,
           lag(o_orderkey, 2, -1) over (partition by o_custkey order by o_orderkey) l2,
           lead(v) ignore nulls over (partition by o_custkey order by o_orderkey) ld,
           lag(v, 2) ignore nulls over (partition by o_custkey order by o_orderkey) li,
           first_value(v) over (partition by o_custkey order by o_orderkey
                                rows between 1 preceding and current row) fv,
           last_value(v) ignore nulls over (partition by o_custkey order by o_orderkey
                                rows between unbounded preceding and unbounded following) lv,
           nth_value(o_orderkey, 2) over (partition by o_custkey order by o_orderkey) nv,
           nth_value(v, 2) ignore nulls over (partition by o_custkey order by o_orderkey
                                rows between unbounded preceding and current row) nvi
    from (select o_custkey, o_orderkey, o_orderdate, o_orderpriority, o_totalprice,
                 case when o_orderpriority = '3-MEDIUM' then null
                      else o_orderkey end v
          from orders where o_custkey < 400) t
    order by o_custkey, o_orderkey"""
W_RANGE = """
    select l_orderkey, l_linenumber,
           sum(l_quantity) over (partition by l_returnflag order by l_orderkey
                                 range between 10 preceding and current row) r1,
           count(*) over (partition by l_returnflag order by l_orderkey
                          range between 5 preceding and 5 following) r2,
           min(l_extendedprice) over (partition by l_linestatus order by d
                                      range between 5 preceding and 5 following) r3,
           avg(d) over (partition by l_returnflag order by l_shipdate
                        range between 3 preceding and current row) r4,
           max(l_discount) over (order by l_quantity desc
                                 range between 5 preceding and 5 following) r5,
           sum(l_linenumber) over (partition by l_returnflag order by k
                                   range between 5 preceding and 5 following) r6
    from (select l_orderkey, l_linenumber, l_quantity, l_extendedprice, l_discount,
                 l_returnflag, l_linestatus, l_shipdate,
                 cast(l_tax as double) * 100 + l_linenumber d,
                 case when l_linenumber = 3 then null
                      else l_orderkey - 7 * l_linenumber end k
          from lineitem where l_orderkey < 1500) t
    order by l_orderkey, l_linenumber"""
UNION_LIMITS = """
    (select n_nationkey k, n_regionkey r from nation limit 3)
    union all
    (select l_orderkey k, o_custkey r from lineitem, orders
     where l_orderkey = o_orderkey and o_orderdate < date '1993-01-01' limit 4)"""

# name: (catalog, SQL, what it covers)
SUBSET = {
    "row_counts_1": ("tpcds", TPCDS_QUERIES["row_counts_1"], "Values (count pushdown)"),
    "q89_monthly_category_window": ("tpcds", TPCDS_QUERIES["q89_monthly_category_window"],
                                    "avg over a partition of an aggregate, abs"),
    "q98_class_revenue_ratio": ("tpcds", TPCDS_QUERIES["q98_class_revenue_ratio"],
                                "sum over a partition: the ratio shape"),
    "q44_best_worst_items_by_rank": ("tpcds",
                                     TPCDS_QUERIES["q44_best_worst_items_by_rank"],
                                     "row_number ranks"),
    "q51_cumulative_channel_windows": ("tpcds",
                                       TPCDS_QUERIES["q51_cumulative_channel_windows"],
                                       "cumulative sums (default RANGE frame)"),
    "q77_multichannel_profit_rollup": ("tpcds",
                                       TPCDS_QUERIES["q77_multichannel_profit_rollup"],
                                       "Union of channels, rollup as a Union"),
    "q39_inventory_mean_stdev": ("tpcds", TPCDS_QUERIES["q39_inventory_mean_stdev"],
                                 "stddev_samp"),
    "q40_returns_adjusted_pivot": ("tpcds", TPCDS_QUERIES["q40_returns_adjusted_pivot"],
                                   "coalesce"),
    "q97_channel_overlap_counts": ("tpcds", TPCDS_QUERIES["q97_channel_overlap_counts"],
                                   "is_null, a full outer join as a Union"),
    "q45_zip_list_or_item_subquery": ("tpcds",
                                      TPCDS_QUERIES["q45_zip_list_or_item_subquery"],
                                      "in_array (an eager IN subquery)"),
    "window_kinds_and_rows_frames": ("tpch", W_KINDS,
                                     "all 17 window kinds, ROWS frames, IGNORE NULLS"),
    "window_range_frames_and_limits": ("tpch", W_RANGE + "\n--\n" + UNION_LIMITS,
                                       "RANGE offsets on int, decimal, DOUBLE, date "
                                       "and nullable keys; Limit over a TableScan and "
                                       "over a Join under a Union"),
}

OPS = {
    "union_values": "select count(*) c from nation union all "
                    "select count(*) c from region union all "
                    "select n_nationkey from nation where n_regionkey = 2",
    "limit_aggregate": "select l_returnflag, count(*) c from lineitem "
                       "group by l_returnflag limit 2",
    "variance_grouped": "select l_returnflag, var_pop(l_quantity) a, "
                        "var_samp(l_quantity) b, stddev_pop(l_extendedprice) c, "
                        "stddev_samp(l_discount) d from lineitem "
                        "where l_orderkey < 40 or l_returnflag = 'N' "
                        "group by l_returnflag order by l_returnflag",
    "variance_one_row_groups": "select o_orderkey, var_samp(o_totalprice) a, "
                               "stddev_pop(o_totalprice) b from orders "
                               "where o_orderkey < 40 group by o_orderkey "
                               "order by o_orderkey",
    "variance_global": "select var_pop(l_quantity) a, var_samp(l_extendedprice) b, "
                       "stddev_pop(l_discount) c, stddev_samp(l_quantity) d "
                       "from lineitem",
    # string columns of two dictionaries: the planner re-encodes both branches
    # into one, so the output keeps the first branch's
    "union_of_dictionaries": "select c_mktsegment x from customer where c_custkey < 3 "
                             "union all select o_orderpriority x from orders "
                             "where o_orderkey < 3",
    # avg over integers finalizes in float64 (ROADMAP C2)
    "avg_of_integers_grouped": "select l_returnflag, avg(l_linenumber) a, "
                               "avg(l_orderkey) b from lineitem group by l_returnflag "
                               "order by l_returnflag",
    "avg_of_integers_global": "select avg(l_linenumber) a, avg(o_custkey) b "
                              "from lineitem, orders where l_orderkey = o_orderkey",
    # a TopN's rows, pulled to the host, feed a join build and a window
    "join_with_topn_build": "select l_orderkey, l_linenumber, l_quantity from lineitem, "
                            "(select o_orderkey, o_totalprice from orders "
                            "order by o_totalprice desc limit 10) t "
                            "where l_orderkey = t.o_orderkey "
                            "order by l_orderkey, l_linenumber",
    "window_over_topn": "select k, p, row_number() over (order by p desc) rn, "
                        "sum(p) over (order by k rows between 1 preceding and current row) s "
                        "from (select o_orderkey k, o_totalprice p from orders "
                        "order by p limit 20) t order by k",
}


@pytest.fixture(scope="module")
def engines(tpch_sf001):
    j = JaxEngine()
    j.register_catalog("tpcds", JaxTpcds(sf=SF, split_rows=SPLIT))
    j.register_catalog("tpch", tpch_sf001)
    t = TorchEngine(device="cpu")
    t.register_catalog("tpcds", TorchTpcds(sf=SF, split_rows=SPLIT))
    t.register_catalog("tpch", TorchTpch(sf=0.01))
    return j, t


def _ordered(sql: str) -> bool:
    """Whether the statement's outermost query orders its rows."""
    return re.search(r"order\s+by[^()]*$", sql.strip(), re.I) is not None


def _rows(r):
    out = []
    for row in zip(*(list(c) for c in r.raw_columns)):
        out.append(tuple(v.item() if isinstance(v, np.generic) else v for v in row))
    return out


def _assert_same(a, b, ordered):
    assert tuple(a.names) == tuple(b.names)
    assert len(a) == len(b)
    na = [np.array([v is None for v in c], bool) for c in a.columns]
    nb = [np.array([v is None for v in c], bool) for c in b.columns]
    ra, rb = _rows(a), _rows(b)
    # a NULL's raw value is a fill value: compare it as None
    ra = [tuple(None if na[i][k] else v for i, v in enumerate(r)) for k, r in enumerate(ra)]
    rb = [tuple(None if nb[i][k] else v for i, v in enumerate(r)) for k, r in enumerate(rb)]
    if not ordered:
        ra, rb = sorted(ra, key=repr), sorted(rb, key=repr)
    for t_, i in zip(a.types, range(len(a.names))):
        ca = [r[i] for r in ra]
        cb = [r[i] for r in rb]
        assert [v is None for v in ca] == [v is None for v in cb], a.names[i]
        if t_.is_floating:
            x = np.array([v for v in ca if v is not None], np.float64)
            y = np.array([v for v in cb if v is not None], np.float64)
            np.testing.assert_allclose(y, x, rtol=1e-9, atol=0, err_msg=a.names[i])
        else:
            assert ca == cb, a.names[i]


@pytest.mark.parametrize("name", list(SUBSET))
def test_sql_subset_equals_the_reference(engines, name):
    catalog, sql, _ = SUBSET[name]
    j, t = engines
    for stmt in sql.split("\n--\n"):
        a = j.execute_sql(stmt, j.create_session(catalog))
        b = t.execute_sql(stmt, t.create_session(catalog))
        _assert_same(a, b, _ordered(stmt))


@pytest.mark.parametrize("name", list(OPS))
def test_operators_equal_the_reference(engines, name):
    j, t = engines
    a = j.execute_sql(OPS[name], j.create_session("tpch"))
    b = t.execute_sql(OPS[name], t.create_session("tpch"))
    _assert_same(a, b, _ordered(OPS[name]))
