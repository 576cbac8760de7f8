"""Planner and executor edge cases of the port against the JAX package, at
TPC-H SF0.01 on the CPU.

Restates, statement by statement, each as a parametrised case run in both
packages (``trino_tpu.Engine`` and ``trino_tpu_torch.Engine(device="cpu")``):

- tests/test_subquery_edges.py: IN-subquery key coercion, computed
  correlation keys, CTE scoping, empty build sides, correlated counts over
  empty groups, EXISTS over an ungrouped aggregate, IN with LIMIT, nested
  explicit joins under EXISTS, NOT IN's NULL semantics, constant join keys,
  and the statements of its dynamic-filtering test (whose split pruning is
  held here on the port's own generate calls); the two statements the
  planner refuses raise the same ``SemanticError`` in both.  Left out:
  test_distributed_dup_key_join_falls_back, which runs with
  ``distributed=True`` on the SPMD executor (ROADMAP A7);
- tests/test_mark_join.py: EXISTS in expression position (mark joins) over
  its memory tables;
- tests/test_tpch_invariants.py: the TPC-H specification's invariants (at
  SF0.01 here, where the reference runs SF0.1: both packages get the same
  data, so the statements compare at any scale), and its row counts;
- tests/test_arrays.py::test_array_type_ddl_roundtrip: an array column's
  type through CREATE TABLE and SHOW COLUMNS.

Outcomes agree under the port's parity rules: integers, decimals, dates and
strings exactly, DOUBLE within rtol 1e-9, row order where the statement
orders its rows, errors of the same type and message.
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

SF = 0.01

_LITS = ",".join(str(i) for i in range(1, 51))

SUBQUERY_EDGES = {
    "in_key_coercion": "select count(*) c from lineitem where l_quantity in "
                       "(select p_size from part)",
    "in_literal_list": f"select count(*) c from lineitem where l_quantity in ({_LITS})",
    "correlated_plain": "select count(*) c from orders where o_totalprice < "
                        "(select sum(l_extendedprice) from lineitem where l_orderkey = o_orderkey)",
    "correlated_computed": "select count(*) c from orders where o_totalprice < "
                           "(select sum(l_extendedprice) from lineitem "
                           "where l_orderkey = o_orderkey + 0)",
    "cte_shadowing": """
        with t as (select n_name from nation)
        select * from (with t as (select r_name from region)
                       select r_name from t) y limit 3""",
    "cte_outer": "with t as (select n_name from nation) select n_name from t",
    "scalar_cardinality_error": "select count(*) c from orders where o_totalprice > "
                                "(select o_totalprice from orders)",
    "empty_build_left": """select count(*) c from nation left outer join customer
                           on n_nationkey = c_nationkey and c_acctbal < -99999999""",
    "empty_build_inner": """select count(*) c from nation, customer
                            where n_nationkey = c_nationkey and c_acctbal < -99999999""",
    "correlated_count_empty_group": "select count(*) c from customer where "
                                    "(select count(*) from orders where o_custkey = c_custkey) = 0",
    "not_exists_empty_group": "select count(*) c from customer where "
                              "not exists (select * from orders where o_custkey = c_custkey)",
    "exists_group_having_error": "select count(*) from customer where exists "
                                 "(select 1 from orders where o_custkey = c_custkey "
                                 " group by o_orderstatus having count(*) > 1000)",
    "exists_ungrouped_aggregate": "select count(*) c from nation where exists "
                                  "(select max(o_orderkey) from orders where o_custkey = -1)",
    "in_respects_limit": "select count(*) c from lineitem where l_partkey in "
                         "(select p_partkey from part order by p_partkey limit 5)",
    "in_five_literals": "select count(*) c from lineitem where l_partkey in (1, 2, 3, 4, 5)",
    "exists_nested_joins": """
        select count(*) c from supplier s1 where exists (
            select 1 from lineitem l2
            join orders o2 on l2.l_orderkey = o2.o_orderkey
            join customer c2 on o2.o_custkey = c2.c_custkey
            where l2.l_suppkey = s1.s_suppkey and o2.o_orderstatus = 'F')""",
    "not_in_null": "select count(*) c from nation where n_nationkey not in "
                   "(select case when r_regionkey > 0 then r_regionkey else null end "
                   "from region)",
    "in_null": "select count(*) c from nation where n_nationkey in "
               "(select case when r_regionkey > 0 then r_regionkey else null end from region)",
    "constant_join_key": "select count(*) c from nation join region on r_regionkey = 0",
    "dynamic_filter_semi": "select count(*) c from lineitem where l_orderkey in "
                           "(select o_orderkey from orders where o_orderkey < 100)",
    "dynamic_filter_inner": "select count(*) c from lineitem, orders "
                            "where l_orderkey = o_orderkey and o_orderkey < 100",
    "dynamic_filter_anti": "select count(*) c from lineitem where l_orderkey not in "
                           "(select o_orderkey from orders where o_orderkey >= 100)",
}

MARK_SETUP = (
    "create table c (ck bigint, nm varchar)",
    "create table w (wk bigint)",
    "create table g (gk bigint)",
    "create table b2 (k bigint, v bigint)",
    "insert into c values (1,'a'), (2,'b'), (3,'c'), (4,'d')",
    "insert into w values (1), (3)",
    "insert into g values (2), (3)",
    "insert into b2 values (1, 10), (1, 20), (3, 5)",
)

MARK_JOIN = {
    "or_of_two_exists": """select ck from c
        where exists (select 1 from w where wk = c.ck)
           or exists (select 1 from g where gk = c.ck)
        order by ck""",
    "not_over_or_of_exists": """select ck from c
        where not (exists (select 1 from w where wk = c.ck)
                or exists (select 1 from g where gk = c.ck))""",
    "exists_or_plain_predicate": """select ck from c
        where ck = 4 or exists (select 1 from w where wk = c.ck)
        order by ck""",
    "exists_inside_case": """select ck from c
        where case when exists (select 1 from w where wk = c.ck)
              then 1 else 0 end = 1 order by ck""",
    "negated_exists_under_or": """select ck from c
        where (not exists (select 1 from w where wk = c.ck)) or ck = 1
        order by ck""",
    "uncorrelated_exists_under_or": """select ck from c
        where exists (select 1 from w where wk > 100) or ck = 2""",
    "mark_mixes_with_in": """select ck from c
        where ck in (select gk from g)
           or exists (select 1 from w where wk = c.ck)
        order by ck""",
    "plain_exists_semi_join": """select ck from c
        where exists (select 1 from w where wk = c.ck)
        order by ck""",
    "select_star_hides_mark": """select * from c
        where exists (select 1 from w where wk = c.ck) or ck = 2
        order by ck""",
    "or_of_in_subqueries": """select ck from c
        where ck in (select wk from w) or ck in (select gk from g)
        order by ck""",
    "ungrouped_aggregate_exists": """select ck from c
        where ck = 4 or exists (select max(wk) from w where wk = c.ck)
        order by ck""",
    "grouped_exists_in_expression": """select ck from c
        where ck = 4 or exists (select wk from w where wk = c.ck group by wk)
        order by ck""",
    "exists_in_select_case": """select ck,
        case when exists (select 1 from w where wk = c.ck)
             then 'w' else 'x' end tag from c order by ck""",
    "exists_in_select_list": """select ck,
        exists (select 1 from g where gk = c.ck) m from c order by ck""",
    "correlated_scalar_sum": "select ck, (select sum(v) from b2 where b2.k = c.ck) sv "
                             "from c order by ck",
    "correlated_scalar_count": "select ck, (select count(*) from b2 where b2.k = c.ck) n "
                               "from c order by ck",
    "in_select_star": "select * from c where ck in (select k from b2) order by ck",
}

TPCH_INVARIANTS = {
    "lineitem_per_order": "select count(*) n, min(l_linenumber) mn, max(l_linenumber) mx "
                          "from lineitem",
    "orders_with_lines": "select count(distinct l_orderkey) from lineitem",
    "lineitem_domains": "select min(l_discount), max(l_discount), min(l_tax), max(l_tax), "
                        "min(l_quantity), max(l_quantity) from lineitem",
    "orders_domains": "select min(o_orderdate), max(o_orderdate), min(o_totalprice) "
                      "from orders",
    "ship_commit_receipt": "select count(*) from lineitem, orders where l_orderkey = o_orderkey "
                           "and (l_shipdate <= o_orderdate or l_receiptdate <= l_shipdate)",
    "lineitem_orders_integrity": "select count(*) from lineitem where l_orderkey not in "
                                 "(select o_orderkey from orders)",
    "partsupp_per_part": "select max(c) from (select ps_partkey, count(*) c from partsupp "
                         "group by ps_partkey) t",
    "part_count": "select count(*) from part",
    "part_distinct_keys": "select count(distinct p_partkey) from part",
    "q1_answer_structure": "select l_returnflag, l_linestatus, count(*) c, avg(l_quantity) q, "
                           "avg(l_discount) d from lineitem "
                           "where l_shipdate <= date '1998-12-01' - interval '90' day "
                           "group by l_returnflag, l_linestatus "
                           "order by l_returnflag, l_linestatus",
    "lineitem_count": "select count(*) from lineitem",
}


@pytest.fixture(scope="module")
def engines():
    """(reference, port, their sessions) over TPC-H at SF0.01 and a memory
    catalog holding test_mark_join.py's tables."""
    j, t = JaxEngine(), Engine(device="cpu")
    j.register_catalog("tpch", JaxTpch(sf=SF))
    t.register_catalog("tpch", TpchConnector(sf=SF))
    j.register_catalog("mem", JaxMemory())
    t.register_catalog("mem", MemoryConnector())
    sessions = {cat: (j.create_session(cat), t.create_session(cat)) for cat in ("tpch", "mem")}
    for sql in MARK_SETUP:
        j.execute_sql(sql, sessions["mem"][0])
        t.execute_sql(sql, sessions["mem"][1])
    return j, t, sessions


def _outcome(e, sql, s):
    try:
        return "ok", e.execute_sql(sql, s)
    except Exception as ex:  # noqa: BLE001 - both packages' errors are compared
        return "error", ex


def _both(engines, sql, catalog):
    """The statement in both packages: equal results, or the same error."""
    j, t, sessions = engines
    (kj, a), (kt, b) = _outcome(j, sql, sessions[catalog][0]), \
        _outcome(t, sql, sessions[catalog][1])
    assert kj == kt, (sql, a, b)
    if kj == "error":
        assert type(a).__name__ == type(b).__name__ and str(a) == str(b), (a, b)
        return b
    assert (a is None) == (b is None), (sql, a, b)
    if a is not None:
        chip_smoke.same_outcome_result(b, a, sql, sql)
    return b


@pytest.mark.parametrize("name", list(SUBQUERY_EDGES))
def test_subquery_edges(engines, name):
    out = _both(engines, SUBQUERY_EDGES[name], "tpch")
    if name.endswith("_error"):
        assert type(out).__name__ == "SemanticError"


@pytest.mark.parametrize("name", list(MARK_JOIN))
def test_mark_join(engines, name):
    _both(engines, MARK_JOIN[name], "mem")


@pytest.mark.parametrize("name", list(TPCH_INVARIANTS))
def test_tpch_invariants(engines, name):
    _both(engines, TPCH_INVARIANTS[name], "tpch")


def test_spec_row_counts_scale():
    """Spec 4.2.3's table scaling, the same in both connectors."""
    for sf in (1.0, SF):
        j, t = JaxTpch(sf=sf), TpchConnector(sf=sf)
        for table in j.tables():
            assert t.row_count(table) == j.row_count(table), (sf, table)
    assert TpchConnector(sf=1.0).row_count("orders") == 1_500_000


def test_dynamic_filter_prunes_probe_splits():
    """Inner and semi joins read only the probe splits inside the build
    keys' domain; an anti join reads every split (the port's own generate
    calls, as the reference's test counts its own)."""
    conn = TpchConnector(sf=SF, split_rows=1 << 12)
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    calls = []
    real = conn.generate
    conn.generate = lambda split, columns=None: (
        calls.append(1) if split.table == "lineitem" else None) or real(split, columns)
    n_splits = len(conn.splits("lineitem"))
    assert n_splits > 10
    s = e.create_session("tpch")
    semi = e.execute_sql(SUBQUERY_EDGES["dynamic_filter_semi"], s)
    assert len(calls) <= 2
    inner = e.execute_sql(SUBQUERY_EDGES["dynamic_filter_inner"], s)
    assert semi.rows() == inner.rows() and semi.rows()[0][0] > 0
    calls.clear()
    anti = e.execute_sql(SUBQUERY_EDGES["dynamic_filter_anti"], s)
    assert len(calls) == n_splits
    assert anti.rows() == semi.rows()


def test_array_type_ddl_roundtrip(engines):
    for sql in ("create table tt (a array(bigint), m bigint)", "show columns from tt"):
        out = _both(engines, sql, "mem")
    assert out.rows()[0] == ("a", "array(bigint)")
