"""Join kinds and ungrouped aggregation of the port against the JAX package,
through SQL at SF0.01: semi, anti (NOT IN, null-aware, and NOT EXISTS),
left and mark joins with an empty build side, with a NULL build key, and
with a residual filter; and a global aggregate over an empty and a full
input.

Results are compared on the decoded surface (NULLs as None; the values under
a NULL are fill and are not compared), DOUBLE within rtol 1e-9, in the order
each query states.
"""

import numpy as np
import pytest

from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

NO_REGION = "r_name = 'NO SUCH REGION'"
NULL_KEY = "case when r_regionkey = 0 then null else r_regionkey end"

CASES = {
    # an empty build side, per join kind
    "semi_empty_build": f"""
        select n_name from nation
        where n_nationkey in (select r_regionkey from region where {NO_REGION})
        order by n_name""",
    "anti_not_in_empty_build": f"""
        select n_name from nation
        where n_nationkey not in (select r_regionkey from region where {NO_REGION})
        order by n_name""",
    "anti_not_exists_empty_build": f"""
        select n_name from nation
        where not exists (select * from region
                          where r_regionkey = n_nationkey and {NO_REGION})
        order by n_name""",
    "left_empty_build": f"""
        select n_name, r_name, r_regionkey from nation left outer join
            (select * from region where {NO_REGION}) r on n_regionkey = r_regionkey
        order by n_name""",
    "mark_empty_build": f"""
        select n_name from nation
        where n_nationkey < 3 or exists (select * from region
                                        where r_regionkey = n_regionkey and {NO_REGION})
        order by n_name""",
    # a NULL among the build keys: NOT IN rejects every row, NOT EXISTS does not
    "anti_not_in_null_build_key": f"""
        select n_name from nation
        where n_nationkey not in (select {NULL_KEY} from region)
        order by n_name""",
    "anti_not_exists_null_build_key": f"""
        select n_name from nation
        where not exists (select * from region where {NULL_KEY} = n_nationkey)
        order by n_name""",
    "semi_null_build_key": f"""
        select n_name from nation where n_nationkey in (select {NULL_KEY} from region)
        order by n_name""",
    # matches present
    "mark_with_matches": """
        select n_name from nation
        where n_nationkey < 3 or exists (select * from region
                                        where r_regionkey = n_regionkey
                                          and r_name = 'ASIA')
        order by n_name""",
    "left_with_matches": """
        select n_name, r_name from nation left outer join
            (select * from region where r_name <> 'ASIA') r on n_regionkey = r_regionkey
        order by n_name""",
    # a residual filter (the multi-match strategy), empty and not
    "semi_residual_empty_build": """
        select o_orderpriority, count(*) as c from orders
        where exists (select * from lineitem where l_orderkey = o_orderkey
                        and l_suppkey <> o_custkey and l_quantity < 0)
        group by o_orderpriority order by o_orderpriority""",
    "anti_residual_empty_build": """
        select o_orderpriority, count(*) as c from orders
        where not exists (select * from lineitem where l_orderkey = o_orderkey
                            and l_suppkey <> o_custkey and l_quantity < 0)
        group by o_orderpriority order by o_orderpriority""",
    "anti_residual": """
        select o_orderpriority, count(*) as c from orders
        where not exists (select * from lineitem where l_orderkey = o_orderkey
                            and l_suppkey <> o_custkey and l_quantity > 45)
        group by o_orderpriority order by o_orderpriority""",
    # duplicate build keys over two key columns (the hashed multi-match layout)
    "inner_multi_hash_two_keys": """
        select p1.p_partkey, count(*) as c from part p1, part p2
        where p1.p_size = p2.p_size and p1.p_brand = p2.p_brand and p2.p_partkey < 400
        group by p1.p_partkey order by p1.p_partkey""",
    "left_multi_residual": """
        select c_custkey, count(o_orderkey) as c from customer left outer join orders
            on c_custkey = o_custkey and o_totalprice > c_acctbal * 20
        group by c_custkey order by c_custkey""",
    # ungrouped aggregation
    "global_agg_empty_input": """
        select count(*) as n, count(l_tax) as nt, sum(l_quantity) as q,
               min(l_shipdate) as lo, max(l_extendedprice) as hi,
               avg(l_discount) as d
        from lineitem where l_quantity < 0""",
    "global_agg": """
        select count(*) as n, sum(l_quantity) as q, min(l_shipdate) as lo,
               max(l_extendedprice) as hi, avg(l_discount) as d,
               sum(l_extendedprice * l_discount) as rev
        from lineitem where l_shipdate >= date '1995-01-01'""",
}


@pytest.fixture(scope="module")
def torch_engine():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(sf=0.01))
    return e


def _decoded(res):
    return [[x for x in np.asarray(c).tolist()] for c in res.columns]


@pytest.mark.parametrize("case", sorted(CASES))
def test_join_kind_equals_reference(engine, torch_engine, case):
    ref = engine.execute_sql(CASES[case], engine.create_session("tpch"))
    got = torch_engine.execute_sql(CASES[case], torch_engine.create_session("tpch"))
    assert tuple(ref.names) == tuple(got.names)
    assert len(ref) == len(got)
    for t, a, b in zip(ref.types, _decoded(ref), _decoded(got)):
        assert [x is None for x in a] == [x is None for x in b]
        if t.is_floating:
            np.testing.assert_allclose([x for x in b if x is not None],
                                       [x for x in a if x is not None], rtol=1e-9)
        else:
            assert [str(x) for x in a] == [str(x) for x in b]


def test_null_build_key_separates_not_in_from_not_exists(torch_engine):
    s = torch_engine.create_session("tpch")
    assert len(torch_engine.execute_sql(CASES["anti_not_in_null_build_key"], s)) == 0
    assert len(torch_engine.execute_sql(CASES["anti_not_exists_null_build_key"], s)) == 21
    assert len(torch_engine.execute_sql(CASES["anti_not_in_empty_build"], s)) == 25


def test_global_agg_over_empty_input_is_one_row_of_nulls(torch_engine):
    got = torch_engine.execute_sql(CASES["global_agg_empty_input"],
                                   torch_engine.create_session("tpch"))
    assert got.rows() == [(0, 0, None, None, None, None)]
