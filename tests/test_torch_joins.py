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

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


PROBE_KEYS = {
    # name: key types of the probe (packed exactly: <= 62 bits, or one 64-bit key)
    "one_bigint": ("bigint",),
    "integer_and_smallint": ("integer", "smallint"),
}


@pytest.mark.parametrize("keys", sorted(PROBE_KEYS))
def test_hash_join_probes_hand_packed_keys_to_the_kernel(monkeypatch, keys):
    """``hashjoin.probe`` and ``probe_slots`` hash nothing themselves: they
    pass the packed keys (and, for the multi-match layout, no payload) to
    ``hash_probe``, which walks the chains; both equal trino_tpu's probes bit
    for bit over the same table."""
    import jax.numpy as jnp
    import torch

    from trino_tpu import types as JT
    from trino_tpu.ops import hashagg as jagg, hashing as jhashing, hashjoin as jjoin
    from trino_tpu_torch import types as TT
    from trino_tpu_torch.ops import cuda_kernels as ck, hashjoin as tjoin

    rng = np.random.default_rng(len(keys))
    names = PROBE_KEYS[keys]
    jtypes = tuple({"bigint": JT.BIGINT, "integer": JT.INTEGER, "smallint": JT.SMALLINT}[t]
                   for t in names)
    ttypes = tuple({"bigint": TT.BIGINT, "integer": TT.INTEGER, "smallint": TT.SMALLINT}[t]
                   for t in names)
    dtypes = {"bigint": np.int64, "integer": np.int32, "smallint": np.int16}
    nb, n, C = 600, 3000, 2048
    build = [rng.integers(-3000, 3000, size=nb).astype(dtypes[t]) for t in names]
    probe = [np.concatenate([b, b + 1])[rng.integers(0, 2 * nb, size=n)] for b in build]
    valid = rng.random(n) < 0.9
    jpacked, _ = jhashing.pack_keys(tuple(jnp.asarray(b) for b in build), jtypes)
    table0 = jnp.full((C + 1,), jhashing.EMPTY_KEY, jnp.int64)
    table, slot, placed = jagg._probe_insert(table0, jpacked, jnp.ones(nb, bool))
    rows = jnp.full((C + 1,), 2**31 - 1, jnp.int32).at[
        jnp.where(placed, slot, C)].min(jnp.arange(nb, dtype=jnp.int32)).at[C].set(0)
    jt = jjoin.JoinTable(table, rows, (), (), jnp.int32(nb), jnp.int32(0), jnp.bool_(False))
    tt = tjoin.JoinTable(torch.as_tensor(np.array(table)), torch.as_tensor(np.array(rows)),
                         (), (), torch.tensor(nb, dtype=torch.int32),
                         torch.tensor(0, dtype=torch.int32), torch.tensor(False))
    calls = []
    real = ck.hash_probe

    def recording(table, vals, packed, valid, max_probes=ck.MAX_PROBES):
        calls.append((vals, packed))
        return real(table, vals, packed, valid, max_probes)

    def boom(*args, **kwargs):
        raise AssertionError("the probe path hashed its keys outside the kernel")

    monkeypatch.setattr(ck, "hash_probe", recording)
    # the plain version on the CPU hashes through its own module's names
    for name in ("splitmix64", "probe_step"):
        monkeypatch.setattr(tjoin, name, boom, raising=False)
    tkeys = tuple(torch.as_tensor(p) for p in probe)
    jkeys = tuple(jnp.asarray(p) for p in probe)
    tpacked, _ = tjoin.pack_keys(tkeys, ttypes)
    got = tjoin.probe(tt, tkeys, ttypes, torch.as_tensor(valid))
    want = jjoin.probe(jt, jkeys, jtypes, jnp.asarray(valid))
    got_s = tjoin.probe_slots(tt.table, tkeys, ttypes, torch.as_tensor(valid))
    want_s = jjoin.probe_slots(jt.table, jkeys, jtypes, jnp.asarray(valid))
    assert len(calls) == 2 and calls[0][0] is not None and calls[1][0] is None
    assert all(torch.equal(packed, tpacked) for _, packed in calls)
    assert bool(np.asarray(want[1]).any()) and not bool(np.asarray(want[1]).all())
    for a, b in ((got, want), (got_s, want_s)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
