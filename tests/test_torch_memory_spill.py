"""The port's memory accounting and Grace-partitioned fallbacks
(``trino_tpu_torch/memory.py``, the Grace and streaming aggregation and the
partitioned join of ``exec/local_executor.py``) against the JAX package on
the CPU.

Restates tests/test_memory_spill.py at its SF0.01 with 4096-row splits: the
pool's reserve and free and the memory contexts step for step against the
reference's; the tiny-pool inner, left and semi joins (and an inner join
on two keys, whose tables are hashed) against the reference's
unconstrained results (the reference's own tiny-pool runs
compile once per partition: about 75 s for the inner join on a CPU);
the spilling group-by against the reference's tiny-pool run, with its
partitions and rows per partition.  ``query_max_memory`` is restated in
tests/test_torch_control_plane.py.
Adds the streaming aggregation over a clustered scan, which the port
now runs: with the direct table turned off in both packages, its result
under the default pool and, through its overflow, under a tiny pool is the
reference's, and the tiny-pool run Grace-partitions as the reference's
does.

Left out: the Parquet join, restated in tests/test_torch_files.py with
the Parquet connector, and the ``slow`` test of 51,000,000 groups at SF34,
which runs on the card at full size (``chip_smoke.py`` phase 16c).
"""

import os

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.exec import spill as jspill
from trino_tpu.exec.local_executor import LocalExecutor as JaxExecutor
from trino_tpu.memory import AggregatedMemoryContext as JaxContext
from trino_tpu.memory import MemoryPool as JaxPool
from trino_tpu.memory import MemoryPoolExhaustedError as JaxExhausted
from trino_tpu.ops import hashagg as jhashagg
from trino_tpu.sql.frontend import compile_sql as jax_compile
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import spill as tspill
from trino_tpu_torch.exec.local_executor import LocalExecutor
from trino_tpu_torch.memory import (AggregatedMemoryContext, MemoryPool,
                                    MemoryPoolExhaustedError)
from trino_tpu_torch.ops import hashagg
from trino_tpu_torch.sql.frontend import compile_sql

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 12


@pytest.fixture(scope="module")
def engines():
    je = JaxEngine()
    je.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return je, e


@pytest.fixture(autouse=True)
def _spill_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    yield
    assert not os.listdir(tmp_path), "a spill file outlived its query"


def _run(pkg, engines, sql, pool_bytes=None):
    je, e = engines
    if pkg == "jax":
        plan = jax_compile(sql, je, je.create_session("tpch"))
        pool = None if pool_bytes is None else JaxPool(max_bytes=pool_bytes)
        ex = JaxExecutor(je.catalogs, memory_pool=pool)
    else:
        plan = compile_sql(sql, e, e.create_session("tpch"))
        pool = None if pool_bytes is None else MemoryPool(max_bytes=pool_bytes)
        ex = LocalExecutor(e.catalogs, "cpu", memory_pool=pool)
    return ex.execute(plan).rows(), ex


def _spill_stats(ex):
    return sorted((st.get("op", ""), st["spill_partitions"])
                  for st in ex.stats.values() if st.get("spill_partitions"))


def _pool_script(pool_cls, exhausted):
    pool = pool_cls(max_bytes=1000)
    out = [pool.try_reserve(600, "a"), pool.try_reserve(600, "b")]
    pool.free(600, "a")
    out.append(pool.try_reserve(600, "b"))
    with pytest.raises(exhausted):
        pool.reserve(600, "c")
    info = pool.info()
    out += [info["reserved"], info["by_tag"], pool.free_bytes(), pool.blocked(0.5),
            pool.blocked(0.7)]
    return out


def test_memory_pool_reserve_free():
    got = _pool_script(MemoryPool, MemoryPoolExhaustedError)
    assert got == _pool_script(JaxPool, JaxExhausted)
    assert got[:4] == [True, False, True, 600] and got[4]["b"] == 600


def _context_script(pool_cls, ctx_cls):
    pool = pool_cls(max_bytes=1000)
    root = ctx_cls(pool=pool, tag="query")
    op1 = root.new_child("op1").new_local()
    op2 = root.new_child("op2").new_local()
    op1.set_bytes(300)
    op2.set_bytes(400)
    out = [root.bytes, pool.reserved, op2.try_set_bytes(800), op2.bytes]
    op1.close()
    out += [root.bytes, pool.reserved, pool.info()["by_tag"]]
    return out


def test_memory_contexts_hierarchy():
    got = _context_script(MemoryPool, AggregatedMemoryContext)
    assert got == _context_script(JaxPool, JaxContext)
    assert got[:4] == [700, 700, False, 400] and got[4:6] == [400, 400]


JOIN_CASES = {
    "inner": ("""select o_orderpriority, count(*) c from orders, lineitem
                 where o_orderkey = l_orderkey and l_quantity < 2500
                 group by o_orderpriority order by o_orderpriority""", 200_000),
    "left": ("""select count(*), count(o_orderkey) from orders
                left join customer on o_custkey = c_custkey and c_acctbal > 5000""",
             150_000),
    "semi": ("""select count(*) from lineitem
                where l_orderkey in (select o_orderkey from orders
                                     where o_totalprice > 20000000)""", 150_000),
    # two keys: the partitions' tables are hashed, not direct
    "two_keys": ("""select count(*) c, sum(ps_supplycost) s from lineitem, partsupp
                    where l_partkey = ps_partkey and l_suppkey = ps_suppkey""", 150_000),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_tiny_pool_join_matches_unlimited(engines, case):
    """A join whose build does not fit the pool partitions and gives the
    reference's unconstrained result; a left join keeps each unmatched
    probe row once across partitions."""
    sql, pool_bytes = JOIN_CASES[case]
    full, _ = _run("jax", engines, sql)
    small, ex = _run("torch", engines, sql, pool_bytes)
    assert small == full
    if case in ("inner", "two_keys"):  # the others' filtered builds fit the pool
        assert any(op == "Join" for op, _ in _spill_stats(ex)), ex.stats
    assert ex.memory_pool.reserved == 0


def _recorded(pkg, engines, sql, pool_bytes, monkeypatch):
    spills = []
    cls = jspill.SpilledPartitions if pkg == "jax" else tspill.SpilledPartitions
    orig = cls.close

    def close(self):
        if not self._closed:
            spills.append((self.parts, list(self.rows)))
        orig(self)

    monkeypatch.setattr(cls, "close", close)
    rows, ex = _run(pkg, engines, sql, pool_bytes)
    return rows, _spill_stats(ex), spills


def test_group_by_spills_to_partitioned(engines, monkeypatch):
    """Many groups under a pool too small for the table: Grace passes give
    the unconstrained result, with the reference's partitions and rows."""
    sql = """select l_orderkey, count(*) c from lineitem
             group by l_orderkey order by c desc, l_orderkey limit 5"""
    got = _recorded("torch", engines, sql, 100_000, monkeypatch)
    ref = _recorded("jax", engines, sql, 100_000, monkeypatch)
    assert got[0] == ref[0] == _run("torch", engines, sql)[0]
    assert got[1] == [("Aggregate", 4)]
    assert got[2] == ref[2] and got[2]


STREAM_SQL = """select l_orderkey, count(*) c, sum(l_quantity) q, min(l_shipdate) d
                from lineitem group by l_orderkey
                order by c desc, q desc, l_orderkey limit 7"""


@pytest.mark.parametrize("pool_bytes", [None, 100_000])
def test_streaming_aggregation_matches_the_reference(engines, monkeypatch, pool_bytes):
    """lineitem is clustered by l_orderkey: with no direct table (turned off
    in both packages, as past 2^24 keys), the group-by streams; a pool too
    small for its merge table Grace-partitions as the reference's does."""
    monkeypatch.setattr(hashagg, "direct_config", lambda *a, **k: None)
    monkeypatch.setattr(jhashagg, "direct_config", lambda *a, **k: None)
    got = _recorded("torch", engines, STREAM_SQL, pool_bytes, monkeypatch)
    ref = _recorded("jax", engines, STREAM_SQL, pool_bytes, monkeypatch)
    assert got[0] == ref[0]
    assert got[2] == ref[2]
    assert bool(got[1]) == (pool_bytes is not None)
