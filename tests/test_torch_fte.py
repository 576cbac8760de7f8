"""The port's fault-tolerant execution (``trino_tpu_torch/exec/fte.py``)
against the JAX package on the CPU.

Restates the 18 tests of tests/test_fte.py and
tests/test_chaos.py::test_fte_dropped_commit_is_retried at SF0.01 in
2^11-row splits (their scale):

- **frames**: the codec round trips, detects corruption, encrypts and
  authenticates; and frames go both ways: the port reads a frame and a
  fragment-output envelope the reference wrote, and the reference reads
  the port's;
- **results**: every fault-tolerant run equals the reference's local
  ``Engine`` result for the same SQL (integers, decimals, dates and strings
  exactly, DOUBLE within rtol 1e-9: ``chip_smoke.same_result``);
- **injections**: under the same ``FailureInjector`` injections the port's
  executor retries as the reference's does: equal rows and equal
  ``task_attempts``, task for task (the reference's run is made in the same
  test); a post-commit failure doubles no sum; an exhausted budget raises
  the same message; a dropped commit is recomputed;
- **real failures**: an ``OSError`` from the connector retries under FTE and
  fails the plain executor; a deterministic error does not retry;
- **the spooled join output** is read, not run again: a join-fed aggregate
  generates each split as often as one local execution does;
- **adaptive side swap**, through the engine's ``fault_tolerant=True``.

The port's task bodies take the executor they run on; the reference's
module-level read (``_host``) is the executor's counted ``_host`` here.
"""

import os
import sys

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.exec import fte as jfte
from trino_tpu.sql.frontend import compile_sql as jax_compile
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import fte as F
from trino_tpu_torch.exec.fte import (FailureInjector, FaultTolerantExecutor, SpoolingExchange,
                                      deserialize_page, serialize_page)
from trino_tpu_torch.exec.local_executor import LocalExecutor
from trino_tpu_torch.execution import faults
from trino_tpu_torch.sql.frontend import compile_sql

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 11

Q1 = """select l_returnflag, l_linestatus, sum(l_quantity) qty, count(*) c,
               avg(l_discount) d
        from lineitem where l_shipdate <= date '1998-09-02'
        group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""

QJOIN = """select o_orderpriority, count(*) c
           from lineitem, orders
           where l_orderkey = o_orderkey and o_totalprice > 100000
           group by o_orderpriority order by o_orderpriority"""

QWINDOW = """select o_custkey, o_orderkey,
                    row_number() over (partition by o_custkey
                                       order by o_orderkey) rn
             from orders where o_custkey < 100
             order by o_custkey, o_orderkey limit 50"""

QPRIO = """select o_orderpriority, count(*) from orders
           group by o_orderpriority order by 1"""

QSWAP = """select a.k, a.ca, b.cb from
             (select s_suppkey k, count(*) ca from supplier
              where s_suppkey <= 3 group by s_suppkey) a
             join (select o_custkey k, count(*) cb from orders
                   group by o_custkey) b
             on a.k = b.k
            order by a.k"""

QDROP = ("select l_returnflag, sum(l_quantity) q from lineitem "
         "group by l_returnflag order by l_returnflag")


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxEngine()
    e.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    return e, e.create_session("tpch")


@pytest.fixture(scope="module")
def ref(jax_engine):
    """The reference's local result of each statement, computed once."""
    e, s = jax_engine
    cache = {}

    def get(sql):
        if sql not in cache:
            cache[sql] = e.execute_sql(sql, s)
        return cache[sql]

    return get


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e, e.create_session("tpch")


def _executor(port, tmp_path, **kw):
    e, _ = port
    inj = FailureInjector()
    return FaultTolerantExecutor(e.catalogs, str(tmp_path / "spool"), injector=inj,
                                 device="cpu", **kw), inj


def _plan(port, sql):
    e, s = port
    return compile_sql(sql, e, s)


def _jax_run(jax_engine, tmp_path, sql, inject, **kw):
    """The reference's FTE run under ``inject``: (rows, task_attempts)."""
    e, s = jax_engine
    inj = jfte.FailureInjector()
    for tid, point, times in inject:
        inj.inject(tid, point, times=times)
    ex = jfte.FaultTolerantExecutor(e.catalogs, str(tmp_path / "jspool"), injector=inj, **kw)
    return ex.execute(jax_compile(sql, e, s)).rows(), dict(ex.task_attempts)


# -- frames ----------------------------------------------------------------------
def test_page_serde_roundtrip():
    cols = [np.arange(10, dtype=np.int64), np.linspace(0, 1, 10)]
    nulls = [None, np.arange(10) % 3 == 0]
    data = serialize_page(cols, nulls)
    rc, rn = deserialize_page(data)
    np.testing.assert_array_equal(rc[0], cols[0])
    np.testing.assert_array_equal(rc[1], cols[1])
    assert rn[0] is None
    np.testing.assert_array_equal(rn[1], nulls[1])
    bad = data[:20] + bytes([data[20] ^ 0xFF]) + data[21:]
    with pytest.raises(ValueError):
        deserialize_page(bad)


def test_frames_cross_both_packages():
    """The port reads the reference's frame and fragment envelope, and the
    reference reads the port's: the spool's bytes are one format."""
    cols = [np.arange(50, dtype=np.int64), np.linspace(0, 1, 50),
            np.arange(50, dtype=np.int32) % 7]
    nulls = [None, np.arange(50) % 4 == 0, None]
    dicts = (None, None, None)
    for write, read in ((jfte.serialize_page, F.deserialize_page),
                        (F.serialize_page, jfte.deserialize_page)):
        rc, rn = read(write(cols, nulls))
        for a, b in zip(rc, cols):
            np.testing.assert_array_equal(a, b)
        assert rn[0] is None and rn[2] is None
        np.testing.assert_array_equal(rn[1], nulls[1])
    for write, read in ((jfte.serialize_fragment_output, F.deserialize_fragment_output),
                        (F.serialize_fragment_output, jfte.deserialize_fragment_output)):
        rc, rn, rd = read(write(cols, nulls, dicts))
        np.testing.assert_array_equal(rc[0], cols[0])
        assert rd == dicts


def test_page_serde_codecs(monkeypatch):
    cols = [np.arange(1000, dtype=np.int64), np.linspace(0, 1, 1000)]
    nulls = [None, np.arange(1000) % 3 == 0]
    codecs = ["none", "zlib"]
    try:
        import zstandard  # noqa: F401

        codecs.append("zstd")
    except ImportError:
        pass
    for codec in codecs:
        monkeypatch.setattr(F, "PAGE_CODEC", codec)
        rc, rn = deserialize_page(serialize_page(cols, nulls))
        np.testing.assert_array_equal(rc[0], cols[0])
        np.testing.assert_array_equal(rn[1], nulls[1])


def test_page_serde_encryption(monkeypatch):
    pytest.importorskip("cryptography")
    import zlib

    cols = [np.arange(100, dtype=np.int64)]
    monkeypatch.setenv("TRINO_TPU_EXCHANGE_KEY", "00" * 16)
    data = serialize_page(cols, [None])
    assert data[4] & 0x80
    rc, _ = deserialize_page(data)
    np.testing.assert_array_equal(rc[0], cols[0])
    body = bytearray(data)
    body[30] ^= 0xFF
    body[5:9] = zlib.crc32(bytes(body[17:])).to_bytes(4, "little")
    with pytest.raises(Exception):
        deserialize_page(bytes(body))
    # the reference reads the port's encrypted frame with the same key
    np.testing.assert_array_equal(jfte.deserialize_page(data)[0][0], cols[0])
    monkeypatch.delenv("TRINO_TPU_EXCHANGE_KEY")
    with pytest.raises(ValueError, match="encrypted"):
        deserialize_page(data)


def test_spool_first_commit_wins(tmp_path):
    ex = SpoolingExchange(str(tmp_path / "x"))
    assert ex.commit(0, 0, b"attempt0")
    assert not ex.commit(0, 1, b"attempt1")
    assert ex.read(0) == b"attempt0"


# -- fault-tolerant runs ---------------------------------------------------------
def test_fte_no_failures_matches_local(port, ref, tmp_path):
    ex, _ = _executor(port, tmp_path)
    chip_smoke.same_result(ex.execute(_plan(port, Q1)), ref(Q1), "q1 fte")
    assert ex.last_spool_bytes > 0
    assert not os.listdir(tmp_path / "spool"), "the query's spool outlived it"


# (statement, injections, max_attempts): each runs in both packages
INJECTED = {
    "recovers_from_task_failures": (Q1, [(0, "TASK_FAILURE", 2),
                                         (1, "TASK_GET_RESULTS_FAILURE", 1)], 4),
    "post_commit_failure_does_not_duplicate": (Q1, [(2, "POST_COMMIT_FAILURE", 1)], 4),
    "mid_join_task_kill": (QJOIN, [("frag0", "TASK_FAILURE", 2)], 4),
    "join_post_commit_failure_no_duplicates": (QJOIN, [("frag0", "POST_COMMIT_FAILURE", 1),
                                                       ("frag1", "TASK_GET_RESULTS_FAILURE",
                                                        1)], 4),
    "window_fragment_retries": (QWINDOW, [("frag0", "TASK_FAILURE", 1)], 4),
}


@pytest.mark.parametrize("case", sorted(INJECTED))
def test_fte_injections_match_reference(case, port, ref, jax_engine, tmp_path):
    """tests/test_fte.py's recovery tests: the same injections in both
    packages give the reference's local rows and the reference's attempts."""
    sql, inject, attempts = INJECTED[case]
    ex, inj = _executor(port, tmp_path, max_attempts=attempts)
    for tid, point, times in inject:
        inj.inject(tid, point, times=times)
    got = ex.execute(_plan(port, sql))
    chip_smoke.same_result(got, ref(sql), case)
    _, jattempts = _jax_run(jax_engine, tmp_path, sql, inject, max_attempts=attempts)
    assert ex.task_attempts == jattempts
    for tid, point, times in inject:
        if point != "POST_COMMIT_FAILURE":
            assert ex.task_attempts[tid] == times + 1


@pytest.mark.parametrize("sql,tid", [(Q1, 0), (QJOIN, "frag0")])
def test_fte_exhausted_retries_fail_query(sql, tid, port, tmp_path):
    """test_fte_exhausted_retries_fail_query and
    test_fte_join_exhausted_retries."""
    ex, inj = _executor(port, tmp_path, max_attempts=2)
    inj.inject(tid, "TASK_FAILURE", times=5)
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        ex.execute(_plan(port, sql))


@pytest.mark.parametrize("sql", [QPRIO, QJOIN])
def test_fte_via_engine(sql, port, ref):
    """test_fte_join_query_via_engine and test_fte_engine_join_fault_tolerant:
    the engine's ``fault_tolerant=True`` route, its retries on the
    statement's counters."""
    e, s = port
    chip_smoke.same_result(e.execute_sql(sql, s, fault_tolerant=True), ref(sql), "engine fte")
    assert e.last_query_counters["task_retries"] == 0
    assert e.last_query_counters["host_reads"] > 0


class _FlakyGenerate:
    """``conn.generate`` raising ``exc()`` for its first ``fail_times`` calls."""

    def __init__(self, conn, exc, fail_times):
        self._orig = conn.generate
        self._exc = exc
        self.left = fail_times

    def __call__(self, *a, **k):
        if self.left > 0:
            self.left -= 1
            raise self._exc()
        return self._orig(*a, **k)


def test_fte_retries_real_connector_failures(port, ref, tmp_path):
    ex, _ = _executor(port, tmp_path)
    conn = ex.catalogs["tpch"]
    conn.generate = _FlakyGenerate(conn, lambda: OSError("simulated io loss"), 2)
    try:
        chip_smoke.same_result(ex.execute(_plan(port, Q1)), ref(Q1), "flaky q1")
    finally:
        del conn.generate
    assert max(ex.task_attempts.values()) == 3
    conn.generate = _FlakyGenerate(conn, lambda: OSError("simulated io loss"), 2)
    try:
        with pytest.raises(OSError):
            LocalExecutor(ex.catalogs, "cpu").execute(_plan(port, Q1))
    finally:
        del conn.generate


def test_fte_deterministic_errors_do_not_retry(port, tmp_path):
    ex, _ = _executor(port, tmp_path)
    conn = ex.catalogs["tpch"]
    conn.generate = _FlakyGenerate(conn, lambda: NotImplementedError("unsupported encoding"),
                                   99)
    try:
        with pytest.raises(NotImplementedError):
            ex.execute(_plan(port, Q1))
    finally:
        del conn.generate
    assert max(ex.task_attempts.values()) == 1


def test_fte_consumes_spooled_join_output(port, ref, tmp_path):
    ex, _ = _executor(port, tmp_path)
    conn = ex.catalogs["tpch"]
    calls = []
    orig = conn.generate
    conn.generate = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    try:
        chip_smoke.same_result(ex.execute(_plan(port, QJOIN)), ref(QJOIN), "qjoin")
        fte_calls = len(calls)
        calls.clear()
        LocalExecutor(ex.catalogs, "cpu").execute(_plan(port, QJOIN))
        local_calls = len(calls)
    finally:
        del conn.generate
    assert fte_calls == local_calls > 0


def test_adaptive_join_side_swap(port, ref):
    e, s = port
    chip_smoke.same_result(e.execute_sql(QSWAP, s, fault_tolerant=True), ref(QSWAP), "swap")
    assert e._fte_executor.adaptive_swaps >= 1


def test_fte_dropped_commit_is_retried(port, ref, tmp_path):
    """tests/test_chaos.py::test_fte_dropped_commit_is_retried: a lost commit
    (``exchange_write`` drop) is noticed, recomputed and committed again."""
    ex, _ = _executor(port, tmp_path)
    with faults.injected("point=exchange_write,action=drop,nth=1") as plan_f:
        got = ex.execute(_plan(port, QDROP))
    assert plan_f.total_fires() == 1, plan_f.stats()
    chip_smoke.same_result(got, ref(QDROP), "dropped commit")
    assert max(ex.task_attempts.values()) >= 2, ex.task_attempts


def test_fte_memory_failure_bisects_task(port, ref, tmp_path, monkeypatch):
    """tests/test_cluster.py::test_fte_memory_failure_bisects_task: a memory
    failure in a partial task bisects its split set and merges the halves;
    a ``torch.OutOfMemoryError`` is a memory failure too."""
    import torch

    ex, _ = _executor(port, tmp_path)
    calls = []
    orig = F._partial_once

    def flaky(local, node, key_types, acc_specs, splits, tick=None):
        calls.append(len(splits))
        if len(splits) > 1:
            raise torch.OutOfMemoryError("synthetic out of memory")
        return orig(local, node, key_types, acc_specs, splits, tick)

    monkeypatch.setattr(F, "_partial_once", flaky)
    chip_smoke.same_result(ex.execute(_plan(port, Q1)), ref(Q1), "bisected q1")
    assert any(c > 1 for c in calls) and any(c == 1 for c in calls)
    assert F._is_memory_failure(MemoryError()) and not F._is_memory_failure(
        __import__("trino_tpu_torch.memory", fromlist=["x"]).QueryKilledError())


def test_fte_small_pool_bisects_by_reservation(port, ref, tmp_path, monkeypatch):
    """The pool itself makes the failure: a partial task reserves its group
    table, eight splits' groups overflow the first table, the pool refuses
    the grown one, and the halves fit (the first table starts at 1024 slots
    here, so SF0.01's groups overflow it)."""
    from trino_tpu_torch.memory import MemoryPool

    sql = "select l_orderkey, sum(l_quantity) q from lineitem group by l_orderkey " \
          "order by l_orderkey"
    plan = _plan(port, sql)
    agg = plan
    while not hasattr(agg, "aggs"):
        agg = agg.child
    assert not agg.capacity
    monkeypatch.setattr(F, "DEFAULT_GROUP_CAPACITY", 1024)
    key_types = tuple(agg.child.schema.fields[i].type for i in agg.keys)
    acc_specs = [(dt, init) for spec in agg.aggs for _k, dt, init in F._accumulators_for(spec)]
    pool = MemoryPool(max_bytes=3 * F._state_bytes(1024, key_types, acc_specs))
    ex, _ = _executor(port, tmp_path, splits_per_task=8, memory_pool=pool)
    calls = []
    orig = F._partial_once

    def spy(local, node, key_types, acc_specs, splits, tick=None):
        calls.append(len(splits))
        return orig(local, node, key_types, acc_specs, splits, tick)

    monkeypatch.setattr(F, "_partial_once", spy)
    chip_smoke.same_result(ex.execute(plan), ref(sql), "small-pool bisect")
    assert max(calls) == 8 and min(calls) < 8, calls
    assert pool.reserved == 0
