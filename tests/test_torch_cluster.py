"""The port's multi-process cluster (``trino_tpu_torch/server/cluster.py``)
on the CPU, against the JAX package.

Coordinators and workers run in this process (``device="cpu"``, ports chosen
by the OS, heartbeats every 0.2 s), and one real worker process is started
with ``python -m trino_tpu_torch.server.cluster --device cpu``, which covers
``main``.  Every cluster result is held against the reference's local
``Engine`` result for the same SQL at SF0.01 in 2^11-row splits (integers,
decimals, dates and strings exactly, DOUBLE within rtol 1e-9:
``chip_smoke.same_result``).  Restated:

- tests/test_cluster.py's fast tests: the HMAC on the task endpoints, the
  loopback refusal, the in-process round trip, the merged worker counters,
  the stalled worker's degradation, speculation of a straggler, graceful
  shutdown and admission backpressure (its ninth,
  test_fte_memory_failure_bisects_task, is in tests/test_torch_fte.py);
- tests/test_cluster_memory.py (both), the four fast tests of
  tests/test_memory_killer.py (each held against the reference's pool and
  policies), the seven fast tests of tests/test_streaming_exchange.py and,
  in process, its fan-out and stream-replay tests;
- tests/test_chaos.py's backoff and reannounce tests,
  test_plan_history.py::test_cluster_harvest_merges_with_local_records,
  test_flight_recorder.py::test_in_process_cluster_one_stitched_trace,
  test_result_cache.py::test_cluster_coordinator_serves_from_result_cache,
  test_spill_tiers.py's two cluster rungs and its counter round trip,
  test_page_cache.py::test_worker_owns_its_pool,
  test_compile_observatory.py::test_coordinator_does_not_degrade_compiling_worker,
  test_decimal128.py::test_wide_sum_fault_tolerant_and_distributed.

Deviations, as the port has them: the port records no span per kernel
launch, so the harvested worker spans are the task spans and their exchange
spans (the reference's also hold one "dispatch" span per jitted step); the
straggler of the speculation test is held on an event until the query has
finished, not by a sleep the query must beat on the wall clock.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.execution import memory_killer as jkiller
from trino_tpu.memory import MemoryPool as JaxPool
from trino_tpu.memory import QueryKilledError as JaxKilled
from trino_tpu.server import cluster as jcluster
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec.fte import SpoolingExchange, deserialize_fragment_output
from trino_tpu_torch.execution import memory_killer as killer
from trino_tpu_torch.execution.tracing import WALL_BUCKETS, QueryCounters, spans_to_otlp
from trino_tpu_torch.memory import MemoryPool, QueryKilledError
from trino_tpu_torch.server import cluster as C
from trino_tpu_torch.server.cluster import (ClusterCoordinator, WorkerServer, _backoff_s, _http,
                                            stream_task_pages)
from trino_tpu_torch.sql.frontend import compile_sql

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 11
CATALOGS = {"tpch": {"connector": "tpch", "sf": SF, "split_rows": SPLIT_ROWS}}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Q = """select l_returnflag, l_linestatus, sum(l_quantity) qty, count(*) c
       from lineitem where l_shipdate <= date '1998-09-02'
       group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""

Q9 = """select nation, o_year, sum(amount) as sum_profit from (
          select n_name as nation, extract(year from o_orderdate) as o_year,
            l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
          from part, supplier, lineitem, partsupp, orders, nation
          where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
            and ps_partkey = l_partkey and p_partkey = l_partkey
            and o_orderkey = l_orderkey and s_nationkey = n_nationkey
            and p_name like '%green%') as profit
        group by nation, o_year order by nation, o_year desc"""

FANOUT_SQL = """select o.o_orderkey, b.c_name from orders o
                join (select c_custkey, c_name, c_acctbal from customer
                      order by c_acctbal desc, c_custkey limit 50) b
                  on o.o_custkey = b.c_custkey
                order by o.o_orderkey limit 20"""

QFLIGHT = """select l_returnflag, sum(l_quantity) q, count(*) c
             from lineitem where l_shipdate <= date '1998-09-02'
             group by l_returnflag order by l_returnflag"""


@pytest.fixture(scope="module")
def ref():
    """The reference's local result of each statement, computed once."""
    e = JaxEngine()
    e.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    s = e.create_session("tpch")
    cache = {}

    def get(sql):
        if sql not in cache:
            cache[sql] = e.execute_sql(sql, s)
        return cache[sql]

    return get


def _engine():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e


class _Cluster:
    """A coordinator and ``n`` in-process workers; ``stop`` in finally."""

    def __init__(self, tmp_path, n=1, engine=None, coord_kw=None, worker_kw=None):
        self.engine = engine or _engine()
        self.spool = str(tmp_path / "spool")
        self.coord = ClusterCoordinator(self.engine, self.spool, heartbeat_interval=0.2,
                                        **(coord_kw or {}))
        self.url = self.coord.start()
        self.workers = []
        try:
            for i in range(n):
                w = WorkerServer(CATALOGS, self.spool, coordinator_url=self.url,
                                 node_id=f"w{i}", device="cpu", **(worker_kw or {}))
                self.workers.append(w)
                w.start()
            if n:
                self.coord.wait_for_workers(n, timeout=30)
        except BaseException:
            self.stop()
            raise

    def stop(self):
        for w in self.workers:
            w.stop()
        self.coord.stop()


# -- tests/test_cluster.py ----------------------------------------------------------
def test_task_endpoints_require_hmac(tmp_path, ref):
    c = _Cluster(tmp_path, 1, coord_kw={"secret": "s3cret"}, worker_kw={"secret": "s3cret"})
    try:
        blob = pickle.dumps({"fragment_id": "x", "plan": None})
        for headers in ({}, {"X-Trino-Internal-Signature": "0" * 64}):
            req = urllib.request.Request(f"{c.workers[0].url}/v1/fragment", data=blob,
                                         headers=headers)
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=5)
            assert exc.value.code == 403
        chip_smoke.same_result(c.coord.execute_sql(Q), ref(Q), "signed cluster q")
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
    finally:
        c.stop()


def test_worker_refuses_unauthenticated_nonloopback(tmp_path, monkeypatch):
    monkeypatch.delenv("TRINO_TPU_CLUSTER_SECRET", raising=False)
    with pytest.raises(ValueError, match="loopback"):
        WorkerServer(CATALOGS, str(tmp_path / "spool"), host="0.0.0.0", device="cpu")


def test_worker_takes_the_card_unless_told(tmp_path):
    """``device=None`` is the card: without one the worker raises, it never
    drops to the CPU on its own."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerServer(CATALOGS, str(tmp_path / "spool"))


def test_in_process_worker_roundtrip(tmp_path, ref):
    c = _Cluster(tmp_path, 1)
    try:
        chip_smoke.same_result(c.coord.execute_sql(Q), ref(Q), "cluster q")
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
        assert c.coord.shipped_fragments > 0
        assert not os.path.exists(os.path.join(c.spool, "cluster_exchange_1")) or \
            not os.listdir(os.path.join(c.spool, "cluster_exchange_1"))
    finally:
        c.stop()


def test_distributed_query_merges_worker_counters(tmp_path, ref):
    c = _Cluster(tmp_path, 2)
    e, coord = c.engine, c.coord
    try:
        before = e.counters_total.device_dispatches
        chip_smoke.same_result(coord.execute_sql(Q9), ref(Q9), "cluster q9")
        assert coord.local_fallbacks == 0, coord.last_fallback_error
        merged, workers = coord.last_query_counters, coord._qc_workers
        assert workers.device_dispatches > 0 and workers.host_bytes_pulled > 0
        assert merged.device_dispatches >= workers.device_dispatches
        assert e.counters_total.device_dispatches - before == merged.device_dispatches
        assert any(k.startswith("fte.") or "/" in k for k in merged.sites), merged.sites
        assert sum(v["dispatches"] for v in merged.sites.values()) == merged.device_dispatches
        names = {s["name"] for s in coord.last_query_worker_spans}
        assert "task" in names, names
        # the wire shape carries per-kernel launches: a worker's reach the
        # coordinator's counters
        fake = QueryCounters(launches={"hash_probe": 3})
        again = QueryCounters.from_dict(fake.as_dict())
        assert again.launches == {"hash_probe": 3} and again.device_dispatches == 3
    finally:
        c.stop()


def test_stalled_worker_marked_degraded_and_unscheduled(tmp_path, ref):
    c = _Cluster(tmp_path, 2, worker_kw={"stall_s": 30.0})
    coord, (wa, wb) = c.coord, c.workers
    try:
        tok = wa.inflight.enter("dispatch", site="probe.step")
        wa.inflight._entries[tok].start_monotonic -= 3600.0
        deadline = time.time() + 30
        while time.time() < deadline and not coord.workers["w0"].degraded:
            time.sleep(0.05)
        assert coord.workers["w0"].degraded and coord.workers["w0"].alive
        assert coord.workers["w0"].health == "stalled"
        assert {w.node_id for w in coord.live_workers()} == {"w1"}
        chip_smoke.same_result(coord.execute_sql(Q), ref(Q), "degraded cluster")
        assert coord.local_fallbacks == 0, coord.last_fallback_error
        assert not wa.tasks and wb.tasks
        wa.inflight.exit(tok)
        deadline = time.time() + 30
        while time.time() < deadline and coord.workers["w0"].degraded:
            time.sleep(0.05)
        assert {w.node_id for w in coord.live_workers()} == {"w0", "w1"}
    finally:
        c.stop()


def test_speculative_execution_of_stragglers(tmp_path, ref):
    """A straggler's task runs again on another worker and the first commit
    wins.  The slow worker's tasks wait on an event that is set only after
    the query returned: the query cannot have waited for them."""
    c = _Cluster(tmp_path, 2, coord_kw={"speculative_factor": 2.0, "task_timeout": 60.0})
    coord, (fast, slow) = c.coord, c.workers
    release = threading.Event()
    orig = slow._checkout_executor

    def held(query_key="q", token="", _o=orig):
        release.wait(60)
        return _o(query_key, token)

    slow._checkout_executor = held
    try:
        got = coord.execute_sql(Q)
        finished_first = not release.is_set()
        release.set()
        chip_smoke.same_result(got, ref(Q), "speculated q")
        assert finished_first and coord.speculative_tasks >= 1
        assert coord.local_fallbacks == 0, coord.last_fallback_error
    finally:
        release.set()
        c.stop()


def test_graceful_shutdown_drains_and_leaves(tmp_path, ref):
    c = _Cluster(tmp_path, 2, worker_kw={"announce_interval": 0.1})
    coord, (w1, w2) = c.coord, c.workers
    try:
        chip_smoke.same_result(coord.execute_sql(Q), ref(Q), "before drain")
        w1.shutdown_gracefully()
        try:
            info = json.loads(urllib.request.urlopen(f"{w1.url}/v1/info", timeout=5).read())
            assert info["state"] == "shutting_down"
        except urllib.error.HTTPError:
            raise
        except (OSError, urllib.error.URLError):
            pass  # the idle drain already stopped the server
        deadline = time.time() + 30
        while time.time() < deadline and {w.node_id for w in coord.live_workers()} != {"w1"}:
            time.sleep(0.05)
        assert {w.node_id for w in coord.live_workers()} == {"w1"}
        chip_smoke.same_result(coord.execute_sql(Q), ref(Q), "after drain")
        deadline = time.time() + 30
        while time.time() < deadline and "w0" in coord.workers:
            time.sleep(0.05)
        assert "w0" not in coord.workers
    finally:
        c.stop()


def test_task_admission_backpressure(tmp_path, ref):
    c = _Cluster(tmp_path, 1, coord_kw={"splits_per_task": 1, "max_attempts": 2},
                 worker_kw={"announce_interval": 0.1})
    c.workers[0].max_concurrent_tasks = 1
    try:
        chip_smoke.same_result(c.coord.execute_sql(Q), ref(Q), "backpressured q")
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
    finally:
        c.stop()


def test_subprocess_worker_on_the_cpu(tmp_path, ref):
    """A real worker process, started as a user would with ``--device cpu``;
    without ``--device`` it takes the card and fails without one."""
    import torch

    c = _Cluster(tmp_path, 0)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "trino_tpu_torch.server.cluster", "--coordinator", c.url,
           "--catalogs", json.dumps(CATALOGS), "--spool", c.spool, "--node-id", "proc"]
    p = subprocess.Popen(cmd + ["--device", "cpu"], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    try:
        assert "device cpu" in p.stdout.readline()
        c.coord.wait_for_workers(1, timeout=60)
        chip_smoke.same_result(c.coord.execute_sql(Q9), ref(Q9), "process worker q9")
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
        assert c.coord._qc_workers.host_reads > 0
        if not torch.cuda.is_available():
            bad = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=60)
            assert bad.returncode != 0 and "CUDA" in bad.stderr
    finally:
        p.terminate()
        p.wait(timeout=30)
        c.stop()


# -- tests/test_cluster_memory.py ---------------------------------------------------
def test_worker_reports_pool_and_refuses_when_full(tmp_path):
    e = _engine()
    w = WorkerServer(CATALOGS, str(tmp_path / "spool"), device="cpu")
    url = w.start()
    try:
        info = json.loads(_http(f"{url}/v1/info"))
        assert info["mem_max"] > 0 and info["mem_reserved"] >= 0 and info["device"] == "cpu"
        plan = compile_sql("select count(*) from lineitem", e, e.create_session("tpch"))
        _http(f"{url}/v1/fragment", C._dumps_fragment({"fragment_id": "f1", "plan": plan}))
        fill = int(w.memory_pool.max_bytes * 0.95)
        w.memory_pool.try_reserve(fill, "test-fill")
        req = pickle.dumps({"task_id": "t1", "fragment_id": "f1", "kind": "fragment",
                            "exchange_dir": str(tmp_path / "x")})
        with pytest.raises(urllib.error.HTTPError) as exc:
            _http(f"{url}/v1/task", req)
        assert exc.value.code == 429
        w.memory_pool.free(fill, "test-fill")
        _http(f"{url}/v1/task", req)
        deadline = time.time() + 60
        while time.time() < deadline:
            st = json.loads(_http(f"{url}/v1/task/t1"))
            if st["state"] == "done":
                break
            assert st["state"] != "failed", st
            time.sleep(0.05)
        else:
            raise AssertionError("task did not finish")
        cols, _, _ = deserialize_fragment_output(SpoolingExchange(str(tmp_path / "x")).read("t1"))
        want = e.execute_sql("select count(*) from lineitem", e.create_session("tpch"))
        assert int(cols[0][0]) == int(want.rows()[0][0])
    finally:
        w.stop()


def test_coordinator_aggregates_cluster_memory(tmp_path):
    c = _Cluster(tmp_path, 1, worker_kw={"announce_interval": 0.2})
    try:
        c.workers[0].memory_pool.try_reserve(12345, "test")
        deadline = time.time() + 10
        while time.time() < deadline:
            mem = c.coord.cluster_memory()
            if {x["node_id"]: x for x in mem["workers"]}["w0"]["mem_reserved"] >= 12345:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"memory never aggregated: {mem}")
        assert mem["total_max"] > 0 and mem["total_reserved"] >= 12345
        assert json.loads(_http(f"{c.url}/v1/memory"))["total_max"] == mem["total_max"]
    finally:
        c.stop()


# -- tests/test_memory_killer.py (both packages) ------------------------------------
def _node(nid, reserved, cap, by_query):
    return {"node_id": nid, "url": f"http://x/{nid}", "mem_reserved": reserved,
            "mem_max": cap, "mem_by_query": by_query}


@pytest.mark.parametrize("mod", [killer, jkiller], ids=["port", "jax"])
def test_killer_policies(mod):
    """The three policy tests: victim on blocked nodes only, none when
    healthy, totals over every node."""
    nodes = [_node("blocked", 95, 100, {"qA": 60, "qB": 35}),
             _node("healthy", 10, 100, {"qC": 1000})]
    assert mod.TotalReservationOnBlockedNodesKiller().pick_victim(nodes) == "qA"
    assert mod.TotalReservationOnBlockedNodesKiller().pick_victim(
        [_node("n1", 10, 100, {"qA": 10})]) is None
    nodes = [_node("blocked", 95, 100, {"qA": 60}), _node("healthy", 50, 100,
                                                           {"qB": 45, "qA": 5})]
    assert mod.TotalReservationKiller().pick_victim(nodes) == "qA"
    assert mod.NoneKiller().pick_victim(nodes) is None


def _poison_script(pool, killed_error):
    out = []
    with pool.query_scope("q1"):
        out.append(pool.try_reserve(100))
        out.append(pool.by_query())
    pool.kill_query("q1")
    with pool.query_scope("q1"):
        with pytest.raises(killed_error):
            pool.try_reserve(10)
        with pytest.raises(killed_error):
            pool.check_killed()
    with pool.query_scope("q2"):
        out.append(pool.try_reserve(10))
        pool.check_killed()
    pool.clear_query("q1")
    out.append("q1" in pool.by_query())
    with pool.query_scope("q1"):
        with pytest.raises(killed_error):
            pool.try_reserve(10)
    for i in range(pool._killed_cap + 1):
        pool.kill_query(f"other{i}")
    with pool.query_scope("q1"):
        out.append(pool.try_reserve(10))
    out.append(pool.by_query())
    return out


def test_pool_kill_poisons_reservations_and_checkpoints():
    got = _poison_script(MemoryPool(max_bytes=1000), QueryKilledError)
    assert got == _poison_script(JaxPool(max_bytes=1000), JaxKilled)
    assert got[:2] == [True, {"q1": 100}]


# -- tests/test_streaming_exchange.py -----------------------------------------------
@pytest.mark.parametrize("mod", [C, jcluster], ids=["port", "jax"])
def test_output_buffer_token_ack_and_backpressure(mod):
    """The buffer tests: token acknowledgement frees pages, a full buffer
    blocks its producer until an acknowledgement, a failure reaches the
    reader, a broadcast page frees once every reader is done or abandoned,
    and an unknown reader is refused; both packages alike."""
    buf = mod._OutputBuffer(max_bytes=100)
    buf.add(b"x" * 40)
    buf.add(b"y" * 40)
    assert buf.get(0, max_wait=0.1) == (b"x" * 40, False, None)
    page, complete, _ = buf.get(1, max_wait=0.1)
    assert page == b"y" * 40 and buf.bytes == 40
    buf.finish()
    assert buf.get(2, max_wait=0.1)[:2] == (None, True)
    buf = mod._OutputBuffer(max_bytes=50)
    buf.add(b"a" * 40)
    added = threading.Event()
    th = threading.Thread(target=lambda: (buf.add(b"b" * 40), added.set()), daemon=True)
    th.start()
    assert not added.wait(0.2), "the producer must block while the buffer is full"
    buf.get(1, max_wait=0.1)
    assert added.wait(2)
    buf = mod._OutputBuffer()
    buf.fail("boom: exploded")
    assert "boom" in buf.get(0, max_wait=0.1)[2]
    buf = mod._OutputBuffer(max_bytes=1000, n_readers=3)
    buf.add(b"p" * 100)
    buf.finish()
    for r in range(3):
        assert buf.get(0, max_wait=0.1, reader=r) == (b"p" * 100, False, None)
    for r in (0, 1):
        assert buf.get(1, max_wait=0.1, reader=r)[1]
    assert buf.bytes == 100 and not buf.fully_delivered
    buf.abandon(2)
    assert buf.bytes == 0 and buf.fully_delivered
    assert "reader" in mod._OutputBuffer(n_readers=2).get(0, max_wait=0.05, reader=5)[2]


def test_streaming_task_roundtrip_no_disk(tmp_path):
    e = _engine()
    w = WorkerServer(CATALOGS, str(tmp_path / "spool"), device="cpu")
    url = w.start()
    try:
        plan = compile_sql("select o_orderkey, o_totalprice from orders "
                           "order by o_totalprice desc limit 7", e, e.create_session("tpch"))
        xdir = str(tmp_path / "x")
        _http(f"{url}/v1/fragment", C._dumps_fragment({"fragment_id": "f1", "plan": plan}))
        _http(f"{url}/v1/task", pickle.dumps({"task_id": "t_stream", "fragment_id": "f1",
                                              "kind": "fragment", "exchange_dir": xdir,
                                              "output": "stream"}))
        chunks = list(stream_task_pages(url, "t_stream", timeout=60))
        assert len(chunks) == 1
        cols, _, _ = deserialize_fragment_output(chunks[0])
        local = e.execute_sql("select o_orderkey, o_totalprice from orders "
                              "order by o_totalprice desc limit 7", e.create_session("tpch"))
        assert list(cols[0]) == list(local.raw_columns[0])
        assert not SpoolingExchange(xdir).is_committed("t_stream")
        time.sleep(0.1)
        assert "t_stream" not in w.out_buffers
    finally:
        w.stop()


def test_worker_concurrent_fragments(tmp_path):
    e = _engine()
    w = WorkerServer(CATALOGS, str(tmp_path / "spool"), device="cpu")
    url = w.start()
    try:
        sql = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) r "
               "from lineitem, orders where l_orderkey = o_orderkey "
               "group by l_orderkey order by r desc limit 5")
        plan = compile_sql(sql, e, e.create_session("tpch"))
        xdir = str(tmp_path / "x")
        _http(f"{url}/v1/fragment", C._dumps_fragment({"fragment_id": "fc", "plan": plan}))
        # the first task's scan waits until the second holds its executor
        both = threading.Barrier(2, timeout=30)
        orig = w._checkout_executor

        def checkout(query_key="q", token="", _o=orig):
            ex = _o(query_key, token)
            both.wait()
            return ex

        w._checkout_executor = checkout
        for tid in ("c1", "c2"):
            _http(f"{url}/v1/task", pickle.dumps({"task_id": tid, "fragment_id": "fc",
                                                  "kind": "fragment", "exchange_dir": xdir}))
        deadline = time.time() + 120
        while time.time() < deadline:
            states = [json.loads(_http(f"{url}/v1/task/{t}"))["state"] for t in ("c1", "c2")]
            if all(s == "done" for s in states):
                break
            assert "failed" not in states, states
            time.sleep(0.05)
        else:
            raise AssertionError(f"tasks did not finish: {states}")
        assert json.loads(_http(f"{url}/v1/info"))["peak_concurrency"] >= 2
        ex = SpoolingExchange(xdir)
        a, b = (deserialize_fragment_output(ex.read(t)) for t in ("c1", "c2"))
        assert [list(c) for c in a[0]] == [list(c) for c in b[0]]
    finally:
        w.stop()


def test_fanout_join_streams_build_side(tmp_path, ref):
    """A split fan-out's consumer tasks read a broadcast streaming producer
    (tests/test_streaming_exchange.py's fan-out, in process)."""
    c = _Cluster(tmp_path, 2)
    try:
        chip_smoke.same_result(c.coord.execute_sql(FANOUT_SQL), ref(FANOUT_SQL), "fanout")
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
        assert c.coord.broadcast_streams >= 1 and c.coord.streamed_tasks >= 1
    finally:
        c.stop()


def test_stream_failure_replays_producers(tmp_path, ref, monkeypatch):
    """A consumer's failed stream read retries by replaying its producers
    (fresh producers under new task ids), not by degrading to the local
    path (tests/test_streaming_exchange.py's slow test, in process)."""
    real = C.stream_task_pages
    tripped = {}

    def flaky(u, task_id, secret=None, timeout=60.0, reader=0):
        # each original producer's first read fails once; respawned ones
        # ("~" in the id) read cleanly
        if "~" not in task_id and task_id not in tripped:
            tripped[task_id] = True
            raise RuntimeError("injected stream failure (GET_RESULTS)")
        return real(u, task_id, secret=secret, timeout=timeout, reader=reader)

    monkeypatch.setattr(C, "stream_task_pages", flaky)
    c = _Cluster(tmp_path, 2)
    try:
        chip_smoke.same_result(c.coord.execute_sql(FANOUT_SQL), ref(FANOUT_SQL), "replayed")
        assert tripped and c.coord.stream_retries >= 1
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
    finally:
        c.stop()


# -- tests/test_chaos.py ------------------------------------------------------------
def test_backoff_spacing_grows_and_is_deterministic():
    a = [_backoff_s("t42", k, base=0.1, cap=60.0) for k in range(1, 8)]
    assert a == sorted(a) and a[0] < a[-1]
    assert a == [jcluster._backoff_s("t42", k, base=0.1, cap=60.0) for k in range(1, 8)]
    assert a != [_backoff_s("t43", k, base=0.1, cap=60.0) for k in range(1, 8)]
    assert _backoff_s("t42", 30, base=0.1, cap=2.5) == 2.5
    assert _backoff_s("t42", 5000, base=0.25, cap=5.0) == 5.0


def test_reannounce_resets_heartbeat_probe_backoff(tmp_path):
    coord = ClusterCoordinator(_engine(), str(tmp_path / "spool"))
    coord._announce("w0", "http://127.0.0.1:1")
    w = coord.workers["w0"]
    w.alive, w.misses, w.next_probe = False, 3, time.time() + 999.0
    coord._announce("w0", "http://127.0.0.1:1")
    assert w.alive and w.misses == 0 and w.next_probe == 0.0


def test_task_fault_kill_worker_recovers(tmp_path, ref):
    """The ``task`` point: ``kill_worker`` on a worker's first task makes it
    look crashed; the coordinator's detector and re-dispatch finish the
    query on the other worker."""
    from trino_tpu_torch.execution import faults

    c = _Cluster(tmp_path, 2, coord_kw={"max_attempts": 4})
    try:
        with faults.injected("point=task,action=kill_worker,nth=1") as plan:
            got = c.coord.execute_sql(Q)
        assert plan.total_fires() == 1
        chip_smoke.same_result(got, ref(Q), "task fault")
        assert c.coord.local_fallbacks == 0, c.coord.last_fallback_error
        assert c.coord.last_query_counters.task_retries >= 1
        # the failure detector takes the crashed worker out within a few
        # heartbeats, whether or not the query outran it
        deadline = time.time() + 30
        while len(c.coord.live_workers()) != 1 and time.time() < deadline:
            time.sleep(0.05)
        assert len(c.coord.live_workers()) == 1
    finally:
        c.stop()


def test_dropped_commit_is_dispatched_again(tmp_path, ref):
    """A worker's lost commit (``exchange_write`` drop): the task reports
    done with no output, and the coordinator offers it again at once."""
    from trino_tpu_torch.execution import faults

    c = _Cluster(tmp_path, 1)
    try:
        with faults.injected("point=exchange_write,action=drop,nth=1") as plan:
            t0 = time.perf_counter()
            got = c.coord.execute_sql(Q)
            wall = time.perf_counter() - t0
        assert plan.total_fires() == 1
        chip_smoke.same_result(got, ref(Q), "dropped commit")
        assert c.coord.last_query_counters.task_retries == 1
        assert wall < c.coord.task_timeout / 2  # not recovered by the deadline
    finally:
        c.stop()


# -- the rest -----------------------------------------------------------------------
def test_cluster_harvest_merges_with_local_records(tmp_path, ref):
    e = _engine()
    s = e.create_session("tpch")
    expected = e.execute_sql(Q, s)
    payload = e.last_plan_actuals
    ent = next(x for x in e.plan_history.snapshot()
               if x["fingerprint"] == payload["fingerprint"])
    assert ent["executions"] == 1
    local_paths = set(ent["nodes"])
    c = _Cluster(tmp_path, 1, engine=e)
    try:
        chip_smoke.same_result(c.coord.execute_sql(Q), ref(Q), "harvest q")
        chip_smoke.same_result(expected, ref(Q), "local q")
        assert c.coord.local_fallbacks == 0
    finally:
        c.stop()
    ent2 = next(x for x in e.plan_history.snapshot()
                if x["fingerprint"] == payload["fingerprint"])
    assert ent2["executions"] == 2
    agg_paths = [p for p in local_paths if p.startswith("Aggregate#")]
    assert agg_paths, local_paths
    for p in agg_paths + [p for p in local_paths if p.startswith(("Sort#", "Project#"))]:
        assert ent2["nodes"][p]["executions"] == 2, (p, ent2["nodes"][p])
        assert ent2["nodes"][p]["actual_rows"] == ent["nodes"][p]["actual_rows"]


def test_in_process_cluster_one_stitched_trace(tmp_path, ref):
    c = _Cluster(tmp_path, 1)
    e, coord = c.engine, c.coord
    try:
        chip_smoke.same_result(coord.execute_sql(QFLIGHT), ref(QFLIGHT), "stitched")
        assert coord.local_fallbacks == 0, coord.last_fallback_error
        t = coord.last_query_trace
        qid, spans = t["query_id"], t["spans"]
        assert {sp["trace_id"] for sp in spans} == {qid}
        roots = [sp for sp in spans if sp["parent_id"] is None]
        assert len(roots) == 1 and roots[0]["name"] == "query"
        tasks = [sp for sp in spans if sp["name"] == "task"]
        assert tasks and all(sp["parent_id"] == roots[0]["span_id"] for sp in tasks)
        ids = {sp["span_id"] for sp in spans}
        assert all(sp["parent_id"] in ids for sp in spans if sp["parent_id"] is not None)
        assert coord.stitched_spans_total >= len(tasks)
        ospans = spans_to_otlp(spans)["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert len({sp["traceId"] for sp in ospans}) == 1
        rec = e.flight_recorder.get(qid)
        assert rec is not None and rec.get("distributed")
        assert rec["worker_spans"] >= len(tasks) and rec["trace"]["spans"]
        bd = rec["wall_breakdown"]
        assert bd and abs(sum(bd[b] for b in WALL_BUCKETS) - bd["wall_s"]) \
            <= 0.05 * bd["wall_s"]
    finally:
        c.stop()


def test_cluster_coordinator_serves_from_result_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(64 << 20))
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
    e = _engine()
    coord = ClusterCoordinator(e, str(tmp_path))
    s = e.create_session("tpch")
    r1 = coord.execute_sql(Q, s)
    r2 = coord.execute_sql(Q, s)
    chip_smoke.same_bytes(r1, r2, "result tier")
    assert e.buffer_pool.result_hits >= 1
    assert e.last_query_counters["result_cache_hits"] == 1
    assert coord.last_query_counters.result_cache_hits == 1
    e._invalidate()


def test_coordinator_walks_evict_rung_before_kill(tmp_path):
    coord = ClusterCoordinator(_engine(), str(tmp_path / "spool"))
    coord._announce("w0", "http://127.0.0.1:1")
    w = coord.workers["w0"]
    w.mem_reserved, w.mem_max = 95, 100
    w.mem_by_query = {"hog": 90}
    coord._run_memory_killer()
    assert coord.oom_kills == 0 and not coord.pressure_events
    coord._run_memory_killer()
    assert coord.oom_kills == 0
    assert [ev["rung"] for ev in coord.pressure_events] == ["evict-cache"]
    coord._run_memory_killer()
    assert coord.oom_kills == 1 and coord.last_oom_victim == "hog"
    assert [ev["rung"] for ev in coord.pressure_events] == ["evict-cache", "kill"]
    assert coord.query_pressure_rung["hog"] == "kill"
    w.mem_reserved = 10
    coord._run_memory_killer()
    assert coord._blocked_streak == 0


def test_worker_sheds_cache_then_refuses(tmp_path):
    w = WorkerServer({"tpch": {"connector": "tpch", "sf": 0.01}}, str(tmp_path / "spool"),
                     device="cpu", cache_bytes=1 << 20, pool_bytes=1 << 30)
    assert w.memory_pool.max_bytes == 1 << 30 and w.buffer_pool.budget() == 1 << 20
    w.fragments["f0"] = object()
    w.memory_pool.reserved = int(w.memory_pool.max_bytes * 0.95)
    with pytest.raises(C._WorkerBusy):
        w._start_task({"task_id": "t0", "fragment_id": "f0"})
    assert w.admission_denials == 1
    w.memory_pool.reserved = 0


def test_spill_counters_merge_and_roundtrip():
    from trino_tpu_torch.execution.tracing import record_spill, track_counters

    c = QueryCounters()
    with track_counters(c):
        record_spill("host", 100)
        record_spill("disk", 50)
    assert (c.spilled_bytes, c.spill_tier_host, c.spill_tier_disk) == (150, 100, 50)
    assert any(v.get("spilled_bytes") for v in c.sites.values())
    d = QueryCounters.from_dict(c.as_dict())
    assert d.spilled_bytes == 150 and d.spill_tier_disk == 50
    m = QueryCounters()
    m.merge(c)
    m.merge(d)
    assert m.spilled_bytes == 300 and m.spill_tier_host == 200
    m.admission_queued += 1
    assert QueryCounters.from_dict(m.as_dict()).admission_queued == 1


def test_worker_owns_its_pool(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", str(1 << 20))
    w = WorkerServer({"tpch": {"connector": "tpch", "sf": 0.01}}, str(tmp_path), device="cpu")
    assert w.local.buffer_pool is w.buffer_pool
    ex = w._checkout_executor(query_key="q", token="t0")
    try:
        assert ex.buffer_pool is w.buffer_pool and ex.memory_pool is w.memory_pool
    finally:
        w._release_executor(ex, token="t0")
    assert _engine().buffer_pool is not w.buffer_pool


def test_coordinator_does_not_degrade_compiling_worker(tmp_path):
    coord = ClusterCoordinator(_engine(), spool_dir=str(tmp_path))
    coord._announce("w1", "http://127.0.0.1:1", health="compiling")
    coord._announce("w2", "http://127.0.0.1:2", health="stalled")
    coord._announce("w3", "http://127.0.0.1:3", health="ok")
    by_id = {w.node_id: w for w in coord.workers.values()}
    assert not by_id["w1"].degraded and by_id["w2"].degraded
    assert {w.node_id for w in coord.live_workers()} == {"w1", "w3"}


def test_wide_sum_fault_tolerant_and_distributed():
    """Two-limb partial sums merge by plain addition across the FTE spool
    and the mesh exchange (tests/test_decimal128.py)."""
    from decimal import Decimal

    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.parallel.mesh import worker_mesh

    e = Engine(device="cpu")
    e.register_catalog("mem", MemoryConnector())
    s = e.create_session("mem")
    e.execute_sql("create table big (g bigint, v decimal(18,2))", s)
    vals = [(i % 2, f"{8_600_000_000_000_000 + i * 7}.25") for i in range(40)]
    e.execute_sql("insert into big values " + ", ".join(f"({g}, {v})" for g, v in vals), s)
    want = [(g, sum(Decimal(v) for gg, v in vals if gg == g)) for g in (0, 1)]
    q = "select g, sum(v) s from big group by g order by g"
    assert e.execute_sql(q, s, fault_tolerant=True).rows() == want
    got = e.execute_sql(q, s, distributed=True, mesh=worker_mesh(8, devices=["cpu"] * 8))
    assert [(g, v) for g, v in got.rows()] == want


def test_fragments_ship_no_tensor():
    """The coordinator refuses to pickle a fragment holding a tensor."""
    import torch

    C._dumps_fragment({"plan": np.arange(3)})
    with pytest.raises(TypeError, match="tensor"):
        C._dumps_fragment({"plan": [1, torch.zeros(2)]})
