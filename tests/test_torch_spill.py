"""The port's memory-pressure ladder (``trino_tpu_torch/exec/spill.py``, the
Grace paths of ``exec/local_executor.py``, the admission gate, the page
codec and ``ops/exchange.partition_ids``) against the JAX package on the
CPU.

Restates tests/test_spill_tiers.py at SF0.02 with 4096-row splits.  For
each of ``chaos_matrix.PRESSURE``'s eight scenarios, both packages run the
same plan on the same tiny pool: both results' signatures equal the port's
unconstrained run, and the partition count and rows per partition
of every spill, the tiers that took bytes and the typed error of the
``fail`` scenarios are the reference's, and the leak check is clean after
each.  The counters of a disk-forced run, a partitioned join through the
ladder, an error mid-spill, the EXPLAIN ``Spill:`` line and the
``/v1/metrics`` series, the admission gate alone and in the engine, and
the spill counters' merge are held against the reference's.  Adds the page
codec in both modes (zstd, and zlib as on the card) with frames read by
both packages, and ``partition_ids`` on keys whose hashes are negative.

The two cluster-rung tests and the counters' round trip through
``QueryCounters.from_dict`` (the worker wire shape) are restated in
tests/test_torch_cluster.py.  Left out: the Q18 tier crossing at SF0.1, a
``slow`` test that runs on the card instead
(``chip_smoke.py`` phase 16b).  The reference's join under a 200,000-byte
pool takes it about 40 s on a CPU (a compile per partition), so the
partitioned join is held against the reference's unconstrained run.
"""

import os
import re
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp
from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.exec import fte as jfte
from trino_tpu.exec import spill as jspill
from trino_tpu.exec.local_executor import LocalExecutor as JaxExecutor
from trino_tpu.execution import chaos_matrix as jcm
from trino_tpu.execution import faults as jfaults
from trino_tpu.execution import tracing as JT
from trino_tpu.execution.bufferpool import DeviceBufferPool as JaxBufferPool
from trino_tpu.execution.resourcegroups import ResourceGroupManager as JaxRGM
from trino_tpu.memory import MemoryPool as JaxPool
from trino_tpu.ops.exchange import partition_ids as jax_partition_ids
from trino_tpu.sql.frontend import compile_sql as jax_compile
from trino_tpu.sql.planprinter import format_plan as jax_format_plan
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import fte
from trino_tpu_torch.exec import spill as tspill
from trino_tpu_torch.exec.local_executor import LocalExecutor
from trino_tpu_torch.execution import chaos_matrix as cm
from trino_tpu_torch.execution import faults
from trino_tpu_torch.execution import tracing as T
from trino_tpu_torch.execution.bufferpool import DeviceBufferPool
from trino_tpu_torch.execution.resourcegroups import ResourceGroupManager
from trino_tpu_torch.memory import MemoryPool
from trino_tpu_torch.ops.exchange import partition_ids
from trino_tpu_torch.server.server import CoordinatorServer
from trino_tpu_torch.sql.frontend import compile_sql
from trino_tpu_torch.sql.planprinter import format_plan

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.02, 1 << 12
JOIN_SQL = """select o_orderpriority, count(*) c from orders, lineitem
              where o_orderkey = l_orderkey group by o_orderpriority
              order by o_orderpriority"""


def _recording(mp, cls, sink):
    """Record each spill's partition count, rows per partition and the
    tiers that took bytes, as it closes (both packages' SpilledPartitions)."""
    orig = cls.close

    def close(self):
        if not self._closed:
            sink.append((self.parts, list(self.rows),
                         sorted(t for t, b in self.tier_bytes.items() if b)))
        orig(self)

    mp.setattr(cls, "close", close)


@pytest.fixture(scope="module")
def env():
    # the reference's scenarios are held to the port's unconstrained run:
    # their forced results equal it, or the scenario fails
    jax_e = JaxEngine()
    jax_e.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    jplan = jax_compile(cm.PRESSURE_QUERY, jax_e, jax_e.create_session("tpch"))
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    session = e.create_session("tpch")
    plan = compile_sql(cm.PRESSURE_QUERY, e, session)
    base = cm.result_signature(LocalExecutor(e.catalogs, "cpu").execute(plan))
    yield {"engine": e, "session": session, "plan": plan, "base": base,
           "jax_engine": jax_e, "jax_plan": jplan}
    e._invalidate()


def _ref_scenario(env, name, scratch, mp):
    """The reference's run of one scenario, with its spills recorded."""
    cfg, spec, kind = next((c, sp, k) for n, c, sp, k in jcm.PRESSURE if n == name)
    spills: list = []
    _recording(mp, jspill.SpilledPartitions, spills)
    rec = jcm.run_pressure_scenario(env["jax_engine"], env["jax_plan"], env["base"],
                                    name, cfg, spec, kind, str(scratch))
    return rec, spills


# ----------------------------------------------------------- pressure matrix
def test_pressure_scenarios_are_the_references():
    assert [(n, c, s, k) for n, c, s, k in cm.PRESSURE] == \
        [(n, c, s, k) for n, c, s, k in jcm.PRESSURE]
    assert " ".join(cm.PRESSURE_QUERY.split()) == " ".join(jcm.PRESSURE_QUERY.split())


@pytest.mark.parametrize("name", [s[0] for s in cm.PRESSURE])
def test_pressure_scenario(env, name, tmp_path, monkeypatch):
    """Every forced tier gives the unconstrained bytes, injected spill
    faults give the reference's typed errors, the spills partition and
    tier as the reference's, and the leak check is clean after each."""
    cfg, spec, kind = next((c, sp, k) for n, c, sp, k in cm.PRESSURE if n == name)
    (tmp_path / "jax").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        jrec, jspills = _ref_scenario(env, name, tmp_path / "jax", mp)
    spills = []
    _recording(monkeypatch, tspill.SpilledPartitions, spills)
    scratch = tmp_path / "spill"
    scratch.mkdir()
    rec = cm.run_pressure_scenario(env["engine"], env["plan"], env["base"], name, cfg,
                                   spec, kind, str(scratch))
    assert rec["ok"], {k: v for k, v in rec.items() if k != "signature"}
    assert jrec["ok"], jrec
    assert spills == jspills
    assert sorted(t for t, b in rec["tiers"].items() if b) == \
        sorted(t for t, b in jrec["tiers"].items() if b)
    assert rec.get("error_type") == jrec.get("error_type")
    assert rec.get("fires") == jrec.get("fires")
    assert cm.leak_report(env["engine"], timeout=2.0) == []


def test_forced_tiers_report_on_counters(env, tmp_path, monkeypatch):
    """The disk-forced run's counters carry its bytes on the disk tier and
    none on the others, under a named site, as the reference's do; no file
    outlives the query."""
    monkeypatch.setenv("TRINO_TPU_SPILL_HOST_BYTES", "0")
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(d))
        if pkg == "jax":
            ex = JaxExecutor(env["jax_engine"].catalogs,
                             memory_pool=JaxPool(max_bytes=1 << 19),
                             buffer_pool=JaxBufferPool(budget_bytes=0))
            ex.execute(env["jax_plan"])
            c = ex.counters
        else:
            ex = LocalExecutor(env["engine"].catalogs, "cpu",
                               memory_pool=MemoryPool(max_bytes=1 << 19),
                               buffer_pool=DeviceBufferPool(budget_bytes=0))
            c = T.QueryCounters()
            with T.track_counters(c):
                ex.execute(env["plan"])
        assert c.spill_tier_disk > 0
        assert c.spill_tier_hbm == 0 and c.spill_tier_host == 0
        assert c.spilled_bytes == c.spill_tier_disk
        assert any("spill.disk" in k for k in c.sites), sorted(c.sites)
        assert not os.listdir(d), "spill files survived the query"
        got[pkg] = c.spill_tier_disk
    assert got["torch"] == got["jax"]


def test_partitioned_join_spill_tiers_identity(env, tmp_path, monkeypatch):
    """The Grace join's build and probe spill walk the same ladder: a tiny
    pool partitions the join, the result is the reference's, the tier stats
    land on the plan stats, and once the query ended no spill reservation,
    registration or file is left (the port's build spill closes with the
    query; the reference's with forget_plan)."""
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    jax_e = env["jax_engine"]
    jplan = jax_compile(JOIN_SQL, jax_e, jax_e.create_session("tpch"))
    full = jcm.result_signature(JaxExecutor(jax_e.catalogs).execute(jplan))
    plan = compile_sql(JOIN_SQL, env["engine"], env["session"])
    ex = LocalExecutor(env["engine"].catalogs, "cpu",
                       memory_pool=MemoryPool(max_bytes=200_000))
    assert cm.result_signature(ex.execute(plan)) == full
    spilled = [st for st in ex.stats.values() if st.get("spill_partitions")]
    assert spilled and any(st.get("spill_tiers") for st in spilled)
    assert any(st["op"] == "Join" for st in spilled)
    assert ex.memory_pool.info()["by_tag"].get("spill", 0) == 0
    assert not ex._spills
    assert not os.listdir(tmp_path), "spill files survived the query"


def test_spill_error_mid_partition_cleans_up(env, tmp_path, monkeypatch):
    """An error raised mid-spill (the third disk chunk) unwinds clean in
    both packages: the typed error, one firing, no orphaned file, no
    stranded reservation."""
    monkeypatch.setenv("TRINO_TPU_SPILL_HOST_BYTES", "0")
    spec = "point=spill_write,site=spill.disk,action=error,nth=3"
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(d))
        if pkg == "jax":
            ex = JaxExecutor(env["jax_engine"].catalogs,
                             memory_pool=JaxPool(max_bytes=1 << 19))
            plan, mod = env["jax_plan"], jfaults
        else:
            ex = LocalExecutor(env["engine"].catalogs, "cpu",
                               memory_pool=MemoryPool(max_bytes=1 << 19))
            plan, mod = env["plan"], faults
        with mod.injected(spec) as fplan:
            with pytest.raises(mod.InjectedFaultError):
                ex.execute(plan)
        assert fplan.total_fires() == 1
        ex.close_producers()
        assert not ex._spills
        assert ex.memory_pool.info()["by_tag"].get("spill", 0) == 0
        assert not os.listdir(d), "orphaned spill file"


def test_unwired_fault_points_refuse_to_arm():
    """Every point of the reference's vocabulary is wired in the port now
    (the cluster's ``task`` last): rules on any of the twelve arm, and a
    point outside the vocabulary is refused."""
    assert set(faults.WIRED) == set(faults.POINTS) == set(jfaults.POINTS)
    assert len(faults.WIRED) == 12
    for spec in ("point=task,action=error",
                 "point=spill_read,action=deny;point=task,action=error",
                 "point=exchange_write,action=error;point=task,action=kill_worker"):
        with faults.injected(spec) as plan:
            assert faults.active() is plan
        assert faults.active() is None
    for spec in ("point=teleport,action=error", "point=task,action=error;point=nope"):
        with pytest.raises(ValueError, match="unknown fault point"):
            faults.arm(spec)
        with pytest.raises(ValueError, match="unknown fault point"):
            with faults.injected(spec):
                pass
        assert faults.active() is None


# ------------------------------------------------------ observability surface
def _pressure_explain(pkg, engine, plan, pool):
    if pkg == "jax":
        ex = JaxExecutor(engine.catalogs, memory_pool=pool)
        ex.execute(plan)
        return jax_format_plan(plan, ex.stats, counters=ex.counters,
                               boundary=ex.boundary)
    ex = LocalExecutor(engine.catalogs, "cpu", memory_pool=pool)
    c = T.QueryCounters()
    with T.track_counters(c):
        ex.execute(plan)
    return format_plan(plan, ex.stats, counters=c, boundary=ex.boundary)


def test_explain_and_metrics_carry_spill_line(env, tmp_path, monkeypatch):
    """EXPLAIN ANALYZE grows the Spill line and the per-node spill and tier
    lines when, and only when, the query spilled, in both packages; a
    spilling statement through the engine reaches the /v1/metrics tier
    series and the admission counter, and /v1/status' memory section
    carries the pool's tags."""
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    jax_e, jplan = env["jax_engine"], env["jax_plan"]
    for pkg, engine, plan, pool_cls in (("jax", jax_e, jplan, JaxPool),
                                        ("torch", env["engine"], env["plan"], MemoryPool)):
        text = _pressure_explain(pkg, engine, plan, None)
        assert "Spill:" not in text and "[tiers:" not in text
        text = _pressure_explain(pkg, engine, plan, pool_cls(max_bytes=1 << 19))
        assert "Spill:" in text and "bytes" in text, text
        assert "[spilled:" in text and "[tiers:" in text, text
    engine, session = env["engine"], env["session"]
    prev = engine.memory_pool.max_bytes
    engine.memory_pool.max_bytes = 1 << 19
    try:
        engine.execute_sql(cm.PRESSURE_QUERY, session)
    finally:
        engine.memory_pool.max_bytes = prev
    c = engine.last_query_counters
    assert c["spilled_bytes"] > 0
    srv = CoordinatorServer(engine)
    mtext = srv._metrics_text()
    assert "# TYPE trino_tpu_spilled_bytes_total counter" in mtext
    m = {t: int(v) for t, v in re.findall(
        r'^trino_tpu_spilled_bytes_total\{tier="(\w+)"\} (\d+)$', mtext, re.M)}
    assert set(m) == {"hbm", "host", "disk"}
    assert sum(m.values()) >= c["spilled_bytes"]
    assert re.search(r"^trino_tpu_admission_queued_total \d+$", mtext, re.M)
    assert all("by_tag" in d for d in engine.memory_info())
    assert cm.leak_report(engine, timeout=2.0) == []


# ---------------------------------------------------- admission (queue rung)
def _gate_script(mgr_cls):
    blocked = {"v": False}
    mgr = mgr_cls(admission_gate=lambda: not blocked["v"])
    g = mgr.get_or_create("global.alice")
    started, mem_queued, trace = [], [], []
    blocked["v"] = True
    mgr.submit(g, lambda: started.append("q1"),
               queued_on_memory=lambda: mem_queued.append("q1"))
    trace.append((list(started), list(mem_queued)))
    mgr.submit(g, lambda: started.append("q2"),
               queued_on_memory=lambda: mem_queued.append("q2"))
    trace.append((list(started), list(mem_queued), mgr.memory_queued_total))
    mgr.finish(g)
    trace.append(list(started))
    mgr.finish(g)
    return trace


def test_admission_gate_queues_then_drains():
    """The memory gate: an idle tree admits; with work running and the gate
    blocked a submission queues on memory; a finish drains it (the
    reference's sequence, step for step)."""
    got = _gate_script(ResourceGroupManager)
    assert got == _gate_script(JaxRGM)
    assert got == [(["q1"], []), (["q1"], ["q2"], 1), ["q1", "q2"]]


def _hogged_statement(engine, session, pool, hold_group):
    """A second statement under a hog past BLOCKED_FRACTION on ``pool``
    while ``hold_group`` runs: (queued while held, finished before the
    hog was freed, its result)."""
    from trino_tpu_torch.execution.memory_killer import BLOCKED_FRACTION

    hog = int(pool.max_bytes * (BLOCKED_FRACTION + 0.05))
    assert pool.try_reserve(hog, "test-hog")
    group = engine.resource_groups.get_or_create(hold_group)
    engine.resource_groups.submit(group, lambda: None)  # a running statement
    done = {}
    t = threading.Thread(target=lambda: done.update(
        r=engine.execute_sql("select count(*) from nation", session)))
    t.start()
    deadline = time.time() + 5
    while time.time() < deadline and engine.resource_groups.memory_queued_total == 0:
        time.sleep(0.01)
    queued = engine.resource_groups.memory_queued_total
    early = "r" in done
    pool.free(hog, "test-hog")
    engine.resource_groups.finish(group)
    t.join(timeout=30)
    assert not t.is_alive()
    return queued, early, done["r"]


def test_engine_defers_admission_under_pool_pressure():
    """With the engine's pool past BLOCKED_FRACTION and a statement
    running, a second one queues, carries admission_queued 1 on its
    counters and the engine's totals, and completes once the pressure
    clears, as in the reference."""
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 11))
    s = e.create_session("tpch")
    e.execute_sql("select count(*) from nation", s)
    before = e.counters_total.admission_queued
    queued, early, r = _hogged_statement(e, s, e.memory_pool, "global.holder")
    assert (queued, early, len(r)) == (1, False, 1)
    assert e.counters_total.admission_queued == before + 1
    # the statement ran on its own thread: its counters sit on its entry
    assert e.query_tracker.all_queries()[-1].counters["admission_queued"] == 1
    # the reference, on its first pooled executor's pool
    je = JaxEngine()
    je.register_catalog("tpch", JaxTpch(sf=0.01, split_rows=1 << 11))
    js = je.create_session("tpch")
    je.execute_sql("select count(*) from nation", js)
    jq, jearly, jr = _hogged_statement(je, js, je._all_executors[0].memory_pool,
                                       "global.holder")
    assert (jq, jearly, len(jr)) == (queued, early, len(r))
    assert je.counters_total.admission_queued == 1


# ----------------------------------------------------------- counters plumb
def test_spill_counters_merge():
    """record_spill fills the tier counters and a site record; merge sums
    them, as the reference's do."""
    out = []
    for mod in (T, JT):
        c = mod.QueryCounters()
        with mod.track_counters(c):
            mod.record_spill("host", 100)
            mod.record_spill("disk", 50)
        assert any(v.get("spilled_bytes") for v in c.sites.values())
        m = mod.QueryCounters()
        m.merge(c)
        m.merge(c)
        m.admission_queued += 1
        d = m.as_dict()
        out.append((c.spilled_bytes, c.spill_tier_host, c.spill_tier_disk,
                    d["spilled_bytes"], d["spill_tier_host"], d["admission_queued"]))
    assert out[0] == out[1] == (150, 100, 50, 300, 200, 1)


# -------------------------------------------------------- codec and routing
@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_page_codec_frames(codec, monkeypatch):
    """A frame the port writes decodes in the port and in the reference, and
    a reference frame decodes in the port, with each codec (zlib is the
    card's, which has no zstandard)."""
    monkeypatch.setattr(fte, "PAGE_CODEC", codec)
    monkeypatch.setattr(jfte, "PAGE_CODEC", codec)
    rng = np.random.default_rng(7)
    cols = [rng.integers(-2**40, 2**40, 1000), rng.normal(size=1000),
            rng.integers(0, 9, 1000).astype(np.int32)]
    nulls = [None, rng.random(1000) < 0.2, None]
    frame = fte.serialize_page(cols, nulls)
    assert frame[:4] == b"TTPG" and frame[4] == fte._CODECS[codec]
    for got in (fte.deserialize_page(frame), jfte.deserialize_page(frame),
                fte.deserialize_page(jfte.serialize_page(cols, nulls))):
        gcols, gnulls = got
        for a, b in zip(gcols, cols):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert gnulls[0] is None and gnulls[2] is None
        assert np.array_equal(gnulls[1], nulls[1])
    with pytest.raises(ValueError, match="checksum"):
        fte.deserialize_page(frame[:-1] + bytes([frame[-1] ^ 1]))


def test_partition_ids_match_the_reference():
    """Row for row the reference's partition ids, on one- and two-column
    keys whose hashes are negative, INT64_MIN and INT64_MAX included."""
    import torch

    rng = np.random.default_rng(11)
    k1 = np.concatenate([rng.integers(-2**62, 2**62, 5000),
                         np.array([0, -1, 1, np.iinfo(np.int64).min,
                                   np.iinfo(np.int64).max])])
    k2 = rng.integers(0, 1000, k1.shape[0]).astype(np.int32)
    from trino_tpu_torch.ops.hashing import hash_columns

    assert (hash_columns((torch.from_numpy(k1),)) < 0).any()
    for keys in ((k1,), (k1, k2)):
        for n in (2, 4, 7, 64):
            got = partition_ids(tuple(torch.from_numpy(k) for k in keys), n).numpy()
            ref = np.asarray(jax_partition_ids(tuple(jnp.asarray(k) for k in keys), n))
            assert got.dtype == np.int32 and np.array_equal(got, ref)
            assert got.min() >= 0 and got.max() < n


def test_route_keeps_partition_order():
    """The route sorts stably: each partition's rows keep the page's order,
    and invalid rows go nowhere."""
    import torch

    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.integers(0, 10**6, 2000))
    valid = torch.from_numpy(rng.random(2000) < 0.7)
    pid = partition_ids((vals,), 8)
    (routed,), bounds = tspill.route_sorted((vals,), valid, pid, 8)
    v, p, ok = vals.numpy(), pid.numpy(), valid.numpy()
    b = bounds.numpy()
    assert b[-1] == ok.sum()
    for q in range(8):
        assert np.array_equal(routed.numpy()[b[q]:b[q + 1]], v[ok & (p == q)])
