"""The port's in-flight registry and stall watchdog
(``trino_tpu_torch/execution/tracing.py`` ``InflightRegistry``,
``StallWatchdog``; the engine's ``health()``; ``/v1/status`` and
``/v1/metrics``) against the JAX package on the CPU.

Restates the in-flight and watchdog cases of tests/test_profiling.py (the
entry's lifecycle and label, the fake-clock report, a deliberately slowed
operation flipping ``/v1/status`` to "stalled" while it hangs, the status
payload and the stall gauges) and tests/test_plan_history.py's second armed
watchdog.  The fake-clock report has the reference's shape key for key.  On
the CPU no kernel launches, so the slowed operation is a host read (the
test hook fires at both kinds of entry); in the port a hung kernel shows at
a host read as well, since launches are asynchronous and every read
synchronises.  Adds the port's entry sites: split generation and the scan
cache's store hold entries while they run, and the engine turns "stalled"
and back to "ok" around a slowed read with its watchdog armed by
``TRINO_TPU_STALL_S``, folding the report into its flight recorder.
"""

import json
import logging
import threading
import time
import urllib.request

import pytest

from trino_tpu.execution import tracing as JT
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution import tracing
from trino_tpu_torch.server import Client
from trino_tpu_torch.server.server import CoordinatorServer

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

QUERY = """select l_returnflag, sum(l_quantity) q, count(*) c
           from lineitem where l_shipdate <= date '1998-09-02'
           group by l_returnflag order by l_returnflag"""


def _engine():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 11))
    return e


@pytest.fixture(scope="module")
def engine():
    return _engine()


@pytest.fixture(scope="module")
def server(engine):
    srv = CoordinatorServer(engine, port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(autouse=True)
def _no_hook():
    yield
    tracing.DISPATCH_TEST_HOOK = None


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_inflight_registry_entry_lifecycle():
    reg = tracing.InflightRegistry()
    with tracing.track_inflight(reg), tracing.query_scope("query_77"):
        assert reg.depth() == 0
        with tracing.operator_scope("Aggregate#3", None):
            with tracing.inflight("dispatch", site="hash_insert"):
                snap = reg.snapshot()
                assert len(snap) == 1 and reg.depth() == 1
                (e,) = snap
                assert e["label"] == "Aggregate#3/hash_insert"
                assert e["kind"] == "dispatch" and e["site"] == "hash_insert"
                assert e["op"] == "Aggregate#3" and e["query_id"] == "query_77"
                assert e["thread_id"] == threading.get_ident() and e["elapsed_s"] >= 0
    assert reg.depth() == 0
    tok = reg.enter("host_pull", "agg.hash.overflow")
    assert reg.snapshot()[0]["label"] == "agg.hash.overflow"
    reg.exit(tok)
    assert reg.depth() == 0


def _fake_clock_report(mod, registry_cls, watchdog_cls):
    """One fake-clock report of ``mod``'s watchdog over a 100 s old entry."""
    reg = registry_cls()
    got = []
    wd = watchdog_cls(registry=reg, stall_s=5.0, kill_s=0, on_stall=got.append,
                      extra_info=lambda: {"memory": [{"pool": "p0"}]})
    with mod.track_inflight(reg), mod.query_scope("query_42"):
        with mod.operator_scope("Join#2", None):
            with mod.inflight("host_pull", site="join.build.nulls"):
                now = time.monotonic() + 100.0
                report = wd.check(now=now)
                verdict = wd.verdict(now=now)
                stalled_now = wd.stalled_now
    return report, got, verdict, stalled_now, wd, reg


def test_stall_watchdog_fake_clock_report_shape():
    report, got, verdict, stalled_now, wd, reg = _fake_clock_report(
        tracing, tracing.InflightRegistry, tracing.StallWatchdog)
    assert report is not None and wd.last_report is report and got == [report]
    assert stalled_now == 1 and verdict == ("stalled", 1)
    assert report["threshold_s"] == 5.0 and report["inflight_depth"] == 1
    assert report["memory"] == [{"pool": "p0"}]
    (e,) = report["stalled"]
    assert e["label"] == "Join#2/join.build.nulls" and e["query_id"] == "query_42"
    assert e["elapsed_s"] >= 100
    assert e["stack"] and "_fake_clock_report" in e["stack"]
    assert wd.check(now=time.monotonic() + 100.0) is None
    assert wd.stalled_now == 0 and wd.verdict()[0] == "ok"
    off = tracing.StallWatchdog(registry=reg, stall_s=0)
    assert not off.enabled and off.check() is None and off.verdict() == ("ok", 0)
    # the reference's watchdog over the same scenario reports the same shape
    ref = _fake_clock_report(JT, JT.InflightRegistry, JT.StallWatchdog)[0]
    assert set(report) == set(ref)
    assert set(report["stalled"][0]) == set(ref["stalled"][0])
    assert {k: v for k, v in report["stalled"][0].items()
            if k not in ("thread_id", "stack", "elapsed_s")} == \
        {k: v for k, v in ref["stalled"][0].items()
         if k not in ("thread_id", "stack", "elapsed_s")}


def test_env_thresholds(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_STALL_S", "2")
    monkeypatch.setenv("TRINO_TPU_STALL_KILL_S", "30")
    wd = tracing.StallWatchdog(registry=tracing.InflightRegistry())
    ref = JT.StallWatchdog(registry=JT.InflightRegistry())
    assert (wd.stall_s, wd.kill_s, wd.compile_stall_s, wd.poll_s) == \
        (ref.stall_s, ref.kill_s, ref.compile_stall_s, ref.poll_s) == (2.0, 30.0, 20.0, 0.5)
    monkeypatch.setenv("TRINO_TPU_STALL_COMPILE_S", "7")
    assert tracing.StallWatchdog(registry=tracing.InflightRegistry()).compile_stall_s == 7.0
    monkeypatch.delenv("TRINO_TPU_STALL_S")
    assert not tracing.StallWatchdog().enabled


def test_slow_host_pull_stall_report_and_status_flip(server, engine):
    """A deliberately slowed host read (the test hook) produces a stall
    report naming its "<Op>#<k>/<site>" within a watchdog period, and
    /v1/status reads "stalled" while the read hangs, "ok" after."""
    wd = engine.stall_watchdog
    saved = (wd.stall_s, wd.poll_s)
    wd.stall_s, wd.poll_s = 0.05, 0.01
    engine.last_stall_report = None
    status_seen = []

    def hook(label):
        if len(status_seen) < 2:
            time.sleep(0.2)
            status_seen.append(_get(server.url + "/v1/status"))

    try:
        s = engine.create_session("tpch")
        engine.execute_sql(QUERY, s)
        wd.start()
        tracing.DISPATCH_TEST_HOOK = hook
        engine.execute_sql(QUERY, s)
    finally:
        tracing.DISPATCH_TEST_HOOK = None
        wd.stop()
        wd.stall_s, wd.poll_s = saved
    report = engine.last_stall_report
    assert report is not None, "the watchdog never reported"
    labels = [e["label"] for e in report["stalled"]]
    assert any("#" in lbl.split("/")[0] and "/" in lbl for lbl in labels), labels
    assert any(e["stack"] for e in report["stalled"])
    assert report.get("memory"), report.keys()
    st = status_seen[0]
    assert st["health"]["status"] == "stalled" and st["health"]["stalled"] >= 1
    assert any(f["kind"] == "host_pull" for f in st["inflight"])
    running = [q for q in st["queries"] if q["state"] == "RUNNING"]
    assert running and any(q["inflight"] for q in running)
    assert engine.health()["status"] == "ok"
    assert engine.flight_recorder.snapshot(kind="stall"), "no stall event recorded"
    engine.last_stall_report = None


def test_status_endpoint_shape(server):
    Client(server.url, catalog="tpch").execute("select count(*) from nation")
    st = _get(server.url + "/v1/status")
    assert st["health"]["status"] == "ok"
    assert st["health"]["watchdog"]["enabled"] in (True, False)
    assert isinstance(st["inflight"], list) and isinstance(st["queries"], list)
    assert st["memory"]
    assert {"pool", "reserved", "max_bytes", "free"} <= set(st["memory"][0])


def test_metrics_stall_memory_and_resource_group_gauges(server):
    from test_profiling import _parse_prometheus

    Client(server.url, catalog="tpch").execute("select count(*) from region")
    parsed = _parse_prometheus(urllib.request.urlopen(
        server.url + "/v1/metrics", timeout=10).read().decode())
    assert parsed["types"]["trino_tpu_stalled_dispatches"] == "gauge"
    assert parsed["samples"]["trino_tpu_stalled_dispatches"][0][1] == 0
    assert parsed["types"]["trino_tpu_inflight_entries"] == "gauge"
    assert parsed["types"]["trino_tpu_memory_reserved_bytes"] == "gauge"
    pools = parsed["samples"]["trino_tpu_memory_reserved_bytes"]
    assert pools and all(lbl.get("pool") for lbl, _ in pools)
    assert parsed["samples"]["trino_tpu_memory_max_bytes"][0][1] > 0
    assert parsed["types"]["trino_tpu_resource_group_running"] == "gauge"
    groups = parsed["samples"]["trino_tpu_resource_group_queued"]
    assert groups and all(lbl.get("group") for lbl, _ in groups)
    assert parsed["types"]["trino_tpu_flight_records"] == "gauge"
    assert parsed["samples"]["trino_tpu_flight_records"][0][1] > 0


def test_second_armed_watchdog_skips_sampling(caplog):
    reg = tracing.InflightRegistry()
    wd1 = tracing.StallWatchdog(registry=reg, stall_s=5.0)
    wd2 = tracing.StallWatchdog(registry=reg, stall_s=5.0)
    try:
        wd1.start()
        assert wd1._thread is not None
        with caplog.at_level(logging.WARNING, logger="trino_tpu_torch.stall"):
            wd2.start()
        assert wd2._thread is None, "a second watchdog over one registry must not sample"
        assert any("already sampled" in r.message for r in caplog.records)
        assert wd2.verdict()[0] == "ok"
        wd3 = tracing.StallWatchdog(registry=tracing.InflightRegistry(), stall_s=5.0)
        try:
            wd3.start()
            assert wd3._thread is not None
        finally:
            wd3.stop()
    finally:
        wd1.stop()
        wd2.stop()
    wd4 = tracing.StallWatchdog(registry=reg, stall_s=5.0)
    try:
        wd4.start()
        assert wd4._thread is not None
    finally:
        wd4.stop()


def test_engine_stall_round_trip(monkeypatch):
    """An engine armed by TRINO_TPU_STALL_S: while one host read is held
    1 s, health() reads "stalled" naming the read's site, a stall event
    lands in the recorder; afterwards health() is "ok" again."""
    monkeypatch.setenv("TRINO_TPU_STALL_S", "0.05")
    e = _engine()
    try:
        assert e.stall_watchdog.enabled and e.stall_watchdog._thread is not None
        s = e.create_session("tpch")
        e.execute_sql(QUERY, s)
        held = threading.Event()

        def hook(label):
            if not held.is_set():
                held.set()
                time.sleep(1.0)

        seen = []
        tracing.DISPATCH_TEST_HOOK = hook
        t = threading.Thread(target=e.execute_sql, args=(QUERY, s))
        t.start()
        held.wait(10)
        deadline = time.monotonic() + 0.9
        while time.monotonic() < deadline and not seen:
            h = e.health()
            if h["status"] == "stalled":
                seen.append(h)
            time.sleep(0.01)
        t.join(30)
        tracing.DISPATCH_TEST_HOOK = None
        assert seen and seen[0]["stalled"] == 1
        stalls = e.flight_recorder.snapshot(kind="stall")
        assert stalls and stalls[-1]["stalled"][0]["kind"] == "host_pull"
        assert "/" in stalls[-1]["stalled"][0]["label"]
        assert e.health()["status"] == "ok"
    finally:
        e.stall_watchdog.stop()


class _Watched:
    """A connector wrapper whose ``splits`` and ``generate`` snapshot the
    in-flight registry."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def splits(self, table, *a, **kw):
        self.seen.append(tracing.INFLIGHT.snapshot())
        return self.inner.splits(table, *a, **kw)


def test_split_generation_holds_an_entry():
    e = Engine(device="cpu")
    conn = _Watched(TpchConnector(sf=0.01, split_rows=1 << 11))
    e.register_catalog("tpch", conn)
    conn.seen.clear()
    e.execute_sql("select max(r_name) from region", e.create_session("tpch"))
    kinds = [[x for x in snap if x["kind"] == "split-generation"] for snap in conn.seen]
    assert any(k and k[0]["site"] == "scan.region" for k in kinds), conn.seen
    assert tracing.INFLIGHT.depth() == 0


def test_cache_store_holds_an_entry(monkeypatch):
    from trino_tpu_torch.execution.bufferpool import DeviceBufferPool

    e = Engine(device="cpu")
    e.buffer_pool = DeviceBufferPool(budget_bytes=64 << 20, device=e.device)
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 11))
    seen = []
    orig = e.buffer_pool.put_page

    def put_page(*a, **kw):
        seen.append(tracing.INFLIGHT.snapshot())
        return orig(*a, **kw)

    monkeypatch.setattr(e.buffer_pool, "put_page", put_page)
    e.execute_sql("select sum(n_regionkey) from nation", e.create_session("tpch"))
    assert seen and any(x["kind"] == "cache-store" and x["site"] == "scan.nation.store"
                        for x in seen[0])
