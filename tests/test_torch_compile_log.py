"""The port's compile log (``trino_tpu_torch/execution/tracing.py``
``CompileLog``, ``record_compile``; ``ops/cuda_kernels.py`` ``_launch`` and
``build_kernels``) against the JAX package on the CPU.

A compile in the port is a kernel build: one record per ``csrc/*.cu``
library that ``build_kernels`` compiles with nvcc or loads from its cache.
This sandbox has neither nvcc nor a card, so a build is recorded here
through ``record_compile`` itself, or through ``_launch`` with the build
step replaced by one that records.

Restates tests/test_compile_observatory.py where a kernel build is its
counterpart: ``arg_signature`` and ``signature_summary``; the counters'
compile fields and their merge; storm detection and ``for_query`` on
synthetic records, equal to the reference's ``CompileLog`` record for
record; the compile-aware watchdog verdicts on a fake clock and the 10x
default; the flight record's compile census, EXPLAIN ANALYZE's
``Compile:`` line, ``system.runtime.compilations`` (columns equal to the
reference's), ``system.runtime.query_log``'s compile columns,
``GET /v1/compiles`` and its metric families, and ``/v1/status`` reading
"compiling".  Adds the launch chokepoint: the launch that triggers the
build holds a ``dispatch`` entry flagged ``compiling``, labelled with the
kernel under its operator, and charges the build to the statement.

Deviations with no counterpart: the reference's first-seen ``_jit``
signature cases (``test_jit_wrapper_detects_first_seen_signatures``,
``test_failed_first_seen_dispatch_does_not_poison_seen``,
``test_cold_then_warm_compile_split_and_wall_attribution``): the port
compiles no plans, so a cold statement of a process whose kernels are built
records no compile.  ``test_coordinator_does_not_degrade_compiling_worker``
is restated in tests/test_torch_cluster.py.
"""

import json
import logging
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

from trino_tpu.execution import tracing as JT
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution import tracing
from trino_tpu_torch.execution.tracing import (COMPILE_LOG, CompileLog, QueryCounters,
                                               StallWatchdog, arg_signature,
                                               signature_summary)
from trino_tpu_torch.ops import cuda_kernels as ck
from trino_tpu_torch.server.server import CoordinatorServer

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF = 0.01
QUERY = """select l_returnflag, sum(l_quantity) q, count(*) c
           from lineitem where l_shipdate <= date '1998-09-02'
           group by l_returnflag order by l_returnflag"""


@pytest.fixture(scope="module")
def engine():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=1 << 11))
    return e


@pytest.fixture(autouse=True)
def _clean_log():
    """Synthetic build records must not reach another test's advisor price."""
    yield
    COMPILE_LOG.clear()
    tracing.DISPATCH_TEST_HOOK = None


class _BuildOnce:
    """A DISPATCH_TEST_HOOK that records one kernel build, as the first
    launch of a process does, at the first host read of a statement."""

    def __init__(self, seconds=1.25):
        self.seconds = seconds
        self.fired = 0

    def __call__(self, label):
        if not self.fired:
            self.fired += 1
            tracing.record_compile(self.seconds, site="hash_insert",
                                   signature="0123456789abcdef", sig_key="0123456789abcdef",
                                   exe_bytes=4096, library="hash_insert.cu", cached=False)


# ---------------------------------------------------------------- unit layer
def test_arg_signature_distinguishes_shapes_dtypes_and_statics():
    k1 = arg_signature((np.zeros((4,), np.int64),))
    k2 = arg_signature((np.zeros((8,), np.int64),))
    k3 = arg_signature((np.zeros((4,), np.float64),))
    k4 = arg_signature((np.zeros((4,), np.int64), 7))
    k5 = arg_signature((np.zeros((4,), np.int64), 8))
    assert len({k1, k2, k3, k4, k5}) == 5
    assert k1 == arg_signature((np.ones((4,), np.int64),))
    assert "int64[4]" in signature_summary(k1)
    assert "7" in signature_summary(k4)
    ka = arg_signature(((np.zeros((2,)), np.zeros((2,))),))
    kb = arg_signature((np.zeros((2,)), np.zeros((2,))))
    assert ka != kb
    # torch tensors key by shape and dtype as arrays do
    t = arg_signature((torch.zeros(4, dtype=torch.int64),))
    assert t != k1 and "int64[4]" in signature_summary(t)
    assert t == arg_signature((torch.ones(4, dtype=torch.int64),))


def test_counters_carry_compiles_and_merge():
    a = QueryCounters(compiles=2, compile_s=1.25)
    a.sites["Agg#0/hash_insert"] = {"dispatches": 1, "transfers": 0, "bytes": 0,
                                   "compiles": 2, "compile_s": 1.25}
    b = QueryCounters()
    b.merge(a)
    b.merge(a)
    assert b.compiles == 4 and b.compile_s == pytest.approx(2.5)
    assert b.sites["Agg#0/hash_insert"]["compile_s"] == pytest.approx(2.5)
    d = b.as_dict()
    assert d["compiles"] == 4 and d["compile_s"] == pytest.approx(2.5)
    # the reference's counters carry the same compile and ladder fields
    j = JT.QueryCounters().as_dict()
    for f in ("compiles", "compile_s", "faults_injected", "task_retries", "spilled_bytes",
              "spill_tier_hbm", "spill_tier_host", "spill_tier_disk", "admission_queued"):
        assert f in d and f in j


def test_record_compile_charges_counters_sites_span_and_log():
    c = QueryCounters()
    tr = tracing.Tracer()
    with tracing.track_counters(c), tracing.query_scope("q9"), \
            tracing.activate_tracer(tr), tr.span("query", trace_id="q9"), \
            tracing.operator_scope("Aggregate#1", None):
        tracing.record_compile(2.5, site="hash_insert", signature="abc", sig_key="abc",
                               exe_bytes=100, library="hash_insert.cu", cached=False)
    assert c.compiles == 1 and c.compile_s == pytest.approx(2.5)
    assert c.sites["Aggregate#1/hash_insert"]["compiles"] == 1
    (rec,) = COMPILE_LOG.for_query("q9")
    assert rec["label"] == "Aggregate#1/hash_insert" and rec["site"] == "hash_insert"
    assert rec["library"] == "hash_insert.cu" and rec["cached"] is False
    assert rec["exe_bytes"] == 100 and rec["duration_s"] == 2.5
    assert [s.name for s in tr.spans_for("q9")].count("compile") == 1
    bd = tracing.wall_breakdown([tracing.span_dict(s) for s in tr.spans_for("q9")])
    assert bd["compile"] > 0


def _storm_sequence(cl):
    for i in range(5):
        cl.record(site="probe", label="Join#2/hash_probe", query_id="q1",
                  signature=f"d{i}", sig_key=f"s{i}", duration_s=0.01)
    cl.record(site="other", label="Aggregate#0/hash_insert", query_id="q1",
              signature="d", sig_key="t0", duration_s=0.01)
    cl.record(site="probe", label="Join#2/hash_probe", query_id="q2",
              signature="d0", sig_key="s0", duration_s=0.01)


def test_compile_log_storm_detection_equals_the_reference(caplog):
    cl = CompileLog(max_records=16, storm_sigs=3)
    with caplog.at_level(logging.WARNING, logger="trino_tpu_torch.stall"):
        _storm_sequence(cl)
    ref = JT.CompileLog(max_records=16, storm_sigs=3)
    _storm_sequence(ref)
    assert cl.info() == ref.info()
    assert cl.info()["storms_total"] == 1
    assert cl.info()["stormed_labels"] == ["Join#2/hash_probe"]
    storms = [r for r in caplog.records
              if r.name == "trino_tpu_torch.stall" and "recompile storm" in r.message]
    assert len(storms) == 1 and "Join#2/hash_probe" in storms[0].getMessage()
    assert len(cl.for_query("q2")) == len(ref.for_query("q2")) == 1
    assert [set(r) for r in cl.snapshot()] == [set(r) for r in ref.snapshot()]
    assert cl.latency.total == ref.latency.total == 7
    assert cl.latency.buckets == ref.latency.buckets


def test_compile_log_off_keeps_totals():
    cl = CompileLog(max_records=0)
    assert not cl.enabled
    cl.record(site="s", label="s", query_id=None, signature="x", duration_s=1.0)
    assert cl.snapshot() == [] and cl.info()["compiles_total"] == 1


def test_watchdog_compile_aware_verdicts():
    reg = tracing.InflightRegistry()
    got = []
    wd = StallWatchdog(registry=reg, stall_s=5.0, compile_stall_s=200.0, kill_s=0,
                       on_stall=got.append)
    with tracing.track_inflight(reg), tracing.query_scope("q7"):
        tok = reg.enter("dispatch", "hash_insert", compiling=True)
        try:
            now = time.monotonic() + 100.0
            assert wd.verdict(now=now) == ("compiling", 1)
            assert wd.check(now=now) is None and got == []
            assert wd.compiling_now == 1 and wd.stalled_now == 0
            now = time.monotonic() + 300.0
            assert wd.verdict(now=now) == ("stalled", 1)
            report = wd.check(now=now)
            assert report is not None and got == [report]
            assert report["stalled"][0]["compiling"] is True
        finally:
            reg.exit(tok)
        tok = reg.enter("dispatch", "hash_probe")
        try:
            assert wd.verdict(now=time.monotonic() + 10.0) == ("stalled", 1)
        finally:
            reg.exit(tok)
    assert wd.verdict()[0] == "ok"


def test_watchdog_compile_threshold_defaults_to_10x():
    wd = StallWatchdog(registry=tracing.InflightRegistry(), stall_s=3.0)
    assert wd.compile_stall_s == pytest.approx(30.0)
    assert wd.compile_stall_s == JT.StallWatchdog(registry=JT.InflightRegistry(),
                                                  stall_s=3.0).compile_stall_s


def test_launch_that_builds_holds_a_compiling_dispatch_entry(monkeypatch):
    """The launch chokepoint on the CPU: with the libraries unbuilt, the
    launch holds a ``dispatch`` entry flagged ``compiling`` around the build
    (here one that records each library) and the C entry's call; the build
    charges the statement's counters under the kernel's site; the next
    launch is warm.  A failing C entry raises."""
    seen = []
    calls = []

    def fake_build(site="build"):
        seen.append(("build", tracing.INFLIGHT.snapshot()))
        for lib in ("compact_rows.cu", "hash_insert.cu"):
            tracing.record_compile(0.5, site=site, signature="d", sig_key="d",
                                   exe_bytes=1, library=lib, cached=False)
        monkeypatch.setitem(ck._entries, "trino_compact_rows",
                            lambda *a: calls.append(a) or 0)

    monkeypatch.setattr(ck, "build_kernels", fake_build)
    monkeypatch.delitem(ck._entries, "trino_compact_rows", raising=False)
    monkeypatch.setattr(tracing, "DISPATCH_TEST_HOOK",
                        lambda label: seen.append(("hook", label)))
    c = QueryCounters()
    before = ck.STATS["compact_rows"].launches
    with tracing.track_counters(c), tracing.query_scope("q1"), \
            tracing.operator_scope("Filter#0", None):
        ck._launch("compact_rows", "trino_compact_rows", (8, 8, (8,)), 1, 2)
        ck._launch("compact_rows", "trino_compact_rows", (8, 8, (8,)), 3)
    assert seen[0] == ("hook", "Filter#0/compact_rows")
    (entry,) = seen[1][1]
    assert entry["kind"] == "dispatch" and entry["compiling"] is True
    assert entry["label"] == "Filter#0/compact_rows" and entry["query_id"] == "q1"
    assert [s[0] for s in seen] == ["hook", "build", "hook"]
    assert calls == [(1, 2), (3,)]
    assert c.compiles == 2 and c.launches == {"compact_rows": 2}
    assert c.sites["Filter#0/compact_rows"]["compiles"] == 2
    assert ck.STATS["compact_rows"].launches == before + 2
    assert tracing.INFLIGHT.depth() == 0
    monkeypatch.setitem(ck._entries, "trino_compact_rows", lambda *a: 700)
    with pytest.raises(RuntimeError, match="compact_rows launch failed"):
        ck._launch("compact_rows", "trino_compact_rows", (8, 8, (8,)))
    assert tracing.INFLIGHT.depth() == 0


def test_build_after_the_libraries_are_loaded_records_nothing(monkeypatch):
    """A thread that loses the race to build (every entry already loaded
    when it takes the build lock) returns at once: it runs no nvcc, loads
    nothing and adds no build record to the log or to its statement."""
    for entry in ck._SIGNATURES:
        monkeypatch.setitem(ck._entries, entry, lambda *a: 0)
    monkeypatch.setattr(ck, "_nvcc", lambda: pytest.fail("nvcc was called"))
    log = CompileLog()
    monkeypatch.setattr(tracing, "COMPILE_LOG", log)
    c = QueryCounters()
    with tracing.track_counters(c), tracing.query_scope("q2"):
        got = ck.build_kernels(site="hash_probe")
    assert got == {"seconds": 0.0, "log": {}, "libraries": {}}
    assert log.snapshot() == [] and c.compiles == 0 and c.compile_s == 0


# -------------------------------------------------------------- engine layer
def test_flight_record_carries_compile_census(engine):
    s = engine.create_session("tpch")
    tracing.DISPATCH_TEST_HOOK = _BuildOnce()
    engine.execute_sql("select count(*) from orders where o_orderkey > 7", s)
    tracing.DISPATCH_TEST_HOOK = None
    qid = engine.last_query_trace["query_id"]
    assert engine.last_query_counters["compiles"] == 1
    rec = engine.flight_recorder.get(qid)
    assert rec["compiles"] == 1 and rec["compile_s"] == pytest.approx(1.25)
    (ev,) = rec["compile_events"]
    assert ev["query_id"] == qid and ev["signature"] and ev["library"] == "hash_insert.cu"
    assert rec["wall_breakdown"]["compile"] > 0
    # a warm statement records no build
    engine.execute_sql("select count(*) from orders where o_orderkey > 7", s)
    assert engine.last_query_counters["compiles"] == 0
    assert engine.flight_recorder.snapshot(kind="query")[-1]["compile_events"] == []


def test_explain_analyze_compile_line(engine):
    s = engine.create_session("tpch")
    tracing.DISPATCH_TEST_HOOK = _BuildOnce(0.5)
    r = engine.execute_sql("explain analyze select count(*) from nation", s)
    tracing.DISPATCH_TEST_HOOK = None
    text = "\n".join(str(row[0]) for row in r.rows())
    m = re.search(r"Compile: (\d+) compilations, ([0-9.]+)s", text)
    assert m, text
    assert int(m.group(1)) == 1 and float(m.group(2)) == pytest.approx(0.5)
    r = engine.execute_sql("explain analyze select count(*) from nation", s)
    assert "Compile:" not in "\n".join(str(row[0]) for row in r.rows())


def test_system_runtime_compilations_table(engine):
    s = engine.create_session("tpch")
    tracing.DISPATCH_TEST_HOOK = _BuildOnce()
    engine.execute_sql(QUERY, s)
    tracing.DISPATCH_TEST_HOOK = None
    qid = engine.last_query_trace["query_id"]
    rows = engine.execute_sql("select site, label, query_id, signature, duration_s, "
                              "exe_bytes from system.compilations", s).rows()
    mine = [r for r in rows if r[2] == qid]
    assert mine and mine[0][0] == "hash_insert" and "/" in mine[0][1]
    assert mine[0][4] == pytest.approx(1.25) and mine[0][5] == 4096


def test_query_log_compile_columns(engine):
    s = engine.create_session("tpch")
    tracing.DISPATCH_TEST_HOOK = _BuildOnce()
    engine.execute_sql(QUERY, s)
    tracing.DISPATCH_TEST_HOOK = None
    cold = engine.last_query_trace["query_id"]
    engine.execute_sql(QUERY, s)
    warm = engine.last_query_trace["query_id"]
    rows = {r[0]: r for r in engine.execute_sql(
        "select query_id, compiles, compile_s from system.query_log", s).rows()}
    assert rows[cold][1] == 1 and rows[cold][2] > 0
    assert rows[warm][1] == 0


# ---------------------------------------------------------------- HTTP layer
@pytest.fixture(scope="module")
def server(engine):
    srv = CoordinatorServer(engine, port=0)
    srv.start()
    yield srv
    srv.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_v1_compiles_endpoint(server, engine):
    tracing.DISPATCH_TEST_HOOK = _BuildOnce()
    engine.execute_sql(QUERY, engine.create_session("tpch"))
    tracing.DISPATCH_TEST_HOOK = None
    payload = _get(server.url + "/v1/compiles")
    assert payload["info"]["compiles_total"] > 0
    assert payload["info"]["storm_threshold_sigs"] > 0
    recs = payload["records"]
    assert recs
    for r in recs:
        assert {"site", "label", "query_id", "signature", "duration_s", "exe_bytes",
                "at", "library", "cached"} <= set(r)


def test_metrics_compile_series_strict_parse(server, engine):
    from test_profiling import _parse_prometheus

    tracing.DISPATCH_TEST_HOOK = _BuildOnce()
    engine.execute_sql("select count(*) from region", engine.create_session("tpch"))
    tracing.DISPATCH_TEST_HOOK = None
    parsed = _parse_prometheus(urllib.request.urlopen(
        server.url + "/v1/metrics", timeout=10).read().decode())
    assert parsed["types"]["trino_tpu_compiles_total"] == "counter"
    assert parsed["samples"]["trino_tpu_compiles_total"][0][1] > 0
    assert parsed["types"]["trino_tpu_recompile_storms_total"] == "counter"
    assert parsed["types"]["trino_tpu_compiling_dispatches"] == "gauge"
    assert parsed["samples"]["trino_tpu_compiling_dispatches"][0][1] == 0
    assert parsed["types"]["trino_tpu_compile_seconds"] == "histogram"
    buckets = parsed["samples"]["trino_tpu_compile_seconds_bucket"]
    assert buckets[-1][0].get("le") == "+Inf"
    counts = [v for _, v in buckets]
    assert counts == sorted(counts)
    assert counts[-1] == parsed["samples"]["trino_tpu_compile_seconds_count"][0][1]
    assert parsed["samples"]["trino_tpu_compile_seconds_sum"][0][1] > 0


def test_status_health_reports_compiling(server, engine):
    wd = engine.stall_watchdog
    saved = (wd.stall_s, wd.compile_stall_s)
    wd.stall_s, wd.compile_stall_s = 0.05, 60.0
    tok = engine.inflight.enter("dispatch", "hash_insert", compiling=True)
    try:
        time.sleep(0.1)
        st = _get(server.url + "/v1/status")
        assert st["health"]["status"] == "compiling"
        assert st["health"]["compiling"] >= 1 and st["health"]["stalled"] == 0
        entries = [e for e in st["inflight"] if e["site"] == "hash_insert"]
        assert entries and entries[0]["compiling"] is True
    finally:
        engine.inflight.exit(tok)
        wd.stall_s, wd.compile_stall_s = saved
    assert engine.health()["status"] == "ok"
