"""The port's flight recorder (``trino_tpu_torch/execution/flightrecorder.py``
and the engine's ``_record_flight``) against the JAX package on the CPU.

Restates tests/test_flight_recorder.py at SF0.01: the wall breakdown's sweep
and the pressure rung against the reference's functions; the on-disk ring's
eviction and a torn tail read back as the reference's reader reads them; a
record per completed and per errored statement; a recorder that raises
never fails the statement; stall reports folded in as events; the completed
statement's trace served from the recorder after the live tracer lost it;
``/v1/flight``, ``/v1/flight/{id}``, ``system.runtime.query_log`` and the
recorder's metric families.  Adds parity with the reference: for bench.py's
five queries and one erroring statement, both packages' records agree on
the key set, ``state``, ``error``, the normalized ``sql``, ``rows``, the
plan actuals (per node: operator, estimate, actual rows, the unestimated
marker, split count) and ``pressure_rung``; the ``query_log`` and
``compilations`` columns, and the key sets of ``/v1/flight``,
``/v1/flight/{id}`` and ``/v1/status``, are the reference's.  And the
budget contract of tests/test_query_budgets.py: with the recorder on and
off, each of bench.py's five reads the host as often, moves as many bytes
and launches as many kernels.  A child process that runs bench.py's five
into a disk ring and is killed with SIGKILL leaves all five records
readable.

And the chaos record: a statement failed by an injected ``fatal`` at
``dispatch`` leaves a FAILED record naming the fault with its firing
counted, as the reference's does, and the leak check is clean after it.

The stitched cluster trace is restated in tests/test_torch_cluster.py.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.execution import flightrecorder as JFR
from trino_tpu.execution import tracing as JT
from trino_tpu.server.server import CoordinatorServer as JaxServer
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution import flightrecorder as FR
from trino_tpu_torch.execution import tracing as T
from trino_tpu_torch.server.server import CoordinatorServer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import chip_smoke  # noqa: E402  (the statement corpora; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 11
QUERY = """select l_returnflag, sum(l_quantity) q, count(*) c
           from lineitem where l_shipdate <= date '1998-09-02'
           group by l_returnflag order by l_returnflag"""
ERROR_Q = "select no_such_column from lineitem"
STATEMENTS = {**chip_smoke.QUERIES, "error": ERROR_Q}
PARITY_FIELDS = ("state", "error", "sql", "rows", "pressure_rung")


def _engine():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _run(e, sql):
    """The flight record of one statement (raised or not)."""
    s = e.create_session("tpch")
    try:
        e.execute_sql(sql, s)
    except Exception:  # noqa: BLE001 - the errored statement's record is wanted
        pass
    return e.flight_recorder.snapshot(kind="query")[-1]


@pytest.fixture(scope="module")
def records():
    """Each statement's record from both packages: {name: (jax, torch)}."""
    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    t = _engine()
    out = {name: (_run(j, sql), _run(t, sql)) for name, sql in STATEMENTS.items()}
    j._invalidate()
    return out


# ---------------------------------------------------------------- unit layer
def _span(name, start, end, span_id=None, parent=None, trace="q"):
    return {"name": name, "trace_id": trace, "span_id": span_id or id(name),
            "parent_id": parent, "start_s": start, "end_s": end,
            "attributes": {}, "status": "OK"}


def test_wall_breakdown_buckets_and_sum():
    spans = [
        _span("query", 0.0, 10.0, span_id=1),
        _span("planner", 0.5, 1.5, span_id=2, parent=1),
        _span("dispatch", 2.0, 5.0, span_id=3, parent=1),
        _span("prefetch", 4.0, 6.0, span_id=4, parent=1),
        _span("host_pull", 7.0, 8.0, span_id=5, parent=1),
        _span("compile", 8.5, 9.0, span_id=6, parent=1),
    ]
    assert T.WALL_BUCKETS == JT.WALL_BUCKETS
    bd = T.wall_breakdown(spans, queued_s=0.25)
    assert bd == JT.wall_breakdown(spans, queued_s=0.25)
    assert bd["h2d"] == pytest.approx(1.0) and bd["compile"] == pytest.approx(0.5)
    assert sum(bd[b] for b in T.WALL_BUCKETS) == pytest.approx(bd["wall_s"], rel=1e-6)
    assert T.wall_breakdown(spans, window=(2.0, 6.0)) == \
        JT.wall_breakdown(spans, window=(2.0, 6.0))
    assert T.wall_breakdown([_span("dispatch", 0, 1)]) is None
    assert T.format_wall_breakdown(bd) == JT.format_wall_breakdown(bd)


@pytest.mark.parametrize("counters", [
    None, {}, {"admission_queued": 1}, {"spill_tier_hbm": 10},
    {"spill_tier_hbm": 1, "spill_tier_disk": 2}, {"spill_tier_host": 3}])
def test_pressure_rung_equals_the_reference(counters):
    assert FR.pressure_rung(counters) == JFR.pressure_rung(counters)


def test_summaries_equal_the_reference():
    rec = {"counters": {"compiles": 2, "compile_s": 1.5,
                        "shard_stats": [{"ratio": 2.0, "imbalance_s": 0.5}]}}
    for r in (None, {}, rec, {"compiles": 3, "compile_s": 0.25}):
        assert FR.summarize_compiles(r) == JFR.summarize_compiles(r)
        assert FR.summarize_skew(r) == JFR.summarize_skew(r)


def test_recorder_ring_eviction_and_dead_process_readback(tmp_path):
    """A tiny byte budget keeps the disk ring bounded, evicts the oldest,
    keeps the newest; a fresh reader, the port's and the reference's alike,
    sees what is on disk and skips a torn tail."""
    d = str(tmp_path / "flight")
    fr = FR.FlightRecorder(flight_dir=d, disk_budget=4000, max_records=16)
    pad = "x" * 300
    for i in range(40):
        fr.record_query({"query_id": f"q{i}", "state": "FINISHED", "sql": pad,
                         "wall_s": 0.1})
    assert fr.disk_evictions > 0
    assert fr.disk_bytes() <= 4000 + 4000 // 8 + 600
    recs = FR.read_flight_dir(d)
    ids = [r["query_id"] for r in recs]
    assert "q39" in ids and "q0" not in ids
    assert ids == sorted(ids, key=lambda q: int(q[1:]))
    segs = sorted(p for p in os.listdir(d) if p.endswith(".jsonl"))
    with open(os.path.join(d, segs[-1]), "ab") as f:
        f.write(b'{"query_id": "torn...')
    assert [r["query_id"] for r in FR.read_flight_dir(d)] == ids
    assert FR.read_flight_dir(d) == JFR.read_flight_dir(d)
    assert len(fr.snapshot()) == 16
    # the reference's recorder under the same budget keeps the same records
    jd = str(tmp_path / "jflight")
    jfr = JFR.FlightRecorder(flight_dir=jd, disk_budget=4000, max_records=16)
    for i in range(40):
        jfr.record_query({"query_id": f"q{i}", "state": "FINISHED", "sql": pad,
                          "wall_s": 0.1})
    assert [r["query_id"] for r in JFR.read_flight_dir(jd)] == ids
    assert fr.info().keys() == jfr.info().keys()


_CHILD = """
import os, sys
sys.path.insert(0, {root!r})
import chip_smoke
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
e = Engine(device="cpu")
e.register_catalog("tpch", TpchConnector(sf={sf}, split_rows={split}))
s = e.create_session("tpch")
for sql in chip_smoke.QUERIES.values():
    e.execute_sql(sql, s)
print("ran", flush=True)
os.kill(os.getpid(), 9)
"""


def test_dead_process_ring_reads_back(tmp_path):
    """A process that runs bench.py's five into a disk ring and dies by
    SIGKILL: both packages' readers read the five records back."""
    d = str(tmp_path / "ring")
    env = dict(os.environ, TRINO_TPU_FLIGHT_DIR=d)
    p = subprocess.run([sys.executable, "-c", _CHILD.format(
        root=_ROOT, sf=SF, split=SPLIT_ROWS)], env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    assert "ran" in p.stdout
    recs = [r for r in FR.read_flight_dir(d) if r.get("kind") == "query"]
    assert [r["state"] for r in recs] == ["FINISHED"] * len(chip_smoke.QUERIES)
    norm = [_normalized(sql) for sql in chip_smoke.QUERIES.values()]
    assert [r["sql"] for r in recs] == norm
    assert FR.read_flight_dir(d) == JFR.read_flight_dir(d)


def _normalized(sql):
    from trino_tpu_torch.engine import _normalize_statement

    return _normalize_statement(sql)


# --------------------------------------------------------- parity per statement
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_records_equal_the_reference(records, name):
    j, t = records[name]
    assert set(t) == set(j)
    for f in PARITY_FIELDS:
        assert t[f] == j[f], (f, t[f], j[f])
    if name == "error":
        assert t["state"] == "FAILED" and "no_such_column" in t["error"]
        assert t["plan_actuals"] is None and j["plan_actuals"] is None
    else:
        assert t["state"] == "FINISHED" and t["error"] is None
        assert set(t["plan_actuals"]) == set(j["plan_actuals"])
        assert chip_smoke.record_view(t["plan_actuals"]["nodes"]) == \
            chip_smoke.record_view(j["plan_actuals"]["nodes"])
    assert set(t["wall_breakdown"]) == set(j["wall_breakdown"])
    assert set(t["trace"]) == set(j["trace"])


def test_record_shape_success_and_error(engine):
    s = engine.create_session("tpch")
    engine.execute_sql(QUERY, s)
    qid = engine.last_query_trace["query_id"]
    rec = engine.flight_recorder.get(qid)
    assert rec is not None and rec["kind"] == "query"
    assert rec["state"] == "FINISHED" and rec["error"] is None
    assert rec["counters"]["host_reads"] > 0 and rec["counters"]["sites"]
    assert rec["trace"]["spans"] and rec["trace"]["root_span_s"] > 0
    assert rec["sql"].startswith("select")
    bd = rec["wall_breakdown"]
    assert bd and abs(sum(bd[b] for b in T.WALL_BUCKETS) - bd["wall_s"]) <= 0.05 * bd["wall_s"]
    before = engine.flight_recorder.records_total
    with pytest.raises(Exception):
        engine.execute_sql(ERROR_Q, s)
    assert engine.flight_recorder.records_total == before + 1
    err = engine.flight_recorder.snapshot(kind="query")[-1]
    assert err["state"] == "FAILED" and "no_such_column" in err["error"]


def test_chaos_fatal_injection_record_and_leak_clean():
    """The flight record of a statement that an injected ``fatal`` failed
    is present and typed in both packages, and the engine passes the
    chaos leak check after it."""
    from trino_tpu.execution import faults as jfaults
    from trino_tpu_torch.execution import faults
    from trino_tpu_torch.execution.chaos_matrix import leak_report

    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    recs = []
    for e, mod in ((j, jfaults), (_engine(), faults)):
        s = e.create_session("tpch")
        e.execute_sql(QUERY, s)  # warm
        with mod.injected("point=dispatch,action=fatal,nth=1"):
            with pytest.raises(mod.FatalInjectedFaultError):
                e.execute_sql(QUERY, s)
        recs.append(e.flight_recorder.snapshot(kind="query")[-1])
    jrec, rec = recs
    for r in recs:
        assert r["state"] == "FAILED"
        # typed: the record carries the raised error's text, which names
        # the point and the rule
        assert "injected fatal at dispatch" in (r["error"] or "")
        assert r["counters"]["faults_injected"] == 1
    assert rec["error"].split("(")[-1] == jrec["error"].split("(")[-1]
    assert not leak_report(e), leak_report(e)
    e._invalidate()
    j._invalidate()


def test_recorder_failure_never_fails_query(engine):
    fr = engine.flight_recorder
    orig = fr.record_query
    calls = []

    def boom(rec):
        calls.append(rec)
        raise RuntimeError("disk full")

    fr.record_query = boom
    try:
        res = engine.execute_sql("select count(*) from nation", engine.create_session("tpch"))
        assert res.rows()[0][0] == 25
        assert calls, "the recorder was never consulted"
    finally:
        fr.record_query = orig
    bad = FR.FlightRecorder(flight_dir="/nonexistent/\0bad", disk_budget=100, max_records=4)
    assert bad.record_query({"query_id": "q", "state": "FINISHED"}) is None
    assert bad.failures == 1


def test_recorder_off_keeps_nothing(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_FLIGHT_RECORDS", "0")
    e = _engine()
    assert not e.flight_recorder.enabled
    e.execute_sql("select count(*) from region", e.create_session("tpch"))
    assert e.flight_recorder.snapshot() == [] and e.flight_recorder.records_total == 0


def test_stall_reports_fold_into_recorder(engine):
    report = {"detected_at_s": time.time(), "threshold_s": 1.0,
              "stalled": [{"label": "Join#2/hash_probe", "elapsed_s": 9.9}],
              "inflight_depth": 1}
    before = len(engine.flight_recorder.snapshot(kind="stall"))
    engine._on_stall(dict(report))
    stalls = engine.flight_recorder.snapshot(kind="stall")
    assert len(stalls) == before + 1
    assert stalls[-1]["stalled"][0]["label"] == "Join#2/hash_probe"
    assert engine.last_stall_report["threshold_s"] == 1.0
    engine.last_stall_report = None


@pytest.mark.parametrize("q", list(chip_smoke.QUERIES))
def test_recorder_adds_no_read_no_copy_no_launch(q, monkeypatch):
    """The budget contract: each statement's host reads, host bytes, H2D
    bytes and launches are the same with the recorder on and off."""
    on = _engine()
    monkeypatch.setenv("TRINO_TPU_FLIGHT_RECORDS", "0")
    off = _engine()
    assert on.flight_recorder.enabled and not off.flight_recorder.enabled
    got = []
    for e in (on, off):
        s = e.create_session("tpch")
        e.execute_sql(chip_smoke.QUERIES[q], s)  # cold
        e.execute_sql(chip_smoke.QUERIES[q], s)
        c = e.last_query_counters
        got.append({k: c[k] for k in ("host_reads", "host_bytes", "h2d_bytes", "launches")})
    assert got[0] == got[1]
    assert len(on.flight_recorder.snapshot(kind="query")) == 2


@pytest.mark.parametrize("table", ["query_log", "compilations"])
def test_system_table_columns_equal_the_reference(engine, tpch_sf001, table):
    j = JaxEngine()
    j.register_catalog("tpch", tpch_sf001)
    js = j.catalogs["system"].schema(table)
    ts = engine.catalogs["system"].schema(table)
    assert [f.name for f in ts.fields] == [f.name for f in js.fields]
    assert [f.type.name for f in ts.fields] == [f.type.name for f in js.fields]


# ------------------------------------------------------------- HTTP surfaces
@pytest.fixture(scope="module")
def servers(engine, tpch_sf001):
    j = JaxEngine()
    j.register_catalog("tpch", tpch_sf001)
    pair = (JaxServer(j, port=0), CoordinatorServer(engine, port=0))
    for srv in pair:
        srv.start()
    yield pair
    for srv in pair:
        srv.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_trace_endpoint_serves_completed_statements_from_recorder(servers, engine):
    srv = servers[1]
    s = engine.create_session("tpch")
    engine.execute_sql(QUERY, s)
    qid = engine.last_query_trace["query_id"]
    engine.execute_sql("select count(*) from region", s)
    with engine.tracer._lock:
        engine.tracer.finished.clear()
    payload = _get(srv.url + f"/v1/query/{qid}/trace")
    spans = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert {"query", "execution"} <= {sp["name"] for sp in spans}
    roots = [sp for sp in spans if sp["parentSpanId"] == ""]
    assert len(roots) == 1 and roots[0]["name"] == "query"


def test_flight_http_endpoints_and_query_log(servers, engine):
    srv = servers[1]
    s = engine.create_session("tpch")
    engine.execute_sql(QUERY, s)
    qid = engine.last_query_trace["query_id"]
    idx = _get(srv.url + "/v1/flight")
    assert idx["info"]["enabled"] and idx["info"]["records"] > 0
    assert any(r["query_id"] == qid for r in idx["records"])
    rec = _get(srv.url + f"/v1/flight/{qid}")
    assert rec["state"] == "FINISHED" and rec["wall_breakdown"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(srv.url + "/v1/flight/nope", timeout=10)
    assert exc.value.code == 404
    rows = engine.execute_sql(
        "select query_id, state, device_dispatches, plan_s, unattributed_s "
        "from system.query_log", s).rows()
    mine = [row for row in rows if row[0] == qid]
    assert mine and mine[0][1] == "FINISHED" and mine[0][2] > 0
    assert mine[0][4] is not None


def test_http_key_sets_equal_the_reference(servers):
    for srv in servers:
        e = srv.engine
        e.execute_sql(QUERY, e.create_session("tpch"))
    j, t = ([_get(srv.url + "/v1/flight") for srv in servers])
    assert set(t) == set(j) and set(t["info"]) == set(j["info"])
    assert set(t["records"][-1]) == set(j["records"][-1])
    jq, tq = (x["records"][-1]["query_id"] for x in (j, t))
    assert set(_get(servers[1].url + f"/v1/flight/{tq}")) == \
        set(_get(servers[0].url + f"/v1/flight/{jq}"))
    js, ts = (_get(srv.url + "/v1/status") for srv in servers)
    assert set(ts) == set(js)
    assert set(ts["health"]) == set(js["health"])
    assert set(ts["health"]["watchdog"]) == set(js["health"]["watchdog"])
    jc, tc = (_get(srv.url + "/v1/compiles") for srv in servers)
    assert set(tc) == set(jc) and set(tc["info"]) == set(jc["info"])


def test_metrics_flight_series(servers, engine):
    from test_profiling import _parse_prometheus

    engine.execute_sql("select count(*) from nation", engine.create_session("tpch"))
    body = urllib.request.urlopen(servers[1].url + "/v1/metrics", timeout=10).read().decode()
    parsed = _parse_prometheus(body)
    assert parsed["types"]["trino_tpu_flight_records"] == "gauge"
    assert parsed["samples"]["trino_tpu_flight_records"][0][1] > 0
    assert parsed["types"]["trino_tpu_flight_disk_bytes"] == "gauge"
    assert parsed["types"]["trino_tpu_flight_records_total"] == "counter"
    assert parsed["samples"]["trino_tpu_flight_records_total"][0][1] > 0
    assert parsed["types"]["trino_tpu_flight_spans_total"] == "counter"
    assert parsed["samples"]["trino_tpu_flight_spans_total"][0][1] > 0
    assert parsed["types"]["trino_tpu_flight_worker_spans_total"] == "counter"
    assert parsed["types"]["trino_tpu_flight_record_failures_total"] == "counter"
