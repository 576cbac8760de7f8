"""The port's per-node execution stats and plan history
(``trino_tpu_torch/exec/local_executor.py`` ``stats`` / ``boundary``,
``trino_tpu_torch/execution/history.py``) against the JAX package on the CPU.

Restates tests/test_plan_history.py at SF0.01: the store's unit cases (node
paths, misestimate arithmetic, LRU, EWMA) against the port's module; warm
runs accumulating on one fingerprint while the statement's counters stay
still; the misestimating filter's ``over`` ratio; ``system.runtime.
plan_history``, ``GET /v1/history``, the ``/v1/metrics`` families and the
completion event's payload; a disabled store.
Adds parity with the reference over bench.py's five queries and this file's
statements: the records both packages' ``collect_plan_actuals`` give (paths,
op, estimate, actual rows, the unestimated marker, split counts) are equal,
and so are the EXPLAIN ANALYZE plan lines and the ``Misestimates:`` line
once each node's wall and boundary counts are masked.  Also the port's own:
the batched read of the row counts, the engine's plan memo (a warm statement
walks neither estimation nor the fingerprint again; ``_invalidate`` clears
it; a one-off plan stays out of it), and the per-operator boundary records summing to the run's counters.

The cluster harvest is restated in tests/test_torch_cluster.py.  The stall
watchdog's case is in tests/test_torch_stall.py.
"""

import os
import sys
import threading

import pytest
import torch

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution import history as H

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the statement corpora; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 11

AGG_Q = """select l_returnflag, l_linestatus, sum(l_quantity) qty, count(*) c
           from lineitem where l_shipdate <= date '1998-09-02'
           group by l_returnflag, l_linestatus
           order by l_returnflag, l_linestatus"""

# correlated range predicates the CBO multiplies as independent, while the
# conjunction is unsatisfiable: the canonical over-estimate
MIS_Q = ("select c_custkey from customer "
         "where c_custkey > 1000 and c_custkey < 50")

PARITY = {**chip_smoke.QUERIES, "agg": AGG_Q, "mis": MIS_Q,
          "region": "select count(*) from region",
          "probe": chip_smoke.ADAPTIVE_PROBE, "probe_hash": chip_smoke.ADAPTIVE_PROBE_HASH}


def _engine():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return e


@pytest.fixture(scope="module")
def engine():
    return _engine()


# ------------------------------------------------------------------ unit layer
def test_node_paths_structural_and_translation():
    from trino_tpu_torch.page import Field, Schema
    from trino_tpu_torch.sql import plan as P
    from trino_tpu_torch.types import BIGINT

    sch = Schema((Field("a", BIGINT),))
    scan = P.TableScan("c", "t", ("a",), sch)
    filt = P.Filter(scan, None)
    lim = P.Limit(filt, 5)
    paths = H.plan_node_paths(lim)
    assert paths[id(lim)] == "Limit#0"
    assert paths[id(filt)] == "Filter#0.0"
    assert paths[id(scan)] == "TableScan#0.0.0"
    # structurally equal trees give equal paths (what lets records merge)
    again = P.Limit(P.Filter(P.TableScan("c", "t", ("a",), sch), None), 5)
    assert sorted(H.plan_node_paths(again).values()) == sorted(paths.values())
    assert H.translate_path("Filter#0", "0.2") == "Filter#0.2"
    assert H.translate_path("Filter#0.1.0", "0.2") == "Filter#0.2.1.0"


def test_misestimate_arithmetic():
    assert H.misestimate(100, 10) == (10.0, "over")
    assert H.misestimate(10, 100) == (10.0, "under")
    assert H.misestimate(7, 7) == (1.0, "exact")
    assert H.misestimate(50, 0) == (50.0, "over")  # an empty actual clamps at 1


def _rec(actual=5, est=10.0, wall=0.0):
    return {"op": "Filter", "est_rows": est, "actual_rows": actual, "wall_s": wall,
            "spilled_bytes": 0, "spill_tiers": {}, "cache_hits": 0}


def test_store_bounded_and_lru():
    st = H.PlanHistoryStore(max_plans=2)
    for fp in ("a", "b", "c"):
        st.record(fp, {"Filter#0": _rec()})
    assert st.get("a") is None  # the oldest went
    assert st.get("b") is not None and st.get("c") is not None
    st.record("b", {"Filter#0": _rec()})  # touch b; d then pushes c out
    st.record("d", {"Filter#0": _rec()})
    assert st.get("c") is None and st.get("b") is not None
    disabled = H.PlanHistoryStore(max_plans=0)
    assert disabled.record("x", {"Filter#0": _rec()}) is None
    assert not disabled.enabled


def test_store_ewma_and_misestimate_counter():
    st = H.PlanHistoryStore(max_plans=4)
    st.record("f", {"Agg#0": _rec(actual=10, est=100.0, wall=0.1)})
    node = st.get("f")["nodes"]["Agg#0"]
    assert node["actual_rows_ewma"] == 10.0  # the first observation seeds it
    assert node["misestimate_ratio"] == 10.0 and node["direction"] == "over"
    assert st.misestimates_total == 1
    st.record("f", {"Agg#0": _rec(actual=30, est=100.0, wall=0.1)})
    node = st.get("f")["nodes"]["Agg#0"]
    assert node["executions"] == 2 and node["actual_rows"] == 30
    assert node["actual_rows_ewma"] == pytest.approx(0.25 * 30 + 0.75 * 10)
    assert st.misestimates_total == 2
    assert st.worst_ratio() == node["misestimate_ratio"]


def test_env_caps_and_disables_the_store(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PLAN_HISTORY", "3")
    assert H.PlanHistoryStore().max_plans == 3
    monkeypatch.setenv("TRINO_TPU_PLAN_HISTORY", "0")
    e = _engine()
    assert not e.plan_history.enabled
    e.execute_sql(AGG_Q, e.create_session("tpch"))
    assert e.plan_history.snapshot() == [] and e.last_plan_actuals is None


def test_row_counts_read_in_one_batched_copy():
    """Python ints pass through, 0-d tensors are stacked and read together;
    nothing is charged to the executor's host reads."""
    vals = [3, torch.tensor(7, dtype=torch.int64), 0, torch.tensor(11, dtype=torch.int32)]
    assert H._read_counts(vals) == [3, 7, 0, 11]


# ------------------------------------------------------------------ engine layer
def test_records_accumulate_across_threads_and_warm_runs(engine):
    ph = engine.plan_history
    errs = []

    def run(sess):
        try:
            engine.execute_sql(AGG_Q, sess)
        except Exception as e:  # pragma: no cover - surfaced by the assert below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(engine.create_session("tpch"),))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    payload = engine.last_plan_actuals
    assert payload is not None and set(payload) == {"fingerprint", "nodes"}
    ent = next(e for e in ph.snapshot() if e["fingerprint"] == payload["fingerprint"])
    base = ent["executions"]
    assert base >= 2
    for path, rec in ent["nodes"].items():
        op, _, chain = path.partition("#")
        assert rec["op"] == op and chain.startswith("0"), path
        assert rec["actual_rows"] >= 0
    # warm re-executions: executions bump, the statement's counters do not move
    s = engine.create_session("tpch")
    engine.execute_sql(AGG_Q, s)
    warm1 = engine.last_query_counters
    engine.execute_sql(AGG_Q, s)
    warm2 = engine.last_query_counters
    for k in ("device_dispatches", "host_transfers", "host_bytes_pulled", "h2d_bytes"):
        assert warm2[k] == warm1[k], k
    ent2 = next(e for e in ph.snapshot() if e["fingerprint"] == payload["fingerprint"])
    assert ent2["executions"] == base + 2


def test_history_costs_no_host_read(monkeypatch):
    """The same statement reads the host as often with the store off."""
    counts = []
    for cap in ("256", "0"):
        monkeypatch.setenv("TRINO_TPU_PLAN_HISTORY", cap)
        e = _engine()
        s = e.create_session("tpch")
        for _ in range(2):
            e.execute_sql(chip_smoke.QUERIES["q3"], s)
        c = e.last_query_counters
        counts.append((c["host_reads"], c["host_bytes"], c["device_dispatches"]))
    assert counts[0] == counts[1]


def test_misestimating_filter_pins_over_ratio(engine):
    s = engine.create_session("tpch")
    assert len(engine.execute_sql(MIS_Q, s)) == 0  # genuinely empty
    payload = engine.last_plan_actuals
    ent = next(e for e in engine.plan_history.snapshot()
               if e["fingerprint"] == payload["fingerprint"])
    top = max(ent["nodes"].values(), key=lambda r: r["misestimate_ratio"])
    assert top["misestimate_ratio"] > 1.0
    assert top["direction"] == "over" and top["actual_rows"] == 0
    assert top["est_rows"] and top["est_rows"] > 1
    assert engine.plan_history.misestimates_total >= 1
    assert engine.plan_history.worst_ratio() >= top["misestimate_ratio"]


def test_explain_analyze_annotations_and_summary(engine):
    s = engine.create_session("tpch")
    text = "\n".join(r[0] for r in engine.execute_sql(f"explain analyze {MIS_Q}", s).rows())
    assert "[est " in text and "x actual " in text, text
    mis = next(l for l in text.splitlines() if l.startswith("Misestimates:"))
    assert "#" in mis and "over" in mis
    text2 = "\n".join(r[0] for r in engine.execute_sql(
        "explain analyze select count(*) from region", s).rows())
    assert "Misestimates:" not in text2, text2
    assert "[rows: 1, " in text2 and "site Result/result" in text2


def test_system_table_and_event_payload(engine):
    from trino_tpu_torch.execution.eventlistener import EventListener

    s = engine.create_session("tpch")
    engine.execute_sql(MIS_Q, s)
    seen = []

    class L(EventListener):
        def query_completed(self, ev):
            seen.append(ev)

    listener = L()
    engine.event_listeners.add(listener)
    try:
        rows = engine.execute_sql(
            "select fingerprint, node_path, op, executions, est_rows, "
            "actual_rows, misestimate_ratio, direction "
            "from system.runtime.plan_history", s).rows()
    finally:
        engine.event_listeners.listeners.remove(listener)
    assert rows, "system.runtime.plan_history is empty"
    assert "over" in {r[7] for r in rows}
    assert any(r[1].startswith(("Project#", "Filter#")) for r in rows)
    # the completion event of the system-table query carries its own payload
    ev = seen[-1]
    assert ev.plan_actuals is not None
    assert set(ev.plan_actuals) == {"fingerprint", "nodes"}
    assert ev.adaptive is None


def test_history_endpoint_and_metrics(engine):
    """GET /v1/history serves the store (the JSON twin of the system
    table), and /v1/metrics the reference's history and advisor families."""
    import json
    import urllib.request

    from trino_tpu_torch.server import CoordinatorServer

    engine.execute_sql(MIS_Q, engine.create_session("tpch"))
    srv = CoordinatorServer(engine, port=0)
    srv.start()
    try:
        with urllib.request.urlopen(srv.url + "/v1/history", timeout=60) as r:
            hist = json.loads(r.read())
        with urllib.request.urlopen(srv.url + "/v1/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        srv.stop()
    assert hist["max_plans"] == 256 and hist["misestimates_total"] >= 1
    assert hist["plans"] and hist["worst"][0]["misestimate_ratio"] >= 2.0
    values = {x.split()[0]: float(x.split()[1]) for x in metrics.splitlines()
              if x and not x.startswith("#")}
    assert values["trino_tpu_cardinality_misestimate_ratio"] >= 2.0
    assert values["trino_tpu_misestimated_nodes_total"] >= 1
    for family in ("trino_tpu_adaptive_replans_total", "trino_tpu_adaptive_holds_total",
                   "trino_tpu_adaptive_demotions_total"):
        assert family in values, family


def test_history_disabled_store_records_nothing():
    e = _engine()
    e.plan_history = H.PlanHistoryStore(max_plans=0)
    e.adaptive_advisor.history = e.plan_history
    e.execute_sql(AGG_Q, e.create_session("tpch"))
    assert e.plan_history.snapshot() == []
    assert e.last_plan_actuals is None


def test_plan_memo_walks_each_plan_once(monkeypatch, engine):
    """A warm statement takes its node paths, estimates and fingerprint
    from the engine's memo; ``_invalidate`` clears it."""
    import trino_tpu_torch.exec.local_executor as LE

    calls = {"est": 0, "fp": 0}
    est, fp = H.estimate_plan_rows, LE._plan_fingerprint

    def counted_est(*a, **k):
        calls["est"] += 1
        return est(*a, **k)

    def counted_fp(*a, **k):
        calls["fp"] += 1
        return fp(*a, **k)

    monkeypatch.setattr(H, "estimate_plan_rows", counted_est)
    monkeypatch.setattr(LE, "_plan_fingerprint", counted_fp)
    monkeypatch.setenv("TRINO_TPU_PLAN_TEMPLATES", "0")
    e = _engine()
    s = e.create_session("tpch")
    sql = "select n_name, count(*) c from nation group by n_name"
    for _ in range(3):
        e.execute_sql(sql, s)
    assert calls == {"est": 1, "fp": 1}
    assert len(e._plan_memo) >= 1
    e._invalidate()
    assert len(e._plan_memo) == 0
    e.execute_sql(sql, s)
    assert calls == {"est": 2, "fp": 2}


# ------------------------------------------------------------------ parity with the reference
def test_one_off_plans_stay_out_of_the_plan_memo(monkeypatch):
    """EXPLAIN ANALYZE runs its plan once: its executor computes the paths,
    estimates and fingerprint for that run alone, adds nothing to the
    engine's memo, and still annotates every breaker line."""
    monkeypatch.setenv("TRINO_TPU_PLAN_TEMPLATES", "0")
    e = _engine()
    s = e.create_session("tpch")
    text = "\n".join(r[0] for r in e.execute_sql(f"explain analyze {AGG_Q}", s).rows())
    assert len(e._plan_memo) == 0
    assert "[rows: " in text and "[est " in text
    e.execute_sql(AGG_Q, s)
    assert len(e._plan_memo) == 1


@pytest.fixture(scope="module")
def pair():
    """(reference, port) engines over the same TPC-H; each parity case runs
    only what it compares, so the cases spread over test workers."""
    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    return j, _engine()


@pytest.mark.parametrize("name", sorted(PARITY))
def test_history_records_equal_the_reference(pair, name):
    got = []
    for e in pair:
        e.execute_sql(PARITY[name], e.create_session("tpch"))
        got.append(chip_smoke.record_view(e.last_plan_actuals["nodes"]))
    ref, port = got
    assert port == ref, (name, port, ref)
    assert port, name


@pytest.mark.parametrize("name", sorted(PARITY))
def test_explain_analyze_lines_equal_the_reference(pair, name):
    """The plan lines and the Misestimates line, each node's wall and
    boundary record masked (the packages count launches and reads at their
    own sites, and print a record only where it is not zero)."""
    ref, port = (chip_smoke.masked_plan_lines([r[0] for r in e.execute_sql(
        f"explain analyze {PARITY[name]}", e.create_session("tpch")).rows()])
        for e in pair)
    assert port == ref, (name, port, ref)
    assert any("[rows: " in line for line in port), port


@pytest.mark.parametrize("name", sorted(chip_smoke.QUERIES))
def test_boundary_records_sum_to_the_run_counters(engine, name):
    """Per operator, launches plus host reads, host reads and their bytes
    sum to what the run's ``Device boundary:`` line counts."""
    lines = chip_smoke.explain_lines(engine, chip_smoke.QUERIES[name],
                                     engine.create_session("tpch"))
    totals = chip_smoke.boundary_sums(lines, name)  # raises where they differ
    assert totals[0] > 0 and totals[1] > 0, totals
