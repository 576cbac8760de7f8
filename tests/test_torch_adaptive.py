"""The port's adaptive execution (``trino_tpu_torch/execution/adaptive.py`` and
the engine's consult / observe loop) against the JAX package on the CPU.

Restates tests/test_adaptive.py: its advisor unit cases run against the
port's module with their bodies unchanged; its engine cases (the
misestimated join re-plans, confirms and shows ``partitioned`` and
``Adaptive: replan``, and its decision rides the flight record; a hold
keeps the plan and the counters; the property off never consults); and the
plan-shaping property and the
``TRINO_TPU_ADAPTIVE`` default.  Adds the probe statements of
``chip_smoke.py`` phase 14 (a group-by whose input the CBO under-estimates
16x, on its direct and on its hash path): with ``price_scale = 0`` both
packages emit equal corrections after the first run, a ``capacity`` for the
Aggregate among them, and the corrected run's rows are byte-equal to the
uncorrected run's, in key order (a hash group-by's output order follows its
table's capacity); on the hash path the corrected plan's group-by starts at
the advisor's capacity.  And the port's re-plan price: the planning seconds
of a statement that missed the plan cache.
"""

import os
import sys

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution import history as H
from trino_tpu_torch.execution.adaptive import (AdaptiveAdvisor, correction_token,
                                                describe_decision)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the statement corpora; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

KEY = ("stmt", "tpch", False, "user", ())
JOIN_Q = chip_smoke.ADAPTIVE_JOIN


def _store(nodes, fp="fp-base"):
    st = H.PlanHistoryStore(max_plans=8)
    st.record(fp, nodes)
    return st


def _rec(op="Join", est=100.0, actual=1600, wall=0.2, build=False,
         spill=None, splits=0):
    rec = {"op": op, "est_rows": est, "actual_rows": actual, "wall_s": wall,
           "spilled_bytes": 0, "spill_tiers": dict(spill or {}),
           "cache_hits": 0}
    if build:
        rec["build"] = True
    if splits:
        rec["splits"] = splits
    return rec


def _advisor(store, **kw):
    kw.setdefault("threshold", 4.0)
    kw.setdefault("horizon", 8.0)
    kw.setdefault("cooldown", 2)
    return AdaptiveAdvisor(history=store, compile_log=None, **kw)


def _base(adv, key=KEY, fp="fp-base", wall=0.2, compile_s=0.1):
    """One uncorrected completion: anchors base_fp, wall EWMA and the
    observed cold price."""
    adv.observe(key, fp, corrected=False, wall_s=wall,
                compiles=1, compile_s=compile_s, sql="select 1")


# ------------------------------------------------------------------ unit layer
def test_token_stable_and_order_independent():
    a = correction_token({"rows": {"Join#0.0": 10.0, "Filter#0.1": 5.0}})
    b = correction_token({"rows": {"Filter#0.1": 5.0, "Join#0.0": 10.0}})
    assert a == b and len(a) == 12
    assert a != correction_token({"rows": {"Join#0.0": 11.0}})


def test_no_history_no_opinion():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    assert adv.consult(KEY) is None  # never observed: no state, no opinion
    disabled = AdaptiveAdvisor(history=H.PlanHistoryStore(max_plans=0))
    assert disabled.consult(KEY) is None


def test_under_misestimate_replans_with_frozen_token():
    adv = _advisor(_store({"Join#0.0": _rec(est=100.0, actual=1600)}))
    _base(adv)
    dec = adv.consult(KEY)
    assert dec is not None and dec["verdict"] == "replan"
    assert dec["corrections"]["rows"]["Join#0.0"] == pytest.approx(1600.0)
    assert dec["predicted_win_s"] == pytest.approx(0.18)
    assert dec["compile_price_s"] == pytest.approx(0.1)
    assert dec["token"] and adv.info()["replans_total"] == 1
    again = adv.consult(KEY)
    assert again["token"] == dec["token"]
    assert again["corrections"] == dec["corrections"]
    assert adv.info()["replans_total"] == 1  # no double count
    assert "replan" in describe_decision(dec)
    assert "rows Join#0.0 -> 1600" in describe_decision(dec)


def test_blind_node_never_corrects():
    adv = _advisor(_store({"Join#0.0": _rec(est=None, actual=10 ** 6)}))
    _base(adv)
    assert adv.consult(KEY) is None


def test_over_estimate_corrects_only_join_builds():
    adv = _advisor(_store({"Filter#0.0": _rec(op="Filter", est=5000.0, actual=10)}))
    _base(adv)
    assert adv.consult(KEY) is None
    adv2 = _advisor(_store({"Project#0.1": _rec(op="Project", est=5000.0,
                                                actual=10, build=True)}))
    _base(adv2)
    dec = adv2.consult(KEY)
    assert dec is not None and dec["verdict"] == "replan"
    assert dec["corrections"]["rows"]["Project#0.1"] == pytest.approx(10.0)


def test_hold_when_price_exceeds_win():
    adv = _advisor(_store({"Join#0.0": _rec()}), price_scale=1e9)
    _base(adv)
    dec = adv.consult(KEY)
    assert dec is not None and dec["verdict"] == "hold"
    assert dec["token"] is None
    assert any("compile price" in r for r in dec["reasons"])
    assert adv.info()["holds_total"] == 1 and adv.info()["replans_total"] == 0
    assert describe_decision(dec).startswith("hold")


def test_hold_when_price_unknown():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    adv.observe(KEY, "fp-base", corrected=False, wall_s=0.2)
    dec = adv.consult(KEY)
    assert dec is not None and dec["verdict"] == "hold"
    assert dec["compile_price_s"] is None
    assert any("unknown" in r for r in dec["reasons"])


def test_peek_consult_transitions_nothing():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    _base(adv)
    dec = adv.consult(KEY, peek=True)
    assert dec is not None and dec["verdict"] == "hold"
    assert any("peek" in r for r in dec["reasons"])
    assert adv.info()["holds_total"] == 0 and adv.info()["replans_total"] == 0
    assert adv.consult(KEY)["verdict"] == "replan"


def test_aggregate_capacity_and_grace_corrections():
    adv = _advisor(_store({"Aggregate#0.0": _rec(
        op="Aggregate", est=100.0, actual=50000, spill={"host": 1 << 20})}))
    _base(adv)
    corr = adv.consult(KEY)["corrections"]
    assert corr["capacity"]["Aggregate#0.0"] == 131072
    assert corr["grace_parts"]["Aggregate#0.0"] == 4
    adv2 = _advisor(_store({"Aggregate#0.0": _rec(op="Aggregate", est=100.0,
                                                  actual=50000)}))
    _base(adv2)
    corr2 = adv2.consult(KEY)["corrections"]
    assert corr2["capacity"]["Aggregate#0.0"] == 131072
    assert "grace_parts" not in corr2  # no spill observed: no Grace seed


def test_dispatch_batch_rides_along():
    from trino_tpu_torch.exec.local_executor import _dispatch_batch_default

    cur = _dispatch_batch_default()
    adv = _advisor(_store({
        "Join#0.0": _rec(),
        "TableScan#0.0.0": _rec(op="TableScan", est=None, actual=0, wall=0.0,
                                splits=64)}))
    _base(adv)
    corr = adv.consult(KEY)["corrections"]
    assert corr["dispatch_batch"] == min(16, max(cur, 16))
    assert corr["dispatch_batch"] > cur


def test_probation_confirms_on_warm_no_worse():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    _base(adv)
    assert adv.consult(KEY)["verdict"] == "replan"
    adv.observe(KEY, "fp-corr", corrected=True, wall_s=5.0, compiles=3, compile_s=1.0)
    assert adv.decision_trace()[-1]["state"] == "probation"
    adv.observe(KEY, "fp-corr", corrected=True, wall_s=0.15)
    assert adv.decision_trace()[-1]["state"] == "confirmed"
    assert adv.info()["confirms_total"] == 1
    assert adv.consult(KEY)["verdict"] == "replan"  # still frozen


def test_regression_demotes_then_cooldown_reconsiders():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    _base(adv)
    tok = adv.consult(KEY)["token"]
    adv.observe(KEY, "fp-corr", corrected=True, wall_s=2.0)
    assert adv.info()["demotions_total"] == 1
    dec = adv.consult(KEY)
    assert dec["verdict"] == "hold" and dec["token"] is None
    assert any("cooling down" in r for r in dec["reasons"])
    _base(adv)
    assert adv.consult(KEY)["verdict"] == "hold"
    _base(adv)
    dec2 = adv.consult(KEY)
    assert dec2 is not None and dec2["verdict"] == "replan"
    assert dec2["token"] == tok


def test_failed_demotes_immediately():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    _base(adv)
    assert adv.consult(KEY)["verdict"] == "replan"
    adv.failed(KEY)
    assert adv.info()["demotions_total"] == 1
    assert adv.consult(KEY)["verdict"] == "hold"
    adv.failed(KEY)  # idempotent on a non-corrected state
    assert adv.info()["demotions_total"] == 1


def test_decision_trace_shape():
    adv = _advisor(_store({"Join#0.0": _rec()}))
    _base(adv)
    adv.consult(KEY)
    t = adv.decision_trace()
    assert len(t) == 1
    row = t[0]
    assert row["state"] == "probation" and row["last_verdict"] == "replan"
    assert row["sql"] == "select 1" and row["base_executions"] == 1
    assert row["corrections"]["rows"] and row["reasons"]


# ---------------------------------------------------------------- engine layer
def _engine():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 11))
    return e


@pytest.fixture(autouse=True)
def steady_walls(monkeypatch):
    """A warm corrected run confirms unless its wall exceeds the uncorrected
    EWMA by 1.5x plus a floor of 5 ms.  Statements at SF0.01 take a few ms,
    and under parallel test workers the CPU's wall noise passes that floor,
    so the engine cases raise it in both packages (the regression rule
    itself is held by ``test_regression_demotes_then_cooldown_reconsiders``)."""
    from trino_tpu.execution import adaptive as jax_adaptive
    from trino_tpu_torch.execution import adaptive

    for mod in (adaptive, jax_adaptive):
        monkeypatch.setattr(mod, "REGRESS_FLOOR_S", 1.0)


@pytest.fixture()
def small_thresholds(monkeypatch):
    """The distribution pass's thresholds under SF0.01's build size (1500
    rows), so the corrected estimate crosses them: broadcast is blocked by
    the absolute cap, partitioned engages."""
    from trino_tpu_torch.sql import exchanges as X

    monkeypatch.setattr(X, "BROADCAST_ABS_CAP", 256)
    monkeypatch.setattr(X, "PARTITIONED_JOIN_THRESHOLD", 1024)


def _text(e, sql, s):
    return "\n".join(r[0] for r in e.execute_sql(sql, s).rows())


def test_misestimated_join_replans_and_improves(small_thresholds):
    e = _engine()
    e.adaptive_advisor.price_scale = 0.0  # any material win takes
    s = e.create_session("tpch")
    ctl = e.create_session("tpch")
    e.execute_sql("set session adaptive_execution = false", ctl)
    expected = e.execute_sql(JOIN_Q, ctl).rows()
    e.execute_sql(JOIN_Q, ctl)
    warm_off = e.last_query_counters
    assert warm_off["adaptive_replans"] == 0 and warm_off["adaptive_holds"] == 0

    before = _text(e, f"explain {JOIN_Q}", s)
    assert "partitioned" not in before and "Adaptive:" not in before, before

    assert e.execute_sql(JOIN_Q, s).rows() == expected
    assert e.last_query_counters["adaptive_replans"] == 0
    assert e.execute_sql(JOIN_Q, s).rows() == expected
    assert e.last_query_counters["adaptive_replans"] == 1, \
        e.adaptive_advisor.decision_trace()
    assert e.adaptive_advisor.info()["replans_total"] == 1

    dec = e.adaptive_advisor.decision_trace()[-1]
    assert dec["state"] in ("probation", "confirmed")
    assert any(v >= 1000 for v in dec["corrections"]["rows"].values()), dec
    after = _text(e, f"explain {JOIN_Q}", s)
    assert "partitioned" in after and "Adaptive: replan" in after, after

    # the warm corrected run costs no more at the device boundary, and the
    # correction confirms
    assert e.execute_sql(JOIN_Q, s).rows() == expected
    c3 = e.last_query_counters
    assert c3["device_dispatches"] <= warm_off["device_dispatches"]
    assert c3["host_bytes_pulled"] <= warm_off["host_bytes_pulled"]
    assert e.adaptive_advisor.decision_trace()[-1]["state"] == "confirmed"

    text = _text(e, f"explain analyze {JOIN_Q}", s)
    assert "Adaptive: replan" in text and "predicted win" in text, text

    # the decision rides the flight record
    recs = [r for r in e.flight_recorder.snapshot(kind="query") if r.get("adaptive")]
    assert recs, "no flight record carried the adaptive decision"
    assert recs[-1]["adaptive"]["verdict"] == "replan"


def test_hold_keeps_plan_and_counters_stable(small_thresholds):
    e = _engine()
    e.adaptive_advisor.price_scale = 1e9  # the price always wins
    s = e.create_session("tpch")
    r1 = e.execute_sql(JOIN_Q, s)
    r2 = e.execute_sql(JOIN_Q, s)
    assert r2.rows() == r1.rows()
    c2 = e.last_query_counters
    assert c2["adaptive_holds"] == 1 and c2["adaptive_replans"] == 0
    assert e.adaptive_advisor.info()["replans_total"] == 0
    e.execute_sql(JOIN_Q, s)
    c3 = e.last_query_counters
    for k in ("device_dispatches", "host_transfers", "host_bytes_pulled"):
        assert c3[k] == c2[k], k
    assert c3["adaptive_holds"] == 1
    text = _text(e, f"explain analyze {JOIN_Q}", s)
    assert "Adaptive: hold" in text and "partitioned" not in text, text


def test_adaptive_off_never_consults(small_thresholds):
    e = _engine()
    e.adaptive_advisor.price_scale = 0.0
    s = e.create_session("tpch")
    e.execute_sql("set session adaptive_execution = false", s)
    for _ in range(3):
        e.execute_sql(JOIN_Q, s)
    c = e.last_query_counters
    assert c["adaptive_replans"] == 0 and c["adaptive_holds"] == 0
    assert e.adaptive_advisor.info()["replans_total"] == 0
    assert e.adaptive_advisor.decision_trace() == []


def test_price_is_the_planning_seconds_of_a_miss(small_thresholds):
    """The advisor's price is what the first (plan-cache missing) run spent
    planning; a warm run adds nothing to it.  The decision rides the
    completion event and the counters."""
    from trino_tpu_torch.execution.eventlistener import EventListener

    e = _engine()
    s = e.create_session("tpch")
    seen = []

    class L(EventListener):
        def query_completed(self, ev):
            seen.append(ev)

    e.event_listeners.add(L())
    e.execute_sql(JOIN_Q, s)
    # the last planner span planned the statement (an earlier one tried a
    # plan template for its auto-parameterized text, and gave up)
    planned = [sp["duration_s"] for sp in e.last_query_trace["spans"]
               if sp["name"] == "planner"]
    price = e.adaptive_advisor.decision_trace()[-1]["compile_price_s"]
    assert price == pytest.approx(planned[-1], abs=1e-6) and price > 0
    e.execute_sql(JOIN_Q, s)  # a plan-cache hit: the price stays
    assert e.adaptive_advisor.decision_trace()[-1]["compile_price_s"] == price
    dec = seen[-1].adaptive
    assert dec is not None and dec["compile_price_s"] == pytest.approx(price, abs=1e-6)
    field = "adaptive_replans" if dec["verdict"] == "replan" else "adaptive_holds"
    assert seen[-1].counters[field] == 1


@pytest.mark.parametrize("name", ["ADAPTIVE_PROBE", "ADAPTIVE_PROBE_HASH"])
def test_probe_corrections_equal_the_reference(name):
    """``price_scale = 0``: run 1 records, run 2 runs the corrected plan, run
    3 confirms; both packages emit equal corrections, a capacity for the
    Aggregate among them, and every run's rows are byte-equal to run 1's in key order."""
    sql = getattr(chip_smoke, name)
    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=0.01, split_rows=1 << 11))
    t = _engine()
    decisions, firsts = [], []
    for e in (j, t):
        e.adaptive_advisor.price_scale = 0.0
        s = e.create_session("tpch")
        runs = [chip_smoke.by_key(e.execute_sql(sql, s)) for _ in range(3)]
        for r in runs[1:]:
            for a, b in zip(runs[0], r):
                assert a.tobytes() == b.tobytes()
        trace = e.adaptive_advisor.decision_trace()[-1]
        assert trace["state"] == "confirmed", trace
        decisions.append(trace["corrections"])
        firsts.append(runs[0])
    for a, b in zip(*firsts):
        assert a.tobytes() == b.tobytes(), name
    assert decisions[1] == decisions[0], decisions
    assert list(decisions[1]["capacity"]) == ["Aggregate#0.0.0"]


def test_hash_probe_starts_at_the_corrected_capacity(monkeypatch):
    """On the hash path the corrected plan's group-by table starts at the
    advisor's capacity; the uncorrected one at the executor's estimate."""
    from trino_tpu_torch.ops import hashagg

    caps = []
    init = hashagg.groupby_init

    def recorded(capacity, *a, **k):
        caps.append(capacity)
        return init(capacity, *a, **k)

    monkeypatch.setattr(hashagg, "groupby_init", recorded)
    e = _engine()
    e.adaptive_advisor.price_scale = 0.0
    s = e.create_session("tpch")
    e.execute_sql(chip_smoke.ADAPTIVE_PROBE_HASH, s)
    e.execute_sql(chip_smoke.ADAPTIVE_PROBE_HASH, s)
    want = e.adaptive_advisor.decision_trace()[-1]["corrections"]["capacity"]
    assert caps[-1] == want["Aggregate#0.0.0"] and caps[0] != caps[-1], caps


# ------------------------------------------------------------------ the property
def test_session_property_is_plan_shaping():
    from trino_tpu_torch.engine import _effective_adaptive, _plan_shape_props

    e = _engine()
    s = e.create_session("tpch")
    on = _plan_shape_props(s)
    assert on[-1] is True and _effective_adaptive(s)
    e.execute_sql("set session adaptive_execution = false", s)
    off = _plan_shape_props(s)
    assert off[-1] is False and off != on
    e.execute_sql("reset session adaptive_execution", s)
    assert _plan_shape_props(s) == on


def test_env_default_off(monkeypatch):
    from trino_tpu_torch.engine import _effective_adaptive, _plan_shape_props

    e = _engine()
    s = e.create_session("tpch")
    monkeypatch.setenv("TRINO_TPU_ADAPTIVE", "0")
    assert not _effective_adaptive(s)
    assert _plan_shape_props(s)[-1] is False
    e.execute_sql("set session adaptive_execution = true", s)
    assert _effective_adaptive(s)
