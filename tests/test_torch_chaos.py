"""The port's fault injector at its local chokepoints and the chaos matrix
(``trino_tpu_torch/execution/faults.py``, ``execution/chaos_matrix.py``)
against the JAX package on the CPU.

Restates tests/test_chaos.py at SF0.01 with 2^11-row splits (its tier-1
scale): each of ``chaos_matrix.SCENARIOS`` over q1 and q3 fires at least
once; a recoverable one gives the reference's fault-free result and the
engine's own fault-free bytes, an unrecoverable one raises the typed error;
the leak check is clean and a fault-free rerun gives the baseline after
each.  Also: reservations steady over repeated faulted runs, the firings on
the counters and in EXPLAIN ANALYZE, the injector's triggers and parser
(both packages fire alike), the fatal fault classified deterministic by
``exec/fte.is_retryable_failure`` (both packages' classifiers agree), the
disarmed injector inert, operator-label and bare-tag site globs, and the
``/v1/metrics`` fault and retry series.  Adds: ``generate`` and ``h2d``
fire as often as in the reference on the same statement, and the scenario
tables are the reference's.

The reference's two prefetch-producer tests are restated on the port's
producer, the spill readback's ``_prefetched_pages`` (the port's scan has
no producer: the reference's comes with dispatch coalescing, which the
port leaves out): a dispatch fault mid-readback leaves no producer alive,
and ``spill_read`` and ``h2d`` faults that land on the producer thread fail
typed, charged to the query.

The ``dispatch`` point counts kernel-wrapper calls and host reads in the
port, jitted steps in the reference, so ``nth`` lands on another operation
in each package: the outcome is held, not the site.

Recovered results equal the reference's fault-free result: integers,
decimals, dates and strings exactly, DOUBLE within rtol 1e-9.

The worker mesh's exchange matrix (tests/test_chaos.py:402 restated): each
of ``chaos_matrix.DIST_SCENARIOS`` runs its statement distributed on
``worker_mesh(8, devices=["cpu"] * 8)`` at SF0.02 in 2^12-row splits, fires
at least once, recovers byte-identical to the port's local run or fails
with the typed error, leaves no leak, and a fault-free distributed rerun
gives the baseline; the scenario and query tables are the reference's.

test_fte_dropped_commit_is_retried is restated in tests/test_torch_fte.py,
and the backoff and reannounce tests in tests/test_torch_cluster.py.
"""

import os
import re
import sys

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.exec.fte import is_retryable_failure as jax_retryable
from trino_tpu.execution import chaos_matrix as jcm
from trino_tpu.execution import faults as jfaults
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec.fte import is_retryable_failure
from trino_tpu_torch.exec.local_executor import LocalExecutor
from trino_tpu_torch.execution import chaos_matrix as cm
from trino_tpu_torch.execution import faults
from trino_tpu_torch.execution.bufferpool import DeviceBufferPool
from trino_tpu_torch.execution.faults import (FatalInjectedFaultError, FaultPlan,
                                              InjectedFaultError)
from trino_tpu_torch.memory import MemoryPool, QueryMemoryLimitError
from trino_tpu_torch.sql.frontend import compile_sql

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 11
FAST = ("q1", "q3")
PAGE_TIER = 6 << 30  # tests/test_chaos.py's fixture
# the producer tests' forced spill: chaos_matrix.PRESSURE_QUERY over orders
# in splits of 4096 rows against the 512 KiB pool (tests/test_torch_spill.py)
SPILL_SF, SPILL_SPLIT_ROWS = 0.02, 1 << 12


def _leak_check(engine):
    leftovers = cm.leak_report(engine, timeout=4.0)
    assert not leftovers, f"post-scenario leaks: {leftovers}"


@pytest.fixture(scope="module")
def sf():
    """The port's engine with the reference fixture's page tier and a
    ``page_cache = false`` session, and its fault-free baselines (held to
    the reference's results by test_generate_and_h2d_fire_as_in_the_reference,
    so a run byte-identical to a baseline equals the reference's result)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRINO_TPU_PAGE_CACHE", str(PAGE_TIER))
        engine = Engine(device="cpu")
        engine.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
        engine.buffer_pool.budget()  # read at first use: fixed here
    session = engine.create_session("tpch")
    nocache = engine.create_session("tpch")
    engine.session_properties.set_property(nocache, "page_cache", False)
    state = {"baselines": {}}
    yield engine, session, nocache, state
    engine._invalidate()


def _baseline(sf, name):
    engine, session, _nocache, state = sf
    if name not in state["baselines"]:
        engine.execute_sql(cm.QUERIES[name], session)  # cold: plans, fills the tier
        state["baselines"][name] = cm.result_signature(
            engine.execute_sql(cm.QUERIES[name], session))
    return state["baselines"][name]


# ------------------------------------------------------------ local matrix
def test_scenario_tables_are_the_references():
    assert cm.SCENARIOS == jcm.SCENARIOS
    assert cm.RECOVERABLE == jcm.RECOVERABLE and cm.FAILING == jcm.FAILING
    assert cm.RESULT_SCENARIOS == jcm.RESULT_SCENARIOS
    assert {k: " ".join(v.split()) for k, v in cm.QUERIES.items()} == \
        {k: " ".join(v.split()) for k, v in jcm.QUERIES.items()}


@pytest.mark.parametrize("name", FAST)
@pytest.mark.parametrize("scenario", sorted(cm.RECOVERABLE))
def test_recoverable_fault_is_invisible(sf, name, scenario):
    """Byte-identical to the fault-free baseline, and so to the reference's
    fault-free result."""
    engine, session, _nocache, _state = sf
    spec, clear_pool = cm.RECOVERABLE[scenario]
    base = _baseline(sf, name)
    if clear_pool:
        engine.buffer_pool.clear()  # the run regenerates and stores
    with faults.injected(spec) as plan:
        got = engine.execute_sql(cm.QUERIES[name], session)
    assert plan.total_fires() >= 1, f"scenario never fired: {plan.stats()}"
    assert cm.result_signature(got) == base, f"{name} under {spec}: result diverged"
    _leak_check(engine)
    assert cm.result_signature(engine.execute_sql(cm.QUERIES[name], session)) == base


@pytest.mark.parametrize("name", FAST)
@pytest.mark.parametrize("scenario", sorted(cm.FAILING))
def test_unrecoverable_fault_fails_clean(sf, name, scenario):
    """Every FAILING scenario fires on q1 and on q3 and raises the typed
    error; no partial page is cached, so the fault-free rerun is the
    baseline."""
    engine, session, nocache, _state = sf
    spec, cache_on = cm.FAILING[scenario]
    base = _baseline(sf, name)
    with faults.injected(spec) as plan:
        with pytest.raises(InjectedFaultError):
            engine.execute_sql(cm.QUERIES[name], session if cache_on else nocache)
    assert plan.total_fires() >= 1, f"scenario never fired: {plan.stats()}"
    _leak_check(engine)
    assert cm.result_signature(engine.execute_sql(cm.QUERIES[name], session)) == base
    _leak_check(engine)


def test_repeated_faulted_runs_hold_reservations_steady(sf):
    engine, session, _nocache, _state = sf
    _baseline(sf, "q1")

    def faulted_run():
        with faults.injected("point=dispatch,action=error,nth=3"):
            with pytest.raises(InjectedFaultError):
                engine.execute_sql(cm.QUERIES["q1"], session)
        cm.settle()

    faulted_run()
    first = {d["pool"]: d["reserved"] for d in engine.memory_info()}
    faulted_run()
    second = {d["pool"]: d["reserved"] for d in engine.memory_info()}
    assert second == first, (first, second)
    _leak_check(engine)


def test_faults_are_counted_and_explained(sf):
    engine, session, _nocache, _state = sf
    _baseline(sf, "q1")
    with faults.injected("point=dispatch,action=delay,s=0,every=1"):
        r = engine.execute_sql(f"explain analyze {cm.QUERIES['q1']}", session)
    text = "\n".join(str(row[0]) for row in r.rows())
    n = engine.last_query_counters["faults_injected"]
    assert n > 0
    assert f"{n} faults injected" in text, text
    # a disarmed statement keeps the line as it was
    r = engine.execute_sql(f"explain analyze {cm.QUERIES['q1']}", session)
    text = "\n".join(str(row[0]) for row in r.rows())
    assert "faults injected" not in text
    assert engine.last_query_counters["faults_injected"] == 0


@pytest.mark.parametrize("cache", [False, True], ids=["tier-off", "tier-on"])
def test_generate_and_h2d_fire_as_in_the_reference(sf, cache):
    """On fresh engines, the same statements, splits and session: the port
    crosses ``generate`` once per split generated and ``h2d`` once per page
    the reference stages (each generated page of a multi-split scan, and
    each page of a scan stored in the page tier), as often as the
    reference.  The results are the reference's, and byte-identical to the
    matrix's fault-free baselines."""
    spec = "point=generate,action=delay,s=0,every=1;point=h2d,action=delay,s=0,every=1"
    got, results = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRINO_TPU_PAGE_CACHE", str(PAGE_TIER))
        for pkg, (E, C, F, kw) in {"jax": (JaxEngine, JaxTpch, jfaults, {}),
                                   "torch": (Engine, TpchConnector, faults,
                                             {"device": "cpu"})}.items():
            e = E(**kw)
            e.register_catalog("tpch", C(sf=SF, split_rows=SPLIT_ROWS))
            s = e.create_session("tpch")
            e.session_properties.set_property(s, "page_cache", cache)
            for q in FAST:
                with F.injected(spec) as plan:
                    results[(pkg, q)] = e.execute_sql(cm.QUERIES[q], s)
                got[(pkg, q)] = [st["fires"] for st in plan.stats()]
            e._invalidate()
    for q in FAST:
        assert got[("torch", q)] == got[("jax", q)], (q, got)
        assert min(got[("torch", q)]) > 0, got
        chip_smoke.same_outcome_result(results[("torch", q)], results[("jax", q)],
                                       cm.QUERIES[q], f"{q} vs the reference")
        assert cm.result_signature(results[("torch", q)]) == _baseline(sf, q)


# ------------------------------------------------------------ injector unit
def test_fault_plan_triggers_are_deterministic():
    for mod in (faults, jfaults):
        p = mod.FaultPlan.parse("point=dispatch,nth=2,action=error")
        assert p.fire("dispatch", "x", None) is None
        with pytest.raises(mod.InjectedFaultError):
            p.fire("dispatch", "x", None)
        assert p.fire("dispatch", "x", None) is None  # nth implies times=1

        p = mod.FaultPlan.parse("point=reserve,action=deny,every=3")
        assert [p.fire("reserve", "t", None) for _ in range(9)] == [None, None, "deny"] * 3

        p = mod.FaultPlan.parse("point=dispatch,site=Agg*,action=error,query=q7")
        assert p.fire("dispatch", "Join#0/probe", "q7") is None
        assert p.fire("dispatch", "Aggregate#1/step", "q8") is None
        with pytest.raises(mod.InjectedFaultError):
            p.fire("dispatch", "Aggregate#1/step", "q7")
    # the seeded probability: reproducible, not constant, and the reference's
    spec = "point=task,action=drop,p=0.3,seed=11,times=1000"
    a, b, j = FaultPlan.parse(spec), FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    seq = [a.fire("task", "s", None) for _ in range(50)]
    assert seq == [b.fire("task", "s", None) for _ in range(50)]
    assert seq == [j.fire("task", "s", None) for _ in range(50)]
    assert 0 < seq.count("drop") < 50


def test_fault_plan_parse_rejects_garbage():
    for bad in ("", "action=error", "point=nope", "point=dispatch,wat=1",
                "point=dispatch,action=explode"):
        for mod in (faults, jfaults):
            with pytest.raises(ValueError):
                mod.FaultPlan.parse(bad)


def test_fatal_fault_is_classified_deterministic():
    """The port's classifier is the reference's over its own classes: a
    retryable injected fault retries; a fatal one, a query past its memory
    limit, and a planner or feature error do not."""
    from trino_tpu.execution.faults import FatalInjectedFaultError as JaxFatal
    from trino_tpu.memory import QueryMemoryLimitError as JaxLimit

    assert is_retryable_failure(InjectedFaultError("x"))
    assert not is_retryable_failure(FatalInjectedFaultError("x"))
    assert not is_retryable_failure(QueryMemoryLimitError("x"))
    pairs = [(InjectedFaultError("x"), jfaults.InjectedFaultError("x")),
             (FatalInjectedFaultError("x"), JaxFatal("x")),
             (QueryMemoryLimitError("x"), JaxLimit("x")),
             (NotImplementedError("x"), NotImplementedError("x")),
             (RuntimeError("x"), RuntimeError("x")),
             (KeyboardInterrupt(), KeyboardInterrupt())]
    for mine, theirs in pairs:
        assert is_retryable_failure(mine) == jax_retryable(theirs), mine


def test_disarmed_injector_is_inert(sf):
    """Disarmed, the points add nothing: no firing charged, and the same
    host reads, bytes and launches as a run armed with a rule that never
    matches."""
    engine, session, _nocache, _state = sf
    assert faults.active() is None
    assert faults.maybe_inject("dispatch", "anything") is None
    _baseline(sf, "q3")
    engine.execute_sql(cm.QUERIES["q3"], session)
    off = engine.last_query_counters
    with faults.injected("point=dispatch,site=never-reached,action=error"):
        engine.execute_sql(cm.QUERIES["q3"], session)
    armed = engine.last_query_counters
    assert off["faults_injected"] == armed["faults_injected"] == 0
    for k in ("host_reads", "host_bytes", "h2d_bytes", "launches"):
        assert off[k] == armed[k], k


def test_operator_targeted_site_glob_fires(sf):
    """A rule's site glob matches the composed "<Op>#<k>/<site>" label and
    the bare chokepoint tag.  The bare tag is ``agg.direct.overflow``, the
    direct group-by's overflow read, which this statement reaches in the
    port (the reference's ``agg.*`` tags are its jit sites)."""
    engine, session, _nocache, _state = sf
    sql = "select l_returnflag, count(*) c from lineitem group by l_returnflag"
    expected = engine.execute_sql(sql, session).rows()
    for glob in ("Aggregate*", "agg.direct.overflow"):
        with faults.injected(f"point=dispatch,site={glob},action=delay,s=0,every=1") as plan:
            got = engine.execute_sql(sql, session).rows()
        assert plan.total_fires() >= 1, f"site={glob} matched no dispatch: {plan.stats()}"
        assert got == expected
    _leak_check(engine)


def test_metrics_export_fault_and_retry_counters():
    from trino_tpu_torch.server.server import CoordinatorServer

    engine = Engine(device="cpu")
    engine.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    session = engine.create_session("tpch")
    with faults.injected("point=dispatch,action=delay,s=0,every=1"):
        engine.execute_sql("select count(*) from nation", session)
    assert engine.counters_total.faults_injected > 0
    text = CoordinatorServer(engine)._metrics_text()
    assert "# TYPE trino_tpu_faults_injected_total counter" in text
    assert "# TYPE trino_tpu_task_retries_total counter" in text
    m = re.search(r"^trino_tpu_faults_injected_total (\d+)$", text, re.M)
    assert m and int(m.group(1)) == engine.counters_total.faults_injected > 0, text
    assert re.search(r"^trino_tpu_task_retries_total 0$", text, re.M), text


# -------------------------------------------- the spill readback's producer
@pytest.fixture(scope="module")
def spill_env():
    e = Engine(device="cpu")
    conn = TpchConnector(sf=SPILL_SF, split_rows=SPILL_SPLIT_ROWS)
    e.register_catalog("tpch", conn)
    plan = compile_sql(cm.PRESSURE_QUERY, e, e.create_session("tpch"))
    base = cm.result_signature(LocalExecutor(e.catalogs, "cpu").execute(plan))
    yield e, plan, base, len(conn.splits("orders"))
    e._invalidate()


def test_mid_readback_fault_kills_prefetch_producer(spill_env, tmp_path, monkeypatch):
    """A dispatch fault raised on the consumer while the Grace aggregation
    reads its host-tier partitions back through the producer: the typed
    error, and no producer thread, registration, spill reservation or spill
    file outlives the query, though ``pytest.raises`` holds the traceback
    (which pins the consumer's generators)."""
    engine, plan, _base, _splits = spill_env
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    monkeypatch.delenv("TRINO_TPU_SPILL_HOST_BYTES", raising=False)
    assert not cm.settle()
    ex = LocalExecutor(engine.catalogs, "cpu", memory_pool=MemoryPool(max_bytes=1 << 19),
                       buffer_pool=DeviceBufferPool(budget_bytes=0, device="cpu"))
    # the readback began (the producer read a partition) before the second
    # partition's first insert faulted
    spec = ("point=spill_read,action=delay,s=0,every=1;"
            "point=dispatch,site=hash_insert,action=error,nth=2")
    with faults.injected(spec) as fplan:
        with pytest.raises(InjectedFaultError):
            ex.execute(plan)
    reads, inserts = (st["fires"] for st in fplan.stats())
    assert inserts == 1 and reads >= 2, fplan.stats()
    leftovers = cm.settle(timeout=4.0)
    assert not leftovers, f"producer survived the faulted query: {leftovers}"
    assert not ex._producers and not ex._spills
    assert ex.memory_pool.info()["by_tag"].get("spill", 0) == 0
    assert not os.listdir(tmp_path), "orphaned spill file"


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("point", ["spill_read", "h2d"])
def test_producer_thread_fault_fails_clean(spill_env, tmp_path, tier, point):
    """A ``spill_read`` or ``h2d`` fault that lands on the producer thread
    (the second partition's read, or its staging past the scan's pages)
    surfaces at the consumer as the typed error, charged to the query once
    through the producer's counter handoff; the producer dies with it and
    nothing leaks.  ``chaos_matrix.producer_faults`` is shared with the card
    run (phase 17c)."""
    engine, plan, base, splits = spill_env
    name, cfg, spec = next(f for f in cm.producer_faults(splits)
                           if f[0] == f"{point}-{tier}")
    rec = cm.run_pressure_scenario(engine, plan, base, name, cfg, spec, "fail",
                                   str(tmp_path))
    assert rec["ok"], {k: v for k, v in rec.items() if k != "counters"}
    assert rec["error_type"] == "InjectedFaultError"
    assert rec["fires"] == 1 and rec["counters"].faults_injected == 1
    assert cm.settle(timeout=4.0) == []
    # the faulted run cached nothing: the same executor setup unfaulted
    # gives the unconstrained bytes
    ok = cm.run_pressure_scenario(engine, plan, base, name, cfg, None, "recover",
                                  str(tmp_path))
    assert ok["ok"], {k: v for k, v in ok.items() if k != "counters"}


# -- the worker mesh's exchange matrix (tests/test_chaos.py:402) ---------------------


@pytest.fixture(scope="module")
def dist_chaos():
    from trino_tpu_torch.parallel.mesh import worker_mesh

    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.02, split_rows=1 << 12))
    s = e.create_session("tpch")
    baselines = {k: cm.result_signature(e.execute_sql(sql, s))
                 for k, sql in cm.DIST_QUERIES.items()}
    return e, s, worker_mesh(8, devices=["cpu"] * 8), baselines


def test_dist_scenarios_are_the_reference_tables():
    assert cm.DIST_SCENARIOS == jcm.DIST_SCENARIOS
    assert cm.DIST_QUERIES == jcm.DIST_QUERIES


@pytest.mark.parametrize("name,query,spec,kind", cm.DIST_SCENARIOS,
                         ids=[sc[0] for sc in cm.DIST_SCENARIOS])
def test_distributed_exchange_fault_matrix(dist_chaos, name, query, spec, kind):
    e, s, mesh, baselines = dist_chaos
    rec = cm.run_dist_scenario(e, cm.DIST_QUERIES[query], s, mesh, baselines[query],
                               name, spec, kind)
    assert rec.get("ok"), rec
