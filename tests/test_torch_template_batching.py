"""The port's template batcher (``trino_tpu_torch/execution/batcher.py``) and
fused template execution (``LocalExecutor.execute_batched``) against the JAX
package on the CPU.

Restates tests/test_template_batching.py: a fused window of concurrent
protocol-parameterized requests (distinct bindings, a NULL binding, a
binding that cannot bind) equal, byte for byte, to serial execution and,
row for row, to the reference's own fused window; a window over bindings
that prune to different splits scans the union of their kept splits; a
member's error is its own; a Sort/Limit template demotes to serial lanes;
a warm fused window of four reads the host at most twice as often as one
warm serial request (the port's counterpart of the reference's 2x-dispatch
bound); the ``Batched:`` EXPLAIN ANALYZE line; the ``/v1/metrics`` series;
and the batcher's protocol on its own.  Each request's batch size is in
the engine's thread slot (``last_batched_with``) and, as in the reference,
on its flight record (``batched_with``).

Fusion is made, never raced: the template's lane is marked busy, the
members enqueue, and a handoff makes the first of them the driver.
"""

import os
import sys
import threading
import time

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.execution import batcher as JBA
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.execution import batcher as BA

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 14

POINT = ("select c_name, c_acctbal, c_mktsegment from customer "
         "where c_custkey = ?")


def _engines(monkeypatch, split_rows=SPLIT_ROWS):
    """(reference, port, port with the batcher off), the result and page
    tiers off."""
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
    for var in ("TRINO_TPU_PLAN_TEMPLATES", "TRINO_TPU_TEMPLATE_BATCH"):
        monkeypatch.delenv(var, raising=False)
    j, t, b = JaxEngine(), Engine(device="cpu"), Engine(device="cpu")
    b.template_batcher.enabled = False
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=split_rows))
    conn = TpchConnector(sf=SF, split_rows=split_rows)
    t.register_catalog("tpch", conn)
    b.register_catalog("tpch", conn)
    assert t.template_batcher.enabled and j.template_batcher.enabled
    return j, t, b


@pytest.fixture()
def eng(monkeypatch):
    return _engines(monkeypatch)


def _warm(e, text, bindings=((42,), (97,))):
    """Create and confirm the template (only a confirmed one fuses)."""
    s = e.create_session("tpch")
    for ps in bindings:
        e.execute_sql(text, s, parameters=list(ps))


def _fused(e, text, params_list, expect_members=None, timeout=60):
    """The requests as ONE fused window, run concurrently.  Returns, in input
    order, (result or the exception it raised, the request's batch size,
    its counters)."""
    bt = e.template_batcher
    key = e._template_key(text, e.create_session("tpch"))
    lane_cls = JBA._Lane if isinstance(e, JaxEngine) else BA._Lane
    with bt._lock:
        lane = bt._lanes.setdefault(key, lane_cls())
        lane.busy = True
    n = len(params_list) if expect_members is None else expect_members
    out = [None] * len(params_list)

    def fire(i, ps):
        s = e.create_session("tpch")
        try:
            r = e.execute_sql(text, s, parameters=list(ps))
            if isinstance(e, Engine):
                out[i] = (r, e.last_batched_with, dict(e.last_query_counters))
            else:
                out[i] = (r, None, None)
        except Exception as ex:  # noqa: BLE001 - the member's own error
            out[i] = (ex, None, None)

    threads = [threading.Thread(target=fire, args=(i, ps))
               for i, ps in enumerate(params_list)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with bt._lock:
            if len(lane.queue) >= n:
                break
        time.sleep(0.001)
    bt._handoff(lane)
    for th in threads:
        th.join(timeout)
    assert not any(th.is_alive() for th in threads), "fused window hung"
    return out


def _serial(e, text, params_list):
    s = e.create_session("tpch")
    return [e.execute_sql(text, s, parameters=list(ps)) for ps in params_list]




# ------------------------------------------------------- byte identity
def test_fused_window_byte_identity(eng):
    """Distinct bindings and a NULL fused into one window equal serial
    execution byte for byte, and the reference's fused window row for row;
    every member counts once and carries the window's size."""
    j, t, b = eng
    for e in eng:
        _warm(e, POINT)
    params = [(42,), (97,), (None,), (7,)]
    before = t.counters_total.as_dict()
    out = _fused(t, POINT, params)
    ref = _fused(j, POINT, params)
    ser = _serial(b, POINT, params)
    for i, ((r, bw, c), (a, _, _), o) in enumerate(zip(out, ref, ser)):
        assert not isinstance(r, Exception), f"member {i} raised: {r!r}"
        chip_smoke.same_bytes(r, o, f"member {i} vs serial")
        chip_smoke.same_outcome_result(r, a, POINT, f"member {i} vs the reference")
        assert bw == len(params) and c["batched_requests"] == 1
    after = t.counters_total.as_dict()
    assert after["batched_requests"] - before["batched_requests"] == len(params)
    # flight records: each member's record carries the window's size
    recs = [r for r in t.flight_recorder.snapshot(kind="query")
            if r.get("batched_with") == len(params)]
    assert len(recs) >= len(params)
    bi = t.template_batcher.info()
    assert bi["batches_total"] == 1 and bi["sizes"] == {len(params): 1}
    assert j.template_batcher.info()["sizes"] == bi["sizes"]
    # one driver carries the window's device work: the riders' counters are
    # empty, and the per-request counters sum to the totals
    reads = sorted(c["host_reads"] for _, _, c in out)
    assert reads[:-1] == [0] * (len(params) - 1) and reads[-1] > 0
    assert after["host_reads"] - before["host_reads"] == reads[-1]


def test_binderror_fallback_shares_the_window(eng):
    """A binding the template cannot take (1.5 in an integer slot) never
    enters the batcher and substitutes; the rest of the window fuses."""
    j, t, b = eng
    for e in eng:
        _warm(e, POINT)
    params = [(42,), (1.5,), (97,), (None,)]
    before = t.counters_total.as_dict()
    out = _fused(t, POINT, params, expect_members=len(params) - 1)
    ref = _fused(j, POINT, params, expect_members=len(params) - 1)
    ser = _serial(b, POINT, params)
    for i, ((r, bw, _), (a, _, _), o) in enumerate(zip(out, ref, ser)):
        assert not isinstance(r, Exception), f"member {i} raised: {r!r}"
        chip_smoke.same_bytes(r, o, f"member {i}")
        chip_smoke.same_outcome_result(r, a, POINT, f"member {i} vs the reference")
        assert bw == (None if i == 1 else len(params) - 1)
    after = t.counters_total.as_dict()
    assert after["batched_requests"] - before["batched_requests"] == len(params) - 1


def test_fused_window_unions_pruned_splits(monkeypatch):
    """Bindings in different splits: the fused scan reads the union of the
    members' kept splits, once each, in split order, and every lane equals
    its serial answer."""
    j, t, b = _engines(monkeypatch, split_rows=256)  # 1500 rows -> 6 splits
    for e in (j, t, b):
        _warm(e, POINT)
    conn = t.catalogs["tpch"]
    seen = []
    gen = conn.generate
    monkeypatch.setattr(conn, "generate",
                        lambda split, cols: seen.append(split) or gen(split, cols))
    params = [(5,), (700,), (1400,), (901,)]
    out = _fused(t, POINT, params)
    scanned = list(seen)
    ref = _fused(j, POINT, params)
    ser = _serial(b, POINT, params)
    for i, ((r, _, _), (a, _, _), o) in enumerate(zip(out, ref, ser)):
        assert not isinstance(r, Exception), f"member {i} raised: {r!r}"
        chip_smoke.same_bytes(r, o, f"member {i}")
        chip_smoke.same_outcome_result(r, a, POINT, f"member {i} vs the reference")
    splits = conn.splits("customer")
    want = [splits[i] for i in sorted({(k - 1) // 256 for (k,) in params})]
    assert scanned == want


# ------------------------------------------------------- error isolation
def test_member_error_fails_only_its_own_request(eng, monkeypatch):
    """A lane's decode error is that member's alone.  While the fused batch
    runs, no binding is published outside the lanes' own: a parameter
    evaluated there raises instead of giving one member's value to all."""
    from trino_tpu_torch.exec import local_executor as LE
    from trino_tpu_torch.sql import ir
    from trino_tpu_torch.types import BIGINT

    _, t, _ = eng
    _warm(t, POINT)
    ref = _serial(t, POINT, [(42,), (97,), (7,)])
    stray = []

    def hook(lane, nlanes):
        if lane == 0:
            # the scope Parameter evaluation reads holds no binding
            stray.append(getattr(ir._PARAM_TLS, "values", None))
            with pytest.raises(RuntimeError, match="outside bind_params"):
                ir.evaluate(ir.Parameter(0, BIGINT), [], [])
        if lane == 1:
            raise RuntimeError("injected lane fault")

    monkeypatch.setattr(LE, "BATCH_LANE_TEST_HOOK", hook)
    out = _fused(t, POINT, [(42,), (97,), (7,)])
    monkeypatch.setattr(LE, "BATCH_LANE_TEST_HOOK", None)
    assert stray == [()]
    assert isinstance(out[1][0], Exception) and "injected lane fault" in str(out[1][0])
    chip_smoke.same_bytes(out[0][0], ref[0], "member 0")
    chip_smoke.same_bytes(out[2][0], ref[2], "member 2")


def test_unbatchable_template_demotes_to_serial(eng):
    """A Sort/Limit template is outside the fused subset: the first fused
    attempt raises BatchUnsupported, the template demotes for good, and
    every member still gets its serial answer."""
    from trino_tpu_torch.engine import _PlanTemplate

    j, t, b = eng
    text = ("select c_name from customer where c_custkey < ? "
            "order by c_name limit 5")
    for e in eng:
        _warm(e, text, ((100,), (500,)))
    tpl = next(v[0] for v in t._template_cache.values()
               if isinstance(v[0], _PlanTemplate) and "order by" in v[0].text)
    assert tpl.batchable
    params = [(100,), (500,), (900,)]
    before = t.counters_total.as_dict()
    out = _fused(t, text, params)
    ref = _fused(j, text, params)
    ser = _serial(b, text, params)
    for i, ((r, bw, _), (a, _, _), o) in enumerate(zip(out, ref, ser)):
        assert not isinstance(r, Exception), f"member {i} raised: {r!r}"
        chip_smoke.same_bytes(r, o, f"member {i}")
        chip_smoke.same_outcome_result(r, a, text, f"member {i} vs the reference")
        assert bw is None
    assert not tpl.batchable
    assert t.counters_total.as_dict()["batched_requests"] == before["batched_requests"]
    # a later request skips the lane: it answers while the lane is busy
    bt = t.template_batcher
    lane = bt._lanes[t._template_key(text, t.create_session("tpch"))]
    with bt._lock:
        lane.busy = True
    got = []
    th = threading.Thread(target=lambda: got.append(
        t.execute_sql(text, t.create_session("tpch"), parameters=[250])))
    th.start()
    th.join(30)
    assert not th.is_alive() and not lane.queue
    bt._handoff(lane)
    chip_smoke.same_bytes(got[0], _serial(b, text, [(250,)])[0], "later request")


# ------------------------------------------------------- amortization
def test_fused_host_reads_within_2x_of_one_request(eng):
    """A warm fused window of four reads the host at most twice as often as
    one warm serial request, not four times."""
    _, t, _ = eng
    _warm(t, POINT)
    s = t.create_session("tpch")
    t.execute_sql(POINT, s, parameters=[11])
    serial = t.last_query_counters["host_reads"]
    assert serial > 0
    _fused(t, POINT, [(21,), (31,), (41,), (51,)])
    mid = t.counters_total.as_dict()
    out = _fused(t, POINT, [(22,), (32,), (42,), (52,)])
    assert not any(isinstance(r, Exception) for r, _, _ in out)
    fused = t.counters_total.as_dict()["host_reads"] - mid["host_reads"]
    assert 0 < fused <= 2 * serial, (fused, serial)


# ------------------------------------------------------- observability
def test_explain_analyze_batched_line(eng):
    """format_plan prints "Batched:" only where the counter is nonzero."""
    from trino_tpu_torch.execution.tracing import QueryCounters
    from trino_tpu_torch.sql.planprinter import format_plan

    _, t, _ = eng
    s = t.create_session("tpch")
    t.execute_sql("select c_custkey from customer where c_custkey = 42", s)
    res = t.execute_sql("explain analyze select c_custkey from customer "
                        "where c_custkey = 42", s)
    assert "Batched:" not in "\n".join(str(row[0]) for row in res.rows())
    c = QueryCounters()
    c.batched_requests = 5
    plan = next(v[0].plan for v in t._template_cache.values()
                if getattr(v[0], "plan", None) is not None)
    assert "Batched: 5 requests" in format_plan(plan, counters=c)
    c.batched_requests = 0
    assert "Batched:" not in format_plan(plan, counters=c)


def test_metrics_export_batch_series(eng):
    from trino_tpu_torch.server.server import CoordinatorServer

    _, t, _ = eng
    _warm(t, POINT)
    out = _fused(t, POINT, [(42,), (97,), (7,)])
    assert not any(isinstance(r, Exception) for r, _, _ in out)
    body = CoordinatorServer(t)._metrics_text()
    assert "trino_tpu_template_batches_total 1" in body
    assert "trino_tpu_batched_requests_total 3" in body
    assert 'trino_tpu_template_batch_size_bucket{le="4"} 1' in body
    assert 'trino_tpu_template_batch_size_bucket{le="2"} 0' in body
    assert "trino_tpu_template_batch_size_sum 3" in body
    assert "trino_tpu_template_batch_size_count 1" in body


# ------------------------------------------------------- batcher protocol
def _mk(window_ms=0.0, max_batch=16, enabled=True):
    return BA.TemplateBatcher(window_ms=window_ms, max_batch=max_batch, enabled=enabled)


def test_batcher_disabled_is_passthrough():
    bt = _mk(enabled=False)
    res, n = bt.execute("k", (1,), lambda rt: ("serial", rt), None)
    assert res == ("serial", (1,)) and n == 0
    assert bt.info()["batches_total"] == 0


def test_batcher_leader_runs_serial_immediately():
    bt = _mk()
    calls = []
    res, n = bt.execute("k", (1,), lambda rt: calls.append(rt) or "ok",
                        lambda rts: pytest.fail("fused on an idle lane"))
    assert res == "ok" and n == 0 and calls == [(1,)]
    assert not bt._lanes["k"].busy


def _fuse_via_hook(bt, runtimes, serial_fn, batch_fn, monkeypatch):
    """The leader parks in LEADER_EXIT_HOOK until every member queued."""
    ready = threading.Event()
    monkeypatch.setattr(BA, "LEADER_EXIT_HOOK", lambda key: ready.wait(timeout=30))
    out = {}

    def run(name, rt):
        try:
            out[name] = bt.execute("k", rt, serial_fn, batch_fn)
        except Exception as e:  # noqa: BLE001
            out[name] = e

    lead = threading.Thread(target=run, args=("leader", ("L",)))
    lead.start()
    t0 = time.monotonic()
    while "k" not in bt._lanes and time.monotonic() - t0 < 10:
        time.sleep(0.001)
    members = [threading.Thread(target=run, args=(f"m{i}", rt))
               for i, rt in enumerate(runtimes)]
    for th in members:
        th.start()
    while time.monotonic() - t0 < 10:
        with bt._lock:
            if len(bt._lanes["k"].queue) >= len(runtimes):
                break
        time.sleep(0.001)
    ready.set()
    for th in [lead] + members:
        th.join(30)
    monkeypatch.setattr(BA, "LEADER_EXIT_HOOK", None)
    return out


def test_batcher_window_fuses_members(monkeypatch):
    bt = _mk(window_ms=5.0)
    fused = []

    def batch_fn(rts):
        fused.append(list(rts))
        return [("batched", rt) for rt in rts]

    out = _fuse_via_hook(bt, [("a",), ("b",), ("c",)],
                         lambda rt: ("serial", rt), batch_fn, monkeypatch)
    assert out["leader"] == (("serial", ("L",)), 0)
    assert len(fused) == 1 and sorted(fused[0]) == [("a",), ("b",), ("c",)]
    for name, rt in (("m0", ("a",)), ("m1", ("b",)), ("m2", ("c",))):
        assert out[name] == (("batched", rt), 3)
    info = bt.info()
    assert (info["batches_total"], info["batched_requests_total"], info["sizes"]) == \
        (1, 3, {3: 1})
    assert not bt._lanes["k"].busy


def test_batcher_whole_batch_failure_falls_back_serial(monkeypatch):
    bt = _mk(window_ms=5.0)

    def batch_fn(rts):
        raise RuntimeError("device fault")

    out = _fuse_via_hook(bt, [("a",), ("b",)], lambda rt: ("serial", rt), batch_fn,
                         monkeypatch)
    for name, rt in (("m0", ("a",)), ("m1", ("b",))):
        assert out[name] == (("serial", rt), 0)
    assert bt.info()["batches_total"] == 0
    assert not bt._lanes["k"].busy


def test_batcher_arity_mismatch_falls_back_serial(monkeypatch):
    bt = _mk(window_ms=5.0)
    out = _fuse_via_hook(bt, [("a",), ("b",)], lambda rt: ("serial", rt),
                         lambda rts: [("only-one", rts[0])], monkeypatch)
    for name, rt in (("m0", ("a",)), ("m1", ("b",))):
        assert out[name] == (("serial", rt), 0)


def test_batcher_member_error_is_its_own(monkeypatch):
    bt = _mk(window_ms=5.0)

    def batch_fn(rts):
        return [ValueError("lane poisoned") if rt == ("b",) else ("batched", rt)
                for rt in rts]

    out = _fuse_via_hook(bt, [("a",), ("b",), ("c",)], lambda rt: ("serial", rt),
                         batch_fn, monkeypatch)
    bad = [v for v in out.values() if isinstance(v, ValueError)]
    assert len(bad) == 1 and "lane poisoned" in str(bad[0])
    assert len([v for v in out.values() if isinstance(v, tuple) and v[1] == 3]) == 2


def test_batcher_singleton_window_runs_serial():
    bt = _mk(window_ms=1.0)
    lane = BA._Lane()
    bt._lanes["k"] = lane
    lane.busy = True
    out = {}

    def member():
        out["m"] = bt.execute("k", ("solo",), lambda rt: ("serial", rt),
                              lambda rts: pytest.fail("fused a singleton"))

    th = threading.Thread(target=member)
    th.start()
    t0 = time.monotonic()
    while not lane.queue and time.monotonic() - t0 < 10:
        time.sleep(0.001)
    bt._handoff(lane)
    th.join(30)
    assert out["m"] == (("serial", ("solo",)), 0)
    assert not lane.busy


def test_batcher_env_defaults_and_disable(monkeypatch):
    """The reference's three variables and defaults, and no other."""
    for var in ("TRINO_TPU_BATCH_WINDOW_MS", "TRINO_TPU_BATCH_MAX",
                "TRINO_TPU_TEMPLATE_BATCH"):
        monkeypatch.delenv(var, raising=False)
    info = BA.TemplateBatcher().info()
    assert (info["enabled"], info["window_ms"], info["max_batch"]) == (True, 2.0, 16)
    monkeypatch.setenv("TRINO_TPU_BATCH_WINDOW_MS", "5")
    monkeypatch.setenv("TRINO_TPU_BATCH_MAX", "4")
    info = BA.TemplateBatcher().info()
    assert (info["window_ms"], info["max_batch"]) == (5.0, 4)
    monkeypatch.setenv("TRINO_TPU_TEMPLATE_BATCH", "0")
    assert not BA.TemplateBatcher().enabled
    monkeypatch.setenv("TRINO_TPU_TEMPLATE_BATCH", "1")
    assert BA.TemplateBatcher().enabled
