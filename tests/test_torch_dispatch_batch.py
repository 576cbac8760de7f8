"""Dispatch coalescing in the port (``LocalExecutor._coalesced_batches``,
``dispatch_batch``) against the JAX package on the CPU.

Restates tests/test_dispatch_batch.py at its size (SF0.02, 2^11-row splits:
about a hundred lineitem splits) over bench.py's north-star queries
(``test_query_budgets.QUERIES``): widths 1 and 4 give byte-identical results
in the port, and each equals the reference's result (integers, decimals,
dates and strings exactly, DOUBLE within rtol 1e-9); ``coalesced_splits`` is
0 at width 1 and above 0 at width 4; width 4 reads the host less and moves
no more bytes; every split is generated once at either width; ``SET
SESSION dispatch_batch`` re-keys a cached plan; EXPLAIN ANALYZE shows the
coalesced splits.  Adds: ``/v1/metrics`` exports
``trino_tpu_coalesced_splits_total``, and a cluster task request carries
the statement's width to the worker, which coalesces at it.

On the CPU no kernel wrapper counts a launch, so ``device_dispatches`` is
the host reads.  Q1's direct group-by reads the host once per scan at any
width (its per-split work launches no port kernel and reads nothing), so Q1
holds ``<=`` where the reference holds ``<``; Q3, Q9 and Q18 hold ``<``.
Q18's host bytes rise by one materialization bucket at one site (the
test names it); every other query's bytes hold ``<=``.
The A/B sessions turn the adaptive advisor off: its ``dispatch_batch``
correction replaces the session's width on a re-plan (as in the reference,
where it makes tests/test_dispatch_batch.py::test_warm_dispatch_reduction
[q18] fail: ROADMAP C, known gaps).  The reference side runs each query once
(module scope).
"""

import os
import re
import sys
import urllib.request

import numpy as np
import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector

from test_query_budgets import QUERIES  # the tier-1 north-star queries

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF = 0.02
SPLIT_ROWS = 1 << 11
# the queries whose host reads fall with the width on the CPU (see the note)
STRICT = ("q3", "q9", "q18")
ORDER_BY = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("revenue", "o_orderdate"),
            "q9": ("nation", "o_year"), "q18": ("o_totalprice", "o_orderdate")}


def _session(e, batch):
    s = e.create_session("tpch")
    e.session_properties.set_property(s, "adaptive_execution", False)
    if batch is not None:
        e.session_properties.set_property(s, "dispatch_batch", batch)
    return s


@pytest.fixture(scope="module")
def ab():
    """One port engine, sessions at widths 1 and 4 (dispatch_batch is
    plan-shaping: each keys its own plan), and the reference's result of
    each query at its default width."""
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    js = j.create_session("tpch")
    ref = {q: j.execute_sql(sql, js) for q, sql in QUERIES.items()}
    yield e, _session(e, 1), _session(e, 4), ref
    e._invalidate()


def _byte_identical(r1, r4, name):
    assert r1.names == r4.names and r1.types == r4.types
    for decoded in (False, True):
        for cn, c1, c4 in zip(r1.names, r1.columns if decoded else r1.raw_columns,
                              r4.columns if decoded else r4.raw_columns):
            a1, a4 = np.asarray(c1), np.asarray(c4)
            assert a1.dtype == a4.dtype, (name, cn, a1.dtype, a4.dtype)
            assert np.array_equal(a1, a4), (name, cn, decoded)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_batch1_vs_batch4_results_byte_identical(ab, name):
    e, s1, s4, ref = ab
    r1 = e.execute_sql(QUERIES[name], s1)
    r4 = e.execute_sql(QUERIES[name], s4)
    assert len(r1) == len(r4) and len(r1) > 0
    _byte_identical(r1, r4, name)
    chip_smoke.same_result(r4, ref[name], f"{name} port vs reference",
                           order_by=ORDER_BY[name])


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_warm_dispatch_reduction(ab, name):
    e, s1, s4, _ = ab
    e.execute_sql(QUERIES[name], s1)
    c1 = e.last_query_counters
    e.execute_sql(QUERIES[name], s4)
    c4 = e.last_query_counters
    assert c1["coalesced_splits"] == 0, c1
    assert c4["coalesced_splits"] > 0, c4
    if name in STRICT:
        assert c4["device_dispatches"] < c1["device_dispatches"], (name, c1, c4)
    else:
        assert c4["device_dispatches"] <= c1["device_dispatches"], (name, c1, c4)
    if name != "q18":
        assert c4["host_bytes_pulled"] <= c1["host_bytes_pulled"], (name, c1, c4)
        return
    # Q18: the IN subquery's build page is materialized in one pow2 bucket
    # (at least 1024 rows) per coalesced group instead of one per split, and
    # here ends a bucket longer; the dynamic filter reads its whole valid
    # mask (join.prune.valid).  Every other site reads no more bytes.
    grew = {site for site in _site_bytes(c4)
            if _site_bytes(c4)[site] > _site_bytes(c1).get(site, 0)}
    assert grew <= {"join.prune.valid"}, (grew, c1, c4)
    assert c4["host_bytes_pulled"] <= 1.05 * c1["host_bytes_pulled"], (c1, c4)


def _site_bytes(c) -> dict:
    """Host bytes per read site, summed over the operators."""
    out: dict = {}
    for key, rec in c["sites"].items():
        site = key.split("/", 1)[-1]
        out[site] = out.get(site, 0) + rec.get("bytes", 0)
    return out


def test_pages_generated_once_per_split():
    """The width groups pages the connector made: each split is generated
    once at either width, and the results are byte-identical."""
    def run(batch):
        e = Engine(device="cpu")
        conn = TpchConnector(sf=0.01, split_rows=SPLIT_ROWS)
        calls = []
        orig = conn.generate
        conn.generate = lambda sp, cols=None: (calls.append(sp), orig(sp, cols))[1]
        e.register_catalog("tpch", conn)
        r = e.execute_sql(QUERIES["q3"], _session(e, batch))
        e._invalidate()
        return calls, r

    calls1, r1 = run(1)
    calls4, r4 = run(4)
    assert calls1 and sorted(map(repr, calls1)) == sorted(map(repr, calls4))
    _byte_identical(r1, r4, "q3")


def test_set_session_rides_plan_cache(ab):
    """SET SESSION dispatch_batch takes effect on a cached statement (the
    property keys the plan), and RESET returns to the default width (4).
    Q3: its host reads show the width on the CPU (Q1's do not)."""
    e = ab[0]
    s = _session(e, None)
    sql = QUERIES["q3"]
    e.execute_sql(sql, s)
    e.execute_sql(sql, s)
    assert e.last_query_counters["coalesced_splits"] > 0
    warm_default = e.last_query_counters["device_dispatches"]
    e.execute_sql("set session dispatch_batch = 1", s)
    e.execute_sql(sql, s)
    e.execute_sql(sql, s)
    assert e.last_query_counters["coalesced_splits"] == 0
    assert e.last_query_counters["device_dispatches"] > warm_default
    e.execute_sql("reset session dispatch_batch", s)
    e.execute_sql(sql, s)
    assert e.last_query_counters["coalesced_splits"] > 0


def test_explain_analyze_shows_coalescing(ab):
    e, _, s4, _ = ab
    r = e.execute_sql("explain analyze select count(*), sum(l_quantity) from lineitem", s4)
    text = "\n".join(str(row[0]) for row in r.rows())
    m = re.search(r"(\d+) splits coalesced", text)
    assert m is not None and int(m.group(1)) > 0, text


def test_metrics_export_coalesced_splits():
    from trino_tpu_torch.server import CoordinatorServer

    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=SPLIT_ROWS))
    srv = CoordinatorServer(e, port=0, dispatch_threads=1)
    srv.start()
    try:
        e.execute_sql(QUERIES["q1"], _session(e, 4))
        body = urllib.request.urlopen(srv.url + "/v1/metrics", timeout=10).read().decode()
    finally:
        srv.stop()
    assert "# TYPE trino_tpu_coalesced_splits_total counter" in body
    m = re.search(r"^trino_tpu_coalesced_splits_total (\d+)$", body, re.M)
    assert m is not None and int(m.group(1)) == e.counters_total.coalesced_splits > 0


def test_cluster_task_request_carries_the_width(tmp_path, monkeypatch):
    """Every task request ships the statement's width; the worker's
    executor runs the task at it and gives it back to the pool reset."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.server import cluster as C

    seen, widths = [], []
    orig_task, orig_batch = C.WorkerServer._run_task, LocalExecutor._batch

    def spy(self, req, tid, frag_id, node, st):
        seen.append(req.get("dispatch_batch"))
        return orig_task(self, req, tid, frag_id, node, st)

    def batch(self):
        widths.append(orig_batch(self))
        return widths[-1]

    monkeypatch.setattr(C.WorkerServer, "_run_task", spy)
    monkeypatch.setattr(LocalExecutor, "_batch", batch)
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=SPLIT_ROWS))
    spool = str(tmp_path / "spool")
    coord = C.ClusterCoordinator(e, spool, heartbeat_interval=0.2)
    url = coord.start()
    w = C.WorkerServer({"tpch": {"connector": "tpch", "sf": 0.01, "split_rows": SPLIT_ROWS}},
                       spool, coordinator_url=url, node_id="w0", device="cpu")
    try:
        w.start()
        coord.wait_for_workers(1, timeout=30)
        s = e.create_session("tpch")
        e.session_properties.set_property(s, "dispatch_batch", 2)
        got = coord.execute_sql(QUERIES["q1"], s)
        assert len(got) == 4
        after = [ex.dispatch_batch for ex in w._all_executors]
    finally:
        w.stop()
        coord.stop()
    assert seen and all(b == 2 for b in seen), seen
    assert widths and set(widths) == {2}, widths
    assert after and all(b is None for b in after), after
