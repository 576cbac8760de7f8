"""The port end to end: all of TPC-H (Q15 through the view it reads,
created before it and dropped after it in both packages) through
``trino_tpu_torch.Engine(device="cpu").execute_sql`` against
``trino_tpu.Engine`` at SF0.01 -- bench.py's SQL for Q1, Q3, Q4, Q9 and
Q18, the SQL of tests/test_sql_tpch*.py for the rest, and the tests' Q18 as
well (bench.py's Q18 returns no rows at SF0.01).

Tolerances: integer, decimal, date, bool and dictionary-id columns exactly;
DOUBLE within rtol 1e-9; row order compared because every query orders its
rows.  Also: joins whose build side filters to zero rows, and the
NotImplementedError a plan outside the port gets.
"""

import ast
import os

import numpy as np
import pytest
import torch

from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_queries():
    """bench.py's QUERIES, read without importing bench (it configures jax)."""
    tree = ast.parse(open(os.path.join(_ROOT, "bench.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "QUERIES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("bench.py has no QUERIES")


def _assigned(path, name):
    tree = ast.parse(open(path).read())
    return next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in n.targets))


def _tests_tpch_sql():
    """{"q<N>": sql} of tests/test_sql_tpch*.py: the statement each test_q<N>
    passes to ``run``; "q15_view": the view test_q15 creates first."""
    out = {}
    for fn in ("test_sql_tpch.py", "test_sql_tpch2.py", "test_sql_tpch3.py"):
        tree = ast.parse(open(os.path.join(_ROOT, "tests", fn)).read())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_q"):
                call = next(c for c in ast.walk(node) if isinstance(c, ast.Call)
                            and isinstance(c.func, ast.Name) and c.func.id == "run")
                out[node.name[len("test_"):]] = call.args[1].value
                if node.name == "test_q15":
                    view = next(c for c in ast.walk(node) if isinstance(c, ast.Call)
                                and isinstance(c.func, ast.Attribute)
                                and c.func.attr == "execute_sql")
                    out["q15_view"] = view.args[0].value
    return out


QUERIES = _bench_queries()
SMOKE = os.path.join(_ROOT, "chip_smoke.py")
TPCH = _assigned(SMOKE, "TPCH_QUERIES")
Q15_VIEW = _assigned(SMOKE, "Q15_VIEW")
ALL = {**QUERIES, **TPCH, "q18_tests": _tests_tpch_sql()["q18"]}


@pytest.fixture(scope="module")
def torch_engine():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(sf=0.01))
    return e


def _assert_same(a, b):
    assert tuple(a.names) == tuple(b.names)
    assert len(a) == len(b)
    for name, t, ca, cb in zip(a.names, a.types, a.raw_columns, b.raw_columns):
        ca, cb = np.asarray(ca), np.asarray(cb)
        if t.is_floating:
            np.testing.assert_allclose(cb, ca, rtol=1e-9, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(cb, ca, err_msg=name)
    for t, ca, cb in zip(a.types, a.columns, b.columns):  # decoded strings, dates
        if t.is_floating:
            continue  # compared within rtol above
        assert [str(x) for x in np.asarray(ca).tolist()] == \
            [str(x) for x in np.asarray(cb).tolist()]


@pytest.mark.parametrize("q", sorted(ALL))
def test_query_equals_reference(engine, torch_engine, q):
    views = [e for e in (engine, torch_engine) if q == "q15"]
    for e in views:
        e.execute_sql(Q15_VIEW, e.create_session("tpch"))
    try:
        ref = engine.execute_sql(ALL[q], engine.create_session("tpch"))
        got = torch_engine.execute_sql(ALL[q], torch_engine.create_session("tpch"))
        reads = torch_engine.last_query_counters["host_reads"]
    finally:
        for e in views:
            e.execute_sql("drop view revenue0", e.create_session("tpch"))
    assert len(got) > 0 or q == "q18"  # bench.py's Q18 is empty at SF0.01
    _assert_same(ref, got)
    assert reads > 0


EMPTY_BUILD = {
    "q3_no_such_segment": QUERIES["q3"].replace("'BUILDING'", "'NO SUCH SEGMENT'"),
    "q9_no_such_color": QUERIES["q9"].replace("%green%", "%no such color%"),
}


@pytest.mark.parametrize("name", sorted(EMPTY_BUILD))
def test_join_with_empty_build_side(engine, torch_engine, name):
    ref = engine.execute_sql(EMPTY_BUILD[name], engine.create_session("tpch"))
    got = torch_engine.execute_sql(EMPTY_BUILD[name], torch_engine.create_session("tpch"))
    assert len(ref) == len(got) == 0
    assert tuple(ref.names) == tuple(got.names)


def test_chip_smoke_runs_the_bench_sql():
    assert _assigned(SMOKE, "QUERIES") == QUERIES
    assert set(QUERIES) == {"q1", "q3", "q4", "q9", "q18"}


def test_chip_smoke_copies_the_tests_tpch_sql():
    tests = _tests_tpch_sql()
    assert set(TPCH) == set(tests) - set(QUERIES) - {"q15_view"}
    assert TPCH == {q: tests[q] for q in TPCH}
    assert Q15_VIEW == tests["q15_view"]


def test_plan_outside_the_slice_raises_naming_the_path(torch_engine, monkeypatch):
    # a join build that does not fit the memory pool takes the Grace
    # partitioning the port now has; a plan of the distributed path (its
    # exchanges, ROADMAP A7) is still outside the port
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.sql.exchanges import physical_plan
    from trino_tpu_torch.sql.frontend import compile_sql

    sql = "select count(*) from lineitem join orders on l_orderkey = o_orderkey"
    session = torch_engine.create_session("tpch")
    full = torch_engine.execute_sql(sql, session).rows()
    monkeypatch.setattr(torch_engine.memory_pool, "max_bytes", 0)
    assert torch_engine.execute_sql(sql, session).rows() == full
    plan = physical_plan(compile_sql(sql, torch_engine, session), torch_engine.catalogs)
    with pytest.raises(NotImplementedError, match="Exchange node"):
        LocalExecutor(torch_engine.catalogs, "cpu").execute(plan)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine()
    assert TorchEngine(device="cpu").device.type == "cpu"


def test_register_binds_the_engine_device():
    conn = TorchTpch(sf=0.01)
    assert conn.device is None
    TorchEngine(device="cpu").register_catalog("tpch", conn)
    assert conn.device == torch.device("cpu")
