"""The port's plan templates (``trino_tpu_torch/engine.py`` ``_template_*``,
``sql/ir.py`` ``bind_params``, ``exec/local_executor.py``
``_param_pruned_source``) against the JAX package on the CPU.

Restates tests/test_plan_templates.py, one case per reference test and per
parametrized statement.  Every statement runs in the reference (templates
on, result and page tiers off, as that file sets them) and in the port on
the CPU; their rows agree (integers, decimals, dates and strings exactly,
DOUBLE within rtol 1e-9), and so do their template hits and misses.  The
port's rows also equal, byte for byte, a port engine with templates off.
A port that raised where the reference binds would demote the text to
substitution and still give the right rows: the hits and misses, and the
``Plan template:`` EXPLAIN lines, are what show it does not.

Where the reference counts dispatches, the port holds its host reads and
their bytes to the templates-off engine's for the same binding.  The
reference's compile counts have no port counterpart: the port compiles no
plans.
"""

import os
import re
import sys
import threading

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the comparison helpers; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SF, SPLIT_ROWS = 0.01, 1 << 14


@pytest.fixture(scope="module")
def engines():
    """(reference, port, port with templates off) over TPC-H and a memory
    catalog, the result and page tiers off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRINO_TPU_RESULT_CACHE", "0")
        mp.setenv("TRINO_TPU_PAGE_CACHE", "0")
        mp.delenv("TRINO_TPU_PLAN_TEMPLATES", raising=False)
        j, t, b = JaxEngine(), Engine(device="cpu"), Engine(device="cpu")
        b.plan_templates_enabled = False
        j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
        j.register_catalog("mem", JaxMemory())
        for e in (t, b):
            e.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
            e.register_catalog("mem", MemoryConnector())
        yield j, t, b


@pytest.fixture()
def eng(engines):
    """The module's engines with no template and no cached plan, as the
    reference's fresh engine of each test has none."""
    for e in engines:
        with e._plan_lock:
            e._plan_cache.clear()
            e._template_cache.clear()
    return engines


def _counts(e):
    """(plan_template_hits, plan_template_misses) of the last statement."""
    c = e.last_query_counters
    if isinstance(c, dict):
        return c.get("plan_template_hits", 0), c.get("plan_template_misses", 0)
    return c.plan_template_hits, c.plan_template_misses


def _spans(e):
    trace = e.last_query_trace if isinstance(e, Engine) else e._thread_accounting.trace
    return [s.get("name") for s in (trace or {}).get("spans", ())]




def _sessions(engines, catalog="tpch"):
    return tuple(e.create_session(catalog) for e in engines)


def _run(engines, sessions, stmt, **kw):
    """``stmt`` in the three engines: the port equals the reference and, byte
    for byte, the templates-off port; hits and misses equal the reference's.
    Returns the port's result."""
    (j, t, b), (sj, st, sb) = engines, sessions
    a = j.execute_sql(stmt, sj, **kw)
    r = t.execute_sql(stmt, st, **kw)
    o = b.execute_sql(stmt, sb, **kw)
    chip_smoke.same_outcome_result(r, a, stmt, stmt)
    chip_smoke.same_bytes(r, o, stmt)
    assert _counts(t) == _counts(j), (stmt, _counts(t), _counts(j))
    return r


def _prepare(engines, sessions, text, name="p"):
    for e, s in zip(engines, sessions):
        e.execute_sql(f"prepare {name} from {text}", s)


def _raises_alike(engines, sessions, stmt, match):
    """Every engine raises, the port and the reference with one message."""
    msgs = []
    for e, s in zip(engines, sessions):
        with pytest.raises(Exception, match=match) as ei:
            e.execute_sql(stmt, s)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0], msgs


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("text,bindings", [
    ("select c_name, c_acctbal from customer where c_custkey = ?",
     ["42", "97", "1", "null"]),
    ("select c_custkey from customer where c_acctbal < ? "
     "order by c_custkey limit 5",
     ["0.00", "-123.45", "9999.99"]),
    ("select c_custkey, c_acctbal * ? from customer "
     "where c_custkey < ? order by c_custkey limit 4",
     ["1.5e0, 10", "0.25e1, 7"]),
    ("select c_custkey from customer where c_mktsegment = ? "
     "order by c_custkey limit 6",
     ["'BUILDING'", "'AUTOMOBILE'", "'no-such-segment'", "null"]),
    ("select c_custkey from customer where c_mktsegment <> ? "
     "order by c_custkey limit 3",
     ["'BUILDING'", "'MACHINERY'"]),
    ("select o_orderkey from orders where o_orderdate < ? "
     "order by o_orderkey limit 5",
     ["date '1995-03-15'", "date '1992-06-01'"]),
    ("select c_custkey from customer where c_custkey in (?, ?, ?) "
     "order by c_custkey",
     ["3, 5, 7", "10, 11, 12"]),
    ("select c_custkey from customer where c_mktsegment in (?, ?) "
     "order by c_custkey limit 4",
     ["'BUILDING', 'MACHINERY'", "'AUTOMOBILE', 'HOUSEHOLD'"]),
    ("select c_custkey from customer where c_acctbal between ? and ? "
     "order by c_custkey limit 5",
     ["100.0, 500.0", "-100.5, 50"]),
], ids=["int_key", "decimal_lt", "double_project", "dict_eq", "dict_neq", "date_lt",
        "int_in", "dict_in", "decimal_between"])
def test_warm_execute_parity(eng, text, bindings):
    sessions = _sessions(eng)
    _prepare(eng, sessions, text)
    for i, bnd in enumerate(bindings):
        _run(eng, sessions, f"execute p using {bnd}")
        assert _counts(eng[1]) == ((0, 1) if i == 0 else (1, 0)), bnd


def test_timestamp_parameter(eng):
    sessions = _sessions(eng, "mem")
    for e, s in zip(eng, sessions):
        e.execute_sql("create table ts_t (id bigint, ts timestamp(3))", s)
        e.execute_sql(
            "insert into ts_t values (1, timestamp '2020-01-01 00:00:00'), "
            "(2, timestamp '2020-06-01 12:30:00'), "
            "(3, timestamp '2021-01-01 00:00:00')", s)
    try:
        _prepare(eng, sessions, "select id from ts_t where ts < ? order by id")
        for bnd in ["timestamp '2020-06-01 12:30:00'", "timestamp '2022-01-01 00:00:00'"]:
            _run(eng, sessions, f"execute p using {bnd}")
        assert _counts(eng[1]) == (1, 0)
    finally:
        for e, s in zip(eng, sessions):
            e.execute_sql("drop table ts_t", s)


# ------------------------------------------------- no planning on a hit
def test_warm_execute_no_planner_span_and_read_parity(eng):
    j, t, b = eng
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_name, c_acctbal from customer where c_custkey = ?")
    _run(eng, sessions, "execute p using 42")
    _run(eng, sessions, "execute p using 97")
    assert _counts(t) == (1, 0)
    assert "planner" not in _spans(t) and "planner" not in _spans(j)
    # the warm template EXECUTE reads what the warm inline statement reads
    inline = "select c_name, c_acctbal from customer where c_custkey = 97"
    sb = b.create_session("tpch")
    b.execute_sql(inline, sb)
    b.execute_sql(inline, sb)
    want = b.last_query_counters
    t.execute_sql("execute p using 97", sessions[1])
    got = t.last_query_counters
    assert (got["host_reads"], got["host_bytes"]) == (want["host_reads"], want["host_bytes"])
    # the bound slot reached the device once: its value and its null flag
    assert got["h2d_bytes"] == 4 + 1


def test_warm_auto_param_no_planner_span(eng):
    tmpl = "select c_name from customer where c_custkey = {}"
    sessions = _sessions(eng)
    _run(eng, sessions, tmpl.format(10))
    assert _counts(eng[1]) == (0, 1)
    for k in (20, 30):
        _run(eng, sessions, tmpl.format(k))
        assert _counts(eng[1]) == (1, 0)
        assert "planner" not in _spans(eng[1])


def test_identical_repeat_spends_zero_plan_work(eng):
    sql = "select c_name from customer where c_custkey = 77"
    sessions = _sessions(eng)
    _run(eng, sessions, sql)
    _run(eng, sessions, sql)
    assert _counts(eng[1]) == (1, 0)
    assert "planner" not in _spans(eng[1])


# ------------------------------------------------------------- fallbacks
def test_limit_parameter_falls_back_byte_identical(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_custkey from customer order by c_custkey limit ?")
    for bnd in ("3", "7"):
        r = _run(eng, sessions, f"execute p using {bnd}")
        assert len(r) == int(bnd)
        assert _counts(eng[1])[0] == 0


def test_typewidth_overflow_falls_back_then_template_survives(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_custkey from customer where c_custkey = ? "
                            "or c_custkey + ? < 0")
    _run(eng, sessions, "execute p using 5, 1")
    _run(eng, sessions, "execute p using 5, 1099511627776")
    assert _counts(eng[1])[0] == 0
    _run(eng, sessions, "execute p using 9, 2")
    assert _counts(eng[1]) == (1, 0)


def test_aggregate_statement_falls_back(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select count(*) c from customer where c_mktsegment = ?")
    for bnd in ("'BUILDING'", "'MACHINERY'"):
        _run(eng, sessions, f"execute p using {bnd}")
        assert _counts(eng[1])[0] == 0


def test_unsupported_parameter_kind_typed_error(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_custkey from customer where c_custkey = ?")
    for e, s in zip(eng, sessions):
        with pytest.raises(ValueError, match="parameter"):
            e.execute_sql("execute p using c_custkey + 1", s)


def test_arity_mismatch_raises(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_custkey from customer where c_custkey = ?")
    _raises_alike(eng, sessions, "execute p using 1, 2", "parameter")
    _raises_alike(eng, sessions, "execute p", "parameter")


# ----------------------------------------------------------- concurrency
def test_concurrent_execute_two_sessions(eng):
    j, t, b = eng
    text = "select c_name, c_acctbal from customer where c_custkey = ?"
    sessions = _sessions(eng)
    _prepare(eng, sessions, text)
    _run(eng, sessions, "execute p using 1")
    keys = list(range(1, 41))
    expected = {k: b.execute_sql(text.replace("?", str(k)), sessions[2]) for k in keys}
    for k in (1, 17, 40):  # and the reference agrees with the oracle
        chip_smoke.same_outcome_result(
            expected[k], j.execute_sql(text.replace("?", str(k)), sessions[0]), text, text)
    errors: list = []

    def worker(offset):
        sess = t.create_session("tpch")
        t.execute_sql(f"prepare p from {text}", sess)
        for k in keys[offset::2]:
            try:
                got = t.execute_sql(f"execute p using {k}", sess)
                chip_smoke.same_bytes(got, expected[k], f"key {k}")
                if t.last_query_counters["plan_template_hits"] != 1:
                    errors.append(f"{k}: not a template hit")
            except Exception as e:  # noqa: BLE001
                errors.append(f"{k}: {e!r}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors


# ------------------------------------------------- result-cache interplay
@pytest.fixture()
def result_engines(monkeypatch):
    """(reference, port) with a 64 MiB result tier and the page tier off."""
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(64 << 20))
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
    monkeypatch.delenv("TRINO_TPU_PLAN_TEMPLATES", raising=False)
    j, t = JaxEngine(), Engine(device="cpu")
    j.register_catalog("tpch", JaxTpch(sf=SF, split_rows=SPLIT_ROWS))
    t.register_catalog("tpch", TpchConnector(sf=SF, split_rows=SPLIT_ROWS))
    return j, t


def _result_hits(e):
    c = e.last_query_counters
    return c["result_cache_hits"] if isinstance(c, dict) else c.result_cache_hits


def test_result_cache_entries_are_binding_specific(result_engines):
    j, t = result_engines
    sj, st = j.create_session("tpch"), t.create_session("tpch")
    text = "select c_name, c_acctbal from customer where c_custkey = ?"
    outs = {}
    for stmt in (f"prepare p from {text}", "execute p using 42", "execute p using 97",
                 "execute p using 42", "execute p using 97"):
        a, r = j.execute_sql(stmt, sj), t.execute_sql(stmt, st)
        if a is not None:
            chip_smoke.same_outcome_result(r, a, stmt, stmt)
            assert _result_hits(t) == _result_hits(j), stmt
            outs.setdefault(stmt, []).append(r)
    assert _result_hits(t) == 1
    assert t.last_query_counters["host_reads"] == 0
    assert outs["execute p using 42"][0].rows() != outs["execute p using 97"][0].rows()
    for stmt, (first, again) in outs.items():
        chip_smoke.same_bytes(first, again, stmt)


def test_volatile_check_on_template_text_not_binding(result_engines):
    j, t = result_engines
    sj, st = j.create_session("tpch"), t.create_session("tpch")
    stmts = ["prepare p from select c_custkey from customer where c_mktsegment = ? "
             "order by c_custkey limit 3",
             "execute p using 'random() now() uuid()'",
             "execute p using 'random() now() uuid()'"]
    hits = []
    for stmt in stmts:
        a, r = j.execute_sql(stmt, sj), t.execute_sql(stmt, st)
        if a is not None:
            chip_smoke.same_outcome_result(r, a, stmt, stmt)
        hits.append((_result_hits(t), _result_hits(j)))
    assert hits[-1] == (1, 1)
    for stmt in ("prepare pv from select c_custkey from customer "
                 "where c_custkey = ? and now() is not null",
                 "execute pv using 5", "execute pv using 5"):
        j.execute_sql(stmt, sj)
        t.execute_sql(stmt, st)
    assert _result_hits(t) == _result_hits(j) == 0


# ------------------------------------------- plan-cache key normalization
def test_plan_cache_key_normalization(eng):
    sessions = _sessions(eng)
    a = _run(eng, sessions, "select c_name from customer where c_custkey = 123454321")
    b = _run(eng, sessions, "select  c_name\n  from customer   -- trailing comment\n"
                            " where /* block\n comment */ c_custkey =     123454321")
    chip_smoke.same_bytes(a, b, "normalized")
    assert "planner" not in _spans(eng[1]) and "planner" not in _spans(eng[0])


# ------------------------------------------------------------ lifecycle
def test_ddl_invalidates_templates(eng):
    sessions = _sessions(eng, "mem")
    for e, s in zip(eng, sessions):
        e.execute_sql("create table inv_t (k bigint, v double)", s)
        e.execute_sql("insert into inv_t values (1, 1.5), (2, 2.5)", s)
        e.execute_sql("prepare p from select v from inv_t where k = ?", s)
    try:
        _run(eng, sessions, "execute p using 1")
        for e, s in zip(eng, sessions):
            e.execute_sql("insert into inv_t values (3, 9.5)", s)
        assert not eng[1]._template_cache
        got = _run(eng, sessions, "execute p using 3")
        assert len(got) == 1
    finally:
        for e, s in zip(eng, sessions):
            e.execute_sql("drop table inv_t", s)


def test_null_first_binding_does_not_poison_template(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_name from customer where c_custkey = ?")
    _run(eng, sessions, "execute p using null")
    assert _counts(eng[1]) == (0, 0)
    _run(eng, sessions, "execute p using 7")
    _run(eng, sessions, "execute p using 8")
    assert _counts(eng[1]) == (1, 0)
    got = _run(eng, sessions, "execute p using null")
    assert len(got) == 0 and _counts(eng[1]) == (1, 0)


def test_bind_time_split_pruning(monkeypatch):
    """A parameterized point predicate prunes splits per execution from the
    bound values: the template run generates the one split the substituted
    run's static pruning keeps, and reads what it reads."""
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
    monkeypatch.delenv("TRINO_TPU_PLAN_TEMPLATES", raising=False)
    j = JaxEngine()
    j.register_catalog("tpch", JaxTpch(sf=0.05, split_rows=1 << 10))
    conn = TpchConnector(sf=0.05, split_rows=1 << 10)  # 8 customer splits
    generated = []
    gen = conn.generate
    monkeypatch.setattr(conn, "generate",
                        lambda split, cols: generated.append(split) or gen(split, cols))
    t, b = Engine(device="cpu"), Engine(device="cpu")
    b.plan_templates_enabled = False
    t.register_catalog("tpch", conn)
    b.register_catalog("tpch", conn)
    engines = (j, t, b)
    sessions = _sessions(engines)
    _prepare(engines, sessions, "select c_name, c_acctbal from customer where c_custkey = ?")
    _run(engines, sessions, "execute p using 42")
    runs = {}
    for e, s in ((t, sessions[1]), (b, sessions[2])):
        generated.clear()
        got = e.execute_sql("execute p using 7000", s)
        runs[e is t] = (got, list(generated), dict(e.last_query_counters))
    (got, splits, c), (want, wsplits, wc) = runs[True], runs[False]
    chip_smoke.same_outcome_result(got, j.execute_sql("execute p using 7000", sessions[0]),
                                   "", "pruned")
    chip_smoke.same_bytes(got, want, "pruned")
    assert len(got) == 1 and c["plan_template_hits"] == 1
    assert len(splits) == 1 and splits == wsplits
    assert (c["host_reads"], c["host_bytes"]) == (wc["host_reads"], wc["host_bytes"])


def test_question_mark_inside_comment_substitutes(eng):
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select count(*) c from customer where c_custkey > ? -- really?")
    _run(eng, sessions, "execute p using 1400")


def test_volatile_statement_never_templates(eng):
    j, t, _ = eng
    sj, st = j.create_session("tpch"), t.create_session("tpch")
    for k in (1, 2, 3):
        stmt = f"select now(), c_name from customer where c_custkey = {k}"
        a, r = j.execute_sql(stmt, sj), t.execute_sql(stmt, st)
        assert r.columns[1].tolist() == a.columns[1].tolist()
        assert _counts(t) == _counts(j) and _counts(t)[0] == 0
    for stmt in ("prepare pv from select now(), c_name from customer where c_custkey = ?",
                 "execute pv using 5", "execute pv using 6"):
        j.execute_sql(stmt, sj)
        t.execute_sql(stmt, st)
    assert _counts(t) == _counts(j) and _counts(t)[0] == 0


def test_illtyped_binding_does_not_poison_other_kinds(eng):
    j, t, b = eng
    sessions = _sessions(eng)
    _raises_alike(eng, sessions, "select c_custkey from customer where c_mktsegment = 5 "
                                 "order by c_custkey limit 3", None)
    tmpl = ("select c_custkey from customer where c_mktsegment = '{}' "
            "order by c_custkey limit 3")
    _run(eng, sessions, tmpl.format("BUILDING"))
    _run(eng, sessions, tmpl.format("MACHINERY"))
    assert _counts(t) == (1, 0)


def test_protocol_float_parameter_stays_double(eng):
    sessions = _sessions(eng)
    sql = ("select c_custkey, c_acctbal * ? from customer "
           "where c_custkey < ? order by c_custkey limit 3")
    r = _run(eng, sessions, sql, parameters=[2.5, 10])
    assert r.types[1].name == "double"
    assert _counts(eng[1]) == (0, 1)
    _run(eng, sessions, sql, parameters=[0.5, 7])
    assert _counts(eng[1]) == (1, 0)


# --------------------------------------------------------- observability
def _explain_lines(e, s, stmt):
    return [re.sub(r"executed in [0-9.]+ ms", "executed in T ms", r[0])
            for r in e.execute_sql(stmt, s).rows()]


def test_explain_execute_lines_equal_the_reference(eng):
    """EXPLAIN EXECUTE prints the reference's lines before the template
    exists, with it (its plan and the cached line), and for an unbindable
    text; EXPLAIN ANALYZE EXECUTE the plan, the hit and the row count."""
    j, t, _ = eng
    sessions = _sessions(eng)
    _prepare(eng, sessions, "select c_name from customer where c_custkey = ?")
    _prepare(eng, sessions, "select count(*) c from customer where c_custkey > ?", "q")
    both = [[_explain_lines(e, s, "explain execute p")] for e, s in ((j, sessions[0]),
                                                                      (t, sessions[1]))]
    assert both[0] == both[1] and "not yet created" in both[1][0][0]
    _run(eng, sessions, "execute p using 3")
    _run(eng, sessions, "execute q using 3")
    for stmt in ("explain execute p", "explain execute p using 4", "explain execute q"):
        a, r = (_explain_lines(e, s, stmt) for e, s in ((j, sessions[0]), (t, sessions[1])))
        assert r == a, (stmt, r, a)
    cached = _explain_lines(t, sessions[1], "explain execute p")
    assert "TableScan" in "\n".join(cached)
    assert cached[-1] == "Plan template: cached, 1 bound slot(s) over 1 parameter(s)"
    assert _explain_lines(t, sessions[1], "explain execute q") == [
        "Plan template: unbindable — substitution path"]
    # ANALYZE: the reference's lines; each package attributes its launches
    # and reads to its own call sites, so the site lines are compared apart
    a = _explain_lines(j, sessions[0], "explain analyze execute p using 5")
    r = _explain_lines(t, sessions[1], "explain analyze execute p using 5")
    assert "Plan template: 1 hits, 0 misses" in r
    assert [x for x in r if not x.startswith("    site ")] == \
        [x for x in a if not x.startswith("    site ")], (r, a)
    assert any(x.startswith("    site Result/") for x in r), r


def test_protocol_parameters_and_metrics(eng):
    from trino_tpu_torch.server.client import Client
    from trino_tpu_torch.server.server import CoordinatorServer

    j, t, _ = eng
    sql = "select c_name, c_acctbal from customer where c_custkey = ?"
    server = CoordinatorServer(t, port=0)
    server.start()
    try:
        client = Client(server.url, catalog="tpch", poll_interval=0.002)
        r1 = client.execute(sql, params=[42])
        r2 = client.execute(sql, params=[97])
        assert r1.rows and r2.rows and r1.rows != r2.rows
        assert r1.rows[0][0] == "Customer#000000042"
        r3 = client.execute(sql, params=[42])
        assert r3.rows == r1.rows
        want = j.execute_sql(sql, j.create_session("tpch"), parameters=[97])
        assert [tuple(x) for x in r2.rows] == [
            (n, float(v)) for n, v in zip(want.columns[0].tolist(), want.columns[1].tolist())]
        body = server._metrics_text()
        hits = [ln for ln in body.splitlines()
                if ln.startswith("trino_tpu_plan_template_hits_total")]
        misses = [ln for ln in body.splitlines()
                  if ln.startswith("trino_tpu_plan_template_misses_total")]
        assert hits and int(hits[0].split()[-1]) >= 2
        assert misses and int(misses[0].split()[-1]) >= 1
    finally:
        server.stop()



def test_template_cache_keeps_the_most_recent_shapes(eng, monkeypatch):
    """Every new ad-hoc statement shape adds a template or a negative entry:
    the cache keeps at most PLAN_CACHE_ENTRIES of them, least recently used
    out first, and a hit counts as a use."""
    import trino_tpu_torch.engine as E
    from trino_tpu_torch.sql.params import parameterize_text

    t = eng[1]
    monkeypatch.setattr(E, "PLAN_CACHE_ENTRIES", 3)
    s = t.create_session("tpch")
    hot = "select c_name from customer where c_custkey = {}"
    others = [f"select {c} from customer where c_custkey = {{}}"
              for c in ("c_address", "c_phone", "c_acctbal", "c_comment")]
    t.execute_sql(hot.format(1), s)
    for k, other in enumerate(others):
        t.execute_sql(other.format(k + 2), s)
        t.execute_sql(hot.format(k + 10), s)  # a hit keeps the hot shape
        assert t.last_query_counters["plan_template_hits"] == 1
    keys = [t._template_key(parameterize_text(sql.format(1))[0], s)
            for sql in [hot] + others]
    assert list(t._template_cache) == [keys[3], keys[4], keys[0]]
