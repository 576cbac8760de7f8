"""The port's statements past SELECT against the JAX package on the CPU.

Each case is a statement sequence restated from a reference test, run
statement by statement in both packages (``trino_tpu.Engine`` and
``trino_tpu_torch.Engine(device="cpu")``) over the same catalogs:

- tests/test_memory_dml.py, every case but ``test_explain_analyze``;
- tests/test_merge.py, all ten cases;
- tests/test_window_frames2.py over its memory table;
- the four memory-catalog cases of tests/test_window_setops.py;
- tests/test_routines.py's function cases and the materialized-view case
  of tests/test_security.py (without their SHOW statements; SHOW and the
  other statements of the control plane are held by
  ``test_statements_left_out_raise_naming_them`` and
  tests/test_torch_control_plane.py);
- tests/test_sql_tpch3.py::test_q15 (CREATE VIEW, the query, DROP VIEW);
- TPC-H's refresh path as ``chip_smoke.py`` phase 8 runs it (CTAS, RF1's
  MERGE and INSERT, the query set with Q15, RF2's DELETEs and UPDATEs, the
  query set again) at SF0.01, with key bands of 15 orders, over memory
  pages of 2^14 rows (four pages of lineitem, the last one short).

Every statement's outcome must agree: ``None`` for DDL; affected-row counts
equal; query results equal (integer, decimal, date and string columns and
NULL masks exactly, DOUBLE within rtol 1e-9, row order compared where the
statement orders its rows, else as sorted lists); an error of the same type
with the same message.  Also: a query never changes a stored table (the
checksums of every numeric column before and after the query set), and the
refresh path's memory tables equal ``tpch`` after RF1.
"""

import os
import re
import sys

import numpy as np
import pytest

import trino_tpu.connectors.memory as jax_memory
import trino_tpu_torch.connectors.memory as torch_memory
from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the statement definitions; imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


# -- comparison --------------------------------------------------------------------------


def _ordered(sql: str) -> bool:
    """Whether the statement's outermost query orders its rows."""
    return re.search(r"order\s+by[^()]*$", sql.strip(), re.I) is not None


def _rows(r, ids=True):
    """Rows of raw values; strings as their decoded values unless ``ids``."""
    cols = [list(d) if t.is_string and not ids else list(c)
            for t, c, d in zip(r.types, r.raw_columns, r.columns)]
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in row)
            for row in zip(*cols)]


def _assert_same(a, b, ordered, what="", ids=True):
    """``ids=False`` compares strings by value: for results over two
    catalogs whose dictionaries number the same strings differently."""
    assert tuple(a.names) == tuple(b.names), what
    assert len(a) == len(b), what
    na = [np.array([v is None for v in c], bool) for c in a.columns]
    nb = [np.array([v is None for v in c], bool) for c in b.columns]
    ra, rb = _rows(a, ids), _rows(b, ids)
    # a NULL's raw value is a fill value: compare it as None
    ra = [tuple(None if na[i][k] else v for i, v in enumerate(r)) for k, r in enumerate(ra)]
    rb = [tuple(None if nb[i][k] else v for i, v in enumerate(r)) for k, r in enumerate(rb)]
    if not ordered:
        ra, rb = sorted(ra, key=repr), sorted(rb, key=repr)
    for i, t_ in enumerate(a.types):
        ca = [r[i] for r in ra]
        cb = [r[i] for r in rb]
        assert [v is None for v in ca] == [v is None for v in cb], (what, a.names[i])
        if t_.is_floating:
            x = np.array([v for v in ca if v is not None], np.float64)
            y = np.array([v for v in cb if v is not None], np.float64)
            np.testing.assert_allclose(y, x, rtol=1e-9, atol=0, err_msg=f"{what} {a.names[i]}")
        else:
            assert ca == cb, (what, a.names[i])
    for t_, ca, cb in zip(a.types, a.columns, b.columns):  # decoded strings, dates
        if t_.is_floating or not ordered:
            continue
        assert [str(x) for x in list(ca)] == [str(x) for x in list(cb)], what


def _outcome(engine, sql, sess):
    try:
        return "ok", engine.execute_sql(sql, sess)
    except Exception as e:  # noqa: BLE001 - both packages' errors are compared
        return "error", e


def run_both(j, t, sql, sj=None, st=None):
    """Run one statement in both packages and hold the outcomes equal;
    returns the port's result (or error)."""
    kj, a = _outcome(j, sql, sj)
    kt, b = _outcome(t, sql, st)
    if kj == "error":
        assert kt == "error", f"the reference raised {a!r}, the port returned: {sql}"
        assert type(b).__name__ == type(a).__name__, (sql, a, b)
        assert str(b) == str(a), sql
        return b
    assert kt == "ok", f"the port raised {b!r}: {sql}"
    if a is None:
        assert b is None, sql
    else:
        assert b is not None, sql
        _assert_same(a, b, _ordered(sql), sql)
        # raw spans alone do not prove two heaps equal
        chip_smoke.same_nested(a, b, sql, _ordered(sql))
    return b


# -- the cases ---------------------------------------------------------------------------


def _window_frames2_rows():
    """tests/test_window_frames2.py's memory table: the same seeded rows."""
    import datetime

    rng = np.random.default_rng(11)
    rows = []
    day = 9000
    for g in range(3):
        for i in range(40):
            day += int(rng.integers(1, 4))
            dt = datetime.date(1970, 1, 1) + datetime.timedelta(days=day)
            x = int(rng.integers(0, 50))
            v = "null" if (i % 7 == 3) else int(rng.integers(-30, 100))
            rows.append(f"({g}, date '{dt.isoformat()}', {x}, {v})")
    return "insert into m values " + ", ".join(rows)


MERGE_SETUP = [
    "create table tgt (id bigint, name varchar, qty bigint)",
    "insert into tgt values (1, 'a', 10), (2, 'b', 20), (3, 'c', 30)",
    "create table src (id bigint, name varchar, qty bigint)",
    "insert into src values (2, 'B', 200), (3, 'c', -1), (4, 'd', 40)",
]
BIG = (1 << 53) + 1

# name: (catalogs, session catalog, statements); catalogs "mem" = a memory
# catalog named mem, "memory+tpch" = tpch SF0.01 and a memory catalog named
# memory (tests/test_memory_dml.py's mem_engine), "tpch" = tpch alone
CASES = {
    # tests/test_memory_dml.py
    "dml_create_insert_select": ("memory+tpch", None, [
        "create table t (a bigint, b varchar, c decimal(10,2), d date)",
        "insert into t values (1, 'x', 1.50, date '2020-01-02'), "
        "(2, 'y', 2.25, date '2021-03-04'), (3, null, null, null)",
        "select * from t order by a"]),
    "dml_null_group_and_sort": ("memory+tpch", None, [
        "create table t (a bigint, b varchar, c decimal(10,2))",
        "insert into t values (1, 'x', 1.50), (2, 'y', 2.25), (3, null, null), (4, null, 5.00)",
        "select b, sum(c) s, count(*) n from t group by b order by b nulls first",
        "select b from t group by b order by b"]),
    "dml_ctas_and_cross_catalog_join": ("memory+tpch", None, [
        "create table amerika as select n_name, n_regionkey from nation where n_regionkey = 1",
        "select count(*) c from amerika",
        "select a.n_name, r_name from amerika a, region "
        "where a.n_regionkey = r_regionkey order by a.n_name",
        "drop table amerika"]),
    "dml_insert_select_and_partial_columns": ("memory+tpch", None, [
        "create table t (a bigint, b varchar)",
        "insert into t (a) values (7)",
        "insert into t select n_nationkey, n_name from nation where n_nationkey < 2",
        "select a, b from t order by a"]),
    "dml_drop_and_if_exists": ("memory+tpch", None, [
        "create table t (a bigint)",
        "drop table t",
        "select * from t",
        "drop table if exists t",
        "create table if not exists t2 (a bigint)",
        "create table if not exists t2 (a bigint)",
        "create table t2 (a bigint)"]),
    "dml_table_properties_refused": ("memory+tpch", None, [
        "create table p (a bigint) with (partitioned_by = ARRAY['a'])",
        "create table p (a bigint) with (partitioned_by = 'a')",
        "create table p (a bigint) with (format = 'orc')",
        "select count(*) from p"]),
    "dml_ctas_if_not_exists_no_duplicate": ("memory+tpch", None, [
        "create table c1 as select n_nationkey from nation",
        "create table if not exists c1 as select n_nationkey from nation",
        "select count(*) c from c1"]),
    "dml_unknown_catalog_qualifier": ("memory+tpch", None, ["select * from memry.t"]),
    "dml_drop_missing_table_message": ("memory+tpch", None, ["drop table never_created"]),
    "dml_delete_and_update": ("memory", "memory", [
        "create table emp (id bigint, name varchar, salary decimal(10,2))",
        "insert into emp values (1, 'ann', 100.00), (2, 'bob', 200.00), "
        "(3, 'cat', 300.00), (4, 'dan', 400.00)",
        "update emp set salary = salary * 2 where id >= 3",
        "select id, salary from emp order by id",
        "update emp set name = 'zed', salary = 1.50 where id = 1",
        "select name, salary from emp where id = 1",
        "delete from emp where salary > 500",
        "select id from emp order by id",
        "delete from emp",
        "select count(*) from emp"]),
    "dml_returns_affected_row_counts": ("mem", "mem", [
        "create table t (a bigint)",
        "insert into t values (1), (2), (3)",
        "update t set a = a + 1 where a >= 2",
        "delete from t where a = 4",
        "delete from t where a = 999",
        "update t set a = null where a = 1",
        "select a from t"]),
    # tests/test_merge.py
    "merge_update_delete_insert": ("mem", "mem", MERGE_SETUP + [
        """merge into tgt t using src s on t.id = s.id
        when matched and s.qty < 0 then delete
        when matched then update set name = s.name, qty = t.qty + s.qty
        when not matched then insert (id, name, qty) values (s.id, s.name, s.qty)""",
        "select id, name, qty from tgt order by id"]),
    "merge_clause_priority_first_match_wins": ("mem", "mem", MERGE_SETUP + [
        """merge into tgt t using src s on t.id = s.id
        when matched and s.qty > 100 then update set qty = 111
        when matched and s.qty > 0 then update set qty = 222""",
        "select id, qty from tgt order by id"]),
    "merge_duplicate_source_match_errors": ("mem", "mem", MERGE_SETUP + [
        "insert into src values (2, 'x', 1)",
        "merge into tgt using src on tgt.id = src.id when matched then delete",
        "select id from tgt order by id"]),
    "merge_subquery_source_and_missing_insert_columns": ("mem", "mem", MERGE_SETUP + [
        """merge into tgt using (select id + 100 as sid, qty from src) s
          on tgt.id = s.sid
        when not matched and s.qty > 30 then insert (id, qty) values (s.sid, s.qty)""",
        "select id, name, qty from tgt order by id"]),
    "merge_null_keys_never_match": ("mem", "mem", MERGE_SETUP + [
        "insert into tgt values (null, 'n', 0)",
        "insert into src values (null, 'N', 99)",
        """merge into tgt t using src s on t.id = s.id
        when matched then update set qty = 1
        when not matched then insert (id, name) values (s.id, s.name)""",
        "select id, name, qty from tgt order by qty, name"]),
    "merge_multiple_when_not_matched": ("mem", "mem", MERGE_SETUP + [
        """merge into tgt using src on tgt.id = src.id
        when not matched and src.qty > 100 then insert (id, qty) values (src.id, 0)
        when not matched then insert (id, qty) values (src.id, src.qty)""",
        "select id, qty from tgt order by id"]),
    "merge_cross_scale_decimal_keys_match": ("mem", "mem", MERGE_SETUP + [
        "create table dt (k decimal(10,2), v bigint)",
        "insert into dt values (1.00, 1)",
        "create table ds (k decimal(4,1), v bigint)",
        "insert into ds values (1.0, 99)",
        "merge into dt using ds on dt.k = ds.k when matched then update set v = ds.v",
        "select k, v from dt"]),
    "merge_set_rejects_source_qualifier": ("mem", "mem", MERGE_SETUP + [
        "merge into tgt t using src s on t.id = s.id when matched then update set s.qty = 1"]),
    "merge_insert_arity_error_precedes_mutation": ("mem", "mem", MERGE_SETUP + [
        """merge into tgt t using src s on t.id = s.id
        when matched then update set qty = 0
        when not matched then insert (id) values (s.id, s.qty)""",
        "select qty from tgt order by id"]),
    "merge_int64_keys_past_2_53": ("mem", "mem", MERGE_SETUP + [
        f"insert into tgt values ({1 << 53}, 'p', 1)",
        f"insert into src values ({BIG}, 'q', 2)",
        "merge into tgt t using src s on t.id = s.id when matched then update set qty = 999",
        f"select qty from tgt where id = {1 << 53}",
        "select id, qty from tgt order by id"]),
    # a BIGINT key against a DECIMAL one: keys of two kinds pair as python
    # values do (2^53 + 1 is not the decimal's float 2^53)
    "merge_bigint_key_against_decimal_key": ("mem", "mem", [
        "create table kt (k bigint, v bigint)",
        f"insert into kt values (1, 1), (2, 2), ({BIG}, 3)",
        "create table ks (k decimal(18,0), v bigint)",
        f"insert into ks values (1, 10), ({BIG}, 30), (null, 40)",
        "merge into kt using ks on kt.k = ks.k when matched then update set v = ks.v "
        "when not matched then insert (k, v) values (ks.k, ks.v)",
        "select k, v from kt order by v"]),
    # keys that are python objects: dates (NULL among them), and a string
    # key against a number, which never compare equal
    "merge_date_keys_and_a_string_key_against_a_number": ("mem", "mem", [
        "create table dk (k date, v bigint)",
        "insert into dk values (date '2020-01-01', 1), (null, 2), (date '2020-03-01', 3)",
        "create table dsrc (k date, v bigint)",
        "insert into dsrc values (date '2020-03-01', 30), (null, 40), (date '2021-01-01', 50)",
        "merge into dk using dsrc on dk.k = dsrc.k when matched then update set v = dsrc.v "
        "when not matched then insert (k, v) values (dsrc.k, dsrc.v)",
        "select k, v from dk order by v",
        "create table sk (k varchar, v bigint)",
        "insert into sk values ('1', 1), ('2', 2)",
        "merge into sk using dk on sk.v = dk.v when matched then update set k = 'hit'",
        "merge into sk using (select v as n, v from dk) s on sk.k = s.n "
        "when matched then update set v = 0",
        "select k, v from sk order by v"]),
    # tests/test_window_frames2.py over its memory table
    "window_frames2_memory_table": ("mem", "mem", [
        "create table m (g bigint, d date, x bigint, v bigint)",
        _window_frames2_rows(),
        "select g, d, x, v from m",
        "select g, x, sum(v) over (partition by g order by x "
        "range between 5 preceding and 5 following) s from m order by g, x",
        "select g, d, count(v) over (partition by g order by d "
        "range between 3 preceding and current row) c from m order by g, d",
        "select g, x, min(x) over (partition by g order by x desc "
        "range 10 preceding) lo from m order by g, x desc",
        "select g, x, v, "
        "lag(v) ignore nulls over (partition by g order by x, d) l1, "
        "lag(v, 2) ignore nulls over (partition by g order by x, d) l2, "
        "lead(v) ignore nulls over (partition by g order by x, d) f1 "
        "from m order by g, x, d",
        "select g, x, v, "
        "first_value(v) ignore nulls over (partition by g order by x, d) fv, "
        "last_value(v) ignore nulls over (partition by g order by x, d "
        " rows between unbounded preceding and unbounded following) lv, "
        "nth_value(v, 2) ignore nulls over (partition by g order by x, d "
        " rows between unbounded preceding and current row) nv "
        "from m order by g, x, d",
        "select row_number() ignore nulls over (order by x) from m"]),
    # tests/test_window_setops.py, the memory-catalog cases
    "setops_right_and_full_outer_joins": ("mem", "mem", [
        "create table ja (k bigint, x bigint)",
        "create table jb (k bigint, y varchar)",
        "insert into ja values (1, 10), (2, 20), (2, 21)",
        "insert into jb values (2, 'two'), (3, 'three'), (null, 'none')",
        "select ja.k, x, jb.k, y from ja right join jb on ja.k = jb.k order by y",
        "select ja.k, x, jb.k, y from ja full outer join jb on ja.k = jb.k "
        "order by coalesce(ja.k, jb.k), x",
        "select count(*) c, count(x) cx, count(y) cy from ja "
        "full outer join jb on ja.k = jb.k"]),
    "setops_join_using_and_qualified_star": ("mem", "mem", [
        "create table ua (k bigint, x bigint)",
        "create table ub (k bigint, y bigint)",
        "insert into ua values (1, 10), (2, 20)",
        "insert into ub values (2, 200), (3, 300)",
        "select * from ua join ub using (k)",
        "select k, y from ua left join ub using (k) order by k",
        "select ub.*, ua.x from ua join ub on ua.k = ub.k"]),
    "setops_intersect_except_all_multiplicity": ("mem", "mem", [
        "create table sa (v bigint, w bigint)",
        "create table sb (v bigint, w bigint)",
        "insert into sa values (1, 7), (1, 7), (1, 7), (2, 8), (3, 9)",
        "insert into sb values (1, 7), (1, 7), (2, 8), (2, 8), (4, 10)",
        "select v, w from sa intersect all select v, w from sb",
        "select v, w from sa except all select v, w from sb"]),
    "setops_string_set_ops_merge_dictionaries": ("mem", "mem", [
        "create table dx (t varchar)",
        "create table dy (t varchar)",
        "insert into dx values ('a'), ('b'), ('b'), ('c')",
        "insert into dy values ('b'), ('d')",
        "select t from dx union select t from dy",
        "select t from dx union all select t from dy",
        "select t from dx intersect select t from dy",
        "select t from dx except all select t from dy"]),
    # tests/test_routines.py (SHOW FUNCTIONS left out)
    "routines_create_function_inline": ("tpch", "tpch", [
        "create function taxed(p double, r double) returns double return p * (1 + r)",
        "select taxed(100.0, 0.1) t",
        "select sum(taxed(o_totalprice, 0.05)) st from orders where o_orderkey < 100",
        "select sum(o_totalprice * 1.05) st from orders where o_orderkey < 100"]),
    "routines_function_composition": ("tpch", "tpch", [
        "create function twice(x bigint) returns bigint return x * 2",
        "create function quad(x bigint) returns bigint return twice(twice(x))",
        "select quad(3) q",
        "create or replace function twice(x bigint) returns bigint return x * 3",
        "select twice(2) t",
        "drop function quad",
        "select quad(1)",
        "drop function quad",
        "drop function if exists quad"]),
    "routines_function_errors": ("tpch", "tpch", [
        "create function f1(x bigint) returns bigint return x",
        "create function f1(x bigint) returns bigint return x",
        "select f1(1, 2)",
        "create or replace function f1(x bigint) returns bigint return f1(x)",
        "select f1(1)"]),
    "routines_param_coercion_and_builtin_conflict": ("tpch", "tpch", [
        "create function half(x double) returns double return x / 2",
        "select half(5) h",
        "create function abs(x bigint) returns bigint return x + 1"]),
    # tests/test_security.py::test_materialized_views (SHOW TABLES left out)
    "materialized_views": ("mem+tpch", "mem", [
        "create table src (k bigint)",
        "insert into src values (1), (2)",
        "create materialized view mv as select count(*) c, sum(k) s from src",
        "select c, s from mv",
        "create materialized view mv as select 1 one",
        "insert into src values (10)",
        "select c, s from mv",
        "refresh materialized view mv",
        "select c, s from mv",
        "create or replace materialized view mv as select k from src where k > 1",
        "select k from mv order by k",
        "drop materialized view mv",
        "select * from mv",
        "drop materialized view mv",
        "drop materialized view if exists mv"]),
    # tests/test_sql_tpch3.py::test_q15
    "tpch_q15_view": ("tpch", "tpch", [
        chip_smoke.Q15_VIEW,
        chip_smoke.TPCH_QUERIES["q15"],
        chip_smoke.Q15_VIEW,
        "drop view revenue0",
        "drop view revenue0",
        "drop view if exists revenue0"]),
}


def _engines(catalogs, tpch_sf001, torch_tpch):
    j, t = JaxEngine(), TorchEngine(device="cpu")
    if "tpch" in catalogs:
        j.register_catalog("tpch", tpch_sf001)
        t.register_catalog("tpch", torch_tpch)
    mem = catalogs.split("+")[0]
    if mem != "tpch":
        j.register_catalog(mem, JaxMemory())
        t.register_catalog(mem, TorchMemory())
    return j, t


@pytest.fixture(scope="module")
def torch_tpch():
    return TorchTpch(sf=0.01)


@pytest.mark.parametrize("name", list(CASES))
def test_statements_equal_the_reference(tpch_sf001, torch_tpch, name):
    catalogs, cat, statements = CASES[name]
    j, t = _engines(catalogs, tpch_sf001, torch_tpch)
    sj, st = j.create_session(cat) if cat else None, t.create_session(cat) if cat else None
    for sql in statements:
        run_both(j, t, sql, sj, st)
    assert not [c for c in t.catalogs if c.startswith("__merge_scratch")]


def test_dml_results_carry_the_affected_row_counts(torch_tpch):
    t = TorchEngine(device="cpu")
    t.register_catalog("mem", TorchMemory())
    s = t.create_session("mem")
    assert t.execute_sql("create table t (a bigint)", s) is None
    counts = [t.execute_sql(sql, s).rows() for sql in (
        "insert into t values (1), (2), (3)", "update t set a = a + 1 where a >= 2",
        "delete from t where a = 4", "delete from t where a = 999")]
    assert counts == [[(3,)], [(2,)], [(1,)], [(0,)]]
    assert t.execute_sql("select a from t order by a", s).rows() == [(1,), (3,)]


@pytest.mark.parametrize("sql,what", [
    ("explain select 1", "EXPLAIN"),
    ("explain analyze select count(*) from nation", "EXPLAIN"),
    ("show tables", "SHOW"),
    ("show functions", "SHOW"),
    ("prepare p from select 1", "PREPARE"),
    ("execute p", "EXECUTE"),
    ("deallocate prepare p", "DEALLOCATE"),
    ("set session query_max_memory = '1GB'", "SET SESSION"),
    ("reset session query_max_memory", "RESET SESSION"),
    ("grant select on nation to bob", "GRANT"),
    ("revoke select on nation from bob", "REVOKE"),
])
def test_statements_left_out_raise_naming_them(tpch_sf001, torch_tpch, sql, what):
    """The statements the port refused before its control plane landed now
    run: each outcome equals the reference's (the same error where the
    reference raises: EXECUTE and DEALLOCATE of a statement never prepared,
    a property value of the wrong type, GRANT and REVOKE under the default
    access control).  EXPLAIN ANALYZE's timing differs by nature: both report
    the run and its one output row."""
    j, t = _engines("tpch", tpch_sf001, torch_tpch)
    sj, st = j.create_session("tpch"), t.create_session("tpch")
    assert sql.split()[0].upper() == what.split()[0]
    if sql.startswith("explain analyze"):
        for e, sess in ((j, sj), (t, st)):
            text = "\n".join(e.execute_sql(sql, sess).columns[0].tolist())
            assert "executed in" in text and "1 output rows" in text
        return
    run_both(j, t, sql, sj, st)


# -- TPC-H's refresh path at SF0.01 ------------------------------------------------------

REFRESH_SPLIT = 1 << 14  # memory pages: lineitem in four, the last one short


@pytest.fixture
def small_memory_pages(monkeypatch):
    monkeypatch.setattr(jax_memory, "SPLIT_ROWS", REFRESH_SPLIT)
    monkeypatch.setattr(torch_memory, "SPLIT_ROWS", REFRESH_SPLIT)


def _query_block(j, t, sj, st):
    """chip_smoke.MEMORY_QUERIES over the memory tables, Q15 through its
    view; returns the port's results."""
    out = {}
    for q in chip_smoke.MEMORY_QUERIES:
        if q == "q15":
            run_both(j, t, chip_smoke.Q15_VIEW, sj, st)
        out[q] = run_both(j, t, chip_smoke.ALL_QUERIES[q], sj, st)
        if q == "q15":
            run_both(j, t, "drop view revenue0", sj, st)
    return out


def test_refresh_path_equals_the_reference(tpch_sf001, torch_tpch, small_memory_pages):
    path = chip_smoke.refresh_path(tpch_sf001.row_count("orders"))
    assert path["band"] == 15
    j, t = _engines("memory+tpch", tpch_sf001, torch_tpch)
    sj, st = j.create_session("memory"), t.create_session("memory")
    for _, sql in path["load"]:
        assert run_both(j, t, sql, sj, st) is None
    assert len(torch_memory.MemoryConnector.splits(t.catalogs["memory"], "lineitem")) == 4
    counts = {}
    for step in ("rf1", "rf2"):
        for label, sql in path[step]:
            counts[label] = run_both(j, t, sql, sj, st)
            want = t.execute_sql(path["counts"][label], st).rows()[0][0]
            if counts[label] is None:  # MERGE returns no count: the table grew
                assert label == "merge_orders"
                got = t.execute_sql("select count(*) from orders", st).rows()[0][0]
                assert got == tpch_sf001.row_count("orders")
            else:
                assert counts[label].rows() == [(want,)], label
            assert want > 0, label
        if step == "rf1":
            # the memory copies now equal tpch: so do the queries' results
            sums = {tb: run_both(j, t, sql, sj, st) for tb, sql in chip_smoke.CHECKSUMS.items()}
            after_rf1 = _query_block(j, t, sj, st)
            for tb, sql in chip_smoke.CHECKSUMS.items():
                _assert_same(sums[tb], run_both(j, t, sql, sj, st), True, f"{tb} checksum")
            tp = t.create_session("tpch")
            for q in chip_smoke.MEMORY_QUERIES:
                if q == "q15":
                    t.execute_sql(chip_smoke.Q15_VIEW, tp)
                ref = t.execute_sql(chip_smoke.ALL_QUERIES[q], tp)
                if q == "q15":
                    t.execute_sql("drop view revenue0", tp)
                assert len(ref) > 0 or q == "q18", q
                _assert_same(ref, after_rf1[q], True, f"{q} over memory vs tpch", ids=False)
    _query_block(j, t, sj, st)


def test_decimal_writes_agree_inside_2_53_and_the_port_stays_exact_past_it():
    """ROADMAP C: the reference writes a query result's decimal as
    round(decoded float * 10^s), the raw value only while |raw| < 2^53; the
    port writes the raw scaled int."""
    inside, past = (1 << 52) + 1, (1 << 53) + 1
    j, t = _engines("mem", None, None)
    sj, st = j.create_session("mem"), t.create_session("mem")
    for sql in ("create table a (k decimal(18,0), p decimal(18,2))",
                f"insert into a values ({inside}, 1234.56), ({-inside}, -0.01)",
                "create table b as select k, p from a",
                "insert into b select k + 1, p from a",
                "select k, p from b order by k"):
        run_both(j, t, sql, sj, st)
    run_both(j, t, f"insert into a values ({past}, 0.00)", sj, st)
    run_both(j, t, "create table c as select k from a where k > 0", sj, st)
    got = t.execute_sql("select k from c order by k", st).raw_columns[0].tolist()
    ref = j.execute_sql("select k from c order by k", sj).raw_columns[0].tolist()
    assert got == [inside, past]
    assert ref == [inside, past - 1]
