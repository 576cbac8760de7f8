"""The port's connectors past the generators that need no ``pyarrow``
(``trino_tpu_torch/connectors/blackhole.py`` and ``dbapi.py``) and its
index join (``LocalExecutor._index_lookup_stream``) against the JAX package
on the CPU.

Both packages read the same sqlite database, built once per module, through
their own ``DbapiConnector`` (each split one rowid range of 256 rows), beside
TPC-H at SF0.01.  Restates:

- tests/test_connectors_extra.py::test_blackhole_scan_and_insert;
- the 12 tests of tests/test_dbapi_connector.py: remote scans, strings and
  NULLs, the federated join, metadata, splits and churn, the TopN and join
  pushdowns and the access check over a pushed handle, the spec that
  travels with a split, and the index join with its ``TRINO_TPU_INDEX_JOIN``
  switch;
- EXPLAIN ANALYZE's ``[index lookup: N keys]``.

Adds: an index join on a string key (the build's ids decode to the remote
values), the index join's one counted read of its keys and its key budget,
the connector's host pages staged by the executor (``h2d_bytes``), the
port's join pushdown with its sides' integer filters in the remote query,
a self-join kept local (ROADMAP C12), an INSERT into blackhole through SQL,
and the tie rule of ``chip_smoke.same_result`` (rows tied on the ORDER BY
key compare as multisets, untied rows in order), which the card's pushdown
phase needs.

Every result is held against the reference's: integer, string, date and
decimal columns and NULLs exactly, DOUBLE within rtol 1e-9, row order where
the statement orders its rows.
"""

import os
import re
import sqlite3
import sys
import types

import numpy as np
import pytest


from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.blackhole import BlackHoleConnector as JaxBlackHole
from trino_tpu.connectors.dbapi import DbapiConnector as JaxDbapi
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.page import Field as JField, Schema as JSchema
from trino_tpu.spi.security import AccessDeniedError as JaxDenied
from trino_tpu.types import BIGINT as JBIGINT, DOUBLE as JDOUBLE
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.blackhole import BlackHoleConnector
from trino_tpu_torch.connectors.dbapi import DbapiConnector
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.page import Field, Schema
from trino_tpu_torch.spi.security import AccessDeniedError
from trino_tpu_torch.types import BIGINT, DOUBLE

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


# -- comparison ----------------------------------------------------------------------


def _ordered(sql: str) -> bool:
    return re.search(r"order\s+by[^()]*$", sql.strip(), re.I) is not None


def _rows(r):
    """Rows of decoded strings and raw other values, NULL as None."""
    cols = []
    for t, raw, dec in zip(r.types, r.raw_columns, r.columns):
        none = [v is None for v in dec]
        vals = [str(v) for v in dec] if t.is_string else \
            [v.item() if isinstance(v, np.generic) else v for v in np.asarray(raw).tolist()]
        cols.append([None if n else v for v, n in zip(vals, none)])
    return [tuple(row) for row in zip(*cols)]


def same(ref, got, sql):
    assert tuple(ref.names) == tuple(got.names), sql
    assert len(ref) == len(got), sql
    ra, rb = _rows(ref), _rows(got)
    if not _ordered(sql):
        ra, rb = sorted(ra, key=repr), sorted(rb, key=repr)
    for i, t in enumerate(ref.types):
        ca, cb = [r[i] for r in ra], [r[i] for r in rb]
        assert [v is None for v in ca] == [v is None for v in cb], (sql, ref.names[i])
        if t.is_floating:
            np.testing.assert_allclose(np.array([v for v in cb if v is not None], float),
                                       np.array([v for v in ca if v is not None], float),
                                       rtol=1e-9, atol=0, err_msg=sql)
        else:
            assert ca == cb, (sql, ref.names[i])


def both(fed, sql):
    """The statement in both packages over their own catalogs; returns the
    port's result after holding it against the reference's."""
    ref = fed.j.execute_sql(sql, fed.sj)
    got = fed.t.execute_sql(sql, fed.st)
    same(ref, got, sql)
    return got


# -- fixtures -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def remote_db(tmp_path_factory):
    """tests/test_dbapi_connector.py's remote database."""
    path = str(tmp_path_factory.mktemp("db") / "remote.db")
    con = sqlite3.connect(path)
    con.execute("create table users (uid integer, region integer, "
                "name text, balance real)")
    rows = [(i, i % 5, None if i % 11 == 0 else f"user-{i % 7}",
             round(i * 1.5, 2)) for i in range(1000)]
    con.executemany("insert into users values (?,?,?,?)", rows)
    con.execute("create table tiny (k integer, v text)")
    con.executemany("insert into tiny values (?,?)",
                    [(1, "a"), (2, "b"), (3, None)])
    con.commit()
    con.close()
    return path


@pytest.fixture(scope="module")
def fed(remote_db):
    j, t = JaxEngine(), Engine(device="cpu")
    j.register_catalog("db", JaxDbapi(lambda: sqlite3.connect(remote_db), split_rows=256))
    t.register_catalog("db", DbapiConnector(lambda: sqlite3.connect(remote_db),
                                            split_rows=256))
    j.register_catalog("tpch", JaxTpch(sf=0.01, split_rows=1 << 12))
    t.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 12))
    return types.SimpleNamespace(j=j, t=t, sj=j.create_session("db"),
                                 st=t.create_session("db"), path=remote_db)


@pytest.fixture()
def probe_catalog(fed):
    """tests/test_dbapi_connector.py's local probe table, in both packages."""
    for e, mem in ((fed.j, JaxMemory), (fed.t, MemoryConnector)):
        if "m2" in e.catalogs:
            continue
        e.register_catalog("m2", mem())
        sm = e.create_session("m2")
        e.execute_sql("create table probe (uid bigint, tag bigint)", sm)
        e.execute_sql("insert into probe values (5, 1), (9, 2), (5, 3), (700, 4)", sm)
    return fed


def _undo_churn(fed):
    """test_remote_metadata_and_splits changes tiny.v past its dictionary
    snapshot on purpose: restore the value and drop both snapshots."""
    con = sqlite3.connect(fed.path)
    con.execute("update tiny set v='a' where k=1")
    con.commit()
    con.close()
    for e in (fed.j, fed.t):
        e.catalogs["db"]._tables.pop("tiny", None)


def _pushed(fed):
    return fed.j.catalogs["db"].pushed_queries, fed.t.catalogs["db"].pushed_queries


def _index_specs(fed, key_col):
    """Each package's index-lookup spec on ``users.key_col`` (handles are
    registered once per content, so the newest handle may be another's)."""
    return [next(sp for sp in e.catalogs["db"]._pushed.values()
                 if sp["kind"] == "index" and sp["key_col"] == key_col)
            for e in (fed.j, fed.t)]


# -- blackhole ------------------------------------------------------------------------


def test_blackhole_scan_and_insert():
    """tests/test_connectors_extra.py:16 in both packages, and an INSERT
    through SQL that the table swallows and counts."""
    j, t = JaxEngine(), Engine(device="cpu")
    jb, tb = JaxBlackHole(), BlackHoleConnector()
    jb.create_table("events", JSchema((JField("id", JBIGINT), JField("v", JDOUBLE))),
                    rows_per_page=100, pages_per_split=2, splits=3)
    tb.create_table("events", Schema((Field("id", BIGINT), Field("v", DOUBLE))),
                    rows_per_page=100, pages_per_split=2, splits=3)
    j.register_catalog("blackhole", jb)
    t.register_catalog("blackhole", tb)
    assert str(tb.device) == "cpu"  # bound to the engine's device
    fed = types.SimpleNamespace(j=j, t=t, sj=j.create_session("blackhole"),
                                st=t.create_session("blackhole"))
    r = both(fed, "select count(*), min(id), max(id), sum(id), sum(v) from events")
    assert r.rows()[0][:3] == (600, 0, 599)
    for bh in (jb, tb):
        bh.append("events", [np.arange(5), np.zeros(5)])
    assert both(fed, "select count(*) from events").rows()[0][0] == 600
    assert jb._tables["events"].inserted_rows == tb._tables["events"].inserted_rows == 5
    both(fed, "select id % 7 k, count(*) c, sum(v) s from events group by id % 7")
    got = [e.execute_sql("insert into events select id, v from events where id < 250", s)
           for e, s in ((j, fed.sj), (t, fed.st))]
    assert got[0].rows() == got[1].rows() == [(250,)]
    assert jb._tables["events"].inserted_rows == tb._tables["events"].inserted_rows == 255
    assert both(fed, "select count(*) from events").rows()[0][0] == 600


# -- tests/test_dbapi_connector.py ----------------------------------------------------


def test_remote_scan_and_aggregate(fed):
    rows = both(fed, "select region, count(*) c, sum(balance) sb from users "
                     "group by region order by region").rows()
    assert len(rows) == 5
    assert sum(r[1] for r in rows) == 1000
    assert rows[0][2] == pytest.approx(sum(i * 1.5 for i in range(0, 1000, 5)))


def test_remote_pages_are_staged_by_the_executor(fed):
    """The connector decodes on the host (numpy pages, ``HOST_DECODE``) and
    the executor stages them: a remote scan counts the bytes of every
    column it fetched in ``h2d_bytes``."""
    tc = fed.t.catalogs["db"]
    page = tc.generate(tc.splits("users")[0], ["uid", "name"])
    assert tc.HOST_DECODE and all(isinstance(c, np.ndarray) for c in page.columns)
    assert isinstance(page.null_masks[1], np.ndarray) and page.null_masks[0] is None
    both(fed, "select sum(uid) s, sum(balance) b from users")
    assert fed.t.last_query_counters["h2d_bytes"] >= 1000 * (8 + 8)


def test_remote_strings_and_nulls(fed):
    rows = both(fed, "select name, count(*) c from users group by name "
                     "order by name nulls last").rows()
    names = [r[0] for r in rows]
    assert names[-1] is None
    assert set(n for n in names if n is not None) == {f"user-{i}" for i in range(7)}
    assert both(fed, "select v from tiny where k = 3").rows() == [(None,)]


def test_remote_federated_join(fed):
    rows = both(fed, "select count(*) c from db.users, tpch.nation "
                     "where users.region = nation.n_regionkey and users.uid < 100").rows()
    assert rows == [(100 * 5,)]


def test_remote_metadata_and_splits(fed):
    jc, tc = fed.j.catalogs["db"], fed.t.catalogs["db"]
    assert tc.tables() == jc.tables() == ["tiny", "users"]
    assert tc.row_count("users") == jc.row_count("users") == 1000
    assert tc.column_range("users", "uid") == jc.column_range("users", "uid") == (0, 999)
    assert [(s.table, s.lo, s.hi) for s in tc.splits("users")] \
        == [(s.table, s.lo, s.hi) for s in jc.splits("users")]
    assert len(tc.splits("users")) >= 4
    assert {k: v.values.tolist() for k, v in tc.dictionaries("users").items()} \
        == {k: v.values.tolist() for k, v in jc.dictionaries("users").items()}
    for conn in (jc, tc):  # tiny's snapshot, taken before the remote change
        conn.dictionaries("tiny")
    con = sqlite3.connect(fed.path)
    con.execute("update tiny set v='brand-new' where k=1")
    con.commit()
    con.close()
    for conn in (jc, tc):
        with pytest.raises(RuntimeError, match="changed since"):
            for sp in conn.splits("tiny"):
                conn.generate(sp, ["v"])
        with pytest.raises(ValueError, match="unsupported remote identifier"):
            conn.column_range('users"; drop table users; --', "uid")


def test_topn_pushdown_ships_n_rows(fed):
    before = _pushed(fed)
    rows = both(fed, "select uid, balance from users order by balance desc, uid limit 7").rows()
    after = _pushed(fed)
    assert after[1] - before[1] == after[0] - before[0] > 0
    assert [r[0] for r in rows] == list(range(999, 992, -1))
    assert rows[0][1] == pytest.approx(999 * 1.5)
    # the handle's remote query ships at most n rows
    tc = fed.t.catalogs["db"]
    handle = next(h for h, sp in tc._pushed.items() if sp["kind"] == "topn")
    page = tc.generate(tc.splits(handle)[0], ["uid", "balance"])
    assert page.capacity == 7


def test_topn_pushdown_respects_nulls_ordering(fed):
    rows = both(fed, "select name from users order by name desc nulls last limit 3").rows()
    assert all(r[0] is not None for r in rows)
    assert rows[0][0] == "user-6"


def test_join_pushdown_runs_remotely(fed):
    _undo_churn(fed)
    before = _pushed(fed)
    got = both(fed, "select u.uid, u.balance, t.v from users u join tiny t on u.region = t.k "
                    "order by u.uid limit 10").rows()
    after = _pushed(fed)
    assert after[1] - before[1] == after[0] - before[0] > 0
    vmap = {1: "a", 2: "b", 3: None}
    want = [(i, i * 1.5, vmap[i % 5]) for i in range(1000) if i % 5 in vmap][:10]
    assert [(r[0], round(r[1], 2), r[2]) for r in got] \
        == [(u, round(b, 2), v) for u, b, v in want]


def test_join_pushdown_access_checks_source_tables(fed):
    sql = "select u.uid from users u join tiny t on u.region = t.k limit 1"
    for e, s, denied in ((fed.j, fed.sj, JaxDenied), (fed.t, fed.st, AccessDeniedError)):
        class DenyTiny:
            def check_can_select(self, user, catalog, table, denied=denied):
                if table == "tiny":
                    raise denied("tiny is restricted")

            def __getattr__(self, name):  # every other check allows
                return lambda *a, **k: None

        saved = e.access_control
        e.access_control = DenyTiny()
        try:
            with pytest.raises(denied, match="tiny is restricted"):
                e.execute_sql(sql, s)
        finally:
            e.access_control = saved


def test_filter_blocks_join_pushdown(fed):
    _undo_churn(fed)
    before = _pushed(fed)
    got = both(fed, "select count(*) c from users u join tiny t on u.region = t.k "
                    "where u.balance > 100 and t.v = 'a'").rows()
    # no join handle: the one remote read pushed is the index join's lookup
    after = _pushed(fed)
    assert after[1] - before[1] == after[0] - before[0]
    assert list(fed.t.catalogs["db"]._pushed.values())[-1]["kind"] == "index"
    assert int(got[0][0]) == sum(1 for i in range(1000) if i % 5 == 1 and i * 1.5 > 100)


def test_join_pushdown_carries_an_integer_key_range(fed):
    """A port extension: a side filter of integer columns against integer
    constants rides into the pushed join's remote query, which ships only
    the rows in range; the reference, whose filters block the pushdown,
    answers the same rows another way."""
    _undo_churn(fed)
    tc = fed.t.catalogs["db"]
    before = tc.pushed_queries
    rows = both(fed, "select u.uid, u.balance, t.v from users u join tiny t on u.region = t.k "
                     "where u.uid between 10 and 60 and t.k < 3 order by u.uid").rows()
    assert tc.pushed_queries > before
    want = [(i, i * 1.5, "ab"[i % 5 - 1]) for i in range(10, 61) if i % 5 in (1, 2)]
    assert [(r[0], round(r[1], 2), r[2]) for r in rows] == want
    handle, spec = [(h, sp) for h, sp in tc._pushed.items() if sp["kind"] == "join"][-1]
    assert {("uid", "gte", 10), ("uid", "lte", 60)} <= set(spec["left_filter"])
    assert ("k", "lt", 3) in spec["right_filter"]
    names = [f.name for f in tc.schema(handle).fields]
    assert sum(tc.generate(sp, names[:1]).capacity for sp in tc.splits(handle)) == len(want)


def test_self_join_is_not_pushed(fed, monkeypatch):
    """A self-join's two sides give its outputs repeated names, by which a
    pushed handle's columns are read: the port keeps such a join local and
    answers right (the reference pushes it and reads one side's ``uid`` for
    both: ROADMAP C), held against the rows built in Python.  The index
    join is off, so no lookup handle is left for the tests that read them."""
    monkeypatch.setenv("TRINO_TPU_INDEX_JOIN", "0")
    tc = fed.t.catalogs["db"]
    handles = {h for h, sp in tc._pushed.items() if sp["kind"] == "join"}
    rows = fed.t.execute_sql("select a.uid, b.uid u2 from users a join users b "
                             "on a.uid = b.region order by a.uid, u2", fed.st).rows()
    assert [tuple(int(v) for v in r) for r in rows] == sorted((i % 5, i) for i in range(1000))
    assert {h for h, sp in tc._pushed.items() if sp["kind"] == "join"} == handles


def test_pushed_spec_travels_with_split(fed):
    import pickle

    _undo_churn(fed)
    pages = []
    for e, cls in ((fed.j, JaxDbapi), (fed.t, DbapiConnector)):
        conn = e.catalogs["db"]
        handle = conn.apply_join("users", "tiny", [("region", "k")],
                                 ["l0", "l1", "r0"], ["uid", "region"], ["v"])
        splits = conn.splits(handle)
        assert splits and splits[0].pushed_spec is not None
        worker = cls(lambda: sqlite3.connect(fed.path), split_rows=256)
        sp = pickle.loads(pickle.dumps(splits[0]))
        page = worker.generate(sp, ["l0", "r0"])
        assert page.columns[0].shape[0] > 0
        pages.append([np.asarray(c).tolist() for c in page.columns])
        assert conn.apply_join("users", "tiny", [("region", "k")], ["l0", "l1", "r0"],
                               ["uid", "region"], ["v"]) == handle
    assert pages[0] == pages[1]


def test_index_join_lookup(probe_catalog):
    fed = probe_catalog
    before = _pushed(fed)
    sql = ("select p.uid, p.tag, u.balance from m2.default.probe p, "
           "db.default.users u where p.uid = u.uid order by p.tag")
    r = both(fed, sql).to_pandas()
    assert list(r["tag"]) == [1, 2, 3, 4]
    assert abs(r["balance"].iloc[0] - 7.5) < 1e-9
    assert abs(r["balance"].iloc[3] - 1050.0) < 1e-9
    after = _pushed(fed)
    assert after[1] - before[1] == after[0] - before[0] > 0
    tc = fed.t.catalogs["db"]
    ref, spec = _index_specs(fed, "uid")
    assert sorted(spec["keys"]) == [5, 9, 700]
    assert spec == ref
    # the connector ships only the matched rows
    handle = next(h for h, sp in tc._pushed.items() if sp is spec)
    page = tc.generate(tc.splits(handle)[0], ["uid"])
    assert sorted(np.asarray(page.columns[0]).tolist()) == [5, 9, 700]


def test_index_join_reads_its_keys_once(probe_catalog, monkeypatch):
    """The build's distinct keys, their count and the live count come back
    in one counted read at ``join.index.keys`` (fixed-size buffers, no
    read sized by the data); a budget one short of the three keys refuses
    the lookup after that same read."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor

    fed = probe_catalog
    sql = ("select p.uid, u.balance from m2.default.probe p, "
           "db.default.users u where p.uid = u.uid")
    calls = []
    lookup, host = LocalExecutor._index_lookup_stream, LocalExecutor._host

    def counted_host(self, arrays, site):
        if calls and calls[-1]["open"]:
            calls[-1]["sites"].append(site)
        return host(self, arrays, site)

    def counted_lookup(self, *args):
        rec = {"open": True, "sites": [], "reads": self.host_reads}
        calls.append(rec)
        try:
            out = lookup(self, *args)
        finally:
            rec["open"] = False
        rec["reads"] = self.host_reads - rec["reads"]
        rec["taken"] = out is not None
        return out

    monkeypatch.setattr(LocalExecutor, "_host", counted_host)
    monkeypatch.setattr(LocalExecutor, "_index_lookup_stream", counted_lookup)
    for budget, taken in ((3, True), (2, False)):
        monkeypatch.setattr(LocalExecutor, "INDEX_JOIN_MAX_KEYS", budget)
        calls.clear()
        before = fed.t.catalogs["db"].pushed_queries
        both(fed, sql)
        assert [(c["sites"], c["reads"], c["taken"]) for c in calls] \
            == [(["join.index.keys"], 1, taken)]
        assert fed.t.catalogs["db"].pushed_queries - before == int(taken)


def test_index_join_disabled_env(probe_catalog, monkeypatch):
    fed = probe_catalog
    monkeypatch.setenv("TRINO_TPU_INDEX_JOIN", "0")
    before = _pushed(fed)
    handles = (len(fed.j.catalogs["db"]._pushed), len(fed.t.catalogs["db"]._pushed))
    r = both(fed, "select count(*) c from m2.default.probe p, db.default.users u "
                  "where p.uid = u.uid").to_pandas()
    assert r["c"].iloc[0] == 4
    assert _pushed(fed) == before
    assert (len(fed.j.catalogs["db"]._pushed), len(fed.t.catalogs["db"]._pushed)) == handles


def test_index_join_on_a_string_key(fed):
    """A string build key: the build's dictionary ids decode to the remote
    values, which the lookup ships.  A self-join keeps both sides in one
    dictionary (a string join across two catalogs compares ids of two
    dictionaries in both packages: ROADMAP C, known gaps); the filter on
    one side keeps the join out of the join pushdown."""
    sql = ("select a.uid, b.uid u2 from db.default.users a, db.default.users b "
           "where a.name = b.name and b.uid < 3 order by a.uid, u2")
    before = _pushed(fed)
    rows = both(fed, sql).rows()
    want = sorted((i, k) for k in (1, 2) for i in range(1000) if i % 11 and i % 7 == k)
    assert [tuple(r) for r in rows] == want
    after = _pushed(fed)
    assert after[1] - before[1] == after[0] - before[0] > 0
    ref, spec = _index_specs(fed, "name")
    # uid 0's NULL name is a dead lane's id: its value may over-fetch
    assert {"user-1", "user-2"} <= set(spec["keys"])
    assert spec == ref


def test_explain_analyze_shows_the_index_lookup(probe_catalog):
    fed = probe_catalog
    sql = ("explain analyze select p.uid, u.balance from m2.default.probe p, "
           "db.default.users u where p.uid = u.uid")
    texts = []
    for e, s in ((fed.j, fed.sj), (fed.t, fed.st)):
        texts.append("\n".join(str(r[0]) for r in e.execute_sql(sql, s).rows()))
    for text in texts:
        assert "[index lookup: 3 keys]" in text, text
    # the line that carries it is the same join line in both
    lines = [next(ln for ln in tx.splitlines() if "index lookup" in ln) for tx in texts]
    assert lines[0].split("[")[0].strip() == lines[1].split("[")[0].strip()


# -- chip_smoke.same_result: ties ----------------------------------------------------


def _result(names, cols):
    class _T:
        def __init__(self, floating):
            self.is_floating, self.is_string = floating, False

    class _R:
        def __len__(self):
            return len(cols[0])

    r = _R()
    r.names, r.raw_columns, r.columns = names, [np.asarray(c) for c in cols], cols
    r.types = [_T(np.asarray(c).dtype.kind == "f") for c in cols]
    return r


def test_same_result_takes_either_order_of_tied_rows():
    """Rows tied on the ORDER BY key come out in either order; untied rows
    in another order, or another key sequence, are refused."""
    a = _result(["k", "v"], [[1, 2, 2, 3], [1.0, 5.0, 6.0, 7.0]])
    swapped = _result(["k", "v"], [[1, 2, 2, 3], [1.0, 6.0, 5.0, 7.0]])
    chip_smoke.same_result(a, swapped, "ties", order_by=("k",))
    chip_smoke.same_result(a, a, "ties", order_by=("k",))
    with pytest.raises(chip_smoke.SmokeFailure, match="column v differs"):
        chip_smoke.same_result(a, swapped, "row by row")
    untied = _result(["k", "v"], [[1, 2, 3, 2], [1.0, 5.0, 7.0, 6.0]])
    with pytest.raises(chip_smoke.SmokeFailure, match="order key k differs"):
        chip_smoke.same_result(a, untied, "untied", order_by=("k",))
    wrong = _result(["k", "v"], [[1, 2, 2, 3], [1.0, 5.0, 8.0, 7.0]])
    with pytest.raises(chip_smoke.SmokeFailure, match="column v differs"):
        chip_smoke.same_result(a, wrong, "tied but unequal", order_by=("k",))
