"""The port's file connectors (``trino_tpu_torch/connectors/parquet.py``,
``orc.py``, ``filetable.py``, ``hive.py``, ``iceberg.py``, ``delta.py``,
with ``fs.py`` and ``formats/avro.py``) and the executor's host-decode
staging against the JAX package on the CPU.

Both packages read the same small files (a few thousand rows), written once
per module where no test writes into them.  Restates:

- tests/test_parquet.py (9 tests);
- the ORC tests of tests/test_connectors_extra.py (``test_orc_connector``,
  ``test_orc_write_read_roundtrip_and_ranges``);
- tests/test_hive_delta.py (11 tests);
- tests/test_iceberg.py (4 tests);
- tests/test_decimal38.py::test_parquet_decimal38_roundtrip and
  tests/test_predicate.py's two Parquet tests (``test_null_admitting_domains_never_prune``,
  ``test_direct_groupby_late_null_page``);
- tests/test_memory_spill.py::test_parquet_join_spills_without_redecoding,
  which tests/test_torch_memory_spill.py left for this file.

Every file a test writes (``write_table``, CTAS, INSERT, a partitioned
CREATE, Iceberg's avro manifests) is written by each package into a
directory of its own and read back by both.  Adds: the connector modules
import without ``pyarrow`` and name it when used; the buffer pool's
``cacheable`` answers as the reference's for every connector; a host-decoded
scan is staged to the device by the prefetch producer, counted in
``h2d_bytes``, and crosses ``generate`` and ``h2d`` as often as the
reference.

Results are held against the reference's: integer, string, date and
decimal columns and NULLs exactly, DOUBLE within rtol 1e-9, row order where
the statement orders its rows.
"""

import collections
import datetime
import decimal
import json
import os
import re
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest


from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors import delta as jdelta, hive as jhive, iceberg as jiceberg
from trino_tpu.connectors import orc as jorc, parquet as jparquet
from trino_tpu.connectors.blackhole import BlackHoleConnector as JaxBlackHole
from trino_tpu.connectors.dbapi import DbapiConnector as JaxDbapi
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.exec.local_executor import LocalExecutor as JaxExecutor
from trino_tpu.execution import faults as jfaults
from trino_tpu.execution.bufferpool import DeviceBufferPool as JaxBufferPool
from trino_tpu.formats import avro as javro
from trino_tpu.fs import MemoryFileSystem as JaxMemoryFs
from trino_tpu.page import Field as JField, Schema as JSchema
from trino_tpu.sql.frontend import compile_sql as jax_compile
from trino_tpu.types import BIGINT as JBIGINT, DOUBLE as JDOUBLE, VarcharType as JVarchar
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors import delta, filetable, hive, iceberg, orc, parquet
from trino_tpu_torch.connectors.blackhole import BlackHoleConnector
from trino_tpu_torch.connectors.dbapi import DbapiConnector
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import local_executor as tle
from trino_tpu_torch.exec.local_executor import LocalExecutor
from trino_tpu_torch.execution import faults
from trino_tpu_torch.execution.bufferpool import DeviceBufferPool
from trino_tpu_torch.formats import avro
from trino_tpu_torch.fs import MemoryFileSystem
from trino_tpu_torch.memory import MemoryPool
from trino_tpu_torch.page import Field, Schema
from trino_tpu_torch.sql.frontend import compile_sql
from trino_tpu_torch.types import BIGINT, DOUBLE, VarcharType

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    assert [str(t) for t in ref.types] == [str(t) for t in got.types], sql
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


class Pair:
    """One engine of each package, with their sessions on ``catalog``."""

    def __init__(self, catalogs: dict, catalog: str):
        self.j, self.t = JaxEngine(), Engine(device="cpu")
        for name, (jc, tc) in catalogs.items():
            self.register(name, jc, tc)
        self.sj, self.st = self.j.create_session(catalog), self.t.create_session(catalog)

    def register(self, name, jc, tc):
        self.j.register_catalog(name, jc)
        self.t.register_catalog(name, tc)

    def run(self, sql):
        """The statement in both; the port's result, held against the
        reference's (a statement without a result: both None)."""
        ref = self.j.execute_sql(sql, self.sj)
        got = self.t.execute_sql(sql, self.st)
        if ref is None:
            assert got is None, sql
            return None
        same(ref, got, sql)
        return got

    def raises(self, sql, exc, match):
        msgs = []
        for e, s in ((self.j, self.sj), (self.t, self.st)):
            with pytest.raises(exc, match=match) as info:
                e.execute_sql(sql, s)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1], sql


def _write(path, cols: dict, **kw):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    pq.write_table(pa.table(cols), str(path), **kw)


# -- tests/test_parquet.py -------------------------------------------------------------


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    """tests/test_parquet.py's events file, written once."""
    d = tmp_path_factory.mktemp("pq")
    n = 5000
    rng = np.random.default_rng(7)
    _write(d / "events.parquet", {
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "grp": pa.array(rng.integers(0, 5, n).astype(np.int32)),
        "val": pa.array(np.where(np.arange(n) % 11 == 0, None,
                                 rng.normal(size=n).round(3)).tolist(), type=pa.float64()),
        "name": pa.array([None if i % 13 == 0 else f"name-{i % 7}" for i in range(n)]),
        "price": pa.array([round(float(i) / 100, 2) for i in range(n)],
                          type=pa.float64()).cast(pa.decimal128(12, 2)),
        "day": pa.array(np.arange(n, dtype=np.int32) % 1000, type=pa.int32()
                        ).cast(pa.date32()),
    }, row_group_size=1024)
    return str(d)


@pytest.fixture(scope="module")
def pqe(pq_dir, tpch_sf001):
    return Pair({"tpch": (tpch_sf001, TpchConnector(sf=0.01)),
                 "parquet": (jparquet.ParquetConnector(pq_dir),
                             parquet.ParquetConnector(pq_dir))}, None)


def test_parquet_scan_and_agg(pqe):
    r = pqe.run("select count(*) c, sum(id) s from events")
    assert r.columns[0][0] == 5000 and r.columns[1][0] == 5000 * 4999 // 2
    r = pqe.run("select grp, count(*) n, count(val) nv from events group by grp order by grp")
    assert len(r) == 5
    assert sum(r.columns[1].tolist()) == 5000
    assert sum(r.columns[2].tolist()) == 5000 - len(range(0, 5000, 11))


def test_parquet_strings_and_nulls(pqe):
    r = pqe.run("select name, count(*) n from events group by name order by name nulls last")
    names = r.columns[0].tolist()
    assert names[-1] is None
    assert set(n for n in names if n is not None) == {f"name-{i}" for i in range(7)}
    assert pqe.run("select count(*) c from events where name = 'name-3'").columns[0][0] > 0
    r = pqe.run("select upper(name) u from events where name is not null order by id limit 1")
    assert r.columns[0][0].startswith("NAME-")


def test_parquet_decimal_date(pqe):
    r = pqe.run("select sum(price) s from events where day >= date '1970-01-11'")
    total = sum(round(i / 100, 2) for i in range(5000) if (i % 1000) >= 10)
    assert abs(r.columns[0][0] - total) < 1e-6
    pqe.run("select day, price, count(*) c from events where id < 40 group by day, price "
            "order by day, price")


def test_parquet_join_with_tpch(pqe):
    assert pqe.run("select count(*) c from events, nation where grp = n_nationkey"
                   ).columns[0][0] == 5000


def test_parquet_write_roundtrip(pqe, tmp_path):
    """Each package writes ``asia`` into a directory of its own; both read
    both files."""
    res = {}
    for pkg, e, mod in (("jax", pqe.j, jparquet), ("torch", pqe.t, parquet)):
        r = e.execute_sql("select n_name, n_regionkey from nation where n_regionkey = 2",
                          e.create_session("tpch"))
        conn = mod.ParquetConnector(str(tmp_path / pkg))
        conn.write_table("asia", r.names, r.types, [c.tolist() for c in r.columns])
        res[pkg] = str(tmp_path / pkg)
    for pkg, d in res.items():
        pqe.register(f"w_{pkg}", jparquet.ParquetConnector(d), parquet.ParquetConnector(d))
        assert pqe.run(f"select count(*) c from w_{pkg}.default.asia").columns[0][0] == 5
        assert pqe.run(f"select n_name from w_{pkg}.default.asia order by n_name limit 1"
                       ).columns[0][0] == "CHINA"


def test_dictionary_id_decode_path(tmp_path):
    n = 5000
    vals = ["x", "yy", "zzz", None]
    _write(tmp_path / "t.parquet",
           {"s": pa.array([vals[i % 4] for i in range(n)]).dictionary_encode(),
            "k": pa.array(np.arange(n) % 7)}, row_group_size=1000)
    p = Pair({"pq": (jparquet.ParquetConnector(str(tmp_path)),
                     parquet.ParquetConnector(str(tmp_path)))}, "pq")
    assert p.run("select s, count(*) c from t group by s order by s nulls last").rows() \
        == [("x", 1250), ("yy", 1250), ("zzz", 1250), (None, 1250)]
    assert p.run("select count(*) c from t where s = 'yy'").rows() == [(1250,)]


def test_decimal_buffer_decode(tmp_path):
    vals = [decimal.Decimal("12345678901234.56"), decimal.Decimal("-0.01"),
            None, decimal.Decimal("99999999999999.99")]
    _write(tmp_path / "d.parquet", {"d": pa.array(vals, pa.decimal128(16, 2))})
    p = Pair({"pq": (jparquet.ParquetConnector(str(tmp_path)),
                     parquet.ParquetConnector(str(tmp_path)))}, "pq")
    rows = p.run("select sum(d) s, min(d) mn, count(d) c from d").rows()
    assert abs(rows[0][0] - (12345678901234.56 - 0.01 + 99999999999999.99)) < 0.5
    assert rows[0][1] == -0.01 and rows[0][2] == 3
    p.run("select d from d order by d nulls first")


def _cross(tmp_path, build, queries):
    """``build(engine, session)`` writes in each package's own directory;
    then both packages read both directories, statement by statement."""
    dirs = {}
    for pkg, E, mod, kw in (("jax", JaxEngine, jparquet, {}),
                            ("torch", Engine, parquet, {"device": "cpu"})):
        d = tmp_path / pkg
        d.mkdir()
        build(d, E(**kw), mod)
        dirs[pkg] = str(d)
    out = []
    for pkg, d in dirs.items():
        p = Pair({"pq": (jparquet.ParquetConnector(d), parquet.ParquetConnector(d))}, "pq")
        out.append([p.run(sql).rows() for sql in queries])
    assert out[0] == out[1]
    return out[0]


def test_parquet_ctas_target(tmp_path):
    def build(d, e, mod):
        _write(d / "src.parquet", {"g": pa.array(["a", "b"] * 50), "v": pa.array(np.arange(100))})
        e.register_catalog("pq", mod.ParquetConnector(str(d)))
        e.execute_sql("create table agg as select g, sum(v) sv from src group by g",
                      e.create_session("pq"))
        assert (d / "agg.parquet").exists()

    rows, = _cross(tmp_path, build, ["select g, sv from agg order by g"])
    assert rows == [("a", sum(range(0, 100, 2))), ("b", sum(range(1, 100, 2)))]


def test_parquet_create_insert_decimal_roundtrip(tmp_path):
    def build(d, e, mod):
        _write(d / "src.parquet", {"d": pa.array([decimal.Decimal("1234.56")],
                                                 pa.decimal128(18, 2))})
        e.register_catalog("pq", mod.ParquetConnector(str(d)))
        s = e.create_session("pq")
        e.execute_sql("create table out as select d from src", s)
        e.execute_sql("create table t2 (x bigint, d decimal(10,2), s varchar)", s)
        assert e.execute_sql("select count(*) c from t2", s).rows() == [(0,)]
        e.execute_sql("insert into t2 values (1, 9.75, 'hello'), (2, null, null)", s)
        e.execute_sql("insert into t2 values (3, 1.25, 'hello')", s)
        e.execute_sql("insert into t2 select x + 10, d, s from t2 where x < 3", s)

    out, t2 = _cross(tmp_path, build, ["select d from out", "select x, d, s from t2 order by x"])
    assert out == [(1234.56,)]
    assert t2 == [(1, 9.75, "hello"), (2, None, None), (3, 1.25, "hello"),
                  (11, 9.75, "hello"), (12, None, None)]


# -- ORC: tests/test_connectors_extra.py ----------------------------------------------


def test_orc_connector(tmp_path):
    from pyarrow import orc as paorc

    n = 3000
    paorc.write_table(pa.table({
        "id": pa.array(range(n), pa.int64()),
        "price": pa.array([float(i) * 0.5 for i in range(n)], pa.float64()),
        "tag": pa.array([None if i % 7 == 0 else f"tag{i % 5}" for i in range(n)]),
    }), str(tmp_path / "sales.orc"), stripe_size=64 * 1024)
    p = Pair({"orc": (jorc.OrcConnector(str(tmp_path)), orc.OrcConnector(str(tmp_path)))},
             "orc")
    assert p.run("select count(*), sum(id) from sales").rows()[0] == (n, sum(range(n)))
    got = {k: c for k, c in p.run("select tag, count(*) c from sales where id < 700 "
                                  "group by tag order by tag").rows()}
    assert got == dict(collections.Counter(None if i % 7 == 0 else f"tag{i % 5}"
                                           for i in range(700)))
    r3 = p.run("select sum(price) from sales where tag = 'tag1'").rows()
    assert abs(r3[0][0] - sum(i * 0.5 for i in range(n) if i % 7 != 0 and i % 5 == 1)) < 1e-6
    p.run("select tag, min(price) lo, max(id) hi from sales group by tag order by tag")


def test_orc_write_read_roundtrip_and_ranges(tmp_path):
    """Each package's ORC writer, read back by both."""
    conns = {}
    for pkg, mod, ty in (("jax", jorc, (JBIGINT, JDOUBLE, JVarchar.of(None))),
                         ("torch", orc, (BIGINT, DOUBLE, VarcharType.of(None)))):
        conn = mod.OrcConnector(str(tmp_path / pkg))
        conn.write_table("t", ["id", "x", "s"], list(ty),
                         [[3, 1, 2], [0.5, 1.5, 2.5], ["b", "a", "b"]])
        conns[pkg] = str(tmp_path / pkg)
    for d in conns.values():
        p = Pair({"orc": (jorc.OrcConnector(d), orc.OrcConnector(d))}, "orc")
        r = p.run("select id, x, s from t order by id").to_pandas()
        assert r["id"].tolist() == [1, 2, 3] and r["s"].tolist() == ["a", "b", "b"]
        assert p.t.catalogs["orc"].column_range("t", "id") \
            == p.j.catalogs["orc"].column_range("t", "id") == (1, 3)
        assert int(p.run("select count(*) c from t where s = 'b'").to_pandas().iloc[0, 0]) == 2


# -- tests/test_hive_delta.py ---------------------------------------------------------


@pytest.fixture(scope="module")
def hive_wh(tmp_path_factory):
    wh = str(tmp_path_factory.mktemp("hive") / "wh")
    for ds, region, ids in [("2024-01-01", "emea", [1, 2]), ("2024-01-01", "apac", [3]),
                            ("2024-01-02", "emea", [4, 5, 6])]:
        _write(os.path.join(wh, "events", f"ds={ds}", f"region={region}", "part-0.parquet"),
               {"id": [int(i) for i in ids], "amount": [float(i) * 1.5 for i in ids]})
    return wh


def _hive(wh, catalog="hive"):
    return Pair({catalog: (jhive.HiveConnector(wh), hive.HiveConnector(wh))}, catalog)


def test_hive_partition_discovery_and_scan(hive_wh):
    r = _hive(hive_wh).run("select id, amount, ds, region from events order by id").to_pandas()
    assert r["id"].tolist() == [1, 2, 3, 4, 5, 6]
    assert r["region"].tolist() == ["emea", "emea", "apac", "emea", "emea", "emea"]
    import pandas as pd

    d1, d2 = pd.Timestamp("2024-01-01"), pd.Timestamp("2024-01-02")
    assert [pd.Timestamp(v) for v in r["ds"]] == [d1, d1, d1, d2, d2, d2]


def test_hive_partition_pruning_prunes_splits(hive_wh):
    p = _hive(hive_wh)
    assert int(p.run("select count(*) c from events where region = 'apac'"
                     ).to_pandas().iloc[0, 0]) == 1
    conn, jconn = p.t.catalogs["hive"], p.j.catalogs["hive"]
    apac = next(i for i, v in enumerate(conn.dictionaries("events")["region"].values)
                if v == "apac")
    ranges = [conn.split_range(sp, "region") for sp in conn.splits("events")]
    assert ranges == [jconn.split_range(sp, "region") for sp in jconn.splits("events")]
    assert sum(1 for rg in ranges if rg == (apac, apac)) == 1


def test_hive_group_by_partition_column(hive_wh):
    r = _hive(hive_wh).run("select region, count(*) c, sum(id) si from events "
                           "group by region order by region").to_pandas()
    assert r.values.tolist() == [["apac", 1, 3], ["emea", 5, 18]]


def test_hive_partitioned_write_roundtrip(tmp_path):
    for pkg, mod, sch in (
            ("jax", jhive, JSchema((JField("id", JBIGINT), JField("name", JVarchar.of(None)),
                                    JField("ds", JVarchar.of(None))))),
            ("torch", hive, Schema((Field("id", BIGINT), Field("name", VarcharType.of(None)),
                                    Field("ds", VarcharType.of(None)))))):
        conn = mod.HiveConnector(str(tmp_path / pkg))
        conn.create_table("t", sch, partitioned_by=("ds",))
        conn.append("t", [[1, 2, 3], ["a", "b", "c"], ["x", "x", "y"]])
        assert sorted(os.listdir(tmp_path / pkg / "t")) == ["ds=x", "ds=y"]
    for pkg in ("jax", "torch"):
        r = _hive(str(tmp_path / pkg)).run("select id, name, ds from t order by id").to_pandas()
        assert r.values.tolist() == [[1, "a", "x"], [2, "b", "x"], [3, "c", "y"]]


@pytest.fixture(scope="module")
def delta_wh(tmp_path_factory):
    wh = str(tmp_path_factory.mktemp("delta") / "dwh")
    tdir = os.path.join(wh, "sales")
    _write(os.path.join(tdir, "part-a.parquet"), {"id": [1, 2], "amount": [10.0, 20.0]})
    _write(os.path.join(tdir, "part-b.parquet"), {"id": [3], "amount": [30.0]})
    _write(os.path.join(tdir, "part-stale.parquet"), {"id": [99], "amount": [99.0]})
    schema_string = json.dumps({"type": "struct", "fields": [
        {"name": "id", "type": "long", "nullable": True, "metadata": {}},
        {"name": "amount", "type": "double", "nullable": True, "metadata": {}},
        {"name": "ds", "type": "date", "nullable": True, "metadata": {}}]})
    log = os.path.join(tdir, "_delta_log")
    os.makedirs(log)

    def commit(version, actions):
        with open(os.path.join(log, f"{version:020d}.json"), "w") as f:
            f.write("\n".join(json.dumps(a) for a in actions))

    commit(0, [
        {"protocol": {"minReaderVersion": 1}},
        {"metaData": {"id": "m1", "schemaString": schema_string,
                      "partitionColumns": ["ds"], "format": {"provider": "parquet"}}},
        {"add": {"path": "part-a.parquet", "dataChange": True,
                 "partitionValues": {"ds": "2024-01-01"},
                 "stats": json.dumps({"numRecords": 2, "minValues": {"id": 1},
                                      "maxValues": {"id": 2}})}},
        {"add": {"path": "part-stale.parquet", "dataChange": True,
                 "partitionValues": {"ds": "2024-01-01"}}},
    ])
    commit(1, [
        {"remove": {"path": "part-stale.parquet", "dataChange": True}},
        {"add": {"path": "part-b.parquet", "dataChange": True,
                 "partitionValues": {"ds": "2024-01-02"},
                 "stats": json.dumps({"numRecords": 1, "minValues": {"id": 3},
                                      "maxValues": {"id": 3}})}},
    ])
    return wh


def _delta(wh):
    return Pair({"delta": (jdelta.DeltaConnector(wh), delta.DeltaConnector(wh))}, "delta")


def test_delta_log_replay_and_scan(delta_wh):
    r = _delta(delta_wh).run("select id, amount, ds from sales order by id").to_pandas()
    assert r["id"].tolist() == [1, 2, 3]
    import pandas as pd

    assert pd.Timestamp(r["ds"].iloc[2]) == pd.Timestamp("2024-01-02")


def test_delta_partition_and_stats_pruning(delta_wh):
    conn, jconn = delta.DeltaConnector(delta_wh), jdelta.DeltaConnector(delta_wh)
    d1 = (datetime.date(2024, 1, 1) - datetime.date(1970, 1, 1)).days
    for col, want in (("ds", [(d1, d1), (d1 + 1, d1 + 1)]), ("id", [(1, 2), (3, 3)])):
        got = sorted(conn.split_range(sp, col) for sp in conn.splits("sales"))
        assert got == sorted(jconn.split_range(sp, col) for sp in jconn.splits("sales")) == want
    r = _delta(delta_wh).run("select sum(amount) a from sales where ds = date '2024-01-02'")
    assert float(r.to_pandas().iloc[0, 0]) == 30.0


def test_delta_tables_listing(delta_wh):
    assert delta.DeltaConnector(delta_wh).tables() \
        == jdelta.DeltaConnector(delta_wh).tables() == ["sales"]


def test_memory_filesystem_roundtrip():
    out = []
    for fs_cls in (JaxMemoryFs, MemoryFileSystem):
        fs = fs_cls()
        fs.write_bytes("/wh/t/_delta_log/x.json", b"{}")
        out.append((fs.is_dir("/wh/t/_delta_log"), fs.list_dir("/wh/t"),
                    fs.read_text("/wh/t/_delta_log/x.json"), fs.exists("/wh/t/missing")))
    assert out[0] == out[1] == (True, ["_delta_log"], "{}", False)


def test_delta_checkpoint_replay(tmp_path):
    wh = str(tmp_path / "cwh")
    tdir = os.path.join(wh, "ck")
    _write(os.path.join(tdir, "a.parquet"), {"id": [1, 2], "v": [1.0, 2.0]})
    _write(os.path.join(tdir, "b.parquet"), {"id": [3], "v": [3.0]})
    log = os.path.join(tdir, "_delta_log")
    os.makedirs(log)
    schema_string = json.dumps({"type": "struct", "fields": [
        {"name": "id", "type": "long", "nullable": True, "metadata": {}},
        {"name": "v", "type": "double", "nullable": True, "metadata": {}}]})
    ck_rows = [
        {"metaData": {"id": "m", "schemaString": schema_string, "partitionColumns": []},
         "add": None},
        {"metaData": None,
         "add": {"path": "a.parquet", "partitionValues": [],
                 "stats": json.dumps({"minValues": {"id": 1}, "maxValues": {"id": 2}})}},
    ]
    pq.write_table(pa.Table.from_pylist(ck_rows),
                   os.path.join(log, f"{1:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        f.write(json.dumps({"version": 1}))
    with open(os.path.join(log, f"{2:020d}.json"), "w") as f:
        f.write(json.dumps({"add": {"path": "b.parquet", "dataChange": True,
                                    "partitionValues": {}}}))
    r = _delta(wh).run("select id, v from ck order by id").to_pandas()
    assert r["id"].tolist() == [1, 2, 3]


def test_hive_sql_partitioned_create_table(tmp_path):
    """Through SQL in each package's own warehouse; both read both."""
    for pkg, E, mod, kw in (("jax", JaxEngine, jhive, {}),
                            ("torch", Engine, hive, {"device": "cpu"})):
        wh = str(tmp_path / pkg)
        e = E(**kw)
        e.register_catalog("hive", mod.HiveConnector(wh))
        s = e.create_session("hive")
        e.execute_sql("create table ev (id bigint, v double, ds varchar) "
                      "with (partitioned_by = array['ds'])", s)
        assert int(e.execute_sql("select count(*) c from ev", s).to_pandas().iloc[0, 0]) == 0
        e.execute_sql("insert into ev values (1, 1.5, 'a'), (2, 2.5, 'b'), (3, 3.5, 'a')", s)
        e.execute_sql("insert into ev select id + 10, v, ds from ev where ds = 'b'", s)
        assert sorted(os.listdir(os.path.join(wh, "ev"))) == ["ds=a", "ds=b"]
        with pytest.raises(ValueError, match="unsupported table properties"):
            e.execute_sql("create table z (a bigint) with (bogus = 1)", s)
    for pkg in ("jax", "torch"):
        r = _hive(str(tmp_path / pkg)).run("select ds, count(*) c, sum(v) sv from ev "
                                          "group by ds order by ds").to_pandas()
        assert r.values.tolist() == [["a", 2, 5.0], ["b", 2, 5.0]]


def test_hive_plain_create_and_partition_order_guard(tmp_path):
    """Each package creates and fills ``plain`` in a warehouse of its own;
    both read both.  Partition columns that do not trail, or a property
    that is no ARRAY, are refused alike."""
    for pkg, E, mod, kw in (("jax", JaxEngine, jhive, {}),
                            ("torch", Engine, hive, {"device": "cpu"})):
        e = E(**kw)
        e.register_catalog("hive", mod.HiveConnector(str(tmp_path / pkg)))
        s = e.create_session("hive")
        e.execute_sql("create table plain (a bigint, b varchar)", s)
        e.execute_sql("create table if not exists plain (a bigint, b varchar)", s)
        e.execute_sql("insert into plain values (1, 'x')", s)
    for pkg in ("jax", "torch"):
        p = _hive(str(tmp_path / pkg))
        assert p.run("select a, b from plain").to_pandas().values.tolist() == [[1, "x"]]
    p.raises("create table bad (ds varchar, id bigint) with (partitioned_by = array['ds'])",
             ValueError, "trailing")
    p.raises("create table bad2 (id bigint, ds varchar) with (partitioned_by = 'ds')",
             ValueError, "ARRAY")


# -- tests/test_iceberg.py ------------------------------------------------------------

KV = {"type": "record", "name": "kv", "fields": [
    {"name": "key", "type": "int"}, {"name": "value", "type": "bytes"}]}
MANIFEST_ENTRY = {"type": "record", "name": "manifest_entry", "fields": [
    {"name": "status", "type": "int"},
    {"name": "snapshot_id", "type": ["null", "long"]},
    {"name": "data_file", "type": {"type": "record", "name": "r2", "fields": [
        {"name": "content", "type": "int"},
        {"name": "file_path", "type": "string"},
        {"name": "file_format", "type": "string"},
        {"name": "record_count", "type": "long"},
        {"name": "file_size_in_bytes", "type": "long"},
        {"name": "lower_bounds", "type": ["null", {"type": "array", "items": KV}]},
        {"name": "upper_bounds", "type": ["null", {"type": "array", "items": KV}]},
    ]}},
]}
MANIFEST_FILE = {"type": "record", "name": "manifest_file", "fields": [
    {"name": "manifest_path", "type": "string"},
    {"name": "manifest_length", "type": "long"},
    {"name": "partition_spec_id", "type": "int"},
]}


def _ice_warehouse(root, write_container):
    """tests/test_iceberg.py's table, its avro manifests written by
    ``write_container`` (one package's)."""
    tdir = root / "events"
    (tdir / "metadata").mkdir(parents=True)
    (tdir / "data").mkdir()

    def datafile(name, ids, names, amounts):
        path = tdir / "data" / name
        pq.write_table(pa.table({"id": pa.array(ids, pa.int64()), "name": pa.array(names),
                                 "amount": pa.array(amounts, pa.float64())}),
                       path, row_group_size=4)
        return str(path)

    f1 = datafile("f1.parquet", list(range(0, 10)), [f"u{i % 3}" for i in range(10)],
                  [float(i) for i in range(10)])
    f2 = datafile("f2.parquet", list(range(100, 110)), [f"u{i % 5}" for i in range(10)],
                  [float(i) * 2 for i in range(10)])
    f3 = datafile("f3.parquet", [999], ["dead"], [0.0])
    entries = []
    for status, path, n, lo, hi in ((1, f1, 10, 0, 9), (1, f2, 10, 100, 109),
                                    (2, f3, 1, 999, 999)):
        entries.append({"status": status, "snapshot_id": 7, "data_file": {
            "content": 0, "file_path": path, "file_format": "PARQUET", "record_count": n,
            "file_size_in_bytes": os.path.getsize(path),
            "lower_bounds": [{"key": 1, "value": struct.pack("<q", lo)}],
            "upper_bounds": [{"key": 1, "value": struct.pack("<q", hi)}]}})
    mpath = str(tdir / "metadata" / "m1.avro")
    write_container(mpath, MANIFEST_ENTRY, entries, codec="deflate")
    mlist = str(tdir / "metadata" / "snap-7.avro")
    write_container(mlist, MANIFEST_FILE, [{"manifest_path": mpath,
                                            "manifest_length": os.path.getsize(mpath),
                                            "partition_spec_id": 0}])
    meta = {"format-version": 1, "table-uuid": "0000-test", "location": str(tdir),
            "current-schema-id": 0,
            "schemas": [{"schema-id": 0, "type": "struct", "fields": [
                {"id": 1, "name": "id", "type": "long", "required": True},
                {"id": 2, "name": "name", "type": "string", "required": False},
                {"id": 3, "name": "amount", "type": "double", "required": False}]}],
            "current-snapshot-id": 7,
            "snapshots": [{"snapshot-id": 7, "manifest-list": mlist}]}
    with open(tdir / "metadata" / "v3.metadata.json", "w") as f:
        json.dump(meta, f)
    with open(tdir / "metadata" / "version-hint.text", "w") as f:
        f.write("3")
    return str(root)


@pytest.fixture(scope="module", params=["jax", "torch"], ids=["ref-avro", "port-avro"])
def ice(request, tmp_path_factory):
    """Both packages over a warehouse whose manifests one package wrote."""
    writer = (javro if request.param == "jax" else avro).write_container
    wh = _ice_warehouse(tmp_path_factory.mktemp(f"ice_{request.param}"), writer)
    mpath = os.path.join(wh, "events", "metadata", "m1.avro")
    assert avro.read_container(mpath) == javro.read_container(mpath)
    return Pair({"ice": (jiceberg.IcebergConnector(wh), iceberg.IcebergConnector(wh))}, "ice")


def test_iceberg_scan_skips_deleted(ice):
    assert ice.run("select count(*) c, sum(id) si from events").rows() \
        == [(20, sum(range(10)) + sum(range(100, 110)))]


def test_iceberg_strings_unified_across_files(ice):
    rows = ice.run("select name, count(*) c from events group by name order by name").rows()
    names = [r[0] for r in rows]
    assert names == sorted(set(f"u{i % 3}" for i in range(10)) | set(f"u{i % 5}" for i in range(10)))
    assert sum(r[1] for r in rows) == 20 and "dead" not in names


def test_iceberg_file_pruning(ice):
    generated = {}
    for pkg, e in (("jax", ice.j), ("torch", ice.t)):
        conn = e.catalogs["ice"]
        seen = generated.setdefault(pkg, [])
        orig = conn.generate
        conn.generate = lambda sp, cols, seen=seen, orig=orig: (seen.append(sp), orig(sp, cols))[1]
    try:
        assert ice.run("select count(*) c from events where id >= 100").rows() == [(10,)]
    finally:
        for e in (ice.j, ice.t):
            del e.catalogs["ice"].generate
    assert generated["torch"] and all(sp.file_index == 1 for sp in generated["torch"])
    assert [(s.file_index, s.row_group) for s in generated["torch"]] \
        == [(s.file_index, s.row_group) for s in generated["jax"]]


def test_iceberg_column_range_and_tables(ice):
    conn = ice.t.catalogs["ice"]
    assert conn.tables() == ["events"]
    assert conn.column_range("events", "id") == (0, 109)
    assert ice.run("select count(*) c from events a, events b "
                   "where a.id = b.id and a.amount > 3").rows() == [(14,)]


# -- tests/test_decimal38.py, tests/test_predicate.py ---------------------------------


def test_parquet_decimal38_roundtrip(tmp_path):
    vals = [decimal.Decimal("123456789012345.6789"), decimal.Decimal("-99999.0001"),
            decimal.Decimal("0.5")]
    _write(tmp_path / "t.parquet", {"v": pa.array(vals, type=pa.decimal128(38, 4)),
                                    "k": pa.array([1, 2, 3], type=pa.int64())})
    p = Pair({"pq": (jparquet.ParquetConnector(str(tmp_path)),
                     parquet.ParquetConnector(str(tmp_path)))}, "pq")
    got = p.run("select k, v from t order by k").to_pandas()
    np.testing.assert_allclose(got["v"].astype(float).to_numpy(), [float(v) for v in vals],
                               rtol=1e-12)
    _write(tmp_path / "w.parquet", {"v": pa.array([decimal.Decimal("9" * 25)],
                                                  type=pa.decimal128(38, 0))})
    p = Pair({"pq": (jparquet.ParquetConnector(str(tmp_path)),
                     parquet.ParquetConnector(str(tmp_path)))}, "pq")
    p.raises("select sum(v) from w", ValueError, "2\\^63|Int128")


def test_null_admitting_domains_never_prune(tmp_path):
    n = 5000
    vals = [None if i % 11 == 0 else i % 200 for i in range(n)]
    _write(tmp_path / "events.parquet", {"val": pa.array(vals, pa.int64())}, row_group_size=500)
    p = Pair({"pq": (jparquet.ParquetConnector(str(tmp_path)),
                     parquet.ParquetConnector(str(tmp_path)))}, "pq")
    assert p.run("select count(*) from events where val is null").rows()[0][0] \
        == sum(1 for v in vals if v is None)
    assert p.run("select count(*) from events where val > 100 or val is null").rows()[0][0] \
        == sum(1 for v in vals if v is None or v > 100)
    assert p.run("select count(*) from events where val = 150").rows()[0][0] \
        == sum(1 for v in vals if v == 150)


def test_direct_groupby_late_null_page(tmp_path):
    ks = [["a", "b", "c"][i % 3] for i in range(900)] + \
         [None if i % 5 == 0 else ["a", "b", "c"][i % 3] for i in range(900)]
    _write(tmp_path / "t.parquet", {"k": pa.array(ks, pa.string())}, row_group_size=900)
    p = Pair({"pq": (jparquet.ParquetConnector(str(tmp_path)),
                     parquet.ParquetConnector(str(tmp_path)))}, "pq")
    rows = p.run("select k, count(*) c from t group by k order by k").rows()
    assert {k: c for k, c in rows} == dict(collections.Counter(ks))


# -- tests/test_memory_spill.py ------------------------------------------------------


def test_parquet_join_spills_without_redecoding(tmp_path, monkeypatch):
    """A join whose build exceeds a tiny pool, over Parquet: the port's
    result equals the reference's unconstrained one, every split decodes
    once (the Grace pass keeps staged pages instead of re-reading the
    file), and EXPLAIN ANALYZE shows the spill."""
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path / "spill"))
    n = 20_000
    rng = np.random.default_rng(3)
    _write(tmp_path / "d" / "facts.parquet", {
        "k": pa.array(rng.integers(0, 5000, n), pa.int64()),
        "v": pa.array(rng.normal(size=n))}, row_group_size=2048)
    _write(tmp_path / "d" / "dims.parquet", {
        "k": pa.array(np.arange(5000, dtype=np.int64)),
        "w": pa.array(np.arange(5000, dtype=np.int64) * 2)}, row_group_size=2048)
    d = str(tmp_path / "d")
    sql = "select count(*) c, sum(w) sw from facts, dims where facts.k = dims.k and v < 10"
    je = JaxEngine()
    je.register_catalog("pq", jparquet.ParquetConnector(d))
    full = JaxExecutor(je.catalogs).execute(jax_compile(sql, je, je.create_session("pq"))).rows()
    e = Engine(device="cpu")
    conn = parquet.ParquetConnector(d)
    e.register_catalog("pq", conn)
    generated = []
    orig = conn.generate
    conn.generate = lambda split, cols: (generated.append(split), orig(split, cols))[1]
    plan = compile_sql(sql, e, e.create_session("pq"))
    ex = LocalExecutor(e.catalogs, "cpu", memory_pool=MemoryPool(max_bytes=60_000))
    small = ex.execute(plan).rows()
    del conn.generate
    assert small == full
    keys = [repr(sp) for sp in generated]
    assert len(keys) == len(set(keys)), "a parquet split was decoded twice"
    from trino_tpu_torch.sql import plan as P
    from trino_tpu_torch.sql.planprinter import format_plan

    joins = []

    def walk(nd):
        if isinstance(nd, P.Join):
            joins.append(nd)
        for c in nd.children:
            walk(c)

    walk(plan)
    assert any((ex.stats.get(id(j)) or {}).get("spilled_bytes") for j in joins)
    text = format_plan(plan, ex.stats)
    assert "spilled:" in text and "partitions]" in text
    assert not os.listdir(tmp_path / "spill"), "a spill file outlived its query"


# -- the port's own: pyarrow, the page tier's opt-in, host-decode staging -------------


def test_file_connectors_import_without_pyarrow_and_name_it_when_used(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "import trino_tpu_torch.connectors.parquet as p, trino_tpu_torch.connectors.orc as o\n"
        "import trino_tpu_torch.connectors.filetable, trino_tpu_torch.connectors.hive as h\n"
        "import trino_tpu_torch.connectors.iceberg as i, trino_tpu_torch.connectors.delta\n"
        "import trino_tpu_torch.fs, trino_tpu_torch.formats.avro\n"
        "assert 'jax' not in sys.modules and 'trino_tpu' not in sys.modules\n"
        f"d = {str(tmp_path)!r}\n"
        "open(d + '/t.parquet', 'wb').write(b'x')\n"
        "open(d + '/t.orc', 'wb').write(b'x')\n"
        "for use in (lambda: p.ParquetConnector(d).schema('t'),\n"
        "            lambda: o.OrcConnector(d).schema('t')):\n"
        "    try:\n"
        "        use()\n"
        "    except ImportError as e:\n"
        "        assert 'pyarrow' in str(e), e\n"
        "        print('named:', e)\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("named:") == 2


def test_page_tier_opt_in_equals_the_reference(tmp_path):
    """Each connector opts into the page tier as the reference's does, and
    decodes on the host where the reference's does; the port's dbapi
    connector decodes on the host too (its rows arrive from a remote
    database as Python values), where the reference's makes device pages."""
    pairs = [(JaxBlackHole(), BlackHoleConnector()),
             (JaxDbapi(lambda: None), DbapiConnector(lambda: None)),
             (JaxMemory(), MemoryConnector()),
             (JaxTpch(sf=0.01), TpchConnector(sf=0.01)),
             (jparquet.ParquetConnector(str(tmp_path)), parquet.ParquetConnector(str(tmp_path))),
             (jorc.OrcConnector(str(tmp_path)), orc.OrcConnector(str(tmp_path))),
             (jhive.HiveConnector(str(tmp_path)), hive.HiveConnector(str(tmp_path))),
             (jdelta.DeltaConnector(str(tmp_path)), delta.DeltaConnector(str(tmp_path))),
             (jiceberg.IcebergConnector(str(tmp_path)), iceberg.IcebergConnector(str(tmp_path)))]
    for jc, tc in pairs:
        assert DeviceBufferPool.cacheable(tc) == JaxBufferPool.cacheable(jc), type(tc)
        assert getattr(tc, "HOST_DECODE", False) \
            == (getattr(jc, "HOST_DECODE", False) or isinstance(tc, DbapiConnector)), type(tc)
    assert not DeviceBufferPool.cacheable(DbapiConnector(lambda: None))
    assert DbapiConnector.HOST_DECODE and not getattr(JaxDbapi, "HOST_DECODE", False)
    assert issubclass(hive.HiveConnector, filetable.MultiFileConnector)


def test_host_decoded_pages_are_staged_by_the_producer(pq_dir, monkeypatch):
    """A parquet scan's numpy pages reach the executor through the
    prefetch producer, which stages them (``_page_to_device``); their bytes
    are the query's ``h2d_bytes``; each page is a ``generate`` and an
    ``h2d`` fault point, crossed as often as in the reference."""
    staged = []
    to_device = tle._page_to_device

    def spy(page, device, side):
        staged.append((threading.current_thread().name,
                       all(isinstance(c, np.ndarray) for c in page.columns)))
        return to_device(page, device, side)

    monkeypatch.setattr(tle, "_page_to_device", spy)
    sql = "select sum(id) s, count(name) c from events"
    spec = "point=generate,action=delay,s=0,every=1;point=h2d,action=delay,s=0,every=1"
    fires, results = {}, {}
    for pkg, E, mod, F, kw in (("jax", JaxEngine, jparquet, jfaults, {}),
                               ("torch", Engine, parquet, faults, {"device": "cpu"})):
        e = E(**kw)
        e.register_catalog("pq", mod.ParquetConnector(pq_dir))
        with F.injected(spec) as plan:
            results[pkg] = e.execute_sql(sql, e.create_session("pq"))
        fires[pkg] = [st["fires"] for st in plan.stats()]
        if pkg == "torch":
            counters = dict(e.last_query_counters)
    same(results["jax"], results["torch"], sql)
    n_splits = len(parquet.ParquetConnector(pq_dir).splits("events"))
    assert staged == [("prefetch-producer", True)] * n_splits
    assert fires["torch"] == fires["jax"] == [n_splits, n_splits]
    nulls = sum(1 for i in range(5000) if i % 13 == 0) > 0  # name has NULLs: a mask a page
    assert counters["h2d_bytes"] == 5000 * 8 + 5000 * 4 + (5000 if nulls else 0)
