"""The port's memory connector alone against the JAX package's.

The same seeded appends (python lists of decoded values, as the engine's
writes pass them: strings with NULLs, decimals as raw scaled ints, dates as
epoch days, doubles with NaN, booleans, bigints with NULLs) go into both
connectors; then deletes and updates.  After every step both must agree:
``generate`` split by split over memory pages of 2^10 rows (values exactly,
NaN where NaN, dtypes, NULL masks, every lane live), ``dictionaries``
element for element, ``row_count``, ``splits``, ``schema``,
``column_range``, ``delete_rows``' and ``update_rows``' counts, and the
errors of ``create_table`` (IF NOT EXISTS) and ``drop_table``.  Also: the
port's stored columns live on its device as torch tensors, ``generate``
hands out views of them, writes never change a tensor handed out earlier,
columns given in storage form (``Raw``, ``Coded``) store what their decoded
values store, and array columns (heaps, spans, element dictionaries) equal
the reference's through appends, deletes and updates.
"""

import numpy as np
import pytest
import torch

import trino_tpu.connectors.memory as jax_memory
import trino_tpu_torch.connectors.memory as torch_memory
from trino_tpu.page import Schema as JaxSchema
from trino_tpu.types import (BIGINT as J_BIGINT, BOOLEAN as J_BOOLEAN, DATE as J_DATE,
                             DOUBLE as J_DOUBLE, ArrayType as JArray,
                             DecimalType as JDecimal, VarcharType as JVarchar)
from trino_tpu_torch.connectors.memory import Coded, MemoryConnector, Raw
from trino_tpu_torch.page import Schema
from trino_tpu_torch.types import (BIGINT, BOOLEAN, DATE, DOUBLE, ArrayType, DecimalType,
                                   VarcharType)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPLIT = 1 << 10

COLUMNS = [("k", BIGINT, J_BIGINT), ("s", VarcharType.of(None), JVarchar.of(None)),
           ("p", DecimalType.of(12, 2), JDecimal.of(12, 2)), ("d", DATE, J_DATE),
           ("x", DOUBLE, J_DOUBLE), ("b", BOOLEAN, J_BOOLEAN),
           ("n", BIGINT, J_BIGINT)]
WORDS = np.array(["alpha", "beta", "gamma", "delta", "", "epsilon", "zeta 7", "eta"])


@pytest.fixture(autouse=True)
def small_pages(monkeypatch):
    monkeypatch.setattr(jax_memory, "SPLIT_ROWS", SPLIT)
    monkeypatch.setattr(torch_memory, "SPLIT_ROWS", SPLIT)


def _schemas():
    return (JaxSchema.of(*[(n, j) for n, _, j in COLUMNS]),
            Schema.of(*[(n, t) for n, t, _ in COLUMNS]))


def _batch(rng, n, base):
    """One append's decoded columns, drawn from ``rng``."""
    strs = [None if rng.random() < 0.15 else str(WORDS[rng.integers(len(WORDS))])
            + ("" if rng.random() < 0.7 else f" {int(rng.integers(0, 50))}")
            for _ in range(n)]
    x = rng.normal(size=n)
    x[rng.random(n) < 0.05] = np.nan
    return [
        list(range(base, base + n)),
        strs,
        rng.integers(-10**9, 10**9, size=n).tolist(),
        rng.integers(-3000, 20000, size=n).tolist(),
        x.tolist(),
        (rng.random(n) < 0.5).tolist(),
        [None if rng.random() < 0.3 else int(v)
         for v in rng.integers(-(1 << 62), 1 << 62, size=n)],
    ]


def _assert_tables_equal(j, t, table):
    assert t.tables() == j.tables()
    assert t.row_count(table) == j.row_count(table)
    assert t.schema(table).names == j.schema(table).names
    assert [f.type.name for f in t.schema(table).fields] == \
        [f.type.name for f in j.schema(table).fields]
    assert t.column_range(table, "k") == j.column_range(table, "k") == (None, None)
    dj, dt = j.dictionaries(table), t.dictionaries(table)
    assert sorted(dt) == sorted(dj)
    for c in dj:
        assert list(dt[c].values) == list(dj[c].values), c
    sj, st = j.splits(table), t.splits(table)
    assert [(s.lo, s.hi) for s in st] == [(s.lo, s.hi) for s in sj]
    for a, b in zip(sj, st):
        pa, pb = j.generate(a), t.generate(b)
        assert pb.valid is None and pa.valid is None
        for f, ca, cb, na, nb in zip(pa.schema.fields, pa.columns, pb.columns,
                                     pa.null_masks, pb.null_masks):
            ca, cb = np.asarray(ca), cb.cpu().numpy()
            assert cb.dtype == ca.dtype, f.name
            np.testing.assert_array_equal(cb, ca, err_msg=f.name)
            assert (na is None) == (nb is None), f.name
            if na is not None:
                np.testing.assert_array_equal(nb.cpu().numpy(), np.asarray(na), err_msg=f.name)


@pytest.fixture
def both():
    rng = np.random.default_rng(5)
    js, ts = _schemas()
    j, t = jax_memory.MemoryConnector(), MemoryConnector(device="cpu")
    assert j.create_table("w", js) is True
    assert t.create_table("w", ts) is True
    base = 0
    for n in (700, 1500, 1, 900):  # splits of 2^10 rows: ragged pages
        cols = _batch(rng, n, base)
        j.append("w", cols)
        t.append("w", cols)
        base += n
    return j, t, rng


def test_appends_equal_the_reference(both):
    j, t, _ = both
    _assert_tables_equal(j, t, "w")
    assert t.row_count("w") == 3101
    assert len(t.splits("w")) == 4


def test_delete_rows_equals_the_reference(both):
    j, t, rng = both
    for frac in (0.3, 0.0, 0.9):
        mask = rng.random(j.row_count("w")) < frac
        assert t.delete_rows("w", mask) == j.delete_rows("w", mask)
        _assert_tables_equal(j, t, "w")
    mask = np.ones(j.row_count("w"), bool)
    assert t.delete_rows("w", mask) == j.delete_rows("w", mask) > 0
    _assert_tables_equal(j, t, "w")
    assert t.row_count("w") == 0 and t.splits("w") == []


def test_update_rows_equals_the_reference(both):
    j, t, rng = both
    n = j.row_count("w")
    for _ in range(3):
        mask = rng.random(n) < 0.4
        new = _batch(rng, n, 0)
        values = {"s": new[1], "p": new[2], "n": new[6], "b": new[5]}
        assert t.update_rows("w", mask, values) == j.update_rows("w", mask, values)
        _assert_tables_equal(j, t, "w")
    mask = rng.random(n) < 0.5
    values = {"s": ["theta"] * n, "d": [None] * n}
    assert t.update_rows("w", mask, values) == j.update_rows("w", mask, values)
    _assert_tables_equal(j, t, "w")


def test_storage_forms_store_what_decoded_values_store(both):
    _, t, rng = both
    js, ts = _schemas()
    u = MemoryConnector(device="cpu")
    u.create_table("w", ts)
    for s in t.splits("w"):
        page = t.generate(s)
        cols = []
        for f, c, m in zip(page.schema.fields, page.columns, page.null_masks):
            nulls = np.zeros(c.shape[0], bool) if m is None else m.numpy()
            if f.type.is_string:
                d = t.dictionaries("w")[f.name]
                cols.append(Coded(c.numpy().astype(np.int64), np.asarray(d.values), nulls))
            else:
                cols.append(Raw(c.numpy(), nulls))
        u.append("w", cols)
    for s, v in zip(t.splits("w"), u.splits("w")):
        a, b = t.generate(s), u.generate(v)
        for ca, cb, na, nb in zip(a.columns, b.columns, a.null_masks, b.null_masks):
            torch.testing.assert_close(cb, ca, rtol=0, atol=0, equal_nan=True)
            assert (na is None) == (nb is None) and (na is None or torch.equal(na, nb))
    assert list(u.dictionaries("w")["s"].values) == list(t.dictionaries("w")["s"].values)


def test_stored_columns_are_device_tensors_handed_out_as_views(both):
    _, t, rng = both
    page = t.generate(t.splits("w")[1])
    stored = t._tables["w"].columns
    assert all(isinstance(c, torch.Tensor) and c.device.type == "cpu" for c in stored)
    assert page.columns[0].data_ptr() == stored[0][SPLIT:].data_ptr()
    assert page.columns[0]._base is stored[0]
    before = [c.clone() for c in page.columns]
    n = t.row_count("w")
    t.update_rows("w", np.ones(n, bool), {"k": [0] * n, "s": ["z"] * n})
    t.delete_rows("w", rng.random(n) < 0.5)
    t.append("w", _batch(rng, 10, 0))
    for a, b in zip(before, page.columns):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


def test_register_binds_the_engine_device():
    from trino_tpu_torch import Engine

    conn = MemoryConnector()
    assert conn.device is None
    Engine(device="cpu").register_catalog("mem", conn)
    assert conn.device == torch.device("cpu")


def test_create_and_drop_equal_the_reference():
    js, ts = _schemas()
    j, t = jax_memory.MemoryConnector(), MemoryConnector(device="cpu")
    for conn, schema in ((j, js), (t, ts)):
        assert conn.create_table("a", schema) is True
        assert conn.create_table("a", schema, if_not_exists=True) is False
        with pytest.raises(ValueError, match="table a already exists"):
            conn.create_table("a", schema)
        conn.drop_table("a")
        conn.drop_table("a", if_exists=True)
        with pytest.raises(ValueError, match="table a does not exist"):
            conn.drop_table("a")
        assert conn.tables() == []


def test_array_column_raises_naming_the_path():
    # array columns are ported: heaps, spans and element dictionaries equal
    # the reference's through appends (python lists, None = NULL), a delete
    # and an update of another column
    t = MemoryConnector(device="cpu")
    j = jax_memory.MemoryConnector()
    vs, jvs = VarcharType.of(None), JVarchar.of(None)
    assert t.create_table("a", Schema.of(("k", BIGINT), ("xs", ArrayType.of(BIGINT)),
                                         ("ss", ArrayType.of(vs))))
    assert j.create_table("a", JaxSchema.of(("k", J_BIGINT), ("xs", JArray.of(J_BIGINT)),
                                            ("ss", JArray.of(jvs))))
    rng = np.random.default_rng(9)
    for lo in (0, 40):
        rows = [None if rng.random() < 0.2 else rng.integers(0, 9, rng.integers(0, 5)).tolist()
                for _ in range(40)]
        words = [None if rng.random() < 0.2 else list(rng.choice(WORDS, rng.integers(0, 4)))
                 for _ in range(40)]
        for conn in (t, j):
            conn.append("a", [list(range(lo, lo + 40)), rows, words])
    mask = rng.random(80) < 0.3
    assert t.delete_rows("a", mask) == j.delete_rows("a", mask)
    keep = int((~mask).sum())
    upd = rng.random(keep) < 0.5
    assert t.update_rows("a", upd, {"k": [7] * keep}) == j.update_rows("a", upd, {"k": [7] * keep})
    jd, td = j.dictionaries("a"), t.dictionaries("a")
    for name in ("xs", "ss"):
        np.testing.assert_array_equal(td[name].values, jd[name].values)
        assert td[name].max_len == jd[name].max_len
    np.testing.assert_array_equal(np.asarray(td["ss"].elem_dict.values),
                                  np.asarray(jd["ss"].elem_dict.values))
    jp = j.generate(j.splits("a")[0])
    tp = t.generate(t.splits("a")[0])
    for ca, cb, na, nb in zip(jp.columns, tp.columns, jp.null_masks, tp.null_masks):
        np.testing.assert_array_equal(cb.numpy(), np.asarray(ca))
        assert (na is None) == (nb is None)
        if na is not None:
            np.testing.assert_array_equal(nb.numpy(), np.asarray(na))
