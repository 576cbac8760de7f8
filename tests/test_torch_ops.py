"""Operator-module parity with the JAX package: hash aggregation (hash and
direct modes, growth by rehash, group compaction) and hash joins (hash and
direct builds and probes), over the same numpy inputs.

Aggregation states are compared as group -> accumulator maps (slot layouts
are never compared); integer and decimal accumulators exactly, DOUBLE sums
within rtol 1e-9 (the summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import types as JT
from trino_tpu.ops import hashagg as jagg, hashjoin as jjoin
from trino_tpu.page import Field as JField, Page as JPage, Schema as JSchema
from trino_tpu_torch import types as TT
from trino_tpu_torch.ops import hashagg as tagg, hashjoin as tjoin
from trino_tpu_torch.ops.convert import groupby_state_from_numpy, page_from_numpy
from trino_tpu_torch.page import Field as TField, Schema as TSchema

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

EMPTY = np.iinfo(np.int64).max
KINDS = ("sum_hi32", "sum_lo32", "count", "count_star", "sum", "min", "max")
ACC_NP = [(np.int64, 0), (np.int64, 0), (np.int64, 0), (np.int64, 0), (np.float64, 0),
          (np.int64, np.iinfo(np.int64).max), (np.int64, np.iinfo(np.int64).min)]


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _page_inputs(rng, n, nkeys_distinct):
    k1 = rng.integers(0, nkeys_distinct, size=n).astype(np.int64) * 7919 - 100
    k2 = rng.integers(0, 3, size=n).astype(np.int32)
    k2n = rng.random(n) < 0.1
    dec = rng.integers(-10**12, 10**12, size=n, dtype=np.int64)
    dnull = rng.random(n) < 0.05
    dbl = rng.normal(size=n)
    valid = rng.random(n) < 0.9
    inputs = [(dec, dnull), (dec, dnull), (dec, dnull), None, (dbl, None), (dec, None),
              (dec, None)]
    return (k1, k2), (None, k2n), inputs, valid


def _groups(state, n_accs):
    table = np.asarray(state.table) if not isinstance(state.table, torch.Tensor) \
        else state.table.numpy()
    C = table.shape[0] - 1
    occ = table[:C] != EMPTY

    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    keys = [arr(k)[:C][occ] for k in state.key_cols]
    knulls = [arr(k)[:C][occ] for k in state.key_nulls]
    accs = [arr(a)[:C][occ] for a in state.accs]
    out = {}
    for r in range(int(occ.sum())):
        key = tuple((None if kn[r] else int(k[r])) for k, kn in zip(keys, knulls))
        out[key] = tuple(a[r] for a in accs)
    return out


def _assert_groups_equal(g_j, g_t):
    assert set(g_j) == set(g_t)
    for key in g_j:
        for j, (a, b) in enumerate(zip(g_j[key], g_t[key])):
            if KINDS[j] == "sum":
                np.testing.assert_allclose(b, a, rtol=1e-9)
            else:
                assert a == b, (key, KINDS[j])


def _insert_both(js, ts, rng, pages, n, distinct):
    jtypes, ttypes = (JT.BIGINT, JT.INTEGER), (TT.BIGINT, TT.INTEGER)
    for _ in range(pages):
        keys, knulls, inputs, valid = _page_inputs(rng, n, distinct)
        js = jagg.groupby_insert(
            js, tuple(jnp.asarray(k) for k in keys), jtypes, jnp.asarray(valid),
            [(None, None) if i is None else (jnp.asarray(i[0]),
                                              None if i[1] is None else jnp.asarray(i[1]))
             for i in inputs], list(KINDS),
            tuple(None if m is None else jnp.asarray(m) for m in knulls))
        ts = tagg.groupby_insert(
            ts, tuple(_t(k) for k in keys), ttypes, _t(valid),
            [(None, None) if i is None else (_t(i[0]), _t(i[1])) for i in inputs],
            list(KINDS), tuple(_t(m) for m in knulls))
    return js, ts


@pytest.mark.parametrize("pages,n,distinct", [(1, 0, 1), (3, 700, 40), (2, 2000, 300)])
def test_groupby_insert_multi_page(pages, n, distinct):
    rng = np.random.default_rng(pages * 100 + n)
    js = jagg.groupby_init(4096, (jnp.int64, jnp.int32), [(jnp.dtype(d), i) for d, i in ACC_NP])
    ts = tagg.groupby_init(4096, (np.int64, np.int32), ACC_NP)
    js, ts = _insert_both(js, ts, rng, pages, n, distinct)
    assert not bool(js.overflow) and not bool(ts.overflow)
    _assert_groups_equal(_groups(js, len(KINDS)), _groups(ts, len(KINDS)))
    assert int(jagg.group_count(js)) == int(tagg.group_count(ts))


def test_rehash_and_compact_groups_from_a_carried_state():
    """A state the JAX insert filled is carried across (convert), both grow it
    4x by rehash, insert more, and compact their groups."""
    rng = np.random.default_rng(5)
    js = jagg.groupby_init(256, (jnp.int64, jnp.int32), [(jnp.dtype(d), i) for d, i in ACC_NP])
    js, _ = _insert_both(js, tagg.groupby_init(256, (np.int64, np.int32), ACC_NP), rng, 2,
                         300, 60)
    ts = groupby_state_from_numpy(np.asarray(js.table), [np.asarray(k) for k in js.key_cols],
                                  [np.asarray(k) for k in js.key_nulls],
                                  [np.asarray(a) for a in js.accs], js.overflow)
    js = jagg.rehash(js, 1024, KINDS)
    ts = tagg.rehash(ts, 1024, KINDS)
    assert ts.capacity == 1024
    js, ts = _insert_both(js, ts, rng, 2, 400, 90)
    _assert_groups_equal(_groups(js, len(KINDS)), _groups(ts, len(KINDS)))
    n = int(tagg.group_count(ts))
    size = 1 << max(n - 1, 1).bit_length()
    jk, jkn, ja = jagg.compact_groups(js, size)
    tk, tkn, ta = tagg.compact_groups(ts, size)
    rows_j = {tuple(int(np.asarray(k)[r]) for k in jk + jkn): tuple(
        np.asarray(a)[r] for a in ja if a.dtype != jnp.float64) for r in range(n)}
    rows_t = {tuple(int(k[r]) for k in tk + tkn): tuple(
        a[r].item() for a in ta if a.dtype != torch.float64) for r in range(n)}
    assert rows_j == rows_t
    assert all(int(x) == 0 for k in tk for x in k[n:])  # zero tail


@pytest.mark.parametrize("ranges,nullable", [
    (((0, 2), (0, 1)), (False, False)),         # Q1's 8-slot one-hot branch
    (((0, 24), (1992, 1998)), (False, True)),   # scatter branch, a nullable key
    (((0, 2), (0, 1)), (False, True)),          # one-hot with a null flag bit
])
def test_direct_groupby(ranges, nullable):
    rng = np.random.default_rng(len(ranges) + sum(nullable))
    jcfg = jagg.direct_config(ranges, nullable)
    tcfg = tagg.direct_config(ranges, nullable)
    assert jcfg.entries == tcfg.entries and jcfg.total_bits == tcfg.total_bits
    js = jagg.direct_groupby_init(jcfg, (jnp.int32, jnp.int64),
                                  [(jnp.dtype(d), i) for d, i in ACC_NP])
    ts = tagg.direct_groupby_init(tcfg, (np.int32, np.int64), ACC_NP)
    for _ in range(3):
        n = 900
        k1 = rng.integers(ranges[0][0], ranges[0][1] + 1, size=n).astype(np.int32)
        k2 = rng.integers(ranges[1][0], ranges[1][1] + 1, size=n).astype(np.int64)
        k2n = (rng.random(n) < 0.2) if nullable[1] else None
        dec = rng.integers(-10**12, 10**12, size=n, dtype=np.int64)
        dbl = rng.normal(size=n)
        valid = rng.random(n) < 0.9
        inputs = [(dec, None)] * 4 + [(dbl, None), (dec, None), (dec, None)]
        js = jagg.direct_groupby_insert(
            js, jcfg, (jnp.asarray(k1), jnp.asarray(k2)), jnp.asarray(valid),
            [(jnp.asarray(v), None) for v, _ in inputs], list(KINDS),
            (None, None if k2n is None else jnp.asarray(k2n)))
        ts = tagg.direct_groupby_insert(
            ts, tcfg, (_t(k1), _t(k2)), _t(valid), [(_t(v), None) for v, _ in inputs],
            list(KINDS), (None, _t(k2n)))
    assert bool(js.overflow) == bool(ts.overflow)
    _assert_groups_equal(_groups(js, len(KINDS)), _groups(ts, len(KINDS)))


def _build_pages(rng, nb, keys2=False):
    k = rng.permutation(np.arange(1, 4 * nb + 1, dtype=np.int64))[:nb] * 3
    k2 = rng.integers(0, 5, size=nb).astype(np.int32)
    payload = rng.integers(-100, 100, size=nb, dtype=np.int64)
    valid = rng.random(nb) < 0.9
    cols = [k, k2, payload] if keys2 else [k, payload]
    jf = [JField("k", JT.BIGINT)] + ([JField("k2", JT.INTEGER)] if keys2 else []) \
        + [JField("v", JT.BIGINT)]
    tf = [TField("k", TT.BIGINT)] + ([TField("k2", TT.INTEGER)] if keys2 else []) \
        + [TField("v", TT.BIGINT)]
    jp = JPage(JSchema(tuple(jf)), tuple(jnp.asarray(c) for c in cols),
               tuple(None for _ in cols), jnp.asarray(valid))
    tp = page_from_numpy(TSchema(tuple(tf)), cols, valid=valid)
    return jp, tp, cols, valid


@pytest.mark.parametrize("nb,keys2", [(0, False), (500, False), (3000, True)])
def test_hash_join_build_and_probe(nb, keys2):
    rng = np.random.default_rng(nb + keys2)
    jp, tp, cols, valid = _build_pages(rng, nb, keys2)
    nk = 2 if keys2 else 1
    jtypes = (JT.BIGINT, JT.INTEGER)[:nk]
    ttypes = (TT.BIGINT, TT.INTEGER)[:nk]
    C = max(1 << max(nb - 1, 1).bit_length(), 16) * 4
    jt = jjoin.build_insert(jjoin.build_table_init(C, jp),
                            tuple(jp.columns[:nk]), jtypes, jp.valid_mask())
    tt = tjoin.build_insert(tjoin.build_table_init(C, tp), tuple(tp.columns[:nk]),
                            ttypes, tp.valid_mask())
    assert int(jt.dup_count) == int(tt.dup_count)
    assert bool(jt.overflow) == bool(tt.overflow)
    assert int(jt.n_build_rows) == int(tt.n_build_rows)
    n = 4000
    pool = np.concatenate([cols[0], np.arange(1, 200, dtype=np.int64) * 3 + 1])
    pk = pool[rng.integers(0, len(pool), size=n)]
    pk2 = rng.integers(0, 5, size=n).astype(np.int32)
    pv = rng.random(n) < 0.95
    pkeys = (pk, pk2)[:nk]
    jr, jm = jjoin.probe(jt, tuple(jnp.asarray(k) for k in pkeys), jtypes, jnp.asarray(pv))
    tr, tm = tjoin.probe(tt, tuple(_t(k) for k in pkeys), ttypes, _t(pv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_direct_join_build_and_probe():
    rng = np.random.default_rng(8)
    jp, tp, cols, valid = _build_pages(rng, 800)
    lo = int(cols[0][valid].min())
    span = int(cols[0][valid].max()) - lo + 1
    jd = jjoin.direct_build(lo, span, jp, 0)
    td = tjoin.direct_build(lo, span, tp, 0)
    np.testing.assert_array_equal(td.rows.numpy(), np.asarray(jd.rows))
    np.testing.assert_array_equal(td.occ.numpy(), np.asarray(jd.occ))
    assert int(td.dup_count) == int(jd.dup_count) == 0
    probe = rng.integers(lo - 50, lo + span + 50, size=3000).astype(np.int64)
    pv = rng.random(3000) < 0.9
    jr, jm = jjoin.direct_probe(jd, jnp.asarray(probe), jnp.asarray(pv))
    tr, tm = tjoin.direct_probe(td, _t(probe), _t(pv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_join_table_carried_across():
    """A join table the JAX build produced, carried into the port, probes equal."""
    from trino_tpu_torch.ops.convert import join_table_from_numpy

    rng = np.random.default_rng(9)
    jp, tp, cols, valid = _build_pages(rng, 700)
    jt = jjoin.build_insert(jjoin.build_table_init(4096, jp), (jp.columns[0],),
                            (JT.BIGINT,), jp.valid_mask())
    tt = join_table_from_numpy(np.asarray(jt.table), np.asarray(jt.rows),
                               [np.asarray(c) for c in jt.build_columns], None,
                               jt.n_build_rows, jt.dup_count, jt.overflow)
    probe = cols[0][rng.integers(0, len(cols[0]), size=1000)]
    jr, jm = jjoin.probe(jt, (jnp.asarray(probe),), (JT.BIGINT,), jnp.ones(1000, bool))
    tr, tm = tjoin.probe(tt, (_t(probe),), (TT.BIGINT,), torch.ones(1000, dtype=torch.bool))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# ------------------------------------------------------------------ multi-match joins
def _dup_build_pages(rng, nb, distinct, keys2=False):
    """Build pages whose keys repeat (the multi-match layouts' input)."""
    pool = rng.permutation(np.arange(1, 4 * distinct + 1, dtype=np.int64))[:distinct] * 3
    k = pool[rng.integers(0, distinct, size=nb)] if nb else np.zeros(0, np.int64)
    k2 = rng.integers(0, 3, size=nb).astype(np.int32)
    knull = rng.random(nb) < 0.05
    valid = rng.random(nb) < 0.9
    cols = [k, k2] if keys2 else [k]
    jf = [JField("k", JT.BIGINT)] + ([JField("k2", JT.INTEGER)] if keys2 else [])
    tf = [TField("k", TT.BIGINT)] + ([TField("k2", TT.INTEGER)] if keys2 else [])
    nulls = [knull] + [None] * (len(cols) - 1)
    jp = JPage(JSchema(tuple(jf)), tuple(jnp.asarray(c) for c in cols),
               tuple(None if m is None else jnp.asarray(m) for m in nulls),
               jnp.asarray(valid))
    tp = page_from_numpy(TSchema(tuple(tf)), cols, nulls, valid=valid)
    return jp, tp, cols, pool


def _matched_rows(mt, slot, matched):
    """Per probe row: the set of build rows its slot holds (None: no match)."""
    counts, starts = np.asarray(mt.counts), np.asarray(mt.starts)
    order = np.asarray(mt.order)
    slot, matched = np.asarray(slot), np.asarray(matched)
    return [frozenset(order[starts[s]:starts[s] + counts[s]].tolist()) if m else None
            for s, m in zip(slot, matched)]


def _torch_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_direct_multi_build_and_probe_slots():
    rng = np.random.default_rng(21)
    jp, tp, cols, pool = _dup_build_pages(rng, 3000, 400)
    lo, span = int(pool.min()), int(pool.max() - pool.min()) + 1
    jm = jjoin.direct_multi_build(lo, span, jp, 0)
    tm = tjoin.direct_multi_build(lo, span, tp, 0)
    for name in ("counts", "starts", "order"):  # both sort stably: identical layouts
        np.testing.assert_array_equal(_torch_np(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)), err_msg=name)
    probe = np.concatenate([pool, pool + 1, [lo - 5, lo + span + 5]])
    probe = probe[rng.integers(0, len(probe), size=5000)]
    pv = rng.random(5000) < 0.9
    js, jmat = jjoin.direct_probe_slots(jm, jnp.asarray(probe), jnp.asarray(pv))
    ts, tmat = tjoin.direct_probe_slots(tm, _t(probe), _t(pv))
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert _matched_rows(tm, ts, tmat) == _matched_rows(jm, js, jmat)


@pytest.mark.parametrize("nb,distinct,keys2", [(0, 1, False), (2500, 300, False),
                                               (4000, 900, True)])
def test_multi_build_and_probe_slots(nb, distinct, keys2):
    """Hash layouts differ between the packages; per probe row the matched
    build rows must be the same set."""
    rng = np.random.default_rng(nb + distinct)
    jp, tp, cols, pool = _dup_build_pages(rng, nb, distinct, keys2)
    nk = 2 if keys2 else 1
    jtypes, ttypes = (JT.BIGINT, JT.INTEGER)[:nk], (TT.BIGINT, TT.INTEGER)[:nk]
    C = max(1 << max(nb - 1, 1).bit_length(), 16) * 4
    jm = jjoin.multi_build(C, jp, tuple(range(nk)), jtypes)
    reads = []
    tm = tjoin.multi_build(C, tp, tuple(range(nk)), ttypes,
                           lambda arrays: reads.append(1) or [a.numpy() for a in arrays])
    assert len(reads) == 1 and not bool(tm.overflow) and not bool(jm.overflow)
    np.testing.assert_array_equal(np.sort(_torch_np(tm.counts)), np.sort(np.asarray(jm.counts)))
    n = 4000
    pk = np.concatenate([pool, pool + 1])[rng.integers(0, 2 * len(pool), size=n)]
    pk2 = rng.integers(0, 3, size=n).astype(np.int32)
    pv = rng.random(n) < 0.95
    pkeys = (pk, pk2)[:nk]
    js, jmat = jjoin.probe_slots(jm.table, tuple(jnp.asarray(k) for k in pkeys), jtypes,
                                 jnp.asarray(pv))
    ts, tmat = tjoin.probe_slots(tm.table, tuple(_t(k) for k in pkeys), ttypes, _t(pv))
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    assert _matched_rows(tm, ts, tmat) == _matched_rows(jm, js, jmat)


def test_multi_build_grows_past_a_full_table():
    """A capacity below the distinct key count overflows and grows by 4x."""
    rng = np.random.default_rng(23)
    jp, tp, cols, pool = _dup_build_pages(rng, 600, 200)
    jm = jjoin.multi_build(16, jp, (0,), (JT.BIGINT,))
    reads = []
    tm = tjoin.multi_build(16, tp, (0,), (TT.BIGINT,),
                           lambda arrays: reads.append(1) or [a.numpy() for a in arrays])
    assert len(reads) > 1 and tm.capacity == jm.capacity
    probe = pool[rng.integers(0, len(pool), size=1000)]
    ones = np.ones(1000, bool)
    js, jmat = jjoin.probe_slots(jm.table, (jnp.asarray(probe),), (JT.BIGINT,),
                                 jnp.asarray(ones))
    ts, tmat = tjoin.probe_slots(tm.table, (_t(probe),), (TT.BIGINT,), _t(ones))
    assert _matched_rows(tm, ts, tmat) == _matched_rows(jm, js, jmat)


@pytest.mark.parametrize("n,size", [(1, 1024), (700, 1024), (3000, 8192)])
def test_expand_counts(n, size):
    rng = np.random.default_rng(n)
    out_counts = rng.integers(0, 4, size=n).astype(np.int32)
    incl = np.cumsum(out_counts, dtype=np.int32)
    size = max(size, int(incl[-1]))
    jp, jk, jr = jjoin.expand_counts(jnp.asarray(incl), jnp.asarray(out_counts), size)
    tp, tk, tr = tjoin.expand_counts(_t(incl), _t(out_counts), size)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


# ------------------------------------------------------- in-place inserts in the executor
GROWTH_SQL = """
    select l_partkey, count(*) as c, sum(l_quantity) as q, min(l_shipdate) as d,
           max(l_extendedprice) as p
    from lineitem group by l_partkey order by l_partkey"""


def _same_result(ref, got):
    assert tuple(ref.names) == tuple(got.names) and len(ref) == len(got) > 0
    for t, a, b in zip(ref.types, ref.raw_columns, got.raw_columns):
        if t.is_floating:
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-9)
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_groupby_replays_an_overflowing_chunk_from_its_snapshot(engine, monkeypatch):
    """The port alone starts its hash group-by at 16 slots (no direct mode,
    no estimate), so its first chunk of pages overflows and replays from the
    per-chunk snapshot after each 4x rehash; groups and aggregates equal
    trino_tpu's ordinary run.  The table is copied at most once per chunk."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec import local_executor as le

    monkeypatch.setattr(le, "DEFAULT_GROUP_CAPACITY", 16)
    monkeypatch.setattr(le.LocalExecutor, "_agg_capacity_estimate", lambda *a: None)
    monkeypatch.setattr(tagg, "direct_config", lambda *a, **k: None)
    grown, clones = [], [0]
    rehash = tagg.rehash
    monkeypatch.setattr(tagg, "rehash",
                        lambda state, cap, kinds=(): grown.append(cap) or rehash(state, cap, kinds))
    clone = torch.Tensor.clone
    monkeypatch.setattr(torch.Tensor, "clone",
                        lambda self, *a, **k: clones.__setitem__(0, clones[0] + 1)
                        or clone(self, *a, **k))
    conn = TpchConnector(sf=0.01, split_rows=4096)
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    got = e.execute_sql(GROWTH_SQL, e.create_session("tpch"))
    monkeypatch.undo()
    ref = engine.execute_sql(GROWTH_SQL, engine.create_session("tpch"))
    _same_result(ref, got)
    assert grown[:3] == [64, 256, 1024]  # the first chunk replayed, 4x each time
    chunks = -(-len(conn.splits("lineitem")) // 4)
    assert chunks > 1 and clones[0] <= chunks


JOIN_BUILD_SQL = {
    "unique_hashed_build": """
        select ps_partkey, sum(l_quantity) as q from lineitem, partsupp
        where ps_partkey = l_partkey and ps_suppkey = l_suppkey and ps_availqty < 2000
        group by ps_partkey order by ps_partkey""",
    "multi_match_hashed_build": """
        select p1.p_partkey, count(*) as c from part p1, part p2
        where p1.p_size = p2.p_size and p1.p_brand = p2.p_brand and p2.p_partkey < 400
        group by p1.p_partkey order by p1.p_partkey""",
}


@pytest.mark.parametrize("name", sorted(JOIN_BUILD_SQL))
def test_join_builds_insert_in_place_without_copying_a_table(engine, monkeypatch, name):
    """Join builds hand hash_insert_ a table made for that build alone:
    every table it gets is still all EMPTY, nothing is cloned while a build
    runs, and the functional insert is never called."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec import local_executor as le
    from trino_tpu_torch.ops import cuda_kernels as ck

    seen = {"depth": 0, "clones": 0, "inserts": 0, "fresh": 0}

    def scoped(fn):
        def inner(*a, **k):
            seen["depth"] += 1
            try:
                return fn(*a, **k)
            finally:
                seen["depth"] -= 1
        return inner

    monkeypatch.setattr(le.LocalExecutor, "_build_join_table",
                        scoped(le.LocalExecutor._build_join_table))
    monkeypatch.setattr(le, "multi_build", scoped(le.multi_build))
    clone = torch.Tensor.clone

    def counted_clone(self, *a, **k):
        seen["clones"] += seen["depth"] > 0
        return clone(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "clone", counted_clone)
    insert_ = ck.hash_insert_

    def watched(table, *a, **k):
        if seen["depth"]:
            seen["inserts"] += 1
            seen["fresh"] += bool((table == EMPTY).all())
        return insert_(table, *a, **k)

    monkeypatch.setattr(ck, "hash_insert_", watched)
    monkeypatch.setattr(ck, "hash_insert",
                        lambda *a, **k: pytest.fail("a functional insert on the main path"))
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(sf=0.01))
    got = e.execute_sql(JOIN_BUILD_SQL[name], e.create_session("tpch"))
    monkeypatch.undo()
    assert seen["inserts"] > 0 and seen["fresh"] == seen["inserts"]
    assert seen["clones"] == 0
    _same_result(engine.execute_sql(JOIN_BUILD_SQL[name], engine.create_session("tpch")), got)


def test_page_column_by_name():
    """``Page.column(name)`` (ROADMAP C4): the column the schema names, as
    the reference's ``Page.column``."""
    rng = np.random.default_rng(4)
    jp, tp, cols, _ = _build_pages(rng, 50, keys2=True)
    for name in ("k", "k2", "v"):
        np.testing.assert_array_equal(tp.column(name).numpy(), np.asarray(jp.column(name)))
    with pytest.raises(KeyError):
        tp.column("missing")
