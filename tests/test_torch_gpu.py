"""Tests of the port that need a CUDA card: each kernel against its plain
version on the card; TPC-H, multi-match joins, global aggregates and the
TPC-DS corpus on the card against the same SQL on the CPU; the window
primitives and the window kernel on the card against their CPU runs; the
streaming LIMIT compacting through the CUDA kernel; the sort-based
aggregation runner, the function corpora and the exact wide sums; and the
array, map, UNNEST and MATCH_RECOGNIZE corpora, UNNEST's expansion map and
the vectorized matcher; the coordinator server over a card engine.

They skip without a card.  This file imports no jax, so on a machine with a
card (which has no jax) it runs without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import cuda_kernels as ck
from trino_tpu_torch.ops.hashing import EMPTY_KEY

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _keys(rng, n, distinct):
    pool = np.unique(rng.integers(1, 1 << 40, size=2 * distinct + 8, dtype=np.int64))
    pool = rng.permutation(pool)[:distinct]
    return pool[rng.integers(0, len(pool), size=n)]


@pytest.mark.parametrize("n,C,distinct", [(3000, 4096, 1500), (1, 2, 1), (5000, 1024, 60)])
def test_hash_insert_kernel_observables(dev, n, C, distinct):
    rng = np.random.default_rng(n)
    packed = torch.as_tensor(_keys(rng, n, distinct), device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    table0 = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=dev)
    tk, sk, pk = ck.hash_insert(table0, packed, valid)
    tp, sp, pp = ck.hash_insert_plain(table0, packed, valid)
    assert torch.equal(pk, pp)
    assert int(tk[C]) == EMPTY_KEY and bool((sk[~valid] == C).all())
    live = valid & pk
    assert bool((tk[sk.long()[live]] == packed[live]).all())
    wk, wp = tk[:C][tk[:C] != EMPTY_KEY], tp[:C][tp[:C] != EMPTY_KEY]
    assert torch.equal(torch.unique(wk), torch.unique(wp))
    assert int(table0[0]) == EMPTY_KEY  # the input table is untouched


PROBE_CASES = {
    # name: (build keys, C, probe rows, the insert that builds the table)
    "hits_and_misses": (1000, 4096, 5000, "plain"),
    # no EMPTY slot: a missing key's chain runs to max_probes
    "full_table_runs_to_max_probes": (256, 256, 600, "plain"),
    "empty_table": (0, 64, 10, "plain"),
    # the CUDA insert lays the chains down: both kernels hash alike
    "kernel_built_table": (30000, 65536, 100003, "kernel"),
    "kernel_built_large_ragged": (300000, 1 << 20, (1 << 20) + 77, "kernel"),
}


@pytest.mark.parametrize("mode", ["payload", "slots"])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_hash_probe_kernel_bit_identical(dev, case, mode):
    """The kernel (hashing in registers) equals the plain version bit for
    bit, with a payload array and in slot mode (vals=None): hits, misses,
    invalid rows, chains that run to max_probes, n not a multiple of the
    block, and tables built by the plain or the CUDA insert."""
    nb, C, n, built_by = PROBE_CASES[case]
    rng = np.random.default_rng(nb + n)
    table = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=dev)
    if nb:
        bkeys = torch.as_tensor(np.unique(_keys(rng, nb, nb)), device=dev)
        ones = torch.ones_like(bkeys, dtype=torch.bool)
        if built_by == "kernel":
            _, placed = ck.hash_insert_(table, bkeys, ones)
            assert bool(placed.all())
        else:
            table, _, _ = ck.hash_insert_plain(table, bkeys, ones)
        pool = torch.cat([bkeys, bkeys + (1 << 41)])
    else:
        pool = torch.arange(1, 100, device=dev)
    packed = pool[torch.as_tensor(rng.integers(0, len(pool), size=n), device=dev)]
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    vals = (torch.as_tensor(rng.integers(0, 2**31 - 1, size=C, dtype=np.int32), device=dev)
            if mode == "payload" else None)
    before = ck.STATS["hash_probe"].launches
    a = ck.hash_probe(table[:C], vals, packed, valid)
    b = ck.hash_probe_plain(table[:C], vals, packed, valid)
    assert ck.STATS["hash_probe"].launches == before + 1
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.bool
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool((a[0][~a[1]] == 0).all()) and not bool(a[1][~valid].any())
    if nb:
        assert bool(a[1].any()) and not bool(a[1].all())


@pytest.mark.parametrize("n,out_len,frac", [(5000, 2000, 0.3), (3000, 100, 0.5),
                                            (1, 1, 1.0), (4097, 4097, 0.0)])
def test_compact_rows_kernel_byte_identical(dev, n, out_len, frac):
    rng = np.random.default_rng(n + out_len)
    cols = (torch.as_tensor(rng.random(n) < 0.5, device=dev),
            torch.as_tensor(rng.integers(-9, 9, size=n).astype(np.int16), device=dev),
            torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev),
            torch.as_tensor(rng.integers(-2**62, 2**62, size=n), device=dev),
            None)
    valid = torch.as_tensor(rng.random(n) < frac, device=dev)
    a, at = ck.compact_rows(cols, valid, out_len)
    b, bt = ck.compact_rows_plain(cols, valid, out_len)
    assert int(at) == int(bt) and a[-1] is None
    for x, y in zip(a[:-1], b[:-1]):
        assert x.dtype == y.dtype and torch.equal(x, y)


TILE = 4096  # rows per tile of csrc/compact_rows.cu
_WIDTH_DTYPES = (torch.bool, torch.int8, torch.int16, torch.float16, torch.int32,
                 torch.float32, torch.int64, torch.float64)
COMPACT_EDGES = {
    # name: (n, out_len, live fraction, columns)
    "tile_minus_one": (TILE - 1, TILE - 1, 0.5, 8),
    "one_tile": (TILE, TILE, 0.5, 8),
    "tile_plus_one": (TILE + 1, TILE + 1, 0.5, 8),
    "many_tiles": ((1 << 22) + 13, (1 << 22) + 13, 0.3, 8),
    "all_dead": (3 * TILE + 5, 1024, 0.0, 8),
    "all_live": (3 * TILE + 5, 3 * TILE + 5, 1.0, 8),
    "drops_past_out_len": (5 * TILE + 7, 3000, 0.6, 8),
    "seventeen_columns": (2 * TILE + 99, 2 * TILE + 99, 0.5, 17),
    "thirty_three_columns": (TILE + 1, 1000, 0.7, 33),
    "empty_input": (0, 64, 0.5, 8),
    "empty_output": (TILE + 3, 0, 0.5, 8),
}


def _compact_columns(rng, n, k, dev):
    cols = []
    for j in range(k):
        dt = _WIDTH_DTYPES[j % len(_WIDTH_DTYPES)]
        raw = rng.integers(0, 256, size=n * torch.empty((), dtype=dt).element_size(),
                           dtype=np.uint8)
        if dt == torch.bool:
            cols.append(torch.as_tensor(raw % 2 == 1, device=dev))
        else:
            cols.append(torch.as_tensor(raw, device=dev).view(dt) if n
                        else torch.empty((0,), dtype=dt, device=dev))
    return tuple(cols)


def _same_bytes(x, y):
    return x.dtype == y.dtype and torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("case", sorted(COMPACT_EDGES))
def test_compact_rows_kernel_tile_edges(dev, case):
    """Byte-identical to the plain version at tile edges, over many tiles,
    all-dead and all-live masks, drops past out_len, more than one column
    chunk, and every width (outputs arrive from torch.empty)."""
    n, out_len, frac, k = COMPACT_EDGES[case]
    rng = np.random.default_rng(n + k)
    cols = _compact_columns(rng, n, k, dev)
    valid = torch.as_tensor(rng.random(n) < frac, device=dev)
    for junk in range(2):  # reuse allocator blocks full of garbage
        torch.full((out_len * 8 * k + 64,), 0x5A, dtype=torch.uint8, device=dev)
        before = ck.STATS["compact_rows"].launches
        a, at = ck.compact_rows(cols, valid, out_len)
        b, bt = ck.compact_rows_plain(cols, valid, out_len)
        assert ck.STATS["compact_rows"].launches == before + 1
        assert int(at) == int(bt) == int(valid.sum())
        for x, y in zip(a, b):
            assert _same_bytes(x, y)


def test_compact_rows_kernel_unaligned_inputs(dev):
    """A mask and columns that start off a 16-byte boundary (slices)."""
    rng = np.random.default_rng(5)
    n = 3 * TILE + 17
    cols = tuple(c[3:] for c in _compact_columns(rng, n + 3, 8, dev))
    valid = torch.as_tensor(rng.random(n + 1) < 0.5, device=dev)[1:]
    a, at = ck.compact_rows(cols, valid, n - 5)
    b, bt = ck.compact_rows_plain(cols, valid, n - 5)
    assert int(at) == int(bt)
    for x, y in zip(a, b):
        assert _same_bytes(x, y)


def _adjacent_duplicates(rng, n, distinct):
    """Keys in runs of 1-7 equal rows, as lineitem rows of one order arrive."""
    pool = np.unique(rng.integers(1, 1 << 40, size=2 * distinct + 8, dtype=np.int64))
    runs = rng.integers(1, 8, size=n)
    keys = np.repeat(rng.permutation(pool)[:distinct][rng.integers(0, distinct, size=n)],
                     runs)[:n]
    return keys


@pytest.mark.parametrize("n,C,distinct,prefill", [(20000, 16384, 3000, 0),
                                                   (70000, 65536, 20000, 5000),
                                                   (4096, 1024, 900, 100)])
def test_hash_insert_in_place_adjacent_duplicates(dev, n, C, distinct, prefill):
    """hash_insert_ writes the caller's table; its observables equal the
    plain version's on runs of equal keys, and every word outside the slots
    it claimed is unchanged (a prefilled part of the table included)."""
    rng = np.random.default_rng(n + prefill)
    table = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=dev)
    if prefill:
        pre = torch.as_tensor(_keys(rng, prefill, prefill), device=dev)
        ck.hash_insert_plain_(table, pre, torch.ones_like(pre, dtype=torch.bool))
    packed = torch.as_tensor(_adjacent_duplicates(rng, n, distinct), device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    before = table.clone()
    ref = table.clone()
    sk, pk = ck.hash_insert_(table, packed, valid)
    sp, pp = ck.hash_insert_plain_(ref, packed, valid)
    assert torch.equal(pk, pp) and bool(pk[valid].all())
    assert bool((sk[~valid] == C).all()) and int(table[C]) == EMPTY_KEY
    live = valid & pk
    assert bool((table[sk.long()[live]] == packed[live]).all())
    changed = torch.nonzero(table != before).flatten()
    assert bool(torch.isin(changed, sk.long()[live]).all())
    assert bool((before[changed] == EMPTY_KEY).all())
    wk, wp = table[:C][table[:C] != EMPTY_KEY], ref[:C][ref[:C] != EMPTY_KEY]
    assert torch.equal(torch.unique(wk), torch.unique(wp))
    # equal keys got one slot
    order = torch.argsort(packed[live])
    ks, ss = packed[live][order], sk[live][order]
    same = ks[1:] == ks[:-1]
    assert bool((ss[1:][same] == ss[:-1][same]).all())


def test_hash_insert_in_place_exhausts_max_probes(dev):
    """More distinct keys than slots: the table fills, the rest exhaust their
    64 rounds unplaced (slot C), and unplaced keys are absent."""
    rng = np.random.default_rng(12)
    C, n = 64, 4000
    packed = torch.as_tensor(_adjacent_duplicates(rng, n, 300), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    table = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=dev)
    ref = table.clone()
    sk, pk = ck.hash_insert_(table, packed, valid)
    sp, pp = ck.hash_insert_plain_(ref, packed, valid)
    assert not bool(pk.all()) and not bool(pp.all())
    assert int((table[:C] != EMPTY_KEY).sum()) == int((ref[:C] != EMPTY_KEY).sum()) == C
    assert int(table[C]) == EMPTY_KEY and bool((sk[~pk] == C).all())
    assert not bool(torch.isin(packed[~pk], table[:C]).any())
    assert bool((table[sk.long()[pk]] == packed[pk]).all())


@pytest.mark.parametrize("n,n_slots,k", [(10000, 8, 2), (3000, 4, 0), (2049 + 777, 16, 3),
                                         (5000, 128, 3), (70000, 128, 40), (1, 1, 1)])
def test_fused_segment_agg_kernel_vs_plain(dev, n, n_slots, k):
    """Counts exactly; float32 sums of both versions within rtol 1e-4 of a
    float64 sum of the same inputs (atomics add in a run-dependent order).
    k=40 runs as two launches over column chunks."""
    rng = np.random.default_rng(n + k)
    slot = torch.as_tensor(rng.integers(-1, n_slots + 1, n).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.8, device=dev)
    vals = tuple(torch.as_tensor(rng.random(n).astype(np.float32) * 10 ** (j % 4),
                                 device=dev) for j in range(k))
    before = ck.STATS["fused_segment_agg"].launches
    kc, ks = ck.fused_segment_agg(slot, valid, vals, n_slots)
    pc, ps = ck.fused_segment_agg_plain(slot, valid, vals, n_slots)
    assert ck.STATS["fused_segment_agg"].launches == before + 1
    assert torch.equal(kc, pc) and len(ks) == len(ps) == k
    live = valid & (slot >= 0) & (slot < n_slots)
    for v, a, b in zip(vals, ks, ps):
        want = torch.zeros(n_slots, dtype=torch.float64, device=dev).index_add_(
            0, slot[live].long(), v[live].double())
        for got in (a, b):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-4, atol=1e-6)


SEGMENT_LAYOUTS = {
    # name: (offset of slot and valid, offset of the value columns), in rows
    "aligned": (0, 0),
    "all_at_offset_1": (1, 1),      # the vector path after a 3-row scalar head
    "columns_at_offset_1": (0, 1),  # offsets disagree: scalar throughout
}


@pytest.mark.parametrize("layout", sorted(SEGMENT_LAYOUTS))
@pytest.mark.parametrize("k", [0, 1, 4, 8, 33])
@pytest.mark.parametrize("n_slots", [1, 8, 33, 128])
def test_fused_segment_agg_kernel_tiers(dev, n_slots, k, layout):
    """Both tiers (registers when max(8, pow2(n_slots)) * (k + 1) <= 64,
    per-warp shared copies otherwise; 33 columns as two chunks) against a
    float64 sum: counts exactly, sums within rtol 1e-4 (float32 adds in a
    run-dependent order); n not a multiple of 4, inputs sliced at an odd
    row."""
    n = 40009
    rng = np.random.default_rng(n_slots * 100 + k)
    lead, col_lead = SEGMENT_LAYOUTS[layout]
    slot = torch.as_tensor(rng.integers(-1, n_slots + 1, n + lead).astype(np.int32),
                           device=dev)[lead:]
    valid = torch.as_tensor(rng.random(n + lead) < 0.8, device=dev)[lead:]
    vals = tuple(torch.as_tensor(rng.random(n + col_lead).astype(np.float32) * 10 ** (j % 4),
                                 device=dev)[col_lead:] for j in range(k))
    before = ck.STATS["fused_segment_agg"].launches
    kc, ks = ck.fused_segment_agg(slot, valid, vals, n_slots)
    assert ck.STATS["fused_segment_agg"].launches == before + 1
    live = valid & (slot >= 0) & (slot < n_slots)
    want_c = torch.bincount(slot[live].long(), minlength=n_slots)
    assert kc.dtype == torch.int32 and torch.equal(kc.long(), want_c)
    assert len(ks) == k
    for v, got in zip(vals, ks):
        want = torch.zeros(n_slots, dtype=torch.float64, device=dev).index_add_(
            0, slot[live].long(), v[live].double())
        assert got.dtype == torch.float32 and got.shape == (n_slots,)
        np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_fused_segment_agg_kernel_takes_an_int64_slot_as_int32(dev):
    """The kernel and the plain version both wrap an int64 slot to int32
    before the range test, as the reference does."""
    rng = np.random.default_rng(3)
    n = 9999
    slot = rng.integers(0, 8, n).astype(np.int64)
    slot[::5] += 1 << 32
    slot[1::7] = (1 << 31) + 2
    slot = torch.as_tensor(slot, device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    vals = (torch.as_tensor(rng.random(n).astype(np.float32), device=dev),)
    kc, ks = ck.fused_segment_agg(slot, valid, vals, 8)
    pc, ps = ck.fused_segment_agg_plain(slot, valid, vals, 8)
    assert torch.equal(kc, pc)
    np.testing.assert_allclose(ks[0].cpu().numpy(), ps[0].cpu().numpy(), rtol=1e-5)


def _same(a, b):
    assert tuple(a.names) == tuple(b.names) and len(a) == len(b)
    for t, x, y in zip(a.types, a.raw_columns, b.raw_columns):
        if t.is_floating:
            np.testing.assert_allclose(x, y, rtol=1e-9)
        else:
            np.testing.assert_array_equal(x, y)


def _card_and_cpu(queries, sf=0.01):
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    results = {}
    for device in ("cuda", "cpu"):
        e = Engine(device=device)
        e.register_catalog("tpch", TpchConnector(sf=sf))
        if "q15" in queries:
            from chip_smoke import Q15_VIEW

            e.execute_sql(Q15_VIEW, e.create_session("tpch"))
        results[device] = {q: e.execute_sql(sql, e.create_session("tpch"))
                           for q, sql in queries.items()}
    return results


def test_tpch_on_the_card_equals_the_cpu(dev):
    from chip_smoke import ALL_QUERIES

    ck.reset_stats()
    results = _card_and_cpu(ALL_QUERIES)
    assert all(s.launches > 0 for k, s in ck.STATS.items() if k != "fused_segment_agg")
    for q in ALL_QUERIES:
        a, b = results["cuda"][q], results["cpu"][q]
        assert len(a) > 0 or q == "q18"  # bench.py's Q18 is empty at SF0.01
        _same(a, b)


MULTI_AND_GLOBAL = {
    # duplicate build keys over two key columns: multi_build + probe_slots
    "hashed_multi_match": """
        select p1.p_partkey, count(*) as c from part p1, part p2
        where p1.p_size = p2.p_size and p1.p_brand = p2.p_brand and p2.p_partkey < 400
        group by p1.p_partkey order by p1.p_partkey""",
    # a residual filter on a left join: direct multi-match layout, expansion
    "left_multi_residual": """
        select c_custkey, count(o_orderkey) as c from customer left outer join orders
            on c_custkey = o_custkey and o_totalprice > c_acctbal * 20
        group by c_custkey order by c_custkey""",
    "global_aggregate": """
        select count(*) as n, sum(l_quantity) as q, min(l_shipdate) as lo,
               max(l_extendedprice) as hi, avg(l_discount) as d
        from lineitem where l_shipdate >= date '1995-01-01'""",
}


@pytest.mark.parametrize("name", sorted(MULTI_AND_GLOBAL))
def test_multi_match_and_global_aggregate_card_vs_cpu(dev, name):
    ck.reset_stats()
    results = _card_and_cpu({name: MULTI_AND_GLOBAL[name]})
    if name == "hashed_multi_match":  # the multi-match build and probe launch
        assert ck.STATS["hash_insert"].launches > 0
        assert ck.STATS["hash_probe"].launches > 0
    assert len(results["cuda"][name]) > 0
    _same(results["cuda"][name], results["cpu"][name])


# -- windows, streaming LIMIT and TPC-DS --------------------------------------------------


def _window_page(rng, n, device):
    """Partition int32 (NULLs), order int64 (ties, NULLs), decimal raw int64
    (NULLs), DOUBLE, int64, order int32; valid with pad rows."""
    cols = [rng.integers(0, 7, n).astype(np.int32), rng.integers(0, 15, n),
            rng.integers(-10**6, 10**6, n), np.round(rng.normal(size=n) * 50, 3),
            rng.integers(-50, 50, n), rng.integers(0, 40, n).astype(np.int32)]
    nulls = [rng.random(n) < 0.1, rng.random(n) < 0.15, rng.random(n) < 0.2,
             None, None, None]
    valid = rng.random(n) < 0.85
    return (tuple(torch.as_tensor(c, device=device) for c in cols),
            tuple(None if m is None else torch.as_tensor(m, device=device) for m in nulls),
            torch.as_tensor(valid, device=device))


def _window_specs():
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql import plan as P

    D = T.DecimalType.of(12, 2)
    asc, dnf, k5 = P.SortKey(1), P.SortKey(1, False, True), P.SortKey(5)

    def spec(kind, arg, typ, order=(asc,), part=(0,), **kw):
        return P.WindowSpec(kind, arg, part, order, kind, typ, **kw)

    return [spec("row_number", None, T.BIGINT), spec("rank", None, T.BIGINT, order=(dnf,)),
            spec("dense_rank", None, T.BIGINT), spec("count_star", None, T.BIGINT),
            spec("count", 2, T.BIGINT, order=()), spec("sum", 2, D),
            spec("sum", 3, T.DOUBLE, order=()), spec("avg", 2, D),
            spec("avg", 3, T.DOUBLE), spec("min", 2, D), spec("max", 4, T.BIGINT, order=()),
            spec("lag", 2, D), spec("lag", 4, T.BIGINT, offset=2, default=-1),
            spec("lead", 2, D, ignore_nulls=True), spec("lead", 4, T.BIGINT, offset=3),
            spec("percent_rank", None, T.DOUBLE), spec("cume_dist", None, T.DOUBLE),
            spec("ntile", None, T.BIGINT, offset=3), spec("nth_value", 4, T.BIGINT, offset=2),
            spec("first_value", 2, D, ignore_nulls=True), spec("last_value", 4, T.BIGINT),
            spec("sum", 2, D, order=(k5,), frame=("rows", "p", 2, "cr", 0)),
            spec("min", 4, T.BIGINT, order=(k5,), frame=("rows", "f", 1, "f", 2)),
            spec("max", 2, D, order=(k5,), frame=("rows", "up", 0, "uf", 0)),
            spec("sum", 4, T.BIGINT, order=(k5,), frame=("range", "p", 10, "cr", 0)),
            spec("count", 2, T.BIGINT, order=(asc,), frame=("range", "p", 5, "f", 5)),
            spec("min", 3, T.DOUBLE, order=(dnf,), frame=("range", "p", 3, "f", 2))]


def _close(a, b, what):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.is_floating_point():
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=0, err_msg=what)
    else:
        assert torch.equal(a, b), what


@pytest.mark.parametrize("n", [1, 1000, 300001])
def test_window_kernel_on_the_card_equals_the_cpu(dev, n):
    from trino_tpu_torch.exec.local_executor import _window_kernel

    rng = np.random.default_rng(n)
    page = _window_page(rng, n, dev)
    specs = _window_specs()
    gc, gn = _window_kernel(specs, *page)
    cc, cn = _window_kernel(specs, *(tuple(None if x is None else x.cpu() for x in part)
                                     if isinstance(part, tuple) else part.cpu()
                                     for part in page))
    live = page[2].cpu()
    for i, s in enumerate(specs):
        what = f"{s.kind} {s.frame}"
        assert (gn[i] is None) == (cn[i] is None), what
        null = torch.zeros(n, dtype=torch.bool) if cn[i] is None else cn[i]
        if gn[i] is not None:
            _close(gn[i][page[2]], cn[i][live], what + " nulls")
        keep = live & ~null
        _close(gc[i].cpu()[keep], cc[i][keep], what)


def test_window_primitives_on_the_card_equal_the_cpu(dev):
    from trino_tpu_torch.ops import window as W

    rng = np.random.default_rng(9)
    n = 100003
    part = np.sort(rng.integers(0, 500, n))
    key = rng.integers(0, 30, n)
    order = np.lexsort((key, part))
    part, key = part[order], key[order]
    part_new = np.r_[True, part[1:] != part[:-1]]
    peer_new = part_new | np.r_[True, key[1:] != key[:-1]]
    vals = rng.integers(-10**9, 10**9, n)
    dbl = rng.normal(size=n)
    nonnull = rng.random(n) < 0.7

    def conv(a, device):
        if isinstance(a, list):
            return [conv(x, device) for x in a]
        return torch.as_tensor(a, device=device) if isinstance(a, np.ndarray) else a

    def both(fn, *args, **kw):
        return (fn(*(conv(a, dev) for a in args), **kw),
                fn(*(conv(a, "cpu") for a in args), **kw))

    keys = [part.astype(np.int32), rng.random(n) < 0.5, dbl, key]
    _close(*both(W.window_order, keys, [False, True, True, False]), "window_order")
    for fn, args in ((W.row_number, (part_new,)), (W.rank, (part_new, peer_new)),
                     (W.dense_rank, (part_new, peer_new)),
                     (W.segmented_scan_sum, (vals, part_new, peer_new)),
                     (W.segmented_scan_sum, (dbl, part_new, peer_new)),
                     (W.partition_total, (vals, part_new)),
                     (W.segmented_scan_minmax, (dbl, part_new, peer_new, "min")),
                     (W.segmented_scan_minmax, (vals, part_new, part_new, "max")),
                     (W.shift_in_partition, (vals, part_new, 2, -1)),
                     (W.shift_ignore_nulls, (vals, nonnull, part_new, -3, 0))):
        g, c = both(fn, *args)
        for x, y in zip(g if isinstance(g, tuple) else (g,), c if isinstance(c, tuple) else (c,)):
            _close(x, y, fn.__name__)
    for frame in (("rows", "p", 2, "cr", 0), ("rows", "f", 3, "f", 4),
                  ("range", "p", 10, "cr", 0), ("range", "p", 5, "f", 5)):
        (glo, ghi), (clo, chi) = both(W.frame_bounds, part_new, peer_new, frame, key)
        _close(glo, clo, f"lo {frame}")
        _close(ghi, chi, f"hi {frame}")
        lo, hi = clo.numpy(), chi.numpy()
        _close(*both(W.framed_sum, dbl, lo, hi), f"framed_sum {frame}")
        live = torch.as_tensor(hi >= lo)
        g, c = both(W.framed_minmax, vals, lo, hi, "max")
        _close(g.cpu()[live], c[live], f"framed_minmax {frame}")
        for x, y in zip(*both(W.framed_nth_nonnull, vals, nonnull, lo, hi, 2)):
            _close(x, y, f"framed_nth_nonnull {frame}")


def test_streaming_limit_compacts_through_the_kernel(dev):
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    sql = ("select l_orderkey, l_quantity, l_shipdate from lineitem "
           "where l_quantity < 5 limit 3000")
    got = {}
    for device in ("cuda", "cpu"):
        e = Engine(device=device)
        e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 13))
        ck.reset_stats()
        got[device] = e.execute_sql(sql, e.create_session("tpch"))
        if device == "cuda":
            assert ck.STATS["compact_rows"].launches > 0
    assert len(got["cuda"]) == 3000
    _same(got["cuda"], got["cpu"])


def test_tpcds_corpus_on_the_card_equals_the_cpu(dev):
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.connectors.tpcds_queries import corpus

    engines = {}
    for device in ("cuda", "cpu"):
        engines[device] = Engine(device=device)
        engines[device].register_catalog("tpcds", TpcdsConnector(sf=0.01,
                                                                 split_rows=1 << 14))
    ck.reset_stats()
    for q, sql in corpus().items():
        a, b = (engines[d].execute_sql(sql, engines[d].create_session("tpcds"))
                for d in ("cuda", "cpu"))
        _same(a, b)
    assert sum(s.launches for s in ck.STATS.values()) > 0


def _memory_table(device, rng, n=70001, k=20):
    """A memory table of ``k`` columns (bigint, double, decimal, date,
    varchar, boolean in turn; every third one with NULLs) on ``device``,
    filled with the same seeded rows."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.page import Schema
    from trino_tpu_torch.types import BIGINT, BOOLEAN, DATE, DOUBLE, DecimalType, VarcharType

    kinds = [BIGINT, DOUBLE, DecimalType.of(12, 2), DATE, VarcharType.of(None), BOOLEAN]
    types = [kinds[i % len(kinds)] for i in range(k)]
    conn = MemoryConnector(device=device)
    conn.create_table("w", Schema.of(*[(f"c{i}", t) for i, t in enumerate(types)]))
    cols = []
    for i, t in enumerate(types):
        if t.is_string:
            vals = [f"s{v}" for v in rng.integers(0, 500, n)]
        elif t.is_floating:
            vals = rng.normal(size=n).tolist()
        elif t == BOOLEAN:
            vals = (rng.random(n) < 0.5).tolist()
        else:
            vals = rng.integers(-10**6, 10**6, n).tolist()
        if i % 3 == 0:
            vals = [None if m else v for v, m in zip(vals, rng.random(n) < 0.1)]
        cols.append(vals)
    conn.append("w", cols)
    return conn


def _same_tables(a, b, table):
    assert a.row_count(table) == b.row_count(table)
    for sa, sb in zip(a.splits(table), b.splits(table)):
        pa, pb = a.generate(sa), b.generate(sb)
        for x, y, nx, ny in zip(pa.columns, pb.columns, pa.null_masks, pb.null_masks):
            assert x.device.type == "cuda" and y.device.type == "cpu"
            assert _same_bytes(x.cpu(), y)
            assert (nx is None) == (ny is None)
            if nx is not None:
                assert torch.equal(nx.cpu(), ny)


def test_memory_delete_compacts_through_the_kernel_once_per_16_arrays(dev):
    conns = {d: _memory_table(d, np.random.default_rng(3)) for d in ("cuda", "cpu")}
    arrays = 20 + sum(m is not None for m in conns["cuda"]._tables["w"].nulls)
    rng = np.random.default_rng(4)
    for frac in (0.001, 0.5, 0.999):
        mask = rng.random(conns["cpu"].row_count("w")) < frac
        before = ck.STATS["compact_rows"].launches
        n = conns["cuda"].delete_rows("w", mask)
        assert ck.STATS["compact_rows"].launches - before == -(-arrays // 16) == 2
        assert n == conns["cpu"].delete_rows("w", mask) == int(mask.sum())
        _same_tables(conns["cuda"], conns["cpu"], "w")


def _both_engines(sf=None):
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector

    out = {}
    for device in ("cuda", "cpu"):
        e = Engine(device=device)
        if sf is not None:
            e.register_catalog("tpch", TpchConnector(sf=sf))
        e.register_catalog("memory", MemoryConnector())
        out[device] = (e, e.create_session("memory"))
    return out


def _run_on_both(engines, sql):
    got = {d: e.execute_sql(sql, s) for d, (e, s) in engines.items()}
    if got["cpu"] is None:
        assert got["cuda"] is None, sql
    else:
        _same(got["cuda"], got["cpu"])
    return got["cuda"]


UPDATE_AND_MERGE = [
    "create table tgt (id bigint, name varchar, qty bigint, price decimal(10,2))",
    "insert into tgt values (1, 'a', 10, 1.50), (2, 'b', 20, 2.50), (3, 'c', 30, null), "
    "(null, 'n', 0, 0.00)",
    "create table src (id bigint, name varchar, qty bigint)",
    "insert into src values (2, 'B', 200), (3, 'c', -1), (4, 'd', 40), (null, 'N', 99)",
    "update tgt set price = price * 2 + 0.01, name = 'zz' where qty >= 20",
    "update tgt set name = null where id = 1",
    """merge into tgt t using src s on t.id = s.id
       when matched and s.qty < 0 then delete
       when matched then update set name = s.name, qty = t.qty + s.qty
       when not matched then insert (id, name, qty) values (s.id, s.name, s.qty)""",
    "select id, name, qty, price from tgt order by id nulls last, name",
    "delete from tgt where qty > 100",
    "select id, name, qty, price from tgt order by id nulls last, name",
]


def test_update_and_merge_on_the_card_equal_the_cpu(dev):
    engines = _both_engines()
    for sql in UPDATE_AND_MERGE:
        _run_on_both(engines, sql)


def test_refresh_path_on_the_card_equals_the_cpu(dev):
    import chip_smoke as cs

    engines = _both_engines(sf=0.1)
    path = cs.refresh_path(engines["cpu"][0].catalogs["tpch"].row_count("orders"))
    ck.reset_stats()
    for step in ("load", "rf1", "rf2"):
        for _, sql in path[step]:
            _run_on_both(engines, sql)
        _run_on_both(engines, cs.Q15_VIEW)
        for q in cs.MEMORY_QUERIES:
            _run_on_both(engines, cs.ALL_QUERIES[q])
        for sql in cs.CHECKSUMS.values():
            _run_on_both(engines, sql)
        _run_on_both(engines, "drop view revenue0")
    assert ck.STATS["compact_rows"].launches > 0 and ck.STATS["hash_insert"].launches > 0


# -- the function library: sort-based aggregation and exact wide sums ---------------------


def test_sort_keys_and_groups_on_the_card_equal_the_cpu(dev):
    """The sort-based runner's group structure on the card equals the CPU's:
    -0.0 and 0.0 in one group, NULL keys in one group, dead rows in none,
    and each NaN key a group of its own after +inf, as in the reference
    (ROADMAP C)."""
    from trino_tpu_torch.exec.local_executor import _sort_key, _sorted_groups

    rng = np.random.default_rng(3)
    n = 200003
    x = rng.choice(np.array([0.0, -0.0, np.nan, -np.nan, np.inf, 1.5, -2.5]), size=n)
    k = rng.integers(0, 50, n).astype(np.int32)
    kn = rng.random(n) < 0.1
    valid = rng.random(n) < 0.9
    got = {}
    for d in (dev, torch.device("cpu")):
        kc = [torch.as_tensor(x, device=d), torch.as_tensor(k, device=d)]
        kns = [None, torch.as_tensor(kn, device=d)]
        _, gid, count = _sorted_groups(kc, kns, torch.as_tensor(valid, device=d))
        got[d.type] = (gid.cpu(), int(count), torch.argsort(_sort_key(kc[0]), stable=True).cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0])
    nan = np.isnan(x)
    distinct = {(v, kk if not nn else None)
                for v, kk, nn in zip(x[valid & ~nan] + 0.0, k[valid & ~nan], kn[valid & ~nan])}
    assert got["cuda"][1] == got["cpu"][1] == len(distinct) + int((valid & nan).sum())
    assert torch.equal(got["cuda"][2], got["cpu"][2])


def test_function_corpora_on_the_card_equal_the_cpu(dev):
    """Phase 9a of chip_smoke.py: every statement of tests/test_torch_functions.py
    and tests/test_torch_aggregates.py (sort-based aggregation, exact wide
    sums, the new accumulators and scalar calls) on the card and the CPU."""
    import chip_smoke as cs

    ck.reset_stats()
    cs.functions_parity()
    assert ck.STATS["compact_rows"].launches > 0 and ck.STATS["hash_insert"].launches > 0


def test_wide_sums_on_the_card_decode_exactly(dev):
    from decimal import Decimal

    import chip_smoke as cs

    engine, sessions = cs.corpus_engines("cuda", cs.AGGREGATE_SETUP)
    want = sum(Decimal(f"{8_600_000_000_000_000 + i * 7}.25") for i in range(40))
    r = engine.execute_sql("select sum(v) s from big", sessions["mem"])
    assert r.raw_columns[0].dtype == object and r.rows() == [(want,)]
    with pytest.raises(NotImplementedError, match="wide-decimal"):
        engine.execute_sql("select sum(v) + 1 x from big", sessions["mem"])


def test_array_and_match_corpora_on_the_card_equal_the_cpu(dev):
    """Phase 10a of chip_smoke.py: every statement of tests/test_torch_arrays.py
    and tests/test_torch_match.py (UNNEST, element calls, lambdas, array- and
    map-valued aggregates, MATCH_RECOGNIZE) on the card and the CPU."""
    import chip_smoke as cs

    ck.reset_stats()
    cs.arrays_parity()
    assert ck.STATS["compact_rows"].launches > 0 and ck.STATS["hash_insert"].launches > 0


def test_unnest_indices_and_vector_match_on_the_card_equal_the_cpu(dev):
    from trino_tpu_torch.ops.arrays import unnest_indices
    from trino_tpu_torch.ops.matcher import vector_match

    rng = np.random.default_rng(5)
    n = 100_000
    lens = rng.integers(0, 8, n)
    lens[rng.random(n) < 0.2] = 0
    total = 1 << int(lens.sum() - 1).bit_length()
    got = [tuple(x.cpu() for x in unnest_indices(torch.as_tensor(lens, device=d), total))
           for d in (dev, torch.device("cpu"))]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    walk = rng.integers(-3, 4, n)
    part = rng.random(n) < 0.01
    part[0] = True
    conds = {"d": walk < 0, "u": walk > 0}
    out = [vector_match((("d", "+"), ("u", "+")),
                        {k: torch.as_tensor(v, device=d) for k, v in conds.items()},
                        torch.as_tensor(part, device=d), {"d", "u"})
           for d in (dev, torch.device("cpu"))]
    for f in ("usable", "end", "pos", "nxt"):
        assert np.array_equal(getattr(out[0], f), getattr(out[1], f)), f
    assert out[0].usable.any()


def test_server_on_the_card_serves_the_cpu_results(dev):
    """Phase 11 of chip_smoke.py at SF0.01: a CoordinatorServer over a card
    engine answers bench.py's queries with the pages a CPU engine's results
    make, from four clients at once; each statement's launches are its
    serial run's, and /v1/status reports the card's memory."""
    import json
    import threading
    import urllib.request

    import chip_smoke as cs
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.server import Client, CoordinatorServer

    card = Engine(device="cuda")
    card.register_catalog("tpch", TpchConnector(sf=0.01))
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpch", TpchConnector(sf=0.01))
    srv = CoordinatorServer(card, port=0, dispatch_threads=4)
    srv.start()
    try:
        c = Client(srv.url, catalog="tpch")
        serial, want = {}, {}
        for q, sql in cs.QUERIES.items():
            res = c.execute(sql)
            want[q] = cs.json_rows(cpu.execute_sql(sql, cpu.create_session("tpch")))
            cs.same_json_rows(res.rows, want[q], res.columns, sql, q)
            serial[q] = cs.statement_counters(card, sql)["launches"]
        errors = []

        def run():
            try:
                c2 = Client(srv.url, catalog="tpch")
                for q, sql in cs.QUERIES.items():
                    res = c2.execute(sql)
                    cs.same_json_rows(res.rows, want[q], res.columns, sql, q)
            except Exception as e:  # noqa: BLE001 - reported by the assertion
                errors.append(e)

        threads = [threading.Thread(target=run) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for qsm in card.query_tracker.all_queries():
            q = next(k for k, v in cs.QUERIES.items() if v == qsm.sql)
            assert qsm.counters["launches"] == serial[q], q
        status = json.loads(urllib.request.urlopen(srv.url + "/v1/status").read())
        assert status["device_memory"]["bytes_limit"] > 0
    finally:
        srv.stop()
