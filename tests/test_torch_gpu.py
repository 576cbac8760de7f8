"""Tests of the port that need a CUDA card: each kernel against its plain
version on the card; TPC-H, multi-match joins, global aggregates and the
TPC-DS corpus on the card against the same SQL on the CPU; the window
primitives and the window kernel on the card against their CPU runs; the
streaming LIMIT compacting through the CUDA kernel; the sort-based
aggregation runner, the function corpora and the exact wide sums; and the
array, map, UNNEST and MATCH_RECOGNIZE corpora, UNNEST's expansion map and
the vectorized matcher; the coordinator server over a card engine; the
buffer pool's page, build and result tiers on the card (phase 12 of
chip_smoke.py at SF0.01); a fused template window on the card (phase 13);
a ``dispatch`` fault inside each kernel wrapper on CUDA tensors, after which
the wrapper launches nothing (phase 17); host-decoded pages staged to the
card by the prefetch producer (phase 18: a connector defined here returns
the numpy pages a file connector would, so the test needs no ``pyarrow``);
the distributed executor on a virtual ``worker_mesh(4)`` over the card, and
the exchange's ``bucketize`` and ``append_rows`` on the card against their
CPU runs (phase 19); the cluster on the card (phase 20): Q1 and Q9 through
an in-process worker on the card and one worker process started without
``--device``, and a fault-tolerant run with injected failures, each against
the same SQL on the CPU.

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


def test_server_on_the_card_serves_the_cpu_results(dev, monkeypatch):
    """Phase 11 of chip_smoke.py at SF0.01: a CoordinatorServer over a card
    engine answers bench.py's queries with the pages a CPU engine's results
    make, from four clients at once; each statement's launches are its
    serial run's, and /v1/status reports the card's memory.  As in phase 11,
    the buffer pool's page tier is off: every run generates its scans."""
    import json
    import threading
    import urllib.request

    import chip_smoke as cs
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.server import Client, CoordinatorServer

    monkeypatch.setenv("TRINO_TPU_PAGE_CACHE", "0")
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
            # the baseline is a warm run, one that captured no graph: a cold
            # statement also counts the eager warm-up of each scan-fused
            # body it captures, and a plan the advisor corrects captures again
            for _ in range(4):
                cs.same_json_rows(c.execute(sql).rows, want[q], res.columns, sql, q)
                counters = cs.statement_counters(card, sql)
                if counters["graph_captures"] == 0:
                    break
            assert counters["graph_captures"] == 0, q
            serial[q] = counters["launches"]
        before = {qsm.query_id for qsm in card.query_tracker.all_queries()}
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
            if qsm.query_id in before:
                continue
            q = next(k for k, v in cs.QUERIES.items() if v == qsm.sql)
            assert qsm.counters["launches"] == serial[q], q
        status = json.loads(urllib.request.urlopen(srv.url + "/v1/status").read())
        assert status["device_memory"]["bytes_limit"] > 0
    finally:
        srv.stop()


# -- the buffer pool on the card (phase 12) ----------------------------------------------


def test_page_tier_defaults_to_a_quarter_of_the_card(dev, monkeypatch):
    from trino_tpu_torch import Engine

    monkeypatch.delenv("TRINO_TPU_PAGE_CACHE", raising=False)
    monkeypatch.delenv("TRINO_TPU_RESULT_CACHE", raising=False)
    e = Engine()
    free, total = torch.cuda.mem_get_info()
    assert 0 < e.buffer_pool.budget() <= total // 4
    assert e.buffer_pool.result_budget() == 0
    assert Engine(device="cpu").buffer_pool.budget() == 0


def test_cached_passes_on_the_card_equal_the_cpu(dev, monkeypatch):
    """The 22 queries twice on a card engine at the default page tier: both
    passes equal the CPU's results; the second hits the page tier on every
    scan, checks every join build out and runs no hashed build, so it
    launches no ``hash_insert`` for one."""
    import chip_smoke as cs
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    monkeypatch.delenv("TRINO_TPU_PAGE_CACHE", raising=False)
    # the page loop: the scan-fused runners generate each split again on
    # the card and never read the page tier (chip_smoke's phase 12 pins it
    # the same way)
    monkeypatch.setenv("TRINO_TPU_SCAN_FUSED", "0")
    cpu = _card_and_cpu(cs.ALL_QUERIES)["cpu"]
    card = Engine(device="cuda")
    card.register_catalog("tpch", TpchConnector(sf=0.01))
    card.execute_sql(cs.Q15_VIEW, card.create_session("tpch"))
    builds, restore = cs.counted_builds()
    try:
        for label in ("pass1", "pass2"):
            before = dict(builds)
            for q, sql in cs.ALL_QUERIES.items():
                _same(card.execute_sql(sql, card.create_session("tpch")), cpu[q])
                c = card.last_query_counters
                if label == "pass2":
                    # bench.py's Q18 is empty at SF0.01: its semi join's
                    # build is empty, so its probe reads no split at all
                    assert c["page_cache_misses"] == 0, q
                    assert c["page_cache_hits"] > 0 or q == "q18", q
                    assert c["build_cache_misses"] == 0, q
            if label == "pass1":
                assert builds["hash_insert"] > before["hash_insert"]
            else:
                assert builds == before, "a warm pass ran a hashed join build"
    finally:
        restore()
    assert card.buffer_pool.info()["device_bytes"] <= card.buffer_pool.budget()


def test_staged_scan_page_on_the_card_equals_the_cpu(dev):
    """A completed scan staged as one page (the kernel packs the live rows)
    holds the bytes the CPU's staging holds."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec.local_executor import LocalExecutor

    pages = {}
    for device in ("cuda", "cpu"):
        conn = TpchConnector(sf=0.01, split_rows=1 << 13, device=device)
        ex = LocalExecutor({"tpch": conn}, device)
        cols = ["l_orderkey", "l_quantity", "l_shipdate", "l_returnflag"]
        before = ck.STATS["compact_rows"].launches
        pages[device] = ex._stage_scan_entry([conn.generate(s, cols)
                                              for s in conn.splits("lineitem")])
        if device == "cuda":
            assert ck.STATS["compact_rows"].launches == before + 1
    a, b = pages["cuda"], pages["cpu"]
    assert a.valid is None and b.valid is None and a.capacity == b.capacity
    for x, y in zip(a.columns, b.columns):
        assert x.device.type == "cuda" and torch.equal(x.cpu(), y)


def test_result_tier_hit_launches_nothing_on_the_card(dev, monkeypatch):
    """Phase 12c's check: the second run of each of bench.py's five is a
    result-tier hit that launches nothing.  As in phase 12, the adaptive
    advisor is off: with it on, q18's second run is its corrected plan,
    which the tier keys by the correction and misses."""
    import chip_smoke as cs
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", str(64 << 20))
    monkeypatch.setenv("TRINO_TPU_ADAPTIVE", "0")
    card = Engine(device="cuda")
    card.register_catalog("tpch", TpchConnector(sf=0.01))
    cpu = _card_and_cpu(cs.QUERIES)["cpu"]
    for q, sql in cs.QUERIES.items():
        s = card.create_session("tpch")
        miss = card.execute_sql(sql, s)
        hit = cs.result_hit_counts(card, sql, s, q)
        _same(miss, cpu[q])
        _same(hit, miss)


def test_fused_template_window_on_the_card_equals_serial(dev, monkeypatch):
    """A fused window of four requests of T4 (a lineitem point lookup,
    bind-time pruned) on the card equals, byte for byte, the four requests
    run one by one, and packs its lanes through the CUDA compaction."""
    import chip_smoke as cs
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "0")
    card = Engine(device="cuda")
    card.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 12))
    text = cs.TEMPLATES["t4"]
    s = card.create_session("tpch")
    for k in (1, 2):  # create and confirm the template
        card.execute_sql(text, s, parameters=[k])
    keys = [(7,), (3000,), (9001,), (14999,)]  # kept splits differ
    card.template_batcher.enabled = False
    serial = [card.execute_sql(text, s, parameters=list(k)) for k in keys]
    card.template_batcher.enabled = True
    before = ck.STATS["compact_rows"].launches
    fused, recs, _ = cs.fused_window(card, text, (5,), keys)
    assert ck.STATS["compact_rows"].launches > before
    for got, want, r in zip(fused, serial, recs):
        cs.same_bytes(got, want, "fused lane vs serial")
        assert r["batched_with"] == len(keys)
    assert any(len(r) for r in serial)


# -- memory-bounded execution (phase 16 of chip_smoke.py at SF0.02) --------------
def _spill_engines(sf=0.02, split_rows=1 << 12):
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    out = {}
    for device in ("cuda", "cpu"):
        e = Engine(device=device)
        e.register_catalog("tpch", TpchConnector(sf=sf, split_rows=split_rows))
        out[device] = e
    return out


def _spill_rows(monkeypatch):
    """Rows per partition of every spill, recorded as it closes."""
    from trino_tpu_torch.exec import spill

    seen = []
    orig = spill.SpilledPartitions.close

    def close(self):
        if not self._closed:
            seen.append((self.parts, list(self.rows)))
        orig(self)

    monkeypatch.setattr(spill.SpilledPartitions, "close", close)
    return seen


def test_pressure_scenarios_on_the_card_equal_the_cpu(dev, tmp_path, monkeypatch):
    """The eight pressure scenarios on a card engine: each recovers to the
    unconstrained card result (equal to the CPU's) or fails typed, its
    spills partition row for row as on the CPU, and the leak check is clean."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.sql.frontend import compile_sql

    engines = _spill_engines()
    seen = _spill_rows(monkeypatch)
    base, recs = {}, {}
    for device, e in engines.items():
        plan = compile_sql(cm.PRESSURE_QUERY, e, e.create_session("tpch"))
        base[device] = cm.result_signature(LocalExecutor(e.catalogs, device).execute(plan))
        for name, cfg, spec, kind in cm.PRESSURE:
            d = tmp_path / f"{device}-{name}"
            d.mkdir()
            seen.clear()
            r = cm.run_pressure_scenario(e, plan, base[device], name, cfg, spec, kind, str(d))
            assert r["ok"], (device, name, r.get("detail"), r.get("leaks"))
            assert cm.leak_report(e, timeout=2.0) == []
            recs[(device, name)] = (list(seen), r.get("error_type"),
                                    sorted(t for t, b in r["tiers"].items() if b))
    assert base["cuda"] == base["cpu"]
    for name, *_ in cm.PRESSURE:
        assert recs[("cuda", name)] == recs[("cpu", name)], name


def test_prefetch_staging_on_the_card_is_byte_equal(dev):
    """Host pages staged to the card by the prefetch producer (pinned
    buffers, a side stream, an event the consumer waits on) arrive equal to
    their sources, run after run, and their bytes count as H2D."""
    import numpy as np

    from trino_tpu_torch.exec.local_executor import LocalExecutor, _prefetched_pages
    from trino_tpu_torch.page import Page, Schema
    from trino_tpu_torch.types import BIGINT

    rng = np.random.default_rng(5)
    schema = Schema.of(("k", BIGINT), ("v", BIGINT))
    pages = [(rng.integers(-2**62, 2**62, n), rng.integers(0, 1000, n), rng.random(n) < 0.1)
             for n in rng.integers(1, 300_000, 24)]

    def source():
        for k, v, m in pages:
            yield Page(schema, (k, v), (None, m), None)

    ex = LocalExecutor({}, "cuda")
    want = sum(k.nbytes + v.nbytes + m.nbytes for k, v, m in pages)
    for _ in range(3):
        ex.h2d_bytes = 0
        got = []
        for page in _prefetched_pages(source, to_device=True, owner=ex)():
            # work on the consumer's stream between pages
            got.append((page.columns[0] * 1, page.columns[1] + 0, page.null_masks[1].clone()))
        torch.cuda.synchronize()
        assert len(got) == len(pages)
        for (k, v, m), (gk, gv, gm) in zip(pages, got):
            assert gk.is_cuda and np.array_equal(gk.cpu().numpy(), k)
            assert np.array_equal(gv.cpu().numpy(), v) and np.array_equal(gm.cpu().numpy(), m)
        assert ex.h2d_bytes == want
        assert ex.close_producers() == 1


@pytest.mark.parametrize("sql,pool", [
    ("""select o_orderpriority, count(*) c from orders, lineitem
        where o_orderkey = l_orderkey group by o_orderpriority order by o_orderpriority""",
     200_000),
    ("""select count(*) c, sum(ps_supplycost) s from lineitem, partsupp
        where l_partkey = ps_partkey and l_suppkey = ps_suppkey""", 150_000),
    ("""select l_orderkey, count(*) c from lineitem group by l_orderkey
        order by c desc, l_orderkey limit 5""", 100_000),
])
def test_grace_paths_on_the_card_equal_the_cpu(dev, tmp_path, monkeypatch, sql, pool):
    """The partitioned join (one key and two) and the Grace aggregation
    under tiny pools on the card: the unconstrained card result, the CPU's,
    and the CPU's rows per partition; no spill file is left."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.memory import MemoryPool
    from trino_tpu_torch.sql.frontend import compile_sql

    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    engines = _spill_engines()
    seen = _spill_rows(monkeypatch)
    got = {}
    for device, e in engines.items():
        plan = compile_sql(sql, e, e.create_session("tpch"))
        full = LocalExecutor(e.catalogs, device).execute(plan)
        seen.clear()
        ex = LocalExecutor(e.catalogs, device, memory_pool=MemoryPool(max_bytes=pool))
        small = ex.execute(plan)
        _same(small, full)
        got[device] = (small, list(seen))
    _same(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1] == got["cpu"][1] and got["cuda"][1]
    assert not list(tmp_path.iterdir())


def test_dispatch_fault_in_a_kernel_wrapper_launches_nothing(dev):
    """An armed ``dispatch`` rule fires inside each kernel wrapper on CUDA
    tensors and raises there: the wrapper launches no kernel (its count
    stays) and runs no plain version; disarmed, the same call launches."""
    from trino_tpu_torch.execution import faults

    rng = np.random.default_rng(5)
    keys = torch.as_tensor(_keys(rng, 4096, 1000), device=dev)
    valid = torch.ones(4096, dtype=torch.bool, device=dev)
    table = torch.full((4097,), EMPTY_KEY, dtype=torch.int64, device=dev)
    slots = torch.as_tensor(rng.integers(0, 8, 4096), dtype=torch.int32, device=dev)
    vals = torch.as_tensor(rng.random(4096), dtype=torch.float32, device=dev)
    calls = {
        "hash_insert": lambda: ck.hash_insert(table, keys, valid),
        "hash_probe": lambda: ck.hash_probe(table[:4096], None, keys, valid),
        "compact_rows": lambda: ck.compact_rows((keys,), valid, 4096),
        "fused_segment_agg": lambda: ck.fused_segment_agg(slots, valid, [vals], 8),
    }
    for name, call in calls.items():
        before = ck.STATS[name].launches
        with faults.injected(f"point=dispatch,site={name},action=error,nth=1") as plan:
            with pytest.raises(faults.InjectedFaultError, match=f"dispatch/{name}"):
                call()
        torch.cuda.synchronize()
        assert plan.total_fires() == 1
        assert ck.STATS[name].launches == before, f"{name} launched under the fault"
        call()
        torch.cuda.synchronize()
        assert ck.STATS[name].launches == before + 1, name


class _HostPages:
    """A connector whose pages decode on the host (``HOST_DECODE``): the
    TPC-H tables at SF0.01, each split's page copied into numpy arrays, as
    a file connector's ``generate`` returns them."""

    HOST_DECODE = True

    def __init__(self):
        from trino_tpu_torch.connectors.tpch import TpchConnector

        self._src = TpchConnector(sf=0.01, split_rows=1 << 13, device="cpu")
        self.pages = 0

    def __getattr__(self, name):  # metadata, splits and ranges: the generator's
        return getattr(self._src, name)

    def generate(self, split, columns=None):
        from trino_tpu_torch.page import Page

        p = self._src.generate(split, columns)
        keep = p.valid_mask().numpy()
        self.pages += 1
        return Page(p.schema, tuple(c.numpy()[keep] for c in p.columns),
                    tuple(None if m is None else m.numpy()[keep] for m in p.null_masks),
                    None)


def test_host_decoded_pages_are_staged_to_the_card(dev, monkeypatch):
    """A host-decode connector's numpy pages reach the card through the
    prefetch producer: each page staged there is on the card, its bytes
    are the query's ``h2d_bytes``, and the rows equal the CPU run's."""
    import threading

    from trino_tpu_torch import Engine
    from trino_tpu_torch.exec import local_executor as le

    staged = []
    to_device = le._page_to_device

    def spy(page, device, side):
        out = to_device(page, device, side)
        staged.append((threading.current_thread().name, out[1],
                       all(c.is_cuda for c in out[0].columns)))
        return out

    monkeypatch.setattr(le, "_page_to_device", spy)
    sql = """select l_returnflag, l_linestatus, count(*) c, sum(l_quantity) q,
                    sum(l_extendedprice * (1 - l_discount)) r
             from lineitem where l_shipdate <= date '1998-09-01'
             group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""
    got = {}
    for device in ("cuda", "cpu"):
        staged.clear()
        conn = _HostPages()
        e = Engine(device=device)
        e.register_catalog("tpch", conn)
        got[device] = e.execute_sql(sql, e.create_session("tpch"))
        assert conn.pages == len(conn.splits("lineitem")) > 1
        assert [s[0] for s in staged] == ["prefetch-producer"] * conn.pages
        assert all(s[2] for s in staged) == (device == "cuda")
        assert e.last_query_counters["h2d_bytes"] >= sum(s[1] for s in staged) > 0
    _same(got["cuda"], got["cpu"])


# -- the worker mesh (chip_smoke.py phase 19) ------------------------------------------

DIST_CARD = {
    "q3": None,  # chip_smoke.DIST_QUERIES["q3"]
    # a partitioned join (the build routes through the exchange) feeding a
    # group-by: hash_insert_ (build and groups), hash_probe, compact_rows
    "partitioned": ("select l_orderkey, count(*) n, sum(l_quantity) q from lineitem, orders "
                    "where l_orderkey = o_orderkey and o_orderdate < date '1994-01-01' "
                    "group by l_orderkey order by l_orderkey limit 50"),
}


@pytest.mark.parametrize("name", sorted(DIST_CARD))
def test_distributed_on_a_virtual_card_mesh_equals_local(dev, name):
    """q3 and a partitioned join on worker_mesh(4) over the one card: equal
    to the local card run, and the mesh run launches the compaction
    (bucketize, append_rows), insert and probe kernels."""
    from chip_smoke import DIST_QUERIES
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec.distributed import DistributedExecutor
    from trino_tpu_torch.parallel.mesh import worker_mesh
    from trino_tpu_torch.sql.frontend import compile_sql

    sql = DIST_CARD[name] or DIST_QUERIES[name]
    e = Engine(device="cuda")
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 13))
    s = e.create_session("tpch")
    local = e.execute_sql(sql, s)
    mesh = worker_mesh(4)
    assert mesh.size == 4 and len(mesh.distinct_devices) == torch.cuda.device_count()
    ck.reset_stats()
    ex = DistributedExecutor(e.catalogs, mesh=worker_mesh(4, devices=["cuda"]),
                             partition_threshold=8 if name == "partitioned" else 1 << 17)
    got = ex.execute(compile_sql(sql, e, s))
    _same(got, local)
    for k in ("compact_rows", "hash_insert", "hash_probe"):
        assert ck.STATS[k].launches > 0, (k, ex.exec_trace)
    assert not [t for t in ex.exec_trace if t[1] == "local"], ex.exec_trace


def test_bucketize_and_append_rows_on_the_card_equal_the_cpu(dev):
    from trino_tpu_torch.ops.arrays import append_rows
    from trino_tpu_torch.ops.exchange import bucketize

    rng = np.random.default_rng(19)
    n, P, bucket = 100_003, 8, 15_000
    cols = (rng.integers(0, 1 << 40, n), rng.random(n), rng.random(n) < 0.5)
    valid = rng.random(n) < 0.9
    pid = rng.integers(0, P, n).astype(np.int32)
    out = {}
    for d in ("cuda", "cpu"):
        t = [torch.as_tensor(c, device=d) for c in cols]
        packed, pvalid, oflow = bucketize(tuple(t), torch.as_tensor(valid, device=d),
                                          torch.as_tensor(pid, device=d), P, bucket)
        cap = 200_000  # two appends of ~90,000 live rows fit, the third passes
        bufs = (torch.zeros((cap + 1,), dtype=torch.int64, device=d),
                torch.zeros((cap + 1,), dtype=torch.float64, device=d))
        cur = torch.zeros((), dtype=torch.int64, device=d)
        flags = []
        for _ in range(3):
            bufs, cur, of = append_rows(bufs, cur, (t[0], t[1]),
                                        torch.as_tensor(valid, device=d))
            flags.append(bool(of))
        out[d] = ([p.cpu().numpy() for p in packed], pvalid.cpu().numpy(), bool(oflow),
                  [b.cpu().numpy() for b in bufs], int(cur), flags)
    a, b = out["cuda"], out["cpu"]
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    assert np.array_equal(a[1], b[1]) and a[2] == b[2]
    for x, y in zip(a[3], b[3]):
        assert np.array_equal(x, y)
    assert a[4] == b[4] and a[5] == b[5] == [False, False, True]


CLUSTER_Q1 = """select l_returnflag, l_linestatus, sum(l_quantity) qty, count(*) c,
        avg(l_discount) d from lineitem where l_shipdate <= date '1998-09-02'
        group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""
CLUSTER_Q9 = """select nation, o_year, sum(amount) as sum_profit from (
          select n_name as nation, extract(year from o_orderdate) as o_year,
            l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
          from part, supplier, lineitem, partsupp, orders, nation
          where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
            and ps_partkey = l_partkey and p_partkey = l_partkey
            and o_orderkey = l_orderkey and s_nationkey = n_nationkey
            and p_name like '%green%') as profit
        group by nation, o_year order by nation, o_year desc"""
CLUSTER_CATALOGS = {"tpch": {"connector": "tpch", "sf": 0.01, "split_rows": 1 << 12}}


def _cluster_engine(device):
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    e = Engine(device=device)
    e.register_catalog("tpch", TpchConnector(sf=0.01, split_rows=1 << 12))
    return e


def _same_rows(a, b):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    chip_smoke.same_result(a, b, "card vs cpu")


def test_cluster_in_process_worker_on_the_card(dev, tmp_path):
    from trino_tpu_torch.server.cluster import ClusterCoordinator, WorkerServer

    cpu, card = _cluster_engine("cpu"), _cluster_engine(None)
    coord = ClusterCoordinator(card, str(tmp_path / "spool"), heartbeat_interval=0.2)
    url = coord.start()
    w = WorkerServer(CLUSTER_CATALOGS, str(tmp_path / "spool"), coordinator_url=url,
                     node_id="card", pool_bytes=2 << 30, cache_bytes=256 << 20)
    try:
        w.start()
        assert w.device.type == "cuda"
        coord.wait_for_workers(1, timeout=60)
        for sql in (CLUSTER_Q1, CLUSTER_Q9):
            got = coord.execute_sql(sql)
            assert coord.local_fallbacks == 0, coord.last_fallback_error
            _same_rows(got, cpu.execute_sql(sql, cpu.create_session("tpch")))
            assert sum(coord._qc_workers.launches.values()) > 0, "no worker launch"
    finally:
        w.stop()
        coord.stop()


def test_cluster_worker_process_takes_the_card(dev, tmp_path):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from trino_tpu_torch.server.cluster import ClusterCoordinator

    cpu, card = _cluster_engine("cpu"), _cluster_engine(None)
    coord = ClusterCoordinator(card, str(tmp_path / "spool"), heartbeat_interval=0.2)
    url = coord.start()
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen([sys.executable, "-m", "trino_tpu_torch.server.cluster",
                          "--coordinator", url, "--catalogs", json.dumps(CLUSTER_CATALOGS),
                          "--spool", str(tmp_path / "spool"), "--node-id", "proc",
                          "--pool-bytes", str(2 << 30), "--cache-bytes", str(256 << 20)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        assert "device cuda" in p.stdout.readline()
        coord.wait_for_workers(1, timeout=120)
        got = coord.execute_sql(CLUSTER_Q9)
        assert coord.local_fallbacks == 0, coord.last_fallback_error
        _same_rows(got, cpu.execute_sql(CLUSTER_Q9, cpu.create_session("tpch")))
        assert sum(coord._qc_workers.launches.values()) > 0
    finally:
        p.terminate()
        p.wait(timeout=60)
        coord.stop()


def test_fault_tolerant_run_on_the_card_recovers(dev, tmp_path):
    from trino_tpu_torch.exec.fte import FailureInjector, FaultTolerantExecutor
    from trino_tpu_torch.sql.frontend import compile_sql

    cpu, card = _cluster_engine("cpu"), _cluster_engine(None)
    inj = FailureInjector()
    inj.inject(0, "TASK_FAILURE", times=2)
    inj.inject(1, "POST_COMMIT_FAILURE", times=1)
    ex = FaultTolerantExecutor(card.catalogs, str(tmp_path / "spool"), injector=inj,
                               memory_pool=card.memory_pool)
    got = ex.execute(compile_sql(CLUSTER_Q1, card, card.create_session("tpch")))
    _same_rows(got, cpu.execute_sql(CLUSTER_Q1, cpu.create_session("tpch")))
    assert ex.task_attempts[0] == 3 and ex.task_attempts[1] == 1
    s = card.create_session("tpch")
    _same_rows(card.execute_sql(CLUSTER_Q9, s, fault_tolerant=True),
               cpu.execute_sql(CLUSTER_Q9, cpu.create_session("tpch")))


# -- the scan-fused runners as CUDA graphs (chip_smoke.py phase 21) ---------------
def _fused_run(monkeypatch, graphs, q, sf=0.05, split_rows=1 << 15):
    """bench.py's ``q`` with the scan-fused runners on, their body captured
    and replayed as CUDA graphs (``graphs``) or run eagerly per split: the
    cold and the warm result and counters."""
    import trino_tpu_torch.exec.local_executor as LE
    from chip_smoke import QUERIES
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    monkeypatch.setattr(LE, "FUSED_GRAPHS", graphs)
    monkeypatch.setenv("TRINO_TPU_SCAN_FUSED", "1")
    e = Engine(device="cuda")
    e.register_catalog("tpch", TpchConnector(sf=sf, split_rows=split_rows))
    s = e.create_session("tpch")
    cold = e.execute_sql(QUERIES[q], s)
    c_cold = dict(e.last_query_counters)
    # one eager run of each captured body (the capture's warm-up): its
    # launches are the cold statement's too
    warmup = {}
    for entry, _ in list(e._fused_cache._entries.values()):
        for kernel, _shape in getattr(entry, "launches", ()):
            warmup[kernel] = warmup.get(kernel, 0) + 1
    c_cold["warmup_launches"] = warmup
    warm = e.execute_sql(QUERIES[q], s)
    return cold, c_cold, warm, dict(e.last_query_counters)


@pytest.mark.parametrize("q", ["q1", "q3"])
def test_fused_chain_replayed_as_a_graph_equals_the_eager_body(dev, monkeypatch, q):
    """The captured body, replayed once per split, gives what the same body
    run eagerly per split gives (integers exactly, DOUBLE within rtol 1e-9);
    a warm statement captures no new graph."""
    e_cold, _, e_warm, _ = _fused_run(monkeypatch, False, q)
    g_cold, gc_cold, g_warm, gc_warm = _fused_run(monkeypatch, True, q)
    _same(g_cold, e_cold)
    _same(g_warm, e_warm)
    assert gc_cold["graph_captures"] > 0 and gc_cold["graph_replays"] > 0
    assert gc_warm["graph_captures"] == 0 and gc_warm["graph_replays"] > 0


def test_replays_charge_the_launches_their_body_holds(dev, monkeypatch):
    """Each replay charges the kernel launches its captured body holds: a
    graph run counts, per kernel, the launches of the same body run eagerly
    (Q3: probes, inserts and the traced concat's compaction); a cold one
    also counts the eager warm-up run of each body it captured."""
    _, e_cold, _, e_warm = _fused_run(monkeypatch, False, "q3")
    _, g_cold, _, g_warm = _fused_run(monkeypatch, True, "q3")
    launched = {k: v for k, v in g_warm["launches"].items() if v}
    assert launched and sum(launched.values()) > 0
    assert launched == {k: v for k, v in e_warm["launches"].items() if v}
    assert g_cold["warmup_launches"]
    assert {k: v for k, v in g_cold["launches"].items() if v} == \
        {k: v + g_cold["warmup_launches"].get(k, 0)
         for k, v in e_cold["launches"].items() if v}
