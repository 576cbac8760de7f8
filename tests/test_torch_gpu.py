"""Tests of the port that need a CUDA card: each kernel against its plain
version on the card, and TPC-H, multi-match joins and global aggregates on
the card against the same SQL on the CPU.

They skip without a card.  This file imports no jax, so on a machine with a
card (which has no jax) it runs without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import cuda_kernels as ck
from trino_tpu_torch.ops.hashing import EMPTY_KEY, probe_step, splitmix64

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


@pytest.mark.parametrize("nb,C,n", [(1000, 4096, 5000), (256, 256, 600), (0, 64, 10)])
def test_hash_probe_kernel_bit_identical(dev, nb, C, n):
    rng = np.random.default_rng(nb + n)
    table = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=dev)
    if nb:
        bkeys = torch.as_tensor(np.unique(_keys(rng, nb, nb)), device=dev)
        table, _, _ = ck.hash_insert_plain(table, bkeys,
                                           torch.ones_like(bkeys, dtype=torch.bool))
        pool = torch.cat([bkeys, bkeys + (1 << 41)])
    else:
        pool = torch.arange(1, 100, device=dev)
    packed = pool[torch.as_tensor(rng.integers(0, len(pool), size=n), device=dev)]
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    vals = torch.as_tensor(rng.integers(0, 2**31 - 1, size=C, dtype=np.int32), device=dev)
    h0 = splitmix64(packed)
    stp = probe_step(h0)
    a = ck.hash_probe(table[:C], vals, packed, h0, stp, valid)
    b = ck.hash_probe_plain(table[:C], vals, packed, h0, stp, valid)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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
