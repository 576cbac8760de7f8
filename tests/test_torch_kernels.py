"""The four kernels' plain versions (what the wrappers run for CPU tensors)
against the JAX package: its XLA path, and its Pallas body in interpret mode.

- hash_insert: observables only (the slot layout depends on the claim order):
  placed sets whenever no row exhausts 64 rounds, the set of table words,
  ``table[slot] == packed`` for placed rows, and probe results over either
  table;
- hash_probe: bit for bit, with a payload array and in slot mode
  (``vals=None``; the port's probe hashes its keys itself, the reference's
  takes h0 and step, computed here on the JAX side from the same keys);
- compact_rows: byte for byte, values and live count;
- fused_segment_agg: counts exactly, float32 sums within rtol 1e-5 (the
  one-hot product and the scatter-add sum in different orders); an int64
  slot is taken as int32 first, as the reference takes it.

Inputs come from numpy with a seed.  Pallas bodies run with
``interpret=True``, as tests/test_pallas_kernels.py runs them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.ops import arrays as jarrays, hashagg as jagg, pallas_kernels as pk
from trino_tpu.ops.hashing import EMPTY_KEY, probe_step, splitmix64
from trino_tpu_torch.ops import cuda_kernels as ck

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

def T(a):
    return torch.as_tensor(np.array(a))


def _keys(rng, n, distinct, lo=1, hi=1 << 40):
    pool = np.unique(rng.integers(lo, hi, size=distinct * 2 + 8, dtype=np.int64))
    pool = rng.permutation(pool)[:distinct]
    return pool[rng.integers(0, len(pool), size=n)] if n else np.zeros(0, np.int64)


def _probe_np(table, packed, valid):
    """(slot, matched) of the port's plain probe over a [C+1] table, in slot mode."""
    C = table.shape[0] - 1
    return ck.hash_probe(T(table[:C]), None, T(packed), T(valid))


def _observables_equal(t_a, s_a, p_a, t_b, s_b, p_b, packed, valid, exhausts=False):
    C = t_a.shape[0] - 1
    for t, s, p in ((t_a, s_a, p_a), (t_b, s_b, p_b)):
        assert t[C] == EMPTY_KEY, "sink word written"
        assert (s[~valid] == C).all() and p[~valid].all(), "invalid rows: sink + placed"
        live = valid & p
        assert (t[s[live]] == packed[live]).all(), "table[slot] != packed"
        assert (s[valid & ~p] == C).all()
    words_a = np.unique(t_a[:C][t_a[:C] != EMPTY_KEY])
    words_b = np.unique(t_b[:C][t_b[:C] != EMPTY_KEY])
    if exhausts:
        # a full table: both fill every slot, and an unplaced row's key is absent
        assert len(words_a) == len(words_b) == C
        for t, p in ((t_a, p_a), (t_b, p_b)):
            assert not np.isin(packed[valid & ~p], t[:C]).any()
        return
    np.testing.assert_array_equal(p_a, p_b)
    np.testing.assert_array_equal(words_a, words_b)
    ma = _probe_np(t_a, packed, valid)
    mb = _probe_np(t_b, packed, valid)
    np.testing.assert_array_equal(ma[1].numpy(), mb[1].numpy())
    np.testing.assert_array_equal(ma[1].numpy(), valid)


INSERT_CASES = {
    # name: (n, C, distinct, valid fraction)
    "empty_input": (0, 64, 1, 1.0),
    "all_invalid": (300, 1024, 100, 0.0),
    "empty_table_one_page": (1000, 4096, 700, 0.9),
    "duplicates_in_page": (2000, 1024, 50, 0.8),
    "half_load": (512, 1024, 512, 1.0),
    "capacity_below_max_probes": (40, 8, 5, 1.0),
}


@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_hash_insert_plain_vs_xla(case):
    n, C, distinct, frac = INSERT_CASES[case]
    rng = np.random.default_rng(len(case))
    packed = _keys(rng, n, distinct)
    valid = rng.random(n) < frac
    table0 = np.full(C + 1, EMPTY_KEY, np.int64)
    jt, js, jp = jagg._probe_insert(jnp.asarray(table0), jnp.asarray(packed),
                                    jnp.asarray(valid))
    tt, ts, tp = ck.hash_insert(T(table0), T(packed), T(valid))
    assert tt.dtype == torch.int64 and ts.dtype == torch.int32 and tp.dtype == torch.bool
    _observables_equal(np.asarray(jt), np.asarray(js), np.asarray(jp),
                       tt.numpy(), ts.numpy(), tp.numpy(), packed, valid)


@pytest.mark.parametrize("case", ["duplicates_in_page", "capacity_below_max_probes",
                                  "all_invalid"])
def test_hash_insert_plain_vs_pallas_interpret(case):
    n, C, distinct, frac = INSERT_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    packed = _keys(rng, n, distinct)
    valid = rng.random(n) < frac
    table0 = np.full(C + 1, EMPTY_KEY, np.int64)
    jt, js, jp = pk.hash_insert(jnp.asarray(table0), jnp.asarray(packed),
                                jnp.asarray(valid), interpret=True)
    tt, ts, tp = ck.hash_insert(T(table0), T(packed), T(valid))
    _observables_equal(np.asarray(jt), np.asarray(js), np.asarray(jp),
                       tt.numpy(), ts.numpy(), tp.numpy(), packed, valid)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_hash_insert_nearly_full_table_exhausts_rounds(impl):
    """More distinct keys than slots: the table fills and the rest exhaust
    their 64 rounds unplaced, in every implementation."""
    C, n = 16, 200
    rng = np.random.default_rng(11)
    packed = _keys(rng, n, 60)
    valid = np.ones(n, bool)
    table0 = np.full(C + 1, EMPTY_KEY, np.int64)
    f = (lambda *a: jagg._probe_insert(*a)) if impl == "xla" \
        else (lambda *a: pk.hash_insert(*a, interpret=True))
    jt, js, jp = f(jnp.asarray(table0), jnp.asarray(packed), jnp.asarray(valid))
    tt, ts, tp = ck.hash_insert(T(table0), T(packed), T(valid))
    assert not tp.all() and not np.asarray(jp).all()
    _observables_equal(np.asarray(jt), np.asarray(js), np.asarray(jp),
                       tt.numpy(), ts.numpy(), tp.numpy(), packed, valid, exhausts=True)


def test_hash_insert_multi_page_state_threading():
    """Three pages threaded through one table in both packages, starting from
    a table the JAX insert partly filled (carried across with convert)."""
    from trino_tpu_torch.ops.convert import groupby_state_from_numpy

    rng = np.random.default_rng(3)
    C = 2048
    pages = [(_keys(rng, 600, 300, hi=5000), rng.random(600) < 0.85) for _ in range(4)]
    jt = jnp.full((C + 1,), EMPTY_KEY, jnp.int64)
    jt, _, _ = jagg._probe_insert(jt, jnp.asarray(pages[0][0]), jnp.asarray(pages[0][1]))
    st = groupby_state_from_numpy(np.asarray(jt), (), (), ())
    tt = st.table
    for packed, valid in pages[1:]:
        jt, js, jp = jagg._probe_insert(jt, jnp.asarray(packed), jnp.asarray(valid))
        tt, ts, tp = ck.hash_insert(tt, T(packed), T(valid))
        _observables_equal(np.asarray(jt), np.asarray(js), np.asarray(jp),
                           tt.numpy(), ts.numpy(), tp.numpy(), packed, valid)


def test_hash_insert_leaves_its_input_table_unchanged():
    rng = np.random.default_rng(4)
    table0 = T(np.full(257, EMPTY_KEY, np.int64))
    before = table0.clone()
    ck.hash_insert(table0, T(_keys(rng, 100, 50)), torch.ones(100, dtype=torch.bool))
    assert torch.equal(table0, before)


def test_hash_insert_in_place_writes_its_input_and_matches_the_functional_form():
    """hash_insert_ (plain version on the CPU) writes into the table it is
    given and returns what hash_insert returns beside its new table."""
    rng = np.random.default_rng(14)
    table0 = np.full(1025, EMPTY_KEY, np.int64)
    packed, valid = T(_keys(rng, 700, 300)), T(rng.random(700) < 0.9)
    tf, sf, pf = ck.hash_insert(T(table0), packed, valid)
    table = T(table0)
    slot, placed = ck.hash_insert_(table, packed, valid)
    assert not torch.equal(table, T(table0))
    assert torch.equal(table, tf) and torch.equal(slot, sf) and torch.equal(placed, pf)
    _observables_equal(tf.numpy(), sf.numpy(), pf.numpy(), table.numpy(), slot.numpy(),
                       placed.numpy(), packed.numpy(), valid.numpy())


def test_hash_insert_in_place_pages_threaded_vs_xla():
    """Four pages inserted in place into one table, each page's observables
    against trino_tpu's _probe_insert threaded through its own table."""
    rng = np.random.default_rng(15)
    C = 2048
    jt = jnp.full((C + 1,), EMPTY_KEY, jnp.int64)
    table = T(np.full(C + 1, EMPTY_KEY, np.int64))
    for _ in range(4):
        packed, valid = _keys(rng, 600, 300, hi=5000), rng.random(600) < 0.85
        jt, js, jp = jagg._probe_insert(jt, jnp.asarray(packed), jnp.asarray(valid))
        ts, tp = ck.hash_insert_(table, T(packed), T(valid))
        _observables_equal(np.asarray(jt), np.asarray(js), np.asarray(jp),
                           table.numpy(), ts.numpy(), tp.numpy(), packed, valid)


def test_hash_insert_in_place_refuses_a_strided_table():
    table = torch.full((130,), EMPTY_KEY, dtype=torch.int64)[::2]
    with pytest.raises(TypeError, match="contiguous"):
        ck.hash_insert_(table, torch.zeros(3, dtype=torch.int64),
                        torch.ones(3, dtype=torch.bool))


def _jax_table(bkeys, C):
    table0 = jnp.full((C + 1,), EMPTY_KEY, jnp.int64)
    valid = jnp.ones(bkeys.shape, bool)
    table, slot, placed = jagg._probe_insert(table0, jnp.asarray(bkeys), valid)
    rows = jnp.full((C + 1,), 2**31 - 1, jnp.int32).at[
        jnp.where(placed, slot, C)].min(jnp.arange(len(bkeys), dtype=jnp.int32)).at[C].set(0)
    return np.asarray(table), np.asarray(rows)


# the Pallas interpreter is slow on the CPU: its body runs on a subset
PALLAS_PROBE_CASES = ("full_table", "capacity_below_max_probes")
PROBE_CASES = {
    # name: (build keys, C, probe rows, valid fraction)
    "empty_probe": (50, 256, 0, 1.0),
    "all_invalid": (50, 256, 300, 0.0),
    "empty_table": (0, 64, 200, 1.0),
    "hits_and_misses": (700, 4096, 3000, 0.9),
    "full_table": (256, 256, 512, 0.9),      # wraparound + exhaustion, no EMPTY
    "capacity_below_max_probes": (5, 8, 64, 1.0),
}


def _probe_case(case):
    """(table [C+1], rows [C+1], C, packed, valid) of one PROBE_CASES entry:
    a table the JAX insert built, probed by hits and misses."""
    nb, C, n, frac = PROBE_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    bkeys = np.unique(_keys(rng, nb, nb)) if nb else np.zeros(0, np.int64)
    table, rows = _jax_table(bkeys, C) if len(bkeys) else (
        np.full(C + 1, EMPTY_KEY, np.int64), np.zeros(C + 1, np.int32))
    pool = np.concatenate([bkeys, (1 << 41) + np.arange(max(nb, 1), dtype=np.int64)])
    packed = pool[rng.integers(0, len(pool), size=n)] if n else np.zeros(0, np.int64)
    return table, rows, C, packed, rng.random(n) < frac


def _pallas_probe(table, vals, packed, valid):
    """The reference's Pallas probe in interpret mode; its h0 and step come
    from the JAX hashing of the same keys."""
    h0 = splitmix64(jnp.asarray(packed))
    return pk.hash_probe(jnp.asarray(table), jnp.asarray(vals), jnp.asarray(packed), h0,
                         probe_step(h0), jnp.asarray(valid), interpret=True)


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_hash_probe_plain_bit_identical(case):
    table, rows, C, packed, valid = _probe_case(case)
    # the XLA loop of hashjoin.probe (use_pallas is off on the CPU)
    from trino_tpu.ops.hashjoin import JoinTable, probe as jprobe
    from trino_tpu.types import BIGINT

    jt = JoinTable(jnp.asarray(table), jnp.asarray(rows), (), (), jnp.int32(0),
                   jnp.int32(0), jnp.bool_(False))
    xr, xm = jprobe(jt, (jnp.asarray(packed),), (BIGINT,), jnp.asarray(valid))
    tr, tm = ck.hash_probe(T(table[:C]), T(rows[:C]), T(packed), T(valid))
    assert tr.dtype == torch.int32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tr.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(xm))
    if case in PALLAS_PROBE_CASES:
        pr, pm = _pallas_probe(table[:C], rows[:C], packed, valid)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(pr))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(pm))


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_hash_probe_slot_mode_bit_identical(case):
    """vals=None returns the slot index: equal to the reference's
    hashjoin.probe_slots and, on the Pallas subset, to its hash_probe with an
    arange payload (interpret mode)."""
    from trino_tpu.ops.hashjoin import probe_slots as jprobe_slots
    from trino_tpu.types import BIGINT

    table, _, C, packed, valid = _probe_case(case)
    ts, tm = ck.hash_probe(T(table[:C]), None, T(packed), T(valid))
    assert ts.dtype == torch.int32 and tm.dtype == torch.bool
    js, jm = jprobe_slots(jnp.asarray(table), (jnp.asarray(packed),), (BIGINT,),
                          jnp.asarray(valid))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if case in PALLAS_PROBE_CASES:
        ps, pm = _pallas_probe(table[:C], np.arange(C, dtype=np.int32), packed, valid)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ps))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(pm))


_DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.float32, np.float64]


def _compact_inputs(rng, n, frac):
    cols = []
    for dt in _DTYPES:
        if dt == np.bool_:
            cols.append(rng.random(n) < 0.5)
        elif np.issubdtype(dt, np.floating):
            cols.append((rng.normal(size=n) * 1e3).astype(dt))
        else:
            info = np.iinfo(dt)
            cols.append(rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True))
    return cols, rng.random(n) < frac


PALLAS_COMPACT_CASES = ("sparse_bucket", "out_len_below_live_count")
COMPACT_CASES = {
    # name: (n, out_len, valid fraction)
    "empty": (0, 16, 1.0),
    "all_invalid": (500, 64, 0.0),
    "all_valid": (300, 300, 1.0),
    "sparse_bucket": (4096, 256, 0.05),
    "out_len_below_live_count": (1000, 100, 0.6),
    "out_len_above_n": (100, 512, 0.5),
    "ragged": (777, 777, 0.37),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_rows_plain_byte_identical(case):
    n, out_len, frac = COMPACT_CASES[case]
    rng = np.random.default_rng(len(case) + 200)
    cols, valid = _compact_inputs(rng, n, frac)
    arrays = tuple(cols) + (None,)
    xp, xt = jarrays.compact_rows(tuple(jnp.asarray(c) for c in cols) + (None,),
                                  jnp.asarray(valid), out_len)
    tp, ttot = ck.compact_rows(tuple(T(c) for c in cols) + (None,), T(valid), out_len)
    assert tp[-1] is None and len(tp) == len(arrays)
    assert int(ttot) == int(xt) == int(valid.sum())
    for a, b in zip(xp[:-1], tp[:-1]):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == (out_len,)
        assert a.tobytes() == b.numpy().tobytes()
    if case in PALLAS_COMPACT_CASES:
        pp, pt = pk.compact_columns(tuple(jnp.asarray(c) for c in cols),
                                    jnp.asarray(valid), out_len, interpret=True)
        assert int(pt) == int(ttot)
        for a, b in zip(pp, tp[:-1]):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_compact_rows_all_none_passes_through():
    valid = T(np.array([True, False, True]))
    packed, total = ck.compact_rows((None, None), valid, 2)
    assert packed == (None, None) and int(total) == 2


SEGMENT_CASES = {
    # name: (n, n_slots, k value columns, valid fraction)
    "reference_case": (10000, 8, 2, 0.8),   # tests/test_pallas_kernels.py's shape
    "no_values": (3000, 4, 0, 0.8),
    "n_not_a_multiple_of_2048": (2049 + 777, 16, 3, 0.7),
    "slot_ceiling": (5000, 128, 3, 0.9),
    "all_invalid": (2500, 8, 2, 0.0),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_fused_segment_agg_plain_vs_pallas_interpret(case):
    n, n_slots, k, frac = SEGMENT_CASES[case]
    rng = np.random.default_rng(n + n_slots)
    slot = rng.integers(0, n_slots, n).astype(np.int32)
    valid = rng.random(n) < frac
    vals = [rng.random(n) * 10 ** j - 0.5 for j in range(k)]
    jc, js = pk.fused_segment_agg(jnp.asarray(slot), jnp.asarray(valid),
                                  tuple(jnp.asarray(v) for v in vals), n_slots=n_slots,
                                  interpret=True)
    tc, ts = ck.fused_segment_agg(T(slot), T(valid), tuple(T(v) for v in vals), n_slots)
    assert tc.dtype == torch.int32 and len(ts) == len(js) == k
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for a, b in zip(js, ts):
        assert b.dtype == torch.float32 and b.shape == (n_slots,)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_fused_segment_agg_takes_an_int64_slot_as_int32():
    """An int64 slot at or above 2**31 wraps to int32 before the range test,
    in the reference (``slot.astype(jnp.int32)``) and in both port forms: 2**32
    + 3 lands in slot 3, 2**31 becomes negative and drops."""
    rng = np.random.default_rng(31)
    n, n_slots = 4000, 8
    slot = rng.integers(0, n_slots, n).astype(np.int64)
    slot[::5] += 1 << 32
    slot[1::7] = (1 << 31) + rng.integers(0, n_slots, len(slot[1::7]))
    valid = rng.random(n) < 0.9
    vals = [rng.random(n) * 10 ** j for j in range(2)]
    jc, js = pk.fused_segment_agg(jnp.asarray(slot), jnp.asarray(valid),
                                  tuple(jnp.asarray(v) for v in vals), n_slots=n_slots,
                                  interpret=True)
    assert int(np.asarray(jc).sum()) == int((valid & (slot % (1 << 31) == slot % (1 << 32))
                                             ).sum())
    for fn in (ck.fused_segment_agg, ck.fused_segment_agg_plain):
        tc, ts = fn(T(slot), T(valid), tuple(T(v) for v in vals), n_slots)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        for a, b in zip(js, ts):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_fused_segment_agg_slot_ceiling_raises():
    with pytest.raises(ValueError, match="n_slots=129"):
        ck.fused_segment_agg(torch.zeros(4, dtype=torch.int32),
                             torch.ones(4, dtype=torch.bool), (), 129)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ck.reset_stats()
    rng = np.random.default_rng(9)
    ck.hash_insert(T(np.full(65, EMPTY_KEY, np.int64)), T(_keys(rng, 10, 5)),
                   torch.ones(10, dtype=torch.bool))
    ck.hash_insert_(T(np.full(65, EMPTY_KEY, np.int64)), T(_keys(rng, 10, 5)),
                    torch.ones(10, dtype=torch.bool))
    ck.compact_rows((torch.arange(4),), T(np.array([1, 0, 1, 1], bool)), 4)
    ck.fused_segment_agg(T(np.array([0, 1, 1, 0], np.int32)),
                         T(np.array([1, 0, 1, 1], bool)), (torch.ones(4),), 2)
    assert all(s.launches == 0 for s in ck.STATS.values())


def test_mixed_devices_raise():
    t = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="mixed or unsupported"):
        ck.hash_insert(t, torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool))


def test_build_key_covers_the_shared_hash_header(tmp_path):
    """Each library's build key hashes its source and every header it
    includes: editing csrc/hashing.cuh changes the keys of the insert and
    the probe (so both rebuild) and of nothing else."""
    import os
    import shutil

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(ck.__file__))),
                        "csrc")
    for name in os.listdir(csrc):
        shutil.copy(os.path.join(csrc, name), tmp_path / name)
    sources = sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))
    before = {n: ck.source_digest(str(tmp_path / n)) for n in sources}
    assert before == {n: ck.source_digest(os.path.join(csrc, n)) for n in sources}
    with open(tmp_path / "hashing.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: ck.source_digest(str(tmp_path / n)) for n in sources}
    changed = sorted(n for n in sources if after[n] != before[n])
    assert changed == ["hash_insert.cu", "hash_probe.cu"]
