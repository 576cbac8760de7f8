"""The port's arrays, maps and UNNEST against the JAX package.

Statement level: the SQL of tests/test_arrays.py, test_arrays2.py and
test_array_lambdas.py, of the array- and map-valued aggregates of
test_agg_functions2.py (test_array_agg, test_array_agg_strings,
test_histogram, test_map_agg) and test_functions_stats.py
(test_approx_most_frequent, test_reduce_family), and of
test_functions_ext2.py::test_split_family, restated as parametrised cases
(``chip_smoke.ARRAY_CASES`` over ``chip_smoke.ARRAY_SETUP``'s memory tables,
which phase 10a also runs on the card), run in both packages
(``trino_tpu.Engine`` and ``trino_tpu_torch.Engine(device="cpu")``) over
TPC-H at SF0.01 (``tpchs``: splits of 2^13 rows) and a memory catalog.
Outcomes must agree under the port's parity rules (``run_both`` of
``tests/test_torch_dml.py``: integers, dates and strings exactly, DOUBLE
within rtol 1e-9, row order where the statement orders its rows, errors of
the same type and message; array and map columns also as their decoded
lists and dicts).  The statements the reference refuses (CTAS
of an array-valued query, element calls and UNNEST over an ``array_agg``
result) are cases too: both packages raise alike.

test_arrays.py::test_array_type_ddl_roundtrip is restated in
tests/test_torch_parity_edges.py.

Op level: each of the 12 array, map and span calls of ``sql/ir.py`` built in
both packages' IR and evaluated over the same numpy-seeded spans and heaps,
empty heaps, NULL spans and negative ``slice`` starts included, equal
exactly (DOUBLE within rtol 1e-9); ``ops/arrays.unnest_indices`` against the
reference's on random lengths with zeros.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import Engine as JaxEngine
from trino_tpu import types as JT
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.ops import arrays as JA
from trino_tpu.sql import ir as JIR
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch import types as TT
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from trino_tpu_torch.ops import arrays as TA
from trino_tpu_torch.sql import ir as TIR
from test_torch_dml import run_both

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import ARRAY_CASES, ARRAY_SETUP  # noqa: E402  (no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def engines():
    j, t = JaxEngine(), TorchEngine(device="cpu")
    for e, tpch, mem in ((j, JaxTpch, JaxMemory), (t, TorchTpch, TorchMemory)):
        e.register_catalog("tpch", tpch(sf=0.01))
        e.register_catalog("tpchs", tpch(sf=0.01, split_rows=1 << 13))
        e.register_catalog("mem", mem())
    sessions = {c: (j.create_session(c), t.create_session(c))
                for c in ("tpch", "tpchs", "mem")}
    for sql in ARRAY_SETUP:
        run_both(j, t, sql, *sessions["mem"])
    return j, t, sessions


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_statement_equal(engines, case):
    j, t, sessions = engines
    catalog, sql = ARRAY_CASES[case]
    run_both(j, t, sql, *sessions[catalog])


def test_connector_append_of_python_lists(engines):
    """tests/test_arrays.py::test_storage_arrays_and_lateral_unnest's direct
    ``append`` of python lists (None = NULL, [] empty), read back alike."""
    j, t, sessions = engines
    for e, s in zip((j, t), sessions["mem"]):
        e.execute_sql("create table apl (id bigint, tags array(varchar), nums array(bigint))", s)
        e.catalogs["mem"].append("apl", [[1, 2, 3], [["red", "blue"], ["blue"], None],
                                         [[10, 20], [30], []]])
    for sql in ("select id, tags, nums from apl order by id",
                "select t.id, u.tag from apl t cross join unnest(t.tags) u(tag) "
                "order by id, tag",
                "select sum(n) sn, count(*) c from apl cross join unnest(nums) u(n)"):
        run_both(j, t, sql, *sessions["mem"])
    assert t.execute_sql("select id, tags, nums from apl order by id",
                         sessions["mem"][1]).rows() == [
        (1, ["red", "blue"], [10, 20]), (2, ["blue"], [30]), (3, None, [])]


def test_heap_is_copied_once_per_query(engines, monkeypatch):
    """Two element calls over one stored heap, over pages of 2 rows: the heap
    reaches the device once in the query (``h2d_bytes``), not once per page
    or per call."""
    import trino_tpu_torch.connectors.memory as tm

    _, t, sessions = engines
    s = sessions["mem"][1]
    t.execute_sql("create table hp (id bigint, xs array(bigint))", s)
    t.execute_sql("insert into hp values " + ", ".join(
        f"({i}, array[{i}, {i + 1}, {i + 2}])" for i in range(9)), s)
    monkeypatch.setattr(tm, "SPLIT_ROWS", 2)
    r = t.execute_sql("select id, contains(xs, 4) c, element_at(xs, 2) e from hp "
                      "order by id", s)
    assert [x[2] for x in r.rows()] == list(range(1, 10))
    # the statement runs as a plan template whose two literals are bound
    # slots: each reaches the device once too, its value and a null flag
    c = t.last_query_counters
    assert c["plan_template_misses"] == 1
    assert c["h2d_bytes"] == 27 * 8 + 2 * (4 + 1)


# -- the IR calls ------------------------------------------------------------------------


N = 64


def _heap_case(seed, heap_len, null_spans=True):
    """(spans, span NULL mask, heap) with spans inside a heap of heap_len."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, N)
    lens[:4] = 0
    starts = rng.integers(0, max(heap_len - 5, 1), N)
    if heap_len == 0:
        lens[:], starts[:] = 0, 0
    spans = (starts.astype(np.int64) << 24) | lens
    nulls = (rng.random(N) < 0.15) if null_spans else None
    heap = rng.integers(-4, 5, heap_len).astype(np.int64)
    return spans, nulls, heap


def _cases(ir, T, heap, heap_b, fheap, body):
    """op name -> expression over channels 0 (spans), 1 (index / needle),
    2 (spans b), 3 (slice start), 4 (slice length)."""
    A = T.ArrayType.of(T.BIGINT)
    s, k = ir.FieldRef(0, A), ir.FieldRef(1, T.BIGINT)
    s2 = ir.FieldRef(2, A)
    h = ir.Constant(heap, T.UNKNOWN)
    L = 6
    excl = np.concatenate([[0], np.cumsum(heap > 0)]).astype(np.int64)
    return {
        "span_len": ir.Call("span_len", (s,), T.BIGINT),
        "span_id": ir.Call("span_id", (s,), A),
        "span_filter": ir.Call("span_filter", (s, ir.Constant(excl, T.UNKNOWN)), A),
        "span_slice": ir.Call("span_slice", (s, ir.FieldRef(3, T.BIGINT),
                                             ir.FieldRef(4, T.BIGINT)), A),
        "span_trim": ir.Call("span_trim", (s, ir.FieldRef(4, T.BIGINT)), A),
        "arrays_overlap": ir.Call("arrays_overlap",
                                  (s, s2, h, ir.Constant(heap_b, T.UNKNOWN)), T.BOOLEAN,
                                  meta=(L, L)),
        "span_reduce_lambda": ir.Call("span_reduce_lambda",
                                      (s, ir.Constant(3, T.BIGINT), h), T.BIGINT,
                                      meta=(L, body)),
        "array_get": ir.Call("array_get", (s, k, h), T.BIGINT),
        "array_contains": ir.Call("array_contains", (s, k, h), T.BOOLEAN, meta=(L,)),
        "array_reduce_sum": ir.Call("array_reduce", (s, h), T.BIGINT, meta=(L, "sum")),
        "array_reduce_avg": ir.Call("array_reduce", (s, h), T.DOUBLE, meta=(L, "avg")),
        "array_reduce_min": ir.Call("array_reduce", (s, h), T.BIGINT, meta=(L, "min")),
        "array_reduce_max_double": ir.Call("array_reduce", (s, ir.Constant(fheap, T.UNKNOWN)),
                                           T.DOUBLE, meta=(L, "max")),
        "array_position": ir.Call("array_position", (s, k, h), T.BIGINT, meta=(L,)),
        "map_get": ir.Call("map_get", (s, k, h, ir.Constant(fheap, T.UNKNOWN)), T.DOUBLE,
                           meta=(L,)),
    }


def _body(ir, T):
    """The reduce combiner (s, x) -> s * 2 + x over channels [state, element]."""
    return ir.Call("add", (ir.Call("multiply", (ir.FieldRef(0, T.BIGINT),
                                                ir.Constant(2, T.BIGINT)), T.BIGINT),
                           ir.FieldRef(1, T.BIGINT)), T.BIGINT)


OPS = sorted(_cases(TIR, TT, np.zeros(1, np.int64), np.zeros(1, np.int64),
                    np.zeros(1), None))


@pytest.mark.parametrize("heap_len", [0, 40])
@pytest.mark.parametrize("op", OPS)
def test_op_equals_the_reference(op, heap_len):
    spans, nulls, heap = _heap_case(1, heap_len)
    spans_b, _, heap_b = _heap_case(2, heap_len, null_spans=False)
    rng = np.random.default_rng(3)
    fheap = rng.normal(size=heap_len)
    k = rng.integers(-2, 7, N).astype(np.int64)
    start = rng.choice([-7, -3, -1, 0, 1, 2, 5], N).astype(np.int64)
    length = rng.integers(-1, 5, N).astype(np.int64)
    cols = [spans, k, spans_b, start, length]
    masks = [nulls, None, None, None, None]
    je = _cases(JIR, JT, heap, heap_b, fheap, _body(JIR, JT))[op]
    te = _cases(TIR, TT, heap, heap_b, fheap, _body(TIR, TT))[op]
    jv, jn = JIR.evaluate(je, [jnp.asarray(c) for c in cols],
                          [None if m is None else jnp.asarray(m) for m in masks])
    tv, tn = TIR.evaluate(te, [torch.as_tensor(c) for c in cols],
                          [None if m is None else torch.as_tensor(m) for m in masks])
    jv = np.broadcast_to(np.asarray(jv), (N,))
    tv = np.broadcast_to(tv.numpy(), (N,))
    jn = np.zeros(N, bool) if jn is None else np.broadcast_to(np.asarray(jn), (N,))
    tn = np.zeros(N, bool) if tn is None else np.broadcast_to(tn.numpy(), (N,))
    np.testing.assert_array_equal(tn, jn)
    live = ~jn
    if np.issubdtype(jv.dtype, np.floating):
        np.testing.assert_allclose(tv[live], jv[live], rtol=1e-9, atol=0)
    else:
        assert tv.dtype == jv.dtype, (tv.dtype, jv.dtype)
        np.testing.assert_array_equal(tv[live], jv[live])


@pytest.mark.parametrize("op", ["array_contains", "array_reduce_sum", "array_position",
                                "map_get", "arrays_overlap"])
def test_op_over_a_literal_array_equals_the_reference(op):
    """The calls over one constant span (an array literal): scalar results."""
    rng = np.random.default_rng(4)
    heap = rng.integers(-3, 4, 5).astype(np.int64)
    fheap = rng.normal(size=5)
    span = (1 << 24) | 4  # elements 1..4

    def expr(ir, T):
        e = _cases(ir, T, heap, heap, fheap, None)[op]
        c = ir.Constant(span, T.ArrayType.of(T.BIGINT))
        args = (c,) + tuple(ir.Constant(2, T.BIGINT) if a == ir.FieldRef(1, T.BIGINT)
                            else c if isinstance(a, ir.FieldRef) else a for a in e.args[1:])
        return ir.Call(e.op, args, e.type, e.meta)

    jv, jn = JIR.evaluate(expr(JIR, JT), [], [])
    tv, tn = TIR.evaluate(expr(TIR, TT), [], [])
    assert np.asarray(jv).shape == tuple(tv.shape) == ()
    np.testing.assert_allclose(tv.numpy().astype(np.float64),
                               np.asarray(jv).astype(np.float64), rtol=1e-9)
    assert (jn is None) == (tn is None) or not np.asarray(jn).any()
    if tn is not None and jn is not None:
        assert bool(np.asarray(jn).reshape(-1)[0]) == bool(tn.reshape(-1)[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unnest_indices_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5, 50).astype(np.int64)
    lens[rng.random(50) < 0.3] = 0
    total = 1 << max(int(lens.sum()) - 1, 1).bit_length()
    jr, jo, jin = (np.asarray(x) for x in JA.unnest_indices(jnp.asarray(lens), total))
    tr, to, tin = (x.numpy() for x in TA.unnest_indices(torch.as_tensor(lens), total))
    np.testing.assert_array_equal(tin, jin)
    np.testing.assert_array_equal(tr[tin], jr[jin])
    np.testing.assert_array_equal(to[tin], jo[jin])
    assert tr.dtype == jr.dtype and to.dtype == jo.dtype
    assert int(tin.sum()) == int(lens.sum())


def test_encode_arrays_equals_the_reference():
    rows = [[3, 1], None, [], [7], None, [2, 2, 2]]
    for a, b in zip(JA.encode_arrays(rows, np.int64), TA.encode_arrays(rows, np.int64)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
