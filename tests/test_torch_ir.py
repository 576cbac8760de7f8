"""The port's expression evaluator against ``trino_tpu.sql.ir.evaluate``.

Each case builds the same expression tree in both packages' IR and evaluates
it over the same random page (numpy, from a seed, with null masks); values
and null masks must be equal (DOUBLE within rtol 1e-12: the same IEEE
operations in the same order).  The calls are the ones TPC-H Q1, Q3 and Q9
reach (decimal arithmetic, comparisons, AND/OR/NOT, BETWEEN/IN, dictionary
lookup tables, casts, extract(year)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import types as JT
from trino_tpu.sql import ir as JIR
from trino_tpu_torch import types as TT
from trino_tpu_torch.sql import ir as TIR

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 257


def _page(seed):
    rng = np.random.default_rng(seed)
    cols = [
        rng.integers(-10**6, 10**6, size=N, dtype=np.int64),       # 0 a: decimal(15,2)
        rng.integers(0, 11, size=N, dtype=np.int64),               # 1 b: decimal(15,2)
        rng.integers(-800, 11000, size=N, dtype=np.int32),         # 2 d: date
        rng.integers(0, 5, size=N, dtype=np.int32),                # 3 s: varchar ids
        rng.integers(-50, 50, size=N, dtype=np.int32),             # 4 i: integer
        rng.normal(size=N) * 100.0,                                # 5 x: double
        rng.integers(-2**62, 2**62, size=N, dtype=np.int64),       # 6 k: bigint
        rng.random(N) < 0.5,                                       # 7 p: boolean
        rng.random(N) < 0.5,                                       # 8 q: boolean
    ]
    nulls = [rng.random(N) < 0.2 if i in (0, 2, 7) else None for i in range(len(cols))]
    return cols, nulls


def _cases(M, T):
    """name -> expression built in the package (M = ir module, T = types)."""
    D152, D182, D184 = T.DecimalType.of(15, 2), T.DecimalType.of(18, 2), \
        T.DecimalType.of(18, 4)
    V = T.VarcharType.of(10)
    a, b = M.FieldRef(0, D152, "a"), M.FieldRef(1, D152, "b")
    d, s = M.FieldRef(2, T.DATE, "d"), M.FieldRef(3, V, "s")
    i, x = M.FieldRef(4, T.INTEGER, "i"), M.FieldRef(5, T.DOUBLE, "x")
    k, p, q = M.FieldRef(6, T.BIGINT, "k"), M.FieldRef(7, T.BOOLEAN, "p"), \
        M.FieldRef(8, T.BOOLEAN, "q")
    C, Call = M.Constant, M.Call
    one = C(100, D182)
    disc = Call("subtract", (one, Call("cast", (b,), D182)), D182)
    price = Call("multiply", (a, disc), D184)
    return {
        # Q1 / Q3 / Q9 decimal arithmetic
        "disc_price": price,
        "charge": Call("multiply", (price, Call("add", (one, Call("cast", (b,), D182)),
                                                D182)), T.DecimalType.of(18, 6)),
        "amount": Call("subtract", (price, Call("multiply", (b, a), D184)), D184),
        "negate": Call("negate", (a,), D152),
        "divide_decimal": Call("divide", (a, b), D182, (100,)),
        "divide_integer": Call("divide", (i, C(7, T.INTEGER)), T.INTEGER),
        "divide_integer_by_column": Call("divide", (C(1000, T.INTEGER), i), T.INTEGER),
        "divide_double": Call("divide", (x, Call("cast", (i,), T.DOUBLE)), T.DOUBLE),
        "rescale_up": Call("rescale", (a,), D184, (2,)),
        "rescale_down": Call("rescale", (a,), T.DecimalType.of(15, 0), (-2,)),
        "cast_dec_down": Call("cast", (a,), T.DecimalType.of(15, 1)),
        "cast_int_to_dec": Call("cast", (i,), D182),
        "cast_double_to_dec": Call("cast", (x,), D182),
        "cast_dec_to_double": Call("cast", (a,), T.DOUBLE),
        "cast_dec_to_int": Call("cast", (a,), T.BIGINT),
        "cast_int_to_bigint": Call("cast", (i,), T.BIGINT),
        "int_times_wide_constant": Call("multiply", (i, C(2**40, T.BIGINT)), T.BIGINT),
        # comparisons, date filters, dictionary predicates
        "lte_date": Call("lte", (d, C(10471, T.DATE)), T.BOOLEAN),
        "lt_date": Call("lt", (d, C(9204, T.DATE)), T.BOOLEAN),
        "gt_date": Call("gt", (d, C(9204, T.DATE)), T.BOOLEAN),
        "gte_bigint": Call("gte", (k, C(-5, T.BIGINT)), T.BOOLEAN),
        "eq_dict": Call("eq", (s, C(1, V)), T.BOOLEAN),
        "neq_dict": Call("neq", (s, C(1, V)), T.BOOLEAN),
        "int_vs_wide_constant": Call("lt", (i, C(2**40, T.BIGINT)), T.BOOLEAN),
        "between": Call("between", (d, C(9000, T.DATE), C(9500, T.DATE)), T.BOOLEAN),
        "in": Call("in", (s, C(1, V), C(3, V)), T.BOOLEAN),
        "lut": Call("lut", (s, C(np.array([True, False, True, False, True]), T.BOOLEAN)),
                    T.BOOLEAN),
        "and_3vl": Call("and", (Call("lte", (d, C(9000, T.DATE)), T.BOOLEAN), p),
                        T.BOOLEAN),
        "or_3vl": Call("or", (p, Call("gt", (a, C(0, D152)), T.BOOLEAN)), T.BOOLEAN),
        "and_plain": Call("and", (q, Call("eq", (s, C(2, V)), T.BOOLEAN)), T.BOOLEAN),
        "not": Call("not", (p,), T.BOOLEAN),
        # extract(year) (Q9)
        "extract_year": Call("extract_year", (d,), T.BIGINT),
        "null_constant": Call("add", (a, C(None, D152)), D152),
    }


CASES = sorted(_cases(JIR, JT))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_equal(name, seed):
    cols, nulls = _page(seed)
    je = _cases(JIR, JT)[name]
    te = _cases(TIR, TT)[name]
    jv, jn = JIR.evaluate(je, [jnp.asarray(c) for c in cols],
                          [None if m is None else jnp.asarray(m) for m in nulls])
    tv, tn = TIR.evaluate(te, [torch.as_tensor(c) for c in cols],
                          [None if m is None else torch.as_tensor(m) for m in nulls])
    jv = np.broadcast_to(np.asarray(jv), (N,))
    tv = np.broadcast_to(tv.numpy(), (N,))
    assert jv.dtype == tv.dtype, (jv.dtype, tv.dtype)
    if jv.dtype.kind == "f":
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(tv, jv)
    assert (jn is None) == (tn is None)
    if jn is not None:
        np.testing.assert_array_equal(np.broadcast_to(tn.numpy(), (N,)),
                                      np.broadcast_to(np.asarray(jn), (N,)))


def test_predicate_equal():
    cols, nulls = _page(5)
    je = _cases(JIR, JT)["and_3vl"]
    te = _cases(TIR, TT)["and_3vl"]
    base = np.random.default_rng(5).random(N) < 0.7
    jk = JIR.evaluate_predicate(je, [jnp.asarray(c) for c in cols],
                                [None if m is None else jnp.asarray(m) for m in nulls],
                                jnp.asarray(base))
    tk = TIR.evaluate_predicate(te, [torch.as_tensor(c) for c in cols],
                                [None if m is None else torch.as_tensor(m) for m in nulls],
                                torch.as_tensor(base))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_unported_call_raises_naming_it():
    # every scalar call is ported, the array, map and span calls too: an
    # unknown call raises naming it
    x = TIR.FieldRef(0, TT.BIGINT, "x")
    span = torch.tensor([(1 << 24) | 2, 3, 0], dtype=torch.int64)  # [7, 9], [1, 7, 9], []
    heap = TIR.Constant(np.array([1, 7, 9], np.int64), TT.UNKNOWN)
    v, nulls = TIR.evaluate(TIR.Call("array_get", (x, TIR.Constant(2, TT.BIGINT), heap),
                                     TT.BIGINT), [span], [None])
    assert v.tolist()[:2] == [9, 7] and nulls.tolist() == [False, False, True]
    with pytest.raises(NotImplementedError, match="'no_such_op'"):
        TIR.evaluate(TIR.Call("no_such_op", (x,), TT.BIGINT),
                     [torch.ones(3, dtype=torch.int64)], [None])
