"""The port's scalar function library against the JAX package.

Op level, in the manner of ``tests/test_torch_ir.py``: each scalar call of
``trino_tpu/sql/ir.py`` but the array, map and span calls (held in
``tests/test_torch_arrays.py``) is built in both packages' IR and evaluated
over the same seeded numpy page with null masks.  Values and null masks must
be equal: integers, booleans, dates and
timestamps exactly, DOUBLE within rtol 1e-12 (the same IEEE operations),
except where ``RTOL`` states another tolerance, ten times the largest
error measured at these inputs: the functions whose torch and XLA
implementations are different approximations (``beta_cdf``, a continued
fraction against XLA's, 9.8e-14; ``cbrt``, ``pow`` and a Newton step
against a native cube root, 1.3e-14; ``normal_cdf`` and
``inverse_normal_cdf``, erf/erfc and rational approximations, 3.0e-12 and
2.4e-13), and ``ATOL`` an absolute one where XLA flushes subnormal
results to zero.

Statement level: the SQL of tests/test_scalar_functions.py,
test_functions_ext.py, test_functions_ext2.py, test_functions_stats.py,
test_spatial.py and test_parametric_types.py, restated as parametrised
cases (``chip_smoke.FUNCTION_CASES``, which phase 9 also runs on the card)
over TPC-H at SF0.01 and over memory tables, runs in both packages
(``trino_tpu.Engine`` and ``trino_tpu_torch.Engine(device="cpu")``).  Their
outcomes must agree under the port's parity rules (``run_both`` of
``tests/test_torch_dml.py``): integer, decimal, date, timestamp and string
columns exactly, DOUBLE within rtol 1e-9, row order where the statement
orders its rows, errors of the same type with the same message.  The calls
that read the clock (``now()``, ``current_timestamp()``) are held to a
timestamp of this century in both packages
(``test_clock_functions_are_timestamps``), not to equal values.

Statements of those files that wait for other parts of the port are left
out, by the name of their test:
- arrays and maps, held by ``tests/test_torch_arrays.py``:
  test_functions_ext2.py::test_split_family,
  test_functions_stats.py::test_reduce_family and
  test_functions_stats.py::test_approx_most_frequent;
- SHOW FUNCTIONS (A6): test_functions_ext.py::test_show_functions_lists_new_families,
  test_functions_stats.py::test_show_functions_lists_new_families;
- nothing here waits for A5 or A7.
The plan check of test_spatial.py::test_spatial_join_plan_uses_grid and the
parser check of test_parametric_types.py::test_pre_epoch_fractional_literal
are restated as tests of both packages' planner and literal parser.
"""

import datetime
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import Engine as JaxEngine
from trino_tpu import types as JT
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.sql import ir as JIR
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch import types as TT
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.sql import ir as TIR
from test_torch_dml import run_both

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import FUNCTION_CASES, FUNCTION_SETUP  # noqa: E402  (imports no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 301


# -- op level ----------------------------------------------------------------------------


def _page(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N) * 50.0
    x[:12] = [0.5, -0.5, 1.5, -2.5, 0.0, -0.0, 27.0, -8.0, 1e-300, 2.5, np.nan, np.inf]
    cols = [
        x,                                                          # 0 x: double
        rng.normal(size=N) * 3.0,                                   # 1 y: double
        rng.integers(-2**40, 2**40, size=N, dtype=np.int64),        # 2 k: bigint
        rng.integers(-9, 10, size=N, dtype=np.int64),               # 3 j: bigint (small)
        rng.integers(-3, 70, size=N, dtype=np.int64),               # 4 sh: shift count
        rng.integers(-30000, 30000, size=N, dtype=np.int32),        # 5 d: date
        rng.integers(-2**52, 2**52, size=N, dtype=np.int64),        # 6 t6: timestamp(6)
        rng.integers(-2**42, 2**42, size=N, dtype=np.int64),        # 7 t3: timestamp(3)
        rng.integers(0, 6, size=N, dtype=np.int32),                 # 8 s: varchar ids
        rng.random(N),                                              # 9 p: double in [0, 1)
        rng.random(N) * 5.0 + 0.05,                                 # 10 a: double > 0
        rng.random(N) * 5.0 + 0.05,                                 # 11 b: double > 0
        rng.integers(0, 100, size=N, dtype=np.int64),               # 12 succ
        rng.integers(100, 200, size=N, dtype=np.int64),             # 13 trials
        rng.random(N) < 0.3,                                        # 14 flag: boolean
        rng.integers(-10**6, 10**6, size=N, dtype=np.int64),        # 15 m: decimal(15,2)
        rng.integers(-200, 200, size=N, dtype=np.int64),            # 16 sh8: bit_count input
        rng.integers(-2, 20, size=N, dtype=np.int32),               # 17 i: integer
    ]
    cols[1][:3] = [0.5, -0.5, 0.0]
    cols[3][:4] = [0, -7, 7, 3]
    nulls = [rng.random(N) < 0.15 if i in (0, 2, 5, 6, 9, 17) else None
             for i in range(len(cols))]
    return cols, nulls


def _op_cases(M, T):
    """name -> expression built in the package (M = ir module, T = types)."""
    D152 = T.DecimalType.of(15, 2)
    TS6, TS3 = T.TimestampType.of(6), T.TimestampType.of(3)
    V = T.VarcharType.of(10)
    DBL, BIG, DATE, BOOL, INT = T.DOUBLE, T.BIGINT, T.DATE, T.BOOLEAN, T.INTEGER
    f = {n: M.FieldRef(i, t, n) for i, (n, t) in enumerate((
        ("x", DBL), ("y", DBL), ("k", BIG), ("j", BIG), ("sh", BIG), ("d", DATE),
        ("t6", TS6), ("t3", TS3), ("s", V), ("p", DBL), ("a", DBL), ("b", DBL),
        ("succ", BIG), ("trials", BIG), ("flag", BOOL), ("m", D152), ("sh8", BIG),
        ("i", INT)))}
    C, Call = M.Constant, M.Call
    x, y, k, j, d = f["x"], f["y"], f["k"], f["j"], f["d"]
    cases = {
        # NULL handling
        "lut_nullable": Call("lut_nullable", (f["s"], C(np.arange(6, dtype=np.int64) * 7, BIG),
                                              C(np.array([0, 1, 0, 0, 1, 0], bool), BOOL)),
                             BIG),
        "nullif_int": Call("nullif", (f["i"], C(3, INT)), INT),
        "nullif_double": Call("nullif", (x, y), DBL),
        "nullif_null_second": Call("nullif", (j, f["k"]), BIG),
        "null_if_flag": Call("null_if_flag", (k, f["flag"]), BIG),
        # unary math
        **{f"{op}_double": Call(op, (x,), DBL) for op in (
            "floor", "ceil", "sqrt", "exp", "ln", "log10", "log2", "round", "sign", "trunc",
            "cbrt", "degrees", "radians", "sin", "cos", "tan", "asin", "acos", "atan",
            "sinh", "cosh", "tanh")},
        **{f"{op}_unit": Call(op, (f["p"],), DBL) for op in ("asin", "acos", "atan", "ln")},
        **{f"{op}_bigint": Call(op, (j,), BIG) for op in ("floor", "ceil", "sign", "trunc",
                                                          "round")},
        "sqrt_bigint": Call("sqrt", (j,), DBL),
        "sign_decimal": Call("sign", (f["m"],), D152),  # the raw sign (ROADMAP C)
        "log_b": Call("log_b", (f["a"], f["b"]), DBL),
        "is_nan": Call("is_nan", (x,), BOOL),
        "is_finite": Call("is_finite", (x,), BOOL),
        "is_infinite": Call("is_infinite", (x,), BOOL),
        # binary math
        "modulus_bigint": Call("modulus", (k, j), BIG),  # the divisor's sign (ROADMAP C)
        "modulus_double": Call("modulus", (x, y), DBL),
        "modulus_int_by_constant": Call("modulus", (f["i"], C(-3, INT)), INT),
        "power": Call("power", (f["a"], y), DBL),
        "power_negative_base": Call("power", (x, C(3.0, DBL)), DBL),
        "atan2": Call("atan2", (x, y), DBL),
        "round_n": Call("round_n", (x,), DBL, (2,)),
        "round_n_negative": Call("round_n", (x,), DBL, (-1,)),
        "truncate_n": Call("truncate_n", (x,), DBL, (2,)),
        "greatest": Call("greatest", (x, y, C(1.0, DBL)), DBL),
        "least": Call("least", (k, j), BIG),
        "width_bucket": Call("width_bucket", (x, C(-50.0, DBL), C(50.0, DBL), C(10, BIG)),
                             BIG),
        "width_bucket_equal_bounds": Call("width_bucket", (y, C(1.0, DBL), C(1.0, DBL),
                                                           C(4, BIG)), BIG),
        # bitwise
        "bitwise_and": Call("bitwise_and", (k, j), BIG),
        "bitwise_or": Call("bitwise_or", (k, j), BIG),
        "bitwise_xor": Call("bitwise_xor", (k, j), BIG),
        "bitwise_not": Call("bitwise_not", (k,), BIG),
        "bitwise_left_shift": Call("bitwise_left_shift", (k, f["sh"]), BIG),
        "bitwise_right_shift": Call("bitwise_right_shift", (k, f["sh"]), BIG),
        "bitwise_right_shift_arithmetic": Call("bitwise_right_shift_arithmetic",
                                               (k, f["sh"]), BIG),
        "bit_count_64": Call("bit_count", (k,), BIG, (64,)),
        "bit_count_8": Call("bit_count", (f["sh8"],), BIG, (8,)),
        # dates
        "extract_month": Call("extract_month", (d,), BIG),
        "extract_day": Call("extract_day", (d,), BIG),
        "extract_quarter": Call("extract_quarter", (d,), BIG),
        **{f"date_add_{u}": Call("date_add_unit", (j, d), DATE, (u,))
           for u in ("day", "week", "month", "year")},
        **{f"date_diff_{u}": Call("date_diff_unit", (d, Call("date_add_unit", (
            f["sh"], d), DATE, ("day",))), BIG, (u,)) for u in ("day", "week", "month", "year")},
        **{f"date_trunc_{u}": Call(f"date_trunc_{u}", (d,), DATE)
           for u in ("year", "quarter", "month", "week", "day")},
        "day_of_week": Call("day_of_week", (d,), BIG),
        "day_of_year": Call("day_of_year", (d,), BIG),
        "last_day_of_month": Call("last_day_of_month", (d,), DATE),
        "week_of_year": Call("week_of_year", (d,), BIG),
        "year_of_week": Call("year_of_week", (d,), BIG),
        # timestamps
        **{f"ts_extract_{part}_{p}": Call("ts_extract", (f[f"t{p}"],), BIG, (part, p))
           for part in ("hour", "minute", "second", "millisecond", "year", "month", "day",
                        "quarter") for p in (3, 6)},
        "ts_to_date": Call("ts_to_date", (f["t6"],), DATE, (6,)),
        "as_timestamp": Call("as_timestamp", (Call("multiply", (x, C(1e6, DBL)), DBL),), TS3),
        "cast_ts6_to_ts3": Call("cast", (f["t6"],), TS3),
        "cast_ts3_to_ts6": Call("cast", (f["t3"],), TS6),
        "cast_ts6_to_ts0": Call("cast", (f["t6"],), T.TimestampType.of(0)),
        "cast_date_to_ts6": Call("cast", (d,), TS6),
        "cast_ts3_to_date": Call("cast", (f["t3"],), DATE),
        # statistics and spatial
        "normal_cdf": Call("normal_cdf", (y, f["a"], x), DBL),
        "inverse_normal_cdf": Call("inverse_normal_cdf", (y, f["a"], f["p"]), DBL),
        "beta_cdf": Call("beta_cdf", (f["a"], f["b"], f["p"]), DBL),
        "wilson_interval_lower": Call("wilson_interval_lower", (f["succ"], f["trials"],
                                                                C(1.96, DBL)), DBL),
        "wilson_interval_upper": Call("wilson_interval_upper", (f["succ"], f["trials"],
                                                                C(1.96, DBL)), DBL),
        "st_distance": Call("st_distance", (x, y, f["a"], f["b"]), DBL),
        "hash": Call("hash", (k,), BIG),
        "hash_two_columns": Call("hash", (f["s"], x), BIG),
        # ported before this slice; here so that every call has a case
        "abs": Call("abs", (x,), DBL),
        "coalesce": Call("coalesce", (f["i"], C(None, INT), C(-1, INT)), INT),
        "if": Call("if", (f["flag"], x, y), DBL),
        "is_null": Call("is_null", (k,), BOOL),
        "in_array": Call("in_array", (j, C(np.array([-7, 0, 3, 8], np.int64), BIG)), BOOL),
    }
    return cases


OP_CASES = sorted(_op_cases(JIR, JT))

# tolerances other than rtol 1e-12 (see the module docstring); each was
# measured at these inputs and holds with a margin of ~10x
RTOL = {"beta_cdf": 1e-12, "cbrt_double": 1e-13, "inverse_normal_cdf": 3e-12,
        "normal_cdf": 3e-11}
# XLA on the CPU flushes subnormal results to zero; torch keeps them
ATOL = {"normal_cdf": 1e-300}


def _eval_both(name, seed):
    cols, nulls = _page(seed)
    jv, jn = JIR.evaluate(_op_cases(JIR, JT)[name], [jnp.asarray(c) for c in cols],
                          [None if m is None else jnp.asarray(m) for m in nulls])
    tv, tn = TIR.evaluate(_op_cases(TIR, TT)[name], [torch.as_tensor(c) for c in cols],
                          [None if m is None else torch.as_tensor(m) for m in nulls])
    jv = np.broadcast_to(np.asarray(jv), (N,))
    tv = np.broadcast_to(tv.numpy(), (N,))
    jn = None if jn is None else np.broadcast_to(np.asarray(jn), (N,))
    tn = None if tn is None else np.broadcast_to(tn.numpy(), (N,))
    return jv, jn, tv, tn


@pytest.mark.parametrize("name", OP_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_op_equal(name, seed):
    jv, jn, tv, tn = _eval_both(name, seed)
    assert jv.dtype == tv.dtype, (jv.dtype, tv.dtype)
    live = np.ones(N, bool) if jn is None else ~jn
    if jv.dtype.kind == "f":
        np.testing.assert_allclose(tv[live], jv[live], rtol=RTOL.get(name, 1e-12),
                                   atol=ATOL.get(name, 0))
    else:
        np.testing.assert_array_equal(tv[live], jv[live])
    assert (jn is None) == (tn is None)
    if jn is not None:
        np.testing.assert_array_equal(tn, jn)


def _calls(expr, acc):
    if isinstance(expr, TIR.Call):
        acc.add(expr.op)
        for a in expr.args:
            _calls(a, acc)
    return acc


def test_every_reference_call_has_a_case_or_waits_for_a4():
    """Every call ``trino_tpu.sql.ir._eval_call`` names is evaluated above,
    in tests/test_torch_ir.py, or (the array, map and span calls, which no
    longer wait for A4) in tests/test_torch_arrays.py."""
    import inspect
    import re

    import test_torch_arrays
    import test_torch_ir

    body = inspect.getsource(JIR._eval_call)
    ref = set(re.findall(r'op == "(\w+)"', body))
    for group in re.findall(r"op in \(([^)]*)\)", body, re.S):
        ref |= set(re.findall(r'"(\w+)"', group))
    ref |= set(JIR._ARITH) | set(JIR._CMP)
    cased = set()
    heap = np.zeros(1, np.int64)
    arrays = test_torch_arrays._cases(TIR, TT, heap, heap, heap, None)
    for e in (list(_op_cases(TIR, TT).values()) + list(test_torch_ir._cases(TIR, TT).values())
              + list(arrays.values())):
        _calls(e, cased)
    assert ref - cased == set()
    assert {e.op for e in arrays.values()} == set(TIR._ARRAY_OPS)


def test_exact_values_the_approximations_must_keep():
    """cbrt of a cube is exact; round is half away from zero; the logical
    right shift zero-fills; bit_count counts the low bits of negatives."""
    def ev(op, vals, t, meta=()):
        v = torch.as_tensor(np.asarray(vals))
        out, _ = TIR.evaluate(TIR.Call(op, (TIR.FieldRef(0, t),), t, meta), [v], [None])
        return out.tolist()

    assert ev("cbrt", [27.0, -8.0, 1e-300, 0.0], TT.DOUBLE)[:3] == [3.0, -2.0, 1e-100]
    assert ev("round", [2.5, -2.5, 0.5, -0.49], TT.DOUBLE) == [3.0, -3.0, 1.0, -0.0]
    assert ev("bit_count", [-1, 255], TT.BIGINT, (64,)) == [64, 8]
    x = TIR.FieldRef(0, TT.BIGINT)
    out, _ = TIR.evaluate(TIR.Call("bitwise_right_shift", (x, TIR.Constant(1, TT.BIGINT)),
                                   TT.BIGINT), [torch.tensor([-8])], [None])
    assert out.tolist() == [(2**64 - 8) >> 1]


# -- statement level ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tpch_sf001):
    from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

    j, t = JaxEngine(), TorchEngine(device="cpu")
    j.register_catalog("tpch", tpch_sf001)
    t.register_catalog("tpch", TorchTpch(sf=0.01))
    j.register_catalog("mem", JaxMemory())
    t.register_catalog("mem", TorchMemory())
    sessions = {c: (j.create_session(c), t.create_session(c)) for c in ("tpch", "mem")}
    for sql in FUNCTION_SETUP:
        run_both(j, t, sql, *sessions["mem"])
    return j, t, sessions


@pytest.mark.parametrize("case", sorted(FUNCTION_CASES))
def test_statement_equal(engines, case):
    j, t, sessions = engines
    catalog, sql = FUNCTION_CASES[case]
    run_both(j, t, sql, *sessions[catalog])


def test_timestamp_result_decodes(engines):
    """Timestamps reach the surface as datetime64 (us up to p = 6), NULLs as
    None, in both packages: timestamp(3) and timestamp(6), a value before
    the epoch, a NULL and ``ts + interval``."""
    j, t, sessions = engines
    sql = ("select ts, t3, ts + interval '1' day p from ev "
           "where ts < timestamp '2000-01-01 00:00:00' or ts is null order by ts nulls last")
    for e, s in zip((j, t), sessions["mem"]):
        r = e.execute_sql(sql, s)
        assert r.rows() == [
            (datetime.datetime(1969, 7, 20, 20, 17, 40, 1),
             datetime.datetime(1969, 12, 31, 23, 59, 59, 999000),
             datetime.datetime(1969, 7, 21, 20, 17, 40, 1)),
            (None, None, None)]
        r = e.execute_sql("select ts from ev where ts is not null order by ts", s)
        assert r.columns[0].dtype == np.dtype("datetime64[us]")
        assert str(r.columns[0][0]) == "1969-07-20T20:17:40.000001"


def test_clock_functions_are_timestamps(engines):
    """now() and current_timestamp read the clock: both packages give a
    timestamp of this century, not its raw epoch units."""
    j, t, sessions = engines
    for e, s in zip((j, t), sessions["mem"]):
        for sql in ("select now()", "select current_timestamp()"):
            v = e.execute_sql(sql, s).rows()[0][0]
            assert str(v).startswith("20"), (sql, v)


def test_array_calls_still_raise_naming_a4(engines):
    # the array calls no longer wait for A4: they equal the reference
    j, t, sessions = engines
    run_both(j, t, "select cardinality(split(s, '/')) from t", *sessions["mem"])


def test_spatial_join_plans_alike(engines):
    """A distance-radius predicate over a cross join becomes a grid join in
    both planners: a UNION ALL of the 3x3 cell shifts and a join that keeps
    the exact distance as its residual filter."""
    from trino_tpu.sql import plan as JP
    from trino_tpu.sql.frontend import compile_sql as jax_compile
    from trino_tpu_torch.sql import plan as TP
    from trino_tpu_torch.sql.frontend import compile_sql as torch_compile

    j, t, sessions = engines
    sql = ("select aid, bid from pts_a, pts_b "
           "where st_distance(st_point(ax, ay), st_point(qx, qy)) <= 5.0")
    shapes = []
    for compile_sql, P, e, s in ((jax_compile, JP, j, sessions["mem"][0]),
                                 (torch_compile, TP, t, sessions["mem"][1])):
        unions, joins = [], []

        def walk(n):
            if isinstance(n, P.Union):
                unions.append(len(n.inputs))
            if isinstance(n, P.Join):
                joins.append(n.filter is not None)
            for c in n.children:
                walk(c)

        walk(compile_sql(sql, e, s))
        shapes.append((unions, joins))
    assert shapes[0] == shapes[1]
    assert shapes[1][0][0] == 9 and shapes[1][1][0]


@pytest.mark.parametrize("text", ["1969-12-31 23:59:59.500", "2024-03-15 10:30:45.123456",
                                  "1969-07-20 20:17:40", "2000-02-29 23:59:59.9995",
                                  "1900-01-01 00:00:00.000000001", "2038-01-19 03:14:08.1"])
def test_timestamp_literal_parses_alike(text):
    """The literal parser of both packages: the same epoch value and
    precision, the fraction moving time forward before the epoch too."""
    jv, jt = JT.parse_timestamp_literal(text)
    tv, tt = TT.parse_timestamp_literal(text)
    assert (int(tv), tt.precision) == (int(jv), jt.precision)
