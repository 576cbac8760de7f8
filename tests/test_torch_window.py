"""The port's window primitives (``trino_tpu_torch/ops/window.py``) and its
window kernel (``local_executor._window_kernel``) against the JAX package's,
on the same seeded numpy inputs: ties, NULLs, empty frames, descending keys,
pad rows, and ROWS and RANGE offsets on int, decimal and DOUBLE keys.

Tolerances: indices, ranks, counts, integer and decimal sums, min, max and
every navigation result exactly; DOUBLE sums and averages within rtol 1e-9
(the prefix sums add in another order).  Window outputs are compared on live
rows only: pad rows carry garbage the executor drops, in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.exec.local_executor import _window_kernel as j_kernel
from trino_tpu.ops import window as JW
from trino_tpu.sql import plan as JP
from trino_tpu import types as JT
from trino_tpu_torch.exec.local_executor import _window_kernel as t_kernel
from trino_tpu_torch.ops import window as TW
from trino_tpu_torch.sql import plan as TP
from trino_tpu_torch import types as TT

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def _both(fn, *args, **kw):
    """fn of both packages on the same numpy args (arrays convert, the rest
    passes through)."""
    def conv(a, to):
        if isinstance(a, list):
            return [conv(x, to) for x in a]
        return to(np.array(a)) if isinstance(a, np.ndarray) else a

    jfn = _J_MINMAX if fn == "segmented_scan_minmax" else getattr(JW, fn)
    return (jfn(*(conv(a, jnp.asarray) for a in args), **kw),
            getattr(TW, fn)(*(conv(a, torch.as_tensor) for a in args), **kw))


# the reference's associative scan, compiled once per shape (eager, it
# dispatches one small program per step)
_J_MINMAX = jax.jit(JW.segmented_scan_minmax, static_argnums=3)


def _sorted_segments(rng, n, parts, peers):
    """Boundary masks of rows sorted by (partition, order key) with ties."""
    part = np.sort(rng.integers(0, parts, size=n))
    key = rng.integers(0, peers, size=n)
    order = np.lexsort((key, part))
    part, key = part[order], key[order]
    part_new = np.r_[True, part[1:] != part[:-1]]
    peer_new = part_new | np.r_[True, key[1:] != key[:-1]]
    return part, key, part_new, peer_new


@pytest.mark.parametrize("seed", [0, 1])
def test_window_order_ties_desc_and_bool_keys(seed):
    rng = np.random.default_rng(seed)
    n = 300
    keys = [rng.integers(0, 4, size=n).astype(np.int32),
            rng.random(n) < 0.3,
            np.round(rng.normal(size=n), 1),
            rng.integers(-3, 3, size=n).astype(np.int64)]
    for desc in ([False, False, False, False], [True, True, False, True],
                 [False, True, True, False], [True, False, True, True]):
        j, t = _both("window_order", keys, desc)
        _eq(j, t, f"desc={desc}")


@pytest.mark.parametrize("n,parts,peers", [(1, 1, 1), (257, 5, 7), (400, 40, 2)])
def test_ranks_and_running_aggregates(n, parts, peers):
    rng = np.random.default_rng(n)
    _, _, part_new, peer_new = _sorted_segments(rng, n, parts, peers)
    _eq(*_both("segments", [np.sort(rng.integers(0, 3, size=n))]))
    for fn in ("row_number",):
        _eq(*_both(fn, part_new), fn)
    for fn in ("rank", "dense_rank"):
        _eq(*_both(fn, part_new, peer_new), fn)
    ints = rng.integers(-10**12, 10**12, size=n, dtype=np.int64)  # decimal raw
    dbl = rng.normal(size=n) * 1e3
    for v in (ints, dbl):
        _eq(*_both("segmented_scan_sum", v, part_new, peer_new), "scan sum")
        _eq(*_both("partition_total", v, part_new), "partition total")
        for kind in ("min", "max"):
            _eq(*_both("segmented_scan_minmax", v, part_new, peer_new, kind), kind)
            _eq(*_both("segmented_scan_minmax", v, part_new, part_new, kind), kind)
    small = rng.integers(0, 9, size=n).astype(np.int32)
    _eq(*_both("segmented_scan_sum", small, part_new, peer_new, np.int64), "widened")


ROWS_FRAMES = [("rows", "p", 2, "cr", 0), ("rows", "p", 1, "f", 1),
               ("rows", "f", 1, "f", 2), ("rows", "f", 3, "f", 4),
               ("rows", "up", 0, "uf", 0), ("rows", "up", 0, "cr", 0),
               ("rows", "p", 3, "p", 1)]
RANGE_FRAMES = [("range", "p", 10, "cr", 0), ("range", "p", 5, "f", 5),
                ("range", "up", 0, "cr", 0), ("range", "cr", 0, "uf", 0),
                ("range", "f", 1, "f", 3)]


def _order_values(rng, part, kind):
    """Ascending-normalized sorted ORDER BY values within each partition."""
    n = len(part)
    if kind == "int":
        v = rng.integers(0, 60, size=n).astype(np.int32)
    elif kind == "decimal":
        v = rng.integers(-5000, 5000, size=n).astype(np.int64)
    else:
        v = np.round(rng.normal(size=n) * 20, 2)
    return v[np.lexsort((v, part))], v.dtype


@pytest.mark.parametrize("key", ["int", "decimal", "double"])
@pytest.mark.parametrize("frame", ROWS_FRAMES + RANGE_FRAMES, ids=str)
def test_frame_bounds_and_framed_aggregates(key, frame):
    rng = np.random.default_rng(len(str(frame)) + len(key))
    n = 240
    part = np.sort(rng.integers(0, 6, size=n))
    ov, _ = _order_values(rng, part, key)
    part_new = np.r_[True, part[1:] != part[:-1]]
    peer_new = part_new | np.r_[True, ov[1:] != ov[:-1]]
    (jlo, jhi), (tlo, thi) = _both("frame_bounds", part_new, peer_new, frame, ov)
    _eq(jlo, tlo, "lo")
    _eq(jhi, thi, "hi")
    lo, hi = np.asarray(jlo), np.asarray(jhi)
    vals = rng.integers(-10**9, 10**9, size=n, dtype=np.int64)
    dbl = rng.normal(size=n)
    for v in (vals, dbl):
        _eq(*_both("framed_sum", v, lo, hi), "framed sum")
    live = hi >= lo
    for kind in ("min", "max"):
        j, t = _both("framed_minmax", vals, lo, hi, kind)
        _eq(np.asarray(j)[live], _np(t)[live], kind)  # the caller masks empty frames


@pytest.mark.parametrize("seed", [3, 4])
def test_navigation_and_ignore_nulls(seed):
    rng = np.random.default_rng(seed)
    n = 200
    _, _, part_new, _ = _sorted_segments(rng, n, 9, 50)
    vals = rng.integers(-100, 100, size=n, dtype=np.int64)
    nonnull = rng.random(n) < 0.6
    g = _both("nonnull_positions", nonnull)
    _eq(g[0][0], g[1][0], "g")
    _eq(np.asarray(g[0][1])[1:][:int(nonnull.sum())],
        _np(g[1][1])[1:][:int(nonnull.sum())], "P")  # P[0] is a sink
    for off in (0, 1, 2, -1, -3):
        j, t = _both("shift_in_partition", vals, part_new, off, -7)
        _eq(j[0], t[0], f"shift {off}")
        _eq(j[1], t[1], f"shift miss {off}")
        (jv, jm), (tv, tm) = _both("shift_ignore_nulls", vals, nonnull, part_new, off,
                                   5)
        _eq(jm, tm, f"ignore-nulls miss {off}")
        _eq(np.asarray(jv)[~np.asarray(jm)], _np(tv)[~_np(tm)], f"ignore-nulls {off}")
    lo = np.clip(np.arange(n) - rng.integers(-2, 6, size=n), 0, n - 1)
    hi = np.clip(np.arange(n) + rng.integers(-3, 6, size=n), 0, n - 1)  # some empty
    for k, from_end in ((1, False), (2, False), (1, True), (3, True)):
        (jv, jm), (tv, tm) = _both("framed_nth_nonnull", vals, nonnull, lo, hi, k,
                                   from_end=from_end)
        _eq(jm, tm, f"nth miss {k} {from_end}")
        _eq(jv, tv, f"nth {k} {from_end}")


# -- _window_kernel: every kind it handles ------------------------------------------------

N = 160


def _page(seed):
    """Columns: 0 partition int32 (NULLs), 1 order int64 (ties, NULLs), 2 arg
    decimal raw int64 (NULLs), 3 arg DOUBLE, 4 arg int64 without NULLs,
    5 order int32 without NULLs, 6 order DOUBLE; valid has pad rows."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 6, size=N).astype(np.int32),
            rng.integers(0, 12, size=N).astype(np.int64),
            rng.integers(-10**6, 10**6, size=N).astype(np.int64),
            np.round(rng.normal(size=N) * 50, 3),
            rng.integers(-50, 50, size=N).astype(np.int64),
            rng.integers(0, 40, size=N).astype(np.int32),
            np.round(rng.normal(size=N) * 10, 1)]
    nulls = [rng.random(N) < 0.1, rng.random(N) < 0.15, rng.random(N) < 0.2,
             None, None, None, None]
    valid = rng.random(N) < 0.85
    return cols, nulls, valid


def _specs(P, T):
    D = T.DecimalType.of(12, 2)
    asc = P.SortKey(1, True, False)
    desc_nf = P.SortKey(1, False, True)
    k5 = P.SortKey(5, True, False)
    kd = P.SortKey(6, False, False)

    def spec(kind, arg, typ, order=(asc,), part=(0,), **kw):
        return P.WindowSpec(kind, arg, part, order, kind, typ, **kw)

    return [
        spec("row_number", None, T.BIGINT),
        spec("rank", None, T.BIGINT, order=(desc_nf,)),
        spec("dense_rank", None, T.BIGINT),
        spec("count_star", None, T.BIGINT),
        spec("count", 2, T.BIGINT, order=()),
        spec("sum", 2, D),
        spec("sum", 3, T.DOUBLE, order=()),
        spec("avg", 2, D),
        spec("avg", 3, T.DOUBLE, order=(desc_nf,)),
        spec("min", 2, D),
        spec("max", 4, T.BIGINT, order=()),
        spec("lag", 2, D),
        spec("lag", 4, T.BIGINT, offset=2, default=-1),
        spec("lead", 2, D, offset=1, ignore_nulls=True),
        spec("lag", 2, D, offset=2, ignore_nulls=True),
        spec("lead", 4, T.BIGINT, offset=3),
        spec("percent_rank", None, T.DOUBLE),
        spec("cume_dist", None, T.DOUBLE, order=(desc_nf,)),
        spec("ntile", None, T.BIGINT, offset=3),
        spec("nth_value", 4, T.BIGINT, offset=2),
        spec("nth_value", 2, D, offset=2, ignore_nulls=True,
             frame=("rows", "up", 0, "cr", 0)),
        spec("first_value", 2, D),
        spec("last_value", 4, T.BIGINT),
        spec("first_value", 2, D, ignore_nulls=True),
        spec("last_value", 2, D, ignore_nulls=True, frame=("rows", "up", 0, "uf", 0)),
        # explicit frames: the ROWS shapes, and RANGE offsets on an int, a
        # nullable int, a descending DOUBLE key
        spec("sum", 2, D, order=(k5,), frame=("rows", "p", 2, "cr", 0)),
        spec("avg", 3, T.DOUBLE, order=(k5,), frame=("rows", "p", 1, "f", 1)),
        spec("min", 4, T.BIGINT, order=(k5,), frame=("rows", "f", 1, "f", 2)),
        spec("count_star", None, T.BIGINT, order=(k5,), frame=("rows", "f", 3, "f", 4)),
        spec("max", 2, D, order=(k5,), frame=("rows", "up", 0, "uf", 0)),
        spec("first_value", 4, T.BIGINT, order=(k5,), frame=("rows", "p", 1, "cr", 0)),
        spec("sum", 4, T.BIGINT, order=(k5,), frame=("range", "p", 10, "cr", 0)),
        spec("count", 2, T.BIGINT, order=(k5,), frame=("range", "p", 5, "f", 5)),
        spec("sum", 4, T.BIGINT, order=(asc,), frame=("range", "p", 2, "f", 1)),
        spec("sum", 4, T.BIGINT, order=(desc_nf,), frame=("range", "p", 3, "cr", 0)),
        spec("min", 3, T.DOUBLE, order=(kd,), frame=("range", "p", 5, "f", 5)),
        spec("max", 2, D, order=(k5,), frame=("range", "f", 2, "f", 4)),
        spec("last_value", 4, T.BIGINT, order=(k5,), frame=("range", "cr", 0, "uf", 0)),
        spec("row_number", None, T.BIGINT, part=(), order=()),
        spec("sum", 4, T.BIGINT, part=(), order=(k5, asc)),
    ]


KINDS = {"row_number", "rank", "dense_rank", "count", "count_star", "sum", "avg", "min",
         "max", "lag", "lead", "percent_rank", "cume_dist", "ntile", "nth_value",
         "first_value", "last_value"}


def test_specs_cover_every_kind():
    assert {s.kind for s in _specs(TP, TT)} == KINDS


@pytest.mark.parametrize("with_valid", [True, False])
def test_window_kernel_every_kind(with_valid, seed=5):
    cols, nulls, valid = _page(seed)
    jspecs, tspecs = _specs(JP, JT), _specs(TP, TT)
    jv = jnp.asarray(valid) if with_valid else None
    tv = torch.as_tensor(valid) if with_valid else None
    jc, jn = j_kernel(jspecs, tuple(jnp.asarray(c) for c in cols),
                      tuple(None if m is None else jnp.asarray(m) for m in nulls), jv)
    tc, tn = t_kernel(tspecs, tuple(torch.as_tensor(c) for c in cols),
                      tuple(None if m is None else torch.as_tensor(m) for m in nulls), tv)
    live = valid if with_valid else np.ones(N, bool)
    for i, s in enumerate(tspecs):
        what = f"{i}: {s.kind} {s.frame} order={s.order}"
        assert (jn[i] is None) == (tn[i] is None), what
        null = np.zeros(N, bool) if jn[i] is None else np.asarray(jn[i])
        if tn[i] is not None:
            _eq(null[live], _np(tn[i])[live], what + " nulls")
        keep = live & ~null
        a, b = np.asarray(jc[i]), _np(tc[i])
        assert a.dtype == b.dtype, what
        _eq(a[keep], b[keep], what)


def test_window_kernel_empty_partition_spec_and_one_row():
    cols = (np.array([7], np.int64), np.array([1.5]))
    spec = lambda P, T: [P.WindowSpec("sum", 1, (), (), "s", T.DOUBLE),  # noqa: E731
                         P.WindowSpec("rank", None, (), (P.SortKey(0),), "r", T.BIGINT),
                         P.WindowSpec("lag", 0, (), (P.SortKey(0),), "l", T.BIGINT)]
    jc, jn = j_kernel(spec(JP, JT), tuple(jnp.asarray(c) for c in cols), (None, None))
    tc, tn = t_kernel(spec(TP, TT), tuple(torch.as_tensor(c) for c in cols), (None, None))
    for a, b in zip(jc, tc):
        _eq(a, b)
    for a, b in zip(jn, tn):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b)
