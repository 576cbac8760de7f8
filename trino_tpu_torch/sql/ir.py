"""Typed expression IR + columnar evaluation over torch tensors
(counterpart of ``trino_tpu/sql/ir.py``).

The node classes are the reference's, so the copied planner builds the same
plans.  ``evaluate`` runs an expression eagerly over whole-column tensors and
returns ``(values, null_mask_or_None)``; NULLs propagate per SQL three-valued
logic.  Strings are dictionary ids: comparisons against literals and LIKE are
pre-resolved by the planner into id comparisons and id -> bool lookup tables
(``Call("lut", ...)``).

Dtypes: constants are 0-d tensors of their SQL type's dtype, and every binary
operation promotes its operands explicitly (``torch.promote_types``) before
computing.  Torch would otherwise let a 0-d operand take the dtype of the
column (an int32 column times an int64 constant would compute in int32);
explicit promotion gives the reference's x64 results.

Runtime parameters (plan templates): ``bind_params`` publishes a query's
bound slot values on this thread, each a ``(0-d value tensor, 0-d isnull
tensor)`` pair the executor staged to the device once per query; a
``Parameter`` leaf evaluates to its slot's pair.  Outside a scope it raises,
which is how template creation rejects a plan-time use of a parameter.

Every scalar call of the reference is ported, its array, map and span calls
included.  Planner-made tables (LIKE lookup tables, element heaps) are numpy
constants: inside ``device_constants`` (the executor's query scope) each one
is copied to the device once per query and the copied bytes are counted;
outside it (plan-time folding) each evaluation converts it.  An unknown call
raises ``NotImplementedError`` naming the op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..ops.arrays import pack_span, span_len, span_start
from ..ops.hashing import _lsr, hash_columns
from ..types import DecimalType, TimestampType, Type, torch_dtype

__all__ = ["Expr", "Constant", "FieldRef", "Call", "Parameter", "bind_params",
           "evaluate", "evaluate_predicate", "device_constants", "device_array"]


class Expr:
    type: Type


@dataclasses.dataclass(frozen=True)
class Constant(Expr):
    """A literal. ``value`` is a python scalar (decimal literals pre-scaled to raw int),
    or a numpy array for planner-generated lookup tables."""

    value: Any
    type: Type

    def __repr__(self):
        return f"Const({self.value}:{self.type.name})"


@dataclasses.dataclass(frozen=True)
class FieldRef(Expr):
    """Positional reference into the input schema."""

    index: int
    type: Type
    name: str = ""

    def __repr__(self):
        return f"${self.index}:{self.name}"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Operator/function call. ``op`` is the function name; result ``type`` was computed by
    the analyzer (decimal ops carry pre-computed rescale factors in ``meta``)."""

    op: str
    args: tuple
    type: Type
    meta: tuple = ()

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class Parameter(Expr):
    """A runtime statement parameter: a value that is an input of the plan,
    not a plan-time literal (plan templates, engine ``EXECUTE``).  ``slot``
    indexes the bound tuple of ``bind_params``.  The value's domain is the
    one the planner resolved at this position (dictionary ids for strings,
    scaled ints for decimals, epoch days for dates); ``sql/params.Binder``
    encodes it at bind time."""

    slot: int
    type: Type

    def __repr__(self):
        return f"?[{self.slot}]:{self.type.name}"


_PARAM_TLS = threading.local()


@contextlib.contextmanager
def bind_params(values):
    """Make a query's bound parameter values visible to ``evaluate`` on this
    thread.  Each slot is a ``(value, isnull)`` pair of 0-d tensors on the
    executor's device, staged once per query: a ``Parameter`` leaf reads its
    pair and copies nothing.  The pair is always present, so NULL and
    non-NULL bindings take the same path."""
    old = getattr(_PARAM_TLS, "values", None)
    _PARAM_TLS.values = values
    try:
        yield
    finally:
        _PARAM_TLS.values = old


def _param_leaf(expr: Parameter):
    vals = getattr(_PARAM_TLS, "values", None)
    if vals is None or expr.slot >= len(vals):
        # reached from a plan-time evaluation (an eager subquery, a constant
        # fold): the value does not exist before execution, and template
        # creation takes this error to fall back to substitution
        raise RuntimeError(
            f"parameter slot {expr.slot} evaluated outside bind_params "
            "(plan-time use of a runtime parameter)")
    v, isnull = vals[expr.slot]
    return v.to(torch_dtype(expr.type)), isnull


def _combine_nulls(*masks):
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out | m)
    return out


def _device_of(columns) -> torch.device:
    for c in columns:
        if isinstance(c, torch.Tensor):
            return c.device
    return torch.device("cpu")


_CONSTS = threading.local()


def current_params() -> tuple:
    """The parameter slots bound on this thread (``bind_params``), or ()."""
    return getattr(_PARAM_TLS, "values", None) or ()


@contextlib.contextmanager
def device_constants(count=None, cache=None, scalars=False):
    """A query's scope for numpy constants: each one is copied to the device
    once (keyed by the array's identity, which the scope keeps alive) and
    ``count(nbytes)`` is called for each copy.  ``cache`` (a dict the caller
    keeps) holds the copies past the scope; ``scalars`` also keeps each
    scalar constant's device copy there, keyed by its expression: a CUDA
    graph capture may copy nothing from the host, so the scan-fused runners
    evaluate their body once before capture in such a scope, and the
    captured graph reads the copies that the cache keeps alive."""
    old = getattr(_CONSTS, "scope", None)
    _CONSTS.scope = ({} if cache is None else cache, count, scalars)
    try:
        yield
    finally:
        _CONSTS.scope = old


def device_array(value: np.ndarray, device) -> torch.Tensor:
    """``value`` on ``device``: the query's copy inside ``device_constants``."""
    scope = getattr(_CONSTS, "scope", None)
    if scope is None:
        return torch.as_tensor(value, device=device)
    cache, count, _ = scope
    dev = torch.device(device)
    key = (id(value), dev.type, dev.index or 0)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = (value, torch.as_tensor(value, device=device))
        if count is not None:
            count(value.nbytes)
    return hit[1]


def evaluate(expr: Expr, columns: Sequence, null_masks: Sequence):
    """Evaluate ``expr`` over columnar inputs; returns (values, null_mask|None)."""
    return _evaluate(expr, columns, null_masks, _device_of(columns))


def _evaluate(expr, columns, null_masks, device):
    if isinstance(expr, Constant):
        if isinstance(expr.value, np.ndarray):
            return device_array(expr.value, device), None
        dt = torch_dtype(expr.type)
        if expr.value is None:
            return (torch.zeros((), dtype=dt, device=device),
                    torch.ones((), dtype=torch.bool, device=device))
        scope = getattr(_CONSTS, "scope", None)
        if scope is not None and scope[2]:
            dev = torch.device(device)
            key = ("scalar", id(expr), dev.type, dev.index or 0)
            hit = scope[0].get(key)
            if hit is None:
                hit = scope[0][key] = (expr, torch.tensor(expr.value, dtype=dt,
                                                          device=device))
            return hit[1], None
        return torch.tensor(expr.value, dtype=dt, device=device), None
    if isinstance(expr, FieldRef):
        return columns[expr.index], null_masks[expr.index]
    if isinstance(expr, Parameter):
        return _param_leaf(expr)
    if isinstance(expr, Call):
        return _eval_call(expr, columns, null_masks, device)
    raise TypeError(f"unknown expression node {expr!r}")


def evaluate_predicate(expr: Optional[Expr], columns, null_masks, base_valid):
    """Filter evaluation: NULL counts as false (WHERE semantics)."""
    if expr is None:
        return base_valid
    vals, nulls = evaluate(expr, columns, null_masks)
    keep = vals
    if nulls is not None:
        keep = keep & ~nulls
    if base_valid is not None:
        keep = keep & base_valid
    return keep


def _promote(*ts):
    """Cast operands to their common dtype (the reference's x64 promotion of
    non-weak arrays; see the module docstring)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


_ARITH = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul}
_CMP = {"eq": torch.eq, "neq": torch.ne, "lt": torch.lt, "lte": torch.le,
        "gt": torch.gt, "gte": torch.ge}


def _eval_call(expr: Call, columns, null_masks, device):
    op = expr.op
    argv = [_evaluate(a, columns, null_masks, device) for a in expr.args]
    vals = [v for v, _ in argv]
    nulls = [n for _, n in argv]
    out_dt = torch_dtype(expr.type)

    if op in _ARITH:
        return _ARITH[op](*_promote(vals[0], vals[1])).to(out_dt), _combine_nulls(*nulls)
    if op == "negate":
        return (-vals[0]).to(out_dt), nulls[0]
    if op == "divide":
        a, b = vals[0], vals[1]
        if isinstance(expr.type, DecimalType):
            # decimal division: the planner computed the numerator rescale in meta[0]
            scale_up = expr.meta[0] if expr.meta else 1
            num = a.to(torch.int64) * scale_up
            safe_b = torch.where(b == 0, torch.ones_like(b), b)
            return _div_round_half_up(num, safe_b.to(torch.int64)), _combine_nulls(*nulls)
        if expr.type.is_integer:
            a, b = _promote(a, b)
            safe_b = torch.where(b == 0, torch.ones_like(b), b)
            return _floordiv(a, safe_b).to(out_dt), _combine_nulls(*nulls)
        safe_b = torch.where(b == 0, torch.ones_like(b), b).to(out_dt)
        return a.to(out_dt) / safe_b, _combine_nulls(*nulls)
    if op in _CMP:
        return _CMP[op](*_promote(vals[0], vals[1])), _combine_nulls(*nulls)
    if op == "between":
        v, lo, hi = _promote(*vals)
        return (v >= lo) & (v <= hi), _combine_nulls(*nulls)
    if op == "and":
        # 3VL: F and NULL = F; T and NULL = NULL
        v = vals[0] & vals[1]
        n0, n1 = nulls
        if n0 is None and n1 is None:
            return v, None
        # a side with no null mask is never NULL: its known-truth is its value
        f0 = ~vals[0] if n0 is None else (~vals[0] & ~n0)
        f1 = ~vals[1] if n1 is None else (~vals[1] & ~n1)
        anynull = _combine_nulls(n0, n1)
        return v & ~anynull, anynull & ~(f0 | f1)
    if op == "or":
        v = vals[0] | vals[1]
        n0, n1 = nulls
        if n0 is None and n1 is None:
            return v, None
        t0 = vals[0] if n0 is None else (vals[0] & ~n0)
        t1 = vals[1] if n1 is None else (vals[1] & ~n1)
        known_true = t0 | t1
        anynull = _combine_nulls(n0, n1)
        return v | known_true, anynull & ~known_true
    if op == "not":
        return ~vals[0], nulls[0]
    if op == "is_null":
        n = nulls[0]
        return (torch.zeros(vals[0].shape, dtype=torch.bool, device=vals[0].device)
                if n is None else n), None
    if op == "in":
        # the planner keeps literal IN-lists as constants: vals[1:] are scalars
        acc = None
        for v in vals[1:]:
            x, y = _promote(vals[0], v)
            acc = (x == y) if acc is None else (acc | (x == y))
        return acc, nulls[0]
    if op == "in_array":
        # membership in a sorted unique plan-time table (an uncorrelated IN
        # subquery run eagerly): one binary search per row
        table, x = vals[1], vals[0]
        if table.shape[0] == 0:
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device), nulls[0]
        x, table = _promote(x, table)
        ix = torch.clamp(torch.searchsorted(table.contiguous(), x), 0, table.shape[0] - 1)
        return table[ix] == x, nulls[0]
    if op == "coalesce":
        # the first non-NULL argument; NULL only where every argument is
        out_dt_ = vals[0].dtype
        for v in vals[1:]:
            out_dt_ = torch.promote_types(out_dt_, v.dtype)
        out, outn = vals[-1].to(out_dt_), nulls[-1]
        for v, n in zip(reversed(vals[:-1]), reversed(nulls[:-1])):
            if n is None:
                out, outn = v.to(out_dt_), None
            else:
                out = torch.where(n, out, v.to(out_dt_))
                outn = (torch.zeros_like(n) if outn is None else outn) & n
        return out, outn
    if op == "abs":
        return torch.abs(vals[0]).to(out_dt), nulls[0]
    if op == "lut":
        # id -> bool/value lookup table (LIKE, dictionary predicates);
        # args: (id_expr, table_const); the planner guarantees ids in range
        table = vals[1]
        ids = torch.clamp(vals[0], 0, table.shape[0] - 1).to(torch.int64)
        return table[ids], nulls[0]
    if op == "rescale":
        # decimal scale adjustment; meta=(factor,) multiply, meta=(-factor,) divide w/ rounding
        factor = expr.meta[0]
        v = vals[0].to(torch.int64)
        if factor >= 0:
            return v * (10**factor), nulls[0]
        return _div_round_half_up(v, 10 ** (-factor)), nulls[0]
    if op == "if":
        c, t, f = vals
        cond = c if nulls[0] is None else (c & ~nulls[0])
        t, f = _promote(t, f)
        nt, nf = nulls[1], nulls[2]
        outn = None
        if nt is not None or nf is not None:
            # nullness follows the selected branch: a NULL in the branch not
            # taken must not poison the row
            nt_ = torch.zeros_like(cond) if nt is None else nt.expand(cond.shape)
            nf_ = torch.zeros_like(cond) if nf is None else nf.expand(cond.shape)
            outn = torch.where(cond, nt_, nf_)
        return torch.where(cond, t, f).to(out_dt), outn
    if op == "cast":
        return _eval_cast(expr, vals[0], nulls[0])
    if op == "extract_year":
        return _extract_ymd(vals[0])[0].to(out_dt), nulls[0]
    if op == "modulus":
        # the divisor's sign, as jnp.remainder (Trino truncates: ROADMAP C)
        a, b = _promote(vals[0], vals[1])
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        return torch.remainder(a, safe_b).to(out_dt), _combine_nulls(*nulls)
    if op == "lut_nullable":
        # "lut" with a parallel null table: entries whose transform produced
        # SQL NULL (regexp miss, unparsable date) null out the row
        table, ntable = vals[1], vals[2]
        ids = torch.clamp(vals[0], 0, table.shape[0] - 1).to(torch.int64)
        return table[ids], _combine_nulls(nulls[0], ntable[ids])
    if op == "null_if_flag":
        # (value, flag) -> value, NULL where flag (TRY_CAST failure lanes)
        v, flag = vals
        return v, (flag if nulls[0] is None else (nulls[0] | flag))
    if op == "nullif":
        # NULL where a = b is KNOWN true; a NULL b leaves a
        a, b = _promote(vals[0], vals[1])
        eq = a == b
        for n in nulls:
            if n is not None:
                eq = eq & ~n
        return vals[0], (eq if nulls[0] is None else (nulls[0] | eq))
    if op in _UNARY_MATH:
        return _UNARY_MATH[op](_float_in(vals[0], op)).to(out_dt), nulls[0]
    if op == "log_b":  # log(b, x)
        return (torch.log(vals[1].to(torch.float64))
                / torch.log(vals[0].to(torch.float64))), _combine_nulls(*nulls)
    if op in ("is_nan", "is_finite", "is_infinite"):
        fn = {"is_nan": torch.isnan, "is_finite": torch.isfinite,
              "is_infinite": torch.isinf}[op]
        return fn(vals[0].to(torch.float64)), nulls[0]
    if op in ("power", "atan2"):
        x, y = vals[0].to(torch.float64), vals[1].to(torch.float64)
        out = torch.pow(x, y) if op == "power" else torch.atan2(x, y)
        return out, _combine_nulls(*nulls)
    if op in ("round_n", "truncate_n"):
        # round half AWAY from zero (Trino), or toward zero, at n decimals
        f = 10.0 ** expr.meta[0]
        x = _float_in(vals[0], op) * f
        r = _round_half_away(x) if op == "round_n" else torch.trunc(x)
        return (r / f).to(out_dt), nulls[0]
    if op in ("greatest", "least"):
        fn = torch.maximum if op == "greatest" else torch.minimum
        out = vals[0]
        for v in vals[1:]:
            out = fn(*_promote(out, v))
        return out.to(out_dt), _combine_nulls(*nulls)
    if op == "width_bucket":
        v, lo, hi, n = vals
        lo, hi = lo.to(torch.float64), hi.to(torch.float64)
        frac = (v.to(torch.float64) - lo) / torch.where(hi == lo, torch.ones_like(hi), hi - lo)
        b = _to_int(torch.floor(frac * n.to(torch.float64)), torch.int64) + 1
        b = torch.minimum(torch.clamp(b, min=0), n.to(torch.int64) + 1)
        return b, _combine_nulls(*nulls)
    if op in _BITWISE:
        a, b = vals[0].to(torch.int64), vals[1].to(torch.int64)
        return _BITWISE[op](a, b), _combine_nulls(*nulls)
    if op == "bitwise_not":
        return ~vals[0].to(torch.int64), nulls[0]
    if op == "bit_count":
        # popcount of the low `bits` bits; a value outside their signed range
        # is NULL (the reference's traced-kernel deviation from raising)
        bits = expr.meta[0]
        v = vals[0].to(torch.int64)
        bad = None
        if bits < 64:
            lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
            bad = (v < lo) | (v > hi)
            v = v & ((1 << bits) - 1)
        return _popcount(v), _combine_nulls(nulls[0], bad)
    if op in _DATE_CALLS:
        return _DATE_CALLS[op](expr, vals[0]), nulls[0]
    if op == "date_add_unit":
        return _date_add_unit(expr.meta[0], vals[0], vals[1]).to(out_dt), \
            _combine_nulls(*nulls)
    if op == "date_diff_unit":
        return _date_diff_unit(expr.meta[0], vals[0], vals[1]).to(out_dt), \
            _combine_nulls(*nulls)
    if op == "ts_extract":
        return _ts_extract(expr.meta[0], expr.meta[1], vals[0]), nulls[0]
    if op == "ts_to_date":
        v = vals[0].to(torch.int64)
        return _floordiv(_floordiv(v, 10 ** expr.meta[0]), 86400).to(out_dt), nulls[0]
    if op == "as_timestamp":
        # a double already in the target timestamp's epoch units; half to
        # even, as jnp.round
        return _to_int(torch.round(vals[0]), torch.int64), nulls[0]
    if op in _STATS:
        fv = [v.to(torch.float64) for v in vals]
        return _STATS[op](*fv), _combine_nulls(*nulls)
    if op == "st_distance":
        # Euclidean distance of two planar points (args: ax, ay, bx, by); one
        # op so the spatial-join rule can match it in join filters
        ax, ay, bx, by = (v.to(torch.float64) for v in vals)
        return torch.sqrt((ax - bx) ** 2 + (ay - by) ** 2), _combine_nulls(*nulls)
    if op == "hash":
        return hash_columns(vals), _combine_nulls(*nulls)
    if op in _ARRAY_OPS:
        return _ARRAY_OPS[op](expr, vals, nulls, device)
    raise NotImplementedError(f"scalar op {op!r} is not ported to trino_tpu_torch")


# -- array/map spans (ops/arrays.py layout: start << 24 | length into an element
# heap; the heaps are plan-time constants, one device copy per query) ---------


def _i64(x):
    return x.to(torch.int64)


def _rows_of(*ts):
    """(1-D broadcast operands, whether every operand was a scalar)."""
    scalar = all(t.ndim == 0 for t in ts)
    return torch.broadcast_tensors(*(torch.atleast_1d(t) for t in ts)), scalar


def _scalar_null(null, scalar):
    return null[0] if scalar and null is not None and null.ndim else null


def _span_elems(start, ln, heap, max_len):
    """The [rows, max_len] gather of each row's elements (positions clipped
    into the heap) and the in-row mask; elements are None for an empty heap."""
    offs = torch.arange(max_len, dtype=torch.int64, device=start.device)
    in_row = offs[None, :] < ln[:, None]
    if not heap.shape[0]:
        return None, in_row, None
    pos = torch.clamp(start[:, None] + offs[None, :], 0, heap.shape[0] - 1)
    return heap[pos], in_row, pos


def _op_span_len(expr, vals, nulls, device):
    return span_len(vals[0]).to(torch_dtype(expr.type)), nulls[0]


def _op_span_id(expr, vals, nulls, device):
    # identity over the span: a transform lambda rewrote only the heap
    return vals[0], nulls[0]


def _op_span_filter(expr, vals, nulls, device):
    # (span, exclusive cumsum of kept elements, len(heap) + 1 entries): the
    # span remapped into the filtered heap by two gathers
    span, excl = vals[0], _i64(vals[1])
    start, ln = span_start(span), span_len(span)
    hi = max(excl.shape[0] - 1, 0)
    s0 = excl[torch.clamp(start, 0, hi)]
    s1 = excl[torch.clamp(start + ln, 0, hi)]
    return pack_span(s0, s1 - s0), nulls[0]


def _op_span_slice(expr, vals, nulls, device):
    # (span, start [1-based; negative from the tail], length): slice() as
    # span arithmetic
    sp, st, ln = vals[0], _i64(vals[1]), _i64(vals[2])
    alen, s0 = span_len(sp), span_start(sp)
    zero = torch.zeros((), dtype=torch.int64, device=sp.device)
    begin = torch.where(st > 0, st - 1, alen + st)
    begin_c = torch.minimum(torch.maximum(begin, zero), alen)
    # a negative start past the head selects nothing, not the clipped prefix
    ln_c = torch.where(begin < 0, zero,
                       torch.minimum(torch.maximum(ln, zero), alen - begin_c))
    bad = (st == 0) | (ln < 0)  # the reference's NULL where Trino raises
    return pack_span(s0 + begin_c, ln_c), _combine_nulls(
        _combine_nulls(nulls[0], nulls[1]), _combine_nulls(nulls[2], bad))


def _op_span_trim(expr, vals, nulls, device):
    # (span, n): trim_array drops the last n elements
    sp, n = vals[0], _i64(vals[1])
    alen = span_len(sp)
    zero = torch.zeros((), dtype=torch.int64, device=sp.device)
    ln_c = torch.minimum(torch.maximum(alen - n, zero), alen)
    return pack_span(span_start(sp), ln_c), _combine_nulls(
        _combine_nulls(nulls[0], nulls[1]), n < 0)


def _op_arrays_overlap(expr, vals, nulls, device):
    # (span_a, span_b, heap_a, heap_b); meta = (max_len_a, max_len_b): one
    # [rows, La, Lb] masked compare
    (sa, sb), scalar = _rows_of(vals[0], vals[1])
    ha, hb = vals[2], vals[3]
    ea, in_a, _ = _span_elems(span_start(sa), span_len(sa), ha, expr.meta[0])
    eb, in_b, _ = _span_elems(span_start(sb), span_len(sb), hb, expr.meta[1])
    if ea is not None and eb is not None:
        ea, eb = _promote(ea, eb)
        hit = torch.any(((ea[:, :, None] == eb[:, None, :])
                         & in_a[:, :, None] & in_b[:, None, :]).flatten(1), dim=1)
    else:
        hit = torch.zeros(sa.shape, dtype=torch.bool, device=sa.device)
    return (hit[0] if scalar else hit), _combine_nulls(nulls[0], nulls[1])


def _op_span_reduce_lambda(expr, vals, nulls, device):
    # reduce(array, init, lambda): a masked fold unrolled over max_len steps;
    # step i applies the combiner (an Expr over [state, element]) to element
    # i of every row's span where i < its length
    span, init, heap = vals[0], vals[1], vals[2]
    max_len, body = expr.meta
    start, ln = span_start(span), span_len(span)
    state = init.expand(span.shape) if init.ndim == 0 else init
    state = state.to(torch_dtype(expr.type))
    if heap.shape[0] == 0:  # every array empty: the fold is the init
        return state, nulls[0]
    hi = heap.shape[0] - 1
    for i in range(max_len):
        elem = heap[torch.clamp(start + i, 0, hi)]
        new_state, _ = _evaluate(body, (state, elem), (None, None), device)
        state = torch.where(i < ln, new_state.to(state.dtype), state)
    return state, nulls[0]


def _op_array_get(expr, vals, nulls, device):
    # (span, index [1-based], heap)
    span, idx, heap = vals[0], vals[1], vals[2]
    start, ln = span_start(span), span_len(span)
    i0 = _i64(idx) - 1
    ok = (i0 >= 0) & (i0 < ln)
    pos = torch.clamp(start + i0, 0, max(heap.shape[0] - 1, 0))
    val = heap[pos] if heap.shape[0] else torch.zeros_like(pos)
    return val.to(torch_dtype(expr.type)), _combine_nulls(
        _combine_nulls(nulls[0], nulls[1]), ~ok)


def _op_array_contains(expr, vals, nulls, device):
    # (span, needle, heap); meta[0] = max array length: one [rows, max_len]
    # gather and a masked reduce
    (span, needle), scalar = _rows_of(vals[0], vals[1])
    elems, in_row, _ = _span_elems(span_start(span), span_len(span), vals[2], expr.meta[0])
    if elems is not None:
        elems, nd = _promote(elems, needle)
        hit = torch.any(in_row & (elems == nd[:, None]), dim=1)
    else:
        hit = torch.zeros(span.shape, dtype=torch.bool, device=span.device)
    return (hit[0] if scalar else hit), _combine_nulls(nulls[0], nulls[1])


def _op_array_reduce(expr, vals, nulls, device):
    # (span, heap); meta = (max_len, kind), kind in sum / avg / min / max;
    # empty arrays give NULL
    kind = expr.meta[1]
    (span,), scalar = _rows_of(vals[0])
    heap = vals[1]
    ln = span_len(span)
    elems, in_row, _ = _span_elems(span_start(span), ln, heap, expr.meta[0])
    if elems is None:
        elems = torch.zeros(in_row.shape, dtype=heap.dtype, device=span.device)
    if kind in ("sum", "avg"):
        out = torch.sum(torch.where(in_row, elems, torch.zeros_like(elems)), dim=1)
        if kind == "avg":
            out = out.to(torch.float64) / torch.clamp(ln, min=1).to(torch.float64)
    else:
        fill = _extreme_for(elems.dtype, +1 if kind == "min" else -1)
        masked = torch.where(in_row, elems, torch.full_like(elems, fill))
        out = torch.amin(masked, dim=1) if kind == "min" else torch.amax(masked, dim=1)
    out = out.to(torch_dtype(expr.type))
    null = _combine_nulls(nulls[0], ln == 0)
    return (out[0] if scalar else out), _scalar_null(null, scalar)


def _op_array_position(expr, vals, nulls, device):
    # (span, needle, heap); meta[0] = max_len: the 1-based index of the first
    # match, 0 when absent
    (span, needle), scalar = _rows_of(vals[0], vals[1])
    elems, in_row, _ = _span_elems(span_start(span), span_len(span), vals[2], expr.meta[0])
    if elems is not None:
        elems, nd = _promote(elems, needle)
        hit = in_row & (elems == nd[:, None])
        # the first hit: argmax over the mask as int32 (torch takes no bool)
        first = torch.argmax(hit.to(torch.int32), dim=1)
        out = torch.where(torch.any(hit, dim=1), first + 1, torch.zeros_like(first))
    else:
        out = torch.zeros(span.shape, dtype=torch.int64, device=span.device)
    return (out[0] if scalar else out).to(torch.int64), _combine_nulls(nulls[0], nulls[1])


def _op_map_get(expr, vals, nulls, device):
    # (span, key, key heap, value heap); meta[0] = max_len: the value at the
    # first matching key, NULL where none matches
    (span, key), scalar = _rows_of(vals[0], vals[1])
    kheap, vheap = vals[2], vals[3]
    out_dt = torch_dtype(expr.type)
    keys, in_row, pos = _span_elems(span_start(span), span_len(span), kheap, expr.meta[0])
    if keys is not None:
        keys, k = _promote(keys, key)
        m = in_row & (keys == k[:, None])
        found = torch.any(m, dim=1)
        first = torch.argmax(m.to(torch.int32), dim=1)
        rows = torch.arange(span.shape[0], device=span.device)
        out = vheap[pos[rows, first]].to(out_dt)
    else:
        found = torch.zeros(span.shape, dtype=torch.bool, device=span.device)
        out = torch.zeros(span.shape, dtype=out_dt, device=span.device)
    null = _combine_nulls(_combine_nulls(nulls[0], nulls[1]), ~found)
    return (out[0] if scalar else out), _scalar_null(null, scalar)


def _extreme_for(dtype, sign):
    if dtype.is_floating_point:
        return float("inf") * sign
    info = torch.iinfo(dtype)
    return info.max if sign > 0 else info.min


_ARRAY_OPS = {
    "span_len": _op_span_len, "span_id": _op_span_id, "span_filter": _op_span_filter,
    "span_slice": _op_span_slice, "span_trim": _op_span_trim,
    "arrays_overlap": _op_arrays_overlap, "span_reduce_lambda": _op_span_reduce_lambda,
    "array_get": _op_array_get, "array_contains": _op_array_contains,
    "array_reduce": _op_array_reduce, "array_position": _op_array_position,
    "map_get": _op_map_get}


def _float_in(x, op):
    """A math function's operand: integers compute in float64 (jnp's x64
    promotion; torch would take float32); floats keep their width.  floor,
    ceil, sign and trunc keep integers as they are, as jnp does."""
    if x.is_floating_point() or op in ("floor", "ceil", "sign", "trunc"):
        return x
    return x.to(torch.float64)


def _to_int(x, dtype):
    """Float -> integer conversion as XLA's: NaN to 0, out-of-range values
    saturated (torch leaves them undefined)."""
    info = torch.iinfo(dtype)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    big = x >= float(info.max)
    small = x <= float(info.min)
    out = torch.where(big | small, torch.zeros_like(x), x).to(dtype)
    out = torch.where(big, torch.full_like(out, info.max), out)
    return torch.where(small, torch.full_like(out, info.min), out)


def _round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _cbrt(x):
    """Real cube root (torch has none): |x|^(1/3) with the sign, then one
    Newton step, which makes exact cubes exact (27 -> 3.0)."""
    r = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    nz = r != 0
    safe = torch.where(nz, r, torch.ones_like(r))
    refined = safe - (safe * safe * safe - x) / (3.0 * safe * safe)
    return torch.where(nz & torch.isfinite(x), refined, r)


def _sign(x):
    """sign with NaN kept, as jnp.sign (torch.sign(NaN) is 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() \
        else torch.sign(x)


_UNARY_MATH = {
    "sqrt": torch.sqrt, "floor": torch.floor, "ceil": torch.ceil, "exp": torch.exp,
    "ln": torch.log, "round": _round_half_away, "sign": _sign, "trunc": torch.trunc,
    "log10": torch.log10, "log2": torch.log2, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "cbrt": _cbrt, "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
}


def _lsr_t(a, s):
    """Logical right shift of int64 lanes by a shift tensor in [0, 63]."""
    s1 = torch.clamp(s, 1, 63)
    return torch.where(s == 0, a, (a >> s1) & ((torch.ones_like(s1) << (64 - s1)) - 1))


def _shift_left(a, b):
    out = a << torch.clamp(b, 0, 63)
    return torch.where(b >= 64, torch.zeros_like(out), out)


def _shift_right(a, b):  # LOGICAL: zero-filling
    out = _lsr_t(a, torch.clamp(b, 0, 63))
    return torch.where(b >= 64, torch.zeros_like(out), out)


def _shift_right_arith(a, b):  # sign-extending
    out = a >> torch.clamp(b, 0, 63)
    return torch.where(b >= 64, torch.where(a < 0, -1, 0).to(out.dtype), out)


_BITWISE = {
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor, "bitwise_left_shift": _shift_left,
    "bitwise_right_shift": _shift_right,
    "bitwise_right_shift_arithmetic": _shift_right_arith,
}


def _popcount(v):
    """Set bits of int64 lanes (SWAR; torch has no popcount)."""
    x = v - (_lsr(v, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (_lsr(x, 2) & 0x3333333333333333)
    x = (x + _lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return _lsr(x * 0x0101010101010101, 56)


# -- dates (days since 1970-01-01) and timestamps (epoch units of 10^-p s) ----------


def _dow0(days):
    """ISO day of week, Monday = 0."""
    return torch.remainder(days.to(torch.int64) + 3, 7)


def _jan1(days):
    y, m, d = _extract_ymd(days)
    return _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))


def _date_trunc(unit, days):
    if unit == "day":
        return days
    if unit == "week":  # ISO Monday
        return (days.to(torch.int64) - _dow0(days)).to(days.dtype)
    y, m, d = _extract_ymd(days)
    mm = {"month": m, "quarter": _floordiv(m - 1, 3) * 3 + 1,
          "year": torch.ones_like(m)}[unit]
    return _days_from_civil(y, mm, torch.ones_like(d))


def _last_day_of_month(days):
    y, m, d = _extract_ymd(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return _days_from_civil(ny, nm, torch.ones_like(d)) - 1


def _iso_week(days, year_of_week: bool):
    """ISO-8601 week number or week-based year."""
    d64 = days.to(torch.int64)
    y, _, _ = _extract_ymd(days)
    dow = _dow0(days) + 1  # Monday = 1
    doy = d64 - _jan1(days) + 1

    def weeks_in(yy):
        def p(z):
            return torch.remainder(z + _floordiv(z, 4) - _floordiv(z, 100)
                                   + _floordiv(z, 400), 7)
        return 52 + ((p(yy) == 4) | (p(yy - 1) == 3)).to(torch.int64)

    w = _floordiv(doy - dow + 10, 7)
    under, over = w < 1, w > weeks_in(y)
    if year_of_week:
        return torch.where(under, y - 1, torch.where(over, y + 1, y))
    return torch.where(under, weeks_in(y - 1), torch.where(over, torch.ones_like(w), w))


def _ymd_part(i):
    return lambda expr, v: _extract_ymd(v)[i].to(torch_dtype(expr.type))


_DATE_CALLS = {
    "extract_month": _ymd_part(1),
    "extract_day": _ymd_part(2),
    "extract_quarter": lambda expr, v: (_floordiv(_extract_ymd(v)[1] - 1, 3) + 1).to(
        torch_dtype(expr.type)),
    "day_of_week": lambda expr, v: _dow0(v) + 1,
    "day_of_year": lambda expr, v: v.to(torch.int64) - _jan1(v) + 1,
    "last_day_of_month": lambda expr, v: _last_day_of_month(v).to(torch_dtype(expr.type)),
    "week_of_year": lambda expr, v: _iso_week(v, False),
    "year_of_week": lambda expr, v: _iso_week(v, True),
    **{f"date_trunc_{u}": (lambda expr, v, u=u: _date_trunc(u, v).to(torch_dtype(expr.type)))
       for u in ("year", "quarter", "month", "week", "day")},
}


def _month_length(total):
    """Days in month ``total`` (months since year 0, zero-based)."""
    one = torch.ones_like(total)
    nxt = total + 1
    return (_days_from_civil(_floordiv(nxt, 12), torch.remainder(nxt, 12) + 1, one)
            - _days_from_civil(_floordiv(total, 12), torch.remainder(total, 12) + 1, one))


def _date_add_unit(unit, n, d):
    n, d = n.to(torch.int64), d.to(torch.int64)
    if unit == "day":
        return d + n
    if unit == "week":
        return d + 7 * n
    y, m, day = _extract_ymd(d)  # month | year: clamp to the month's length
    total = y * 12 + (m - 1) + n * (12 if unit == "year" else 1)
    return _days_from_civil(_floordiv(total, 12), torch.remainder(total, 12) + 1,
                            torch.minimum(day, _month_length(total)))


def _date_diff_unit(unit, d1, d2):
    d1, d2 = d1.to(torch.int64), d2.to(torch.int64)
    if unit == "day":
        return d2 - d1
    if unit == "week":
        return _floordiv(d2 - d1, 7)
    y1, m1, day1 = _extract_ymd(d1)
    y2, m2, day2 = _extract_ymd(d2)
    months = (y2 * 12 + m2) - (y1 * 12 + m1) - (day2 < day1).to(torch.int64)
    return _floordiv(months, 12) if unit == "year" else months


def _ts_extract(part, prec, v):
    unit = 10 ** prec
    v = v.to(torch.int64)
    secs = _floordiv(v, unit)
    days = _floordiv(secs, 86400)
    if part in ("hour", "minute", "second"):
        tod = secs - days * 86400
        if part == "hour":
            return _floordiv(tod, 3600)
        if part == "minute":
            return torch.remainder(_floordiv(tod, 60), 60)
        return torch.remainder(tod, 60)
    if part == "millisecond":
        frac = v - secs * unit
        return _floordiv(frac * 1000, unit) if prec <= 3 else _floordiv(frac, unit // 1000)
    y, m, d = _extract_ymd(days)
    if part == "quarter":
        return _floordiv(m - 1, 3) + 1
    if part in ("year", "month", "day"):
        return {"year": y, "month": m, "day": d}[part]
    raise NotImplementedError(f"ts_extract {part}")


# -- statistics ----------------------------------------------------------------------


def _betainc(a, b, x, iters: int = 200):
    """Regularized incomplete beta I_x(a, b) in float64 (torch has no
    betainc): the continued fraction by Lentz's method, with the symmetry
    I_x(a, b) = 1 - I_{1-x}(b, a) where x > (a + 1) / (a + b + 2)."""
    tiny = 1e-300
    swap = x > (a + 1.0) / (a + b + 2.0)
    a_, b_ = torch.where(swap, b, a), torch.where(swap, a, b)
    x_ = torch.where(swap, 1.0 - x, x)
    xs = torch.clamp(x_, tiny, 1.0)
    lbeta = torch.lgamma(a_) + torch.lgamma(b_) - torch.lgamma(a_ + b_)
    front = torch.exp(a_ * torch.log(xs) + b_ * torch.log1p(-torch.clamp(x_, max=1.0 - 1e-16))
                      - lbeta) / a_

    c = torch.ones_like(x_)
    d = 1.0 - (a_ + b_) * x_ / (a_ + 1.0)
    d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    f = d
    for m in range(1, iters + 1):
        for even in (True, False):
            if even:
                num = m * (b_ - m) * x_ / ((a_ + 2 * m - 1) * (a_ + 2 * m))
            else:
                num = -(a_ + m) * (a_ + b_ + m) * x_ / ((a_ + 2 * m) * (a_ + 2 * m + 1))
            d = 1.0 + num * d
            d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
            d = 1.0 / d
            c = 1.0 + num / c
            c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
            f = f * c * d
    out = front * f
    out = torch.where(x_ <= 0, torch.zeros_like(out), out)
    out = torch.where(swap, 1.0 - out, out)
    bad = (a <= 0) | (b <= 0) | (x < 0) | (x > 1) | torch.isnan(a) | torch.isnan(b) \
        | torch.isnan(x)
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def _wilson(lower: bool):
    def fn(s, t, z):
        # z^2/(4t^2) as (z/t)^2/4: the interval collapses to p at z = 0
        p = s / t
        z2n = z * z / t
        center = p + z2n / 2.0
        half = z * torch.sqrt(p * (1 - p) / t + (z / t) * (z / t) / 4.0)
        return (center - half if lower else center + half) / (1.0 + z2n)
    return fn


def _ndtr(x):
    """The standard normal CDF as jax computes it: erfc in the tails, where
    torch.special.ndtr's 1 + erf(x) cancels to 0 below x ~ -8."""
    w = x * (0.5 * 2.0 ** 0.5)
    z = torch.abs(w)
    y = torch.where(z < 0.5 * 2.0 ** 0.5, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


_STATS = {
    "normal_cdf": lambda mean, sd, v: _ndtr((v - mean) / sd),
    "inverse_normal_cdf": lambda mean, sd, p: mean + sd * torch.special.ndtri(p),
    "beta_cdf": _betainc,
    "wilson_interval_lower": _wilson(True),
    "wilson_interval_upper": _wilson(False),
}


def _eval_cast(expr: Call, v, n):
    src = expr.args[0].type
    dst = expr.type
    dst_dt = torch_dtype(dst)
    if isinstance(dst, DecimalType):
        if isinstance(src, DecimalType):
            diff = dst.scale - src.scale
            v64 = v.to(torch.int64)
            out = v64 * (10**diff) if diff >= 0 else _div_round_half_up(v64, 10**-diff)
            return out, n
        if src.is_integer:
            return v.to(torch.int64) * (10**dst.scale), n
        if src.is_floating:
            return torch.round(v * (10**dst.scale)).to(torch.int64), n
    if dst.is_floating and isinstance(src, DecimalType):
        return v.to(dst_dt) / (10**src.scale), n
    if dst.is_floating or dst.is_integer or dst.name == "boolean":
        if isinstance(src, DecimalType) and dst.is_integer:
            return _div_round_half_up(v.to(torch.int64), 10**src.scale).to(dst_dt), n
        if dst.is_integer and v.is_floating_point():
            return _to_int(v, dst_dt), n
        return v.to(dst_dt), n
    if isinstance(dst, TimestampType) or isinstance(src, TimestampType):
        sp = src.precision if isinstance(src, TimestampType) else None
        dp = dst.precision if isinstance(dst, TimestampType) else None
        v64 = v.to(torch.int64)
        if sp is not None and dp is not None:  # rescale between precisions
            diff = dp - sp
            if diff >= 0:
                return v64 * (10 ** diff), n
            return _div_round_half_up(v64, 10 ** -diff), n  # narrowing: HALF UP
        if sp is None and src.name == "date":
            return v64 * (86400 * 10 ** dp), n
        if sp is not None and dst.name == "date":
            return _floordiv(_floordiv(v64, 10 ** sp), 86400).to(dst_dt), n
        raise NotImplementedError(
            f"cast {src.name} -> {dst.name} not supported (a fall-through "
            f"would reinterpret raw storage as timestamp units)")
    if dst.name.startswith("date") and src.name.startswith("varchar"):
        raise NotImplementedError("runtime varchar->date cast; planner folds literals")
    return v.to(dst_dt), n


def _div_round_half_up(num, den):
    """Decimal division with HALF_UP rounding on the magnitude."""
    a = torch.abs(num)
    absq = _floordiv(a, den)
    absr = a - absq * den
    rounded = absq + (absr * 2 >= den).to(absq.dtype)
    return torch.where(num < 0, -rounded, rounded)


def _extract_ymd(days):
    """Civil-from-days (Howard Hinnant's algorithm), vectorized; days since 1970-01-01."""
    z = days.to(torch.int64) + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    """Inverse of _extract_ymd (Howard Hinnant's days_from_civil), vectorized."""
    y = torch.where(m <= 2, y - 1, y)
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468
