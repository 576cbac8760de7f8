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

Only the calls that TPC-H and the TPC-DS corpus reach
are ported; any other call raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..types import DecimalType, Type, torch_dtype

__all__ = ["Expr", "Constant", "FieldRef", "Call", "Parameter",
           "evaluate", "evaluate_predicate"]


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
    """A runtime statement parameter (plan templates, not ported: evaluating
    one raises)."""

    slot: int
    type: Type

    def __repr__(self):
        return f"?[{self.slot}]:{self.type.name}"


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


def evaluate(expr: Expr, columns: Sequence, null_masks: Sequence):
    """Evaluate ``expr`` over columnar inputs; returns (values, null_mask|None)."""
    return _evaluate(expr, columns, null_masks, _device_of(columns))


def _evaluate(expr, columns, null_masks, device):
    if isinstance(expr, Constant):
        if isinstance(expr.value, np.ndarray):
            return torch.as_tensor(expr.value, device=device), None
        dt = torch_dtype(expr.type)
        if expr.value is None:
            return (torch.zeros((), dtype=dt, device=device),
                    torch.ones((), dtype=torch.bool, device=device))
        return torch.tensor(expr.value, dtype=dt, device=device), None
    if isinstance(expr, FieldRef):
        return columns[expr.index], null_masks[expr.index]
    if isinstance(expr, Parameter):
        raise NotImplementedError(
            "runtime parameters (plan templates) are not ported")
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
    raise NotImplementedError(f"scalar op {op!r} is not ported to trino_tpu_torch")


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
        return v.to(dst_dt), n
    if dst.name.startswith("timestamp") or src.name.startswith("timestamp"):
        raise NotImplementedError(
            f"cast {src.name} -> {dst.name} is not ported to trino_tpu_torch")
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
