"""Parameterized plan templates: bindability registry, value binding, and
statement parameterization.

Reference: the layer-1/3 EXECUTE path (QueryPreparer + Session.
preparedStatements) binds values into an already-prepared plan; TQP (arxiv
2203.01877) frames plans as tensor programs, whose serving analog is
compile-once/bind-per-request.  This module is the engine-side substrate:

- ``ParamRegistry`` collects, during TEMPLATE planning, one ``Binder`` per
  runtime parameter SLOT.  A slot is one occurrence of a ``Parameter`` IR
  node; AST duplication during planning (CASE operand expansion, routine
  inlining) can mint several slots for one ordinal, each with its own
  encoding (e.g. the same string ordinal compared against two differently-
  encoded columns).
- ``Binder.encode`` maps an EXECUTE literal AST to the raw device value the
  planned ``Parameter`` expects — dictionary ids for strings (the bind-time
  analog of the planner's per-distinct-value resolution), epoch days for
  dates, scaled ints for decimals.  Impossible bindings raise ``BindError``
  and the statement falls back to the substitution path for that execution.
- ``Unbindable`` aborts template CREATION: a constant that SHAPES the plan
  (LIMIT counts, LUT folds, plan-time string value dictionaries, interval
  arithmetic) cannot become a runtime input.  ``transient=True`` marks
  binding-specific failures (a NULL first binding carries no type) that must
  not negative-cache the template text.
- ``parameterize_text`` is the auto-parameterization pass: a token-level
  literal extraction that normalizes point-shaped ad-hoc SELECTs, so
  statements identical up to constants share one template without clients
  opting in.  It is deliberately conservative — positions whose literals are
  structural (LIMIT, GROUP BY/ORDER BY lists, type parameters, interval
  literals) stay inline; anything it gets wrong fails template creation and
  falls back, it can never change results.
- ``normalize_sql`` re-serializes the token stream (comments stripped,
  whitespace collapsed) — the plan-cache key normalization that stops
  trivially reformatted repeats of one statement from re-planning.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
import threading
from decimal import Decimal, InvalidOperation
from typing import Optional

import numpy as np

from ..types import (DATE, DecimalType, TimestampType, parse_date_literal,
                     parse_timestamp_literal)
from . import parser as A

__all__ = ["Binder", "ParamRegistry", "Unbindable", "BindError",
           "literal_param_value", "value_to_literal_ast", "marker_ordinals",
           "bind_markers", "bind_values", "values_cache_key",
           "parameterize_text", "normalize_sql", "RawSql"]


class Unbindable(Exception):
    """Template creation failure: a parameter position requires its value at
    PLAN time.  ``transient`` failures (typing from a NULL binding) retry on
    the next execution instead of negative-caching the template text."""

    def __init__(self, reason: str, transient: bool = False):
        super().__init__(reason)
        self.transient = transient


class BindError(ValueError):
    """A binding the planned template cannot represent (type-width overflow,
    finer timestamp precision, non-literal value).  The engine falls back to
    the substitution path for THIS execution; the template stays cached."""


@dataclasses.dataclass(frozen=True)
class RawSql:
    """A value the substitution path must splice VERBATIM (timestamp
    literals keep their own-precision text form)."""

    sql: str


@dataclasses.dataclass(frozen=True)
class Binder:
    """How one runtime parameter SLOT encodes a bound literal into the raw
    value domain its ``Parameter`` node was planned in."""

    ordinal: int  # which EXECUTE parameter feeds this slot
    type: object  # ir type of the Parameter node (device dtype + semantics)
    kind: str  # raw | dict | char | date | timestamp
    dict: object = None  # Dictionary for dict/char kinds (bind-time lookup)
    precision: int = 0  # timestamp kind: the template literal's precision

    def encode(self, lit):
        """EXECUTE literal AST -> (raw python value, isnull)."""
        neg = False
        while isinstance(lit, A.UnaryOp) and lit.op == "negate":
            neg = not neg
            lit = lit.operand
        if isinstance(lit, A.NullLit):
            return 0, True
        if self.kind in ("dict", "char"):
            if not isinstance(lit, A.StringLit) or neg:
                raise BindError(
                    f"parameter {self.ordinal + 1} expects a string literal")
            s = lit.value
            if self.kind == "char":
                n = self.type.length
                s = s[:n].ljust(n)
            # bind-time analog of the planner's Dictionary.lookup: a value
            # absent from the dictionary binds to -1, which compares unequal
            # to every id (exactly what plan-time resolution produces)
            return int(self.dict.lookup(s)), False
        if self.kind == "date":
            if isinstance(lit, A.DateLit) or isinstance(lit, A.StringLit):
                try:
                    return int(parse_date_literal(lit.value)), False
                except Exception as e:
                    raise BindError(f"bad date parameter: {e}") from e
            raise BindError(
                f"parameter {self.ordinal + 1} expects a date literal")
        if self.kind == "timestamp":
            if not isinstance(lit, (A.TimestampLit, A.StringLit)):
                raise BindError(
                    f"parameter {self.ordinal + 1} expects a timestamp literal")
            try:
                v, ty = parse_timestamp_literal(lit.value)
            except ValueError as e:
                raise BindError(str(e)) from e
            diff = self.precision - ty.precision
            if diff >= 0:
                scaled = int(v) * 10 ** diff
                if not -(1 << 63) <= scaled < (1 << 63):
                    raise BindError(
                        f"timestamp parameter beyond int64 at precision "
                        f"{self.precision}")
                return scaled, False
            scaled, rem = divmod(int(v), 10 ** -diff)
            if rem:
                # a finer literal than the template was planned at cannot
                # rescale losslessly — substitution keeps exact semantics
                raise BindError(
                    f"timestamp parameter finer than template precision "
                    f"{self.precision}")
            return scaled, False
        # raw: numeric/bool in the Parameter's own type
        t = self.type
        if isinstance(t, DecimalType):
            if not isinstance(lit, A.NumberLit):
                raise BindError(
                    f"parameter {self.ordinal + 1} expects a numeric literal")
            try:
                d = Decimal(lit.text)
            except InvalidOperation as e:
                raise BindError(str(e)) from e
            if neg:
                d = -d
            scaled = d.scaleb(t.scale)
            if scaled != scaled.to_integral_value():
                raise BindError(
                    f"decimal parameter {d} does not fit scale {t.scale}")
            raw = int(scaled)
            if not -(1 << 63) <= raw < (1 << 63):
                raise BindError(f"decimal parameter {d} beyond 2^63")
            return raw, False
        if t.name == "boolean":
            if not isinstance(lit, A.BoolLit):
                raise BindError(
                    f"parameter {self.ordinal + 1} expects a boolean literal")
            return bool(lit.value), False
        # (date-typed slots always register with kind="date" — both analyzer
        # sites — so the raw path below is numeric-only)
        if not isinstance(lit, A.NumberLit):
            raise BindError(
                f"parameter {self.ordinal + 1} expects a numeric literal")
        text = lit.text
        if t.is_floating:
            if "." not in text and "e" not in text.lower() \
                    and abs(int(text)) > (1 << 53):
                # an int-form literal beyond double's exact range would
                # silently round; substitution re-plans it as an exact BIGINT
                raise BindError(
                    f"integer literal {text} beyond exact double range in a "
                    "double-typed parameter position")
            v = float(text)
            return (-v if neg else v), False
        if "." in text or "e" in text.lower():
            raise BindError(
                f"parameter {self.ordinal + 1}: integer position bound a "
                f"fractional literal {text}")
        v = int(text)
        if neg:
            v = -v
        info = np.iinfo(np.dtype(t.dtype))
        if not info.min <= v <= info.max:
            # the template was typed from a narrower first binding; widening
            # would change the compiled program — substitution re-plans
            raise BindError(
                f"parameter {self.ordinal + 1} value {v} exceeds the "
                f"template's {t.name} range")
        return v, False


class ParamRegistry:
    """Planning-time collector: one ``Binder`` per minted Parameter slot."""

    def __init__(self, n_params: int):
        self.n_params = n_params
        self.binders: list = []

    def register(self, ordinal: int, type, kind: str = "raw", dict=None,
                 precision: int = 0) -> int:
        """Mint a runtime slot for ``ordinal`` and return its index."""
        if not 0 <= ordinal < self.n_params:
            raise Unbindable(f"parameter ordinal {ordinal} out of range")
        self.binders.append(Binder(ordinal, type, kind, dict, precision))
        return len(self.binders) - 1


# ---------------------------------------------------------------------------
# EXECUTE literal extraction (shared by the substitution path and binding)


def float_literal(v: float) -> str:
    """SQL text form of a python float, exponent-suffixed so it re-parses as
    DOUBLE: a bare "2.5" types as decimal(2,1) and computes in exact
    scaled-int arithmetic, diverging from double math by an ulp.  THE shared
    rule for the dbapi _quote substitution path and protocol-parameter AST
    construction — the two must agree exactly."""
    r = repr(v)
    if "e" in r or "E" in r or "inf" in r or "nan" in r:
        return r
    return r + "e0"


def literal_param_value(p):
    """EXECUTE parameter AST -> python value for text substitution and
    result-cache keying.  Raises a typed ValueError for unsupported AST kinds
    instead of silently mis-substituting."""
    neg = False
    while isinstance(p, A.UnaryOp) and p.op == "negate":
        neg = not neg
        p = p.operand
    if isinstance(p, A.NumberLit):
        t = p.text
        if "e" in t.lower():
            v = float(t)
        elif "." in t:
            v = Decimal(t)  # exact: float would corrupt wide decimals
        else:
            v = int(t)
        return -v if neg else v
    if neg:
        raise ValueError(
            f"unsupported EXECUTE parameter: negation of "
            f"{type(p).__name__} — parameters must be literals")
    if isinstance(p, A.StringLit):
        return p.value
    if isinstance(p, A.BoolLit):
        return bool(p.value)
    if isinstance(p, A.NullLit):
        return None
    if isinstance(p, A.DateLit):
        try:
            return datetime.date.fromisoformat(p.value)
        except ValueError as e:
            raise ValueError(f"bad date parameter {p.value!r}: {e}") from e
    if isinstance(p, A.TimestampLit):
        # keep the literal's own text (and so its precision) through the
        # substitution path verbatim
        return RawSql("timestamp '" + p.value.replace("'", "''") + "'")
    raise ValueError(
        f"unsupported EXECUTE parameter kind {type(p).__name__}: "
        "parameters must be literals")


def value_to_literal_ast(v):
    """Protocol parameter (python/JSON value) -> literal AST node."""
    if v is None:
        return A.NullLit()
    if isinstance(v, bool):
        return A.BoolLit(v)
    if isinstance(v, int):
        return (A.UnaryOp("negate", A.NumberLit(str(-v))) if v < 0
                else A.NumberLit(str(v)))
    if isinstance(v, float):
        node = A.NumberLit(float_literal(abs(v)))
        return A.UnaryOp("negate", node) if v < 0 else node
    if isinstance(v, Decimal):
        return (A.UnaryOp("negate", A.NumberLit(str(-v))) if v < 0
                else A.NumberLit(str(v)))
    if isinstance(v, datetime.datetime):
        return A.TimestampLit(v.isoformat(sep=" "))
    if isinstance(v, datetime.date):
        return A.DateLit(v.isoformat())
    if isinstance(v, str):
        return A.StringLit(v)
    raise ValueError(
        f"unsupported statement parameter of type {type(v).__name__}")


def literal_kinds(param_asts) -> tuple:
    """Per-ordinal literal KIND tags (negation-stripped AST class names).
    The template negative cache is scoped to these: an ill-typed binding
    (``c_mktsegment = 5``) must not poison the well-typed shape
    (``c_mktsegment = 'X'``) that normalizes to the same template text."""
    out = []
    for p in param_asts:
        while isinstance(p, A.UnaryOp) and p.op == "negate":
            p = p.operand
        out.append(type(p).__name__)
    return tuple(out)


def values_cache_key(param_asts) -> tuple:
    """Canonical per-ordinal value tuple for binding-specific result-cache
    keys: two bindings must never share an entry, so every value is tagged
    with its python type (1 vs '1' vs 1.0 stay distinct)."""
    out = []
    for p in param_asts:
        v = literal_param_value(p)
        out.append((type(v).__name__, str(v)))
    return tuple(out)


# ---------------------------------------------------------------------------
# marker plumbing


def _walk_ast(node, fn):
    if isinstance(node, A.Node):
        fn(node)
        for f in node.__dataclass_fields__:
            _walk_ast(getattr(node, f), fn)
    elif isinstance(node, tuple):
        for x in node:
            _walk_ast(x, fn)


def marker_ordinals(ast) -> set:
    """Ordinals of every ParamMarker in a parsed statement."""
    ords: set = set()
    _walk_ast(ast, lambda n: ords.add(n.ordinal)
              if isinstance(n, A.ParamMarker) else None)
    return ords


def bind_markers(ast, param_asts):
    """Rewrite each ParamMarker(i) into ParamLit(i, param_asts[i]): the
    representative literal types the parameter during analysis exactly as the
    substituted statement would."""
    from .analyzer import _rewrite_ast

    return _rewrite_ast(
        ast, lambda n: A.ParamLit(n.ordinal, param_asts[n.ordinal])
        if isinstance(n, A.ParamMarker) else n)


def bind_values(binders, param_asts):
    """Binders + EXECUTE literals -> the runtime slot tuple the executor
    threads into every dispatch: per slot, (0-d numpy value in the planned
    dtype, isnull)."""
    out = []
    for b in binders:
        if b.ordinal >= len(param_asts):
            raise BindError(f"missing parameter {b.ordinal + 1}")
        v, isnull = b.encode(param_asts[b.ordinal])
        try:
            out.append((np.asarray(0 if isnull else v,
                                   np.dtype(b.type.dtype)), bool(isnull)))
        except (OverflowError, ValueError) as e:
            # any conversion the planned dtype cannot represent demotes this
            # EXECUTION to substitution (the documented BindError contract),
            # never fails the statement
            raise BindError(str(e)) from e
    return tuple(out)


# ---------------------------------------------------------------------------
# statement text normalization + auto-parameterization

_BARE_IDENT = re.compile(r"[a-z_][a-z0-9_]*$")


def _serialize_token(t) -> str:
    if t.kind == "string":
        return "'" + t.value.replace("'", "''") + "'"
    if t.kind == "ident":
        if _BARE_IDENT.match(t.value) and t.value not in A.KEYWORDS:
            return t.value
        return '"' + t.value.replace('"', '""') + '"'
    return t.value


def normalize_sql(sql: str) -> str:
    """Comment-stripped, whitespace-collapsed serialization of the token
    stream — the plan-cache/template-cache key form.  Unlexable statements
    fall back to whitespace collapsing (they will fail parse identically
    either way, so key fidelity does not matter)."""
    try:
        toks = A.tokenize(sql)
    except A.ParseError:
        return " ".join(sql.split())
    return " ".join(_serialize_token(t) for t in toks if t.kind != "eof")


_MAX_AUTO_PARAMS = 16
# keywords that end a GROUP BY / ORDER BY element list for the extractor's
# purposes (coarse: suppressing extraction too long is safe, never wrong)
_BY_LIST_ENDERS = ("limit", "having", "where", "union", "intersect", "except")


def parameterize_text(sql: str):
    """Token-level literal extraction for point-shaped ad-hoc SELECTs:
    -> (template text with ``?`` markers, literal AST tuple), or None when the
    statement is not worth (or not safe to) auto-parameterize.

    Structural literal positions are kept inline so the extracted template
    has a chance to plan: LIMIT counts, GROUP BY / ORDER BY lists (ordinals),
    interval literals (plan-time folded), and type parameter lists after
    ``as`` (cast targets).  date/timestamp literal forms extract as ONE
    marker carrying their typed AST.  Anything this pass misjudges fails
    template creation and falls back to the ordinary path — extraction can
    reduce coverage, never correctness."""
    try:
        toks = [t for t in A.tokenize(sql) if t.kind != "eof"]
    except A.ParseError:
        return None
    if not toks or not (toks[0].kind == "keyword"
                        and toks[0].value == "select"):
        return None
    if any(t.kind == "op" and t.value == "?" for t in toks):
        return None  # explicit markers: the prepared-statement path owns it
    out: list = []
    lits: list = []
    in_by = False
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        if t.kind == "keyword" and t.value == "by":
            in_by = True
            out.append("by")
            i += 1
            continue
        if in_by and t.kind == "keyword" and t.value in _BY_LIST_ENDERS:
            in_by = False
        if t.kind == "keyword" and t.value == "as" and i + 2 < n \
                and toks[i + 1].kind == "ident" \
                and toks[i + 2].kind == "op" and toks[i + 2].value == "(":
            # cast(... as decimal(12, 2)): type parameters are structure
            out.append("as")
            out.append(_serialize_token(toks[i + 1]))
            out.append("(")
            i += 3
            depth = 1
            while i < n and depth:
                if toks[i].kind == "op" and toks[i].value == "(":
                    depth += 1
                elif toks[i].kind == "op" and toks[i].value == ")":
                    depth -= 1
                out.append(_serialize_token(toks[i]))
                i += 1
            continue
        if t.kind == "keyword" and t.value == "interval":
            # interval '90' day folds at plan time — keep it whole
            out.append("interval")
            i += 1
            if i < n and toks[i].kind == "op" and toks[i].value == "-":
                out.append("-")
                i += 1
            if i < n and toks[i].kind == "string":
                out.append(_serialize_token(toks[i]))
                i += 1
            if i < n and toks[i].kind in ("ident", "keyword"):
                out.append(_serialize_token(toks[i]))
                i += 1
            continue
        if not in_by and t.kind == "keyword" and t.value == "date" \
                and i + 1 < n and toks[i + 1].kind == "string":
            lits.append(A.DateLit(toks[i + 1].value))
            out.append("?")
            i += 2
            continue
        if not in_by and t.kind == "ident" and t.value == "timestamp" \
                and i + 1 < n and toks[i + 1].kind == "string":
            lits.append(A.TimestampLit(toks[i + 1].value))
            out.append("?")
            i += 2
            continue
        if t.kind == "keyword" and t.value == "limit":
            # LIMIT shapes the plan (TopN fusion, parser-level int): inline
            out.append("limit")
            i += 1
            if i < n and toks[i].kind == "number":
                out.append(toks[i].value)
                i += 1
            continue
        if not in_by and t.kind == "number":
            lits.append(A.NumberLit(t.value))
            out.append("?")
            i += 1
            continue
        if not in_by and t.kind == "string":
            lits.append(A.StringLit(t.value))
            out.append("?")
            i += 1
            continue
        out.append(_serialize_token(t))
        i += 1
    if not lits or len(lits) > _MAX_AUTO_PARAMS:
        return None
    return " ".join(out), tuple(lits)
