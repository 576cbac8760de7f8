"""Engine facade of the PyTorch port (counterpart of ``trino_tpu/engine.py``, slim):
catalogs, sessions, and the statement entry point.

``execute_sql`` parses, plans SELECTs with the planner copied from the
reference (``Planner(self, session).plan_query``) and runs the plan on one
device through ``LocalExecutor``.  Every other statement goes to
``_execute_statement``, the port of the reference's statement layer: views,
SQL routines, tables (CREATE, CTAS, INSERT, DROP), materialized views and
row-level DML (DELETE, UPDATE, MERGE) over a writable catalog such as
``connectors/memory.MemoryConnector``.  DDL returns ``None`` and DML the
affected-row count, as in the reference.

Writes are vectorised with numpy where the reference walks python lists:
a query result whose column type equals the target's is written from its
raw (storage-form) columns, and the per-value coercion of the reference
(``_coerce_host``) runs only where a coercion happens (``INSERT ... VALUES``,
mismatched types).

Not ported: PREPARE / EXECUTE / DEALLOCATE, SET / RESET SESSION, SHOW,
EXPLAIN and GRANT / REVOKE raise ``NotImplementedError`` naming the
statement; access control (the reference's default allows every
statement) and the plan, result and buffer caches that the reference's
``_invalidate`` clears.  Nor are the reference's other services (plan
templates, batching, adaptive advice, history, flight recorder,
fault-tolerant and distributed execution).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Engine", "Session"]


@dataclasses.dataclass
class Session:
    catalog: Optional[str] = None
    schema: Optional[str] = None
    user: str = "user"
    properties: dict = dataclasses.field(default_factory=dict)


def _resolve_device(device) -> torch.device:
    """``None`` means the card; without one the caller must ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run trino_tpu_torch on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


# statements the port refuses, by the SQL that names them
_NOT_PORTED = {
    "Prepare": "PREPARE", "ExecutePrepared": "EXECUTE", "Deallocate": "DEALLOCATE",
    "SetSession": "SET SESSION", "ResetSession": "RESET SESSION", "Show": "SHOW",
    "Explain": "EXPLAIN", "Grant": "GRANT",
}


class Engine:
    def __init__(self, device=None):
        from .memory import MemoryPool

        self.device = _resolve_device(device)
        self.catalogs: dict = {}
        self.sql_routines: dict = {}  # name -> (params, return_type, body AST)
        self.views: dict = {}  # name -> (column_aliases, Select AST)
        # name -> {"query": AST, "storage": table, "catalog": name,
        # "session_catalog": name}
        self.materialized_views: dict = {}
        self.memory_pool = MemoryPool(device=self.device)
        # device -> host reads and bytes, and host -> device bytes, of the
        # most recent execute_sql (its plan-time subqueries and a statement's
        # inner queries included) or bare execute_plan
        self.last_query_counters: dict = {}
        self._sql_totals: Optional[dict] = None

    def register_catalog(self, name: str, connector) -> None:
        """Register a connector; one without a device works on the engine's."""
        if getattr(connector, "device", False) is None:
            connector.device = self.device
        self.catalogs[name] = connector

    def create_session(self, catalog: Optional[str] = None,
                       schema: str = "default") -> Session:
        return Session(catalog=catalog, schema=schema)

    def execute_plan(self, plan, cache: bool = True):
        """Run a plan to a host-side ``MaterializedResult`` (also the
        planner's entry point for eager subqueries, which pass
        ``cache=False``; the port keeps no plan caches either way)."""
        from .exec.local_executor import LocalExecutor

        ex = LocalExecutor(self.catalogs, self.device, memory_pool=self.memory_pool)
        try:
            return ex.execute(plan)
        finally:
            self.last_query_counters = {"host_reads": ex.host_reads,
                                        "host_bytes": ex.host_bytes,
                                        "h2d_bytes": ex.h2d_bytes}
            if self._sql_totals is not None:
                for k, v in self.last_query_counters.items():
                    self._sql_totals[k] += v

    def execute_sql(self, sql: str, session: Optional[Session] = None):
        """Statement entry point: a SELECT is parsed, planned and executed;
        any other statement runs through ``_execute_statement``."""
        from .sql import parser as A
        from .sql.frontend import Planner

        sess = session or Session()
        ast = A.parse(sql)
        self._sql_totals = totals = {"host_reads": 0, "host_bytes": 0, "h2d_bytes": 0}
        try:
            if not isinstance(ast, (A.Select, A.SetOp)):
                return self._execute_statement(ast, sess)
            # scalar and EXISTS subqueries execute while the query plans
            plan = Planner(self, sess).plan_query(ast)
            return self.execute_plan(plan)
        finally:
            self._sql_totals = None
            self.last_query_counters = totals

    # -- statements (reference: Engine._execute_statement) ----------------------
    def _execute_statement(self, ast, sess: Session):
        from .sql import parser as A

        kind = type(ast).__name__
        if kind in _NOT_PORTED:
            what = "REVOKE" if getattr(ast, "revoke", False) else _NOT_PORTED[kind]
            raise NotImplementedError(
                f"{what} statements ({kind}) are not ported to trino_tpu_torch")
        if isinstance(ast, A.Delete):
            return self._delete(ast, sess)
        if isinstance(ast, A.Update):
            return self._update(ast, sess)
        if isinstance(ast, A.Merge):
            return self._merge(ast, sess)
        if isinstance(ast, A.CreateView):
            if not ast.or_replace and ast.name in self.views:
                raise ValueError(f"view {ast.name} already exists")
            self.views[ast.name] = ((), ast.query)
            return None
        if isinstance(ast, A.CreateFunction):
            # inline SQL routine (reference: CreateFunctionTask + sql/routine/
            # SqlRoutineCompiler -- an expression body inlines at call sites)
            from .sql import functions as FN
            from .sql.frontend import AGG_FUNCS, Planner

            if FN.lookup(ast.name) is not None or ast.name in AGG_FUNCS \
                    or ast.name in Planner._COLLECTION_FUNCS:
                # built-ins resolve first at call sites, so a shadowing
                # routine would be silently dead: reject it up front
                raise ValueError(f"function {ast.name} conflicts with a built-in")
            if not ast.or_replace and ast.name in self.sql_routines:
                raise ValueError(f"function {ast.name} already exists")
            self.sql_routines[ast.name] = (ast.params, ast.return_type, ast.body)
            return None
        if isinstance(ast, A.DropFunction):
            if ast.name not in self.sql_routines and not ast.if_exists:
                raise ValueError(f"function {ast.name} does not exist")
            self.sql_routines.pop(ast.name, None)
            return None
        if isinstance(ast, A.DropView):
            if ast.name not in self.views and not ast.if_exists:
                raise ValueError(f"view {ast.name} does not exist")
            self.views.pop(ast.name, None)
            return None
        if isinstance(ast, A.CreateTable):
            return self._create_table(ast, sess)
        if isinstance(ast, A.InsertInto):
            return self._insert(ast, sess)
        if isinstance(ast, A.CreateMaterializedView):
            return self._create_materialized_view(ast, sess)
        if isinstance(ast, A.RefreshMaterializedView):
            return self._refresh_materialized_view(ast, sess)
        if isinstance(ast, A.DropMaterializedView):
            mv = self.materialized_views.get(ast.name)
            if mv is None:
                if ast.if_exists:
                    return None
                raise ValueError(f"materialized view {ast.name} does not exist")
            del self.materialized_views[ast.name]
            self.catalogs[mv["catalog"]].drop_table(mv["storage"], True)
            return None
        if isinstance(ast, A.DropTable):
            self._writable_catalog(sess).drop_table(ast.name, ast.if_exists)
            return None
        raise ValueError(f"unsupported statement {kind}")

    def _writable_catalog(self, sess: Session):
        cand = self.catalogs.get(sess.catalog)
        if cand is not None and hasattr(cand, "create_table"):
            return cand
        for c in self.catalogs.values():
            if hasattr(c, "create_table"):
                return c
        raise ValueError("no writable catalog registered (register a MemoryConnector)")

    def _catalog_name_of(self, conn) -> str:
        for name, c in self.catalogs.items():
            if c is conn:
                return name
        return "?"

    def _create_table(self, ast, sess: Session):
        from .page import Field, Schema
        from .sql.frontend import Planner, _type_from_name

        conn = self._writable_catalog(sess)
        if ast.as_query is not None:  # CTAS
            src_plan = Planner(self, sess).plan_query(ast.as_query)
            res = self.execute_plan(src_plan, cache=False)
            schema = Schema(tuple(Field(n, t) for n, t in zip(res.names, res.types)))
            created = conn.create_table(ast.name, schema, ast.if_not_exists)
            if created is not False:  # IF NOT EXISTS on an existing table: skip insert
                conn.append(ast.name, [_write_column(res, i) for i in range(len(res.names))])
        else:
            fields = tuple(Field(n, _type_from_name(tn, params))
                           for n, tn, params in ast.columns)
            props = dict(getattr(ast, "properties", ()) or ())
            part = props.pop("partitioned_by", None)
            if props:
                raise ValueError(f"unsupported table properties: {sorted(props)}")
            if part is not None:
                if not isinstance(part, (tuple, list)):
                    raise ValueError("partitioned_by must be ARRAY['col', ...]")
                # no connector of the port takes partitions (hive and iceberg
                # are not ported)
                raise ValueError("this catalog does not support partitioned_by")
            conn.create_table(ast.name, Schema(fields), if_not_exists=ast.if_not_exists)
        return None

    def _create_materialized_view(self, ast, sess: Session):
        """Materialize the query into a storage table in the writable catalog
        and record the definition (reference: CreateMaterializedViewTask;
        queries read the STORAGE table, so results are as of the last
        refresh)."""
        from .page import Field, Schema
        from .sql.frontend import Planner

        existing = self.materialized_views.get(ast.name)
        if existing is not None and not ast.or_replace:
            raise ValueError(f"materialized view {ast.name} already exists")
        if existing is not None:
            # replace/refresh stays in the DEFINING catalog
            conn = self.catalogs[existing["catalog"]]
            cat = existing["catalog"]
        else:
            conn = self._writable_catalog(sess)
            cat = self._catalog_name_of(conn)
        storage = f"__mv_{ast.name}"
        res = self.execute_plan(Planner(self, sess).plan_query(ast.query), cache=False)
        conn.drop_table(storage, True)
        conn.create_table(storage, Schema(tuple(Field(n, t)
                                                for n, t in zip(res.names, res.types))))
        conn.append(storage, [_write_column(res, i) for i in range(len(res.names))])
        self.materialized_views[ast.name] = {
            "query": ast.query, "storage": storage, "catalog": cat,
            "session_catalog": sess.catalog}
        return None

    def _refresh_materialized_view(self, ast, sess: Session):
        from .sql import parser as A

        mv = self.materialized_views.get(ast.name)
        if mv is None:
            raise ValueError(f"materialized view {ast.name} does not exist")
        # the definition re-plans under the DEFINING session catalog
        refresh_sess = Session(catalog=mv.get("session_catalog"), user=sess.user)
        return self._create_materialized_view(
            A.CreateMaterializedView(ast.name, mv["query"], or_replace=True), refresh_sess)

    def _insert(self, ast, sess: Session):
        from .sql import parser as A
        from .sql.frontend import Planner

        conn = self._writable_catalog(sess)
        schema = conn.schema(ast.name)
        names = ast.columns or schema.names
        if isinstance(ast.query, A.ValuesRows):
            cols = _literal_rows_to_columns(ast.query.rows,
                                            [schema.field(n).type for n in names])
        else:
            res = self.execute_plan(Planner(self, sess).plan_query(ast.query), cache=False)
            if len(res.columns) != len(names):
                raise ValueError(
                    f"INSERT has {len(names)} target columns but the query "
                    f"produces {len(res.columns)}")
            cols = [_write_column(res, i, schema.field(n).type) for i, n in enumerate(names)]
        n_rows = len(cols[0]) if cols else 0
        if tuple(names) != schema.names:
            by_name = dict(zip(names, cols))
            cols = [by_name.get(f.name, [None] * n_rows) for f in schema.fields]
        conn.append(ast.name, cols)
        return _dml_count_result(n_rows)

    # -- row-level DML (reference: spi/connector/ConnectorMergeSink -- DELETE
    # and UPDATE funnel through the merge surface; the engine evaluates the
    # per-row predicate/assignments and the connector applies them) ----------
    def _eval_rowwise(self, table: str, exprs, sess: Session):
        """Evaluate expressions per row of `table` in storage order."""
        from .sql import parser as A
        from .sql.frontend import Planner

        items = tuple(A.SelectItem(e, f"c{i}") for i, e in enumerate(exprs))
        sel = A.Select(items=items, from_=A.TableRef((table,), None), where=None,
                       group_by=(), having=None, order_by=(), limit=None)
        return self.execute_plan(Planner(self, sess).plan_query(sel), cache=False)

    def _dml_target(self, table: str, sess: Session):
        conn = self._writable_catalog(sess)
        if table not in conn.tables():
            raise ValueError(f"table {table} does not exist")
        return conn

    @staticmethod
    def _dml_mask(col) -> np.ndarray:
        """A predicate column as a row mask: NULL is False."""
        from .connectors.memory import is_none

        col = np.asarray(col)
        if col.dtype != object:
            return col.astype(bool)
        none = is_none(col)
        return np.where(none, False, col).astype(bool)

    def _delete(self, ast, sess: Session):
        from .sql import parser as A

        conn = self._dml_target(ast.table, sess)
        res = self._eval_rowwise(ast.table, [ast.where or A.BoolLit(True)], sess)
        return _dml_count_result(conn.delete_rows(ast.table, self._dml_mask(res.columns[0])))

    @staticmethod
    def _assignment_casts(schema, assignments, rewrite=lambda e: e):
        """Split SET assignments into constant strings/NULLs (which bypass
        row-wise planning: strings live as dictionary ids bound to a column)
        and expressions cast to the column's type."""
        from .sql import parser as A

        const, exprs = {}, []
        for col, e in assignments:
            f = schema.field(col)  # raises on unknown column
            if isinstance(e, A.StringLit):
                const[col] = e.value
            elif isinstance(e, A.NullLit):
                const[col] = None
            else:
                base = f.type.name.split("(")[0]
                params = ()
                if "(" in f.type.name:
                    params = tuple(int(x) for x in
                                   f.type.name[f.type.name.index("(") + 1:-1].split(","))
                exprs.append((col, A.Cast(rewrite(e), base, params)))
        return const, exprs

    def _update(self, ast, sess: Session):
        from .sql import parser as A

        conn = self._dml_target(ast.table, sess)
        const_assigns, expr_assigns = self._assignment_casts(conn.schema(ast.table),
                                                             ast.assignments)
        exprs = [ast.where or A.BoolLit(True)] + [e for _, e in expr_assigns]
        res = self._eval_rowwise(ast.table, exprs, sess)
        mask = self._dml_mask(res.columns[0])
        values = {col: _constant_column(v, len(mask)) for col, v in const_assigns.items()}
        for j, (col, _) in enumerate(expr_assigns):
            values[col] = _write_column(res, j + 1)
        return _dml_count_result(conn.update_rows(ast.table, mask, values))

    def _merge(self, ast, sess: Session):
        """MERGE INTO: match target rows against a source relation on
        equi-keys, then apply WHEN MATCHED updates/deletes and WHEN NOT
        MATCHED inserts.

        As in the reference, the pairing happens on the host and each
        clause's conditions and assignments are evaluated by the engine
        itself over scratch memory tables (``pairs``: one row per target row
        with its matched source row beside it; ``src``: the source rows),
        which live on the engine's device.  The pairing is vectorised
        (``_pair_rows``); ``pairs`` is built only when a WHEN MATCHED clause
        has matched rows to route, the only reader of it."""
        from .connectors.memory import MemoryConnector
        from .page import Field, Schema
        from .sql import parser as A

        conn = self._dml_target(ast.target, sess)
        tgt_schema = conn.schema(ast.target)
        tgt_cols = list(tgt_schema.names)

        # ---- the source relation (decoded + raw)
        if isinstance(ast.source, str):
            if ast.source not in conn.tables():
                raise ValueError(f"table {ast.source} does not exist")
            src_cols = list(conn.schema(ast.source).names)
            src_res = self._eval_rowwise(
                ast.source, [A.Identifier((c,)) for c in src_cols], sess)
        else:
            from .sql.frontend import Planner

            src_res = self.execute_plan(Planner(self, sess).plan_query(ast.source),
                                        cache=False)
            src_cols = list(src_res.names)

        # ---- equi-key pairs from the ON condition
        def conjuncts(e):
            if isinstance(e, A.BinaryOp) and e.op == "and":
                return conjuncts(e.left) + conjuncts(e.right)
            return [e]

        def classify(ident):
            parts = ident.parts
            if len(parts) == 2:
                alias, c = parts
                if alias == ast.target_alias and c in tgt_cols:
                    return ("t", c)
                if alias == ast.source_alias and c in src_cols:
                    return ("s", c)
                raise ValueError(f"MERGE: cannot resolve {'.'.join(parts)}")
            c = parts[0]
            in_t, in_s = c in tgt_cols, c in src_cols
            if in_t and in_s:
                raise ValueError(f"MERGE: column {c} is ambiguous")
            if in_t:
                return ("t", c)
            if in_s:
                return ("s", c)
            raise ValueError(f"MERGE: unknown column {c}")

        keys = []
        for cj in conjuncts(ast.on):
            if not (isinstance(cj, A.BinaryOp) and cj.op == "eq"
                    and isinstance(cj.left, A.Identifier)
                    and isinstance(cj.right, A.Identifier)):
                raise ValueError("MERGE ON must be a conjunction of column equalities")
            a, b = classify(cj.left), classify(cj.right)
            if a[0] == b[0]:
                raise ValueError("MERGE ON equality must pair target with source")
            keys.append((a[1], b[1]) if a[0] == "t" else (b[1], a[1]))

        # DECODED values compare: raw storage differs across decimal scales
        tgt_key_res = self._eval_rowwise(
            ast.target, [A.Identifier((tc,)) for tc, _ in keys], sess)
        tgt_keys = list(tgt_key_res.columns)
        src_keys = [src_res.columns[src_cols.index(sc)] for _, sc in keys]
        n_tgt = len(tgt_key_res)
        n_src = len(src_res)
        match_of, src_matched = _pair_rows(tgt_keys, src_keys)

        # ---- scratch relations the engine evaluates clause exprs over
        scratch = MemoryConnector(device=self.device)
        src_fields = [Field(f"s_{c}", src_res.types[src_cols.index(c)]) for c in src_cols]
        scratch.create_table("src", Schema(tuple(src_fields)))
        if n_src:
            scratch.append("src", [_write_column(src_res, src_cols.index(c))
                                   for c in src_cols])

        def build_pairs():
            if "pairs" in scratch.tables():
                return
            tgt_res = self._eval_rowwise(
                ast.target, [A.Identifier((c,)) for c in tgt_cols], sess)
            fields = [Field(f"t_{c}", tgt_schema.field(c).type) for c in tgt_cols] + src_fields
            scratch.create_table("pairs", Schema(tuple(fields)))
            cols = [_write_column(tgt_res, i) for i in range(len(tgt_cols))]
            cols += [_take(_write_column(src_res, src_cols.index(c)), match_of)
                     for c in src_cols]
            if n_tgt:
                scratch.append("pairs", cols)

        import uuid

        # unique per statement: a shared name would let one MERGE read
        # another's scratch rows
        cat_name = f"__merge_scratch_{uuid.uuid4().hex[:12]}__"
        self.catalogs[cat_name] = scratch
        scratch_sess = dataclasses.replace(sess, catalog=cat_name)
        try:
            def rewrite(e, in_matched):
                if isinstance(e, A.Identifier):
                    side, c = classify(e)
                    if side == "t" and not in_matched:
                        raise ValueError("WHEN NOT MATCHED cannot reference the target")
                    return A.Identifier(((f"{side}_{c}"),))
                if dataclasses.is_dataclass(e) and not isinstance(e, type):
                    ch = {}
                    for f in dataclasses.fields(e):
                        v = getattr(e, f.name)
                        nv = rewrite_any(v, in_matched)
                        if nv is not v:
                            ch[f.name] = nv
                    return dataclasses.replace(e, **ch) if ch else e
                return e

            def rewrite_any(v, in_matched):
                if isinstance(v, tuple):
                    return tuple(rewrite_any(x, in_matched) for x in v)
                if dataclasses.is_dataclass(v) and not isinstance(v, type):
                    return rewrite(v, in_matched)
                return v

            for cl in ast.clauses:  # arity errors must precede ANY mutation
                if cl.action == "insert":
                    names = list(cl.columns) or tgt_cols
                    if len(cl.values) != len(names):
                        raise ValueError(f"MERGE INSERT has {len(names)} columns but "
                                         f"{len(cl.values)} values")

            remaining = match_of >= 0
            delete_mask = np.zeros(n_tgt, bool)
            update_ops = []  # (mask, clause) applied after clause routing
            src_remaining = ~src_matched
            inserts = []  # (mask, clause)
            for cl in ast.clauses:
                if cl.matched:
                    if not remaining.any():
                        continue
                    if cl.condition is not None:
                        build_pairs()
                        cres = self._eval_rowwise(
                            "pairs", [rewrite(cl.condition, True)], scratch_sess)
                        cm = self._dml_mask(cres.columns[0])
                    else:
                        cm = np.ones(n_tgt, bool)
                    mask = remaining & cm
                    remaining &= ~mask
                    if cl.action == "delete":
                        delete_mask |= mask
                    else:
                        update_ops.append((mask, cl))
                else:
                    if cl.condition is not None and n_src:
                        cres = self._eval_rowwise(
                            "src", [rewrite(cl.condition, False)], scratch_sess)
                        cm = self._dml_mask(cres.columns[0])
                    else:
                        cm = np.ones(n_src, bool)
                    mask = src_remaining & cm
                    src_remaining &= ~mask
                    inserts.append((mask, cl))

            # ---- apply updates (row count unchanged), then deletes, then inserts
            for mask, cl in update_ops:
                if not mask.any():
                    continue
                const, expr_assigns = self._assignment_casts(
                    tgt_schema, cl.assignments, lambda e: rewrite(e, True))
                values = {col: _constant_column(v, n_tgt) for col, v in const.items()}
                if expr_assigns:  # one scan evaluates every assignment of the clause
                    build_pairs()
                    vres = self._eval_rowwise("pairs", [e for _, e in expr_assigns],
                                              scratch_sess)
                    for j, (col, _) in enumerate(expr_assigns):
                        values[col] = _write_column(vres, j)
                conn.update_rows(ast.target, mask, values)
            if delete_mask.any():
                conn.delete_rows(ast.target, delete_mask)
            for mask, cl in inserts:
                if not mask.any():
                    continue
                names = list(cl.columns) or tgt_cols
                vres = self._eval_rowwise(
                    "src", [rewrite(e, False) for e in cl.values], scratch_sess)
                rows = np.flatnonzero(mask)
                cols_by_name = {nm: _take(_write_column(vres, j, tgt_schema.field(nm).type),
                                          rows)
                                for j, nm in enumerate(names)}
                conn.append(ast.target, [cols_by_name.get(f.name, [None] * len(rows))
                                         for f in tgt_schema.fields])
        finally:
            del self.catalogs[cat_name]
        return None


# -- the write path ----------------------------------------------------------------------


def _write_column(res, i, dst_t=None):
    """Column ``i`` of a query result in the form a connector writes.  Where
    the result's type is the target's (``dst_t`` None: the same type), the
    raw column is taken as it is (``Raw``, or ``Coded`` for strings: each
    distinct dictionary id's decoded string), nulls from the decoded
    column's ``None``; otherwise the decoded values through the reference's
    per-value coercion (``_coerce_host``)."""
    from .connectors.memory import Coded, Raw, first_seen, is_none
    from .types import ArrayType, MapType

    t = res.types[i]
    dec = res.columns[i]
    if dst_t is not None and dst_t != t:
        return _coerce_host(list(dec), t, dst_t)
    if isinstance(t, (ArrayType, MapType)):
        # the reference's per-value coercion, which takes no list (its known
        # gap: CTAS and INSERT ... SELECT of an array-valued query raise)
        return _coerce_host(list(dec), t, t)
    nulls = is_none(dec)
    raw = np.asarray(res.raw_columns[i])
    if t.is_string:
        codes = np.zeros(len(raw), np.int64)
        live = np.flatnonzero(~nulls)
        values = np.empty(0, object)
        if len(live):
            _, first, codes[live] = first_seen(raw[live])
            values = np.asarray(dec)[live[first]]
        return Coded(codes, values, nulls)
    return Raw(raw, nulls)


def _constant_column(value, n: int):
    """One SET value (a string or NULL) for each of ``n`` rows."""
    from .connectors.memory import Coded

    if value is None:
        return [None] * n
    return Coded(np.zeros(n, np.int64), np.array([value], dtype=object), np.zeros(n, bool))


def _take(col, rows):
    """Rows ``rows`` of a written column; a row index below 0 is NULL."""
    from .connectors.memory import Coded, Raw

    rows = np.asarray(rows, np.int64)
    miss = rows < 0
    at = np.where(miss, 0, rows)
    if isinstance(col, Raw):
        if not len(col):
            return Raw(np.zeros(len(rows), col.values.dtype), np.ones(len(rows), bool))
        return Raw(np.where(miss, 0, col.values[at]), miss | col.nulls[at])
    if isinstance(col, Coded):
        if not len(col):
            return Coded(np.zeros(len(rows), np.int64), col.values, np.ones(len(rows), bool))
        return Coded(np.where(miss, 0, col.codes[at]), col.values, miss | col.nulls[at])
    return [None if r < 0 else col[r] for r in rows.tolist()]


def _key_array(col):
    """(values, usable) of a decoded ON-key column for pairing: values as a
    typed numpy array where they are numbers of one kind, else as python
    objects (strings, dates); usable False where the key is NULL or NaN
    (neither matches anything, as in the reference, where two NaN objects
    never compare equal).  An unusable slot holds a usable value of the
    column, so that every slot sorts."""
    from .connectors.memory import is_none

    col = np.asarray(col)
    none = is_none(col)
    if col.dtype == object:
        live = col[~none]
        typed = np.asarray(live.tolist()) if len(live) else np.zeros(0, np.int64)
        if typed.ndim != 1 or typed.dtype.kind in "USO":
            typed = live
        out = np.zeros(len(col), typed.dtype)
        out[~none] = typed
        col = out
    if col.dtype.kind in "US":
        col = col.astype(object)
    usable = ~none
    if col.dtype.kind == "f":
        usable &= ~np.isnan(col)
    if usable.any() and not usable.all():
        col = np.where(usable, col, col[usable][0])
    return col, usable


def _pair_rows(tgt_keys, src_keys):
    """(match_of, src_matched): the source row each target row matches on
    all key columns (-1: none) and which source rows some target row
    matched.  Keys compare by decoded value, as python compares them; NULL
    keys never match; a target row that matches two source rows raises.
    Each key column's values on both sides get one dense code through
    ``np.unique``: as typed arrays where both sides are numbers of one kind,
    else as python objects, which compare an integer and a float exactly
    (an int64 key against a DECIMAL's float past 2^53)."""
    n_t = len(tgt_keys[0]) if tgt_keys else 0
    n_s = len(src_keys[0]) if src_keys else 0
    match_of = np.full(n_t, -1, np.int64)
    src_matched = np.zeros(n_s, bool)
    t_code = np.zeros(n_t, np.int64)
    s_code = np.zeros(n_s, np.int64)
    t_ok = np.ones(n_t, bool)
    s_ok = np.ones(n_s, bool)
    for tk, sk in zip(tgt_keys, src_keys):
        (a, a_ok), (b, b_ok) = _key_array(tk), _key_array(sk)
        t_ok &= a_ok
        s_ok &= b_ok
        if not t_ok.any() or not s_ok.any():
            return match_of, src_matched
        if a.dtype.kind != b.dtype.kind or a.dtype == object:
            a, b = a.astype(object), b.astype(object)
            if not _comparable(a[a_ok][0], b[b_ok][0]):
                return match_of, src_matched  # a string never equals a number
        _, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
        card = int(inv.max()) + 1
        _, comb = np.unique(np.concatenate([t_code, s_code]) * card + inv, return_inverse=True)
        comb = comb.reshape(-1).astype(np.int64)
        t_code, s_code = comb[:n_t], comb[n_t:]
    s_rows = np.flatnonzero(s_ok)
    uniq, first, counts = np.unique(s_code[s_rows], return_index=True, return_counts=True)
    pos = np.minimum(np.searchsorted(uniq, t_code), len(uniq) - 1)
    found = t_ok & (uniq[pos] == t_code)
    if (counts[pos[found]] > 1).any():
        raise ValueError("MERGE: one target row matched more than one source row")
    match_of[found] = s_rows[first[pos[found]]]
    src_matched[match_of[found]] = True
    return match_of, src_matched


def _comparable(x, y) -> bool:
    """Whether python may find two key values equal: two numbers (an int, a
    float and a Decimal compare exactly) or two values of one type.  A key
    column's values are of one SQL type, so one value of each side decides."""
    import numbers

    both_numbers = isinstance(x, numbers.Number) and isinstance(y, numbers.Number)
    return both_numbers or type(x) is type(y)


def _coerce_host(values, src_t, dst_t):
    """Host-side value coercion for writes (decoded python objects -> storage
    repr: decimals as raw scaled ints, strings as str, dates as epoch days)."""
    import datetime

    from .types import DecimalType, TimestampType

    if isinstance(dst_t, DecimalType):
        from decimal import Decimal

        s = dst_t.scale
        out = []
        for v in values:
            if v is None:
                out.append(None)
                continue
            if isinstance(v, float):
                raw = round(v * 10**s)
            else:
                # int / str / Decimal: exact scaling, no float round-trip
                raw = int(Decimal(str(v)).scaleb(s).to_integral_value())
            if not -(1 << 63) <= raw < (1 << 63):
                raise ValueError(
                    f"decimal value {v} beyond 2^63: Int128 column storage "
                    "is not supported (declared wide precision is, for "
                    "values that fit)")
            out.append(raw)
        return out
    if dst_t.is_string:
        return [None if v is None else str(v) for v in values]
    if dst_t.is_floating:
        return [None if v is None else float(v) for v in values]
    if dst_t.name == "date":
        out = []
        for v in values:
            if v is None:
                out.append(None)
            elif isinstance(v, np.datetime64):
                out.append(int(v.astype("datetime64[D]").astype(np.int64)))
            elif isinstance(v, datetime.date):
                out.append((v - datetime.date(1970, 1, 1)).days)
            else:
                out.append(int(v))
        return out
    if isinstance(dst_t, TimestampType):
        unit = "us" if dst_t.precision <= 6 else "ns"
        back = 10 ** ((6 if unit == "us" else 9) - dst_t.precision)
        return [None if v is None else
                (int(v.astype(f"datetime64[{unit}]").astype(np.int64)) // back
                 if isinstance(v, np.datetime64) else int(v))
                for v in values]
    return [None if v is None else int(v) for v in values]


def _literal_rows_to_columns(rows, types):
    """INSERT ... VALUES literal evaluation (coordinator-side, like the
    reference's ValuesNode constant folding)."""
    cols = [[] for _ in types]
    for row in rows:
        if len(row) != len(types):
            raise ValueError(f"VALUES row has {len(row)} fields, expected {len(types)}")
        for i, (e, t) in enumerate(zip(row, types)):
            cols[i].append(_literal_value(e, t))
    return cols


def _dml_count_result(n: int, label: str = "rows"):
    """Affected-row count surface for DML (reference: the protocol's
    updateCount / UPDATE n rows output)."""
    from .exec.local_executor import MaterializedResult
    from .types import BIGINT

    col = np.array([int(n)], np.int64)
    return MaterializedResult((label,), (BIGINT,), [col], [col])


def _ts_rescale(text: str, t):
    """Parse a timestamp literal and rescale to the column's precision."""
    from .types import parse_timestamp_literal

    v, ty = parse_timestamp_literal(text)
    diff = t.precision - ty.precision
    return (v * 10 ** diff if diff >= 0 else round(v / 10 ** -diff)), t


def _literal_value(e, t):
    from .sql import parser as A
    from .types import DecimalType, parse_date_literal

    neg = False
    while isinstance(e, A.UnaryOp) and e.op == "negate":
        neg = not neg
        e = e.operand
    if isinstance(e, A.NullLit):
        return None
    if isinstance(e, A.NumberLit):
        if isinstance(t, DecimalType):
            # exact decimal parse: float64 loses digits past ~15 significant
            # figures
            from decimal import ROUND_HALF_UP, Decimal

            d = Decimal(e.text)
            if neg:
                d = -d
            raw = int((d * (10 ** t.scale)).to_integral_value(rounding=ROUND_HALF_UP))
            if not -(1 << 63) <= raw < (1 << 63):
                raise ValueError(
                    f"decimal value {d} beyond 2^63 at scale {t.scale}: "
                    "Int128 column storage is not supported")
            return raw
        v = float(e.text) if ("." in e.text or "e" in e.text.lower()) else int(e.text)
        if neg:
            v = -v
        return float(v) if t.is_floating else int(v)
    if isinstance(e, A.StringLit):
        from .types import CharType

        if isinstance(t, CharType):
            # char(n) stores SPACE-PADDED to n (Chars.padSpaces)
            return e.value[:t.length].ljust(t.length)
        if t.name == "date":
            return parse_date_literal(e.value)
        if t.name.startswith("timestamp"):
            v, _ = _ts_rescale(e.value, t)
            return v
        return e.value
    if isinstance(e, A.DateLit):
        return parse_date_literal(e.value)
    if isinstance(e, A.TimestampLit):
        if t.name.startswith("timestamp"):
            v, _ = _ts_rescale(e.value, t)
            return v
        return parse_date_literal(e.value.split(" ")[0])
    if isinstance(e, A.BoolLit):
        return bool(e.value)
    if isinstance(e, A.ArrayLiteral):
        from .types import ArrayType

        et = t.element if isinstance(t, ArrayType) else t
        return [_literal_value(item, et) for item in e.items]
    raise ValueError(f"unsupported VALUES literal {e}")
