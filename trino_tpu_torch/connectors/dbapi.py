"""Federation connector over Python DB-API drivers (the JDBC-family analog;
counterpart of ``trino_tpu/connectors/dbapi.py``).

Reference: the plugin/trino-base-jdbc family (BaseJdbcClient.java — metadata
discovery, column mapping, and projection pushdown into the remote SQL
dialect) with its concrete plugins (postgresql, mysql, sqlserver...).  The
in-tree dialect speaks sqlite3; other DB-API 2.0 drivers plug in by
overriding the three dialect hooks (_table_names, _table_info, _rowid_expr)
— statement execution already goes through the standard cursor() surface.

Pushdown scope: COLUMN PROJECTION is pushed into the remote SELECT, and each
split reads one contiguous rowid range (O(n) total across splits).  Filter
predicates evaluate on-device after transfer; there is no split-level
min/max pruning (a remote range probe per split would cost more than the
scan it saves on unindexed columns).

Remote rows land as numpy columns in a host page (``HOST_DECODE``): the
executor stages them to the device on its prefetch producer, so the remote
fetch overlaps the device's work and the copy is counted in ``h2d_bytes``
like every host-decoded scan.  String columns dictionary-encode table-wide
so the device sees fixed-width ids — the same page contract every other
connector speaks.  Metadata (schema, row count, dictionaries) snapshots at
first access; remote churn after the snapshot surfaces as a clear error,
not silent corruption.  The connector never opts into the buffer pool's
page tier (no ``CACHEABLE_SCANS``): the remote database changes behind the
engine's back.
"""

from __future__ import annotations

import dataclasses
from itertools import repeat

import numpy as np

from ..page import Field, Page, Schema
from ..types import BIGINT, BOOLEAN, DOUBLE, VarcharType
from .tpch import Dictionary

__all__ = ["DbapiConnector"]


@dataclasses.dataclass(frozen=True)
class DbapiSplit:
    table: str
    lo: int  # inclusive remote rowid range [lo, hi]
    hi: int
    pushed_spec: tuple = None  # serialized virtual-handle spec (sorted item
    # pairs): cluster WORKERS build their own connector instances, so a
    # pushed handle must travel WITH the split, not live only in the
    # planning process's registry


@dataclasses.dataclass
class _RemoteTable:
    schema: Schema
    n_rows: int
    rid_min: int
    rid_max: int
    dicts: dict  # column -> Dictionary
    id_maps: dict  # column -> {value: id}


# the comparisons a pushed join's side filters may use, as remote SQL
_SQL_CMP = {"eq": "=", "lt": "<", "lte": "<=", "gt": ">", "gte": ">="}


def _affinity_type(decl: str):
    d = (decl or "").lower()
    if "int" in d:
        return BIGINT
    if "bool" in d:
        return BOOLEAN
    if "char" in d or "clob" in d or "text" in d or d == "":
        return VarcharType.of(None)
    if "real" in d or "floa" in d or "doub" in d or d.startswith("decimal") \
            or d.startswith("numeric"):
        return DOUBLE  # remote decimals surface as double (documented)
    return VarcharType.of(None)


class DbapiConnector:
    """``connect`` is a zero-arg factory returning a DB-API connection (each
    split opens its own cursor; drivers like sqlite3 are cheap to connect)."""

    name = "dbapi"
    HOST_DECODE = True  # pages are numpy: the executor stages them

    def __init__(self, connect, split_rows: int = 1 << 16):
        self._connect = connect
        self.split_rows = split_rows
        self._tables: dict = {}
        # virtual handles from optimizer pushdowns (applyTopN / applyJoin,
        # spi/connector/ConnectorMetadata.java:1637,1663): handle -> spec,
        # content-deduped (replanning the same query reuses its handle) and
        # bounded (a long-lived server plans unbounded distinct SQL texts)
        self._pushed: dict = {}
        self._pushed_by_content: dict = {}
        self._pushed_cap = 512
        self._pushed_seq = 0
        import threading

        # index lookups register handles on the EXECUTION path, where pooled
        # executors run concurrently — the registry mutates under this lock
        self._pushed_lock = threading.Lock()
        self.pushed_queries = 0  # observability: remote pushed-handle reads

    # -- optimizer pushdown surfaces (applyTopN / applyJoin) ---------------------
    supports_topn_pushdown = True
    supports_join_pushdown = True
    supports_index_lookup = True

    def is_pushdown_handle(self, table: str) -> bool:
        """Interface-level test the optimizer uses instead of reaching into
        connector-private state (a handle is not itself pushable-over)."""
        return table in self._pushed

    def _register_pushed(self, prefix: str, spec: dict) -> str:
        key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                    for k, v in spec.items()))
        with self._pushed_lock:
            hit = self._pushed_by_content.get(key)
            if hit is not None:
                return hit
            self._pushed_seq += 1
            handle = f"{prefix}{self._pushed_seq}"
            self._pushed[handle] = spec
            self._pushed_by_content[key] = handle
            while len(self._pushed) > self._pushed_cap:
                old = next(iter(self._pushed))
                self._pushed.pop(old)
                self._pushed_by_content = {k: h for k, h
                                           in self._pushed_by_content.items()
                                           if h != old}
            return handle

    def _resolve_spec(self, table: str, split=None):
        """Handle spec from the local registry, or — on a WORKER that never
        planned the query — from the split's serialized copy."""
        spec = self._pushed.get(table)
        if spec is None and split is not None \
                and getattr(split, "pushed_spec", None):
            spec = {k: list(v) if isinstance(v, tuple) else v
                    for k, v in split.pushed_spec}
            self._pushed[table] = spec  # cache for metadata calls
        return spec

    def apply_topn(self, table: str, order: list, n: int) -> str:
        """TopN pushdown (ConnectorMetadata.applyTopN:1663): returns a handle
        whose scan issues ORDER BY ... LIMIT n remotely, shipping n rows
        instead of the table.  The engine keeps its local Sort+Limit above
        (the reference's topNGuarantee — remote collation may differ)."""
        base = self._open(table)
        parts = []
        for col, asc, nulls_first in order:
            base.schema.field(col)  # validate
            parts.append(f"{_q(col)} {'asc' if asc else 'desc'} "
                         f"nulls {'first' if nulls_first else 'last'}")
        return self._register_pushed(
            f"{table}#topn",
            {"kind": "topn", "base": table,
             "order_sql": ", ".join(parts), "n": int(n)})

    def apply_index_lookup(self, table: str, key_col: str, keys) -> str:
        """Index-join lookup (reference: operator/index/IndexLoader — fetch
        only the build rows matching the probe's key set): a handle whose
        scan issues ``WHERE key_col IN (...)`` remotely, shipping the
        matching rows instead of the table.  ``keys`` are remote-domain
        values (strings already decoded)."""
        t = self._open(table)
        t.schema.field(key_col)  # validate
        return self._register_pushed(
            f"{table}#idx",
            {"kind": "index", "base": table, "key_col": key_col,
             "keys": tuple(keys)})

    def apply_join(self, left: str, right: str, pairs: list, out_names: list,
                   left_cols: list, right_cols: list, left_filter=(),
                   right_filter=()) -> str:
        """Equi-join pushdown (ConnectorMetadata.applyJoin:1637): both sides
        live in THIS remote database, so the join runs there — the engine
        scans the joined result (split by the left side's rowid ranges).
        ``pairs``: [(left_col, right_col)]; ``out_names``: output field
        names aligned to ``left_cols`` then ``right_cols`` (the sides'
        PROJECTED column lists, which may subset/reorder the tables).
        ``left_filter`` / ``right_filter``: [(column, op, int)] each side's
        rows must satisfy (a port extension), ANDed into the remote query's
        WHERE."""
        lt, rt = self._open(left), self._open(right)
        for lc, rc in pairs:
            lt.schema.field(lc)
            rt.schema.field(rc)
        for c in left_cols:
            lt.schema.field(c)
        for c in right_cols:
            rt.schema.field(c)
        for t, cons in ((lt, left_filter), (rt, right_filter)):
            for col, op, _ in cons:
                t.schema.field(col)
                if op not in _SQL_CMP:
                    raise ValueError(f"unsupported remote comparison {op!r}")
        return self._register_pushed(
            f"{left}#join",
            {"kind": "join", "left": left, "right": right,
             "pairs": [tuple(p) for p in pairs],
             "out_names": list(out_names),
             "left_cols": list(left_cols), "right_cols": list(right_cols),
             "left_filter": [tuple(c) for c in left_filter],
             "right_filter": [tuple(c) for c in right_filter]})

    def _handle_schema(self, spec) -> Schema:
        if spec["kind"] in ("topn", "index"):
            return self._open(spec["base"]).schema
        lt, rt = self._open(spec["left"]), self._open(spec["right"])
        src = [lt.schema.field(c) for c in spec["left_cols"]] \
            + [rt.schema.field(c) for c in spec["right_cols"]]
        return Schema(tuple(Field(n, f.type)
                            for n, f in zip(spec["out_names"], src)))

    def _handle_sources(self, spec) -> list:
        """[(source_table, source_column)] per output channel."""
        if spec["kind"] in ("topn", "index"):
            return [(spec["base"], f.name)
                    for f in self._open(spec["base"]).schema.fields]
        return ([(spec["left"], c) for c in spec["left_cols"]]
                + [(spec["right"], c) for c in spec["right_cols"]])

    # -- dialect hooks (override for non-sqlite drivers) -------------------------
    def _table_names(self, cur) -> list:
        cur.execute("select name from sqlite_master where type='table' "
                    "order by name")
        return [r[0] for r in cur.fetchall()]

    def _table_info(self, cur, table: str) -> list:
        """-> [(column_name, declared_type), ...]"""
        cur.execute(f"pragma table_info({_q(table)})")
        return [(r[1], r[2]) for r in cur.fetchall()]

    def _rowid_expr(self) -> str:
        return "rowid"

    # -- metadata ----------------------------------------------------------------
    def tables(self):
        con = self._connect()
        try:
            return self._table_names(con.cursor())
        finally:
            con.close()

    def _open(self, table: str) -> _RemoteTable:
        t = self._tables.get(table)
        if t is not None:
            return t
        con = self._connect()
        try:
            cur = con.cursor()
            cols = self._table_info(cur, table)
            if not cols:
                raise KeyError(f"remote table {table!r} not found")
            fields = [Field(cn, _affinity_type(decl)) for cn, decl in cols]
            rid = self._rowid_expr()
            cur.execute(f"select count(*), min({rid}), max({rid}) "
                        f"from {_q(table)}")
            n, rmin, rmax = cur.fetchone()
            dicts, id_maps = {}, {}
            for f in fields:
                if f.type.is_string:
                    cur.execute(
                        f"select distinct {_q(f.name)} from {_q(table)} "
                        f"where {_q(f.name)} is not null")
                    # str() can collapse distinct remote values ('1' vs 1 in a
                    # dynamically-typed column): dedup AFTER stringification
                    uniq = sorted({str(r[0]) for r in cur.fetchall()})
                    dicts[f.name] = Dictionary(
                        values=np.array(uniq or [""], dtype=object))
                    id_maps[f.name] = {v: i for i, v in enumerate(uniq)}
            t = _RemoteTable(Schema(tuple(fields)), int(n),
                             int(rmin or 0), int(rmax or -1), dicts, id_maps)
            self._tables[table] = t
            return t
        finally:
            con.close()

    def schema(self, table: str) -> Schema:
        spec = self._pushed.get(table)
        if spec is not None:
            return self._handle_schema(spec)
        return self._open(table).schema

    def dictionaries(self, table: str) -> dict:
        spec = self._pushed.get(table)
        if spec is not None:
            out = {}
            for name, (src_t, src_c) in zip(
                    [f.name for f in self._handle_schema(spec).fields],
                    self._handle_sources(spec)):
                d = self._open(src_t).dicts.get(src_c)
                if d is not None:
                    out[name] = d
            return out
        return dict(self._open(table).dicts)

    def row_count(self, table: str) -> int:
        spec = self._pushed.get(table)
        if spec is not None:
            if spec["kind"] == "topn":
                return min(spec["n"], self._open(spec["base"]).n_rows)
            if spec["kind"] == "index":
                return self._open(spec["base"]).n_rows  # conservative bound
            return self._open(spec["left"]).n_rows  # estimate
        return self._open(table).n_rows

    def column_range(self, table: str, column: str):
        if table in self._pushed:
            return (None, None)
        t = self._open(table)
        if t.schema.field(column).type.is_string:
            return (None, None)
        con = self._connect()
        try:
            cur = con.cursor()
            cur.execute(f"select min({_q(column)}), max({_q(column)}) "
                        f"from {_q(table)}")
            lo, hi = cur.fetchone()
            if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
                return (lo, hi)
            return (None, None)
        finally:
            con.close()

    # -- scan --------------------------------------------------------------------
    def splits(self, table: str, n_hint: int = 0):
        """Contiguous rowid ranges sized so a UNIFORM id distribution yields
        ~split_rows rows each (sparse rowids give uneven but correct splits);
        each range reads independently — O(n) total remote work."""
        spec = self._pushed.get(table)
        wire = None
        if spec is not None:
            # the spec travels with every split: cluster workers never saw
            # the planning pass and must reconstruct the handle from it
            wire = tuple(sorted(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in spec.items()))
            if spec["kind"] in ("topn", "index"):
                # ORDER BY...LIMIT and keyed IN-lookups are single remote
                # cursors by nature
                return [DbapiSplit(table, 0, -1, wire)]
            # joined scans parallelize by the LEFT side's rowid ranges
            base = spec["left"]
        else:
            base = table
        t = self._open(base)
        if t.n_rows == 0 or t.rid_max < t.rid_min:
            return [DbapiSplit(table, 0, -1, wire)]
        span = t.rid_max - t.rid_min + 1
        n_splits = max((t.n_rows + self.split_rows - 1) // self.split_rows, 1)
        step = max((span + n_splits - 1) // n_splits, 1)
        return [DbapiSplit(table, lo, min(lo + step - 1, t.rid_max), wire)
                for lo in range(t.rid_min, t.rid_max + 1, step)]

    def _pushed_query(self, spec, names, split):
        """(sql, params) for a virtual handle read, projecting ``names``."""
        schema = self._handle_schema(spec)
        srcs = dict(zip([f.name for f in schema.fields],
                        self._handle_sources(spec)))
        rid = self._rowid_expr()
        if spec["kind"] == "topn":
            sel = ", ".join(f"{_q(srcs[n][1])} as {_q(n)}" for n in names)
            return (f"select {sel} from {_q(spec['base'])} "
                    f"order by {spec['order_sql']} limit {spec['n']}", ())
        if spec["kind"] == "index":
            sel = ", ".join(f"{_q(srcs[n][1])} as {_q(n)}" for n in names)
            keys = spec["keys"]
            if not keys:
                return (f"select {sel} from {_q(spec['base'])} where 1 = 0",
                        ())
            ph = ", ".join("?" for _ in keys)
            return (f"select {sel} from {_q(spec['base'])} "
                    f"where {_q(spec['key_col'])} in ({ph})", tuple(keys))
        sel = ", ".join(
            f"{'a' if srcs[n][0] == spec['left'] else 'b'}.{_q(srcs[n][1])} "
            f"as {_q(n)}" for n in names)
        on = " and ".join(f"a.{_q(lc)} = b.{_q(rc)}"
                          for lc, rc in spec["pairs"])
        where, params = [f"a.{rid} between ? and ?"], [split.lo, split.hi]
        for alias, key in (("a", "left_filter"), ("b", "right_filter")):
            for col, op, value in spec.get(key, ()):
                where.append(f"{alias}.{_q(col)} {_SQL_CMP[op]} ?")
                params.append(int(value))
        return (f"select {sel} from {_q(spec['left'])} a "
                f"join {_q(spec['right'])} b on {on} "
                f"where {' and '.join(where)}", tuple(params))

    def generate(self, split: DbapiSplit, columns=None) -> Page:
        """One remote query per split: SELECT <projected columns> WHERE the
        rowid range (projection pushdown + split-ranged reads; reference:
        BaseJdbcClient column pushdown).  Virtual handles from applyTopN /
        applyJoin read their pushed remote query instead."""
        spec = self._resolve_spec(split.table, split)
        if spec is not None:
            schema = self._handle_schema(spec)
            srcs = dict(zip([f.name for f in schema.fields],
                            self._handle_sources(spec)))
            names = list(columns) if columns \
                else [f.name for f in schema.fields]
            sql, params = self._pushed_query(spec, names, split)
            self.pushed_queries += 1
        else:
            t0 = self._open(split.table)
            schema, srcs = t0.schema, None
            names = list(columns) if columns \
                else [f.name for f in schema.fields]
            sel = ", ".join(_q(c) for c in names)
            sql = (f"select {sel} from {_q(split.table)} "
                   f"where {self._rowid_expr()} between ? and ?")
            params = (split.lo, split.hi)
        con = self._connect()
        try:
            cur = con.cursor()
            cur.execute(sql, params)
            rows = cur.fetchall()
        finally:
            con.close()
        n = len(rows)
        by_col = list(zip(*rows)) if n else [()] * len(names)
        cols_out, nulls_out, fields = [], [], []
        for ci, name in enumerate(names):
            fld = schema.field(name)
            fields.append(fld)
            raw = by_col[ci]
            # the mask is made only where a NULL is (one C-level scan finds one)
            nm = np.fromiter((v is None for v in raw), bool, count=n) if None in raw else None
            if fld.type.is_string:
                if srcs is None:
                    idm = self._open(split.table).id_maps[name]
                else:
                    src_t, src_c = srcs[name]
                    idm = self._open(src_t).id_maps[src_c]
                arr = np.fromiter(map(idm.get, raw, repeat(-1)), np.int32, count=n)
                # the lanes left at -1: NULLs, values held as another type
                # (a number in a text column: its string is looked up), and
                # values new since the snapshot
                for i in np.flatnonzero(arr < 0):
                    v = raw[i]
                    if v is None:
                        arr[i] = 0
                        continue
                    ix = idm.get(str(v))
                    if ix is None:
                        raise RuntimeError(
                            f"remote table {split.table!r} changed since its "
                            f"metadata snapshot: unknown value {v!r} in "
                            f"column {name!r} (re-register the catalog to "
                            f"refresh)")
                    arr[i] = ix
            else:
                dt = np.dtype(fld.type.dtype)
                arr = np.array(raw if nm is None else [0 if v is None else v for v in raw], dt)
            cols_out.append(arr)
            nulls_out.append(nm)
        return Page(Schema(tuple(fields)), tuple(cols_out), tuple(nulls_out), None)


def _q(ident: str) -> str:
    """Quote a remote identifier (reject anything needing escapes — the
    engine's identifiers are lowercased names, never untrusted input)."""
    if not ident.replace("_", "").isalnum():
        raise ValueError(f"unsupported remote identifier {ident!r}")
    return f'"{ident}"'
