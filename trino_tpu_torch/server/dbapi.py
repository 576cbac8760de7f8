"""DB-API 2.0 (PEP 249) interface.

Reference: client/trino-jdbc (TrinoDriver.java:21) — the standard database API
binding so existing tooling (pandas.read_sql, SQLAlchemy raw connections,
ORMs' cursor protocols) can talk to the engine.  Two transports:
`connect(engine=...)` runs in-process; `connect(url="http://...")` speaks the
coordinator's statement protocol via trino_tpu_torch.server.client.
"""

from __future__ import annotations

import datetime
from typing import Optional

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"

__all__ = ["connect", "Connection", "Cursor", "Error", "InterfaceError",
           "ProgrammingError", "apilevel", "threadsafety", "paramstyle"]


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class ProgrammingError(Error):
    pass


def connect(engine=None, url: Optional[str] = None, catalog: Optional[str] = None):
    if (engine is None) == (url is None):
        raise InterfaceError("pass exactly one of engine= or url=")
    return Connection(engine=engine, url=url, catalog=catalog)


class Connection:
    def __init__(self, engine=None, url=None, catalog=None):
        self._engine = engine
        self._catalog = catalog
        self._client = None
        if url is not None:
            from .client import Client

            self._client = Client(url, catalog=catalog)
        self._session = engine.create_session(catalog) if engine is not None else None
        self._closed = False

    def cursor(self) -> "Cursor":
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def close(self) -> None:
        self._closed = True

    def commit(self) -> None:  # autocommit engine; present for PEP 249
        pass

    def rollback(self) -> None:
        raise ProgrammingError("transactions are not supported")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _quote(v) -> str:
    import decimal

    from ..sql.params import RawSql

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, float):
        # a python float is a SQL double and must stay one through
        # substitution — sql/params.float_literal is THE shared rule (the
        # plan-template path types protocol floats with the same helper)
        from ..sql.params import float_literal

        return float_literal(v)
    if isinstance(v, int):
        return repr(v)
    if isinstance(v, decimal.Decimal):
        # exact decimal text (repr would add the Decimal(...) wrapper; float
        # round-tripping would corrupt wide values)
        return format(v, "f")
    if isinstance(v, RawSql):
        return v.sql  # pre-formed literal (timestamp text keeps precision)
    if isinstance(v, datetime.datetime):  # BEFORE date: datetime is a date
        return "timestamp '" + v.isoformat(sep=" ") + "'"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    s = str(v).replace("'", "''")
    return f"'{s}'"


def _substitute(sql: str, params) -> str:
    """qmark substitution, quote- and comment-aware: a ``?`` inside a string
    literal, a ``--`` line comment, or a ``/* */`` block comment is text, not
    a marker (the parser lexes exactly these forms away, so marker counts
    must agree with what the parser sees)."""
    out, it = [], iter(params)
    in_str = False
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if in_str:
            out.append(ch)
            if ch == "'":
                in_str = False
            i += 1
            continue
        if ch == "'":
            in_str = True
            out.append(ch)
            i += 1
            continue
        if ch == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
            continue
        if ch == "/" and sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(sql[i:j])
            i = j
            continue
        if ch == "?":
            try:
                out.append(_quote(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters") from None
            i += 1
            continue
        out.append(ch)
        i += 1
    leftover = sum(1 for _ in it)
    if leftover:
        raise ProgrammingError(f"{leftover} unused parameters")
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self._conn = conn
        self.description = None
        self.rowcount = -1
        self._rows: list = []
        self._pos = 0

    # -- execution ---------------------------------------------------------------
    def execute(self, sql: str, parameters=None) -> "Cursor":
        if parameters:
            sql = _substitute(sql, list(parameters))
        try:
            if self._conn._engine is not None:
                res = self._conn._engine.execute_sql(sql, self._conn._session)
            else:
                res = self._conn._client.execute(sql)
        except Exception as e:
            raise ProgrammingError(str(e)) from e
        if res is None:
            self.description = None
            self._rows, self.rowcount, self._pos = [], -1, 0
            return self
        if self._conn._engine is not None:
            names, rows = list(res.names), res.rows()
        else:
            # a protocol result: its column names and rows are attributes
            # (the reference calls them as methods and raises here)
            names, rows = res.column_names, res.rows
        self.description = [(n, None, None, None, None, None, None) for n in names]
        self._rows = [tuple(_py(v) for v in row) for row in rows]
        self.rowcount = len(self._rows)
        self._pos = 0
        return self

    def executemany(self, sql: str, seq_of_parameters) -> "Cursor":
        for p in seq_of_parameters:
            self.execute(sql, p)
        return self

    # -- fetch -------------------------------------------------------------------
    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None):
        size = size or self.arraysize
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self):
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self) -> None:
        self._rows = []

    def setinputsizes(self, sizes):  # PEP 249 no-ops
        pass

    def setoutputsize(self, size, column=None):
        pass


def _py(v):
    """numpy scalars -> python scalars for PEP 249 consumers."""
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    return v
