"""Parquet file connector (counterpart of ``trino_tpu/connectors/parquet.py``).

Reference: lib/trino-parquet (ParquetReader.java:108 — row-group based reads with
column projection and predicate pushdown) + plugin/trino-hive's file listing.  Here
pyarrow supplies the columnar decode on the host; the connector's job is the mapping to
the engine's page model: fixed-width numpy arrays, null bitmaps, and table-wide
string dictionaries so pages carry int32 ids, never bytes.

Layout: one table per ``<name>.parquet`` file inside the connector directory.
Splits = row groups (the reference's split granularity for parquet tables).

Host decode: ``generate`` returns a page of numpy arrays (``HOST_DECODE``).
The executor stages it to the engine's device on its prefetch producer
thread (``exec/local_executor._prefetched_pages``, pinned and asynchronous on
a side stream on the card), counting the bytes in ``h2d_bytes``; the
reference pushes each column to the device inside ``generate``.

``pyarrow`` is imported only when a file is read or written (``_pyarrow``):
the module imports without it, and using a file connector without it raises
an ImportError that names it.  Writes (``append``) take the engine's write
columns (``connectors.memory.Raw`` / ``Coded`` or python lists) and write
host-convention values, as the reference's writes do.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..page import Field, Page, Schema
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, SMALLINT, TINYINT,
                     DecimalType, VarcharType)
from .tpch import Dictionary

__all__ = ["ParquetConnector", "host_lists"]


def _pyarrow(module: str = ""):
    """``pyarrow`` or one of its modules, imported at first use; without
    pyarrow, an ImportError that names it."""
    import importlib

    name = "pyarrow" + (f".{module}" if module else "")
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"the file connectors (parquet, orc, filetable, hive, iceberg, delta) "
            f"decode and write through {name}, which is not installed") from e


def host_lists(columns) -> list:
    """The engine's write columns as python lists of host-convention values
    (NULL as None, strings as str, decimals as raw scaled ints, dates as
    epoch days): ``Raw`` and ``Coded`` columns are expanded, lists pass."""
    from .memory import Coded, Raw

    out = []
    for c in columns:
        if isinstance(c, Raw):
            vals = np.asarray(c.values).tolist()
            out.append([None if n else v for v, n in zip(vals, np.asarray(c.nulls).tolist())])
        elif isinstance(c, Coded):
            table = [str(v) for v in np.asarray(c.values).tolist()]
            out.append([None if n else table[k] for k, n in
                        zip(np.asarray(c.codes).tolist(), np.asarray(c.nulls).tolist())])
        else:
            out.append(list(c))
    return out


def _arrow_to_type(at):
    pa = _pyarrow()

    if pa.types.is_int64(at):
        return BIGINT
    if pa.types.is_int32(at):
        return INTEGER
    if pa.types.is_int16(at):
        return SMALLINT
    if pa.types.is_int8(at):
        return TINYINT
    if pa.types.is_float64(at):
        return DOUBLE
    if pa.types.is_float32(at):
        return REAL
    if pa.types.is_boolean(at):
        return BOOLEAN
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_timestamp(at):
        from ..types import TIMESTAMP

        return TIMESTAMP
    if pa.types.is_decimal(at):
        if at.precision > 38:
            raise ValueError(f"decimal precision {at.precision} > 38 not supported")
        return DecimalType.of(at.precision, at.scale)
    if pa.types.is_string(at) or pa.types.is_large_string(at) or \
            pa.types.is_dictionary(at):
        return VarcharType.of(None)
    raise ValueError(f"unsupported parquet type {at}")


def _decimal_int64(col, null_np, check_fit: bool = False) -> np.ndarray:
    """decimal128 arrow array -> scaled int64, straight from the buffer.

    Arrow stores decimal128 as 16-byte little-endian two's-complement; values
    within +-2^63 live in the LOW word, whose int64 view is already
    sign-correct — one frombuffer + stride, no per-value Decimal objects.
    With ``check_fit`` (declared precision > 18), the HIGH word must be the
    low word's sign extension: wider actual values are rejected with a clear
    error instead of silently truncating (declared decimal(38,x) columns are
    supported for the int64 value domain; see DecimalType docstring).
    ``null_np`` is the caller's already-materialized null mask."""
    n = len(col)
    if n == 0:
        return np.zeros(0, np.int64)
    buf = col.buffers()[1]
    if buf is None:  # all-null column
        return np.zeros(n, np.int64)
    words = np.frombuffer(buf, dtype=np.int64)
    lo = words[2 * col.offset:2 * (col.offset + n):2].copy()
    if check_fit:
        hi = words[2 * col.offset + 1:2 * (col.offset + n) + 1:2]
        live = ~null_np
        if not np.array_equal(hi[live], (lo >> 63)[live]):
            raise ValueError(
                "decimal value beyond 2^63: Int128 column storage is not "
                "supported (declared wide precision is, for values that fit)")
    if null_np.any():
        lo[null_np] = 0
    return lo


@dataclasses.dataclass(frozen=True)
class ParquetSplit:
    table: str
    row_group: int


@dataclasses.dataclass
class _PqTable:
    path: str
    schema: Schema
    arrow_schema: object
    n_rows: int
    n_row_groups: int
    dicts: dict  # column -> Dictionary (string columns; table-wide)
    id_maps: dict  # column -> {value: id}
    metadata: object  # pyarrow FileMetaData (cached footer; row-group stats)


class ParquetConnector:

    CACHEABLE_SCANS = True  # file pages are immutable between DDL;
    # the buffer pool keeps decoded columns device-resident across queries
    supports_count_pushdown = True  # exact footer row counts; DDL/DML bumps plan_version
    name = "parquet"
    HOST_DECODE = True  # pages decode on the host: scans benefit from
    # background-thread split prefetch (see local_executor._prefetched_pages)

    def __init__(self, directory: str):
        self.directory = directory
        self._tables: dict = {}
        # explicit path registrations: table-format connectors (Iceberg) map
        # manifest-listed data FILES onto this connector's decode machinery
        self._paths: dict = {}
        self._version = 0  # bumped on every write: cached plans embed split
        # lists (and pushed-down counts) — the engine's plan-version snapshot
        # replans when this moves

    def plan_version(self) -> int:
        return self._version

    # -- metadata ----------------------------------------------------------------
    def tables(self):
        names = set(self._tables)
        if os.path.isdir(self.directory):
            for f in os.listdir(self.directory):
                if f.endswith(".parquet"):
                    names.add(f[:-len(".parquet")])
        return sorted(names)

    def _open(self, table: str) -> _PqTable:
        t = self._tables.get(table)
        if t is not None:
            return t
        pq = _pyarrow("parquet")

        path = self._paths.get(table) \
            or os.path.join(self.directory, f"{table}.parquet")
        pf = pq.ParquetFile(path)
        fields, dicts, id_maps = [], {}, {}
        for fld in pf.schema_arrow:
            try:
                ty = _arrow_to_type(fld.type)
            except (ValueError, NotImplementedError):
                # unsupported physical types (structs, raw binary, fixed) are
                # not exposed as columns; the table stays readable for the rest
                continue
            fields.append(Field(fld.name, ty))
            if ty.is_string:
                # table-wide dictionary: one pass over the column's distinct values
                # (reference: dictionary pages are per-row-group; the engine needs
                # stable ids across every page of the table)
                pc = _pyarrow("compute")

                col = pf.read(columns=[fld.name]).column(0)
                uniq = sorted(v for v in pc.unique(col).to_pylist() if v is not None)
                dicts[fld.name] = Dictionary(values=np.array(uniq or [""], dtype=object))
                id_maps[fld.name] = {v: i for i, v in enumerate(uniq)}
        t = _PqTable(path, Schema(tuple(fields)), pf.schema_arrow,
                     pf.metadata.num_rows, pf.metadata.num_row_groups, dicts, id_maps,
                     pf.metadata)
        self._tables[table] = t
        return t

    def schema(self, table: str) -> Schema:
        return self._open(table).schema

    def dictionaries(self, table: str) -> dict:
        return dict(self._open(table).dicts)

    def row_count(self, table: str) -> int:
        return self._open(table).n_rows

    def exact_row_count(self, table: str) -> int:
        return self._open(table).n_rows  # footer metadata is exact

    def column_range(self, table: str, column: str):
        return (None, None)

    def split_range(self, split: ParquetSplit, column: str):
        """Per-row-group min/max statistics, feeding TupleDomain split pruning and
        dynamic filters (reference: lib/trino-parquet predicate/TupleDomainParquetPredicate
        — row groups skipped when stats are disjoint from the effective predicate)."""
        t = self._open(split.table)
        if column in t.dicts:
            return None  # engine domains over dictionary ids; stats are raw strings
        rg = t.metadata.row_group(split.row_group)
        for ci in range(rg.num_columns):
            col = rg.column(ci)
            if col.path_in_schema == column:
                st = col.statistics
                if st is None or not st.has_min_max:
                    return None
                lo, hi = st.min, st.max
                ty = t.schema.field(column).type
                if ty.name == "date":
                    import datetime

                    epoch = datetime.date(1970, 1, 1)
                    if isinstance(lo, datetime.date):
                        lo, hi = (lo - epoch).days, (hi - epoch).days
                if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
                    return (lo, hi)
                return None
        return None

    # -- scan --------------------------------------------------------------------
    def splits(self, table: str, n_hint: int = 0):
        t = self._open(table)
        return [ParquetSplit(table, g) for g in range(t.n_row_groups)]

    def generate(self, split: ParquetSplit, columns=None) -> Page:
        """One row group -> one host page of numpy arrays, decoded WITHOUT
        per-row python (the executor stages it to the device):

        - string columns read as parquet DICTIONARY indices (pyarrow
          read_dictionary): the row-group-local dictionary remaps to the
          table-wide id space through a small per-distinct-value LUT, and the
          index vector gathers through it — ids are preserved end-to-end from
          the file encoding to HBM (reference: lib/trino-parquet's dictionary-
          aware column readers, reader/flat/ + DictionaryBlock output);
        - short decimals decode from the raw 16-byte buffer (low word is the
          two's-complement int64 for precision <= 18) instead of per-value
          decimal.Decimal round trips;
        - numerics are numpy arrays, copied to the device once by the
          executor.
        """
        pq = _pyarrow("parquet")

        t = self._open(split.table)
        names = list(columns) if columns is not None else list(t.schema.names)
        str_cols = [n for n in names if t.schema.field(n).type.is_string]
        pf = pq.ParquetFile(t.path, read_dictionary=str_cols)
        tbl = pf.read_row_group(split.row_group, columns=names)
        out_schema = Schema(tuple(t.schema.field(n) for n in names))
        cols, nulls = [], []
        for n in names:
            f = t.schema.field(n)
            col = tbl.column(n).combine_chunks()
            null_np = np.asarray(col.is_null())
            if f.type.is_string:
                arr = self._decode_string_ids(t, n, col)
            elif isinstance(f.type, DecimalType):
                arr = _decimal_int64(col, null_np,
                                     check_fit=f.type.precision > 18)
            elif f.type.name == "date":
                arr = np.asarray(col.cast("int32").fill_null(0)).astype(np.int32)
            else:
                arr = np.asarray(col.fill_null(0)).astype(np.dtype(f.type.dtype))
            cols.append(np.ascontiguousarray(arr))
            nulls.append(np.array(null_np, bool) if null_np.any() else None)
        return Page(out_schema, tuple(cols), tuple(nulls), None)

    def _decode_string_ids(self, t: _PqTable, name: str, col) -> np.ndarray:
        pa = _pyarrow()

        id_map = t.id_maps[name]
        if isinstance(col, pa.ChunkedArray):  # pragma: no cover - combined above
            col = col.combine_chunks()
        if pa.types.is_dictionary(col.type):
            # local dictionary -> table-wide ids: one python pass PER DISTINCT
            # VALUE, then a vectorized gather over the index vector
            # a value missing from the cached table-wide map means the file
            # changed under a stale _PqTable cache: fail LOUDLY (a .get(v, 0)
            # default would silently alias rows to the first dictionary value)
            local = col.dictionary.to_pylist()
            remap = np.fromiter((id_map[v] for v in local), np.int32,
                                count=len(local))
            idx = col.indices.fill_null(0)
            return remap[np.asarray(idx).astype(np.int64)] if len(local) \
                else np.zeros(len(col), np.int32)
        # plain-encoded column in the file: fall back to a value pass
        vals = col.to_pylist()
        return np.fromiter((0 if v is None else id_map[v] for v in vals),
                           np.int32, count=len(vals))

    # -- write (CTAS/INSERT target; reference: lib/trino-parquet writer/ behind
    # ConnectorPageSink) ---------------------------------------------------------
    def _arrow_schema_for(self, schema: Schema):
        pa = _pyarrow()

        def at(ty):
            if isinstance(ty, DecimalType):
                return pa.decimal128(18, ty.scale)
            if ty.is_string:
                return pa.string()
            return {"bigint": pa.int64(), "integer": pa.int32(),
                    "smallint": pa.int16(), "tinyint": pa.int8(),
                    "double": pa.float64(), "real": pa.float32(),
                    "boolean": pa.bool_(), "date": pa.date32(),
                    "timestamp(6)": pa.timestamp("us"),
                    "unknown": pa.int8()}[ty.name]

        return pa.schema([(f.name, at(f.type)) for f in schema.fields])

    def create_table(self, table: str, schema: Schema, if_not_exists=False) -> bool:
        """Write an empty (schema-only) parquet file immediately, so the table
        is scannable right after DDL; INSERT/CTAS appends rows to it."""
        pa, pq = _pyarrow(), _pyarrow("parquet")

        if table in self.tables():
            if if_not_exists:
                return False
            raise ValueError(f"table {table} already exists")
        os.makedirs(self.directory, exist_ok=True)
        aschema = self._arrow_schema_for(schema)
        pq.write_table(pa.table({f.name: pa.array([], f.type) for f in aschema},
                                schema=aschema),
                       os.path.join(self.directory, f"{table}.parquet"))
        self._tables.pop(table, None)
        self._version += 1
        return True

    def append(self, table: str, decoded_columns, null_flags=None) -> None:
        """Append HOST-CONVENTION values (strings as str, decimals as raw
        scaled ints, dates as epoch days; ``host_lists`` expands the engine's
        ``Raw`` / ``Coded`` columns into them): read existing rows,
        concatenate, rewrite the file (small-file semantics; the reference
        appends new files to a directory instead)."""
        import decimal

        pq = _pyarrow("parquet")

        decoded_columns = host_lists(decoded_columns)
        t = self._open(table)
        types = [f.type for f in t.schema.fields]
        new_cols = []
        for col, ty in zip(decoded_columns, types):
            if isinstance(ty, DecimalType):
                # engine DML sends raw scaled ints; write_table expects
                # decoded decimal values — rescale EXACTLY via Decimal
                col = [None if v is None
                       else decimal.Decimal(int(v)).scaleb(-ty.scale)
                       for v in col]
            new_cols.append(list(col))
        existing = pq.read_table(t.path)
        if existing.num_rows:
            dec = self._decode_table(existing, t)
            new_cols = [old + new for old, new in zip(dec, new_cols)]
        self.write_table(table, t.schema.names, types, new_cols)

    def _decode_table(self, arrow_table, t: _PqTable):
        """Existing file -> write_table-convention python columns."""
        cols = []
        for f in t.schema.fields:
            col = arrow_table.column(f.name)
            if f.type.name == "date":
                import datetime

                epoch = datetime.date(1970, 1, 1)
                cols.append([None if v is None else (v - epoch).days
                             for v in col.to_pylist()])
            else:
                cols.append(col.to_pylist())
        return cols

    def write_table(self, table: str, names, types, columns) -> str:
        """Write decoded host columns as a parquet file (CTAS target support)."""
        pa, pq = _pyarrow(), _pyarrow("parquet")

        arrays = arrow_arrays(types, columns)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"{table}.parquet")
        pq.write_table(pa.table(dict(zip(names, arrays))), path)
        self._tables.pop(table, None)
        self._version += 1
        return path


def arrow_arrays(types, columns) -> list:
    """Decoded host columns -> typed arrow arrays (shared by the parquet and
    ORC writers).  Declared types, NOT value inference: an all-null column
    would otherwise persist as arrow null (unreadable table) and integer/real
    would widen to bigint/double on rewrite."""
    import decimal

    pa = _pyarrow()
    arrays = []
    for col, ty in zip(columns, types):
        if isinstance(ty, DecimalType):
            q = decimal.Decimal(1).scaleb(-ty.scale)
            arrays.append(pa.array(
                [None if v is None else decimal.Decimal(str(v)).quantize(q)
                 for v in col], type=pa.decimal128(18, ty.scale)))
        elif ty.name == "date":
            arrays.append(pa.array(col, type=pa.int32()).cast(pa.date32()))
        elif ty.name.startswith("timestamp"):
            p = getattr(ty, "precision", 6)
            unit = "s" if p == 0 else ("ms" if p <= 3 else
                                       ("us" if p <= 6 else "ns"))
            scale = {"s": 1, "ms": 10 ** (3 - p) if p <= 3 else 1,
                     "us": 10 ** (6 - p) if p <= 6 else 1,
                     "ns": 10 ** (9 - p)}[unit]
            arrays.append(pa.array(
                [None if v is None else int(v) * scale for v in col],
                type=pa.timestamp(unit)))
        else:
            at = (pa.string() if ty.is_string else
                  {"bigint": pa.int64(), "integer": pa.int32(),
                   "smallint": pa.int16(), "tinyint": pa.int8(),
                   "double": pa.float64(), "real": pa.float32(),
                   "boolean": pa.bool_(), "unknown": pa.int8()}[ty.name])
            arrays.append(pa.array(col, type=at))
    return arrays
