"""Hive-style partitioned-directory connector (counterpart of
``trino_tpu/connectors/hive.py``).

Reference: plugin/trino-hive — partition discovery over ``key=value`` path
segments (metastore-backed there; directory-crawled here, the classic
"hive-layout without a metastore" mode), partition pruning via TupleDomain
(HivePartitionManager.java), partition values synthesized as constant columns
per split (HivePageSourceProvider.java), and partitioned writes laying out
one file per partition directory (HivePageSink).

Partition value typing follows Hive's string storage: values parse to
bigint/double/date when every partition agrees, else varchar
(``__HIVE_DEFAULT_PARTITION__`` is NULL).  Data files are parquet.  Writes
take the engine's write columns (``parquet.host_lists``).
"""

from __future__ import annotations

import datetime
import os
import uuid

import numpy as np

from ..page import Field, Schema
from ..types import BIGINT, DATE, DOUBLE, VarcharType
from .filetable import MultiFileConnector, PartFile, _FTable
from .tpch import Dictionary

__all__ = ["HiveConnector"]

NULL_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def _parse_epoch_days(s: str):
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


class HiveConnector(MultiFileConnector):
    name = "hive"

    def __init__(self, warehouse: str, fs=None):
        super().__init__(fs)
        self.warehouse = warehouse

    def tables(self):
        out = []
        if self.fs.is_dir(self.warehouse):
            for d in self.fs.list_dir(self.warehouse):
                if self.fs.is_dir(os.path.join(self.warehouse, d)):
                    out.append(d)
        return sorted(set(out) | set(self._tables))

    # -- pending DDL: declared tables with no data files yet serve their
    # declared schema (discovery takes over at the first append) -----------------
    def _pending(self, table: str):
        pending = getattr(self, "_pending_ddl", {})
        if table not in pending:
            return None
        found: list = []
        try:
            self._walk(os.path.join(self.warehouse, table), (), out=found)
        except FileNotFoundError:
            pass
        if found:  # data landed: discovery owns the table from here on
            pending.pop(table, None)
            return None
        return pending[table]

    def schema(self, table: str):
        p = self._pending(table)
        return p[0] if p is not None else super().schema(table)

    def dictionaries(self, table: str) -> dict:
        return {} if self._pending(table) is not None             else super().dictionaries(table)

    def row_count(self, table: str) -> int:
        return 0 if self._pending(table) is not None             else super().row_count(table)

    def splits(self, table: str, n_hint: int = 0):
        return [] if self._pending(table) is not None             else super().splits(table, n_hint)

    # -- discovery ---------------------------------------------------------------
    def _walk(self, d: str, parts: tuple, out: list) -> None:
        for name in self.fs.list_dir(d):
            p = os.path.join(d, name)
            if self.fs.is_dir(p):
                if "=" in name:
                    k, v = name.split("=", 1)
                    self._walk(p, parts + ((k, v),), out)
                else:
                    self._walk(p, parts, out)
            elif name.endswith(".parquet"):
                out.append((p, parts))

    def _discover(self, table: str) -> _FTable:
        table_dir = os.path.join(self.warehouse, table)
        if not self.fs.is_dir(table_dir):
            raise ValueError(f"table {table} does not exist")
        found: list = []
        self._walk(table_dir, (), out=found)
        if not found:
            raise ValueError(f"table {table} has no data files")
        part_cols = [k for k, _ in found[0][1]]
        for _, parts in found:
            if [k for k, _ in parts] != part_cols:
                raise ValueError(
                    f"table {table}: inconsistent partition nesting")

        # type inference over the STRING partition values (Hive stores strings)
        raw_by_col = {c: [] for c in part_cols}
        for _, parts in found:
            for k, v in parts:
                raw_by_col[k].append(None if v == NULL_PARTITION else v)
        part_fields, converters, part_dicts = [], {}, {}
        for c in part_cols:
            vals = [v for v in raw_by_col[c] if v is not None]
            ty, conv = self._infer(vals)
            if ty.is_string:
                uniq = sorted(set(vals))
                d = Dictionary(values=np.array(uniq or [""], dtype=object))
                id_map = {v: i for i, v in enumerate(uniq)}
                conv = id_map.__getitem__
                part_dicts[c] = d
            part_fields.append(Field(c, ty))
            converters[c] = conv

        files = []
        for path, parts in found:
            pseudo = f"{table}#hive{len(files)}"
            self._pq._paths[pseudo] = path
            pv = {k: (None if v == NULL_PARTITION else converters[k](v))
                  for k, v in parts}
            files.append(PartFile(path, pseudo, pv))
        data_schema = self._pq._open(files[0].pseudo).schema
        return _FTable(data_schema, tuple(part_fields), files, part_dicts, 0)

    @staticmethod
    def _infer(vals):
        try:
            [int(v) for v in vals]
            return BIGINT, int
        except ValueError:
            pass
        try:
            [float(v) for v in vals]
            return DOUBLE, float
        except ValueError:
            pass
        try:
            [_parse_epoch_days(v) for v in vals]
            return DATE, _parse_epoch_days
        except ValueError:
            pass
        return VarcharType.of(None), str

    # -- writes (reference: HivePageSink partition routing) ----------------------
    def create_table(self, table: str, schema: Schema, partitioned_by=(),
                     if_not_exists=False) -> bool:
        """Declare a partitioned table; rows arrive via ``append``.  The
        declared schema INCLUDES the partition columns (they route to the
        directory layout, not into the files)."""
        table_dir = os.path.join(self.warehouse, table)
        if self.fs.is_dir(table_dir) or table in self._tables:
            if if_not_exists:
                return False
            raise ValueError(f"table {table} already exists")
        names = [f.name for f in schema.fields]
        unknown = [c for c in partitioned_by if c not in names]
        if unknown:
            raise ValueError(f"partition columns {unknown} not in schema")
        if partitioned_by and \
                tuple(names[-len(partitioned_by):]) != tuple(partitioned_by):
            # discovery appends partition columns LAST; a different declared
            # order would silently flip positional column meaning at the
            # first write
            raise ValueError(
                "partition columns must be the trailing columns, in order: "
                f"declare (... , {', '.join(partitioned_by)})")
        self.fs.mkdirs(table_dir)
        self._pending_ddl = getattr(self, "_pending_ddl", {})
        self._pending_ddl[table] = (schema, tuple(partitioned_by))
        return True

    def append(self, table: str, decoded_columns, null_flags=None) -> None:
        """Host-convention rows (strings as str, decimals as raw scaled ints,
        dates as epoch days); rows group by partition tuple, one parquet file
        written per partition directory."""
        from .parquet import host_lists

        decoded_columns = host_lists(decoded_columns)
        schema, partitioned_by = self._write_layout(table)
        names = [f.name for f in schema.fields]
        by_name = dict(zip(names, decoded_columns))
        data_fields = [f for f in schema.fields if f.name not in partitioned_by]
        n = len(decoded_columns[0]) if decoded_columns else 0
        groups: dict = {}
        for i in range(n):
            key = tuple(by_name[c][i] for c in partitioned_by)
            groups.setdefault(key, []).append(i)
        for key, rows in groups.items():
            segs = []
            for c, v in zip(partitioned_by, key):
                f = schema.field(c)
                if v is None:
                    s = NULL_PARTITION
                elif f.type.name == "date":
                    s = (datetime.date(1970, 1, 1)
                         + datetime.timedelta(days=int(v))).isoformat()
                else:
                    s = str(v)
                segs.append(f"{c}={s}")
            part_dir = os.path.join(self.warehouse, table, *segs)
            self.fs.mkdirs(part_dir)
            cols = [[by_name[f.name][i] for i in rows] for f in data_fields]
            self._write_parquet(part_dir, data_fields, cols)
        self._tables.pop(table, None)  # re-discover on next read

    def _write_layout(self, table: str):
        pending = getattr(self, "_pending_ddl", {})
        if table in pending:
            return pending[table]
        # existing table: layout from discovery (partition cols trail)
        t = self._load(table)
        full = Schema(tuple(t.data_schema.fields) + t.part_fields)
        return full, tuple(f.name for f in t.part_fields)

    def _write_parquet(self, part_dir: str, fields, columns) -> None:
        # reuse the parquet connector's declared-type writer via a scratch
        # instance rooted at the partition directory
        from .parquet import ParquetConnector

        w = ParquetConnector(directory=part_dir)
        w.write_table(f"part-{uuid.uuid4().hex[:12]}",
                      [f.name for f in fields], [f.type for f in fields],
                      columns)

    def drop_table(self, table: str, if_exists=False) -> None:
        table_dir = os.path.join(self.warehouse, table)
        if not self.fs.is_dir(table_dir):
            if if_exists:
                return
            raise ValueError(f"table {table} does not exist")
        self.fs.delete_dir(table_dir)
        self._tables.pop(table, None)
        getattr(self, "_pending_ddl", {}).pop(table, None)
