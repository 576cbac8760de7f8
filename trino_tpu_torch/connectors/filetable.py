"""Shared machinery for multi-file table-format connectors (Hive, Delta)
(counterpart of ``trino_tpu/connectors/filetable.py``).

Reference: the split-generation + page-source layering every lakehouse plugin
shares (plugin/trino-hive/.../HivePageSourceProvider.java — data columns come
from the file reader, partition columns are synthesized as constants per
split; plugin/trino-delta-lake analogs).  File decode is delegated to
ParquetConnector's pseudo-path machinery (the Iceberg connector's pattern)
and partition columns are appended as constant host arrays (the page is a
host page, staged to the device by the executor: ``HOST_DECODE``), with
per-split exact pruning: a partition column's "range" is its single value —
for strings, in dictionary-ID space, matching the engine's id-space domains.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fs import LocalFileSystem
from ..page import Page, Schema
from .parquet import ParquetConnector, ParquetSplit
from .tpch import Dictionary

__all__ = ["PartFile", "FileSplit", "MultiFileConnector"]


@dataclasses.dataclass
class PartFile:
    """One data file + its partition coordinates."""

    path: str
    pseudo: str  # registration key into the parquet delegate
    part_values: dict  # partition column -> raw engine value (int64 / float /
    # epoch days / dictionary id) or None for NULL partitions
    lower: dict = dataclasses.field(default_factory=dict)  # file-level stats
    upper: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class FileSplit:
    table: str
    file_index: int
    row_group: int


@dataclasses.dataclass
class _FTable:
    data_schema: Schema
    part_fields: tuple  # Field... (appended after the data columns)
    files: list  # PartFile...
    part_dicts: dict  # partition varchar column -> Dictionary
    n_rows: int


class MultiFileConnector:
    """Base: subclasses implement ``_discover(table) -> _FTable`` (schema +
    file list + partition metadata); everything else — splits, pruning,
    dictionary unification, constant-column synthesis — is shared."""

    HOST_DECODE = True  # parquet delegate decodes on the host: scans benefit
    # from background-thread split prefetch
    CACHEABLE_SCANS = True  # host-decoded pages: the buffer pool saves
    # BOTH the decode and the host->device staging on warm scans.  Files
    # are assumed immutable between engine-visible DDL (the reference
    # caching connectors' contract); out-of-band rewrites need an
    # engine invalidation

    def __init__(self, fs=None):
        self.fs = fs if fs is not None else LocalFileSystem()
        self._tables: dict = {}
        self._pq = ParquetConnector(directory="")

    # -- subclass surface --------------------------------------------------------
    def _discover(self, table: str) -> _FTable:
        raise NotImplementedError

    # -- shared loading ----------------------------------------------------------
    def _load(self, table: str) -> _FTable:
        t = self._tables.get(table)
        if t is None:
            t = self._discover(table)
            self._unify_dictionaries(t)
            t.n_rows = sum(self._pq._open(f.pseudo).n_rows for f in t.files)
            self._tables[table] = t
        return t

    def _unify_dictionaries(self, t: _FTable) -> None:
        """Stable string ids across every data file (see IcebergConnector)."""
        string_cols = [f.name for f in t.data_schema.fields if f.type.is_string]
        if not string_cols or not t.files:
            return
        values: dict = {c: set() for c in string_cols}
        opened = [self._pq._open(f.pseudo) for f in t.files]
        for pt in opened:
            for c in string_cols:
                d = pt.dicts.get(c)
                if d is not None:
                    values[c].update(d.values.tolist())
        for c in string_cols:
            uniq = sorted(values[c])
            gd = Dictionary(values=np.array(uniq or [""], dtype=object))
            id_map = {v: i for i, v in enumerate(uniq)}
            for pt in opened:
                pt.dicts[c] = gd
                pt.id_maps[c] = id_map

    # -- connector protocol ------------------------------------------------------
    def schema(self, table: str) -> Schema:
        t = self._load(table)
        return Schema(tuple(t.data_schema.fields) + t.part_fields)

    def dictionaries(self, table: str) -> dict:
        t = self._load(table)
        out = dict(self._pq._open(t.files[0].pseudo).dicts) if t.files else {}
        out.update(t.part_dicts)
        return out

    def row_count(self, table: str) -> int:
        return self._load(table).n_rows

    def column_range(self, table: str, column: str):
        t = self._load(table)
        pv = [f.part_values.get(column) for f in t.files
              if column in f.part_values]
        if pv and all(v is not None for v in pv):
            return (min(pv), max(pv))
        los = [f.lower[column] for f in t.files if column in f.lower]
        his = [f.upper[column] for f in t.files if column in f.upper]
        if t.files and len(los) == len(t.files) and len(his) == len(t.files):
            return (min(los), max(his))
        return (None, None)

    def splits(self, table: str, n_hint: int = 0):
        t = self._load(table)
        out = []
        for i, f in enumerate(t.files):
            for rg in range(self._pq._open(f.pseudo).n_row_groups):
                out.append(FileSplit(table, i, rg))
        return out

    def split_range(self, split: FileSplit, column: str):
        """Partition columns prune EXACTLY (value == the split's coordinate,
        id-space for strings); data columns use row-group stats, then
        file-level bounds."""
        t = self._load(split.table)
        f = t.files[split.file_index]
        if column in f.part_values:
            v = f.part_values[column]
            return None if v is None else (v, v)
        rg = self._pq.split_range(ParquetSplit(f.pseudo, split.row_group),
                                  column)
        if rg is not None:
            return rg
        lo, hi = f.lower.get(column), f.upper.get(column)
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
            return (lo, hi)
        return None

    def generate(self, split: FileSplit, columns=None):
        t = self._load(split.table)
        f = t.files[split.file_index]
        part_names = {pf.name: pf for pf in t.part_fields}
        if columns is None:
            columns = [fl.name for fl in t.data_schema.fields] \
                + list(part_names)
        data_cols = [c for c in columns if c not in part_names]
        # the file page provides the row count; when only partition columns
        # are requested, read one data column as the row-count carrier
        carrier = data_cols or [t.data_schema.fields[0].name]
        page = self._pq.generate(ParquetSplit(f.pseudo, split.row_group),
                                 carrier)
        n = page.capacity
        by_name = dict(zip(carrier, zip(page.columns, page.null_masks)))
        cols, nulls, fields = [], [], []
        for c in columns:
            pf = part_names.get(c)
            if pf is None:
                v, nm = by_name[c]
                cols.append(v)
                nulls.append(nm)
                fields.append(t.data_schema.field(c))
            else:
                v = f.part_values.get(c)
                dt = np.dtype(pf.type.dtype)
                cols.append(np.full((n,), 0 if v is None else v, dt))
                nulls.append(np.ones((n,), bool) if v is None else None)
                fields.append(pf)
        return Page(Schema(tuple(fields)), tuple(cols), tuple(nulls),
                    page.valid)
