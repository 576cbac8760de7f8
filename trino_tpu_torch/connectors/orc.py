"""ORC file connector (counterpart of ``trino_tpu/connectors/orc.py``).

Reference: lib/trino-orc (OrcRecordReader.java:84 — stripe-based reads with
column projection; stream readers + predicate pushdown).  pyarrow.orc supplies
the host-side columnar decode; the connector maps stripes to splits and
dictionary-encodes strings table-wide so pages carry int32 ids (same
page model as the Parquet connector: host numpy pages, ``HOST_DECODE``,
staged to the device by the executor; pyarrow imported at first use).

Layout: one table per ``<name>.orc`` file inside the connector directory.
Splits = stripes (the reference's split granularity for ORC tables).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..page import Field, Page, Schema
from .parquet import _arrow_to_type, _pyarrow
from .tpch import Dictionary

__all__ = ["OrcConnector"]


@dataclasses.dataclass(frozen=True)
class OrcSplit:
    table: str
    stripe: int


@dataclasses.dataclass
class _OrcTable:
    path: str
    schema: Schema
    n_rows: int
    n_stripes: int
    dicts: dict  # column -> Dictionary
    id_maps: dict  # column -> {value: id}


class OrcConnector:

    CACHEABLE_SCANS = True  # file pages are immutable between DDL;
    # the buffer pool keeps decoded columns device-resident across queries
    name = "orc"
    HOST_DECODE = True  # pyarrow stripe decode on the host: prefetchable

    def __init__(self, directory: str):
        self.directory = directory
        self._tables: dict = {}

    def tables(self):
        names = set(self._tables)
        if os.path.isdir(self.directory):
            for f in os.listdir(self.directory):
                if f.endswith(".orc"):
                    names.add(f[:-len(".orc")])
        return sorted(names)

    def _open(self, table: str) -> _OrcTable:
        t = self._tables.get(table)
        if t is not None:
            return t
        orc = _pyarrow("orc")

        path = os.path.join(self.directory, f"{table}.orc")
        of = orc.ORCFile(path)
        fields, dicts, id_maps, ranges = [], {}, {}, {}
        types_by_name = {}
        for fld in of.schema:
            ty = _arrow_to_type(fld.type)
            fields.append(Field(fld.name, ty))
            types_by_name[fld.name] = ty
        # ONE decode pass builds string dictionaries AND numeric file-level
        # bounds (pyarrow's ORC reader exposes no stripe statistics, and the
        # file is being opened anyway; per-column reads would decompress the
        # stripes once per column)
        wanted = [n for n, ty in types_by_name.items()
                  if ty.is_string or ty.is_integer or ty.name == "date"]
        tbl = of.read(columns=wanted) if wanted else None
        for n in wanted:
            pc = _pyarrow("compute")

            ty = types_by_name[n]
            col = tbl.column(n)
            if ty.is_string:
                uniq = sorted(v for v in pc.unique(col).to_pylist()
                              if v is not None)
                dicts[n] = Dictionary(values=np.array(uniq or [""],
                                                      dtype=object))
                id_maps[n] = {v: i for i, v in enumerate(uniq)}
            else:
                lo, hi = pc.min(col).as_py(), pc.max(col).as_py()
                if ty.name == "date" and lo is not None:
                    import datetime

                    epoch = datetime.date(1970, 1, 1)
                    lo, hi = (lo - epoch).days, (hi - epoch).days
                if lo is not None:
                    ranges[n] = (lo, hi)
        t = _OrcTable(path, Schema(tuple(fields)), of.nrows, of.nstripes,
                      dicts, id_maps)
        t.ranges = ranges
        self._tables[table] = t
        return t

    def schema(self, table: str) -> Schema:
        return self._open(table).schema

    def dictionaries(self, table: str) -> dict:
        return dict(self._open(table).dicts)

    def row_count(self, table: str) -> int:
        return self._open(table).n_rows

    def column_range(self, table: str, column: str):
        return getattr(self._open(table), "ranges", {}).get(column,
                                                            (None, None))

    def splits(self, table: str, n_hint: int = 0):
        t = self._open(table)
        return [OrcSplit(table, s) for s in range(t.n_stripes)]

    def generate(self, split: OrcSplit, columns=None) -> Page:
        """One stripe -> one host page of numpy arrays."""
        orc = _pyarrow("orc")

        t = self._open(split.table)
        names = columns if columns is not None else t.schema.names
        out_schema = Schema(tuple(t.schema.field(c) for c in names))
        of = orc.ORCFile(t.path)
        batch = of.read_stripe(split.stripe, columns=list(names))
        cols, nulls = [], []
        for cname in names:
            f = t.schema.field(cname)
            arr = batch.column(cname)
            null_np = np.asarray(arr.is_null())
            if f.type.is_string:
                # one python pass per DISTINCT stripe value, vectorized gather
                # for the rows (same shape as the parquet dictionary decode)
                pa = _pyarrow()

                idm = t.id_maps[cname]
                if isinstance(arr, pa.ChunkedArray):
                    arr = arr.combine_chunks()
                enc = arr if pa.types.is_dictionary(arr.type) \
                    else arr.dictionary_encode()
                local = enc.dictionary.to_pylist()
                remap = np.fromiter((0 if v is None else idm[v]
                                     for v in local), np.int32,
                                    count=len(local))
                idx = np.asarray(enc.indices.fill_null(0)).astype(np.int64)
                ids = remap[idx] if len(local) else np.zeros(len(arr), np.int32)
                cols.append(np.ascontiguousarray(ids, np.int32))
            else:
                np_arr = arr.to_numpy(zero_copy_only=False)
                if f.type.name == "date":
                    np_arr = np_arr.astype("datetime64[D]").astype(np.int32)
                if null_np.any():
                    np_arr = np.where(null_np, 0, np_arr)
                cols.append(np.ascontiguousarray(np_arr.astype(np.dtype(f.type.dtype))))
            nulls.append(np.array(null_np, bool) if null_np.any() else None)
        return Page(out_schema, tuple(cols), tuple(nulls), None)

    # -- write (CTAS/INSERT target parity with the parquet connector) ----------
    def write_table(self, table: str, names, types, columns) -> str:
        from .parquet import arrow_arrays

        pa, orc = _pyarrow(), _pyarrow("orc")

        arrays = arrow_arrays(types, columns)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"{table}.orc")
        orc.write_table(pa.table(dict(zip(names, arrays))), path)
        self._tables.pop(table, None)
        return path
