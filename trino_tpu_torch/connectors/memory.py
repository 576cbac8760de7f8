"""In-memory writable connector (counterpart of ``trino_tpu/connectors/memory.py``).

Reference: plugin/trino-memory (MemoryPagesStore.java:43 keeps pages on heap;
the connector serves CREATE TABLE / INSERT / SELECT and row-level DML).

Unlike the reference, which keeps numpy columns on the host and copies each
split to the device on every scan, the stored columns and null masks are
torch tensors on the connector's device, so a table sits in device memory
at the size a deployment keeps there:

- ``device=None`` binds to the engine's device at ``register_catalog``;
- ``generate`` hands out slices (views) of the stored tensors, never copies;
- ``append`` concatenates, ``update_rows`` builds new tensors with
  ``torch.where`` and ``delete_rows`` compacts the kept rows with
  ``ops/arrays.compact_rows`` (the ``compact_rows`` kernel on the card, one
  call per 16 stored arrays).  No stored tensor is ever written in place, so
  a page handed out earlier keeps the rows it was given.

String columns hold int32 ids into a growable per-column dictionary, which
stays on the host.  Writes are vectorised with numpy and keep the
reference's semantics: a value that ``is None`` is NULL and stores 0, a
string is ``str(v)`` and gets its id at its first appearance, decimals come
as raw scaled ints and dates as epoch days.  A column may also come in
storage form already (``Raw``, ``Coded``), as the engine's writes pass a
query result's columns.

An array(T) column stores one int64 span per row (start << 24 | length, as
``ops/arrays.py`` packs them) on the device, into an element heap that stays
a host numpy array per column, as in the reference: every scan hands it out
in the channel's dictionary slot (``ArrayData``), and the executor copies it
to the device once per query.  Appends add python lists (None = NULL) to the
heap, with spans offset by its length; string elements take ids in a growable
dictionary of the column.  DELETE and UPDATE move spans and leave the heaps
as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.arrays import ArrayData, compact_rows, encode_arrays, pack_span, span_len
from ..page import Page, Schema
from ..types import ArrayType, torch_dtype
from .tpch import Dictionary

__all__ = ["MemoryConnector", "Raw", "Coded", "SPLIT_ROWS"]

SPLIT_ROWS = 1 << 20
_COMPACT_ARRAYS = 16  # stored arrays per compact_rows call: one kernel launch each

_is_none_u = np.frompyfunc(lambda v: v is None, 1, 1)
_str_u = np.frompyfunc(str, 1, 1)


@dataclasses.dataclass(frozen=True)
class Raw:
    """A column in storage form: ``values`` in the column's numpy dtype
    (decimals as scaled ints, dates as epoch days, 0 where NULL) and
    ``nulls`` (True = NULL)."""

    values: np.ndarray
    nulls: np.ndarray

    def __len__(self):
        return len(self.values)


@dataclasses.dataclass(frozen=True)
class Coded:
    """A string column as codes into a table of strings: row i holds
    ``values[codes[i]]``, or NULL where ``nulls[i]``."""

    codes: np.ndarray
    values: np.ndarray
    nulls: np.ndarray

    def __len__(self):
        return len(self.codes)


def is_none(arr) -> np.ndarray:
    """``v is None`` for each element, as a bool array."""
    arr = np.asarray(arr) if isinstance(arr, np.ndarray) else _objects(arr)
    if arr.dtype != object:
        return np.zeros(arr.shape, bool)
    return _is_none_u(arr).astype(bool)


def _objects(vals) -> np.ndarray:
    """A 1-D object array of ``vals`` (a list stays one element per value)."""
    out = np.empty(len(vals), dtype=object)
    out[:] = list(vals)
    return out


def first_seen(codes):
    """(the distinct codes in the order of their first appearance, the row
    of each one's first appearance, each row's position among them) of an
    integer array.  Dense codes take a scatter-min over the code range;
    sparse ones a sort."""
    codes = np.asarray(codes, np.int64)
    n = len(codes)
    lo = int(codes.min()) if n else 0
    k = int(codes.max()) - lo + 1 if n else 0
    if k <= 2 * n + 1024:
        c = codes - lo
        first = np.full(k, n, np.int64)
        np.minimum.at(first, c, np.arange(n))
        used = np.flatnonzero(first < n)
        order = used[np.argsort(first[used], kind="stable")]
        rank = np.empty(k, np.int64)
        rank[order] = np.arange(len(order))
        return order + lo, first[order], rank[c]
    uniq, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(order))
    return uniq[order], first[order], rank[inv.reshape(-1)]


class _GrowableDict:
    """Mutable value<->id mapping materialising an immutable Dictionary view
    (cached until the dictionary grows)."""

    def __init__(self):
        self.values: list = []
        self.ids: dict = {}
        self._view = None

    def _ids_for(self, strings: list) -> np.ndarray:
        """Ids of ``strings``, new ones appended in the order given."""
        if not self.ids:  # a fresh dictionary (CTAS): distinct strings take 0..n-1
            fresh = dict(zip(strings, range(len(strings))))
            if len(fresh) == len(strings):
                self.ids, self.values = fresh, strings
                return np.arange(len(strings), dtype=np.int32)
        new = [s for s in dict.fromkeys(strings) if s not in self.ids]
        if new:
            base = len(self.values)
            self.ids.update(zip(new, range(base, base + len(new))))
            self.values.extend(new)
        return np.fromiter(map(self.ids.__getitem__, strings), np.int32, len(strings))

    def encode_codes(self, codes, values, nulls) -> np.ndarray:
        """Ids of a ``Coded`` column: each distinct code's string is encoded
        once, in the order of its first appearance; NULL rows get id 0."""
        codes = np.asarray(codes)
        out = np.zeros(len(codes), np.int32)
        live = np.flatnonzero(~np.asarray(nulls, bool))
        if not len(live):
            return out
        distinct, _, inv = first_seen(codes[live])
        strings = list(_str_u(_objects(np.asarray(values)[distinct])))
        out[live] = self._ids_for(strings)[inv]
        return out

    def encode(self, vals) -> np.ndarray:
        """Ids of decoded values (``None`` -> 0, masked by the null mask)."""
        arr = vals if isinstance(vals, np.ndarray) else _objects(vals)
        none = is_none(arr)
        codes = np.zeros(len(arr), np.int64)
        table = np.empty(0, object)
        if not none.all():
            table, inv = np.unique(_str_u(arr[~none].astype(object)), return_inverse=True)
            codes[~none] = inv.reshape(-1)
        return self.encode_codes(codes, table, none)

    def view(self) -> Dictionary:
        if self._view is None or self._view[0] != len(self.values):
            self._view = (len(self.values), Dictionary(values=np.array(
                self.values if self.values else [""], dtype=object)))
        return self._view[1]


@dataclasses.dataclass
class _MemTable:
    schema: Schema
    columns: list  # torch tensors on the connector's device (strings: int32 ids;
    # arrays: int64 spans)
    nulls: list  # torch bool tensors | None
    growable: dict  # column name -> _GrowableDict (string columns + array elements)
    heaps: dict = dataclasses.field(default_factory=dict)  # array column -> host heap
    max_lens: dict = dataclasses.field(default_factory=dict)  # array column -> longest


@dataclasses.dataclass(frozen=True)
class MemorySplit:
    table: str
    lo: int
    hi: int


class MemoryConnector:
    name = "memory"
    CACHEABLE_SCANS = True  # every write through the engine calls
    # Engine._invalidate, which clears the buffer pool; a write that
    # bypasses the engine (a direct ``append``) must invalidate itself, the
    # contract the plan cache imposes too

    def __init__(self, device=None):
        # device the tables live on; None = the device of the engine
        self.device = device
        self._tables: dict = {}

    def _dev(self) -> torch.device:
        return torch.device(self.device if self.device is not None else "cpu")

    # metadata ---------------------------------------------------------------
    def tables(self):
        return list(self._tables)

    def schema(self, table: str) -> Schema:
        return self._tables[table].schema

    def dictionaries(self, table: str) -> dict:
        t = self._tables[table]
        out = {}
        for f in t.schema.fields:
            if isinstance(f.type, ArrayType):
                gd = t.growable.get(f.name)
                out[f.name] = ArrayData(t.heaps[f.name], f.type.element,
                                        elem_dict=gd.view() if gd else None,
                                        max_len=t.max_lens[f.name])
            elif f.name in t.growable:
                out[f.name] = t.growable[f.name].view()
        return out

    def row_count(self, table: str) -> int:
        t = self._tables[table]
        return 0 if not t.columns else int(t.columns[0].shape[0])

    def column_range(self, table: str, column: str):
        return (None, None)

    # DDL/DML ----------------------------------------------------------------
    def create_table(self, table: str, schema: Schema, if_not_exists=False) -> bool:
        """Returns False when IF NOT EXISTS skipped an existing table."""
        if table in self._tables:
            if if_not_exists:
                return False
            raise ValueError(f"table {table} already exists")
        dev = self._dev()
        arrays = [f for f in schema.fields if isinstance(f.type, ArrayType)]
        self._tables[table] = _MemTable(
            schema,
            [torch.empty((0,), dtype=torch_dtype(f.type), device=dev) for f in schema.fields],
            [None] * len(schema.fields),
            {f.name: _GrowableDict() for f in schema.fields
             if f.type.is_string or (f in arrays and f.type.element.is_string)},
            {f.name: np.zeros(0, np.dtype(f.type.element.dtype)) for f in arrays},
            {f.name: 0 for f in arrays})
        return True

    def drop_table(self, table: str, if_exists=False) -> None:
        if table not in self._tables:
            if if_exists:
                return
            raise ValueError(f"table {table} does not exist")
        del self._tables[table]

    def _append_arrays(self, t: _MemTable, f, rows):
        """(spans, null flags) of appended python lists (None = NULL), whose
        elements extend the column's heap (``encode_arrays``); string
        elements take their dictionary ids in one call."""
        gd = t.growable.get(f.name)
        heap_dt = t.heaps[f.name].dtype
        spans, nulls, heap = encode_arrays(rows, object if gd is not None else heap_dt)
        if gd is not None:
            # code each distinct element once (in order of first appearance),
            # then give the codes their dictionary ids
            table: dict = {}
            codes = np.fromiter((table.setdefault(x, len(table)) for x in heap), np.int64,
                                len(heap))
            distinct = _objects(list(table))
            heap = gd.encode_codes(codes, distinct, is_none(distinct)[codes]).astype(heap_dt)
        base = len(t.heaps[f.name])
        spans = np.where(spans != 0, spans + pack_span(base, 0), spans)
        t.heaps[f.name] = np.concatenate([t.heaps[f.name], heap])
        longest = int(span_len(spans).max()) if len(spans) else 0
        t.max_lens[f.name] = max(t.max_lens[f.name], longest)
        return spans, (np.zeros(len(spans), bool) if nulls is None else nulls)

    def _storage(self, t: _MemTable, i: int, vals, null_flags=None):
        """(storage numpy array, null flags) of one written column."""
        f = t.schema.fields[i]
        dtype = np.dtype(f.type.dtype)
        if isinstance(f.type, ArrayType) and not isinstance(vals, (Raw, Coded)):
            arr, nulls = self._append_arrays(t, f, vals)
        elif isinstance(vals, Coded):
            if not f.type.is_string:
                raise TypeError(f"string codes written to {f.type.name} column {f.name}")
            arr = t.growable[f.name].encode_codes(vals.codes, vals.values, vals.nulls)
            nulls = np.asarray(vals.nulls, bool)
        elif isinstance(vals, Raw):
            nulls = np.asarray(vals.nulls, bool)
            arr = np.asarray(vals.values)
            arr = (np.where(nulls, 0, arr) if nulls.any() else arr).astype(dtype, copy=False)
        else:
            obj = vals if isinstance(vals, np.ndarray) else _objects(vals)
            nulls = is_none(obj)
            if f.type.is_string:
                arr = t.growable[f.name].encode(obj)
            elif nulls.any():
                filled = obj.copy()
                filled[nulls] = 0
                arr = filled.astype(dtype)
            else:
                arr = obj.astype(dtype)
        if null_flags is not None:
            nulls = np.asarray(null_flags, bool)
        return arr, nulls

    def append(self, table: str, decoded_columns, null_flags=None) -> None:
        """Append decoded host values (strings as python str, decimals as raw
        scaled ints, dates as epoch days) or columns in storage form."""
        t = self._tables[table]
        n = len(decoded_columns[0]) if decoded_columns else 0
        dev = self._dev()
        for i, f in enumerate(t.schema.fields):
            arr, nulls = self._storage(t, i, decoded_columns[i],
                                       None if null_flags is None else null_flags[i])
            t.columns[i] = torch.cat([t.columns[i], torch.as_tensor(arr, device=dev)
                                      .to(torch_dtype(f.type))])
            if nulls.any() or t.nulls[i] is not None:
                prev = (t.nulls[i] if t.nulls[i] is not None else
                        torch.zeros((t.columns[i].shape[0] - n,), dtype=torch.bool, device=dev))
                t.nulls[i] = torch.cat([prev, torch.as_tensor(nulls, device=dev)])

    def delete_rows(self, table: str, mask) -> int:
        """Remove rows where mask is True (reference: ConnectorMergeSink
        delete path; the memory connector applies it eagerly): a stable
        compaction of every stored array into the kept count."""
        t = self._tables[table]
        mask = np.asarray(mask, bool)
        deleted = int(np.count_nonzero(mask))
        if not deleted:
            return 0
        keep = torch.as_tensor(~mask, device=self._dev())
        kept = len(mask) - deleted
        arrays = list(t.columns) + [m for m in t.nulls if m is not None]
        packed = []
        for lo in range(0, len(arrays), _COMPACT_ARRAYS):
            out, _ = compact_rows(arrays[lo:lo + _COMPACT_ARRAYS], keep, kept)
            packed.extend(out)
        t.columns = packed[:len(t.columns)]
        rest = iter(packed[len(t.columns):])
        t.nulls = [None if m is None else next(rest) for m in t.nulls]
        names = [f.name for f in t.schema.fields if isinstance(f.type, ArrayType)]
        if names:  # the longest array left, as the reference rescans its spans
            cols = [t.columns[t.schema.index(nm)] for nm in names]
            got = torch.stack([span_len(c).max() if c.shape[0] else
                               torch.zeros((), dtype=torch.int64, device=c.device)
                               for c in cols]).cpu().tolist()
            t.max_lens.update(zip(names, got))
        return deleted

    def update_rows(self, table: str, mask, decoded_values: dict) -> int:
        """Assign decoded values (or columns in storage form) on rows where
        mask is True (strings re-encode through the table-wide growable
        dictionary)."""
        t = self._tables[table]
        m_np = np.asarray(mask, bool)
        dev = self._dev()
        m = torch.as_tensor(m_np, device=dev)
        for col, vals in decoded_values.items():
            i = t.schema.index(col)
            arr, nulls = self._storage(t, i, vals)
            old = t.columns[i]
            t.columns[i] = torch.where(m, torch.as_tensor(arr, device=dev).to(old.dtype), old)
            if nulls.any() or t.nulls[i] is not None:
                prev = t.nulls[i] if t.nulls[i] is not None else \
                    torch.zeros(old.shape, dtype=torch.bool, device=dev)
                t.nulls[i] = torch.where(m, torch.as_tensor(nulls, device=dev), prev)
        return int(m_np.sum())

    # scan -------------------------------------------------------------------
    def splits(self, table: str, n_hint: int = 0):
        n = self.row_count(table)
        return [MemorySplit(table, lo, min(lo + SPLIT_ROWS, n))
                for lo in range(0, n, SPLIT_ROWS)]

    def generate(self, split: MemorySplit, columns=None) -> Page:
        """Slices of the stored tensors: views, every lane live."""
        t = self._tables[split.table]
        names = columns if columns is not None else t.schema.names
        out_schema = Schema(tuple(t.schema.field(n) for n in names))
        cols, nulls = [], []
        for n in names:
            i = t.schema.index(n)
            cols.append(t.columns[i][split.lo:split.hi])
            nm = t.nulls[i]
            nulls.append(None if nm is None else nm[split.lo:split.hi])
        return Page(out_schema, tuple(cols), tuple(nulls), None)
