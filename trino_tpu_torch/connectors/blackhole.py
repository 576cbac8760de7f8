"""Blackhole connector: null source / null sink for benchmarking the engine path
(counterpart of ``trino_tpu/connectors/blackhole.py``).

Reference: plugin/trino-blackhole (BlackHoleConnector.java:42) — tables accept
any INSERT and discard it, scans return a configurable number of empty-ish rows
instantly.  Used to measure planner/executor overhead without storage costs.

Pages are made on the connector's device (``torch.arange`` for integer
columns, ``torch.zeros`` otherwise); ``device=None`` binds to the engine's
device at ``register_catalog``, as the memory connector's does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..page import Page, Schema
from ..types import torch_dtype

__all__ = ["BlackHoleConnector"]


@dataclasses.dataclass(frozen=True)
class BlackHoleSplit:
    table: str
    lo: int
    hi: int


@dataclasses.dataclass
class _BhTable:
    schema: Schema
    rows_per_page: int
    pages_per_split: int
    splits: int
    inserted_rows: int = 0


class BlackHoleConnector:
    name = "blackhole"

    def __init__(self, device=None):
        # device the pages are made on; None = the device of the engine
        self.device = device
        self._tables: dict[str, _BhTable] = {}

    def _dev(self) -> torch.device:
        return torch.device(self.device if self.device is not None else "cpu")

    def tables(self):
        return sorted(self._tables)

    def schema(self, table: str) -> Schema:
        return self._tables[table].schema

    def dictionaries(self, table: str) -> dict:
        return {}

    def row_count(self, table: str) -> int:
        t = self._tables[table]
        return t.rows_per_page * t.pages_per_split * t.splits

    def column_range(self, table: str, column: str):
        return (None, None)

    # DDL/DML (reference: blackhole accepts CREATE TABLE + INSERT, discards data)
    def create_table(self, table: str, schema: Schema, if_not_exists=False,
                     rows_per_page: int = 0, pages_per_split: int = 1,
                     splits: int = 1) -> bool:
        if table in self._tables:
            if if_not_exists:
                return False
            raise ValueError(f"table {table} already exists")
        self._tables[table] = _BhTable(schema, rows_per_page, pages_per_split, splits)
        return True

    def drop_table(self, table: str, if_exists=False) -> None:
        if table not in self._tables and not if_exists:
            raise ValueError(f"table {table} does not exist")
        self._tables.pop(table, None)

    def append(self, table: str, decoded_columns, null_flags=None) -> None:
        t = self._tables[table]
        t.inserted_rows += len(decoded_columns[0]) if decoded_columns else 0
        # rows vanish (the point of the connector)

    def splits(self, table: str, n_hint: int = 0):
        t = self._tables[table]
        n = t.rows_per_page * t.pages_per_split
        return [BlackHoleSplit(table, s * n, (s + 1) * n) for s in range(t.splits)]

    def generate(self, split: BlackHoleSplit, columns=None) -> Page:
        t = self._tables[split.table]
        names = columns if columns is not None else t.schema.names
        out_schema = Schema(tuple(t.schema.field(c) for c in names))
        n = split.hi - split.lo
        dev = self._dev()
        cols = []
        for c in names:
            f = t.schema.field(c)
            dt = torch_dtype(f.type)
            if f.type.name == "bigint" or f.type.is_integer:
                cols.append(torch.arange(split.lo, split.hi, dtype=dt, device=dev))
            else:
                cols.append(torch.zeros((n,), dtype=dt, device=dev))
        return Page(out_schema, tuple(cols), tuple(None for _ in cols), None)
