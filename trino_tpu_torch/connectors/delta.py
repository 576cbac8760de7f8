"""Delta Lake connector, read path (counterpart of
``trino_tpu/connectors/delta.py``).

Reference: plugin/trino-delta-lake — the transaction log under ``_delta_log/``
is the table's source of truth (TransactionLogAccess.java): JSON commit files
hold ``metaData`` (schemaString + partitionColumns), ``add`` and ``remove``
file actions; the live file set is the log replay.  This subset reads the
``_last_checkpoint`` pointer and its checkpoint parquet (single-file or
multi-part via the ``parts`` field), replays the JSON commits after it in
version order (falling back to full JSON replay when the checkpoint files are
absent or unreadable), maps each live ``add`` to a parquet split, synthesizes
partition columns as constants, and prunes splits with the add action's
``stats`` min/max (TransactionLogParser + DeltaLakeSplitManager's stats-based
pruning).  Action paths arrive percent-encoded and are decoded before
resolution (reference: TransactionLogParser URL-decoding of add paths).
"""

from __future__ import annotations

import datetime
import json
import os
from urllib.parse import unquote

import numpy as np

from ..page import Field
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, DecimalType,
                     VarcharType)
from .filetable import MultiFileConnector, PartFile, _FTable
from .tpch import Dictionary

__all__ = ["DeltaConnector"]


def _delta_type(t: str):
    if isinstance(t, dict):
        raise NotImplementedError(f"nested delta type {t.get('type')}")
    if t.startswith("decimal"):
        p, s = t[t.index("(") + 1:-1].split(",")
        return DecimalType.of(int(p), int(s))
    return {
        "string": VarcharType.of(None), "long": BIGINT, "integer": INTEGER,
        "short": INTEGER, "byte": INTEGER, "double": DOUBLE, "float": REAL,
        "boolean": BOOLEAN, "date": DATE,
    }[t]


def _epoch_days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


class DeltaConnector(MultiFileConnector):
    name = "delta"

    def __init__(self, warehouse: str, fs=None):
        super().__init__(fs)
        self.warehouse = warehouse

    def tables(self):
        out = []
        if self.fs.is_dir(self.warehouse):
            for d in self.fs.list_dir(self.warehouse):
                if self.fs.is_dir(os.path.join(self.warehouse, d, "_delta_log")):
                    out.append(d)
        return out

    def _discover(self, table: str) -> _FTable:
        table_dir = os.path.join(self.warehouse, table)
        log_dir = os.path.join(table_dir, "_delta_log")
        if not self.fs.is_dir(log_dir):
            raise ValueError(f"table {table} does not exist (no _delta_log)")
        commits = sorted(f for f in self.fs.list_dir(log_dir)
                         if f.endswith(".json") and f[:-5].isdigit())
        meta = None
        live: dict = {}  # path -> add action (log replay)

        # checkpoint: the compacted log state at some version — replay starts
        # there and only JSON commits AFTER it apply (reference:
        # TransactionLogAccess reading _last_checkpoint + checkpoint parquet;
        # vacuumed tables have no JSON commits before the checkpoint)
        ckpt_version, ckpt_parts = -1, None
        lc = os.path.join(log_dir, "_last_checkpoint")
        if self.fs.exists(lc):
            try:
                lc_doc = json.loads(self.fs.read_text(lc))
                ckpt_version = int(lc_doc["version"])
                ckpt_parts = lc_doc.get("parts")
            except (ValueError, KeyError):
                ckpt_version = -1
        if ckpt_version >= 0:
            try:
                meta, live = self._read_checkpoint(log_dir, ckpt_version,
                                                   ckpt_parts)
                commits = [c for c in commits if int(c[:-5]) > ckpt_version]
            except (FileNotFoundError, OSError, ValueError) as e:
                # stale/corrupt checkpoint pointer: full JSON replay still
                # yields the correct state as long as the commits are present
                meta, live = None, {}
                if not commits:
                    raise ValueError(
                        f"table {table}: checkpoint at version {ckpt_version} "
                        f"unreadable ({e}) and no JSON commits to replay")
        for c in commits:
            text = self.fs.read_text(os.path.join(log_dir, c))
            for line in text.splitlines():
                if not line.strip():
                    continue
                action = json.loads(line)
                if "metaData" in action:
                    meta = action["metaData"]
                elif "add" in action:
                    a = dict(action["add"])
                    a["path"] = unquote(a["path"])
                    live[a["path"]] = a
                elif "remove" in action:
                    live.pop(unquote(action["remove"]["path"]), None)
        if meta is None:
            raise ValueError(f"table {table}: no metaData action in log")

        schema_json = json.loads(meta["schemaString"])
        part_cols = list(meta.get("partitionColumns", ()))
        data_fields, part_types = [], {}
        for f in schema_json["fields"]:
            try:
                ty = _delta_type(f["type"])
            except (NotImplementedError, KeyError):
                continue  # unsupported types are not exposed
            if f["name"] in part_cols:
                part_types[f["name"]] = ty
            else:
                data_fields.append(Field(f["name"], ty))
        part_fields = tuple(Field(c, part_types[c]) for c in part_cols
                            if c in part_types)

        # partition varchar dictionaries over the distinct live values
        part_dicts: dict = {}
        converters: dict = {}
        for pf in part_fields:
            if pf.type.is_string:
                uniq = sorted({a["partitionValues"].get(pf.name)
                               for a in live.values()}
                              - {None})
                part_dicts[pf.name] = Dictionary(
                    values=np.array(uniq or [""], dtype=object))
                id_map = {v: i for i, v in enumerate(uniq)}
                converters[pf.name] = id_map.__getitem__
            elif pf.type.name == "date":
                converters[pf.name] = _epoch_days
            elif pf.type.is_floating:
                converters[pf.name] = float
            elif isinstance(pf.type, DecimalType):
                converters[pf.name] = \
                    lambda s, sc=pf.type.scale: round(float(s) * 10**sc)
            else:
                converters[pf.name] = int

        files = []
        for path, a in sorted(live.items()):
            fpath = os.path.join(table_dir, path)
            pseudo = f"{table}#delta{len(files)}"
            self._pq._paths[pseudo] = fpath
            pv = {}
            for pf in part_fields:
                raw = a.get("partitionValues", {}).get(pf.name)
                pv[pf.name] = None if raw is None else converters[pf.name](raw)
            lower, upper = self._stats_bounds(a, data_fields)
            files.append(PartFile(fpath, pseudo, pv, lower, upper))
        if not files:
            raise ValueError(f"table {table} has no live data files")
        data_schema = self._pq._open(files[0].pseudo).schema
        return _FTable(data_schema, part_fields, files, part_dicts, 0)

    def _read_checkpoint(self, log_dir: str, version: int, parts=None):
        """Checkpoint parquet -> (metaData dict, live add actions): each row
        holds at most one action as a nested struct (add / remove / metaData
        columns); remove rows are tombstones already applied at write time.
        Multi-part checkpoints (``parts`` in _last_checkpoint) split the rows
        over ``<v>.checkpoint.<i>.<n>.parquet`` files — the union of all parts
        is the state (reference: CheckpointEntryIterator over every part)."""
        from .parquet import _pyarrow

        pq = _pyarrow("parquet")
        if parts:
            n = int(parts)
            paths = [os.path.join(
                log_dir, f"{version:020d}.checkpoint.{i:010d}.{n:010d}.parquet")
                for i in range(1, n + 1)]
        else:
            paths = [os.path.join(log_dir, f"{version:020d}.checkpoint.parquet")]
        rows = []
        for path in paths:
            rows.extend(pq.read_table(path).to_pylist())
        meta = None
        live: dict = {}
        for r in rows:
            md = r.get("metaData")
            if md and md.get("schemaString"):
                meta = md
            a = r.get("add")
            if a and a.get("path"):
                # partitionValues may arrive as a list of {key,value} structs
                pv = a.get("partitionValues")
                a = dict(a)
                if isinstance(pv, list):
                    a["partitionValues"] = {e["key"]: e["value"] for e in pv}
                a["path"] = unquote(a["path"])
                live[a["path"]] = a
        return meta, live

    @staticmethod
    def _stats_bounds(add: dict, data_fields) -> tuple:
        """File-level min/max from the add action's stats JSON, converted to
        the engine's raw value space (dates -> epoch days, decimals ->
        scaled ints)."""
        stats = add.get("stats")
        if not stats:
            return {}, {}
        try:
            st = json.loads(stats)
        except (TypeError, ValueError):
            return {}, {}
        types = {f.name: f.type for f in data_fields}

        def conv(c, v):
            ty = types.get(c)
            if ty is None or v is None or isinstance(v, bool):
                return None
            if ty.name == "date" and isinstance(v, str):
                try:
                    return _epoch_days(v)
                except ValueError:
                    return None
            if isinstance(ty, DecimalType) and isinstance(v, (int, float)):
                return round(float(v) * 10**ty.scale)
            if isinstance(v, (int, float)):
                return v
            return None

        lower = {c: cv for c, v in st.get("minValues", {}).items()
                 if (cv := conv(c, v)) is not None}
        upper = {c: cv for c, v in st.get("maxValues", {}).items()
                 if (cv := conv(c, v)) is not None}
        return lower, upper
