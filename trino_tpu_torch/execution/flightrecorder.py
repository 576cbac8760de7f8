"""Query flight recorder (counterpart of ``trino_tpu/execution/flightrecorder.py``):
durable per-statement execution records.

One JSON record per COMPLETED or ERRORED statement: the normalized SQL, the
counters with their per-site map, the finished span tree, the wall-clock
breakdown, the plan-actuals payload, the adaptive decision, the fused batch
size, the admission wait and the statement's kernel builds
(``compiles`` / ``compile_s`` and the ``compile_events`` of the engine's
compile log), plus event records for stall reports.  The engine appends them
after the statement, from what it already holds on the host, under the same
guard as the cache stores: a recorder failure never fails the statement, and
the record adds no host read, no H2D copy and no kernel launch.

Two tiers, as in the reference:

- an in-memory ring (``TRINO_TPU_FLIGHT_RECORDS`` entries, default 256; 0
  turns the recorder off) serving ``GET /v1/flight/{id}``,
  ``system.runtime.query_log`` and the completed-statement trace lookup;
- an optional on-disk JSONL ring (``TRINO_TPU_FLIGHT_DIR``, byte budget
  ``TRINO_TPU_FLIGHT_BYTES``, default 64 MB; no directory: memory only):
  append-only segment files, the oldest deleted while the directory exceeds
  the budget.  ``read_flight_dir`` reads a dead process's directory; a
  record torn by the process dying mid-write is skipped.

Standard library only (numpy, when present, for scalar encoding).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional

__all__ = ["FlightRecorder", "read_flight_dir", "pressure_rung",
           "summarize_compiles", "summarize_skew"]

DEFAULT_MAX_RECORDS = 256
DEFAULT_DISK_BUDGET = 64 << 20
_SEGMENT_FRACTION = 8  # rotate the active segment at budget/8


def _env_int(name: str, default: int) -> int:
    try:
        v = os.environ.get(name, "")
        return int(v) if v != "" else default
    except ValueError:
        return default


def pressure_rung(counters: Optional[dict]) -> Optional[str]:
    """The deepest memory-pressure-ladder rung this query's own counters
    show it reached: disk spill > host spill > device spill > admission
    queue; None when the query never felt pressure.  Derived, never
    fabricated: a kill surfaces as the query's typed error."""
    c = counters or {}
    if c.get("spill_tier_disk"):
        return "spill-disk"
    if c.get("spill_tier_host"):
        return "spill-host"
    if c.get("spill_tier_hbm"):
        return "spill-hbm"
    if c.get("admission_queued"):
        return "admission-queue"
    return None


def summarize_compiles(rec: Optional[dict]):
    """(count, seconds) of the kernel builds attributed to one statement
    record: the top-level fields when the engine stamped them, else the
    counters snapshot ((0, 0.0) for neither, never None)."""
    r = rec or {}
    c = r.get("counters") or {}
    n = r.get("compiles")
    if n is None:
        n = c.get("compiles")
    s = r.get("compile_s")
    if s is None:
        s = c.get("compile_s")
    return int(n or 0), float(s or 0.0)


def summarize_skew(rec: Optional[dict]):
    """(worst_ratio, imbalance_s, n_records) of the per-shard attribution in
    one statement record: the top-level ``shard_stats`` when the engine
    stamped it, else the counters snapshot; (None, 0.0, 0) for a statement
    that crossed no exchange (every statement of the one-device port)."""
    r = rec or {}
    stats = r.get("shard_stats")
    if stats is None:
        stats = (r.get("counters") or {}).get("shard_stats")
    stats = stats or []
    worst = None
    imb = 0.0
    for s in stats:
        ratio = float(s.get("ratio") or 1.0)
        if worst is None or ratio > worst:
            worst = ratio
        imb += float(s.get("imbalance_s") or 0.0)
    return worst, imb, len(stats)


def read_flight_dir(path: str) -> list:
    """Records from a flight directory, oldest first; works on a dead
    process's directory.  Unparseable lines (a record torn by the process
    dying mid-write) are skipped."""
    out: list = []
    try:
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("flight-") and n.endswith(".jsonl"))
    except OSError:
        return out
    for name in names:
        try:
            with open(os.path.join(path, name), "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail of a dead process
        except OSError:
            continue
    # several recorders may share one directory: name order interleaves
    # instances, recording time is the one global order (a stable sort keeps
    # each file's append order for ties)
    out.sort(key=lambda r: r.get("recorded_at") or 0.0)
    return out


class FlightRecorder:
    """Bounded ring of per-statement flight records (+ stall/pressure event
    records), in-memory always, mirrored to an on-disk JSONL ring when
    ``TRINO_TPU_FLIGHT_DIR`` is set.  Every mutation is guarded: ``record``
    never raises (failures count on ``failures`` and surface as a metrics
    counter, exactly like guarded cache stores)."""

    def __init__(self, flight_dir: Optional[str] = None,
                 disk_budget: Optional[int] = None,
                 max_records: Optional[int] = None):
        self.flight_dir = flight_dir if flight_dir is not None \
            else (os.environ.get("TRINO_TPU_FLIGHT_DIR") or None)
        self.disk_budget = disk_budget if disk_budget is not None \
            else _env_int("TRINO_TPU_FLIGHT_BYTES", DEFAULT_DISK_BUDGET)
        self.max_records = max_records if max_records is not None \
            else _env_int("TRINO_TPU_FLIGHT_RECORDS", DEFAULT_MAX_RECORDS)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=max(self.max_records, 1))
        self._seq = 0
        # lifetime counters (the /v1/metrics recorder series)
        self.records_total = 0
        self.failures = 0
        self.disk_evictions = 0
        self.spans_total = 0
        self.worker_spans_total = 0
        self._segment: Optional[str] = None  # active segment file path
        self._segment_bytes = 0
        # per-instance segment namespace: several recorders may share one
        # TRINO_TPU_FLIGHT_DIR, and identical names would let one instance's
        # eviction delete another's active segment
        self._instance = f"{os.getpid():08x}{uuid.uuid4().hex[:6]}"

    @property
    def enabled(self) -> bool:
        return self.max_records > 0

    # -- write path ------------------------------------------------------------
    def record_query(self, rec: dict) -> Optional[dict]:
        """Append one statement record (kind defaults to "query").  Returns
        the stamped record, or None when disabled/failed — the caller never
        sees an exception (guard discipline)."""
        return self._append(dict(rec, kind=rec.get("kind", "query")))

    def record_event(self, rec: dict) -> Optional[dict]:
        """Append a non-statement event (stall report, pressure rung)."""
        return self._append(dict(rec, kind=rec.get("kind", "event")))

    def _append(self, rec: dict) -> Optional[dict]:
        if not self.enabled:
            return None
        try:
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                rec.setdefault("recorded_at", time.time())
                self._records.append(rec)
                self.records_total += 1
                spans = ((rec.get("trace") or {}).get("spans")
                         if isinstance(rec.get("trace"), dict) else None)
                if spans:
                    self.spans_total += len(spans)
                # stitched worker-span count: the cluster coordinator stamps
                # it on the record (how many harvested spans joined the tree)
                self.worker_spans_total += int(rec.get("worker_spans") or 0)
                if self.flight_dir:
                    self._write_disk(rec)
            return rec
        except Exception:
            # a recorder failure (full disk, unserializable value) must never
            # fail the statement it records
            with self._lock:
                self.failures += 1
            return None

    def _write_disk(self, rec: dict) -> None:
        """One JSONL line into the active segment; rotate at budget/8 and
        drop oldest segments while the directory exceeds the budget.  Caller
        holds the lock."""
        os.makedirs(self.flight_dir, exist_ok=True)
        line = (json.dumps(rec, default=_json_default) + "\n").encode()
        seg_target = max(self.disk_budget // _SEGMENT_FRACTION, 1)
        if self._segment is None or self._segment_bytes >= seg_target:
            self._segment = os.path.join(
                self.flight_dir,
                f"flight-{self._instance}-{self._seq:08d}.jsonl")
            self._segment_bytes = 0
        with open(self._segment, "ab") as f:
            f.write(line)
        self._segment_bytes += len(line)
        self._evict_disk()

    def _evict_disk(self) -> None:
        names = [n for n in os.listdir(self.flight_dir)
                 if n.startswith("flight-") and n.endswith(".jsonl")]
        sizes, mtimes = {}, {}
        for n in names:
            p = os.path.join(self.flight_dir, n)
            try:
                st = os.stat(p)
                sizes[n], mtimes[n] = st.st_size, st.st_mtime
            except OSError:
                sizes[n], mtimes[n] = 0, 0.0
        # oldest-WRITTEN first: with several instances sharing the dir, name
        # order interleaves their sequences — mtime is the shared clock, and
        # another instance's active segment (just written) sorts newest
        segs = sorted(names, key=lambda n: (mtimes[n], n))
        total = sum(sizes.values())
        # never delete the active segment: the newest record must survive
        # even when one record alone exceeds a tiny budget
        active = os.path.basename(self._segment) if self._segment else None
        for n in segs:
            if total <= self.disk_budget or n == active:
                break
            try:
                os.remove(os.path.join(self.flight_dir, n))
                self.disk_evictions += 1
            except OSError:
                pass
            total -= sizes[n]

    # -- read surfaces ---------------------------------------------------------
    def get(self, query_id: str) -> Optional[dict]:
        """Most recent record for ``query_id`` (statement records only)."""
        with self._lock:
            for rec in reversed(self._records):
                if rec.get("query_id") == query_id \
                        and rec.get("kind") == "query":
                    return rec
        return None

    def snapshot(self, limit: Optional[int] = None, kind: Optional[str] = None
                 ) -> list:
        """Records oldest-first; ``kind`` filters ("query"/"stall"/...)."""
        with self._lock:
            recs = list(self._records)
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs[-limit:] if limit else recs

    def disk_bytes(self) -> int:
        if not self.flight_dir:
            return 0
        total = 0
        try:
            for n in os.listdir(self.flight_dir):
                if n.startswith("flight-") and n.endswith(".jsonl"):
                    try:
                        total += os.path.getsize(
                            os.path.join(self.flight_dir, n))
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    def info(self) -> dict:
        with self._lock:
            n = len(self._records)
        return {"enabled": self.enabled, "records": n,
                "records_total": self.records_total,
                "failures": self.failures,
                "disk_evictions": self.disk_evictions,
                "spans_total": self.spans_total,
                "worker_spans_total": self.worker_spans_total,
                "dir": self.flight_dir,
                "disk_budget": self.disk_budget if self.flight_dir else 0,
                "disk_bytes": self.disk_bytes()}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


def _json_default(v):
    """JSON fallback for numpy scalars / stray objects inside counters or
    span attributes — a record must serialize, not raise."""
    try:
        import numpy as np

        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.bool_):
            return bool(v)
    except Exception:
        pass
    return str(v)
