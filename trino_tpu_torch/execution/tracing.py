"""Tracing spans and per-statement counters (counterpart of
``trino_tpu/execution/tracing.py``, its span tree and what the server reads).

Spans record to an in-memory tracer; ``spans_to_otlp`` renders them as
OTLP-shaped JSON for ``GET /v1/query/{id}/trace`` and ``wall_breakdown``
decomposes a statement's wall into named buckets.  The span classes, the
export and the breakdown are the reference's.

``QueryCounters`` are the port's own counts at its device boundary: host
reads (each a synchronising device -> host copy), the bytes they move, the
bytes copied host -> device, and the launches of each hand-written kernel;
and the buffer pool's hits, misses and bytes saved per tier
(``record_page_cache``, ``record_build_cache``, ``record_result_cache``).
The engine opens one counter set per statement (``track_counters``) on the
statement's thread; the kernel wrappers charge their launches to the set
open on the thread that launches them (``record_launch``), so concurrent
statements on other threads never see each other's counts.

Attribution, as in the reference: the executor opens an ``operator_scope``
around each plan node it runs (innermost scope wins) and every kernel
launch and every host read charges that scope's sink (the executor's
per-operator ``boundary`` record) and the counter set's ``sites`` map under
``"<Op>#<k>/<site>"``.  A site's ``dispatches`` counts what
``device_dispatches`` counts, kernel launches plus host reads; its
``transfers`` and ``bytes`` the host reads and their bytes.  The per-operator
sums therefore equal the execution's totals.

The compile log (``CompileLog``, ``COMPILE_LOG``, ``record_compile``), the
in-flight registry (``INFLIGHT``) and the stall watchdog (``StallWatchdog``)
are the reference's, with two CUDA deviations:

- a compile is a **kernel build**: one record per ``csrc/*.cu`` library that
  ``ops/cuda_kernels.build_kernels`` compiles with ``nvcc`` or loads from its
  build cache (``cached``), its nvcc seconds as ``duration_s``, the library's
  bytes as ``exe_bytes`` and its ``source_digest`` as the signature, under
  the kernel wrapper whose launch triggered the build;
- a ``dispatch`` entry covers a kernel's **enqueue** only: launches are
  asynchronous, so a kernel that hangs shows at the next ``host_pull``
  entry (every host read synchronises).  ``DISPATCH_TEST_HOOK`` fires at
  both kinds of entry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Optional

__all__ = ["Span", "Tracer", "NOOP_TRACER", "QueryCounters", "track_counters",
           "record_launch", "record_host_read", "operator_scope", "record_page_cache",
           "record_build_cache", "record_result_cache", "DISPATCH_LATENCY", "LatencyHistogram",
           "LATENCY_BUCKETS_S", "activate_tracer", "current_tracer", "maybe_span",
           "span_dict", "spans_to_otlp", "query_scope", "current_query_id",
           "live_query_counters", "record_task_retry", "WALL_BUCKETS", "wall_breakdown",
           "format_wall_breakdown", "SPILL_TIERS", "SHARD_STATS_MAX", "shard_skew",
           "record_shard_stats", "record_coalesced", "record_graph",
           "COMPILE_BUCKETS_S", "CompileLog", "COMPILE_LOG", "record_compile",
           "arg_signature", "signature_summary",
           "InflightRegistry", "InflightEntry", "INFLIGHT", "inflight",
           "track_inflight", "current_inflight", "full_site_label",
           "StallWatchdog", "StallKilledError", "DISPATCH_TEST_HOOK"]

_log = logging.getLogger("trino_tpu_torch.stall")


# -- latency histogram ---------------------------------------------------------

LATENCY_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# kernel-build wall-time buckets: an nvcc build takes seconds, past the
# launch buckets' 10 s ceiling (the reference's compile scale)
COMPILE_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0, 120.0, 300.0)


class LatencyHistogram:
    """Fixed-bucket latency histogram (non-cumulative counts internally; the
    Prometheus exporter cumulates).  Thread-safe."""

    __slots__ = ("buckets", "counts", "total", "sum_s", "_lock")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.total = 0
        self.sum_s = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        i = 0
        for i, ub in enumerate(self.buckets):
            if seconds <= ub:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum_s += seconds

    def as_dict(self) -> dict:
        with self._lock:
            return {"buckets": list(self.counts), "count": self.total,
                    "sum_s": round(self.sum_s, 6)}


# -- per-statement device-boundary counters ------------------------------------

SPILL_TIERS = ("hbm", "host", "disk")  # the spill_tier_<t> counter fields
SHARD_STATS_MAX = 64  # shard records kept per counter set (newest win)


def _site_entry(sites: dict, key: str) -> dict:
    rec = sites.get(key)
    if rec is None:
        rec = sites[key] = {"dispatches": 0, "transfers": 0, "bytes": 0}
    return rec


@dataclasses.dataclass
class QueryCounters:
    """Host reads, their bytes, H2D bytes and kernel launches of one plan
    execution or statement (or, in ``Engine.counters_total``, of the engine's
    lifetime).  The reference's names read through the properties:
    ``device_dispatches`` counts kernel launches plus host reads,
    ``host_transfers`` the host reads, ``host_bytes_pulled`` their bytes.
    ``sites`` breaks them down per ``"<Op>#<k>/<site>"`` (a kernel's name or
    a host read's site tag under the operator scope that made it)."""

    host_reads: int = 0
    host_bytes: int = 0
    h2d_bytes: int = 0
    launches: dict = dataclasses.field(default_factory=dict)  # kernel -> count
    # the device buffer pool (execution/bufferpool).  A page hit served a
    # whole scan from device memory (no generation, one page instead of one
    # per split); a build hit checked a join's finished build out instead of
    # running its fragment and inserting its rows; bytes_saved is the served
    # entry's size.  A result hit answered the whole statement from a cached
    # result; result misses count only statements the tier would take.
    page_cache_hits: int = 0
    page_cache_misses: int = 0
    page_cache_bytes_saved: int = 0
    build_cache_hits: int = 0
    build_cache_misses: int = 0
    build_cache_bytes_saved: int = 0
    result_cache_hits: int = 0
    result_cache_misses: int = 0
    result_cache_bytes_saved: int = 0
    # plan templates (engine._template_cache): a hit answered the statement
    # through a cached parameterized plan, with no parse, analyze or plan; a
    # miss counts a template's creation.  batched_requests counts a request
    # served through a fused same-template batch, on the driver's counters
    # (which also carry the batch's device spend) and on each rider's
    # otherwise empty ones, so per-request counters sum to the totals.
    plan_template_hits: int = 0
    plan_template_misses: int = 0
    batched_requests: int = 0
    # adaptive execution (execution/adaptive.py): a replan means the
    # statement ran a plan the advisor corrected from its history; a hold
    # means a material misestimate existed and the advisor declined
    adaptive_replans: int = 0
    adaptive_holds: int = 0
    # kernel builds (record_compile): libraries built or loaded while this
    # set recorded, and their seconds.  A warm statement records none
    compiles: int = 0
    compile_s: float = 0.0
    # the chaos, spill-ladder and admission counters, read by the flight
    # record (pressure_rung) and system.runtime.query_log: fault firings
    # (record_fault), bytes spilled per tier (record_spill), a statement
    # deferred at the admission gate (stamped by the engine), and the
    # distributed path's per-exchange shard records (record_shard_stats).
    # task_retries counts the fault-tolerant executor's retries and the
    # cluster coordinator's re-dispatches (record_task_retry)
    faults_injected: int = 0
    task_retries: int = 0
    spilled_bytes: int = 0
    spill_tier_hbm: int = 0
    spill_tier_host: int = 0
    spill_tier_disk: int = 0
    admission_queued: int = 0
    # dispatch coalescing (exec/local_executor._coalesced_batches): splits
    # whose transform ran inside a stacked group of K shape-uniform pages
    # (record_coalesced counts a group's real splits)
    coalesced_splits: int = 0
    # the scan-fused whole-scan runners on the card: CUDA graphs captured
    # for a body (one per plan node, mode and shape; a warm statement
    # captures none) and their replays (one per split of a fused scan)
    graph_captures: int = 0
    graph_replays: int = 0
    shard_stats: list = dataclasses.field(default_factory=list)
    # "<Op>#<k>/<site>" -> {"dispatches", "transfers", "bytes"}, plus the
    # extras a site recorded (compiles, compile_s)
    sites: dict = dataclasses.field(default_factory=dict)

    _COUNT_FIELDS = ("page_cache_hits", "page_cache_misses", "page_cache_bytes_saved",
                     "build_cache_hits", "build_cache_misses", "build_cache_bytes_saved",
                     "result_cache_hits", "result_cache_misses",
                     "result_cache_bytes_saved", "plan_template_hits",
                     "plan_template_misses", "batched_requests", "adaptive_replans",
                     "adaptive_holds", "compiles", "compile_s", "faults_injected",
                     "task_retries", "spilled_bytes", "spill_tier_hbm", "spill_tier_host",
                     "spill_tier_disk", "admission_queued", "coalesced_splits",
                     "graph_captures", "graph_replays")

    @property
    def kernel_launches(self) -> int:
        return sum(self.launches.values())

    @property
    def device_dispatches(self) -> int:
        return self.kernel_launches + self.host_reads

    @property
    def host_transfers(self) -> int:
        return self.host_reads

    @property
    def host_bytes_pulled(self) -> int:
        return self.host_bytes

    def merge(self, other: "QueryCounters") -> None:
        self.host_reads += other.host_reads
        self.host_bytes += other.host_bytes
        self.h2d_bytes += other.h2d_bytes
        for k, v in list(other.launches.items()):
            self.launches[k] = self.launches.get(k, 0) + v
        for f in self._COUNT_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        if other.shard_stats:
            self.shard_stats.extend(dict(r) for r in other.shard_stats)
            del self.shard_stats[:-SHARD_STATS_MAX]
        for key, rec in list(other.sites.items()):
            mine = _site_entry(self.sites, key)
            for k, v in rec.items():
                mine[k] = mine.get(k, 0) + v

    def merge_dict(self, d: dict) -> None:
        """Fold an ``as_dict`` snapshot (the form a worker task's status
        carries over the wire) into this set, per-kernel launches included;
        the derived keys (device_dispatches, ...) are recomputed, not read."""
        if not d:
            return
        self.host_reads += int(d.get("host_reads", 0))
        self.host_bytes += int(d.get("host_bytes", 0))
        self.h2d_bytes += int(d.get("h2d_bytes", 0))
        for k, v in (d.get("launches") or {}).items():
            self.launches[str(k)] = self.launches.get(str(k), 0) + int(v)
        for f in self._COUNT_FIELDS:
            v = d.get(f, 0)
            setattr(self, f, getattr(self, f) + (float(v) if isinstance(v, float) else int(v)))
        for key, rec in (d.get("sites") or {}).items():
            mine = _site_entry(self.sites, str(key))
            for k, v in rec.items():
                # site extras may be floats (compile_s): keep them so
                mine[k] = mine.get(k, 0) + (float(v) if isinstance(v, float) else int(v))
        if d.get("shard_stats"):
            self.shard_stats.extend(dict(r) for r in d["shard_stats"])
            del self.shard_stats[:-SHARD_STATS_MAX]

    @classmethod
    def from_dict(cls, d: dict) -> "QueryCounters":
        out = cls()
        out.merge_dict(d)
        return out

    def snapshot(self) -> "QueryCounters":
        """An independent copy."""
        out = QueryCounters()
        out.merge(self)
        return out

    def as_dict(self) -> dict:
        d = {"host_reads": self.host_reads, "host_bytes": self.host_bytes,
             "h2d_bytes": self.h2d_bytes, "launches": dict(self.launches),
             "device_dispatches": self.device_dispatches,
             "host_transfers": self.host_transfers,
             "host_bytes_pulled": self.host_bytes_pulled,
             **{f: getattr(self, f) for f in self._COUNT_FIELDS},
             "sites": {k: dict(v) for k, v in list(self.sites.items())}}
        if self.shard_stats:
            d["shard_stats"] = [dict(r) for r in self.shard_stats]
        return d


_counter_local = threading.local()


def current_counters() -> Optional[QueryCounters]:
    """The counter set recording on this thread (None outside one)."""
    return getattr(_counter_local, "counters", None)

# qid -> [QueryCounters...] currently recording (counters-so-far of running
# statements), for system.queries
_live_lock = threading.Lock()
_live_counters: dict = {}


@contextlib.contextmanager
def track_counters(counters: QueryCounters):
    """Make ``counters`` the recording target for this thread; on exit the
    previous target (or None) is restored, so a plan executed inside a
    statement charges its own set, which the engine then folds into the
    statement's."""
    prev = getattr(_counter_local, "counters", None)
    _counter_local.counters = counters
    qid = getattr(_counter_local, "query_id", None)
    if qid is not None:
        with _live_lock:
            _live_counters.setdefault(qid, []).append(counters)
    try:
        yield counters
    finally:
        _counter_local.counters = prev
        if qid is not None:
            with _live_lock:
                lst = _live_counters.get(qid)
                if lst is not None:
                    try:
                        lst.remove(counters)
                    except ValueError:
                        pass
                    if not lst:
                        _live_counters.pop(qid, None)


# host wall time of each kernel launch's C entry, process-wide (the
# counterpart of the reference's dispatch-latency histogram)
DISPATCH_LATENCY = LatencyHistogram()


@contextlib.contextmanager
def operator_scope(label: str, sink: Optional[dict] = None):
    """Charge every launch and host read recorded on this thread to
    ``label`` until exit (innermost scope wins: a streaming chain charges
    the operator that drives it).  ``sink`` also accumulates
    {"dispatches", "transfers", "bytes"} in place: the executor's
    per-operator record that EXPLAIN ANALYZE prints."""
    prev = getattr(_counter_local, "op", None)
    _counter_local.op = (label, sink)
    try:
        yield sink
    finally:
        _counter_local.op = prev


def _attribute(site: str, dispatches: int = 0, transfers: int = 0, nbytes: int = 0,
               counters: Optional[QueryCounters] = None) -> None:
    """Charge one record to the open operator scope's sink and to the
    counter set's ``sites`` under "<op>/<site>"."""
    op = getattr(_counter_local, "op", None)
    if counters is not None:
        key = f"{op[0]}/{site}" if op is not None else site
        rec = _site_entry(counters.sites, key)
        rec["dispatches"] += dispatches
        rec["transfers"] += transfers
        rec["bytes"] += nbytes
    if op is not None and op[1] is not None:
        sink = op[1]
        sink["dispatches"] += dispatches
        sink["transfers"] += transfers
        sink["bytes"] += nbytes


def record_launch(kernel: str, seconds) -> None:
    """One launch of ``kernel`` whose C entry took ``seconds`` of host time,
    charged to the counter set open on this thread (none open: only the
    process-wide histogram records it) and to the open operator scope.
    ``seconds`` None: a launch inside a graph replay, not in the histogram."""
    if seconds is not None:
        DISPATCH_LATENCY.record(seconds)
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.launches[kernel] = c.launches.get(kernel, 0) + 1
    _attribute(kernel, dispatches=1, counters=c)


def record_host_read(nbytes: int, site: str) -> None:
    """One synchronising host read of ``nbytes`` at ``site``, attributed to
    the open operator scope and the counter set's ``sites``.  The totals
    (``host_reads``, ``host_bytes``) are the executor's own count, folded
    into the statement's counters when its plan finishes."""
    _attribute(site, dispatches=1, transfers=1, nbytes=nbytes,
               counters=getattr(_counter_local, "counters", None))


def record_page_cache(hits: int = 0, misses: int = 0, bytes_saved: int = 0) -> None:
    """One page-tier lookup, charged to the counter set open on this thread
    (the scan's page source resolves the cache on the query's thread)."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.page_cache_hits += hits
        c.page_cache_misses += misses
        c.page_cache_bytes_saved += bytes_saved


def record_build_cache(hits: int = 0, misses: int = 0, bytes_saved: int = 0) -> None:
    """One build-tier lookup."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.build_cache_hits += hits
        c.build_cache_misses += misses
        c.build_cache_bytes_saved += bytes_saved


def record_result_cache(hits: int = 0, misses: int = 0, bytes_saved: int = 0) -> None:
    """One result-tier outcome: a hit records on a counter set of its own,
    which the engine accounts as the statement's (a served statement never
    reaches an executor); a miss is stamped on the statement's counters
    after it ran."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.result_cache_hits += hits
        c.result_cache_misses += misses
        c.result_cache_bytes_saved += bytes_saved


def record_coalesced(n_splits: int) -> None:
    """One coalesced group of ``n_splits`` real splits, charged to the
    counter set open on this thread."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.coalesced_splits += n_splits


def record_graph(captures: int = 0, replays: int = 0) -> None:
    """Scan-fused graph captures and replays, charged to the counter set
    open on this thread."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.graph_captures += captures
        c.graph_replays += replays


def record_fault(site: Optional[str] = None) -> None:
    """One fault-injector firing (execution/faults), attributed like the
    cache events so EXPLAIN ANALYZE's site table names where it landed."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.faults_injected += 1
    _attribute_extra(site, faults_injected=1)


def record_task_retry(n: int = 1, site: Optional[str] = None) -> None:
    """A task retry or re-dispatch, charged to the query that paid for it
    (the fault-tolerant executor's retry loop, the cluster coordinator's
    reassignment)."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.task_retries += n
    _attribute_extra(site, task_retries=n)


def record_spill(tier: str, nbytes: int, site: Optional[str] = None) -> None:
    """One tiered-spill chunk admission (exec/spill): ``nbytes`` landed in
    ``tier`` (one of SPILL_TIERS), attributed to the operator that spilled.
    The admission gate's deferral has no helper: it happens before the
    statement's counters exist, so the engine stamps it on them."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.spilled_bytes += nbytes
        field = f"spill_tier_{tier}"
        setattr(c, field, getattr(c, field) + nbytes)
    _attribute_extra(site or f"spill.{tier}", spilled_bytes=nbytes)


# -- shard skew -----------------------------------------------------------------
#
# Per-shard attribution for the distributed path: a mesh run's wall is set
# by its slowest position, and the per-position load that decides it
# already crosses the host boundary (the receive cursors at
# dist.exchange.flags / dist.stream.flags, the live-group counts at
# dist.agg.overflow).  These helpers fold those host ints into
# QueryCounters.shard_stats records: no read, no launch of their own.


def shard_skew(per_worker) -> dict:
    """The skew core of a per-position load vector (host ints, never device
    tensors): max/mean ratio and the argmax position.  An empty or all-zero
    vector reads as balanced (1.0)."""
    vals = [int(v) for v in per_worker]
    n = len(vals)
    mx = max(vals) if vals else 0
    mean = (sum(vals) / n) if n else 0.0
    ratio = (mx / mean) if mean > 0 else 1.0
    worker = vals.index(mx) if vals else 0
    return {"workers": n, "rows": vals, "max": mx, "mean": mean,
            "ratio": ratio, "worker": worker}


def record_shard_stats(site: str, per_worker, wall_s: float = 0.0,
                       kind: str = "exchange", op: Optional[str] = None,
                       bytes_per_row: Optional[int] = None,
                       labels=None) -> Optional[dict]:
    """One blocking exchange's or shard consumer's per-position load, from
    counts the caller already read.  ``imbalance_s`` estimates the wall the
    skew cost: the span ran at the slowest position's pace, so a balanced
    run would take mean/max of it.  Returns the record, also appended to
    the counter set open on this thread (the newest SHARD_STATS_MAX kept)."""
    rec = shard_skew(per_worker)
    rec["site"] = site
    rec["kind"] = kind
    if op:
        rec["op"] = op
    rec["wall_s"] = float(wall_s)
    mx, mean = rec["max"], rec["mean"]
    rec["imbalance_s"] = ((mx - mean) / mx * float(wall_s)) if mx > 0 else 0.0
    if bytes_per_row:
        rec["bytes"] = [int(v) * int(bytes_per_row) for v in rec["rows"]]
    if labels:
        rec["labels"] = list(labels)
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.shard_stats.append(dict(rec))
        del c.shard_stats[:-SHARD_STATS_MAX]
    return rec


def live_query_counters() -> dict:
    """query_id -> merged counters (``as_dict`` form) of every counter set
    currently recording for that query.  Poll-grade: the owning threads keep
    counting while this reads."""
    with _live_lock:
        items = {q: list(v) for q, v in _live_counters.items()}
    out = {}
    for qid, lst in items.items():
        merged = QueryCounters()
        try:
            for c in lst:
                merged.merge(c)
        except RuntimeError:  # a launches dict grew mid-copy: skip this pass
            continue
        out[qid] = merged.as_dict()
    return out


@contextlib.contextmanager
def query_scope(query_id: str):
    """Tag this thread's counter sets with the executing query id."""
    prev = getattr(_counter_local, "query_id", None)
    _counter_local.query_id = query_id
    try:
        yield
    finally:
        _counter_local.query_id = prev


def current_query_id() -> Optional[str]:
    return getattr(_counter_local, "query_id", None)


def full_site_label(site: str) -> str:
    """The "<Op>#<k>/<site>" form of a bare site tag, as the in-flight
    registry and the compile log label it (bare outside an operator scope)."""
    op = getattr(_counter_local, "op", None)
    return f"{op[0]}/{site}" if op is not None else site


def _attribute_extra(site: Optional[str], **extras) -> None:
    """Charge extras (a build's compiles and seconds) to the open operator
    scope's sink and the counter set's site record, beside its boundary
    counts."""
    c = getattr(_counter_local, "counters", None)
    op = getattr(_counter_local, "op", None)
    tag = site or "untagged"
    if c is not None:
        rec = _site_entry(c.sites, f"{op[0]}/{tag}" if op is not None else tag)
        for k, v in extras.items():
            rec[k] = rec.get(k, 0) + v
    if op is not None and op[1] is not None:
        for k, v in extras.items():
            op[1][k] = op[1].get(k, 0) + v


# -- the compile log: kernel builds --------------------------------------------
#
# The reference logs every XLA compilation at its _jit chokepoint.  The port
# compiles no plans: what it compiles is its CUDA libraries, once a process
# (or loads them from the build cache).  ops/cuda_kernels.build_kernels
# records one entry per library here, charged to the statement whose launch
# triggered the build: per-query counters and "<op>/<site>" attribution, a
# "compile" span for the wall breakdown, and the process-global CompileLog
# behind system.runtime.compilations, GET /v1/compiles and /v1/metrics.


def _flatten(x, leaves: list):
    """Structure of nested tuples, lists and dicts, with the leaves appended
    to ``leaves`` (the role of jax's pytree flattening in the reference)."""
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(sorted(x, key=repr))
        return ("dict", keys, tuple(_flatten(x[k], leaves) for k in keys))
    leaves.append(x)
    return "*"


def arg_signature(args, kw=None):
    """Hashable key of a call's abstract argument signature: the nesting
    structure plus each leaf's shape and dtype (tensors, arrays) or value
    (hashable scalars).  Host-side only, never reads array contents, and
    builds no strings (``signature_summary`` renders it)."""
    leaves: list = []
    try:
        tree = _flatten((args, kw or {}), leaves)
    except Exception:  # noqa: BLE001
        return ("opaque",)
    key: list = []
    for x in leaves:
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            key.append(("a", tuple(shape), str(dtype)))
        elif isinstance(x, (bool, int, float, str, bytes, type(None))):
            key.append(("v", x))
        else:
            # an opaque static: its hash when hashable, else its type name
            # (a coarser key only under-reports, never fabricates)
            try:
                key.append(("h", type(x).__name__, hash(x)))
            except TypeError:
                key.append(("t", type(x).__name__))
    return (tree, tuple(key))


def signature_summary(sig_key) -> str:
    """Printable form of an ``arg_signature`` key ("torch.int64[2097152],
    4, ..."), rendered only where a record is made."""
    if not isinstance(sig_key, tuple) or len(sig_key) != 2:
        return "opaque"
    parts: list = []
    leaves = sig_key[1]
    for leaf in leaves[:12]:
        if leaf[0] == "a":
            parts.append(f"{leaf[2]}[{','.join(map(str, leaf[1]))}]")
        elif leaf[0] == "v":
            parts.append(repr(leaf[1])[:24])
        else:
            parts.append(leaf[1])
    if len(leaves) > 12:
        parts.append(f"... {len(leaves) - 12} more")
    return ", ".join(parts) or "()"


def record_compile(seconds: float, site: Optional[str] = None,
                   signature: Optional[str] = None,
                   sig_key: Optional[str] = None,
                   exe_bytes: Optional[int] = None,
                   wrapper: Optional[int] = None, **extra) -> None:
    """One kernel build: per-query counters and site attribution, a
    "compile" span, and a CompileLog record (``extra`` rides the record:
    the library and whether the build cache served it).  Host-side
    bookkeeping only."""
    c = getattr(_counter_local, "counters", None)
    if c is not None:
        c.compiles += 1
        c.compile_s += seconds
    _attribute_extra(site, compiles=1, compile_s=round(seconds, 6))
    tr = current_tracer()
    if tr is not None and seconds > 0:
        tr.add_completed("compile", seconds, site=site or "")
    COMPILE_LOG.record(site=site or "build", label=full_site_label(site or "build"),
                       query_id=getattr(_counter_local, "query_id", None),
                       signature=signature, sig_key=sig_key, duration_s=seconds,
                       exe_bytes=exe_bytes, wrapper=wrapper, extra=extra)


DEFAULT_COMPILE_LOG_RECORDS = 512
DEFAULT_STORM_SIGNATURES = 8


def _env_int(name: str, default: int) -> int:
    import os

    try:
        v = os.environ.get(name, "")
        return int(v) if v != "" else default
    except ValueError:
        return default


class CompileLog:
    """Process-global bounded ring of per-build records (the reference's
    compile census): {site, label ("<Op>#<k>/<site>"), query_id, signature,
    duration_s, exe_bytes, at}, plus the port's ``library`` and ``cached``.
    ``TRINO_TPU_COMPILE_LOG`` caps retained records (default 512; 0 keeps
    none, the lifetime totals still count).

    Storm detection, as in the reference: one stream (``wrapper``) building
    more than ``TRINO_TPU_COMPILE_STORM_SIGS`` (default 8) distinct
    signatures within one statement logs one warning naming the site.  The
    key is (label, wrapper, query_id), FIFO-bounded at ``_MAX_SIG_ENTRIES``.
    ``record`` never raises."""

    _MAX_SIG_ENTRIES = 4096

    def __init__(self, max_records: Optional[int] = None,
                 storm_sigs: Optional[int] = None):
        from collections import deque

        self.max_records = max_records if max_records is not None \
            else _env_int("TRINO_TPU_COMPILE_LOG", DEFAULT_COMPILE_LOG_RECORDS)
        self.storm_sigs = storm_sigs if storm_sigs is not None \
            else _env_int("TRINO_TPU_COMPILE_STORM_SIGS", DEFAULT_STORM_SIGNATURES)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=max(self.max_records, 1))
        self.compiles_total = 0
        self.compile_s_total = 0.0
        self.storms_total = 0
        self.latency = LatencyHistogram(buckets=COMPILE_BUCKETS_S)
        self._sigs: dict = {}  # (label, wrapper, query_id) -> signatures seen
        self._stormed: set = set()

    @property
    def enabled(self) -> bool:
        return self.max_records > 0

    def record(self, site: str, label: str, query_id: Optional[str],
               signature: Optional[str], duration_s: float,
               sig_key: Optional[str] = None, exe_bytes: Optional[int] = None,
               wrapper: Optional[int] = None, extra: Optional[dict] = None
               ) -> Optional[dict]:
        storm_label = None
        try:
            rec = {"site": site, "label": label, "query_id": query_id,
                   "signature": signature, "duration_s": round(duration_s, 6),
                   "exe_bytes": exe_bytes, "at": time.time(), **(extra or {})}
            skey = (label, wrapper, query_id)
            with self._lock:
                self.compiles_total += 1
                self.compile_s_total += duration_s
                if self.enabled:
                    self._records.append(rec)
                sigs = self._sigs.setdefault(skey, set())
                sigs.add(sig_key if sig_key is not None else signature)
                if len(sigs) > self.storm_sigs and skey not in self._stormed:
                    self._stormed.add(skey)
                    self.storms_total += 1
                    storm_label = (label, len(sigs))
                while len(self._sigs) > self._MAX_SIG_ENTRIES:
                    old = next(iter(self._sigs))
                    del self._sigs[old]
                    self._stormed.discard(old)
            self.latency.record(duration_s)
        except Exception:  # noqa: BLE001 - a census failure never fails a launch
            return None
        if storm_label is not None:
            _log.warning("recompile storm: site %s has compiled %d distinct argument "
                         "signatures — shape churn is defeating executable reuse "
                         "(quantize the operator's shapes or check split uniformity)",
                         storm_label[0], storm_label[1])
        return rec

    def for_query(self, query_id: str) -> list:
        """Retained records of one query id, oldest first (the flight
        record's ``compile_events``)."""
        with self._lock:
            return [dict(r) for r in self._records if r.get("query_id") == query_id]

    def snapshot(self, limit: Optional[int] = None) -> list:
        with self._lock:
            recs = [dict(r) for r in self._records]
        return recs[-limit:] if limit else recs

    def info(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "records": len(self._records),
                    "compiles_total": self.compiles_total,
                    "compile_s_total": round(self.compile_s_total, 6),
                    "storms_total": self.storms_total,
                    "storm_threshold_sigs": self.storm_sigs,
                    "stormed_labels": sorted({k[0] for k in self._stormed})}

    def clear(self) -> None:
        """Test hook: drop retained records and storm state (the lifetime
        totals keep counting)."""
        with self._lock:
            self._records.clear()
            self._sigs.clear()
            self._stormed.clear()


COMPILE_LOG = CompileLog()


# -- the in-flight registry ----------------------------------------------------
#
# What the engine is doing right now: every kernel launch (kind "dispatch",
# its enqueue), every host read ("host_pull", where a wedged card shows, as
# each read synchronises), split generation and scan-cache stores hold an
# entry while they run.  The stall watchdog samples it; /v1/status shows it.

# Test hook: when set, called as hook(label) inside every dispatch and
# host_pull entry before the work runs (the deliberately slowed operation
# the watchdog tests use).  Never set in production.
DISPATCH_TEST_HOOK = None


@dataclasses.dataclass
class InflightEntry:
    token: int
    kind: str  # dispatch | host_pull | split-generation | cache-store
    site: str
    op: Optional[str]
    label: str  # "<Op>#<k>/<site>", the key shape of QueryCounters.sites
    query_id: Optional[str]
    thread_id: int
    thread_name: str
    start_monotonic: float
    # this launch triggered the kernel build: the watchdog judges it against
    # TRINO_TPU_STALL_COMPILE_S and verdicts "compiling", not "stalled"
    compiling: bool = False

    def as_dict(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        return {"kind": self.kind, "site": self.site, "op": self.op,
                "label": self.label, "query_id": self.query_id,
                "thread_id": self.thread_id, "thread_name": self.thread_name,
                "compiling": self.compiling,
                "elapsed_s": round(now - self.start_monotonic, 4)}


class InflightRegistry:
    """Live entries for work inside a device-boundary chokepoint: one lock
    and one dict operation on entry and on exit, no launch, no read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._next = 1

    def enter(self, kind: str, site: Optional[str] = None,
              compiling: bool = False) -> int:
        op = getattr(_counter_local, "op", None)
        tag = site or "untagged"
        label = f"{op[0]}/{tag}" if op is not None else tag
        t = threading.current_thread()
        with self._lock:
            tok = self._next
            self._next += 1
            self._entries[tok] = InflightEntry(
                tok, kind, tag, op[0] if op is not None else None, label,
                getattr(_counter_local, "query_id", None), t.ident, t.name,
                time.monotonic(), compiling)
        return tok

    def exit(self, token: int) -> None:
        with self._lock:
            self._entries.pop(token, None)

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self, now: Optional[float] = None) -> list:
        now = time.monotonic() if now is None else now
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.start_monotonic)
        return [e.as_dict(now) for e in entries]

    def stalled(self, threshold_s: float, now: Optional[float] = None) -> list:
        """Entries older than ``threshold_s`` (InflightEntry objects)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return [e for e in self._entries.values()
                    if now - e.start_monotonic >= threshold_s]


INFLIGHT = InflightRegistry()


def current_inflight() -> InflightRegistry:
    """The thread's registry: the process-global INFLIGHT unless a scope
    installed its own."""
    return getattr(_counter_local, "inflight", None) or INFLIGHT


@contextlib.contextmanager
def track_inflight(registry: InflightRegistry):
    """Route this thread's in-flight entries to ``registry``."""
    prev = getattr(_counter_local, "inflight", None)
    _counter_local.inflight = registry
    try:
        yield registry
    finally:
        _counter_local.inflight = prev


@contextlib.contextmanager
def inflight(kind: str, site: Optional[str] = None):
    """One in-flight entry around an operation that may wedge (split
    generation, cache stores; launches and host reads inline the calls)."""
    reg = current_inflight()
    tok = reg.enter(kind, site)
    try:
        yield
    finally:
        reg.exit(tok)


# -- the stall watchdog --------------------------------------------------------

# one sampling watchdog per registry: a second engine armed by
# TRINO_TPU_STALL_S in the same process skips sampling instead of racing
# the first over the global INFLIGHT (its verdicts stay live)
_ARMED_LOCK = threading.Lock()
_ARMED_WATCHDOGS: dict = {}  # id(registry) -> owning watchdog


class StallKilledError(RuntimeError):
    """Raised asynchronously in a thread whose in-flight entry exceeded
    TRINO_TPU_STALL_KILL_S.  It is delivered when the interpreter resumes:
    a thread blocked in one C call (a synchronising read of a hung kernel)
    dies when that call returns."""


def _env_seconds(name: str) -> Optional[float]:
    import os

    try:
        v = float(os.environ.get(name, "") or 0)
    except ValueError:
        return None
    return v if v > 0 else None


class StallWatchdog:
    """Samples an InflightRegistry for entries older than ``stall_s``
    (TRINO_TPU_STALL_S; unset or 0: disabled, no thread) and emits a
    structured report: the stuck "<Op>#<k>/<site>" labels, their elapsed
    seconds, each stuck thread's stack (``sys._current_frames()``) and what
    ``extra_info`` adds (the memory pools).  ``kill_s``
    (TRINO_TPU_STALL_KILL_S) optionally aborts the stuck thread with an
    asynchronous StallKilledError.  ``clock`` is injectable and
    ``check(now=...)`` runs one pass synchronously (fake-clock tests).

    An entry flagged ``compiling`` (the launch that triggered the kernel
    build) is judged against ``compile_stall_s`` (TRINO_TPU_STALL_COMPILE_S,
    default 10x stall_s): under it the verdict is "compiling", with no
    report; past it, stalled like any other."""

    def __init__(self, registry: Optional[InflightRegistry] = None,
                 stall_s: Optional[float] = None, kill_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 compile_stall_s: Optional[float] = None,
                 on_stall=None, clock=None, extra_info=None):
        self.registry = registry if registry is not None else INFLIGHT
        self.stall_s = stall_s if stall_s is not None \
            else _env_seconds("TRINO_TPU_STALL_S")
        self.kill_s = kill_s if kill_s is not None \
            else _env_seconds("TRINO_TPU_STALL_KILL_S")
        self.compile_stall_s = compile_stall_s if compile_stall_s is not None \
            else _env_seconds("TRINO_TPU_STALL_COMPILE_S")
        if self.compile_stall_s is None and self.stall_s:
            self.compile_stall_s = 10.0 * self.stall_s
        self.poll_s = poll_s if poll_s is not None else (
            min(max(self.stall_s / 4, 0.05), 1.0) if self.stall_s else 1.0)
        self.on_stall = on_stall
        self.clock = clock or time.monotonic
        self.extra_info = extra_info
        self.last_report: Optional[dict] = None
        self.stalled_now = 0  # gauge: entries over threshold at the last check
        self.compiling_now = 0  # gauge: tolerated builds at the last check
        self.reports = 0  # passes that found stalls
        self.kills = 0
        self._killed: set = set()  # entry tokens already killed
        self._last_labels: tuple = ()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def enabled(self) -> bool:
        return bool(self.stall_s)

    def classify(self, now: Optional[float] = None):
        """(stalled_entries, compiling_entries), live from the registry."""
        if not self.enabled:
            return [], []
        now = self.clock() if now is None else now
        compile_s = self.compile_stall_s or self.stall_s
        stalled, compiling = [], []
        for e in self.registry.stalled(self.stall_s, now):
            if e.compiling and now - e.start_monotonic < compile_s:
                compiling.append(e)
            else:
                stalled.append(e)
        return stalled, compiling

    def status(self, now: Optional[float] = None):
        """("ok"|"compiling"|"stalled", stalled_n, compiling_n), recomputed
        live from the registry: the one place the verdict is derived."""
        stalled, compiling = self.classify(now)
        st = "stalled" if stalled else ("compiling" if compiling else "ok")
        return st, len(stalled), len(compiling)

    def verdict(self, now: Optional[float] = None):
        """(verdict, count of the entries behind it)."""
        st, stalled_n, compiling_n = self.status(now)
        return st, (stalled_n if st == "stalled"
                    else compiling_n if st == "compiling" else 0)

    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """One sampling pass: returns (and keeps) the report when an entry
        is stalled, else None."""
        if not self.enabled:
            return None
        now = self.clock() if now is None else now
        stalled, compiling = self.classify(now)
        self.stalled_now = len(stalled)
        self.compiling_now = len(compiling)
        if not stalled:
            self._last_labels = ()
            return None
        report = self._build_report(stalled, now)
        report["compiling"] = self.compiling_now
        self.last_report = report
        self.reports += 1
        labels = tuple(sorted(e.label for e in stalled))
        if labels != self._last_labels:  # log on change, not every poll
            self._last_labels = labels
            _log.warning("stall watchdog: %d in-flight entr%s over %.1fs: %s",
                         len(stalled), "y" if len(stalled) == 1 else "ies",
                         self.stall_s, ", ".join(labels))
        if self.on_stall is not None:
            try:
                self.on_stall(report)
            except Exception:  # noqa: BLE001 - a report hook never kills the watchdog
                pass
        if self.kill_s:
            for e in stalled:
                if now - e.start_monotonic >= self.kill_s and e.token not in self._killed:
                    self._killed.add(e.token)
                    self._async_kill(e)
        return report

    def _build_report(self, stalled, now: float) -> dict:
        import sys
        import traceback

        frames = sys._current_frames()
        entries = []
        for e in sorted(stalled, key=lambda x: x.start_monotonic):
            f = frames.get(e.thread_id)
            d = e.as_dict(now)
            d["stack"] = "".join(traceback.format_stack(f)) if f is not None else None
            entries.append(d)
        report = {"detected_at_s": time.time(), "threshold_s": self.stall_s,
                  "stalled": entries, "inflight_depth": self.registry.depth()}
        if self.extra_info is not None:
            try:
                report.update(self.extra_info() or {})
            except Exception:  # noqa: BLE001
                pass
        return report

    def _async_kill(self, entry: InflightEntry) -> None:
        import ctypes

        self.kills += 1
        _log.error("stall watchdog: hard-aborting thread %s (%s, wedged past %.1fs "
                   "kill threshold)", entry.thread_name, entry.label, self.kill_s)
        try:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(entry.thread_id), ctypes.py_object(StallKilledError))
        except Exception:  # noqa: BLE001
            pass

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        with _ARMED_LOCK:
            owner = _ARMED_WATCHDOGS.get(id(self.registry))
            if owner is not None and owner is not self:
                _log.warning("stall watchdog: registry already sampled by another "
                             "watchdog in this process; skipping (one armed Engine "
                             "per process samples the global registry)")
                return
            _ARMED_WATCHDOGS[id(self.registry)] = self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="stall-watchdog",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - a watchdog crash never takes the engine
                pass

    def stop(self) -> None:
        with _ARMED_LOCK:
            if _ARMED_WATCHDOGS.get(id(self.registry)) is self:
                del _ARMED_WATCHDOGS[id(self.registry)]
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


# -- spans ---------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    start_s: float
    end_s: Optional[float] = None
    attributes: dict = dataclasses.field(default_factory=dict)
    status: str = "OK"

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.end_s is None else self.end_s - self.start_s


class Tracer:
    def __init__(self, max_finished: int = 10_000):
        self._lock = threading.Lock()
        self._next_id = 1
        self.max_finished = max_finished
        self.finished: list[Span] = []
        self._local = threading.local()

    def _current(self) -> Optional[Span]:
        return getattr(self._local, "span", None)

    def current(self) -> Optional[Span]:
        """The span active on THIS thread."""
        return self._current()

    def _new_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def _finish(self, s: Span) -> None:
        with self._lock:
            self.finished.append(s)
            if len(self.finished) > self.max_finished:
                del self.finished[:len(self.finished) - self.max_finished]

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", parent: Optional[Span] = None,
             **attributes):
        """Open a child span of ``parent`` (explicit, for cross-thread
        parenting) or of this thread's current span."""
        if parent is None:
            parent = self._current()
        s = Span(name=name,
                 trace_id=trace_id or (parent.trace_id if parent else ""),
                 span_id=self._new_id(),
                 parent_id=parent.span_id if parent else None,
                 start_s=time.time(), attributes=dict(attributes))
        prev = self._current()
        self._local.span = s
        try:
            yield s
        except BaseException as e:
            s.status = f"ERROR: {type(e).__name__}"
            raise
        finally:
            s.end_s = time.time()
            self._local.span = prev
            self._finish(s)

    def add_completed(self, name: str, duration_s: float,
                      parent: Optional[Span] = None, **attributes) -> Span:
        """Record an interval already measured as a finished span ending now."""
        if parent is None:
            parent = self._current()
        end = time.time()
        s = Span(name=name, trace_id=parent.trace_id if parent else "",
                 span_id=self._new_id(), parent_id=parent.span_id if parent else None,
                 start_s=end - duration_s, end_s=end, attributes=dict(attributes))
        self._finish(s)
        return s

    def spans_for(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self.finished if s.trace_id == trace_id]


class _NoopTracer(Tracer):
    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", parent: Optional[Span] = None,
             **attributes):
        yield Span(name, trace_id, 0, None, time.time())

    def add_completed(self, name, duration_s, parent=None, **attributes):
        return Span(name, "", 0, None, time.time())


NOOP_TRACER = _NoopTracer()


def current_tracer() -> Optional[Tracer]:
    return getattr(_counter_local, "tracer", None)


@contextlib.contextmanager
def activate_tracer(tracer: Tracer):
    prev = getattr(_counter_local, "tracer", None)
    _counter_local.tracer = tracer
    try:
        yield tracer
    finally:
        _counter_local.tracer = prev


@contextlib.contextmanager
def maybe_span(name: str, parent: Optional[Span] = None, **attributes):
    """Child span via the thread's active tracer, or a no-op span when none is
    active."""
    tr = current_tracer()
    if tr is None:
        yield Span(name, "", 0, None, time.time())
        return
    with tr.span(name, parent=parent, **attributes) as s:
        yield s


# -- export --------------------------------------------------------------------
def span_dict(s: Span) -> dict:
    """JSON-ready span summary (``Engine.last_query_trace``)."""
    return {"name": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
            "parent_id": s.parent_id, "start_s": s.start_s, "end_s": s.end_s,
            "duration_s": s.duration_s, "attributes": dict(s.attributes),
            "status": s.status}


def _otlp_value(v):
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def spans_to_otlp(spans, service: str = "trino_tpu") -> dict:
    """OTLP/JSON-shaped trace payload (opentelemetry-proto trace/v1 field
    names) from Span objects or span_dict dicts."""
    import hashlib

    out = []
    for s in spans:
        d = s if isinstance(s, dict) else span_dict(s)
        trace_hex = hashlib.md5(
            str(d.get("trace_id", "")).encode()).hexdigest()
        end_s = d.get("end_s") or d.get("start_s", 0.0)
        out.append({
            "traceId": trace_hex,
            "spanId": f"{int(d.get('span_id', 0)):016x}",
            "parentSpanId": ("" if d.get("parent_id") is None
                             else f"{int(d['parent_id']):016x}"),
            "name": d.get("name", ""),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(d.get("start_s", 0.0) * 1e9)),
            "endTimeUnixNano": str(int(end_s * 1e9)),
            "attributes": [{"key": k, "value": _otlp_value(v)}
                           for k, v in (d.get("attributes") or {}).items()],
            "status": ({"code": 1} if d.get("status", "OK") == "OK"
                       else {"code": 2, "message": str(d.get("status"))}),
        })
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": service}}]},
        "scopeSpans": [{"scope": {"name": "trino_tpu.execution.tracing"},
                        "spans": out}],
    }]}


# -- wall-clock decomposition --------------------------------------------------
#
# ``wall_breakdown`` attributes the query root span's window to named buckets
# from the finished span tree: each leaf span maps to a bucket and a sweep
# over the elementary time slices charges every covered slice to ONE bucket
# (the highest in _BUCKET_PRIORITY), so the buckets are disjoint and sum, with
# the admission queue and the unattributed remainder, to the reported wall.
# The port opens the "planner" span, and a "compile" span for each kernel
# build; the other buckets stay zero until spans that feed them are opened.

WALL_BUCKETS = ("plan", "compile", "admission_queue", "split_generation",
                "h2d", "device_dispatch", "host_pull", "exchange_wait",
                "retry_backoff", "unattributed")

_SPAN_BUCKETS = {
    "planner": "plan",
    "compile": "compile",
    "dispatch": "device_dispatch",
    "host_pull": "host_pull",
    "split-generation": "split_generation",
    "prefetch": "h2d",
    "h2d": "h2d",
    "exchange.read": "exchange_wait",
    "exchange.stream": "exchange_wait",
    "exchange.write": "exchange_wait",
    "exchange.route": "exchange_wait",
    "exchange.merge": "exchange_wait",
}

_BUCKET_PRIORITY = ("compile", "device_dispatch", "host_pull",
                    "exchange_wait", "split_generation", "plan", "h2d")


def wall_breakdown(spans, window=None, queued_s: float = 0.0,
                   retry_backoff_s: float = 0.0) -> Optional[dict]:
    """Decompose a query's wall clock into WALL_BUCKETS seconds.

    ``spans``: Span objects or span_dict dicts.  ``window``: explicit
    (start_s, end_s) wall window; default = the root "query" span.
    ``queued_s`` is measured outside the window and adds to the reported
    wall; ``retry_backoff_s`` happens inside it and is carved out of the
    unattributed remainder.  None when no closed window can be
    established."""
    dicts = [s if isinstance(s, dict) else span_dict(s) for s in spans]
    if window is None:
        root = next((s for s in dicts
                     if s.get("parent_id") is None
                     and s.get("name") == "query"), None)
        if root is None or root.get("end_s") is None:
            return None
        window = (root["start_s"], root["end_s"])
    lo, hi = window
    wall = max(float(hi) - float(lo), 0.0)
    intervals = []
    for s in dicts:
        bucket = _SPAN_BUCKETS.get(s.get("name"))
        if bucket is None or s.get("end_s") is None \
                or s.get("start_s") is None:
            continue
        a = max(float(s["start_s"]), lo)
        z = min(float(s["end_s"]), hi)
        if z > a:
            intervals.append((a, z, bucket))
    buckets = {b: 0.0 for b in WALL_BUCKETS}
    rank = {b: i for i, b in enumerate(_BUCKET_PRIORITY)}
    events: list = []
    for a, z, b in intervals:
        events.append((a, 1, b))
        events.append((z, -1, b))
    events.sort(key=lambda ev: ev[0])
    active = [0] * len(_BUCKET_PRIORITY)
    prev = None
    i, n = 0, len(events)
    while i < n:
        t = events[i][0]
        if prev is not None and t > prev:
            for j, b in enumerate(_BUCKET_PRIORITY):
                if active[j]:
                    buckets[b] += t - prev
                    break
        while i < n and events[i][0] == t:
            active[rank[events[i][2]]] += events[i][1]
            i += 1
        prev = t
    attributed = sum(buckets.values())
    buckets["admission_queue"] = max(float(queued_s or 0.0), 0.0)
    remainder = max(wall - attributed, 0.0)
    buckets["retry_backoff"] = min(max(float(retry_backoff_s or 0.0), 0.0),
                                   remainder)
    buckets["unattributed"] = remainder - buckets["retry_backoff"]
    out = {b: round(v, 6) for b, v in buckets.items()}
    out["wall_s"] = round(wall + buckets["admission_queue"], 6)
    return out


def format_wall_breakdown(bd: dict) -> str:
    """One-line render for EXPLAIN ANALYZE: non-zero buckets in declaration
    order, milliseconds, total last."""
    parts = [f"{b} {bd.get(b, 0.0) * 1000:.1f}ms"
             for b in WALL_BUCKETS if bd.get(b, 0.0) > 0.0005]
    if not parts:
        parts = ["unattributed 0.0ms"]
    return ("Wall breakdown: " + ", ".join(parts)
            + f" (total {bd.get('wall_s', 0.0) * 1000:.1f}ms)")
