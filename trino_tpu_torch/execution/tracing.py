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

Not ported yet: the reference's XLA compile log (here it would be a log of
kernel builds), its in-flight registry and the stall watchdog.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

__all__ = ["Span", "Tracer", "NOOP_TRACER", "QueryCounters", "track_counters",
           "record_launch", "record_host_read", "operator_scope", "record_page_cache",
           "record_build_cache", "record_result_cache", "DISPATCH_LATENCY", "LatencyHistogram",
           "LATENCY_BUCKETS_S", "activate_tracer", "current_tracer", "maybe_span",
           "span_dict", "spans_to_otlp", "query_scope", "current_query_id",
           "live_query_counters", "WALL_BUCKETS", "wall_breakdown",
           "format_wall_breakdown"]


# -- latency histogram ---------------------------------------------------------

LATENCY_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


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
    # "<Op>#<k>/<site>" -> {"dispatches", "transfers", "bytes"}
    sites: dict = dataclasses.field(default_factory=dict)

    _COUNT_FIELDS = ("page_cache_hits", "page_cache_misses", "page_cache_bytes_saved",
                     "build_cache_hits", "build_cache_misses", "build_cache_bytes_saved",
                     "result_cache_hits", "result_cache_misses",
                     "result_cache_bytes_saved", "plan_template_hits",
                     "plan_template_misses", "batched_requests", "adaptive_replans",
                     "adaptive_holds")

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
        for key, rec in list(other.sites.items()):
            mine = _site_entry(self.sites, key)
            for k, v in rec.items():
                mine[k] = mine.get(k, 0) + v

    def as_dict(self) -> dict:
        return {"host_reads": self.host_reads, "host_bytes": self.host_bytes,
                "h2d_bytes": self.h2d_bytes, "launches": dict(self.launches),
                "device_dispatches": self.device_dispatches,
                "host_transfers": self.host_transfers,
                "host_bytes_pulled": self.host_bytes_pulled,
                **{f: getattr(self, f) for f in self._COUNT_FIELDS},
                "sites": {k: dict(v) for k, v in list(self.sites.items())}}


_counter_local = threading.local()

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


def record_launch(kernel: str, seconds: float) -> None:
    """One launch of ``kernel`` whose C entry took ``seconds`` of host time,
    charged to the counter set open on this thread (none open: only the
    process-wide histogram records it) and to the open operator scope."""
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

    def spans_for(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self.finished if s.trace_id == trace_id]


class _NoopTracer(Tracer):
    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", parent: Optional[Span] = None,
             **attributes):
        yield Span(name, trace_id, 0, None, time.time())


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
# The port opens the "planner" span; the other buckets stay zero until spans
# that feed them are opened.

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
