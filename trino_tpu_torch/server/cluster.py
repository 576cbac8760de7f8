"""Multi-process control plane: a coordinator and worker processes over HTTP
(counterpart of ``trino_tpu/server/cluster.py``).

Reference architecture: worker announcements (CoordinatorNodeManager.java:56),
fragment dispatch (HttpRemoteTask.java:137,743: the fragment ships once per
worker, split batches address it), the task REST surface (TaskResource.java:
142,229), heartbeat failure detection (HeartbeatFailureDetector.java:77, here
a consecutive-miss threshold), and the spooled filesystem exchange shared with
the fault-tolerant executor (``exec/fte.py``): workers commit their outputs
first-commit-wins and the coordinator merges.  Nested single-task fragments
stream worker to worker through in-memory output buffers instead (long-poll
reads with token acknowledgement, a broadcast buffer for a split fan-out).

One worker process runs one executor pool on one device.  ``WorkerServer``
takes its device explicitly: ``device=None`` (and ``main`` without
``--device``) means the card and raises without one, ``"cpu"`` the CPU; a
worker never drops to the CPU on its own.  Several workers may share one
card: each takes its memory pool and page cache sizes as arguments
(``pool_bytes``, ``cache_bytes``; None sizes them as the engine does, from
the card's free memory), so co-located workers each claim a share.

A fragment ships pickled (the reference's trusted internal channel: every
POST body carries an HMAC of the cluster secret, checked before unpickling).
The coordinator refuses to ship a fragment that holds a tensor: a device
array in a plan would either fail to unpickle in the worker or move through
host memory unseen.  Workers run the task bodies of ``exec/fte.py`` on their
own ``LocalExecutor``, under a counter set and a task span that ride the
task status back; the coordinator merges them into the query's
``last_query_counters`` (per-kernel launches included) and one stitched
trace.  Start a worker with
``python -m trino_tpu_torch.server.cluster --catalogs JSON --spool DIR
--coordinator URL [--device cpu] [--pool-bytes N] [--cache-bytes N]``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import io
import itertools
import json
import os as _os
import pickle
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ..exec.fte import (FaultTolerantExecutor, SpoolingExchange, counted,
                        is_retryable_failure, merge_partial_outputs, read_fragment_outputs,
                        run_fragment, run_partial_aggregate, run_stream_splits,
                        serialize_fragment_output)
from ..exec.local_executor import LocalExecutor
from ..execution import faults, tracing
from ..execution.faults import InjectedFaultError
from ..execution.tracing import InflightRegistry, QueryCounters, StallWatchdog, Tracer
from ..sql import plan as P
from ..sql.ir import device_constants

__all__ = ["WorkerServer", "ClusterCoordinator", "build_catalogs", "stream_task_pages"]

_cluster_qids = itertools.count(1)  # coordinator query and trace ids (cluster_N)


def build_catalogs(config: dict, device) -> dict:
    """Connectors from a declarative config, each generating on ``device``
    (the analog of the catalog properties files the CatalogManager loads)."""
    from ..connectors.tpcds import TpcdsConnector
    from ..connectors.tpch import TpchConnector

    factories = {"tpch": TpchConnector, "tpcds": TpcdsConnector}
    out = {}
    for name, spec in config.items():
        kwargs = {k: v for k, v in spec.items() if k != "connector"}
        out[name] = factories[spec["connector"]](device=device, **kwargs)
    return out


def _http(url: str, data: Optional[bytes] = None, timeout: float = 10.0,
          secret: Optional[str] = None) -> bytes:
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    if secret and data is not None:
        req.add_header("X-Trino-Internal-Signature", _sign(secret, data))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _sign(secret: str, body: bytes) -> str:
    return hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()


def _backoff_s(key: str, attempt: int, base: float = 0.25, cap: float = 5.0) -> float:
    """Exponential backoff with deterministic jitter: ``base * 2^(attempt-1)``
    times a factor in [1.0, 1.5) hashed from (key, attempt), at most ``cap``.
    Two coordinators retrying one task space it alike and a chaos run
    repeats, while distinct tasks still spread out.  The exponent is clamped:
    a worker that never comes back keeps adding heartbeat misses, and an
    unclamped power would overflow the float."""
    d = base * (2 ** min(max(attempt - 1, 0), 30))
    h = int.from_bytes(hashlib.blake2b(f"{key}:{attempt}".encode(), digest_size=8).digest(),
                       "big")
    return min(d * (1.0 + 0.5 * (h / 2.0 ** 64)), cap)


_LOOPBACK = ("127.0.0.1", "localhost", "::1")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128  # the standard library's 5 delays bursts of connects


class _NoTensorPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError(f"a shipped fragment holds a tensor ({tuple(obj.shape)}, "
                            f"{obj.dtype}, {obj.device}): plans ship host values only")
        return NotImplemented


def _dumps_fragment(obj) -> bytes:
    """Pickle a fragment request, refusing any tensor it reaches."""
    buf = io.BytesIO()
    _NoTensorPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _http_stream_get(url: str, secret: Optional[str], timeout: float = 10.0):
    """GET signed on its path (a streamed page read has no body) -> (body,
    headers)."""
    req = urllib.request.Request(url, method="GET")
    if secret:
        path = urllib.parse.urlsplit(url).path
        req.add_header("X-Trino-Internal-Signature", _sign(secret, path.encode()))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), dict(r.headers)


class _OutputBuffer:
    """A task's in-memory output with long-poll reads and per-reader token
    acknowledgement (reference: PartitionedOutputBuffer.java and the
    TaskResource long poll, TaskResource.java:331-383): a GET of token T by
    reader R acknowledges every page below T for R and waits for page T.  A
    page frees once every reader that is not abandoned acknowledged it; with
    ``n_readers`` > 1 it is the broadcast buffer a split fan-out reads
    (BroadcastOutputBuffer.java).  ``add`` blocks while the unacknowledged
    pages pass ``max_bytes`` (OutputBuffer.isFull)."""

    def __init__(self, max_bytes: int = 64 << 20, n_readers: int = 1):
        self.pages: dict = {}  # index -> envelope
        self.next_index = 0
        self.bytes = 0
        self.max_bytes = max_bytes
        self.done = False
        self.failed: Optional[str] = None
        self.n_readers = n_readers
        self.acked = [0] * n_readers  # per reader: pages below are free
        self.completed = [False] * n_readers  # the reader saw the end
        self.abandoned = [False] * n_readers  # the reader is gone
        self.cv = threading.Condition()

    def _free_acked(self) -> None:
        """Drop every page all live readers acknowledged (under cv)."""
        floors = [a for a, gone in zip(self.acked, self.abandoned) if not gone]
        floor = min(floors) if floors else self.next_index
        for i in [i for i in self.pages if i < floor]:
            self.bytes -= len(self.pages.pop(i))

    def add(self, data: bytes, stall_timeout: float = 120.0) -> None:
        """Blocks while the buffer is full; a consumer that vanished would
        pin the producer (and its slot) for ever, so after ``stall_timeout``
        without an acknowledgement the buffer fails and the producer ends."""
        deadline = time.time() + stall_timeout
        with self.cv:
            while self.bytes > 0 and self.bytes + len(data) > self.max_bytes \
                    and not self.failed:
                if time.time() > deadline:
                    self.failed = f"consumer stalled: no acknowledgement for {stall_timeout:.0f}s"
                    self.cv.notify_all()
                    break
                self.cv.wait(0.05)
            if self.failed:
                raise RuntimeError(f"output buffer failed: {self.failed}")
            self.pages[self.next_index] = data
            self.next_index += 1
            self.bytes += len(data)
            self.cv.notify_all()

    def finish(self) -> None:
        with self.cv:
            self.done = True
            self.cv.notify_all()

    def fail(self, error: str) -> None:
        with self.cv:
            self.failed = error
            self.cv.notify_all()

    def abandon(self, reader: int) -> None:
        """A reader died and retries against a fresh producer: stop keeping
        pages for it."""
        with self.cv:
            if 0 <= reader < self.n_readers:
                self.abandoned[reader] = True
                self._free_acked()
                self.cv.notify_all()

    @property
    def fully_delivered(self) -> bool:
        return all(c or a for c, a in zip(self.completed, self.abandoned))

    def get(self, token: int, max_wait: float = 1.0, reader: int = 0):
        """(page or None, complete, failed): acknowledge the pages below
        ``token`` for ``reader``, then wait up to ``max_wait`` for page
        ``token``."""
        deadline = time.time() + max_wait
        with self.cv:
            if not 0 <= reader < self.n_readers:
                return None, False, f"unknown reader {reader}"
            self.acked[reader] = max(self.acked[reader], token)
            self._free_acked()
            self.cv.notify_all()  # an acknowledgement may unblock the producer
            while True:
                if self.failed:
                    return None, False, self.failed
                if token in self.pages:
                    return self.pages[token], False, None
                if self.done and token >= self.next_index:
                    self.completed[reader] = True
                    self.cv.notify_all()
                    return None, True, None
                left = deadline - time.time()
                if left <= 0:
                    return None, False, None  # the client polls again
                self.cv.wait(left)


def stream_task_pages(url: str, task_id: str, secret: Optional[str] = None,
                      timeout: float = 60.0, reader: int = 0):
    """The client half of the streaming exchange (HttpPageBufferClient.java:
    100): long-poll a producer's buffer, yielding envelopes; each new token
    acknowledges the pages before it for this reader."""
    token = 0
    deadline = time.time() + timeout
    while True:
        try:
            body, headers = _http_stream_get(
                f"{url}/v1/task/{task_id}/results/{reader}/{token}", secret)
        except urllib.error.HTTPError as he:
            if he.code == 404 and time.time() < deadline:
                # dispatched, but its thread has not registered the buffer yet
                time.sleep(0.1)
                continue
            raise
        if headers.get("X-Trino-Buffer-Failed"):
            raise RuntimeError(f"stream source {task_id} failed: "
                               f"{headers.get('X-Trino-Buffer-Failed')}")
        if headers.get("X-Trino-Buffer-Complete") == "1":
            return
        if headers.get("X-Trino-Has-Page") == "1":
            token += 1
            deadline = time.time() + timeout
            yield body
        elif time.time() > deadline:
            raise TimeoutError(f"stream source {task_id} produced nothing for {timeout:.0f}s")


class _WorkerBusy(Exception):
    """Task admission refused: the queue is full, or the pool is blocked."""


class _WorkerDraining(Exception):
    """Task admission refused: graceful shutdown in progress."""


# ---------------------------------------------------------------------------- worker
@dataclasses.dataclass
class _TaskState:
    state: str = "running"  # running | done | failed
    error: Optional[str] = None
    retryable: bool = True  # False: a deterministic failure, not re-dispatched
    # set before the output commits, so a coordinator that sees the commit
    # reads them: the task's counters (QueryCounters.as_dict), its finished
    # span tree, and its fragment-relative plan actuals
    counters: Optional[dict] = None
    spans: Optional[list] = None
    plan_stats: Optional[dict] = None


def _span_subtree(tracer, trace_id: str, root_span_id: int) -> list:
    """The finished spans of ``trace_id`` under ``root_span_id`` (included),
    in start order: a task ships its own subtree though its siblings on the
    worker share the query's trace id."""
    children: dict = {}
    by_id: dict = {}
    for s in tracer.spans_for(trace_id):
        by_id[s.span_id] = s
        children.setdefault(s.parent_id, []).append(s)
    out, stack, seen = [], [root_span_id], set()
    while stack:
        sid = stack.pop()
        if sid in seen:
            continue
        seen.add(sid)
        s = by_id.get(sid)
        if s is not None:
            out.append(s)
        stack.extend(c.span_id for c in children.get(sid, ()))
    out.sort(key=lambda s: s.start_s)
    return out


def _subtree_ids(node) -> list:
    out: list = []

    def walk(n):
        out.append(id(n))
        for c in n.children:
            walk(c)

    walk(node)
    return out


class WorkerServer:
    """A worker: runs dispatched fragments on its own executors and spools
    their outputs to the shared exchange directory (or streams them)."""

    def __init__(self, catalogs_config: dict, spool_dir: str, host: str = "127.0.0.1",
                 port: int = 0, coordinator_url: Optional[str] = None,
                 node_id: str = "worker", announce_interval: float = 0.5,
                 secret: Optional[str] = None, stall_s: Optional[float] = None,
                 device=None, pool_bytes: Optional[int] = None,
                 cache_bytes: Optional[int] = None):
        from ..engine import _resolve_device
        from ..execution.bufferpool import DeviceBufferPool
        from ..execution.fair_scheduler import FairScheduler
        from ..memory import MemoryPool

        # the fragment request is pickled, so the task endpoints authenticate
        # (internal-communication.shared-secret); without a secret the
        # worker listens on loopback only
        self.secret = secret if secret is not None \
            else _os.environ.get("TRINO_TPU_CLUSTER_SECRET")
        if self.secret is None and host not in _LOOPBACK:
            raise ValueError(f"refusing to serve unauthenticated task endpoints on {host}: "
                             "set TRINO_TPU_CLUSTER_SECRET (or pass secret=) to bind "
                             "beyond loopback")
        self.device = _resolve_device(device)
        self.catalogs = build_catalogs(catalogs_config, self.device)
        # one node pool shared by every pooled executor (MemoryPool.java is
        # per node), and the node's own page and build cache: each node
        # caches what it scans
        self.memory_pool = MemoryPool(device=self.device, max_bytes=pool_bytes)
        self.buffer_pool = DeviceBufferPool(budget_bytes=cache_bytes, device=self.device)
        self.local = self._new_executor()
        # each task runs under a root span on the worker's tracer, whose
        # finished tree rides the task status back
        self.tracer = Tracer()
        # the worker's own in-flight registry and stall watchdog: the
        # verdict rides /v1/info and the announces, so a wedged worker whose
        # HTTP thread still answers reads "stalled" to the coordinator
        self.inflight = InflightRegistry()
        self.last_stall_report: Optional[dict] = None
        self.stall_watchdog = StallWatchdog(
            registry=self.inflight, stall_s=stall_s, on_stall=self._on_stall,
            extra_info=lambda: {"memory": [self.memory_pool.info()]})
        self.spool_dir = spool_dir
        self.host, self.port = host, port
        self.node_id = node_id
        self.coordinator_url = coordinator_url
        self.announce_interval = announce_interval
        # a fragment ships once per query; tasks name it.  Both registries
        # are bounded: a long-lived worker serves unbounded queries
        self.fragments: OrderedDict = OrderedDict()  # fragment id -> plan
        self.tasks: OrderedDict = OrderedDict()  # task id -> _TaskState
        self.max_fragments = 32
        self.max_task_states = 256
        self._wlock = threading.Lock()
        # the executor pool: each running task checks one out (overrides are
        # one query's state); the fair scheduler's slots gate them
        self.max_exec_concurrency = int(_os.environ.get("TRINO_TPU_WORKER_EXEC_SLOTS", "2"))
        self.scheduler = FairScheduler(self.max_exec_concurrency)
        self._executor_pool: list = [self.local]
        self._all_executors: list = [self.local]
        self._running_frags: dict = {}  # fragment id -> running tasks
        self._running_queries: dict = {}  # exchange dir -> running tasks
        self._running_tasks = 0
        self._executing = 0  # tasks holding an executor
        self.peak_concurrency = 0
        self.out_buffers: dict = {}  # task id -> _OutputBuffer (bounded)
        self.max_out_buffers = 16
        # admission: past this queue depth, or with the pool past
        # memory_admission_fraction, a task is refused (429) and the
        # coordinator offers it again
        self.max_concurrent_tasks = 8
        self.memory_admission_fraction = 0.9
        self.admission_denials = 0
        self.cache_sheds = 0  # buffer-pool evictions the pressure forced
        self.stream_bytes_served = 0  # envelope bytes read from the output buffers
        self._draining = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._stop = threading.Event()

    def _new_executor(self) -> LocalExecutor:
        return LocalExecutor(self.catalogs, self.device, memory_pool=self.memory_pool,
                             buffer_pool=self.buffer_pool)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> str:
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _path_signed(self) -> bool:
                if worker.secret is None:
                    return True
                got = self.headers.get("X-Trino-Internal-Signature", "")
                return hmac.compare_digest(got, _sign(worker.secret, self.path.encode()))

            def do_GET(self):
                if self.path == "/v1/info":
                    return self._reply(200, worker.info())
                if self.path == "/v1/kernels":
                    # this process's kernel wrappers: launches and launch
                    # shapes since the process started (or the last reset)
                    from ..ops import cuda_kernels as ck

                    return self._reply(200, {k: {"launches": st.launches,
                                                 "shapes": [list(x) for x in st.shapes]}
                                             for k, st in ck.STATS.items()})
                if "/results/" in self.path and self.path.startswith("/v1/task/"):
                    # /v1/task/{tid}/results/{reader}/{token}: page data is
                    # cluster-internal, so the path is signed
                    if not self._path_signed():
                        return self._reply(403, {"error": "bad signature"})
                    parts = self.path.split("/")
                    tid = parts[3]
                    reader, token = (int(parts[5]), int(parts[6])) if len(parts) >= 7 \
                        else (0, int(parts[5]))
                    buf = worker.out_buffers.get(tid)
                    if buf is None:
                        return self._reply(404, {"error": "no such buffer"})
                    page, complete, failed = buf.get(token, max_wait=1.0, reader=reader)
                    body = page or b""
                    with worker._wlock:
                        worker.stream_bytes_served += len(body)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Trino-Has-Page", "1" if page is not None else "0")
                    self.send_header("X-Trino-Buffer-Complete", "1" if complete else "0")
                    if failed:
                        self.send_header("X-Trino-Buffer-Failed",
                                         failed.splitlines()[0][:200])
                    self.end_headers()
                    self.wfile.write(body)
                    if complete and buf.fully_delivered:
                        worker.out_buffers.pop(tid, None)
                    return
                if self.path.startswith("/v1/task/"):
                    st = worker.tasks.get(self.path.rsplit("/", 1)[-1])
                    if st is None:
                        return self._reply(404, {"error": "no such task"})
                    return self._reply(200, {"state": st.state, "error": st.error,
                                             "retryable": st.retryable,
                                             "counters": st.counters, "spans": st.spans,
                                             "plan_stats": st.plan_stats})
                self._reply(404, {"error": "not found"})

            def _read_verified(self):
                """The body, its HMAC checked BEFORE unpickling (unpickling an
                unauthenticated body runs arbitrary code)."""
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if worker.secret is not None:
                    got = self.headers.get("X-Trino-Internal-Signature", "")
                    if not hmac.compare_digest(got, _sign(worker.secret, body)):
                        return None
                return pickle.loads(body)

            def do_POST(self):
                if self.path.startswith("/v1/task/") and self.path.endswith("/abandon"):
                    # /v1/task/{tid}/results/{reader}/abandon: a consumer died
                    # and retries against a fresh producer
                    if not self._path_signed():
                        return self._reply(403, {"error": "bad signature"})
                    parts = self.path.split("/")
                    buf = worker.out_buffers.get(parts[3])
                    if buf is not None:
                        buf.abandon(int(parts[5]))
                        if buf.fully_delivered:
                            worker.out_buffers.pop(parts[3], None)
                    return self._reply(200, {"ok": True})
                if self.path not in ("/v1/fragment", "/v1/task", "/v1/shutdown",
                                     "/v1/kill_query", "/v1/evict_cache"):
                    return self._reply(404, {"error": "not found"})
                req = self._read_verified()
                if req is None:
                    return self._reply(403, {"error": "bad signature"})
                if self.path == "/v1/fragment":
                    worker._register_fragment(req["fragment_id"], req["plan"])
                    return self._reply(200, {"ok": True})
                if self.path == "/v1/task":
                    try:
                        worker._start_task(req)
                    except KeyError:
                        return self._reply(409, {"error": "unknown fragment"})
                    except _WorkerDraining:
                        return self._reply(503, {"error": "shutting down"})
                    except _WorkerBusy:
                        return self._reply(429, {"error": "task queue full"})
                    return self._reply(200, {"accepted": req["task_id"]})
                if self.path == "/v1/shutdown":
                    worker.shutdown_gracefully()
                    return self._reply(200, {"state": "shutting_down"})
                if self.path == "/v1/kill_query":
                    # the cluster's low-memory policy chose a victim: poison
                    # it node-wide (ClusterMemoryManager -> killQuery)
                    worker.memory_pool.kill_query(req["query_key"])
                    return self._reply(200, {"killed": req["query_key"]})
                # /v1/evict_cache, the coordinator's rung before a kill: the
                # cache is droppable, a query is not
                freed = worker.buffer_pool.evict_bytes(1 << 62)
                if freed:
                    worker.cache_sheds += 1
                return self._reply(200, {"freed_bytes": freed})

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        self.stall_watchdog.start()  # no thread unless a threshold is set
        if self.coordinator_url:
            threading.Thread(target=self._announce_loop, daemon=True).start()
        return self.url

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._stop.set()
        self.stall_watchdog.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    def info(self) -> dict:
        """What /v1/info serves: state, pool, scheduler, and the health
        verdict; the stall report ships only while stalled (the coordinator
        keeps the last one it saw)."""
        pool = self.memory_pool
        health = self._health()
        return {"node_id": self.node_id,
                "state": "shutting_down" if self._draining else "active",
                "device": str(self.device), "peak_concurrency": self.peak_concurrency,
                "mem_reserved": pool.reserved, "mem_max": pool.max_bytes,
                "mem_by_query": pool.by_query(), "scheduler": self.scheduler.info(),
                "admission_denials": self.admission_denials,
                "cache_sheds": self.cache_sheds,
                "stream_bytes_served": self.stream_bytes_served, **health,
                "stall_report": self.last_stall_report
                if health["health"] == "stalled" else None}

    def _on_stall(self, report: dict) -> None:
        self.last_stall_report = report

    def _health(self) -> dict:
        """The node's verdict, live per request: "stalled" when an in-flight
        entry on this worker's registry is past the watchdog's threshold,
        "compiling" when every such entry is a kernel build (the coordinator
        degrades only a stalled worker)."""
        verdict, stalled_n, compiling_n = self.stall_watchdog.status()
        return {"health": verdict, "stalled": stalled_n, "compiling": compiling_n,
                "inflight": self.inflight.depth()}

    def _announce_loop(self):
        while not self._stop.is_set():
            try:
                _http(f"{self.coordinator_url}/v1/announce",
                      json.dumps({"node_id": self.node_id, "url": self.url,
                                  "state": "shutting_down" if self._draining else "active",
                                  "mem_reserved": self.memory_pool.reserved,
                                  "mem_max": self.memory_pool.max_bytes,
                                  **self._health()}).encode(),
                      secret=self.secret)
            except Exception:  # noqa: BLE001 - the coordinator is not up yet
                pass
            self._stop.wait(self.announce_interval)

    # -- task execution ----------------------------------------------------------
    def _checkout_executor(self, query_key: str = "q", token: str = ""):
        """A task's own executor, after the fair scheduler grants its slot
        (the task yields the slot at split boundaries through ``tick``; its
        executor stays with it)."""
        self.scheduler.acquire(query_key, token)
        with self._wlock:
            if self._executor_pool:
                return self._executor_pool.pop()
            ex = self._new_executor()
            self._all_executors.append(ex)
            return ex

    def _release_executor(self, ex, token: str = "") -> None:
        with self._wlock:
            self._executor_pool.append(ex)
        self.scheduler.release(token)

    def _register_fragment(self, frag_id: str, plan) -> None:
        with self._wlock:
            if frag_id in self.fragments:
                return
            self.fragments[frag_id] = plan
            evictable = [f for f in self.fragments if not self._running_frags.get(f)]
            while len(self.fragments) > self.max_fragments and evictable:
                old_id = evictable.pop(0)
                if old_id == frag_id:
                    continue
                old = self.fragments.pop(old_id)
                for ex in self._all_executors:
                    ex.forget_plan(old)

    def _collect_task_plan_stats(self, node, ex) -> Optional[dict]:
        """The task's fragment-relative plan actuals (node paths anchored at
        the fragment root; the coordinator re-anchors them).  Best effort: a
        failure loses history, never the task."""
        try:
            from ..execution.history import collect_plan_actuals

            return collect_plan_actuals(node, ex.stats, boundary=ex.boundary,
                                        catalogs=self.catalogs, paths=ex._node_paths,
                                        ests=ex._node_ests) or None
        except Exception:  # noqa: BLE001 - advisory
            return None

    def _start_task(self, req: dict):
        tid = str(req["task_id"])
        frag_id = req["fragment_id"]
        with self._wlock:
            # under the lock the drain reads _running_tasks with: no task
            # slips in after it saw zero
            if self._draining:
                raise _WorkerDraining()
            node = self.fragments.get(frag_id)
            if node is None:
                raise KeyError(frag_id)
            if self._running_tasks >= self.max_concurrent_tasks:
                raise _WorkerBusy()
            # the node half of the memory ladder: shed this node's cache
            # first, then refuse (the coordinator offers the task elsewhere)
            if self.memory_pool.blocked(self.memory_admission_fraction):
                if self.buffer_pool.evict_bytes(1 << 62):
                    self.cache_sheds += 1
                self.admission_denials += 1
                raise _WorkerBusy()
            self._running_tasks += 1
            self.tasks[tid] = st = _TaskState()
            self._running_frags[frag_id] = self._running_frags.get(frag_id, 0) + 1
            # only terminal states are pruned: an evicted running entry would
            # read as lost to the coordinator and burn a retry
            done = [t for t, s in self.tasks.items() if s.state != "running"]
            while len(self.tasks) > self.max_task_states and done:
                self.tasks.pop(done.pop(0), None)
        threading.Thread(target=self._run_task, args=(req, tid, frag_id, node, st),
                         daemon=True).start()

    def _stream_fetcher(self, sources):
        if not sources:
            return None

        def fetch(t):
            # a plain url (reader 0 of task t) or {"url", "task", "reader"}:
            # the broadcast and replay form
            v = sources[t]
            if isinstance(v, str):
                return stream_task_pages(v, t, secret=self.secret)
            return stream_task_pages(v["url"], v.get("task", t), secret=self.secret,
                                     reader=int(v.get("reader", 0)))

        return fetch

    def _output_buffer(self, tid: str, n_readers: int) -> _OutputBuffer:
        buf = _OutputBuffer(n_readers=n_readers)
        with self._wlock:
            self.out_buffers[tid] = buf
            # evict what nothing reads again first, then the oldest finished
            # (a consumer stage that never dispatched would pin them)
            dead = [t for t, b in self.out_buffers.items() if b.failed or b.fully_delivered]
            done = [t for t, b in self.out_buffers.items() if b.done and t not in dead]
            while len(self.out_buffers) > self.max_out_buffers and (dead or done):
                self.out_buffers.pop(dead.pop(0) if dead else done.pop(0), None)
        return buf

    def _run_task(self, req, tid, frag_id, node, st):
        stream_out = req.get("output") == "stream"
        buf = self._output_buffer(tid, int(req.get("n_readers", 1))) if stream_out else None
        sources = req.get("stream_sources") or {}
        fetch = self._stream_fetcher(sources)
        xdir = req["exchange_dir"]
        # a token per execution: a speculative duplicate of one task id
        # holds a slot of its own
        token = self.scheduler.new_token(tid)
        ex = self._checkout_executor(query_key=xdir, token=token)
        ex.page_cache = req.get("page_cache")
        # the statement's coalescing width, shipped in every task request
        ex.dispatch_batch = req.get("dispatch_batch")
        # pooled executors keep stats across tasks: drop this fragment's
        # stale ones and stamp its fragment-relative paths and estimates
        for nid in _subtree_ids(node):
            ex.stats.pop(nid, None)
            ex.boundary.pop(nid, None)
        ex.begin_plan(node)

        def tick(t=token):
            # a preemption point is a kill checkpoint too: a poisoned query
            # ends here even between reservations
            self.memory_pool.check_killed()
            self.scheduler.tick(t)

        counters = QueryCounters()
        kind = req.get("kind", "partial_agg")
        try:
            with self._wlock:
                self._executing += 1
                self.peak_concurrency = max(self.peak_concurrency, self._executing)
                self._running_queries[xdir] = self._running_queries.get(xdir, 0) + 1
            # the coordinator ships the query's trace id: this task's spans
            # record under it (one trace per query)
            qtrace = str((req.get("trace") or {}).get("trace_id") or tid)
            with tracing.track_inflight(self.inflight), tracing.query_scope(tid), \
                    tracing.activate_tracer(self.tracer), \
                    self.tracer.span("task", trace_id=qtrace, task=tid, kind=kind,
                                     node=self.node_id) as task_span, \
                    tracing.track_counters(counters), counted(ex), \
                    self.memory_pool.query_scope(xdir):
                # the task fault point: kill_worker makes this worker look
                # crashed; error and fatal fail this task
                if faults.maybe_inject("task", f"{kind}.{tid}") == "kill_worker":
                    self._simulate_crash()
                    raise InjectedFaultError(f"injected worker crash during task {tid}")
                if kind == "partial_agg":
                    data = run_partial_aggregate(ex, node, req["splits"], xdir, sources,
                                                 fetch, tick=tick)
                elif kind == "stream_splits":
                    data = run_stream_splits(ex, node, xdir, req["splits"], sources, fetch,
                                             sink=buf.add if buf is not None else None,
                                             tick=tick)
                elif kind == "fragment":
                    data = run_fragment(ex, node, xdir, sources, fetch)
                else:
                    raise ValueError(f"unknown task kind {kind!r}")
            # before the output shows: a coordinator that sees the commit
            # finds these set
            st.plan_stats = self._collect_task_plan_stats(node, ex)
            st.counters = counters.as_dict()
            st.spans = [tracing.span_dict(s)
                        for s in _span_subtree(self.tracer, qtrace, task_span.span_id)]
            if stream_out:
                if data:
                    buf.add(data)
                buf.finish()
            else:
                SpoolingExchange(xdir).commit(req["task_id"], req.get("attempt", 0), data)
            st.state = "done"
        except Exception as e:  # noqa: BLE001 - the task's failure is its status
            st.state = "failed"
            if st.counters is None:
                st.counters = counters.as_dict()  # the spend so far is real
            st.retryable = is_retryable_failure(e)
            st.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            if buf is not None:
                buf.fail(st.error)
        finally:
            with self._wlock:
                self._executing -= 1
                self._running_tasks -= 1
                n = self._running_frags.get(frag_id, 1) - 1
                if n <= 0:
                    self._running_frags.pop(frag_id, None)
                else:
                    self._running_frags[frag_id] = n
                nq = self._running_queries.get(xdir, 1) - 1
                if nq <= 0:
                    self._running_queries.pop(xdir, None)
                    self.memory_pool.clear_query(xdir)  # the query's last task here
                else:
                    self._running_queries[xdir] = nq
            ex.page_cache = None
            ex.dispatch_batch = None  # per-task settings: the executor is pooled
            # the executor goes back to the pool: no producer of a failed
            # task may race the next task's scan
            ex.close_producers()
            ex._release_reserved()
            self._release_executor(ex, token=token)

    def _simulate_crash(self) -> None:
        """The ``kill_worker`` action: the worker looks crashed, not drained:
        its HTTP server stops (status polls and heartbeat probes fail, so the
        failure detector marks it dead) while the process lives on."""
        self._stop.set()
        with self._wlock:
            self._draining = True
        httpd = self._httpd
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:  # noqa: BLE001
                pass

    # -- graceful shutdown (GracefulShutdownHandler.java: no new work, the
    # running tasks drain, the node leaves) -------------------------------------
    def shutdown_gracefully(self, poll: float = 0.1) -> None:
        if self._draining:
            return
        self._draining = True

        def drain():
            while True:
                with self._wlock:
                    if self._running_tasks == 0:
                        break
                time.sleep(poll)
            # stop the announces BEFORE "gone": a late shutting_down announce
            # would register the departed worker again
            self._stop.set()
            if self.coordinator_url:
                try:
                    _http(f"{self.coordinator_url}/v1/announce",
                          json.dumps({"node_id": self.node_id, "url": self.url,
                                      "state": "gone"}).encode(), secret=self.secret)
                except Exception:  # noqa: BLE001 - the heartbeats notice
                    pass
            self.stop()

        threading.Thread(target=drain, daemon=True).start()


# ---------------------------------------------------------------------------- coordinator
@dataclasses.dataclass
class _WorkerInfo:
    node_id: str
    url: str
    last_seen: float
    misses: int = 0
    alive: bool = True
    draining: bool = False  # graceful shutdown: reachable, not schedulable
    mem_reserved: int = 0  # the last announced pool reservation
    mem_max: int = 0
    mem_by_query: dict = dataclasses.field(default_factory=dict)  # the kill policy's input
    # the worker's own stall verdict: a degraded worker stays alive (its
    # polls and streams work) but takes no new task
    health: str = "ok"
    degraded: bool = False
    inflight: int = 0
    stall_report: Optional[dict] = None
    # probes of a failing worker back off (deterministic jitter from the
    # node id); a success or a fresh announce resets this
    next_probe: float = 0.0


class ClusterCoordinator:
    """The coordinator: takes worker announcements, detects failures by
    heartbeat, plans queries, dispatches every blocking fragment as remote
    tasks, merges the partial outputs and finishes the plan on its own
    executor, on the engine's device."""

    _FRAGMENT_NODES = FaultTolerantExecutor._FRAGMENT_NODES

    def __init__(self, engine, spool_dir: str, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_interval: float = 0.5, max_misses: int = 3, max_attempts: int = 3,
                 splits_per_task: int = 2, task_timeout: float = 120.0,
                 secret: Optional[str] = None, speculative_factor: float = 3.0,
                 stream_exchange: bool = True, low_memory_killer=None,
                 retry_backoff_s: float = 0.25, retry_backoff_cap_s: float = 5.0,
                 max_query_retries: int = 16):
        from ..execution.memory_killer import TotalReservationOnBlockedNodesKiller

        # stream_exchange: a nested single-task fragment streams its output
        # through its worker's buffer (reader 0, or one reader per task of a
        # split fan-out) instead of the spool.  A failed consumer retries by
        # replaying its producer chain: fresh producers run again (outputs
        # are deterministic), the dead reader is abandoned, and the spool's
        # first commit wins over a straggler of the earlier attempt
        self.stream_exchange = stream_exchange
        self.fanout_stream = _os.environ.get("TRINO_TPU_FANOUT_STREAM", "1") != "0"
        self._stream_pending: dict = {}  # id(plan node) -> its fragment
        self._stream_producers: dict = {}  # task id -> replay record
        self.streamed_tasks = 0
        self.stream_retries = 0
        self.broadcast_streams = 0
        self.local_fallbacks = 0  # queries that degraded to the local executor
        self.last_fallback_error: Optional[str] = None
        # the low-memory kill policy (ClusterMemoryManager.java:92), walked
        # by the heartbeat loop after a debounced blocked streak
        self.low_memory_killer = low_memory_killer if low_memory_killer is not None \
            else TotalReservationOnBlockedNodesKiller()
        self._blocked_streak = 0
        self.oom_kills = 0
        self.last_oom_victim: Optional[str] = None
        # the ladder's record: each pass's rung ("evict-cache", "kill"),
        # bounded, and the rung each victim landed on
        self.pressure_events: list = []
        self.query_pressure_rung: dict = {}
        self._pressure_cap = 64
        self.engine = engine
        self.spool_dir = spool_dir
        self.secret = secret if secret is not None \
            else _os.environ.get("TRINO_TPU_CLUSTER_SECRET")
        if self.secret is None and host not in _LOOPBACK:
            raise ValueError(f"refusing to serve unauthenticated announcements on {host}: "
                             "set TRINO_TPU_CLUSTER_SECRET (or pass secret=) to bind "
                             "beyond loopback")
        self.host, self.port = host, port
        self.workers: dict = {}  # node id -> _WorkerInfo
        self.max_workers = 256
        self.heartbeat_interval = heartbeat_interval
        self.max_misses = max_misses
        self.max_attempts = max_attempts
        self.splits_per_task = splits_per_task
        self.task_timeout = task_timeout
        # speculation: once a fragment's tasks are all dispatched, one
        # running past speculative_factor x the median finished duration
        # runs again on another worker; the spool keeps the first commit
        self.speculative_factor = speculative_factor
        self.speculative_tasks = 0
        # a retried task waits _backoff_s(task, attempt) before it is offered
        # again, and a query that burns more than max_query_retries retries
        # fails with the budget in its error
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self.max_query_retries = max_query_retries
        self._query_retries = 0
        self.last_retry_schedule: list = []  # (task id, attempt, backoff s)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._query_lock = threading.Lock()  # one distributed query at a time
        self._exchange_seq = 0
        self._frag_seq = 0
        # the coordinator's executor for the local finish (and a fallback),
        # on the engine's device and pools
        self._local = self._new_executor()
        self._compile_lock = threading.Lock()
        self._query_abort = threading.Event()  # sibling stages fail fast
        # (sql, catalog, user, plan-shaping properties) -> (plan, versions),
        # least recently used out first
        self._plan_cache: OrderedDict = OrderedDict()
        self._plan_cache_max = 128
        # the query's cluster-wide profile: the coordinator's own spend, its
        # sibling-stage threads', and every harvested worker task's
        self.last_query_counters = QueryCounters()
        self.last_query_worker_spans: list = []
        # one stitched trace per query: the root span on the engine's
        # tracer, worker spans re-keyed under it at harvest
        self.last_query_trace: dict = {}
        self._trace_qid = None
        self._trace_parent = None
        self.stitched_spans_total = 0
        self.shipped_fragments = 0  # fragments pickled with no tensor in them
        self._qc_local = QueryCounters()
        self._qc_workers = QueryCounters()
        self._qc_children: list = []
        self._worker_spans: list = []
        self._harvested: set = set()
        self._task_plan_stats: dict = {}  # task id -> fragment-relative actuals
        self._task_walls: dict = {}  # worker url -> [task wall s]
        self._fragment_rows: dict = {}  # id(node) -> a nested fragment's rows
        self.last_spool_bytes = 0  # bytes the last query committed to its spool

    def _new_executor(self) -> LocalExecutor:
        eng = self.engine
        return LocalExecutor(eng.catalogs, eng.device, memory_pool=eng.memory_pool,
                             buffer_pool=eng.buffer_pool)

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> str:
        coord = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/v1/announce":
                    return self._reply(404, {"error": "not found"})
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if coord.secret is not None:
                    # registration feeds the scheduler: it authenticates too
                    got = self.headers.get("X-Trino-Internal-Signature", "")
                    if not hmac.compare_digest(got, _sign(coord.secret, body)):
                        return self._reply(403, {"error": "bad signature"})
                msg = json.loads(body)
                coord._announce(msg["node_id"], msg["url"], msg.get("state", "active"),
                                msg.get("mem_reserved"), msg.get("mem_max"),
                                health=msg.get("health"), inflight=msg.get("inflight"))
                return self._reply(200, {"ok": True})

            def do_GET(self):
                if self.path == "/v1/nodes":
                    with coord._lock:
                        nodes = [{"node_id": w.node_id, "url": w.url, "alive": w.alive,
                                  "health": w.health, "degraded": w.degraded,
                                  "inflight": w.inflight} for w in coord.workers.values()]
                    return self._reply(200, {"nodes": nodes})
                if self.path == "/v1/memory":
                    return self._reply(200, coord.cluster_memory())
                self._reply(404, {"error": "not found"})

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    def cluster_memory(self) -> dict:
        """The cluster's memory view from the workers' announces and
        heartbeats (ClusterMemoryManager's aggregate): no poll on read."""
        from ..execution.memory_killer import BLOCKED_FRACTION

        with self._lock:
            per = [{"node_id": w.node_id, "mem_reserved": w.mem_reserved,
                    "mem_max": w.mem_max, "alive": w.alive} for w in self.workers.values()]
        live = [w for w in per if w["alive"]]
        return {"workers": per,
                "total_reserved": sum(w["mem_reserved"] for w in live),
                "total_max": sum(w["mem_max"] for w in live),
                "blocked_nodes": [w["node_id"] for w in live if w["mem_max"]
                                  and w["mem_reserved"] > BLOCKED_FRACTION * w["mem_max"]]}

    def _announce(self, node_id: str, url: str, state: str = "active", mem_reserved=None,
                  mem_max=None, health=None, inflight=None):
        with self._lock:
            if state == "gone":  # a graceful exit leaves at once
                self.workers.pop(node_id, None)
                return
            draining = state == "shutting_down"
            w = self.workers.get(node_id)
            if w is None:
                if len(self.workers) >= self.max_workers:
                    for nid in [n for n, i in self.workers.items() if not i.alive]:
                        self.workers.pop(nid)
                if len(self.workers) >= self.max_workers:
                    return
                w = self.workers[node_id] = _WorkerInfo(node_id, url, time.time(),
                                                        draining=draining)
            else:
                w.url, w.last_seen, w.misses, w.alive = url, time.time(), 0, True
                # a recovered worker is probed at once: a stale backoff would
                # blind the detector to a second death
                w.next_probe = 0.0
                w.draining = draining
            if mem_reserved is not None:
                w.mem_reserved = int(mem_reserved)
            if mem_max is not None:
                w.mem_max = int(mem_max)
            if health is not None:
                w.health = str(health)
                w.degraded = w.health == "stalled"
            if inflight is not None:
                w.inflight = int(inflight)

    def _heartbeat_loop(self):
        """The failure detector: probe /v1/info; max_misses failures in a
        row take a worker out of scheduling.  The same pass feeds the
        memory view and the killer's ladder."""
        while not self._stop.is_set():
            with self._lock:
                snapshot = list(self.workers.values())
            for w in snapshot:
                if w.next_probe > time.time():
                    continue  # a failing worker: probed on its backoff
                try:
                    info = json.loads(_http(f"{w.url}/v1/info", timeout=2.0))
                    with self._lock:
                        w.misses, w.alive, w.last_seen = 0, True, time.time()
                        w.next_probe = 0.0
                        w.draining = info.get("state") == "shutting_down"
                        if "mem_reserved" in info:
                            w.mem_reserved = int(info["mem_reserved"])
                            w.mem_max = int(info.get("mem_max", 0))
                        w.mem_by_query = info.get("mem_by_query") or {}
                        w.health = str(info.get("health", "ok"))
                        w.degraded = w.health == "stalled"
                        w.inflight = int(info.get("inflight", 0) or 0)
                        rep = info.get("stall_report")
                        if rep:
                            # a new report lands once in the engine's flight
                            # recorder, attributed to its node
                            prev = w.stall_report or {}
                            if rep.get("detected_at_s") != prev.get("detected_at_s"):
                                fr = getattr(self.engine, "flight_recorder", None)
                                if fr is not None:
                                    fr.record_event(dict(rep, kind="stall", node_id=w.node_id))
                            w.stall_report = rep
                except Exception:  # noqa: BLE001 - a missed probe
                    with self._lock:
                        w.misses += 1
                        if w.misses >= self.max_misses:
                            w.alive = False
                        w.next_probe = time.time() + _backoff_s(
                            w.node_id, w.misses, self.heartbeat_interval,
                            max(self.heartbeat_interval * 16, 8.0))
            self._run_memory_killer()
            self._stop.wait(self.heartbeat_interval)

    def _run_memory_killer(self) -> None:
        """One pass of the escalation ladder (ClusterMemoryManager.java:92):
        a node blocked for one heartbeat waits (spill gets a beat); two asks
        the blocked nodes to shed their caches; three asks the policy for a
        victim and kills it on every live worker.  Each rung is recorded in
        ``pressure_events``, a victim's in ``query_pressure_rung``."""
        from ..execution.memory_killer import BLOCKED_FRACTION

        with self._lock:
            nodes = [{"node_id": w.node_id, "url": w.url, "mem_reserved": w.mem_reserved,
                      "mem_max": w.mem_max, "mem_by_query": w.mem_by_query}
                     for w in self.workers.values() if w.alive]
        blocked = [n for n in nodes
                   if n["mem_max"] and n["mem_reserved"] > BLOCKED_FRACTION * n["mem_max"]]
        if not blocked:
            self._blocked_streak = 0
            return
        self._blocked_streak += 1
        if self._blocked_streak < 2:
            return
        if self._blocked_streak == 2:
            self._record_pressure({"rung": "evict-cache",
                                   "nodes": [n["node_id"] for n in blocked]})
            for n in blocked:
                try:
                    _http(f"{n['url']}/v1/evict_cache", pickle.dumps({}), secret=self.secret)
                except Exception:  # noqa: BLE001 - the detector's business
                    pass
            return
        victim = self.low_memory_killer.pick_victim(nodes)
        if victim is None:
            return
        self._blocked_streak = 0
        with self._lock:
            self.oom_kills += 1
            self.last_oom_victim = victim
        self._record_pressure({"rung": "kill", "query": victim})
        for n in nodes:
            try:
                _http(f"{n['url']}/v1/kill_query", pickle.dumps({"query_key": victim}),
                      secret=self.secret)
            except Exception:  # noqa: BLE001 - a dead worker frees with its process
                pass

    def _record_pressure(self, event: dict) -> None:
        with self._lock:
            self.pressure_events.append(dict(event, at=time.time()))
            del self.pressure_events[:-self._pressure_cap]
            if event["rung"] == "kill":
                self.query_pressure_rung[event["query"]] = "kill"
                while len(self.query_pressure_rung) > self._pressure_cap:
                    self.query_pressure_rung.pop(next(iter(self.query_pressure_rung)))

    def live_workers(self) -> list:
        """Schedulable workers: alive, not draining, not degraded."""
        with self._lock:
            return [w for w in self.workers.values()
                    if w.alive and not w.draining and not w.degraded]

    def wait_for_workers(self, n: int, timeout: float = 20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.live_workers()) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"{n} workers not registered within {timeout}s")

    # -- distributed query -------------------------------------------------------
    def execute_sql(self, sql: str, session=None, parameters=None):
        """Plan on the coordinator; run every blocking fragment as remote
        tasks over the live workers (scan-fed aggregates and join probes fan
        out by split batches; other fragments run as single tasks), the
        spooled exchange between fragments; finish the rest locally.  The
        engine's result tier answers a repeated statement before any
        fragment is scheduled, and a clean completion stores there.
        ``parameters`` substitute as literals (templates run locally only).
        One trace per query; completion, clean or not, lands a flight
        record."""
        if parameters is not None:
            from .dbapi import _substitute

            sql = _substitute(sql, list(parameters))
        sess = session or self.engine.create_session(next(iter(self.engine.catalogs)))
        qid = f"cluster_{next(_cluster_qids)}"
        self.engine._thread_accounting.snap = None
        t_created = time.time()
        state, error = "FINISHED", None
        try:
            with tracing.query_scope(qid), tracing.activate_tracer(self.engine.tracer), \
                    self.engine.tracer.span("query", trace_id=qid, sql=sql):
                return self._execute_sql_admitted(sql, sess)
        except BaseException as e:
            state, error = "FAILED", f"{type(e).__name__}: {e}"
            try:  # a failed corrected run demotes its correction
                ta = self.engine._thread_accounting
                if getattr(ta, "adaptive_corrected", False):
                    akey = getattr(ta, "adaptive_key", None)
                    adv = getattr(self.engine, "adaptive_advisor", None)
                    if adv is not None and akey is not None:
                        adv.failed(akey)
            except Exception:  # noqa: BLE001 - never masks the error
                pass
            raise
        finally:
            self._publish_cluster_trace(qid, sql, sess, state, error, t_created)

    def _execute_sql_admitted(self, sql: str, sess):
        plan, adaptive = self._consulted_plan(sql, sess)
        eng = self.engine
        rkey = eng._result_cache_key(sql, plan, sess)
        if rkey is not None and adaptive is not None and adaptive.get("verdict") == "replan":
            rkey = rkey + (("adaptive", adaptive["token"]),)
        epoch = eng.buffer_pool.epoch if rkey is not None else None
        if rkey is not None:
            served = eng._result_cache_fetch(rkey)
            if served is not None:
                snap = eng._thread_accounting.snap
                if snap is not None:
                    with self._lock:
                        self.last_query_counters = snap
                return served
        out = self._execute_plan_cluster(plan, sess)
        eng._result_cache_finish(rkey, out, epoch, plan)
        if rkey is not None:
            # the miss landed on the engine's snapshot: mirror it
            snap = eng._thread_accounting.snap
            if snap is not None:
                with self._lock:
                    self.last_query_counters.result_cache_misses += snap.result_cache_misses
        return out

    def _local_execute(self, plan):
        """The whole plan on the coordinator's executor (no worker, no
        fragment, or a degraded query), its reads counted."""
        local = self._local
        local._overrides = {}
        with counted(local):
            out = local.execute(plan)
        self.engine._record_plan_history(plan, local)
        return out

    def _execute_plan_cluster(self, plan, sess):
        import shutil

        from ..engine import _effective_dispatch_batch, _effective_page_cache

        local = self._local
        with self._query_lock:  # overrides are executor state
            # the session's coalescing width, or the advisor's correction of
            # it: the coordinator's local finish runs at it and every task
            # request ships it (queries serialize on the lock)
            self._dispatch_batch = _effective_dispatch_batch(sess)
            adec = getattr(self.engine._thread_accounting, "adaptive", None)
            if adec is not None and adec.get("verdict") == "replan":
                k = (adec.get("corrections") or {}).get("dispatch_batch")
                if k:
                    self._dispatch_batch = int(k)
            local.dispatch_batch = self._dispatch_batch
            self._page_cache = _effective_page_cache(sess)
            local.page_cache = self._page_cache
            # the root span execute_sql opened: tasks ship it, harvest
            # re-parents worker spans under it
            self._trace_qid = tracing.current_query_id()
            cur = self.engine.tracer.current()
            self._trace_parent = cur.span_id if (cur is not None and self._trace_qid) else None
            self._qc_local = QueryCounters()
            self._qc_workers = QueryCounters()
            self._qc_children = []
            self._worker_spans = []
            self._harvested = set()
            self._task_plan_stats = {}
            self._task_walls = {}
            self._fragment_rows = {}
            self._query_retries = 0
            self.last_retry_schedule = []
            self.last_spool_bytes = 0
            local._reset_stats(plan)
            try:
                with tracing.track_counters(self._qc_local):
                    if not self.live_workers():
                        return self._local_execute(plan)
                    with self._lock:
                        self._exchange_seq += 1
                        seq = self._exchange_seq
                    exchange_dir = _os.path.join(self.spool_dir,
                                                 f"cluster_exchange_{_os.getpid()}_{seq}")
                    exchange = SpoolingExchange(exchange_dir)
                    self._task_seq = 0
                    self._query_abort.clear()
                    self._stream_pending = {}
                    self._stream_producers = {}
                    spooled: dict = {}  # id(node) -> (task ids, node)
                    self._mem_results = {}  # id(node) -> (page, dicts) merged here
                    try:
                        try:
                            self._exec_fragments(plan, exchange, exchange_dir, spooled,
                                                 nested=False)
                        except Exception as exc:  # noqa: BLE001 - degrade below
                            if "QueryKilledError" in str(exc):
                                # the policy killed this query: a local rerun
                                # would defeat the kill
                                from ..memory import QueryKilledError

                                raise QueryKilledError(str(exc)) from exc
                            # a fragment the workers cannot run (a shape they
                            # lack, exhausted retries, every worker dead):
                            # the local executor answers, and a genuine
                            # query error raises from there alike
                            self.local_fallbacks += 1
                            self.last_fallback_error = traceback.format_exc()
                            return self._local_execute(plan)
                        if not spooled:
                            return self._local_execute(plan)
                        with counted(local), device_constants(local._count_h2d):
                            overrides = {}
                            for nid in self._top_fragments(plan, spooled):
                                hit = self._mem_results.get(nid)
                                if hit is None:
                                    task_ids, n = spooled[nid]
                                    hit = read_fragment_outputs(local, exchange, task_ids,
                                                                n.schema)
                                overrides[nid] = hit
                            local._overrides = overrides
                            out_page, dd = local._execute_to_page(plan)
                            out = local._materialize(out_page, dd)
                        self._record_cluster_history(plan, spooled, local, overrides)
                        return out
                    finally:
                        local._overrides = {}
                        self._mem_results = {}
                        local.close_producers()
                        local._release_reserved()
                        self._harvest_stream_producers()
                        self.last_spool_bytes = exchange.spooled_bytes()
                        shutil.rmtree(exchange_dir, ignore_errors=True)
            finally:
                self._publish_counters()

    def _publish_counters(self) -> None:
        """The query's merged profile (coordinator + sibling stages + every
        harvested worker task, and the straggler record), published as
        ``last_query_counters`` and folded into the engine's totals."""
        merged = self._qc_local.snapshot()
        with self._lock:
            for sub in self._qc_children:
                merged.merge(sub)
            merged.merge(self._qc_workers)
            walls = {u: sum(ds) for u, ds in self._task_walls.items()}
            if walls:
                # one kind="task" straggler record from the per-worker walls
                # the commit poll saw: summed task wall per worker, in ms
                urls = sorted(walls)
                rec = tracing.shard_skew([int(walls[u] * 1000.0) for u in urls])
                wall = max(walls.values())
                rec.update(site="cluster.task.walls", kind="task", wall_s=float(wall),
                           labels=urls)
                mx, mean = rec["max"], rec["mean"]
                rec["imbalance_s"] = ((mx - mean) / mx * wall) if mx > 0 else 0.0
                merged.shard_stats.append(rec)
                del merged.shard_stats[:-tracing.SHARD_STATS_MAX]
            self.last_query_counters = merged
            self.last_query_worker_spans = list(self._worker_spans)
        self.engine._account_counters(merged)

    def _record_cluster_history(self, plan, spooled, local, overrides) -> None:
        """One clean cluster run's actuals into the engine's plan history
        under the full plan's fingerprint: the local finish's stats, every
        harvested task's records re-anchored at its fragment root (split
        tasks of one fragment sum), and each fragment root's final rows.
        Best effort, as every history feed."""
        ph = getattr(self.engine, "plan_history", None)
        if ph is None or not ph.enabled:
            return
        try:
            from ..execution.history import fold_records, plan_node_paths, translate_path

            paths = plan_node_paths(plan)
            ests = getattr(local, "_node_ests", None) or {}
            extra: dict = {}
            with self._lock:
                task_stats = dict(self._task_plan_stats)
            for _nid, (tids, node) in spooled.items():
                root_path = paths.get(id(node))
                if root_path is None:
                    continue
                root_chain = root_path.partition("#")[2]
                for tid in tids:
                    for rel, rec in (task_stats.get(tid) or {}).items():
                        fold_records(extra, translate_path(rel, root_chain), rec)
            # fragment roots' finals overwrite (partials sum to more than the
            # merged output)
            finals: dict = dict(self._fragment_rows)
            for nid, hit in (overrides or {}).items():
                finals[nid] = int(hit[0].capacity if hit[0].valid is None
                                  else local._host([hit[0].valid.sum()], "history.rows")[0])
            for nid, rows in finals.items():
                root_path = paths.get(nid)
                if root_path is None:
                    continue
                rec = extra.setdefault(root_path, {
                    "op": root_path.partition("#")[0], "est_rows": None, "actual_rows": 0,
                    "wall_s": 0.0, "spilled_bytes": 0, "spill_tiers": {}, "cache_hits": 0})
                rec["actual_rows"] = rows
            est_by_path: dict = {}
            for nid, path in paths.items():
                v = ests.get(nid)
                if v is not None:
                    est_by_path.setdefault(path, v)
            for path, rec in extra.items():
                if rec.get("est_rows") is None:
                    rec["est_rows"] = est_by_path.get(path)
            self.engine._record_plan_history(plan, local, extra_records=extra)
        except Exception:  # noqa: BLE001 - history never fails a query
            pass

    # -- the cluster's counter flow --------------------------------------------
    def _harvest_task_stats(self, worker_url: str, tid: str) -> None:
        """A finished task's counters, spans and plan stats from its worker,
        merged into the query's profile once per task id (speculation and
        replay must not count a task twice).  Best effort: a worker that died
        after its commit keeps its output and loses its stats."""
        with self._lock:
            if tid in self._harvested:
                return
        try:
            st = json.loads(_http(f"{worker_url}/v1/task/{tid}", timeout=2.0))
        except Exception:  # noqa: BLE001
            return
        counters = st.get("counters")
        with self._lock:
            if tid in self._harvested:
                return
            if counters is None and st.get("state") == "running":
                return  # a speculated duplicate committed elsewhere
            self._harvested.add(tid)
            self._qc_workers.merge_dict(counters or {})
            if st.get("plan_stats"):
                self._task_plan_stats[tid] = st["plan_stats"]
            self._worker_spans.extend(self._stitch_spans(st.get("spans") or ()))

    def _stitch_spans(self, spans) -> list:
        """One task's span dicts re-keyed into the query's trace: the query's
        trace id, span ids from the engine tracer's id space (two workers'
        ids collide), task roots parented under the coordinator's root.
        Without a trace context they pass unchanged.  Under self._lock."""
        qid, parent = self._trace_qid, self._trace_parent
        if qid is None or parent is None:
            return [dict(s) for s in spans]
        idmap = {s.get("span_id"): self.engine.tracer._new_id() for s in spans}
        out = []
        for s in spans:
            d = dict(s)
            d["trace_id"] = qid
            d["span_id"] = idmap[s.get("span_id")]
            d["parent_id"] = idmap.get(s.get("parent_id"), parent)
            out.append(d)
        self.stitched_spans_total += len(out)
        return out

    def _publish_cluster_trace(self, qid, sql, sess, state, error, t_created) -> None:
        """The query's stitched trace (coordinator spans and re-parented
        worker spans), its wall breakdown (the retry backoff from the
        dispatch loop's schedule), ``last_query_trace`` and the flight
        record.  Guarded: a failure here never fails the query."""
        try:
            spans = [tracing.span_dict(s) for s in self.engine.tracer.spans_for(qid)]
            with self._lock:
                wspans = [s for s in self.last_query_worker_spans if s.get("trace_id") == qid]
                backoff = sum(d for _t, _a, d in self.last_retry_schedule) \
                    if self._trace_qid == qid else 0.0
                counters = self.last_query_counters.snapshot()
            spans += wspans
            root = next((s for s in spans if s.get("parent_id") is None
                         and s.get("name") == "query"), None)
            bd = tracing.wall_breakdown(spans, retry_backoff_s=backoff)
            root_s = None
            if root is not None and root.get("end_s") is not None:
                root_s = root["end_s"] - root["start_s"]
            trace = {"query_id": qid, "root_span_s": root_s, "spans": spans}
            if bd is not None:
                trace["wall_breakdown"] = bd
            self.last_query_trace = trace
            fr = getattr(self.engine, "flight_recorder", None)
            if fr is None or not fr.enabled:
                return
            from ..execution.flightrecorder import pressure_rung
            from ..sql.params import normalize_sql

            cd = counters.as_dict()
            try:
                norm = normalize_sql(sql)
            except Exception:  # noqa: BLE001
                norm = sql
            now = time.time()
            fr.record_query({"query_id": qid, "state": state, "sql": norm,
                             "user": sess.user, "catalog": sess.catalog, "error": error,
                             "created_s": t_created, "ended_s": now,
                             "wall_s": now - t_created, "queued_s": 0.0,
                             "distributed": True, "counters": cd,
                             "worker_spans": len(wspans), "retry_backoff_s": backoff,
                             "pressure_rung": pressure_rung(cd),
                             "trace": {"root_span_s": root_s, "spans": spans},
                             "wall_breakdown": bd})
        except Exception:  # noqa: BLE001 - observability never fails a query
            pass

    def _harvest_stream_producers(self) -> None:
        """Streaming producers commit nothing the dispatch loop sees: their
        stats are collected at query end (their consumers drained them).
        Dead workers are skipped: best-effort stats must not add a timeout."""
        with self._lock:
            producers = list(self._stream_producers.items())
            dead = {w.url for w in self.workers.values() if not w.alive}
        for tid, rec in producers:
            if rec["url"] not in dead:
                self._harvest_task_stats(rec["url"], tid)

    # -- fragment scheduling -----------------------------------------------------
    def _exec_fragments(self, node, exchange, exchange_dir, spooled, nested: bool) -> None:
        """Bottom-up: schedule every blocking fragment's tasks; its
        descendants' outputs are spooled (or pending as streams), so the
        fragment's plan replaces them by RemoteSource leaves.  ``nested``: a
        fragment above consumes this one remotely, so a coordinator-merged
        output must spool."""
        child_nested = nested or isinstance(node, self._FRAGMENT_NODES)
        kids = list(node.children)
        if len(kids) > 1:
            # independent siblings (join sides, set-op inputs) schedule at
            # once, their tasks interleaving over the workers
            import concurrent.futures as futures

            def run_child(c):
                # counters record per thread: each stage thread keeps its own
                sub = QueryCounters()
                try:
                    with tracing.track_counters(sub):
                        self._exec_fragments(c, exchange, exchange_dir, spooled,
                                             child_nested)
                except BaseException:
                    self._query_abort.set()  # siblings stop dispatching
                    raise
                finally:
                    with self._lock:
                        self._qc_children.append(sub)

            with futures.ThreadPoolExecutor(max_workers=len(kids)) as pool:
                for f in [pool.submit(run_child, c) for c in kids]:
                    f.result()
        else:
            for c in kids:
                self._exec_fragments(c, exchange, exchange_dir, spooled, child_nested)
        if not isinstance(node, self._FRAGMENT_NODES):
            return
        frag = self._substitute(node, spooled, root=True)
        if isinstance(node, P.Aggregate) and node.keys \
                and not any(s.kind in P.SORTED_AGG_KINDS for s in node.aggs):
            spine = self._scan_spine(frag.child)
            if spine is not None:
                task_ids = self._run_split_tasks(frag, spine, exchange_dir, "partial_agg",
                                                 fanout=node, spooled=spooled)
                if task_ids is not None:
                    self._merge_split_outputs(node, frag, exchange, task_ids, nested,
                                              spooled)
                    return
        if isinstance(node, P.Join):
            spine = self._scan_spine(frag.left)
            if spine is not None:
                task_ids = self._run_split_tasks(frag, spine, exchange_dir, "stream_splits",
                                                 fanout=node, spooled=spooled)
                if task_ids is not None:
                    spooled[id(node)] = (task_ids, node)
                    return
        if self.stream_exchange and nested:
            # a single-task fragment with a remote consumer waits: it starts
            # as a streaming producer when its consumer dispatches
            tid = self._next_tid()
            self._stream_pending[id(node)] = frag
            spooled[id(node)] = ((tid,), node)
            return
        sources = self._dispatch_stream_tree(node, spooled, exchange_dir)
        spooled[id(node)] = (self._run_single_task(frag, exchange_dir, sources=sources), node)

    def _merge_split_outputs(self, node, frag, exchange, task_ids, nested, spooled) -> None:
        """The final aggregation of a split fan-out's partial outputs, on a
        merge executor of this thread's own (sibling stages merge at once)."""
        merger = self._new_executor()
        with counted(merger):
            page, dicts = merge_partial_outputs(merger, frag,
                                                [exchange.read(t) for t in task_ids])
            tid = self._next_tid()
            if nested:
                # a remote consumer reads it: spool the merged page
                valid, pcols, pnulls = merger._host_page(page, site="cluster.merge.spool")
                self._fragment_rows[id(node)] = int(valid.sum())
                cols = [c[valid] for c in pcols]
                nulls = [None if (m is None or not m[valid].any()) else m[valid]
                         for m in pnulls]
                exchange.commit(tid, 0, serialize_fragment_output(cols, nulls, dicts))
            else:
                self._mem_results[id(node)] = (page, dicts)  # only the finish reads it
        spooled[id(node)] = ((tid,), node)

    def _substitute(self, node, spooled, root=False):
        """A copy of the subtree with spooled descendant fragments replaced
        by RemoteSource leaves."""
        if not root:
            hit = spooled.get(id(node))
            if hit is not None:
                return P.RemoteSource(tuple(hit[0]), node.schema)
        kids = tuple(self._substitute(c, spooled) for c in node.children)
        if all(k is c for k, c in zip(kids, node.children)):
            return node
        from ..sql.rules import _replace_children

        return _replace_children(node, kids)

    def _scan_spine(self, node):
        """(scan, chain top) of the fragment's probe-side TableScan under a
        pure Filter/Project chain (the split-parallel spine), or None (the
        stream is fed by a RemoteSource: one task over the spooled input)."""
        if isinstance(node, P.TableScan):
            return node, node
        if isinstance(node, (P.Filter, P.Project)):
            sub = self._scan_spine(node.child)
            return None if sub is None else (sub[0], node)
        return None

    def _top_fragments(self, plan, spooled) -> list:
        """Fragment roots the local finish consumes (nested ones are read
        remotely)."""
        out: list = []

        def walk(n):
            if id(n) in spooled:
                out.append(id(n))
                return
            for c in n.children:
                walk(c)

        walk(plan)
        return out

    def _next_tid(self) -> str:
        with self._lock:  # sibling fragments dispatch at once
            tid = f"t{self._task_seq}"
            self._task_seq += 1
            return tid

    def _next_fragment_blob(self, frag):
        """(fragment id, the pickled fragment request): the plan must hold
        no tensor (``_dumps_fragment`` refuses one)."""
        with self._lock:
            self._frag_seq += 1
            frag_id = f"frag_{self._frag_seq}"
        blob = _dumps_fragment({"fragment_id": frag_id, "plan": frag})
        with self._lock:
            self.shipped_fragments += 1
        return frag_id, blob

    def _trace_ctx(self):
        """The trace context every task request ships, or None outside a
        traced query."""
        if self._trace_qid is None or self._trace_parent is None:
            return None
        return {"trace_id": self._trace_qid, "parent_span_id": self._trace_parent}

    def _run_split_tasks(self, frag, spine, exchange_dir, kind, fanout=None, spooled=None):
        """Fan a fragment out over the workers by split batches.  The splits
        come from compiling the scan's Filter/Project chain alone, which
        prunes them statically as the executor does.  Returns the task ids,
        or None for a source with no split.  ``fanout``'s stream-pending
        children start as broadcast producers, one reader per task."""
        scan, chain_top = spine
        splits = None
        try:
            with self._compile_lock:
                stream = self._local._compile_stream(chain_top)
            if stream.scan_info is not None:
                splits = list(stream.scan_info.splits)
        except NotImplementedError:
            pass
        if splits is None:
            splits = list(self.engine.catalogs[scan.catalog].splits(scan.table))
        if not splits:
            return None
        k = self.splits_per_task
        n_tasks = (len(splits) + k - 1) // k
        base_sources = None
        if fanout is not None and self._collect_pending(fanout, spooled):
            if self.fanout_stream:
                base_sources = self._stream_fanout_sources(fanout, spooled, exchange_dir,
                                                           n_readers=n_tasks)
            else:
                self._materialize_pending(fanout, spooled, exchange_dir)
        tasks = []
        for i in range(n_tasks):
            extra = {"splits": tuple(splits[i * k:(i + 1) * k])}
            if base_sources:
                extra["stream_sources"] = {pt: {"url": u, "task": pt, "reader": i}
                                           for pt, u in base_sources.items()}
            tasks.append((self._next_tid(), extra))
        self._dispatch_tasks(frag, tasks, exchange_dir, kind)
        return tuple(t for t, _ in tasks)

    def _run_single_task(self, frag, exchange_dir, tid=None, sources=None) -> tuple:
        tid = tid if tid is not None else self._next_tid()
        self._dispatch_tasks(frag, [(tid, {"stream_sources": sources} if sources else {})],
                             exchange_dir, "fragment")
        return (tid,)

    # -- the streaming exchange ------------------------------------------------
    def _collect_pending(self, node, spooled) -> list:
        """The stream-pending child fragments directly under ``node``'s
        fragment (the walk stops at a materialized boundary)."""
        out: list = []

        def walk(n):
            for c in n.children:
                if id(c) in self._stream_pending:
                    out.append(c)
                elif id(c) not in spooled:
                    walk(c)

        walk(node)
        return out

    def _dispatch_stream_tree(self, node, spooled, exchange_dir) -> dict:
        """Start every stream-pending descendant of ``node`` as a streaming
        producer, deepest first -> {task id: producer url}."""
        sources: dict = {}
        for c in self._collect_pending(node, spooled):
            frag = self._stream_pending.pop(id(c))
            child_sources = self._dispatch_stream_tree(c, spooled, exchange_dir)
            tid = spooled[id(c)][0][0]
            sources[tid] = self._dispatch_stream_producer(frag, tid, exchange_dir,
                                                          child_sources)
        return sources

    def _materialize_pending(self, node, spooled, exchange_dir) -> None:
        """Each pending child run to a spooled output (the fan-out stream
        switched off: the readers share the durable copy)."""
        for c in self._collect_pending(node, spooled):
            frag = self._stream_pending.pop(id(c))
            srcs = self._dispatch_stream_tree(c, spooled, exchange_dir)
            self._run_single_task(frag, exchange_dir, tid=spooled[id(c)][0][0], sources=srcs)

    def _stream_fanout_sources(self, node, spooled, exchange_dir, n_readers: int) -> dict:
        """Each pending child as a broadcast producer serving ``n_readers``
        consumer tasks -> {task id: producer url}."""
        sources: dict = {}
        for c in self._collect_pending(node, spooled):
            frag = self._stream_pending.pop(id(c))
            child_sources = self._dispatch_stream_tree(c, spooled, exchange_dir)
            tid = spooled[id(c)][0][0]
            sources[tid] = self._dispatch_stream_producer(frag, tid, exchange_dir,
                                                          child_sources, n_readers=n_readers)
            with self._lock:
                self.broadcast_streams += 1
        return sources

    def _dispatch_stream_producer(self, frag, tid, exchange_dir, sources,
                                  n_readers: int = 1) -> str:
        """Ship a fragment as a streaming-output task to one worker without
        waiting: the consumer's reads drive it.  Returns the producer's url
        and records a replay entry for a failed consumer.  Producers run kind
        "fragment", one envelope each: the first add into an empty buffer
        always succeeds, so readers that are not dispatched yet cannot
        deadlock a broadcast producer against its backpressure."""
        live = self.live_workers()
        if not live:
            raise RuntimeError("no live workers")
        frag_id, frag_blob = self._next_fragment_blob(frag)
        req = {"task_id": tid, "fragment_id": frag_id, "kind": "fragment", "attempt": 0,
               "exchange_dir": exchange_dir, "output": "stream", "n_readers": n_readers,
               "trace": self._trace_ctx(), "page_cache": getattr(self, "_page_cache", None),
               "dispatch_batch": getattr(self, "_dispatch_batch", None)}
        if sources:
            req["stream_sources"] = sources
        last_err = None
        for w in live:
            try:
                _http(f"{w.url}/v1/fragment", frag_blob, secret=self.secret)
                _http(f"{w.url}/v1/task", pickle.dumps(req), secret=self.secret)
                with self._lock:
                    self.streamed_tasks += 1
                    self._stream_producers[tid] = {"frag": frag,
                                                   "child_tids": list(sources or ()),
                                                   "exchange_dir": exchange_dir, "url": w.url}
                return w.url
            except Exception as e:  # noqa: BLE001 - busy, draining, unreachable: next
                last_err = e
        raise RuntimeError(f"no worker accepted streaming task {tid}: {last_err}")

    def _replay_stream_sources(self, sources: dict, attempt: int, consumer: str = "") -> dict:
        """A consumer failed mid-drain: its producers freed the pages it
        acknowledged, so a fresh dedicated producer chain runs per source
        (outputs are deterministic) and the dead reader is abandoned on any
        surviving old producer."""
        new = {}
        for ptid, v in sources.items():
            old = v if isinstance(v, dict) else {"url": v, "task": ptid, "reader": 0}
            self._abandon_reader(old)
            new[ptid] = self._respawn_producer(ptid, attempt, consumer)
        with self._lock:
            self.stream_retries += 1
        return new

    def _abandon_reader(self, src: dict) -> None:
        path = f"/v1/task/{src.get('task')}/results/{int(src.get('reader', 0))}/abandon"
        try:
            req = urllib.request.Request(src["url"] + path, data=b"", method="POST")
            if self.secret:
                req.add_header("X-Trino-Internal-Signature", _sign(self.secret, path.encode()))
            urllib.request.urlopen(req, timeout=2.0).read()
        except Exception:  # noqa: BLE001 - the old producer may be dead
            pass

    def _respawn_producer(self, ptid: str, attempt: int, consumer: str = "") -> dict:
        """A fresh single-reader instance of producer ``ptid`` under a new
        task id that names the retried consumer (two consumers of one
        broadcast producer must not collide), its own producers respawned."""
        rec = self._stream_producers[ptid]
        child_sources = {c: self._respawn_producer(c, attempt, consumer)
                         for c in rec["child_tids"]}
        newtid = f"{ptid}~{consumer}a{attempt}"
        url = self._dispatch_stream_producer(rec["frag"], newtid, rec["exchange_dir"],
                                             child_sources, n_readers=1)
        return {"url": url, "task": newtid, "reader": 0}

    # -- plans -----------------------------------------------------------------
    def _consulted_plan(self, sql: str, sess):
        """The adaptive advisor's cluster entry: consulted on the
        coordinator's statement key before planning; a frozen "replan"
        compiles and caches the corrected plan under its token, whose
        fragments ship as any other.  -> (plan, decision or None)."""
        from ..engine import _normalize_statement, _plan_shape_props

        eng = self.engine
        ta = eng._thread_accounting
        ta.adaptive = None
        ta.adaptive_key = None
        ta.adaptive_corrected = False
        ta.history_sql = sql
        key = (_normalize_statement(sql), sess.catalog, "cluster", sess.user,
               _plan_shape_props(sess))
        decision = eng._adaptive_consult(key, sess)
        if decision is None:
            eng._adaptive_note_base(key, sess)
            return self._cached_plan(sql, sess), None
        ta.adaptive = decision
        replan = decision.get("verdict") == "replan"
        field = "adaptive_replans" if replan else "adaptive_holds"
        with eng._totals_lock:
            setattr(eng.counters_total, field, getattr(eng.counters_total, field) + 1)
        if not replan:
            eng._adaptive_note_base(key, sess)
            return self._cached_plan(sql, sess), decision
        ta.adaptive_key = key
        ta.adaptive_corrected = True
        return self._cached_plan(sql, sess, adaptive=decision), decision

    def _cached_plan(self, sql: str, sess, adaptive=None):
        """A bounded plan cache with the engine's staleness rule (a plan
        embeds its catalogs' table resolution); ``adaptive`` keys and plans
        the corrected form."""
        from ..engine import _plan_shape_props, _session_with_corrections
        from ..sql.frontend import compile_sql

        key = (sql, sess.catalog, sess.user, _plan_shape_props(sess))
        if adaptive is not None:
            key = key + (("adaptive", adaptive["token"]),)
            sess = _session_with_corrections(sess, adaptive.get("corrections") or {})
        with self._lock:
            entry = self._plan_cache.get(key)
            if entry is not None:
                plan, versions = entry
                if self.engine._stale_catalog(versions) is not None:
                    self._plan_cache.pop(key, None)
                    self._local.forget_plan(plan)
                else:
                    self._plan_cache.move_to_end(key)
                    return plan
        plan = compile_sql(sql, self.engine, sess)
        with self._lock:
            raced = self._plan_cache.get(key)
            if raced is not None:
                return raced[0]
            self._plan_cache[key] = (plan, self.engine._plan_versions(plan))
            while len(self._plan_cache) > self._plan_cache_max:
                _, (old, _v) = self._plan_cache.popitem(last=False)
                self._local.forget_plan(old)
        return plan

    # -- dispatch ----------------------------------------------------------------
    def _dispatch_tasks(self, frag_plan, tasks, exchange_dir, kind) -> None:
        """Dispatch a fragment's tasks over the live workers and drive them
        to committed outputs: round-robin placement, status polls, timeout
        and death reassignment under an attempt budget on the backoff curve,
        a deterministic failure at once, speculation of stragglers.
        ``tasks``: [(task id, extra request fields)]."""
        exchange = SpoolingExchange(exchange_dir)
        frag_id, frag_blob = self._next_fragment_blob(frag_plan)
        frag_sent: set = set()  # worker urls (a restart changes the url)
        pending = dict(tasks)
        attempts: dict = {tid: 0 for tid, _ in tasks}
        refused_since: dict = {}  # tid -> the first 429/503 of its streak
        not_before: dict = {}  # tid -> earliest offer again (backoff)
        spin = 0  # a re-offered task tries another worker
        assigned: dict = {}  # tid -> (worker, extra, deadline)
        started: dict = {}
        durations: list = []
        speculated: set = set()

        def request(tid, extra, attempt):
            return pickle.dumps({"task_id": tid, "fragment_id": frag_id, "kind": kind,
                                 "attempt": attempt, "exchange_dir": exchange_dir,
                                 "trace": self._trace_ctx(),
                                 "page_cache": getattr(self, "_page_cache", None),
                                 "dispatch_batch": getattr(self, "_dispatch_batch", None),
                                 **extra})

        def ship(w):
            if w.url not in frag_sent:
                _http(f"{w.url}/v1/fragment", frag_blob, secret=self.secret)
                frag_sent.add(w.url)

        def burn(tid: str, what: str) -> None:
            """One retry: the task's attempt, the query's budget, and the
            next offer on the backoff curve."""
            attempts[tid] += 1
            tracing.record_task_retry(site="task.redispatch")
            with self._lock:
                self._query_retries += 1
                burned = self._query_retries
            if burned > self.max_query_retries:
                raise RuntimeError(
                    f"query retry budget exhausted: {burned} task retries > "
                    f"max_query_retries={self.max_query_retries} "
                    f"(last: task {tid} {what}, attempt {attempts[tid]})")
            if attempts[tid] >= self.max_attempts:
                raise RuntimeError(f"task {tid} {what} after {attempts[tid]} attempts")
            delay = _backoff_s(tid, attempts[tid], self.retry_backoff_s,
                               self.retry_backoff_cap_s)
            not_before[tid] = time.time() + delay
            with self._lock:
                self.last_retry_schedule.append((tid, attempts[tid], delay))

        while pending or assigned:
            if self._query_abort.is_set():
                raise RuntimeError("sibling stage failed: aborting this stage's dispatch")
            live = self.live_workers()
            if not live:
                raise RuntimeError("no live workers")
            spin += 1
            for i, (tid, extra) in enumerate(list(pending.items())):
                if not_before.get(tid, 0.0) > time.time():
                    continue
                w = live[(i + spin) % len(live)]
                try:
                    ship(w)
                    _http(f"{w.url}/v1/task", request(tid, extra, attempts[tid]),
                          secret=self.secret)
                    assigned[tid] = (w, extra, time.time() + self.task_timeout)
                    started[tid] = time.time()
                    refused_since.pop(tid, None)
                    del pending[tid]
                except urllib.error.HTTPError as he:
                    if he.code in (429, 503):
                        # backpressure or a drain: offered again next pass;
                        # refusal past task_timeout burns an attempt
                        t0 = refused_since.setdefault(tid, time.time())
                        if time.time() - t0 > self.task_timeout:
                            refused_since.pop(tid, None)
                            burn(tid, "refused by every worker")
                        continue
                    frag_sent.discard(w.url)
                    burn(tid, "failed to dispatch")
                except Exception:  # noqa: BLE001
                    # unreachable, or 409 after a restart: the fragment ships
                    # again, and the failure counts as a missed heartbeat so
                    # a dead worker leaves scheduling at once
                    frag_sent.discard(w.url)
                    with self._lock:
                        w.misses += 1
                        if w.misses >= self.max_misses:
                            w.alive = False
                        still_alive = w.alive
                    if still_alive:
                        burn(tid, "failed to dispatch")
            time.sleep(0.02)
            for tid, (w, extra, deadline) in list(assigned.items()):
                if exchange.is_committed(tid):
                    if tid not in speculated:
                        # rescued stragglers would inflate the median
                        dur = time.time() - started.get(tid, time.time())
                        durations.append(dur)
                        with self._lock:
                            self._task_walls.setdefault(w.url, []).append(dur)
                    self._harvest_task_stats(w.url, tid)
                    del assigned[tid]
                    continue
                if not pending and durations and tid not in speculated \
                        and "stream_sources" not in extra:
                    # (a speculated stream consumer would drain its producer's
                    # ack-once buffer twice)
                    med = sorted(durations)[len(durations) // 2]
                    if time.time() - started.get(tid, 0) > self.speculative_factor * max(med, 0.2):
                        others = [o for o in self.live_workers() if o.url != w.url]
                        if others:
                            o = others[len(speculated) % len(others)]
                            try:
                                ship(o)
                                _http(f"{o.url}/v1/task",
                                      request(tid, extra, attempts[tid] + 100),
                                      secret=self.secret)
                                speculated.add(tid)
                                with self._lock:
                                    self.speculative_tasks += 1
                            except Exception:  # noqa: BLE001 - best effort
                                frag_sent.discard(o.url)
                failed = time.time() > deadline  # a wedged task is reassigned
                try:
                    st = json.loads(_http(f"{w.url}/v1/task/{tid}", timeout=2.0))
                    # "done" is set after the commit: done and not committed
                    # is a lost commit (an exchange_write drop), offered
                    # again now rather than at the task's deadline (the
                    # reference waits for the deadline)
                    failed = failed or st.get("state") == "failed" or (
                        st.get("state") == "done" and not exchange.is_committed(tid))
                    if st.get("state") == "failed" and not st.get("retryable", True):
                        # deterministic: every re-dispatch would fail alike
                        raise RuntimeError(f"task {tid} failed deterministically: "
                                           f"{st.get('error')}")
                except RuntimeError:
                    raise
                except Exception:  # noqa: BLE001 - unreachable or lost: gone
                    failed = True
                if failed and not exchange.is_committed(tid):
                    del assigned[tid]
                    burn(tid, "failed")
                    if extra.get("stream_sources"):
                        extra = dict(extra)
                        extra["stream_sources"] = self._replay_stream_sources(
                            extra["stream_sources"], attempts[tid], consumer=tid)
                    pending[tid] = extra


def main(argv=None):
    """A worker process: ``python -m trino_tpu_torch.server.cluster --catalogs
    JSON --spool DIR [--coordinator URL] [--node-id ID] [--port N] [--device
    cpu|cuda] [--pool-bytes N] [--cache-bytes N]``.  Without ``--device`` the
    worker takes the card and fails without one.  Runs until SIGTERM or
    SIGINT."""
    import argparse
    import signal

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--catalogs", required=True)
    ap.add_argument("--spool", required=True)
    ap.add_argument("--node-id", default="worker")
    ap.add_argument("--device", default=None)
    ap.add_argument("--pool-bytes", type=int, default=None)
    ap.add_argument("--cache-bytes", type=int, default=None)
    args = ap.parse_args(argv)
    w = WorkerServer(json.loads(args.catalogs), args.spool, port=args.port,
                     coordinator_url=args.coordinator, node_id=args.node_id,
                     device=args.device, pool_bytes=args.pool_bytes,
                     cache_bytes=args.cache_bytes)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: done.set())
    url = w.start()
    print(f"worker {args.node_id} listening on {url} device {w.device}", flush=True)
    done.wait()
    w.stop()


if __name__ == "__main__":
    main()
