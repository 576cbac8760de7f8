"""Coordinator HTTP server: the client statement protocol.

Reference: the v1 statement protocol — POST /v1/statement returns a queued query with a
``nextUri``; the client follows nextUri until results are exhausted
(dispatcher/QueuedStatementResource.java:110,170, server/protocol/ExecutingStatementResource,
client paging loop StatementClientV1.java:403).  Query lifecycle mirrors QueryStateMachine
(execution/QueryState.java:21: QUEUED -> PLANNING -> RUNNING -> FINISHING -> FINISHED/FAILED).

Implementation: stdlib ThreadingHTTPServer + a thread-pool dispatch (the reference's
dispatch executor); results are paged DATA_ROWS_PER_FETCH rows per GET like the
reference's token-addressed result pages (server/TaskResource.java:331 token protocol).

Counterpart of ``trino_tpu/server/server.py``, serving a ``trino_tpu_torch``
engine: the protocol, the pages, the statement gate, authentication, spooling,
the status, trace and UI endpoints are the reference's.  Device memory comes
from ``torch.cuda`` on the engine's device; ``/v1/metrics`` exports the
families whose source the port has (query states, kernel launches and host
reads, host bytes, the launch-latency histogram, memory, resource groups);
``/v1/history``, ``/v1/flight`` and ``/v1/compiles`` answer as the reference
does when plan history, the flight recorder or the compile log is off.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["CoordinatorServer"]

DATA_ROWS_PER_FETCH = 4096

_qids = itertools.count(1)


_UI_STYLE = ("<!doctype html><title>trino-tpu</title>"
             "<style>body{font-family:sans-serif;margin:2em}"
             "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
             "padding:4px 8px;text-align:left}"
             "pre{background:#f6f6f6;padding:8px;overflow-x:auto}</style>")

# the single-page web UI (reference: core/trino-web-ui's React SPA, reduced
# to one dependency-free page): client-side rendering over /ui/api/*, a
# query drill-down, and a SQL console that speaks the public /v1/statement
# protocol (nextUri paging) like every other client.
_UI_APP = """<!doctype html><html><head><meta charset="utf-8">
<title>trino-tpu</title><style>
body{font-family:system-ui,sans-serif;margin:0;background:#f4f5f7;color:#172b4d}
header{background:#172b4d;color:#fff;padding:10px 24px;display:flex;gap:24px;
  align-items:baseline}
header h1{font-size:18px;margin:0}
header .stat{font-size:13px;opacity:.85}
main{padding:16px 24px;display:grid;grid-template-columns:1fr 1fr;gap:16px}
section{background:#fff;border-radius:6px;padding:12px 16px;
  box-shadow:0 1px 2px rgba(9,30,66,.15)}
section h2{font-size:14px;margin:0 0 8px;text-transform:uppercase;
  letter-spacing:.04em;color:#6b778c}
table{border-collapse:collapse;width:100%;font-size:13px}
td,th{border-bottom:1px solid #ebecf0;padding:5px 8px;text-align:left}
tr.q{cursor:pointer}tr.q:hover{background:#f0f4ff}
.st{padding:1px 7px;border-radius:9px;font-size:11px;font-weight:600}
.st-FINISHED{background:#e3fcef;color:#006644}
.st-FAILED,.st-CANCELED{background:#ffebe6;color:#bf2600}
.st-RUNNING,.st-QUEUED{background:#deebff;color:#0747a6}
pre{background:#f6f6f6;padding:8px;overflow-x:auto;font-size:12px;
  white-space:pre-wrap}
textarea{width:100%;box-sizing:border-box;font-family:ui-monospace,monospace;
  font-size:13px;min-height:70px}
button{background:#0052cc;color:#fff;border:0;border-radius:4px;
  padding:6px 14px;cursor:pointer}
#results{max-height:320px;overflow:auto}
</style></head><body>
<header><h1>trino-tpu</h1><span class="stat" id="stats">loading…</span></header>
<main>
<section style="grid-column:1/3"><h2>SQL console</h2>
<textarea id="sql" placeholder="select …"></textarea>
<p><button onclick="run()">Run</button> <span id="runstate"></span></p>
<div id="results"></div></section>
<section><h2>Queries</h2><table id="qs"><tr><th>id</th><th>state</th>
<th>user</th><th>elapsed</th><th>rows</th><th>sql</th></tr></table></section>
<section><h2>Query detail</h2><div id="detail">select a query…</div></section>
</main><script>
const esc = s => String(s ?? '').replace(/[&<>"]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
async function refresh(){
  try{
    const o = await (await fetch('/ui/api/overview')).json();
    const mb = o.memory.max_bytes ?
      ` | memory ${(o.memory.reserved/1e6).toFixed(0)}/` +
      `${(o.memory.max_bytes/1e6).toFixed(0)} MB` : '';
    document.getElementById('stats').textContent =
      `${o.queries.length} queries | catalogs: ${o.catalogs.join(', ')}${mb}`;
    const t = document.getElementById('qs');
    t.querySelectorAll('tr.q').forEach(r => r.remove());
    for(const q of o.queries){
      const tr = document.createElement('tr');
      tr.className = 'q';
      tr.onclick = () => detail(q.query_id);
      tr.innerHTML = `<td>${esc(q.query_id)}</td>` +
        `<td><span class="st st-${esc(q.state)}">${esc(q.state)}</span></td>` +
        `<td>${esc(q.user)}</td><td>${q.elapsed}s</td>` +
        `<td>${q.rows ?? ''}</td><td><code>${esc(q.sql)}</code></td>`;
      t.appendChild(tr);
    }
  }catch(e){ /* poll again */ }
}
async function detail(id){
  const d = await (await fetch('/ui/api/query/' + encodeURIComponent(id)))
    .json();
  let h = `<table><tr><th>state</th><td>${esc(d.state)}</td></tr>` +
    `<tr><th>user</th><td>${esc(d.user)}</td></tr>` +
    `<tr><th>elapsed</th><td>${d.elapsed}s</td></tr>` +
    (d.rows != null ? `<tr><th>rows</th><td>${d.rows}</td></tr>` : '') +
    `</table><h3>sql</h3><pre>${esc(d.sql)}</pre>`;
  if(d.error) h += `<h3>error</h3><pre>${esc(d.error)}</pre>`;
  if(d.plan) h += `<h3>plan</h3><pre>${esc(d.plan)}</pre>`;
  document.getElementById('detail').innerHTML = h;
}
async function run(){
  const sql = document.getElementById('sql').value.trim();
  if(!sql) return;
  const rs = document.getElementById('runstate');
  rs.textContent = 'running…';
  try{
    let r = await (await fetch('/v1/statement',
      {method:'POST', body: sql})).json();
    let cols = null, rows = [];
    while(true){
      if(r.columns) cols = r.columns;
      if(r.data) rows.push(...r.data);
      if(r.error){ rs.textContent = ''; document.getElementById('results')
        .innerHTML = `<pre>${esc(r.error.message || r.error)}</pre>`; return; }
      if(!r.nextUri) break;
      if(!r.data) await new Promise(s => setTimeout(s, 200));  // poll pacing
      r = await (await fetch(r.nextUri)).json();
    }
    rs.textContent = `${rows.length} rows`;
    let h = '<table><tr>' + (cols||[]).map(
      c => `<th>${esc(c.name)}</th>`).join('') + '</tr>';
    for(const row of rows.slice(0, 200))
      h += '<tr>' + row.map(v => `<td>${esc(v)}</td>`).join('') + '</tr>';
    document.getElementById('results').innerHTML =
      h + '</table>' + (rows.length > 200 ?
        `<p>… ${rows.length - 200} more rows</p>` : '');
    refresh();
  }catch(e){ rs.textContent = String(e); }
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


@dataclasses.dataclass
class _Query:
    query_id: str
    sql: str
    state: str = "QUEUED"  # QUEUED|PLANNING|RUNNING|FINISHED|FAILED|CANCELED
    error: Optional[str] = None
    columns: Optional[list] = None  # [{name, type}]
    rows: Optional[list] = None  # list of row tuples (json-ready)
    segments: Optional[list] = None  # spooled result descriptors
    user: str = "user"  # submitting principal: result reads require it
    created_at: float = dataclasses.field(default_factory=time.time)
    finished_at: Optional[float] = None
    # engine span-tree summary captured at completion (engine.last_query_trace
    # under the engine lock) — served OTLP-shaped by /v1/query/{id}/trace
    trace: Optional[dict] = None
    # protocol-level EXECUTE: python values bound into a parameterized
    # statement (sql carries ? markers), substituted as literals by the engine
    params: Optional[list] = None
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


class _StatementLock:
    """Shared/exclusive gate for engine access (round 12).

    The engine has been safe for CONCURRENT read statements since round 9
    (per-query pooled executors, the plan lock, the shared buffer pool under
    its own lock — tests/test_page_cache drives 4 threads through
    execute_sql), but this server still serialized every statement behind
    one mutex, which made the coordinator protocol single-file and any
    concurrency benchmark meaningless.  Read statements (SELECT/SHOW/
    EXPLAIN/VALUES/WITH) now run SHARED; DDL/DML and anything unrecognized
    runs EXCLUSIVE (memory-connector writes + catalog mutation still assume
    single-writer).  Writer-preference: a waiting writer blocks new readers,
    so a stream of dashboard SELECTs cannot starve an INSERT."""

    READ_KEYWORDS = ("select", "with", "show", "explain", "describe",
                     "values", "table")

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @classmethod
    def is_read_statement(cls, sql: str) -> bool:
        head = sql.lstrip().lstrip("(").lstrip()[:12].lower()
        return any(head.startswith(k) for k in cls.READ_KEYWORDS)

    def acquire_shared(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_shared(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_exclusive(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1

    def release_exclusive(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    def statement_scope(self, sql: str):
        import contextlib

        @contextlib.contextmanager
        def scope():
            shared = self.is_read_statement(sql)
            (self.acquire_shared if shared else self.acquire_exclusive)()
            try:
                yield
            finally:
                (self.release_shared if shared
                 else self.release_exclusive)()

        return scope()


def _device_memory_stats(device):
    """The card's allocator and free/total memory on a CUDA engine, in the
    reference's key names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``); None ("no device") on the CPU.  Neither call waits
    for running work."""
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    st = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total), "bytes_free": int(free)}


def _json_value(v):
    import decimal

    import numpy as np

    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.str_):
        return str(v)
    if isinstance(v, np.datetime64):
        return str(v)  # ISO date/timestamp text on the wire
    if isinstance(v, decimal.Decimal):
        # an exact decimal sum past 2^63: its exact text, as Trino's protocol
        # sends DECIMAL values (the reference's encoder raises on it)
        return str(v)
    return v


class CoordinatorServer:
    """Serves an Engine over the statement protocol (one process = coordinator role;
    the worker data plane is the SPMD mesh inside the engine, reference:
    CoordinatorModule vs WorkerModule role split)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080,
                 dispatch_threads: int = 4, passwords: Optional[dict] = None,
                 spool_dir: Optional[str] = None,
                 spool_threshold_rows: int = 10_000):
        self.engine = engine
        # user -> password; None = open access (reference: optional password
        # authenticator plugins; file-based password auth)
        self.passwords = passwords
        # spooled client protocol (reference: server/protocol/spooling + the
        # SpoolingManager SPI, spi/spool/SpoolingManager.java): results at or
        # above the threshold write as compressed segments the client fetches
        # by URI instead of inline JSON pages.  None disables spooling.
        self.spool_dir = spool_dir
        self.spool_threshold_rows = spool_threshold_rows
        self.host = host
        self.port = port
        self.queries: dict = {}
        self._pool = ThreadPoolExecutor(max_workers=dispatch_threads,
                                        thread_name_prefix="dispatch")
        # shared/exclusive statement gate (round 12): read statements execute
        # CONCURRENTLY against the engine's executor pool (one dispatch
        # thread per in-flight statement, up to dispatch_threads); DDL/DML
        # still serialize exclusively — see _StatementLock
        self._engine_lock = _StatementLock()
        self._queries_lock = threading.Lock()  # guards the queries registry itself
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------------
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/v1/statement":
                    self._send(404, {"error": "not found"})
                    return
                user = self.headers.get("X-Trino-User")
                if not server._authenticate(self.headers, user):
                    self.send_response(401)
                    self.send_header("WWW-Authenticate", "Basic")
                    self.end_headers()
                    return
                if user is None:
                    user = server._principal(self.headers) or "user"
                n = int(self.headers.get("Content-Length", 0))
                sql = self.rfile.read(n).decode()
                session_catalog = self.headers.get("X-Trino-Catalog")
                # protocol-level EXECUTE with parameters: the body is a
                # parameterized statement (? markers), the header a JSON
                # array of values to bind
                params = None
                raw = self.headers.get("X-Trino-Execute-Parameters")
                if raw:
                    try:
                        params = json.loads(raw)
                        if not isinstance(params, list):
                            raise ValueError("parameters must be a JSON list")
                    except ValueError as e:
                        self._send(400, {"error": f"bad parameters: {e}"})
                        return
                q = server._submit(sql, session_catalog, user, params=params)
                self._send(200, server._queued_response(q))

            def do_GET(self):
                if not server._authenticate(self.headers, None):
                    self.send_response(401)
                    self.send_header("WWW-Authenticate", "Basic")
                    self.end_headers()
                    return
                parts = self.path.strip("/").split("/")
                # /v1/statement/executing/{id}/{token}
                if len(parts) == 5 and parts[:3] == ["v1", "statement", "executing"]:
                    qid, token = parts[3], int(parts[4])
                    q = server.queries.get(qid)
                    if q is None:
                        self._send(404, {"error": f"unknown query {qid}"})
                        return
                    if not server._owns(self.headers, q):
                        self._send(403, {"error": "not your query"})
                        return
                    self._send(200, server._results_response(q, token))
                    return
                # /v1/query/{id}/trace — OTLP-shaped span tree of the query
                # (reference: airlift TracingModule's OTLP export, served
                # in-process so one curl profiles a finished statement)
                if len(parts) == 4 and parts[:2] == ["v1", "query"] \
                        and parts[3] == "trace":
                    payload = server._query_trace(parts[2])
                    if payload is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    self._send(200, payload)
                    return
                if len(parts) == 3 and parts[:2] == ["v1", "query"]:
                    q = server.queries.get(parts[2])
                    if q is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    self._send(200, server._query_info(q))
                    return
                if parts == ["v1", "info"]:
                    self._send(200, {"coordinator": True, "running": True,
                                     "nodeVersion": {"version": "trino-tpu-0"}})
                    return
                if parts == ["v1", "status"]:
                    # live introspection: running queries with their
                    # counters so far, health, the memory pool and the
                    # device's memory (reference: QueryInfo/TaskInfo live
                    # snapshots behind the web UI)
                    self._send(200, server._status_json())
                    return
                if parts == ["v1", "history"]:
                    # the plan-actuals history: the reference's answer
                    # without one (the port keeps no plan history yet)
                    self._send(200, {"plans": []})
                    return
                if parts == ["v1", "flight"]:
                    self._send(200, server._flight_index())
                    return
                if len(parts) == 3 and parts[:2] == ["v1", "flight"]:
                    # /v1/flight/{id}: no record is ever kept
                    self._send(404, {"error": "unknown query"})
                    return
                if parts == ["v1", "compiles"]:
                    # the compile observatory: the reference's answer with
                    # its log off
                    self._send(200, server._compiles_json())
                    return
                # /v1/spooled/{qid}/{seg} — spooled result segment payload
                # (reference: the client fetching spooled segments by URI,
                # client/trino-client/.../OkHttpSegmentLoader.java)
                if len(parts) == 4 and parts[:2] == ["v1", "spooled"]:
                    q = server.queries.get(parts[2])
                    if q is not None and not server._owns(self.headers, q):
                        self._send(403, {"error": "not your query"})
                        return
                    data = server._read_segment(parts[2], parts[3])
                    if data is None:
                        self._send(404, {"error": "unknown segment"})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if parts == ["v1", "metrics"]:
                    # reference: JmxOpenMetricsModule — a Prometheus text
                    # exposition of engine counters
                    body = server._metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parts == ["ui"] or parts == ["ui", ""]:
                    # reference: core/trino-web-ui's SPA, reduced to ONE
                    # self-contained page (inline JS, no build tooling) that
                    # polls the JSON api below — live overview, per-query
                    # drill-down, and a SQL console speaking the same
                    # /v1/statement protocol as every other client
                    body = _UI_APP.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parts == ["ui", "api", "overview"]:
                    self._send(200, server._ui_overview())
                    return
                if len(parts) == 4 and parts[:3] == ["ui", "api", "query"]:
                    detail = server._ui_query_json(parts[3])
                    if detail is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    self._send(200, detail)
                    return
                if len(parts) == 3 and parts[:2] == ["ui", "query"]:
                    # per-query drill-down (reference: the web UI's query
                    # detail page — SQL, state, timings, plan)
                    html_q = server._ui_query_html(parts[2])
                    if html_q is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    body = html_q.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._send(404, {"error": "not found"})

            def do_DELETE(self):
                if not server._authenticate(self.headers, None):
                    self.send_response(401)
                    self.send_header("WWW-Authenticate", "Basic")
                    self.end_headers()
                    return
                parts = self.path.strip("/").split("/")
                qid = None
                if len(parts) >= 5 and parts[:3] == ["v1", "statement", "executing"]:
                    qid = parts[3]  # DELETE on a nextUri (StatementClientV1 cancel)
                elif len(parts) == 3 and parts[:2] == ["v1", "statement"]:
                    qid = parts[2]
                if qid is not None:
                    q = server.queries.get(qid)
                    if q is not None and not server._owns(self.headers, q):
                        self._send(403, {"error": "not your query"})
                        return
                    if q is not None:
                        with q.lock:
                            if q.state not in ("FINISHED", "FAILED"):
                                q.state = "CANCELED"
                    self._send(204, {})
                    return
                self._send(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._pool.shutdown(wait=False)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- auth (reference: password authenticators + InternalAuthenticationManager;
    # a password map gates access when configured, else open) ----------------------
    def _authenticate(self, headers, user) -> bool:
        """Basic credentials against the password map (constant-time compare).
        When an X-Trino-User is given it must match the authenticated
        principal (reference: the authenticated user gates the session user);
        result/cancel/metrics GETs authenticate the principal alone."""
        if self.passwords is None:
            return True
        import base64
        import hmac

        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            return False
        try:
            decoded = base64.b64decode(auth[6:]).decode()
            auth_user, _, pw = decoded.partition(":")
        except Exception:
            return False
        expected = self.passwords.get(auth_user)
        if expected is None or not hmac.compare_digest(expected, pw):
            return False
        return user is None or auth_user == user

    def _owns(self, headers, q) -> bool:
        """Result reads and cancels belong to the submitting principal: query
        ids are guessable, and per-table access control would otherwise be
        moot for any data another user has already queried.  Open servers
        (no password map) skip the check."""
        if self.passwords is None:
            return True
        return self._principal(headers) == q.user

    def _principal(self, headers):
        import base64

        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            return None
        try:
            return base64.b64decode(auth[6:]).decode().partition(":")[0]
        except Exception:
            return None

    @staticmethod
    def _escape_label(v: str) -> str:
        """Prometheus text-format label-value escaping (backslash, quote,
        newline) — stricter scrapers reject unescaped values."""
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def _metrics_text(self) -> str:
        """Prometheus text exposition with # HELP / # TYPE metadata (the
        format openmetrics-strict scrapers require; reference:
        JmxOpenMetricsModule): query states, the device-boundary counters,
        the launch-latency histogram, the memory pool and the resource
        groups, under the reference's family names."""
        esc = self._escape_label
        with self._queries_lock:
            qs = list(self.queries.values())
        by_state: dict = {}
        for q in qs:
            by_state[q.state] = by_state.get(q.state, 0) + 1
        lines = [
            "# HELP trino_tpu_queries_total Statements accepted by this "
            "coordinator.",
            "# TYPE trino_tpu_queries_total counter",
            f"trino_tpu_queries_total {len(qs)}",
            "# HELP trino_tpu_queries_by_state Tracked queries per lifecycle "
            "state.",
            "# TYPE trino_tpu_queries_by_state gauge",
        ]
        for state, n in sorted(by_state.items()):
            lines.append(
                f'trino_tpu_queries_by_state{{state="{esc(state)}"}} {n}')
        done = [q for q in qs if q.finished_at is not None]
        if done:
            total = sum(q.finished_at - q.created_at for q in done)
            lines += ["# HELP trino_tpu_query_seconds_total Wall seconds of "
                      "finished queries.",
                      "# TYPE trino_tpu_query_seconds_total counter",
                      f"trino_tpu_query_seconds_total {total:.3f}"]
        # device-boundary totals (execution/tracing.QueryCounters) over every
        # statement this engine ran: kernel launches plus host reads as the
        # reference's dispatches, host reads as its transfers
        ct = getattr(self.engine, "counters_total", None)
        if ct is not None:
            lines += [
                "# HELP trino_tpu_device_dispatches_total Kernel launches "
                "plus host reads.",
                "# TYPE trino_tpu_device_dispatches_total counter",
                f"trino_tpu_device_dispatches_total {ct.device_dispatches}",
                "# HELP trino_tpu_host_transfers_total Device->host reads "
                "(each one synchronises the device).",
                "# TYPE trino_tpu_host_transfers_total counter",
                f"trino_tpu_host_transfers_total {ct.host_transfers}",
                "# HELP trino_tpu_host_bytes_pulled_total Device bytes moved "
                "to host.",
                "# TYPE trino_tpu_host_bytes_pulled_total counter",
                f"trino_tpu_host_bytes_pulled_total {ct.host_bytes_pulled}",
            ]
        from ..execution.tracing import DISPATCH_LATENCY

        h = DISPATCH_LATENCY.as_dict()
        lines += ["# HELP trino_tpu_dispatch_latency_seconds Host wall time of "
                  "each kernel launch (process-wide).",
                  "# TYPE trino_tpu_dispatch_latency_seconds histogram"]
        cum = 0
        for ub, c in zip(DISPATCH_LATENCY.buckets, h["buckets"]):
            cum += c
            lines.append(f'trino_tpu_dispatch_latency_seconds_bucket{{le="{ub}"}} {cum}')
        lines.append(f'trino_tpu_dispatch_latency_seconds_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"trino_tpu_dispatch_latency_seconds_sum {h['sum_s']}")
        lines.append(f"trino_tpu_dispatch_latency_seconds_count {h['count']}")
        # memory-pool snapshots as labeled gauges (the pool info dict finally
        # reaches the metrics endpoint — round-8 satellite)
        pools = self.engine.memory_info() \
            if hasattr(self.engine, "memory_info") else []
        if pools:
            lines += ["# HELP trino_tpu_memory_reserved_bytes Bytes reserved "
                      "in each executor memory pool.",
                      "# TYPE trino_tpu_memory_reserved_bytes gauge"]
            for d in pools:
                lines.append(f'trino_tpu_memory_reserved_bytes'
                             f'{{pool="{esc(d["pool"])}"}} {d["reserved"]}')
            lines += ["# HELP trino_tpu_memory_max_bytes Capacity of each "
                      "executor memory pool.",
                      "# TYPE trino_tpu_memory_max_bytes gauge"]
            for d in pools:
                lines.append(f'trino_tpu_memory_max_bytes'
                             f'{{pool="{esc(d["pool"])}"}} {d["max_bytes"]}')
        # resource-group queue depths (reference: the resource-group JMX
        # metrics the reference exports per group)
        groups = []
        try:
            groups = self.engine.resource_groups.info()
        except Exception:
            pass
        if groups:
            lines += ["# HELP trino_tpu_resource_group_running Queries "
                      "running per resource group.",
                      "# TYPE trino_tpu_resource_group_running gauge"]
            for g in groups:
                lines.append(f'trino_tpu_resource_group_running'
                             f'{{group="{esc(g["name"])}"}} {g["running"]}')
            lines += ["# HELP trino_tpu_resource_group_queued Queries queued "
                      "per resource group.",
                      "# TYPE trino_tpu_resource_group_queued gauge"]
            for g in groups:
                lines.append(f'trino_tpu_resource_group_queued'
                             f'{{group="{esc(g["name"])}"}} {g["queued"]}')
        return "\n".join(lines) + "\n"

    def _status_json(self) -> dict:
        """GET /v1/status payload: engine health, the running statements with
        their counters so far, the memory pool and the device's memory
        (lock-free, poll-grade)."""
        from ..execution import tracing

        e = self.engine
        live = tracing.live_query_counters()
        queries = []
        for q in e.query_tracker.all_queries():
            if q.is_done:
                continue
            i = q.info()
            queries.append({
                "query_id": i.query_id, "state": i.state, "user": i.user,
                "elapsed_s": round(i.elapsed_s or 0.0, 3),
                "sql": i.sql[:500],
                "counters": live.get(i.query_id),
                "inflight": []})
        return {"health": e.health(),
                "stall_report": None,
                "inflight": [],
                "queries": queries,
                "memory": e.memory_info(),
                "buffer_pool": None,
                "device_memory": _device_memory_stats(e.device)}

    def _query_row_count(self, q):
        """Result row count for UI surfaces: spooled queries hold their rows
        in segments, not q.rows (which _run empties after spooling)."""
        if q.segments:
            return sum(s["rows"] for s in q.segments)
        return len(q.rows) if q.rows is not None else None

    def _plan_text(self, q):
        """Best-effort EXPLAIN under the engine lock (every other execution
        path holds it; planning against catalogs mid-DDL is a race)."""
        try:
            with self._engine_lock.statement_scope("explain"):
                r = self.engine.execute_sql(f"explain {q.sql}")
            return "\n".join(str(row[0]) for row in r.rows())
        except Exception:
            return None  # DDL/statements EXPLAIN can't cover

    def _ui_overview(self) -> dict:
        """JSON cluster overview the SPA polls (reference: the web UI's
        /ui/api/stats + query list endpoints)."""
        with self._queries_lock:
            qs = sorted(self.queries.values(), key=lambda q: q.created_at,
                        reverse=True)[:100]
        mem = self.engine.memory_pool.info()
        return {
            "catalogs": sorted(self.engine.catalogs),
            "memory": {"reserved": mem.get("reserved", 0),
                       "max_bytes": mem.get("max_bytes", 0)},
            "queries": [{
                "query_id": q.query_id, "state": q.state, "user": q.user,
                "elapsed": round((q.finished_at or time.time())
                                 - q.created_at, 3),
                "rows": self._query_row_count(q),
                "sql": q.sql[:200]} for q in qs],
        }

    def _ui_query_json(self, qid: str):
        q = self.queries.get(qid)
        if q is None:
            return None
        out = {"query_id": q.query_id, "state": q.state, "user": q.user,
               "elapsed": round((q.finished_at or time.time())
                                - q.created_at, 3),
               "sql": q.sql, "error": q.error,
               "columns": list(q.columns or ()),
               "rows": self._query_row_count(q)}
        if not q.error:
            plan = self._plan_text(q)
            if plan is not None:
                out["plan"] = plan
        return out

    def _ui_query_html(self, qid: str):
        """Query drill-down: full SQL, lifecycle timings, output columns, the
        error if any, and a best-effort EXPLAIN of the statement (reference:
        the web UI query page's livePlan tab, reduced to the text plan)."""
        q = self.queries.get(qid)
        if q is None:
            return None
        import html as _html

        elapsed = (q.finished_at or time.time()) - q.created_at
        parts = [_UI_STYLE, f"<h1>query {_html.escape(q.query_id)}</h1>",
                 "<p><a href='/ui'>&larr; all queries</a></p>",
                 "<table>",
                 f"<tr><th>state</th><td>{_html.escape(q.state)}</td></tr>",
                 f"<tr><th>user</th><td>{_html.escape(q.user)}</td></tr>",
                 f"<tr><th>elapsed</th><td>{elapsed:.3f}s</td></tr>"]
        if q.rows is not None:
            parts.append(f"<tr><th>result rows</th><td>{len(q.rows)}</td></tr>")
        if q.columns:
            cols = ", ".join(f"{c['name']} {c['type']}" for c in q.columns)
            parts.append(f"<tr><th>columns</th><td>{_html.escape(cols)}</td>"
                         "</tr>")
        parts.append("</table>")
        parts.append(f"<h2>sql</h2><pre>{_html.escape(q.sql)}</pre>")
        if q.error:
            parts.append(f"<h2>error</h2><pre>{_html.escape(q.error)}</pre>")
        else:
            plan_text = self._plan_text(q)
            if plan_text is not None:
                parts.append(f"<h2>plan</h2><pre>{_html.escape(plan_text)}"
                             "</pre>")
        return "".join(parts)

    # -- dispatch -----------------------------------------------------------------
    def _submit(self, sql: str, catalog: Optional[str],
                user: str = "user", params: Optional[list] = None) -> _Query:
        q = _Query(query_id=f"q{next(_qids)}", sql=sql, user=user,
                   params=params)
        with self._queries_lock:
            self.queries[q.query_id] = q
        self._pool.submit(self._run, q, catalog, user)
        return q

    def _drop_spool(self, query_id: str) -> None:
        import os
        import shutil

        if self.spool_dir is not None:
            shutil.rmtree(os.path.join(self.spool_dir, query_id),
                          ignore_errors=True)

    def _set_state(self, q: _Query, new: str) -> bool:
        """Transition unless a cancel already landed (q.lock guards the race between
        DELETE and the dispatch thread — the reference's StateMachine CAS semantics)."""
        with q.lock:
            if q.state == "CANCELED":
                return False
            q.state = new
            return True

    def _run(self, q: _Query, catalog: Optional[str],
             user: str = "user") -> None:
        try:
            with self._engine_lock.statement_scope(q.sql):
                if not self._set_state(q, "PLANNING"):
                    return  # canceled while queued: never execute
                session = self.engine.create_session(catalog)
                session.user = user
                if not self._set_state(q, "RUNNING"):
                    return
                try:
                    if q.params is not None:
                        res = self.engine.execute_sql(q.sql, session,
                                                      parameters=q.params)
                    else:
                        res = self.engine.execute_sql(q.sql, session)
                finally:
                    # the trace is read from this dispatch thread's slot
                    acct = getattr(self.engine, "_thread_accounting", None)
                    q.trace = getattr(acct, "trace", None)
            if res is None:  # DDL
                columns = [{"name": "result", "type": "boolean"}]
                rows = [[True]]
            else:
                columns = [{"name": n, "type": t.name}
                           for n, t in zip(res.names, res.types)]
                rows = [[_json_value(v) for v in row] for row in res.rows()]
            if self.spool_dir is not None and len(rows) >= self.spool_threshold_rows:
                segments = self._spool_rows(q.query_id, rows)
                rows = []  # spooled results live on disk, not inline
            else:
                segments = None
            with q.lock:
                canceled = q.state == "CANCELED"
                if not canceled:
                    q.segments = segments
                    q.columns = columns
                    q.rows = rows
                    q.state = "FINISHED"
            if canceled and segments:
                self._drop_spool(q.query_id)  # orphaned mid-cancel segments
        except Exception as e:  # noqa: BLE001 - protocol surface reports all failures
            with q.lock:
                if q.state != "CANCELED":
                    q.error = f"{type(e).__name__}: {e}"
                    q.state = "FAILED"
            traceback.print_exc()
        finally:
            q.finished_at = time.time()
            self._evict_finished()

    def _evict_finished(self, keep: int = 100) -> None:
        """Bound coordinator memory: retain only the most recent terminal queries'
        results (reference: QueryTracker expiration)."""
        with self._queries_lock:
            done = [q for q in self.queries.values()
                    if q.state in ("FINISHED", "FAILED", "CANCELED")]
            done.sort(key=lambda q: q.finished_at or 0)
            for q in done[:-keep] if len(done) > keep else []:
                self.queries.pop(q.query_id, None)
                self._drop_spool(q.query_id)

    # -- responses ----------------------------------------------------------------
    def _queued_response(self, q: _Query) -> dict:
        return {
            "id": q.query_id,
            "nextUri": f"{self.url}/v1/statement/executing/{q.query_id}/0",
            "stats": {"state": q.state},
        }

    def _results_response(self, q: _Query, token: int) -> dict:
        if q.state == "FAILED":
            return {"id": q.query_id, "stats": {"state": q.state},
                    "error": {"message": q.error}}
        if q.state == "CANCELED":  # terminal: no nextUri, client stops polling
            return {"id": q.query_id, "stats": {"state": q.state},
                    "error": {"message": "query was canceled"}}
        if q.state not in ("FINISHED",):
            # still running: client re-polls the same token (long-poll analog)
            return {"id": q.query_id, "stats": {"state": q.state},
                    "nextUri": f"{self.url}/v1/statement/executing/{q.query_id}/{token}"}
        if q.segments is not None:
            # spooled protocol: one response carries every segment descriptor;
            # the client fetches payloads straight from the spool URIs
            # (reference: server/protocol/spooling/ — segments of
            # json+zstd/json+lz4; the in-tree codec here is json+zlib)
            return {
                "id": q.query_id,
                "columns": q.columns,
                "segments": [
                    {"uri": f"{self.url}/v1/spooled/{q.query_id}/{i}",
                     "encoding": "json+zlib", "rowCount": seg["rows"],
                     "uncompressedSize": seg["raw_bytes"]}
                    for i, seg in enumerate(q.segments)],
                "stats": {"state": q.state,
                          "totalRows": sum(s["rows"] for s in q.segments)},
            }
        lo = token * DATA_ROWS_PER_FETCH
        hi = lo + DATA_ROWS_PER_FETCH
        out = {
            "id": q.query_id,
            "columns": q.columns,
            "data": q.rows[lo:hi],
            "stats": {"state": q.state, "totalRows": len(q.rows)},
        }
        if hi < len(q.rows):
            out["nextUri"] = (
                f"{self.url}/v1/statement/executing/{q.query_id}/{token + 1}")
        return out

    def _spool_rows(self, query_id: str, rows) -> list:
        """Write result rows as compressed JSON segments; returns descriptors.
        Segment size follows the inline page size so the client's memory
        profile matches the paged path."""
        import os
        import zlib

        d = os.path.join(self.spool_dir, query_id)
        os.makedirs(d, exist_ok=True)
        segments = []
        for i in range(0, max(len(rows), 1), DATA_ROWS_PER_FETCH):
            chunk = rows[i:i + DATA_ROWS_PER_FETCH]
            raw = json.dumps(chunk).encode()
            with open(os.path.join(d, f"seg_{len(segments)}"), "wb") as f:
                f.write(zlib.compress(raw, 1))
            segments.append({"rows": len(chunk), "raw_bytes": len(raw)})
        return segments

    def _read_segment(self, query_id: str, seg: str):
        import os

        if self.spool_dir is None or not seg.isdigit() \
                or query_id not in self.queries:
            return None
        path = os.path.join(self.spool_dir, query_id, f"seg_{int(seg)}")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def _flight_index(self) -> dict:
        """GET /v1/flight: the reference's answer with its recorder off (the
        port has no flight recorder yet)."""
        return {"info": {"enabled": False}, "records": []}

    def _compiles_json(self) -> dict:
        """GET /v1/compiles: the reference's answer with its compile log off
        (the port has no log of kernel builds yet)."""
        return {"info": {"enabled": False}, "records": []}

    def _query_trace(self, qid: str):
        """OTLP/JSON trace for a server query id (the trace captured at
        completion), else a live lookup of an engine query id in the
        engine's tracer."""
        from ..execution.tracing import spans_to_otlp

        q = self.queries.get(qid)
        if q is not None:
            if not q.trace:
                return None
            return spans_to_otlp(q.trace.get("spans", ()))
        spans = self.engine.tracer.spans_for(qid)
        return spans_to_otlp(spans) if spans else None

    def _query_info(self, q: _Query) -> dict:
        return {
            "queryId": q.query_id,
            "state": q.state,
            "query": q.sql,
            "error": q.error,
            "elapsedMs": round(((q.finished_at or time.time()) - q.created_at) * 1000),
        }
