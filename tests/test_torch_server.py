"""The port's coordinator server against the reference's, page for page.

Both packages' ``CoordinatorServer`` run in this process on ephemeral ports,
each over its own engine (TPC-H SF0.01 and a memory catalog).  Every statement
of tests/test_server.py and the HTTP cases of tests/test_security.py goes to
both over the statement protocol, and the raw protocol pages must be equal:
``columns``, ``data`` and the terminal ``stats``, paged past
DATA_ROWS_PER_FETCH rows, spooled segment descriptors and their decompressed
payloads, error messages, DDL and DML results, a cancel, and the HTTP status
codes of authentication.  Query ids and the servers' URLs are the only parts
of a page that may differ.  Pages that only report a statement still
running are not compared (how many a client sees depends on timing).
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request
import zlib

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.server.server import CoordinatorServer as JaxServer
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from trino_tpu_torch.server import Client
from trino_tpu_torch.server import client as torch_client
from trino_tpu_torch.server.server import DATA_ROWS_PER_FETCH
from trino_tpu_torch.server.server import CoordinatorServer as TorchServer

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def engines(tpch_sf001):
    j = JaxEngine()
    j.register_catalog("tpch", tpch_sf001)
    j.register_catalog("memory", JaxMemory())
    t = TorchEngine(device="cpu")
    t.register_catalog("tpch", TorchTpch(sf=0.01))
    t.register_catalog("memory", TorchMemory())
    return j, t


def _start(engines, **kw):
    j, t = engines
    out = (JaxServer(j, port=0, **kw), TorchServer(t, port=0, **kw))
    for s in out:
        s.start()
    return out


@pytest.fixture(scope="module")
def servers(engines):
    pair = _start(engines)
    yield pair
    for s in pair:
        s.stop()


def _get(url, headers=None, method="GET", body=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


def _normalize(page, srv, qid):
    text = json.dumps(page).replace(srv.url, "URL").replace(f'"{qid}"', '"QID"') \
        .replace(f"/{qid}/", "/QID/")
    return json.loads(text)


def _pages(srv, sql, headers=None):
    """Every page of one statement but those that only report it running,
    with its query id and the server's URL replaced; spooled segments with
    their decompressed payloads."""
    h = {"X-Trino-Catalog": "tpch", **(headers or {})}
    out = _get(f"{srv.url}/v1/statement", h, "POST", sql.encode())
    qid = out["id"]
    pages = []
    while True:
        if out.get("columns") is not None or out.get("error") or "data" in out:
            page = _normalize(out, srv, qid)
            for seg, raw in zip(page.get("segments") or (), out.get("segments") or ()):
                req = urllib.request.Request(raw["uri"], headers=headers or {})
                seg["payload"] = json.loads(zlib.decompress(
                    urllib.request.urlopen(req, timeout=60).read()))
            pages.append(page)
        nxt = out.get("nextUri")
        if nxt is None:
            return pages
        if not pages:
            time.sleep(0.01)
        out = _get(nxt, headers)


def _same_pages(pair, sql, headers=None):
    a, b = (_pages(s, sql, headers) for s in pair)
    assert a == b, sql
    return b


# -- tests/test_server.py ------------------------------------------------------------------

STATEMENTS = {
    "roundtrip": "select n_name, n_regionkey from nation where n_regionkey = 3 "
                 "order by n_name",
    "paging": "select o_orderkey from orders order by o_orderkey limit 10000",
    "error": "select * from no_such_table",
    "region_count": "select count(*) c from region",
    "lineitem_count": "select count(*) c from lineitem",
    "flag_sums": "select l_returnflag, sum(l_quantity) q from lineitem "
                 "group by l_returnflag order by l_returnflag",
    "max_price": "select max(l_extendedprice) m from lineitem",
    "custkey_count": "select count(*) c from orders where o_custkey < 100",
    "nation_count": "select count(*) from nation",
    "one": "select 1 as one from region limit 1",
    # the column kinds the port's results decode to: dates, decimals as
    # doubles, NaN and infinities, timestamps, arrays and maps, wide sums
    "kinds": "select o_orderdate, o_totalprice, o_orderstatus from orders "
             "order by o_orderkey limit 5",
    "special_doubles": "select nan() x, infinity() y, -infinity() z, "
                       "cast(null as double) w from region limit 1",
    "timestamp": "select timestamp '2024-03-15 10:30:45.123456' ts, "
                 "date '2024-01-02' d, cast(1.5 as decimal(10,2)) dd from region limit 1",
    "array_map": "select array[1, 2, 3] a, map(array['a'], array[1]) m from region limit 1",
    "show_catalogs": "show catalogs",
    "show_columns": "show columns from lineitem",
    "show_stats": "show stats for orders",
    "explain": "explain select o_orderpriority, count(*) from orders "
               "group by o_orderpriority",
    "system_catalogs": "select catalog_name, connector_name from system.catalogs order by 1",
}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_protocol_pages_equal_the_reference(servers, name):
    pages = _same_pages(servers, STATEMENTS[name])
    if name == "paging":
        assert len(pages) == -(-10000 // DATA_ROWS_PER_FETCH)
        assert sum(len(p["data"]) for p in pages) == 10000
    if name == "error":
        assert "no_such_table" in pages[-1]["error"]["message"]


def test_wide_decimal_sum_is_sent_as_its_exact_text(servers):
    """An exact decimal sum past 2^63 (a python ``Decimal`` in the result):
    the port sends its exact text; the reference's JSON encoder raises on it
    and drops the connection (ROADMAP C, reference gaps)."""
    sql = "select sum(cast(9000000000000000000 as decimal(38,0))) s from nation"
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        _pages(servers[0], sql)
    assert _pages(servers[1], sql)[-1]["data"] == [["225000000000000000000"]]


def test_protocol_roundtrip(servers):
    c = Client(servers[1].url, catalog="tpch")
    r = c.execute(STATEMENTS["roundtrip"])
    assert r.column_names == ["n_name", "n_regionkey"]
    assert [row[0] for row in r.rows] == ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA",
                                         "UNITED KINGDOM"]
    with pytest.raises(torch_client.QueryError, match="no_such_table"):
        c.execute(STATEMENTS["error"])


def test_protocol_ddl(servers):
    """DDL and DML over the protocol: each page equal to the reference's."""
    h = {"X-Trino-Catalog": "memory"}
    for sql in ("create table srv_t (a bigint)", "insert into srv_t values (41), (42)",
                "select max(a) m from srv_t", "delete from srv_t where a = 41",
                "select count(*) c from srv_t", "drop table srv_t"):
        pages = [_pages(s, sql, h) for s in servers]
        assert pages[0] == pages[1], sql
    assert pages[1][0]["data"] == [[True]]


def test_protocol_parameters(servers):
    sql = "select count(*) c from customer where c_mktsegment = ? and c_custkey < ?"
    h = {"X-Trino-Execute-Parameters": json.dumps(["BUILDING", 500])}
    pages = _same_pages(servers, sql, h)
    assert pages[-1]["data"][0][0] > 0


def test_query_info_and_trace(servers):
    infos = []
    for srv in servers:
        out = _get(f"{srv.url}/v1/statement", {"X-Trino-Catalog": "tpch"}, "POST",
                   b"select count(*) from part")
        while out.get("nextUri"):
            time.sleep(0.01)
            out = _get(out["nextUri"])
        info = _get(f"{srv.url}/v1/query/{out['id']}")
        assert "elapsedMs" in info
        infos.append({k: v for k, v in info.items() if k not in ("queryId", "elapsedMs")})
    assert infos[0] == infos[1] and infos[1]["state"] == "FINISHED"
    trace = _get(f"{servers[1].url}/v1/query/{out['id']}/trace")
    names = {s["name"] for s in trace["resourceSpans"][0]["scopeSpans"][0]["spans"]}
    assert {"query", "planner", "execution"} <= names


def _statement_held(srv, sql):
    """Submit ``sql`` while a writer holds the statement gate, so it cannot
    start; returns its query id."""
    srv._engine_lock.acquire_exclusive()
    try:
        return _get(f"{srv.url}/v1/statement", {"X-Trino-Catalog": "tpch"}, "POST",
                    sql.encode())["id"]
    except BaseException:
        srv._engine_lock.release_exclusive()
        raise


def test_cancel_terminal(servers):
    """A statement canceled before it starts never runs, and its page is
    terminal (no nextUri), equal to the reference's."""
    pages = []
    for srv in servers:
        qid = _statement_held(srv, "select count(*) from lineitem, orders "
                                   "where l_orderkey = o_orderkey")
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{srv.url}/v1/statement/{qid}", method="DELETE"), timeout=30)
        finally:
            srv._engine_lock.release_exclusive()
        q = srv.queries[qid]
        for _ in range(200):
            if q.finished_at is not None:
                break
            time.sleep(0.01)
        assert q.state == "CANCELED"
        body = _get(f"{srv.url}/v1/statement/executing/{qid}/0")
        assert "nextUri" not in body
        pages.append(_normalize(body, srv, qid))
    assert pages[0] == pages[1]


def test_spooled_result_protocol(engines, tmp_path):
    pair = _start(engines, spool_dir=str(tmp_path / "spool"), spool_threshold_rows=100)
    try:
        pages = _same_pages(pair, "select c_custkey from customer order by c_custkey")
        segs = pages[-1]["segments"]
        assert segs and segs[0]["encoding"] == "json+zlib"
        assert sum(s["rowCount"] for s in segs) == 1500
        assert [r[0] for r in segs[0]["payload"][:3]] == [1, 2, 3]
        # small results stay inline
        assert _same_pages(pair, "select count(*) c from region")[-1]["data"] == [[5]]
        res = Client(pair[1].url, catalog="tpch").execute(
            "select c_custkey from customer order by c_custkey")
        assert len(res.rows) == 1500
    finally:
        for s in pair:
            s.stop()


def test_ui_spa_and_json_api(servers):
    srv = servers[1]
    Client(srv.url, catalog="tpch").execute("select count(*) c from region")
    shells = [urllib.request.urlopen(f"{s.url}/ui", timeout=10).read() for s in servers]
    assert shells[0] == shells[1]
    over = _get(f"{srv.url}/ui/api/overview")
    assert "tpch" in over["catalogs"]
    assert over["queries"] and over["queries"][0]["state"] == "FINISHED"
    qid = over["queries"][0]["query_id"]
    det = _get(f"{srv.url}/ui/api/query/{qid}")
    assert det["sql"] == "select count(*) c from region"
    assert det["state"] == "FINISHED" and det["rows"] == 1
    assert "Aggregate" in det.get("plan", "") or "Values" in det.get("plan", "")
    page = urllib.request.urlopen(f"{srv.url}/ui/query/{qid}", timeout=30).read().decode()
    assert "select count(*) c from region" in page
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{srv.url}/ui/api/query/nope", timeout=10)


def test_concurrent_queries_share_the_engine_safely(servers):
    queries = [STATEMENTS[k] for k in ("lineitem_count", "flag_sums", "max_price",
                                       "custkey_count")]
    c = Client(servers[1].url, catalog="tpch")
    expected = [c.execute(q).rows for q in queries]
    results = [None] * len(queries) * 3
    errors = []

    def run(i, q):
        try:
            results[i] = Client(servers[1].url, catalog="tpch").execute(q).rows
        except Exception as e:  # noqa: BLE001 - reported by the assertion
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k * len(queries) + j, q))
               for k in range(3) for j, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert results == expected * 3


def test_metrics_exposes_device_boundary_counters(servers):
    srv = servers[1]
    Client(srv.url, catalog="tpch").execute("select count(*) from nation")
    body = urllib.request.urlopen(srv.url + "/v1/metrics").read().decode()
    for metric in ("trino_tpu_device_dispatches_total", "trino_tpu_host_transfers_total",
                   "trino_tpu_host_bytes_pulled_total"):
        lines = [x for x in body.splitlines()
                 if x.startswith(metric) and not x.startswith("# ")]
        assert lines and float(lines[0].split()[-1]) > 0, metric
    for family in ("trino_tpu_queries_total", "trino_tpu_queries_by_state",
                   "trino_tpu_dispatch_latency_seconds_count",
                   "trino_tpu_memory_reserved_bytes", "trino_tpu_resource_group_running"):
        assert family in body
    status = _get(srv.url + "/v1/status")
    assert status["health"]["status"] == "ok" and status["device_memory"] is None
    assert status["memory"][0]["pool"] == "pool0"


def test_disabled_services_answer_as_the_reference(servers):
    """The observability services answer with the reference's payloads:
    plan history, the flight recorder and the compile log are ported, and
    their payloads have the reference's keys."""
    for path in ("/v1/flight", "/v1/compiles", "/v1/history", "/v1/info"):
        got = [_get(s.url + path) for s in servers]
        if path == "/v1/history":
            assert set(got[1]) == set(got[0]) == {"max_plans", "misestimates_total",
                                                  "worst", "plans"}
            assert got[1]["max_plans"] == got[0]["max_plans"]
        elif path == "/v1/info":
            assert got[1] == got[0]
        else:
            assert set(got[1]) == set(got[0]) == {"info", "records"}
            assert set(got[1]["info"]) == set(got[0]["info"])
            assert got[1]["info"]["enabled"] == got[0]["info"]["enabled"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{servers[1].url}/v1/flight/nope", timeout=10)
    assert exc.value.code == 404


def test_cli_formatting_and_local_engine(capsys):
    from trino_tpu_torch.server.cli import format_aligned, main

    out = format_aligned(["a", "bb"], [[1, None], [22, "x"]])
    assert out.split("\n")[0].split(" | ")[0].strip() == "a"
    assert "NULL" in out and "(2 rows)" in out
    assert main(["--device", "cpu", "--sf", "0.01", "-e",
                 "select count(*) c from region"]) == 0
    printed = capsys.readouterr().out
    assert printed.split("\n")[2].strip() == "5" and "(1 row)" in printed


def test_dbapi_over_http(servers):
    """The DB-API over the protocol (the reference's cursor calls the
    client result's column names and rows as methods, and raises)."""
    from trino_tpu.server import dbapi as jax_dbapi
    from trino_tpu_torch.server import dbapi

    with pytest.raises(TypeError):
        jax_dbapi.connect(url=servers[0].url, catalog="tpch").cursor().execute(
            "select count(*) from region")
    cur = dbapi.connect(url=servers[1].url, catalog="tpch").cursor()
    cur.execute("select count(*) from orders where o_orderpriority = ? and o_orderkey > ?",
                ("1-URGENT", 100))
    n = cur.fetchone()[0]
    cur.execute("select count(*) from orders where o_orderpriority = '1-URGENT' "
                "and o_orderkey > 100")
    assert cur.fetchone()[0] == n > 0


# -- tests/test_security.py, the HTTP cases ------------------------------------------------


def _status(url, headers=None, method="GET", body=None):
    try:
        urllib.request.urlopen(urllib.request.Request(url, data=body, method=method,
                                                      headers=headers or {}), timeout=30)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def test_http_auth_and_metrics(engines):
    pair = _start(engines, passwords={"ana": "pw1"})
    cred = {"Authorization": "Basic " + base64.b64encode(b"ana:pw1").decode()}
    wrong = {"Authorization": "Basic " + base64.b64encode(b"ana:nope").decode()}
    try:
        codes = []
        for s in pair:
            codes.append([
                _status(f"{s.url}/v1/statement", method="POST", body=b"select 1"),
                _status(f"{s.url}/v1/statement", wrong, "POST", b"select 1"),
                _status(f"{s.url}/v1/statement", {**cred, "X-Trino-User": "bob"}, "POST",
                        b"select 1"),
                _status(f"{s.url}/v1/metrics"),
                _status(f"{s.url}/v1/metrics", cred),
                _status(f"{s.url}/ui", cred)])
        assert codes[0] == codes[1] == [401, 401, 401, 401, 200, 200]
        pages = _same_pages(pair, "select count(*) c from region",
                            {**cred, "X-Trino-User": "ana"})
        assert pages[-1]["data"] == [[5]]
        body = urllib.request.urlopen(urllib.request.Request(
            f"{pair[1].url}/v1/metrics", headers=cred), timeout=5).read().decode()
        assert "trino_tpu_queries_total" in body
        html = urllib.request.urlopen(urllib.request.Request(
            f"{pair[1].url}/ui", headers=cred), timeout=5).read().decode()
        assert "<h1>trino-tpu</h1>" in html
    finally:
        for s in pair:
            s.stop()


def test_client_basic_auth(engines, tmp_path):
    pair = _start(engines, passwords={"ana": "pw1"},
                  spool_dir=str(tmp_path / "segments"), spool_threshold_rows=1)
    try:
        c = Client(pair[1].url, catalog="tpch", user="ana", password="pw1")
        assert len(c.execute("select n_name from nation order by n_name limit 3").rows) == 3
        bad = Client(pair[1].url, catalog="tpch", user="ana", password="nope")
        with pytest.raises(Exception):
            bad.execute("select 1")
        # another principal may not read a query's results
        cred = {"Authorization": "Basic " + base64.b64encode(b"ana:pw1").decode()}
        pages = _same_pages(pair, "select n_name from nation order by n_name limit 3",
                            {**cred, "X-Trino-User": "ana"})
        assert pages[-1]["segments"][0]["payload"][0] == ["ALGERIA"]
    finally:
        for s in pair:
            s.stop()


def test_unfetched_results_outlive_newer_statements(engines, monkeypatch):
    """A finished statement whose client has not fetched its last response
    keeps its results while more than the retained number of newer
    statements finish (many clients, one of them slow to read); once read,
    it is dropped like any other.  The reference drops it, and the slow
    client's next poll gets a 404."""
    from trino_tpu_torch.server import server as S

    _, t = engines
    srv = TorchServer(t, port=0)
    srv.start()
    try:
        keep = 5
        monkeypatch.setattr(srv, "_evict_finished",
                            lambda keep=keep, f=srv._evict_finished: f(keep))
        slow = _get(srv.url + "/v1/statement", method="POST",
                    body=b"select n_name from nation where n_nationkey = 3")
        qid = slow["id"]
        deadline = time.time() + 30
        while srv.queries[qid].state != "FINISHED" and time.time() < deadline:
            time.sleep(0.005)
        c = Client(srv.url, catalog="tpch", poll_interval=0.002)
        for k in range(2 * keep):
            assert c.execute(f"select {k} x").rows == [[k]]
        assert qid in srv.queries
        page = _get(slow["nextUri"])
        assert page["data"] == [["CANADA"]] and "nextUri" not in page
        for k in range(2 * keep):
            c.execute(f"select {k} x")
        assert qid not in srv.queries
        assert S.UNFETCHED_KEEP_S > 0
    finally:
        srv.stop()


def test_many_clients_connect_at_once():
    """32 clients connect while the accept loop is busy: every connect is
    taken at once.  With the standard library's backlog of 5 (the
    reference's) the connects past it wait for a retry a second later."""
    import socket

    from trino_tpu_torch.server.server import _HTTPServer

    httpd = _HTTPServer(("127.0.0.1", 0), object)  # never accepts: no serve loop
    socks = []
    try:
        for _ in range(32):
            s = socket.socket()
            s.settimeout(0.5)
            s.connect(httpd.server_address)
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
