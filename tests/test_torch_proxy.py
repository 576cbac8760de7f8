"""The port's HTTP proxy (``trino_tpu_torch/server/proxy.py``) in front of
the port's coordinator, against the reference's proxy in front of the
reference's, on the CPU.

Restates tests/test_proxy.py: a statement through the proxy gives the
reference's rows through its proxy, and every URI in a paging response
stays on the proxy's host; a proxy whose backend is down answers 502, as
the reference's does.
"""

import json
import urllib.error
import urllib.request

import pytest

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.server.client import Client as JaxClient
from trino_tpu.server.proxy import ProxyServer as JaxProxy
from trino_tpu.server.server import CoordinatorServer as JaxServer
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.server import Client, CoordinatorServer
from trino_tpu_torch.server.proxy import ProxyServer

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def proxied():
    out = {}
    for pkg, eng, tpch, srv_cls, proxy_cls in (
            ("jax", JaxEngine(), JaxTpch, JaxServer, JaxProxy),
            ("torch", Engine(device="cpu"), TpchConnector, CoordinatorServer,
             ProxyServer)):
        eng.register_catalog("tpch", tpch(sf=0.01))
        srv = srv_cls(eng, port=0)
        srv.start()
        proxy = proxy_cls(srv.url)
        out[pkg] = (srv, proxy, proxy.start())
    yield out
    for srv, proxy, _ in out.values():
        proxy.stop()
        srv.stop()


def _next_uri(purl):
    body = "select l_orderkey from lineitem limit 5".encode()
    req = urllib.request.Request(f"{purl}/v1/statement", data=body, method="POST",
                                 headers={"X-Trino-User": "user"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read()).get("nextUri")


def test_query_through_proxy_rewrites_uris(proxied):
    got = {}
    for pkg, client in (("jax", JaxClient), ("torch", Client)):
        _srv, _proxy, purl = proxied[pkg]
        got[pkg] = client(purl, catalog="tpch").execute(
            "select count(*) c from lineitem").rows
        uri = _next_uri(purl)
        assert uri is None or uri.startswith(purl), uri
    assert got["torch"] == got["jax"] and got["torch"][0][0] > 0


@pytest.mark.parametrize("proxy_cls", [ProxyServer, JaxProxy], ids=["torch", "jax"])
def test_proxy_backend_down_returns_502(proxy_cls):
    proxy = proxy_cls("http://127.0.0.1:1")  # nothing listens there
    purl = proxy.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{purl}/v1/info", timeout=10)
        assert err.value.code == 502
    finally:
        proxy.stop()
