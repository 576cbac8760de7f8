"""HTTP proxy in front of a coordinator (the trino-proxy analog).

Reference: core/trino-proxy — ProxyResource forwards /v1/statement and
follow-up URIs to the backing coordinator and REWRITES every URI in the
response so the client keeps talking through the proxy (the proxy is the
only address clients ever see; useful for TLS termination / network
segmentation in front of the cluster)."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["ProxyServer"]

_HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding", "host",
                "content-length"}


class ProxyServer:
    def __init__(self, coordinator_url: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.backend = coordinator_url.rstrip("/")
        self.host, self.port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _rewrite(self, obj):
        """Every URI pointing at the backend re-roots onto the proxy (the
        reference rewrites nextUri/infoUri/partialCancelUri the same way)."""
        if isinstance(obj, dict):
            return {k: self._rewrite(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self._rewrite(v) for v in obj]
        if isinstance(obj, str) and obj.startswith(self.backend):
            return self.url + obj[len(self.backend):]
        return obj

    def start(self) -> str:
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _forward(self, method: str):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else None
                req = urllib.request.Request(
                    proxy.backend + self.path, data=body, method=method)
                for k, v in self.headers.items():
                    if k.lower() not in _HOP_HEADERS:
                        req.add_header(k, v)
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        payload = r.read()
                        code = r.status
                        ctype = r.headers.get("Content-Type", "")
                except urllib.error.HTTPError as e:
                    payload, code = e.read(), e.code
                    ctype = e.headers.get("Content-Type", "")
                except Exception as e:
                    payload = json.dumps(
                        {"error": f"proxy: backend unreachable: {e}"}).encode()
                    code, ctype = 502, "application/json"
                if ctype.startswith("application/json"):
                    try:
                        payload = json.dumps(
                            proxy._rewrite(json.loads(payload))).encode()
                    except ValueError:
                        pass  # non-JSON body despite the header: pass through
                self.send_response(code)
                self.send_header("Content-Type", ctype or "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._forward("GET")

            def do_POST(self):
                self._forward("POST")

            def do_DELETE(self):
                self._forward("DELETE")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self.url

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
