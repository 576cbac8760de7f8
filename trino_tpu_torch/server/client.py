"""Python client for the statement protocol.

Reference: client/trino-client StatementClientV1 — POST /v1/statement, then follow
``nextUri`` until absent, accumulating data pages (StatementClientV1.java:160,403).
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Optional

__all__ = ["Client", "ClientResult", "QueryError"]


class QueryError(RuntimeError):
    pass


@dataclasses.dataclass
class ClientResult:
    columns: list  # [{name, type}]
    rows: list

    @property
    def column_names(self):
        return [c["name"] for c in self.columns]

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.rows, columns=self.column_names)


class Client:
    def __init__(self, base_url: str, catalog: Optional[str] = None,
                 user: str = "user", password: Optional[str] = None,
                 poll_interval: float = 0.05):
        self.base_url = base_url.rstrip("/")
        self.catalog = catalog
        self.user = user
        self.poll_interval = poll_interval
        # Basic credentials (reference: client BasicAuthInterceptor attaching
        # Authorization on every request, including segment fetches)
        self._auth = None
        if password is not None:
            import base64

            token = base64.b64encode(f"{user}:{password}".encode()).decode()
            self._auth = f"Basic {token}"

    def _headers(self, catalog: bool = True) -> dict:
        headers = {"X-Trino-User": self.user}
        if catalog and self.catalog:
            headers["X-Trino-Catalog"] = self.catalog
        if self._auth:
            headers["Authorization"] = self._auth
        return headers

    def _request(self, url: str, method: str = "GET", body: bytes = None,
                 extra_headers: Optional[dict] = None) -> dict:
        headers = self._headers()
        if extra_headers:
            headers.update(extra_headers)
        req = urllib.request.Request(url, data=body, method=method, headers=headers)
        with urllib.request.urlopen(req) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    def execute(self, sql: str, timeout: float = 600.0,
                params: Optional[list] = None) -> ClientResult:
        """``params``: protocol-level EXECUTE — ``sql`` is a parameterized
        statement with ``?`` markers; the values ride the
        X-Trino-Execute-Parameters header as JSON and bind server-side
        (through the engine's plan-template path when one exists)."""
        extra = None
        if params is not None:
            extra = {"X-Trino-Execute-Parameters": json.dumps(params)}
        out = self._request(f"{self.base_url}/v1/statement", "POST",
                            sql.encode(), extra_headers=extra)
        columns, rows = None, []
        deadline = time.time() + timeout
        while True:
            if "error" in out and out["error"]:
                raise QueryError(out["error"].get("message", str(out["error"])))
            if out.get("columns"):
                columns = out["columns"]
            rows.extend(out.get("data") or [])
            for seg in out.get("segments") or ():
                # spooled protocol: fetch the segment payload by URI
                # (reference: OkHttpSegmentLoader following spooled segments)
                rows.extend(self._fetch_segment(seg))
            nxt = out.get("nextUri")
            if nxt is None:
                break
            if time.time() > deadline:
                raise TimeoutError(f"query timed out after {timeout}s")
            state = (out.get("stats") or {}).get("state")
            if state in ("QUEUED", "PLANNING", "RUNNING"):
                time.sleep(self.poll_interval)
            out = self._request(nxt)
        return ClientResult(columns or [], rows)

    def _fetch_segment(self, seg: dict) -> list:
        import zlib

        req = urllib.request.Request(seg["uri"],
                                     headers=self._headers(catalog=False))
        with urllib.request.urlopen(req) as resp:
            data = resp.read()
        if seg.get("encoding") == "json+zlib":
            data = zlib.decompress(data)
        return json.loads(data)

    def cancel(self, query_id: str) -> None:
        self._request(f"{self.base_url}/v1/statement/{query_id}", "DELETE")
