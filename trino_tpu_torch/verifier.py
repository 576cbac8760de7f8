"""Query verifier: replay a query corpus against two engines and diff results.

Reference: service/trino-verifier (verifier/Verifier.java:56) — replays logged
queries against a control and a test cluster and reports mismatches; used to
qualify releases.  Here the control can be another Engine configuration (e.g.
local vs distributed vs fault-tolerant execution of the same catalogs), or any
callable returning rows.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

__all__ = ["VerifierQuery", "VerifierResult", "Verifier"]


@dataclasses.dataclass(frozen=True)
class VerifierQuery:
    name: str
    sql: str


@dataclasses.dataclass
class VerifierResult:
    name: str
    status: str  # MATCH | MISMATCH | CONTROL_FAILED | TEST_FAILED
    detail: str = ""
    control_wall_s: float = 0.0
    test_wall_s: float = 0.0


def _normalize(rows, sort: bool) -> list:
    out = []
    for row in rows:
        norm = []
        for v in row:
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float):
                if math.isnan(v):
                    v = "NaN"
                else:
                    v = round(v, 9)
            norm.append(v)
        out.append(tuple(norm))
    if sort:
        out.sort(key=lambda r: tuple((x is None, str(x)) for x in r))
    return out


class Verifier:
    """control/test: callables sql -> rows (e.g. lambda q: engine.execute_sql(q).rows()).

    ``ordered`` treats result order as significant (queries with ORDER BY);
    unordered comparison sorts both sides first (reference: the verifier's
    determinism analysis deciding row-order sensitivity)."""

    def __init__(self, control: Callable, test: Callable):
        self.control = control
        self.test = test

    def run(self, queries: Sequence[VerifierQuery],
            ordered: Optional[Callable[[VerifierQuery], bool]] = None
            ) -> list[VerifierResult]:
        if ordered is None:
            ordered = lambda q: "order by" in q.sql.lower()
        results = []
        for q in queries:
            t0 = time.perf_counter()
            try:
                control_rows = self.control(q.sql)
            except Exception as e:
                results.append(VerifierResult(q.name, "CONTROL_FAILED", str(e)[:200]))
                continue
            t1 = time.perf_counter()
            try:
                test_rows = self.test(q.sql)
            except Exception as e:
                results.append(VerifierResult(q.name, "TEST_FAILED", str(e)[:200],
                                              t1 - t0))
                continue
            t2 = time.perf_counter()
            keep_order = ordered(q)
            c = _normalize(control_rows, sort=not keep_order)
            t = _normalize(test_rows, sort=not keep_order)
            if c == t:
                results.append(VerifierResult(q.name, "MATCH", "", t1 - t0, t2 - t1))
            else:
                detail = f"control {len(c)} rows vs test {len(t)} rows"
                for i, (cr, tr) in enumerate(zip(c, t)):
                    if cr != tr:
                        detail = f"first diff at row {i}: {cr!r} != {tr!r}"
                        break
                results.append(VerifierResult(q.name, "MISMATCH", detail,
                                              t1 - t0, t2 - t1))
        return results

    @staticmethod
    def report(results: Sequence[VerifierResult]) -> str:
        lines = []
        counts: dict = {}
        for r in results:
            counts[r.status] = counts.get(r.status, 0) + 1
            mark = "ok " if r.status == "MATCH" else "!! "
            lines.append(f"{mark}{r.name:<24} {r.status:<14} "
                         f"ctl {r.control_wall_s * 1000:7.1f}ms "
                         f"tst {r.test_wall_s * 1000:7.1f}ms  {r.detail}")
        lines.append(" | ".join(f"{k}={v}" for k, v in sorted(counts.items())))
        return "\n".join(lines)
