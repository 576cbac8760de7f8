"""Plan-actuals history: persistent est-vs-actual cardinality records per
plan node (counterpart of ``trino_tpu/execution/history.py``, copied; the
one batched read of the row counters reads 0-d torch tensors).

Reference: the reference engine's PlanOptimizersStatsCollector +
QueryPlanOptimizerStatistics keep per-rule effectiveness counters, and TQP
(arxiv 2203.01877) selects tensor strategies from RUNTIME shapes — adaptive
execution (ROADMAP item 5) needs the same input here: what did each plan node
*actually* produce, against what the CBO promised.  Until this round that
record lived exactly once, in a released executor's ``stats`` dict, and died
with it.

``PlanHistoryStore`` is a bounded, thread-safe map from the STRUCTURAL plan
fingerprint (exec/local_executor._plan_fingerprint — content-based and
plan-version-embedding, the same identity the result cache keys on) to
per-node records keyed by stable structural node paths.  Records merge across
pooled executors, across warm re-executions of a cached plan, and across the
cluster harvest (worker task snapshots ship fragment-relative records; the
coordinator re-anchors them at the fragment root's full-plan path).

Node addressing: ``id(plan-node)`` is process-local and executor ``_op_label``
ordinals are execution-order, so neither merges.  ``plan_node_paths`` assigns
``"<Op>#<chain>"`` — the site-label "<Op>#<k>" shape with a position that is a
pure function of plan STRUCTURE: the chain is the child-index walk from the
root ("0" = root, "0.2.1" = root's third child's second child).  Chains
COMPOSE under subtree re-anchoring (``translate_path``), which is what lets a
worker fragment's relative records fold into the full plan's addresses —
fragment plans substitute spooled children with RemoteSource leaves but keep
child positions, so the chains align.

Feeding invariant (held by tests/test_torch_plan_history.py with the store
enabled): history appends ONLY on clean completion, from actuals the
executor already computed — blocking-operator row counts, spill byte/tier
counts, cache hits.  Zero new kernel launches, zero ``_host`` reads; the
only device interaction is one batched value read of already-computed row
counters at collection time (the same lazy materialization EXPLAIN ANALYZE
does when formatting).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional

__all__ = ["PlanHistoryStore", "plan_node_paths", "estimate_plan_rows",
           "collect_plan_actuals", "fold_records", "translate_path",
           "misestimate", "short_fingerprint", "MISESTIMATE_THRESHOLD"]

# a node is counted "misestimated" (metrics counter, EXPLAIN ANALYZE summary)
# past this over/under factor — 2x matches the point where the reference's
# DetermineJoinDistributionType-class decisions start flipping
MISESTIMATE_THRESHOLD = 2.0

EWMA_ALPHA = 0.25  # weight of the LATEST actual in the running estimate

_AGG_DEFAULT_COEFFICIENT = 0.1  # GROUP BY keys with no NDV estimate


def short_fingerprint(fingerprint: str) -> str:
    """16-hex digest of a structural plan fingerprint — the join key the
    system table / HTTP surfaces expose (full fingerprints are multi-KB plan
    prints)."""
    return hashlib.blake2b(fingerprint.encode(), digest_size=8).hexdigest()


def misestimate(est: float, actual: float) -> tuple:
    """(ratio >= 1.0, "over"|"under"|"exact") for one est-vs-actual pair.
    "over" = the CBO promised MORE rows than arrived (over-estimate)."""
    est = float(est)
    actual = float(actual)
    hi, lo = (est, actual) if est >= actual else (actual, est)
    ratio = hi / max(lo, 1.0)
    if ratio <= 1.0:
        return 1.0, "exact"
    return ratio, ("over" if est > actual else "under")


# ---------------------------------------------------------------- node paths
def plan_node_paths(root) -> dict:
    """{id(node): "<Op>#<chain>"} over a plan tree (pre-order; a shared
    subtree object keeps its first — leftmost — address)."""
    out: dict = {}

    def walk(n, chain):
        if id(n) in out:
            return
        out[id(n)] = f"{type(n).__name__}#{chain}"
        for i, c in enumerate(n.children):
            walk(c, f"{chain}.{i}")

    walk(root, "0")
    return out


def translate_path(rel_path: str, root_chain: str) -> str:
    """Re-anchor a fragment-relative node path at the fragment root's
    full-plan chain: relative "Filter#0.1" under a root whose full chain is
    "0.2" becomes "Filter#0.2.1" (chains compose by construction)."""
    op, _, chain = rel_path.partition("#")
    return f"{op}#{root_chain}{chain[1:]}"


# ---------------------------------------------------------------- estimation
def estimate_plan_rows(root, catalogs: dict) -> dict:
    """{id(node): estimated output rows or None} — the CBO's per-node
    arithmetic (sql/stats.py) re-run over the PHYSICAL plan, so every node
    the executor records actuals for has an estimate to compare against.
    Joins prefer the estimate the planner already stamped (``est_rows``).
    Unknown inputs (stat-less connectors, unnest expansion, remote sources)
    yield None, never a fabricated number — a record without an estimate
    cannot produce a bogus misestimate ratio.  Host-only walk: connector
    stats surfaces, no device work."""
    from ..spi.statistics import connector_table_stats
    from ..sql import ir
    from ..sql import plan as P
    from ..sql import stats as S

    ests: dict = {}

    def note(n, rel):
        if isinstance(n, P.Join) and n.est_rows is not None:
            ests[id(n)] = float(n.est_rows)
        elif rel is not None and rel.known:
            ests[id(n)] = float(rel.rows)
        else:
            ests.setdefault(id(n), None)
        return rel

    def unknown(n):
        return S.unknown_stats(len(n.schema.fields))

    def walk(n):
        if isinstance(n, P.TableScan):
            conn = catalogs.get(n.catalog)
            try:
                ts = connector_table_stats(conn, n.table) \
                    if conn is not None else None
            except Exception:
                ts = None
            if ts is None or ts.row_count is None:
                return note(n, unknown(n))
            return note(n, S.scan_stats(ts, n.columns))
        if isinstance(n, P.Filter):
            child = walk(n.child)
            try:
                sel = S.filter_selectivity(n.predicate, child)
            except Exception:
                sel = S.UNKNOWN_FILTER_COEFFICIENT
            return note(n, child.scaled(sel))
        if isinstance(n, P.Project):
            child = walk(n.child)
            cols = [child.col(e.index) if isinstance(e, ir.FieldRef) else None
                    for e in n.exprs]
            return note(n, S.RelStats(child.rows, cols, child.base_rows,
                                      child.known))
        if isinstance(n, P.Aggregate):
            child = walk(n.child)
            ncols = len(n.schema.fields)
            if not n.keys:
                return note(n, S.RelStats(1.0, [None] * ncols,
                                          known=child.known))
            rows = 1.0
            for k in n.keys:
                ndv = child.col(k).ndv
                rows *= ndv if ndv else \
                    max(child.rows * _AGG_DEFAULT_COEFFICIENT, 1.0)
            rows = max(min(rows, child.rows), 1.0)
            cols = [child.col(k) for k in n.keys] \
                + [None] * (ncols - len(n.keys))
            return note(n, S.RelStats(rows, cols, known=child.known))
        if isinstance(n, P.Join):
            left, right = walk(n.left), walk(n.right)
            try:
                rel = S.join_stats(left, right, n.left_keys, n.right_keys)
            except Exception:
                rel = S.unknown_stats(len(n.schema.fields))
            if n.kind in ("semi", "anti"):
                rel = S.RelStats(min(rel.rows, left.rows), list(left.cols),
                                 known=rel.known)
            if n.est_rows is not None:
                rel = S.RelStats(float(n.est_rows), list(rel.cols),
                                 known=True)
            return note(n, rel)
        if isinstance(n, P.Limit):
            child = walk(n.child)
            return note(n, S.RelStats(min(child.rows, float(n.count)),
                                      list(child.cols), child.base_rows,
                                      child.known))
        if isinstance(n, P.Union):
            rels = [walk(c) for c in n.inputs]
            rows = sum(r.rows for r in rels)
            return note(n, S.RelStats(rows, list(rels[0].cols) if rels
                                      else [], known=all(r.known
                                                         for r in rels)))
        if isinstance(n, P.Values):
            return note(n, S.RelStats(float(len(n.rows)),
                                      [None] * len(n.schema.fields)))
        if isinstance(n, (P.Sort, P.Output, P.Exchange)):
            return note(n, walk(n.children[0]))
        if isinstance(n, P.Window):
            child = walk(n.child)
            cols = list(child.cols) + [None] * len(n.specs)
            return note(n, S.RelStats(child.rows, cols, child.base_rows,
                                      child.known))
        # Unnest / MatchRecognize / RemoteSource / future nodes: walk the
        # children for THEIR estimates, report this node unknown
        for c in n.children:
            walk(c)
        return note(n, unknown(n))

    try:
        walk(root)
    except Exception:
        pass  # estimation is advisory: a walk failure yields fewer estimates
    return ests


# ----------------------------------------------------------------- collection
def collect_plan_actuals(plan, stats: dict, boundary: Optional[dict] = None,
                         catalogs: Optional[dict] = None,
                         paths: Optional[dict] = None,
                         ests: Optional[dict] = None,
                         facts: Optional[dict] = None) -> dict:
    """{node_path: one-execution record} from an executor's per-node
    ``stats`` (id(node)-keyed) after a clean completion.  ``paths``/``ests``
    are the maps the executor stamped at ``begin_plan`` time (recomputed here
    only when a driver skipped begin_plan).  Row counts may still live on
    device (the executor defers the sync); they are fetched in ONE batched
    value read — no new dispatches, no ``_host``-counted pulls.

    Each record carries an ``unestimated`` marker — True when the CBO had NO
    estimate for the node — so a consumer (the adaptive advisor) can tell
    "CBO was wrong" from "CBO was blind" and never fabricate a correction
    from a blind node.

    ``facts`` is the executor's compile-time advisory map
    ({id(node): (node, fact)} — scan split counts, join build-side row
    counts): nodes the streaming stats never record get SYNTHESIZED records
    here.  Scan facts carry ``splits`` with ``est_rows=None`` (a splits-only
    fact has no output-row observation — a real estimate against a zero
    actual would fabricate a misestimate); build facts carry the measured
    build rows against the node's real estimate plus a ``build`` marker, the
    input the broadcast-vs-partitioned decision needs."""
    if not stats and not facts:
        return {}
    if not paths:
        paths = plan_node_paths(plan)
    if ests is None:
        ests = estimate_plan_rows(plan, catalogs or {}) \
            if catalogs is not None else {}
    boundary = boundary or {}
    pending: list = []  # (path, record, raw rows value)
    for nid, s in (stats or {}).items():
        # the CURRENT plan's path map is the authority: a pooled executor's
        # stats can hold residue from other plans/fragments (only execute()
        # resets; task bodies pop only their own subtree), and a stale
        # entry's registration-time s["path"] would fold another plan's rows
        # into this record — skip anything the map doesn't know
        path = paths.get(nid)
        if path is None:
            continue  # stale entry from another plan on a shared executor
        est = s.get("est_rows", ests.get(nid))
        b = boundary.get(nid) or {}
        rec = {
            "op": s.get("op") or path.partition("#")[0],
            "est_rows": None if est is None else float(est),
            "unestimated": est is None,
            "actual_rows": 0,
            "wall_s": float(s.get("wall_s", 0.0)),
            "spilled_bytes": int(s.get("spilled_bytes", 0)),
            "spill_tiers": dict(s.get("spill_tiers") or {}),
            "cache_hits": int(b.get("page_cache_hits", 0)
                              + b.get("build_cache_hits", 0)),
        }
        pending.append((path, rec, s.get("rows", 0)))
    seen = {p for p, _, _ in pending}
    for nid, (node, fact) in (facts or {}).items():
        path = paths.get(nid)
        if path is None or path in seen:
            continue  # stale fact from another plan, or stats already cover
        if "splits" in fact:
            rec = {"op": path.partition("#")[0], "est_rows": None,
                   "unestimated": True, "actual_rows": 0,
                   "wall_s": 0.0, "spilled_bytes": 0, "spill_tiers": {},
                   "cache_hits": 0, "splits": int(fact["splits"])}
            pending.append((path, rec, 0))
        elif "build_rows" in fact:
            est = ests.get(nid)
            rec = {"op": path.partition("#")[0],
                   "est_rows": None if est is None else float(est),
                   "unestimated": est is None, "actual_rows": 0,
                   "wall_s": float(fact.get("wall_s", 0.0)),
                   "spilled_bytes": 0, "spill_tiers": {},
                   "cache_hits": 0, "build": True}
            pending.append((path, rec, fact["build_rows"]))
    if not pending:
        return {}
    vals = _read_counts([r[2] for r in pending])
    out: dict = {}
    for (path, rec, _), v in zip(pending, vals):
        rec["actual_rows"] = int(v)
        fold_records(out, path, rec)
    return out


def _read_counts(values: list) -> list:
    """The row counters as python ints: python ints pass through, and the
    0-d tensors (the executor keeps its counts on the device) are stacked
    per device and read in ONE synchronising copy each, not one per node.
    Not a ``_host``-counted read: the values exist, nothing new launches."""
    import torch

    out = list(values)
    by_device: dict = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        got = torch.stack([values[i].reshape(()).to(torch.int64) for i in idx]).tolist()
        for i, g in zip(idx, got):
            out[i] = g
    return out


def fold_records(dst: dict, path: str, rec: dict) -> None:
    """Fold one node record into ``dst[path]`` — rows/wall/spill SUM (split
    tasks of one fragment partition one logical node's input), estimates and
    op name keep the first non-None value."""
    cur = dst.get(path)
    if cur is None:
        dst[path] = dict(rec, spill_tiers=dict(rec.get("spill_tiers") or {}))
        if rec.get("skew"):
            dst[path]["skew"] = dict(rec["skew"])
        return
    if rec.get("skew"):
        # worst shard wins when split tasks of one logical node fold: the
        # slowest shard sets the SPMD wall, so the max ratio is the record
        mine = cur.get("skew")
        if mine is None or (rec["skew"].get("ratio", 1.0)
                            > mine.get("ratio", 1.0)):
            cur["skew"] = dict(rec["skew"])
    if "actual_rows" not in rec:
        return  # skew-only record (round 20): no cardinality arithmetic
    cur["actual_rows"] += int(rec.get("actual_rows", 0))
    cur["wall_s"] += float(rec.get("wall_s", 0.0))
    cur["spilled_bytes"] += int(rec.get("spilled_bytes", 0))
    cur["cache_hits"] += int(rec.get("cache_hits", 0))
    for t, b in (rec.get("spill_tiers") or {}).items():
        cur["spill_tiers"][t] = cur["spill_tiers"].get(t, 0) + b
    if cur.get("est_rows") is None:
        cur["est_rows"] = rec.get("est_rows")
    if cur.get("est_rows") is not None:
        cur["unestimated"] = False
    if rec.get("splits"):
        cur["splits"] = max(int(cur.get("splits") or 0),
                            int(rec["splits"]))
    if rec.get("build"):
        cur["build"] = True
    if not cur.get("op"):
        cur["op"] = rec.get("op")


# ---------------------------------------------------------------------- store
class PlanHistoryStore:
    """Bounded LRU map: structural plan fingerprint -> per-node-path records.

    TRINO_TPU_PLAN_HISTORY caps the number of PLANS retained (entry count,
    not bytes — records are a few hundred host bytes per node); 0 disables
    the store, unset defaults to 256.  All mutation under one lock; readers
    get snapshots.  The store survives plan-cache invalidation on purpose:
    fingerprints are content-based and embed connector plan_versions, so a
    replanned statement lands on the same key (or a new one when the data
    version moved) — history is what persists when compiled state does not.
    """

    DEFAULT_MAX_PLANS = 256

    def __init__(self, max_plans: Optional[int] = None):
        if max_plans is None:
            try:
                max_plans = int(os.environ.get("TRINO_TPU_PLAN_HISTORY", "")
                                or self.DEFAULT_MAX_PLANS)
            except ValueError:
                max_plans = self.DEFAULT_MAX_PLANS
        self.max_plans = max_plans
        self._lock = threading.Lock()
        self._plans: OrderedDict = OrderedDict()  # fingerprint -> entry
        # lifetime count of node records observed past MISESTIMATE_THRESHOLD
        # (the /v1/metrics counter: each recording of a misestimated node
        # fires once, so the rate is "misestimated node executions per
        # scrape interval")
        self.misestimates_total = 0

    @property
    def enabled(self) -> bool:
        return self.max_plans > 0

    def record(self, fingerprint: str, records: dict,
               sql: Optional[str] = None) -> Optional[dict]:
        """Merge one clean execution's node records under ``fingerprint``;
        returns the {"fingerprint": <short>, "nodes": records} payload the
        completion event carries (None when disabled/empty)."""
        if not self.enabled or not records:
            return None
        short = short_fingerprint(fingerprint)
        with self._lock:
            ent = self._plans.get(fingerprint)
            if ent is None:
                ent = self._plans[fingerprint] = {
                    "fingerprint": short, "executions": 0, "sql": sql,
                    "nodes": {}}
                while len(self._plans) > self.max_plans:
                    self._plans.popitem(last=False)
            else:
                self._plans.move_to_end(fingerprint)
                if ent["sql"] is None and sql is not None:
                    ent["sql"] = sql
            ent["executions"] += 1
            for path, rec in records.items():
                self._merge_node(ent["nodes"], path, rec)
        return {"fingerprint": short, "nodes": records}

    def _merge_node(self, nodes: dict, path: str, rec: dict) -> None:
        node = nodes.get(path)
        actual = int(rec.get("actual_rows", 0))
        if node is None:
            node = nodes[path] = {
                "op": rec.get("op") or path.partition("#")[0],
                "executions": 0, "est_rows": None, "unestimated": True,
                "actual_rows": 0, "actual_rows_ewma": float(actual),
                "wall_s": 0.0, "wall_s_total": 0.0,
                "spilled_bytes": 0, "spill_tiers": {}, "cache_hits": 0,
                "misestimate_ratio": 1.0, "direction": "exact"}
        skew = rec.get("skew")
        if skew is not None:
            # round 20: per-exchange shard skew keyed by the same structural
            # paths — EWMA on the ratio (one hot run must not dominate), the
            # latest argmax worker, summed recoverable imbalance wall
            cur = node.get("skew")
            ratio = float(skew.get("ratio", 1.0))
            if cur is None:
                node["skew"] = {
                    "ratio": ratio, "ratio_ewma": ratio,
                    "worker": int(skew.get("worker", 0)),
                    "workers": int(skew.get("workers", 0)),
                    "imbalance_s": float(skew.get("imbalance_s", 0.0))}
            else:
                cur["ratio"] = ratio
                cur["ratio_ewma"] = (EWMA_ALPHA * ratio
                                     + (1.0 - EWMA_ALPHA)
                                     * cur["ratio_ewma"])
                cur["worker"] = int(skew.get("worker", cur["worker"]))
                cur["workers"] = int(skew.get("workers", cur["workers"]))
                cur["imbalance_s"] += float(skew.get("imbalance_s", 0.0))
        if "actual_rows" not in rec:
            return  # skew-only record: never touch the cardinality EWMAs
        node["executions"] += 1
        est = rec.get("est_rows")
        if est is not None:
            node["est_rows"] = float(est)
        # "CBO was blind" vs "CBO was wrong": the marker clears the moment
        # ANY execution supplied an estimate (the advisor must never build a
        # correction from a blind node)
        node["unestimated"] = node["est_rows"] is None
        if rec.get("splits"):
            node["splits"] = max(int(node.get("splits") or 0),
                                 int(rec["splits"]))
        if rec.get("build"):
            node["build"] = True
        node["actual_rows"] = actual
        node["actual_rows_ewma"] = (EWMA_ALPHA * actual
                                    + (1.0 - EWMA_ALPHA)
                                    * node["actual_rows_ewma"]) \
            if node["executions"] > 1 else float(actual)
        node["wall_s"] = float(rec.get("wall_s", 0.0))
        node["wall_s_total"] += float(rec.get("wall_s", 0.0))
        node["spilled_bytes"] += int(rec.get("spilled_bytes", 0))
        for t, b in (rec.get("spill_tiers") or {}).items():
            node["spill_tiers"][t] = node["spill_tiers"].get(t, 0) + int(b)
        node["cache_hits"] += int(rec.get("cache_hits", 0))
        if node["est_rows"] is not None:
            ratio, direction = misestimate(node["est_rows"],
                                           node["actual_rows_ewma"])
            node["misestimate_ratio"] = round(ratio, 3)
            node["direction"] = direction
            if ratio >= MISESTIMATE_THRESHOLD:
                self.misestimates_total += 1

    # -- read surfaces ---------------------------------------------------------
    def get(self, fingerprint: str) -> Optional[dict]:
        """Deep-ish snapshot of one plan's entry (by FULL fingerprint)."""
        with self._lock:
            ent = self._plans.get(fingerprint)
            return None if ent is None else self._copy_entry(ent)

    @staticmethod
    def _copy_entry(ent: dict) -> dict:
        def copy_node(r: dict) -> dict:
            out = dict(r, spill_tiers=dict(r["spill_tiers"]))
            if r.get("skew"):
                out["skew"] = dict(r["skew"])
            return out

        return {**ent, "nodes": {p: copy_node(r)
                                 for p, r in ent["nodes"].items()}}

    def snapshot(self) -> list:
        """All entries, LRU-oldest first (what /v1/history serves)."""
        with self._lock:
            return [self._copy_entry(e) for e in self._plans.values()]

    def rows(self) -> list:
        """Flat per-node dicts for system.runtime.plan_history."""
        out = []
        for ent in self.snapshot():
            for path, r in sorted(ent["nodes"].items()):
                out.append({"fingerprint": ent["fingerprint"],
                            "node_path": path, **r,
                            "plan_executions": ent["executions"]})
        return out

    def misestimated(self, fingerprint: str,
                     min_ratio: float = MISESTIMATE_THRESHOLD) -> dict:
        """Win-prediction query (the adaptive advisor's input): {path: node
        record} for one plan's nodes whose EWMA-backed misestimate ratio is
        at or past ``min_ratio`` AND whose estimate was real — ``unestimated``
        (CBO-blind) nodes never qualify, whatever their actuals."""
        ent = self.get(fingerprint)
        if ent is None:
            return {}
        return {p: r for p, r in ent["nodes"].items()
                if r.get("est_rows") is not None
                and not r.get("unestimated")
                and float(r.get("misestimate_ratio", 1.0)) >= min_ratio}

    def predicted_win_s(self, fingerprint: str,
                        min_ratio: float = MISESTIMATE_THRESHOLD,
                        ratio_cap: float = 10.0) -> float:
        """Misestimate-scaled fraction of the recorded warm wall: for each
        qualifying node, its average recorded wall x (1 - 1/min(ratio, cap)).
        The advisor compares this (amortized over its horizon) against the
        re-plan's compile price."""
        win = 0.0
        for r in self.misestimated(fingerprint, min_ratio).values():
            execs = max(int(r.get("executions", 1)), 1)
            ratio = min(float(r.get("misestimate_ratio", 1.0)), ratio_cap)
            win += (float(r.get("wall_s_total", 0.0)) / execs) \
                * (1.0 - 1.0 / max(ratio, 1.0))
        return win

    def worst(self, n: int = 5, min_ratio: float = MISESTIMATE_THRESHOLD) \
            -> list:
        """The n worst-misestimated node records across every plan."""
        flat = [r for r in self.rows()
                if r["est_rows"] is not None
                and r["misestimate_ratio"] >= min_ratio]
        flat.sort(key=lambda r: -r["misestimate_ratio"])
        return flat[:n]

    def worst_ratio(self) -> float:
        """Worst misestimate ratio currently in the store (gauge; 1.0 when
        empty or everything is on-estimate)."""
        worst = 1.0
        with self._lock:
            for ent in self._plans.values():
                for r in ent["nodes"].values():
                    if r["misestimate_ratio"] > worst:
                        worst = r["misestimate_ratio"]
        return worst

    def as_dict(self) -> dict:
        """The GET /v1/history payload: every entry plus the worst-offender
        digest a dashboard reads first."""
        return {"max_plans": self.max_plans,
                "misestimates_total": self.misestimates_total,
                "worst": self.worst(),
                "plans": self.snapshot()}

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
