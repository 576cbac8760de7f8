"""EXPLAIN plan rendering.

Reference: sql/planner/planprinter/PlanPrinter.java (text mode).  Channel-based plans
print one operator per line with indentation, output schema, and the operator-specific
details (predicates, join keys, aggregate calls).

Counterpart of ``trino_tpu/sql/planprinter.py``, copied.
"""

from __future__ import annotations

from . import plan as P

__all__ = ["format_plan"]


def format_plan(node: P.PlanNode, stats: dict = None, counters=None,
                boundary: dict = None, ests: dict = None,
                paths: dict = None, breakdown: dict = None,
                adaptive: dict = None, skew: dict = None) -> str:
    """``stats``: optional id(node) -> {rows, wall_s} from an EXPLAIN ANALYZE run
    (reference: PlanPrinter's textDistributedPlan with OperatorStats).
    ``counters``: optional per-query device-boundary counters
    (execution/tracing.QueryCounters) appended as a summary line — the
    dispatch/transfer budget the query actually spent — followed by the
    per-call-site breakdown (``counters.sites``).  ``boundary``: optional
    per-operator attribution (LocalExecutor.boundary: id(node) ->
    {label, dispatches, transfers, bytes}, plus a "result" entry for the final
    materialization pull); per-operator rows sum to the counter totals
    exactly (innermost-scope attribution).  ``ests``: optional id(node) ->
    CBO row estimate (executor begin_plan maps, execution/history.py) —
    nodes with both an estimate and actuals get an
    ``[est N x actual M -> K.Kx over/under]`` annotation and the worst
    offenders roll up into a "Misestimates:" summary line; ``paths`` names
    them by structural node path.  ``breakdown``: optional wall-clock
    decomposition (execution/tracing.wall_breakdown over the analyze run's
    window) rendered as one "Wall breakdown:" line — where the time went
    (plan / split generation / h2d / device dispatch / host pull / exchange
    wait / unattributed), not just how much there was.  ``adaptive``:
    optional adaptive-advisor decision dict (round 19) rendered as one
    "Adaptive:" line with the win-vs-price arithmetic and the corrections —
    why this statement's plan changed, or why the advisor held (no decision
    = no line, budget-suite regexes unchanged).  ``skew``: optional id(node)
    -> ShardStats record (round 20, DistributedExecutor.skew_by_node) —
    exchanges above the noise floor get a ``[skew: max/mean K.Kx worker N]``
    annotation and the worst offenders roll up into a "Skew:" summary line
    (balanced mesh = no annotation, no line)."""
    lines: list = []
    _fmt(node, lines, 0, stats or {}, boundary or {}, ests or {}, skew or {})
    mis = _misestimate_summary(stats or {}, ests or {}, paths or {})
    if mis:
        lines.append(mis)
    sk = _skew_summary(skew or {})
    if sk:
        lines.append(sk)
    if adaptive:
        from ..execution.adaptive import describe_decision

        desc = describe_decision(adaptive)
        if desc:
            lines.append(f"Adaptive: {desc}")
    if breakdown:
        from ..execution.tracing import format_wall_breakdown

        lines.append(format_wall_breakdown(breakdown))
    if counters is not None:
        boundary_line = (
            f"Device boundary: {counters.device_dispatches} dispatches, "
            f"{counters.host_transfers} host transfers, "
            f"{counters.host_bytes_pulled} bytes pulled, "
            f"{counters.coalesced_splits} splits coalesced")
        # chaos runs are self-describing: injected faults and the retries
        # they forced ride the boundary summary (zero = line unchanged)
        fi = getattr(counters, "faults_injected", 0)
        tr = getattr(counters, "task_retries", 0)
        if fi or tr:
            boundary_line += f", {fi} faults injected, {tr} task retries"
        lines.append(boundary_line)
        cm = getattr(counters, "compiles", 0)
        if cm:
            # the compile observatory (round 17): how many first-seen arg
            # signatures this run compiled and what they cost — a WARM
            # statement prints nothing here (zero = no line, budget-suite
            # regexes unchanged), so the line itself is a cold-path marker
            lines.append(f"Compile: {cm} compilations, "
                         f"{getattr(counters, 'compile_s', 0.0):.3f}s")
        sp = getattr(counters, "spilled_bytes", 0)
        aq = getattr(counters, "admission_queued", 0)
        if sp or aq:
            # the escalation ladder is self-describing: which tier the
            # spilled bytes landed in, and whether admission deferred the
            # query first (zero everywhere = no line, budget-suite regexes
            # and non-spilling EXPLAINs unchanged)
            lines.append(
                f"Spill: {sp} bytes "
                f"(hbm {getattr(counters, 'spill_tier_hbm', 0)}, "
                f"host {getattr(counters, 'spill_tier_host', 0)}, "
                f"disk {getattr(counters, 'spill_tier_disk', 0)}), "
                f"{aq} admissions queued")
        pc_h = getattr(counters, "page_cache_hits", 0)
        pc_m = getattr(counters, "page_cache_misses", 0)
        bc_h = getattr(counters, "build_cache_hits", 0)
        if pc_h or pc_m or bc_h:
            lines.append(
                f"Buffer pool: {pc_h} page hits, {pc_m} page misses, "
                f"{getattr(counters, 'page_cache_bytes_saved', 0)} bytes "
                f"saved, {bc_h} build hits")
        pt_h = getattr(counters, "plan_template_hits", 0)
        pt_m = getattr(counters, "plan_template_misses", 0)
        if pt_h or pt_m:
            # plan templates (round 13): a hit answered the statement through
            # an already-compiled parameterized plan — no parse/analyze/plan,
            # no re-trace; a miss is the one-time template creation (zero
            # everywhere = no line, budget-suite regexes unchanged)
            lines.append(f"Plan template: {pt_h} hits, {pt_m} misses")
        br = getattr(counters, "batched_requests", 0)
        if br:
            # continuous template batching (round 21): this statement was
            # served through a fused same-template batch — one device
            # program amortized across the window's requests (zero = no
            # line, budget-suite regexes unchanged)
            lines.append(f"Batched: {br} requests served via fused "
                         f"template batches")
        rc_h = getattr(counters, "result_cache_hits", 0)
        rc_m = getattr(counters, "result_cache_misses", 0)
        if rc_h or rc_m:
            # the buffer pool's result tier (round 12): a hit means the
            # WHOLE statement was served with zero dispatches; a miss means
            # the statement was admissible and stored on completion (zero
            # everywhere = no line, budget-suite regexes unchanged)
            lines.append(
                f"Result cache: {rc_h} hits, {rc_m} misses, "
                f"{getattr(counters, 'result_cache_bytes_saved', 0)} bytes "
                f"saved")
        res = (boundary or {}).get("result")
        if res is not None and _boundary_nonzero(res):
            lines.append("    result: " + _boundary_str(res))
        sites = getattr(counters, "sites", None) or {}
        for key in sorted(sites, key=lambda k: (-sites[k]["dispatches"],
                                                -sites[k]["bytes"], k)):
            lines.append(f"    site {key}: " + _boundary_str(sites[key]))
    return "\n".join(lines)


def _misestimate_summary(stats: dict, ests: dict, paths: dict) -> str:
    """One "Misestimates:" line naming the worst est-vs-actual offenders
    (ratio >= MISESTIMATE_THRESHOLD, worst first, top 5) — the drift signal
    an EXPLAIN ANALYZE reader scans for, and the input the adaptive advisor
    (execution/adaptive.py) consumes through the history store.  Empty
    string when every node is within threshold (non-
    analyze prints and on-estimate plans are unchanged)."""
    from ..execution.history import MISESTIMATE_THRESHOLD, misestimate

    worst: list = []
    for nid, s in stats.items():
        est = s.get("est_rows", ests.get(nid))
        if est is None:
            continue
        actual = int(s["rows"])
        ratio, direction = misestimate(est, actual)
        if ratio < MISESTIMATE_THRESHOLD:
            continue
        label = s.get("path") or paths.get(nid) or s.get("op", "node")
        worst.append((ratio, label, est, actual, direction))
    if not worst:
        return ""
    worst.sort(key=lambda w: (-w[0], w[1]))
    inner = "; ".join(
        f"{label} est {int(est):,} actual {actual:,} ({ratio:.1f}x {d})"
        for ratio, label, est, actual, d in worst[:5])
    return f"Misestimates: {inner}"


# per-node skew annotations and the summary line print only ABOVE this
# ratio and row floor: a balanced mesh or a trivially small exchange stays
# silent (budget-suite EXPLAIN regexes unchanged, same zero-is-no-line
# discipline as every other summary here)
SKEW_PRINT_THRESHOLD = 2.0
SKEW_ROWS_FLOOR = 8


def _skew_rec_visible(rec: dict) -> bool:
    return (rec.get("ratio", 1.0) >= SKEW_PRINT_THRESHOLD
            and rec.get("max", 0) >= SKEW_ROWS_FLOOR)


def _skew_str(rec: dict) -> str:
    return (f"max/mean {rec.get('ratio', 1.0):.1f}x "
            f"worker {rec.get('worker', 0)}")


def _skew_summary(skew: dict) -> str:
    """One "Skew:" line naming the worst per-shard imbalances (round 20) —
    which exchange sent most of its rows to one worker and roughly what
    that slowest-shard wall cost.  Empty when every exchange is balanced."""
    worst = [rec for rec in skew.values() if _skew_rec_visible(rec)]
    if not worst:
        return ""
    worst.sort(key=lambda r: (-r.get("ratio", 1.0), r.get("site", "")))
    inner = "; ".join(
        f"{rec.get('op') or rec.get('site', 'exchange')} "
        f"{_skew_str(rec)} ({rec.get('imbalance_s', 0.0) * 1000:.1f} ms "
        f"imbalance)"
        for rec in worst[:5])
    return f"Skew: {inner}"


def _boundary_nonzero(b: dict) -> bool:
    return bool(b.get("dispatches") or b.get("transfers") or b.get("bytes"))


def _boundary_str(b: dict) -> str:
    return (f"{b.get('dispatches', 0)} dispatches, "
            f"{b.get('transfers', 0)} transfers, "
            f"{b.get('bytes', 0)} bytes")


def _schema_str(node: P.PlanNode) -> str:
    fields = node.schema.fields
    inner = ", ".join(f"{f.name}:{f.type.name}" for f in fields[:8])
    if len(fields) > 8:
        inner += f", ... {len(fields) - 8} more"
    return f"[{inner}]"


def _fmt(node: P.PlanNode, lines: list, depth: int, stats: dict,
         boundary: dict = None, ests: dict = None,
         skew: dict = None) -> None:
    pad = "    " * depth
    boundary = boundary or {}
    ests = ests or {}
    skew = skew or {}
    before = len(lines)
    if isinstance(node, P.Output):
        lines.append(f"{pad}Output[{', '.join(node.names)}]")
    elif isinstance(node, P.Sort):
        keys = ", ".join(
            f"${k.channel} {'ASC' if k.ascending else 'DESC'}" for k in node.keys)
        lines.append(f"{pad}Sort[{keys}]")
    elif isinstance(node, P.Limit):
        lines.append(f"{pad}Limit[{node.count}]")
    elif isinstance(node, P.Aggregate):
        keys = ", ".join(f"${k}" for k in node.keys)
        aggs = ", ".join(f"{s.name} := {s.kind}({s.arg if s.arg is not None else '*'})"
                         for s in node.aggs)
        what = " DISTINCT" if not node.aggs else ""
        lines.append(f"{pad}Aggregate{what}[keys = [{keys}], {aggs}] => "
                     f"{_schema_str(node)}")
    elif isinstance(node, P.Join):
        keys = ", ".join(f"${l} = ${r}" for l, r in zip(node.left_keys, node.right_keys))
        extra = f", filter: {node.filter}" if node.filter is not None else ""
        na = ", null-aware" if node.null_aware else ""
        est = (f", est: {int(node.est_rows):,} rows"
               if node.est_rows is not None else "")
        lines.append(f"{pad}{node.kind.capitalize()}Join[{keys}{extra}{na}, "
                     f"{node.distribution}{est}] => {_schema_str(node)}")
    elif isinstance(node, P.Exchange):
        # physical placement marker (AddExchanges product; on TPU this is the
        # XLA collective fused into the surrounding program, not an operator)
        keys = f" on [{', '.join(f'${k}' for k in node.keys)}]" \
            if node.keys else ""
        lines.append(f"{pad}Exchange[{node.kind}{keys}]")
    elif isinstance(node, P.Filter):
        lines.append(f"{pad}Filter[{node.predicate}]")
    elif isinstance(node, P.Project):
        exprs = ", ".join(f"{f.name} := {e}"
                          for f, e in zip(node.schema.fields[:6], node.exprs[:6]))
        more = " ..." if len(node.exprs) > 6 else ""
        lines.append(f"{pad}Project[{exprs}{more}]")
    elif isinstance(node, P.TableScan):
        lines.append(f"{pad}TableScan[{node.catalog}.{node.table}] => "
                     f"{_schema_str(node)}")
    elif isinstance(node, P.Union):
        lines.append(f"{pad}Union => {_schema_str(node)}")
    elif isinstance(node, P.Values):
        lines.append(f"{pad}Values[{len(node.rows)} rows]")
    else:
        lines.append(f"{pad}{type(node).__name__} => {_schema_str(node)}")
    s = stats.get(id(node))
    if s is not None and len(lines) > before:
        # row counts may still live on device (deferred device->host sync)
        lines[before] += f"  [rows: {int(s['rows'])}, {s['wall_s'] * 1000:.1f} ms]"
        if s.get("spilled_bytes"):
            # the tiered spill ran (reference: operator spill metrics in
            # OperatorStats — spilledDataSize); tiers show where the bytes
            # landed on the HBM -> host -> disk ladder
            lines[before] += (f" [spilled: {s['spilled_bytes'] / 1e6:.1f} MB, "
                              f"{s['spill_partitions']} partitions]")
            tiers = s.get("spill_tiers")
            if tiers and any(tiers.values()):
                inner = ", ".join(f"{t} {b}" for t, b in tiers.items() if b)
                lines[before] += f" [tiers: {inner}]"
        if s.get("index_join_keys"):
            # the probe scan collapsed to a connector keyed lookup
            lines[before] += f" [index lookup: {s['index_join_keys']} keys]"
        est = s.get("est_rows", ests.get(id(node)))
        if est is not None:
            # est-vs-actual drift annotation (round 15): what the CBO
            # promised against what arrived, with the over/under factor —
            # the per-node view of the plan-history record this run fed
            from ..execution.history import misestimate

            actual = int(s["rows"])
            ratio, direction = misestimate(est, actual)
            drift = "on estimate" if direction == "exact" \
                else f"{ratio:.1f}x {direction}"
            lines[before] += (f" [est {int(est):,} x actual {actual:,} "
                              f"-> {drift}]")
    b = boundary.get(id(node))
    if b is not None and _boundary_nonzero(b) and len(lines) > before:
        # per-operator device-boundary attribution (the OperatorStats analog
        # for the accelerator boundary): dispatches/pulls recorded while THIS
        # operator (and the streaming chain it drives) executed
        lines[before] += f" [boundary: {_boundary_str(b)}]"
    sk = skew.get(id(node))
    if sk is not None and _skew_rec_visible(sk) and len(lines) > before:
        # per-shard imbalance at this operator's exchange (round 20): the
        # slowest shard sets the SPMD wall, so the reader sees WHICH worker
        # carried the heavy partition straight on the plan line
        lines[before] += f" [skew: {_skew_str(sk)}]"
    for c in node.children:
        _fmt(c, lines, depth + 1, stats, boundary, ests, skew)
