"""Plan rewrites that run after logical planning.

Reference: the iterative optimizer's column-pruning rules
(sql/planner/iterative/rule/PruneTableScanColumns.java, PruneProjectionColumns,
PruneJoinColumns, ...) — every node should produce only the channels its
consumers reference.  On this engine the win is direct compute: generator
connectors synthesize every requested column on device and file connectors
decode them, so unreferenced columns cost real kernel time (the reference
mostly saves IO).

`prune_columns(root)` propagates required channel sets top-down and returns a
rewritten tree with scans narrowed and FieldRef indices remapped.  Nodes whose
channel algebra isn't modeled (Window, Values, set operations with computed
dictionaries...) conservatively require everything below them — correct, just
unpruned.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ir
from . import plan as P
from ..page import Schema

__all__ = ["prune_columns"]


def _expr_channels(expr, out: set) -> None:
    if isinstance(expr, ir.FieldRef):
        out.add(expr.index)
    elif isinstance(expr, ir.Call):
        for a in expr.args:
            _expr_channels(a, out)


def _remap_expr(expr, mapping: dict):
    if isinstance(expr, ir.FieldRef):
        return dataclasses.replace(expr, index=mapping[expr.index])
    if isinstance(expr, ir.Call):
        return dataclasses.replace(
            expr, args=tuple(_remap_expr(a, mapping) for a in expr.args))
    return expr


def prune_columns(root: P.PlanNode) -> P.PlanNode:
    node, mapping = _prune(root, None)
    return node


def _identity(node):
    """(node, no mapping) — children keep their full layout (required=all), but
    deeper prunable chains still shrink inside them."""
    kids = node.children
    if kids:
        node = _replace_children(node, tuple(_prune(c, None)[0] for c in kids))
    return node, None


def _prune(node: P.PlanNode, required):
    """required: set of needed output channels of ``node`` (None = all).
    Returns (new_node, mapping old_channel -> new_channel or None for identity)."""
    n_out = len(node.schema.fields)
    if required is None:
        required = set(range(n_out))

    if isinstance(node, P.Output):
        child_req = set(range(len(node.names)))
        child, m = _prune(node.child, _closed(node.child, child_req))
        # Output renames the first len(names) child channels; pruning keeps
        # relative order, so names still line up
        return dataclasses.replace(node, child=child), None

    if isinstance(node, P.Sort):
        child_req = set(required) | {k.channel for k in node.keys}
        child, m = _prune(node.child, _closed(node.child, child_req))
        if m:
            keys = tuple(dataclasses.replace(k, channel=m[k.channel])
                         for k in node.keys)
            return P.Sort(child, keys), m
        return P.Sort(child, node.keys), m

    if isinstance(node, P.Limit):
        child, m = _prune(node.child, _closed(node.child, set(required)))
        return dataclasses.replace(node, child=child), m

    if isinstance(node, P.Filter):
        child_req = set(required)
        _expr_channels(node.predicate, child_req)
        child, m = _prune(node.child, _closed(node.child, child_req))
        pred = _remap_expr(node.predicate, m) if m else node.predicate
        return P.Filter(child, pred), m

    if isinstance(node, P.Project):
        keep = sorted(required)
        child_req: set = set()
        for i in keep:
            _expr_channels(node.exprs[i], child_req)
        child, m = _prune(node.child, _closed(node.child, child_req))
        cm = m or {}
        exprs = tuple(_remap_expr(node.exprs[i], cm) if cm else node.exprs[i]
                      for i in keep)
        dicts = (tuple(node.dicts[i] for i in keep) if node.dicts else None)
        schema = Schema(tuple(node.schema.fields[i] for i in keep))
        mapping = {old: new for new, old in enumerate(keep)}
        if len(keep) == n_out:
            mapping = None
        return P.Project(child, exprs, schema, dicts), mapping

    if isinstance(node, P.TableScan):
        keep = sorted(required)
        if len(keep) == n_out or not keep:
            return node, None
        scan = P.TableScan(node.catalog, node.table,
                           tuple(node.columns[i] for i in keep),
                           Schema(tuple(node.schema.fields[i] for i in keep)),
                           source_tables=node.source_tables)  # provenance
        # (virtual pushdown handles) must survive pruning: access control
        # checks it instead of the handle name
        return scan, {old: new for new, old in enumerate(keep)}

    if isinstance(node, P.Aggregate):
        # outputs stay intact (keys + agg layout is load-bearing); prune below
        child_req: set = set(node.keys)
        for spec in node.aggs:
            if spec.arg is not None:
                _expr_channels(spec.arg, child_req)
            if spec.kind == "listagg" and spec.param \
                    and spec.param[1] is not None:
                child_req.add(spec.param[1])  # WITHIN GROUP order channel
            if spec.kind in ("max_by", "min_by", "map_agg"):
                child_req.add(int(spec.param))  # payload/value channel
        child, m = _prune(node.child, _closed(node.child, child_req))
        if m:
            keys = tuple(m[k] for k in node.keys)
            aggs = []
            for spec in node.aggs:
                if spec.arg is not None:
                    spec = dataclasses.replace(
                        spec, arg=_remap_expr(spec.arg, m))
                if spec.kind == "listagg" and spec.param \
                        and spec.param[1] is not None:
                    sep, och, asc = spec.param
                    spec = dataclasses.replace(spec,
                                               param=(sep, m[och], asc))
                if spec.kind in ("max_by", "min_by", "map_agg"):
                    spec = dataclasses.replace(spec,
                                               param=m[int(spec.param)])
                aggs.append(spec)
            return dataclasses.replace(node, child=child, keys=keys,
                                       aggs=tuple(aggs)), None
        return dataclasses.replace(node, child=child), None

    if isinstance(node, P.Join):
        if node.kind == "mark":
            # probe channels + one appended boolean mark channel (always
            # last): prune both sides like a semi join, then remap the mark
            # channel onto the new probe width
            n_left = len(node.left.schema.fields)
            left_req = {c for c in required if c < n_left} \
                | set(node.left_keys)
            right_req = set(node.right_keys)
            left, lm = _prune(node.left, _closed(node.left, left_req))
            right, rm = _prune(node.right, _closed(node.right, right_req))
            lmf = lm if lm else {c: c for c in range(n_left)}
            rmf = rm if rm else \
                {c: c for c in range(len(node.right.schema.fields))}
            left_keys = tuple(lmf[c] for c in node.left_keys)
            right_keys = tuple(rmf[c] for c in node.right_keys)
            new_n_left = len(left.schema.fields)
            schema = Schema(tuple(left.schema.fields)
                            + (node.schema.fields[-1],))
            comb = dict(lmf)
            comb[n_left] = new_n_left  # the mark channel itself
            out_map = None if all(comb.get(i, i) == i
                                  for i in range(n_left + 1)) else comb
            return dataclasses.replace(
                node, left=left, right=right, left_keys=left_keys,
                right_keys=right_keys, schema=schema), out_map
        semi = node.kind in ("semi", "anti")
        n_left = len(node.left.schema.fields)
        left_req = {c for c in required if c < n_left} | set(node.left_keys)
        right_req = (set() if semi else
                     {c - n_left for c in required if c >= n_left})
        right_req |= set(node.right_keys)
        if node.filter is not None:
            fch: set = set()
            _expr_channels(node.filter, fch)
            left_req |= {c for c in fch if c < n_left}
            right_req |= {c - n_left for c in fch if c >= n_left}
        left, lm = _prune(node.left, _closed(node.left, left_req))
        right, rm = _prune(node.right, _closed(node.right, right_req))
        n_right = len(node.right.schema.fields)
        lmf = lm if lm else {c: c for c in range(n_left)}
        rmf = rm if rm else {c: c for c in range(n_right)}
        new_n_left = len(left.schema.fields)
        comb = dict(lmf)
        for c, nc in rmf.items():
            comb[n_left + c] = new_n_left + nc
        left_keys = tuple(lmf[c] for c in node.left_keys)
        right_keys = tuple(rmf[c] for c in node.right_keys)
        filt = _remap_expr(node.filter, comb) if node.filter is not None else None
        if semi:
            schema = left.schema
        else:
            schema = Schema(tuple(left.schema.fields) + tuple(right.schema.fields))
        out_map = None if all(comb.get(i, i) == i for i in range(n_out)) else comb
        return dataclasses.replace(
            node, left=left, right=right, left_keys=left_keys,
            right_keys=right_keys, schema=schema, filter=filt), out_map

    # Window / Union / Values / anything else: conservatively keep everything
    return _identity(node)


def _closed(child, req: set):
    """Clamp a requirement set to the child's channel space."""
    n = len(child.schema.fields)
    return {c for c in req if 0 <= c < n} or set(range(min(n, 1)))


def _replace_children(node: P.PlanNode, new_kids: tuple) -> P.PlanNode:
    from .rules import _replace_children as shared

    return shared(node, new_kids)


def pushdown_aggregations(root, catalogs):
    """Connector aggregate pushdown, count(*) slice (reference:
    ConnectorMetadata.applyAggregation, spi/connector/ConnectorMetadata.java:1595):
    a global count(*) over a bare scan — no Filter; Projects do not change
    cardinality — is answered from connector metadata without scanning.
    Connectors opt in with ``supports_count_pushdown`` (exact row counts that
    invalidate cached plans on mutation)."""
    import dataclasses as _dc

    from . import plan as P

    def walk(n):
        if isinstance(n, P.Aggregate) and not n.keys and n.aggs \
                and all(s.kind == "count_star" for s in n.aggs):
            c = n.child
            while isinstance(c, P.Project):
                c = c.child
            if isinstance(c, P.TableScan):
                conn = catalogs.get(c.catalog)
                if conn is not None and getattr(conn,
                                                "supports_count_pushdown",
                                                False) \
                        and hasattr(conn, "exact_row_count"):
                    # row_count() is a stats ESTIMATE on some connectors
                    # (tpch lineitem); count(*) must be exact
                    nrows = int(conn.exact_row_count(c.table))
                    return P.Values((tuple(nrows for _ in n.aggs),), n.schema,
                                    source_tables=((c.catalog, c.table),))
        kids = tuple(walk(k) for k in n.children)
        if all(a is b for a, b in zip(kids, n.children)):
            return n
        from .rules import _replace_children

        return _replace_children(n, kids)

    return walk(root)


def pushdown_topn(root, catalogs):
    """Connector TopN pushdown (reference: ConnectorMetadata.applyTopN,
    spi/connector/ConnectorMetadata.java:1663): Limit(Sort(scan-chain)) over
    a connector that opts in (``supports_topn_pushdown``) rewrites the scan
    to a virtual handle whose remote read issues ORDER BY ... LIMIT n — n
    rows cross the wire instead of the table.  The local Sort+Limit STAYS
    (the reference's topNGuarantee: remote collation may differ), so this is
    pure transfer savings, never a semantics change."""
    import dataclasses as _dc

    from . import plan as P
    from .rules import _replace_children

    def chain_to_scan(n):
        """-> (scan, channel->column-name map) through pure FieldRef
        projects; None when anything else intervenes."""
        if isinstance(n, P.TableScan):
            return n, {i: c for i, c in enumerate(n.columns)}
        if isinstance(n, P.Project):
            sub = chain_to_scan(n.child)
            if sub is None:
                return None
            scan, m = sub
            out = {}
            from . import ir as _ir

            for i, e in enumerate(n.exprs):
                if isinstance(e, _ir.FieldRef) and e.index in m:
                    out[i] = m[e.index]
            return scan, out
        return None

    def walk(n):
        if isinstance(n, P.Limit) and isinstance(n.child, P.Sort):
            sort = n.child
            sub = chain_to_scan(sort.child)
            if sub is not None:
                scan, colmap = sub
                conn = catalogs.get(scan.catalog)
                if conn is not None \
                        and getattr(conn, "supports_topn_pushdown", False) \
                        and not getattr(conn, "is_pushdown_handle",
                                        lambda t: False)(scan.table) \
                        and all(k.channel in colmap for k in sort.keys):
                    order = [(colmap[k.channel], k.ascending, k.nulls_first)
                             for k in sort.keys]
                    handle = conn.apply_topn(scan.table, order, n.count)
                    new_scan = _dc.replace(
                        scan, table=handle,
                        source_tables=((scan.catalog, scan.table),))
                    replaced = _replace_subtree(sort, scan, new_scan)
                    return _dc.replace(n, child=replaced)
        kids = tuple(walk(k) for k in n.children)
        if all(a is b for a, b in zip(kids, n.children)):
            return n
        from .rules import _replace_children as _rc

        return _rc(n, kids)

    return walk(root)


def _replace_subtree(root, target, replacement):
    """Rebuild ``root`` with the node ``target`` (by identity) replaced."""
    import dataclasses as _dc

    from .rules import _replace_children

    if root is target:
        return replacement
    kids = tuple(_replace_subtree(c, target, replacement)
                 for c in root.children)
    if all(a is b for a, b in zip(kids, root.children)):
        return root
    return _replace_children(root, kids)


# the comparisons a join pushdown carries into the remote query
_REMOTE_CMP = ("eq", "lt", "lte", "gt", "gte")


def pushdown_joins(root, catalogs):
    """Connector join pushdown (reference: ConnectorMetadata.applyJoin,
    spi/connector/ConnectorMetadata.java:1637): an INNER equi-join whose
    both sides are bare scans (or FieldRef projections of scans) of the SAME
    opting-in catalog runs remotely; the engine scans the joined result,
    split by the left side's rowid ranges.  Residual filters or computed
    keys block the pushdown (the classic applyJoin contract).  Two port
    changes: output names that repeat (a self-join's) block it too, since a
    handle's columns are read by name (the reference pushes such a join and
    reads one side's column for both); and a side's filter that is a
    conjunction of integer columns compared with integer constants rides
    into the remote join (``apply_join``'s ``left_filter`` /
    ``right_filter``), which applies it exactly, so it leaves the plan (the
    reference's filters always block)."""
    import dataclasses as _dc

    from . import ir as _ir
    from . import plan as P
    from .rules import _replace_children

    def conjuncts(e):
        if isinstance(e, _ir.Call) and e.op == "and":
            for a in e.args:
                yield from conjuncts(a)
        else:
            yield e

    def int_const(e):
        return isinstance(e, _ir.Constant) and e.type.is_integer \
            and isinstance(e.value, (int, np.integer)) and not isinstance(e.value, bool)

    def remote_filter(pred, columns):
        """[(column, op, value)] for a conjunction of integer columns of
        ``columns`` compared with integer constants, else None."""
        out = []
        for c in conjuncts(pred):
            if not (isinstance(c, _ir.Call) and c.op in _REMOTE_CMP + ("between",)
                    and isinstance(c.args[0], _ir.FieldRef)
                    and c.args[0].index < len(columns) and c.args[0].type.is_integer
                    and all(int_const(a) for a in c.args[1:])):
                return None
            col = columns[c.args[0].index]
            if c.op == "between":
                out += [(col, "gte", int(c.args[1].value)), (col, "lte", int(c.args[2].value))]
            else:
                out.append((col, c.op, int(c.args[1].value)))
        return out

    def side_info(n):
        """-> (scan, [output column names per channel], [remote filter]) for
        a pushable side: bare scan or ONE pure-FieldRef project over a scan
        covering every output channel, either over a filter the connector
        applies (``remote_filter``)."""
        proj = n if isinstance(n, P.Project) else None
        if proj is not None:
            n = proj.child
        cons = []
        if isinstance(n, P.Filter) and isinstance(n.child, P.TableScan):
            cons = remote_filter(n.predicate, n.child.columns)
            if not cons:
                return None
            n = n.child
        if not isinstance(n, P.TableScan):
            return None
        if proj is None:
            return n, list(n.columns), cons
        names = []
        for e in proj.exprs:
            if not isinstance(e, _ir.FieldRef) or e.index >= len(n.columns):
                return None
            names.append(n.columns[e.index])
        return n, names, cons

    def walk(n):
        kids = tuple(walk(k) for k in n.children)
        if not all(a is b for a, b in zip(kids, n.children)):
            n = _replace_children(n, kids)
        if isinstance(n, P.Join) and n.kind == "inner" \
                and n.filter is None and not n.null_aware:
            ls, rs = side_info(n.left), side_info(n.right)
            if ls is not None and rs is not None:
                (lscan, lnames, lcons), (rscan, rnames, rcons) = ls, rs
                conn = catalogs.get(lscan.catalog)
                is_handle = getattr(conn, "is_pushdown_handle",
                                    lambda t: False) if conn else None
                if lscan.catalog == rscan.catalog and conn is not None \
                        and getattr(conn, "supports_join_pushdown", False) \
                        and not is_handle(lscan.table) \
                        and not is_handle(rscan.table) \
                        and all(k < len(lnames) for k in n.left_keys) \
                        and all(k < len(rnames) for k in n.right_keys) \
                        and len(n.schema.fields) == len(lnames) + len(rnames) \
                        and len({f.name for f in n.schema.fields}) == len(n.schema.fields):
                    pairs = [(lnames[a], rnames[b])
                             for a, b in zip(n.left_keys, n.right_keys)]
                    out_names = [f.name for f in n.schema.fields]
                    filters = {"left_filter": lcons, "right_filter": rcons} \
                        if lcons or rcons else {}
                    handle = conn.apply_join(lscan.table, rscan.table, pairs,
                                             out_names, lnames, rnames, **filters)
                    return P.TableScan(
                        lscan.catalog, handle, tuple(out_names), n.schema,
                        source_tables=((lscan.catalog, lscan.table),
                                       (rscan.catalog, rscan.table)))
        return n

    return walk(root)
