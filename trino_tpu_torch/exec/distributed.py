"""The distributed executor over a worker mesh (counterpart of
``trino_tpu/exec/distributed.py``).

The reference runs one SPMD program over a 1-D jax mesh through
``shard_map``, driven by one Python process.  The port keeps that
single-controller design over a single-process mesh of device positions
(``parallel/mesh.py``): every per-worker step runs once per position on the
position's device, in lockstep, and a ``shard_map`` body becomes a loop over
the positions.  Per-position state is a list of W values ("shards": a
``(cols, nulls, valid)`` tuple per position) where the reference holds one
``[W, ...]`` array sharded on the worker axis.

- **sharded scan**: batch b gives position w split ``b * W + w``.  Generated
  tables (``generate_traced``) are generated per position; every other
  connector is host-fed (``_HostFedBatches``): pages that already live on
  the device (memory, blackhole) are padded there, and host-decoded pages
  are staged through ``_page_to_device``.
- **streaming fragment**: scan, filter, project and join probe run per
  position; a transform maps the W shards of a batch to W shards plus a
  per-position overflow flag.
- **broadcast join**: the build side runs on the embedded ``LocalExecutor``
  and its table is replicated once per distinct device.
- **partitioned join**: the build page routes through the hash exchange so
  each position builds the table of its own key range (``hash_insert_``),
  and every probe batch routes the same way.
- **aggregation**: per-position partial group tables (``hash_insert_``), then
  one hash exchange of the table entries and a merge insert per position.
- **sort, window**: rows route to their owning position (range or hash),
  which sorts or evaluates its shard; TopN keeps a running top-k per
  position.

The exchange is ``ops/exchange.py``'s ``bucketize`` (one ``compact_rows``
per destination) and ``exchange_all_to_all`` (copies between the
positions' tensors).  With ``TRINO_TPU_DEVICE_EXCHANGE`` on (the default)
routed rows append into per-position device receive buffers
(``append_rows``) and a run reads only the cursors and overflow flags of all
W positions, in one counted read; ``=0`` restores the reference's host
spool.  Fragments the mesh cannot run fall back as the reference's do, and
``exec_trace`` records each fragment's mode (mesh, coordinator, local with
the reason).  A ``local`` fragment runs on the embedded ``LocalExecutor`` on
the mesh's first device.

Every host read goes through the embedded executor's ``_host`` (counted,
fault points ``dispatch`` / ``host_pull``) at ``dist.*`` sites; the mesh
exchange's own fault points are ``exchange_write`` and ``exchange_read``
(``_exchange_fault``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..execution import faults, tracing
from ..execution.tracing import maybe_span, record_shard_stats
from ..ops import hashagg
from ..ops.arrays import append_rows, compact_rows
from ..ops.exchange import bucketize, exchange_all_to_all, partition_ids
from ..ops.hashing import EMPTY_KEY, pack_keys
from ..ops.hashjoin import (MultiJoinTable, _multi_build_step, build_insert,
                            build_table_init, expand_counts, multi_build, probe,
                            probe_slots)
from ..page import Page, Schema
from ..parallel.mesh import worker_mesh
from ..sql import plan as P
from ..sql.ir import FieldRef, device_array, device_constants, evaluate, evaluate_predicate
from ..types import torch_dtype
from .local_executor import (_MERGE_KIND, DEFAULT_GROUP_CAPACITY, MAX_GROUP_CAPACITY,
                             LocalExecutor, MaterializedResult, _broadcast,
                             _collation_rank_lut, _finalize_aggs_device, _gather_build,
                             _global_agg_update, _global_init_state, _lexsort,
                             _null_aware_anti, _page_to_device, _window_kernel,
                             _window_spec_dicts)

__all__ = ["DistributedExecutor"]

# (probe_bucket_factor, expand_factor) retry ladder: probe exchange buckets
# start at ~2n/W (factor 2) instead of the always-safe n, trading a W/2-times
# smaller receive tensor for a rare retry under hash skew; expansion buckets
# for multi-match joins grow alongside.  ``None`` = exact (bucket = n, no
# probe-side overflow possible).
_EXCHANGE_LADDER = ((2, 4), (4, 8), (None, 16), (None, 64))


def _exchange_fault(point: str, site: str):
    """Fault point of the mesh exchange (``exchange_write`` /
    ``exchange_read``).  ``error`` / ``fatal`` / ``delay`` act as everywhere
    else; any RETURNED action (drop, deny) raises typed too: the mesh
    exchange is one lockstep program, it cannot drop a commit or defer a
    reader as a spooled exchange can."""
    act = faults.maybe_inject(point, site)
    if act:
        raise faults.InjectedFaultError(
            f"injected {point}:{act} at {site}: the mesh exchange cannot "
            "drop or defer rows")


def _zeros(n: int, dtype, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=device)


def _eval_project(exprs, cols, nulls, valid):
    """Projection expressions over one shard; scalars broadcast to its rows."""
    out = [evaluate(e, cols, nulls) for e in exprs]
    vs = tuple(v.expand(valid.shape) if v.ndim == 0 else v for v, _ in out)
    ns = tuple(None if m is None else (m.expand(valid.shape) if m.ndim == 0 else m)
               for _, m in out)
    return vs, ns


def _resolve_project_dicts(node: P.Project, child_dicts):
    """Output dictionaries: planner-declared, else inherited through FieldRefs."""
    planner_dicts = node.dicts or tuple(None for _ in node.exprs)
    return tuple(
        pd if pd is not None
        else (child_dicts[e.index] if isinstance(e, FieldRef) else None)
        for pd, e in zip(planner_dicts, node.exprs))


def _pad_page(page: Page, cap: int) -> Page:
    """Pad a page to at least ``cap`` rows (new rows invalid): a zero-row
    build side then flows through the fixed-shape probe machinery."""
    n = page.capacity
    if n >= cap:
        return page
    dev = page.device
    cols = tuple(torch.cat([c, _zeros(cap - n, c.dtype, dev)]) for c in page.columns)
    nulls = tuple(None if m is None else torch.cat([m, _zeros(cap - n, torch.bool, dev)])
                  for m in page.null_masks)
    valid = torch.cat([page.valid_mask(), _zeros(cap - n, torch.bool, dev)]) \
        if n else _zeros(cap, torch.bool, dev)
    return Page(page.schema, cols, nulls, valid)


def _multi_probe_expand(node, mt, build_key_types, cols, nulls, valid,
                        expand_size: int, build_null_stats, semi: bool):
    """One shard's multi-match probe: the slot lookup (``hash_probe`` in slot
    mode) and the expansion at a STATIC expansion bucket.  A too-small
    bucket reports overflow through the stream contract (the executor
    retries bigger) instead of reading the expanded size.  Returns (cols, nulls,
    valid, oflow)."""
    keys = tuple(cols[i] for i in node.left_keys)
    kvalid = valid
    for i in node.left_keys:
        if nulls[i] is not None:
            kvalid = kvalid & ~nulls[i]
    slot, matched = probe_slots(mt.table, keys, build_key_types, kvalid)
    matched = matched & kvalid
    cnt = torch.where(matched, mt.counts[slot.to(torch.int64)], 0)
    if semi and node.filter is None:
        # existence test only: no expansion needed
        if node.kind == "semi":
            out_valid = valid & matched
        else:
            out_valid = _null_aware_anti(node, valid & ~matched, nulls, *build_null_stats)
        return tuple(cols), tuple(nulls), out_valid, False
    n = valid.shape[0]
    out_cnt = torch.where(valid, torch.clamp(cnt, min=1), 0) if node.kind == "left" else cnt
    incl = torch.cumsum(out_cnt, 0, dtype=torch.int32)
    oflow = incl[n - 1] > expand_size
    pidx, k, in_range = expand_counts(incl, out_cnt, expand_size)
    pl = pidx.to(torch.int64)
    is_match = matched[pl] & (k < cnt[pl]) & in_range
    pos = torch.clamp(mt.starts[slot[pl].to(torch.int64)] + k, 0, mt.order.shape[0] - 1)
    brow = torch.where(is_match, mt.order[pos.to(torch.int64)], 0).to(torch.int64)
    ocols = tuple(c[pl] for c in cols) + tuple(c[brow] for c in mt.build_columns)
    onulls = tuple(None if m is None else m[pl] for m in nulls) + tuple(
        None if m is None else m[brow] for m in mt.build_null_masks)
    passed = evaluate_predicate(node.filter, ocols, onulls, is_match) \
        if node.filter is not None else is_match
    if semi or node.kind == "left":
        any_pass = torch.zeros((n,), dtype=torch.int32, device=valid.device).scatter_reduce_(
            0, pl, passed.to(torch.int32), "amax", include_self=True).to(torch.bool)
        if semi:
            if node.kind == "semi":
                out_valid = valid & any_pass
            else:
                out_valid = _null_aware_anti(node, valid & ~any_pass, nulls,
                                             *build_null_stats)
            return tuple(cols), tuple(nulls), out_valid, oflow
        keep = passed | ((k == 0) & ~any_pass[pl] & in_range & valid[pl])
        onulls = onulls[:len(cols)] + tuple(
            (torch.zeros_like(passed) if m is None else m) | ~passed
            for m in onulls[len(cols):])
        return ocols, onulls, keep, oflow
    return ocols, onulls, passed, oflow  # inner


def _collation_luts(sort_keys, fields, dicts):
    """id -> collation-rank tables (host int64) of the dictionary-encoded
    sort keys: ids are assigned in insertion order, so device sorts compare
    decoded-value ranks instead (the local sort's tables, cached on each
    dictionary)."""
    return {sk.channel: _collation_rank_lut(dicts[sk.channel]) for sk in sort_keys
            if dicts[sk.channel] is not None and fields[sk.channel].type.is_string}


def _rankable(sort_keys, fields, dicts) -> bool:
    """Can every string sort key be ranked on the device?  A dictionary
    without a value list (names formatted from keys) cannot."""
    return all(not fields[k.channel].type.is_string
               or getattr(dicts[k.channel], "values", None) is not None
               for k in sort_keys)


def _lex_indices(sort_keys, luts_t, cols, nulls, valid):
    """Full stable sort permutation of one shard by ``sort_keys``, invalid
    rows last: the order the distributed TopN and full sort share."""
    lex = []  # _lexsort: the LAST key is the primary sort key
    for sk in reversed(sort_keys):
        c = cols[sk.channel]
        if sk.channel in luts_t:
            lut = luts_t[sk.channel]
            c = lut[torch.clamp(c, 0, lut.shape[0] - 1).to(torch.int64)]
        if c.dtype == torch.bool:
            c = c.to(torch.int8)
        if not sk.ascending:
            # bitwise complement is order-reversing AND total on ints
            # (arithmetic negation wraps -INT64_MIN back to itself)
            c = -c if c.is_floating_point() else ~c
        nm = nulls[sk.channel]
        ni = nm.to(torch.int8) if nm is not None \
            else torch.zeros(c.shape, dtype=torch.int8, device=c.device)
        if sk.nulls_first:
            ni = -ni
        lex.append(c)
        lex.append(ni)  # null placement outranks the value for this key
    lex.append((~valid).to(torch.int8))  # invalid rows sort last
    return _lexsort(lex, valid.shape[0], valid.device)


def _full_nulls(shards):
    """Shards whose null masks are all present (zeros where absent): the
    receive buffers and the collect paths carry one mask per column."""
    return [(cols, tuple(torch.zeros_like(valid) if m is None else m for m in nulls), valid)
            for cols, nulls, valid in shards]


class _HostFedBatches:
    """Lazy sequence of scan batches for connectors WITHOUT generation by
    row range (memory, blackhole, the file and DB-API connectors): batch b
    takes splits ``b * W .. b * W + W - 1``, pads each page to the batch's
    pow2 row capacity (at least 1024) and places page w on position w.
    Pages that already live on a device (memory, blackhole) are padded
    there; host-decoded pages (``HOST_DECODE``) are padded on the host and
    staged through ``_page_to_device`` (an ``h2d`` point; the bytes count
    in ``h2d_bytes``).  Only the last batch is kept, so the retry ladder
    re-reads without holding the table in memory.  Reference:
    SourcePartitionedScheduler.java:55 assigning any connector's splits
    across nodes."""

    def __init__(self, conn, table, columns, schema, mesh, count_h2d, start=0):
        self.conn, self.table = conn, table
        self.columns, self.schema, self.mesh = tuple(columns), schema, mesh
        self.count_h2d = count_h2d
        self.splits = list(conn.splits(table))
        self.start = start
        W = mesh.size
        self._n = max(0, -(-(len(self.splits) - start * W) // W))
        self._cache: dict = {}

    def __len__(self):
        return self._n

    def __iter__(self):
        return (self[i] for i in range(self._n))

    def __getitem__(self, i):
        if i < 0 or i >= self._n:
            raise IndexError(i)
        hit = self._cache.get(i)
        if hit is None:
            hit = self._build(i)
            self._cache = {i: hit}  # most-recent only: bounded memory
        return hit

    def _build(self, i):
        mesh = self.mesh
        W = mesh.size
        base = (self.start + i) * W
        pages = [self.conn.generate(s, list(self.columns))
                 for s in self.splits[base:base + W]]
        rows = max((p.capacity for p in pages), default=1)
        cap = max(1 << max(rows - 1, 1).bit_length(), 1024)
        dtypes = [torch_dtype(f.type) for f in self.schema.fields]
        out = []
        for w, dev in enumerate(mesh.devices):
            if w >= len(pages):
                out.append((tuple(_zeros(cap, dt, dev) for dt in dtypes),
                            tuple(None for _ in dtypes), _zeros(cap, torch.bool, dev)))
                continue
            p = pages[w]
            if any(isinstance(c, np.ndarray) for c in p.columns):
                p = self._stage(p, cap, dev)
            p = _pad_page(Page(p.schema, p.columns, p.null_masks, p.valid_mask()), cap)
            out.append((tuple(c.to(dev) for c in p.columns),
                        tuple(None if m is None else m.to(dev) for m in p.null_masks),
                        p.valid.to(dev)))
        return out

    def _stage(self, page, cap, dev):
        """A host-decoded page padded on the host and staged to ``dev``."""
        n = page.capacity

        def pad(a, dt):
            out = np.zeros((cap,), dt)
            out[:n] = a
            return out

        valid = np.ones((n,), bool) if page.valid is None else np.asarray(page.valid)
        host = Page(page.schema,
                    tuple(pad(np.asarray(c), np.asarray(c).dtype) for c in page.columns),
                    tuple(None if m is None else pad(np.asarray(m), bool)
                          for m in page.null_masks),
                    pad(valid, bool))
        staged, nbytes, _ = _page_to_device(host, dev, None)
        self.count_h2d(nbytes)
        return staged


@dataclasses.dataclass
class _DStream:
    """A distributed streaming fragment: a per-position scan source and a
    transform over the W shards of a batch."""

    schema: Schema
    dicts: tuple
    scan_lo_batches: object  # per batch: W split offsets (generated) or W shards (host-fed)
    scan_fn: Callable  # (batch) -> W shards (cols, nulls, valid), one per position
    rows: int  # lanes per position of one scan batch
    transform: Callable  # (W shards) -> (W shards, W overflow flags)
    # a flag is True (a 0-d bool tensor, or the python False when it cannot
    # be set) when an exchange or expansion bucket of the fragment dropped
    # rows this batch; the consumer retries the whole run with bigger
    # buckets (_retry_exchange)


def _identity_transform(shards):
    return shards, [False] * len(shards)


def _stream_batch(stream: _DStream, batch):
    """One batch's scan and transform on every position."""
    return stream.transform(stream.scan_fn(batch))


class DistributedExecutor:
    """Executes plans across the worker mesh; blocking sub-plans (join build
    sides, fragments the mesh cannot run) go to the embedded LocalExecutor
    on the mesh's first device."""

    def __init__(self, catalogs: dict, mesh=None, partition_threshold: int = 1 << 17,
                 device_exchange=None, memory_pool=None, dispatch_batch=None):
        self.catalogs = catalogs
        self.mesh = mesh if mesh is not None else worker_mesh()
        self.n_workers = self.mesh.size
        # device-resident exchange: routed rows append into per-position
        # device receive buffers, and a run reads only cursors and overflow
        # flags; =0 restores the host spool
        if device_exchange is None:
            device_exchange = os.environ.get("TRINO_TPU_DEVICE_EXCHANGE", "1") != "0"
        self.device_exchange = bool(device_exchange)
        self.local = LocalExecutor(catalogs, self.mesh.devices[0], memory_pool=memory_pool)
        # the fragments that run locally coalesce at the statement's width
        self.local.dispatch_batch = dispatch_batch
        # a kernel launches on the current device's stream: positions on
        # other cards run their steps with their device current
        self._switch = len(self.mesh.distinct_devices) > 1 and any(
            d.type == "cuda" for d in self.mesh.devices)
        # build sides at/above this row count join PARTITIONED (reference:
        # DetermineJoinDistributionType's size-based choice)
        self.partition_threshold = partition_threshold
        self._probe_factor, self._expand_factor = _EXCHANGE_LADDER[0]
        # per-execute build artifacts keyed by plan-node id: the retry
        # ladder re-compiles only the probe side
        self._build_cache: dict = {}
        self.exec_trace: list = []
        self._decline_reason = None
        self.counters = tracing.QueryCounters()
        # per-exchange shard skew keyed by plan-node id (EXPLAIN ANALYZE's
        # [skew: ...] annotations, the plan history's skew facts)
        self.skew_by_node: dict = {}

    # ------------------------------------------------------------------ public
    def execute(self, node: P.PlanNode) -> MaterializedResult:
        self._build_cache = {}
        self.exec_trace = []  # [(node label, mode, reason)]: which fragments
        # ran on the mesh and which fell back; EXPLAIN ANALYZE prints it
        self._decline_reason = None
        self.skew_by_node = {}
        self.counters = tracing.QueryCounters()
        loc = self.local
        loc.host_reads = loc.host_bytes = loc.h2d_bytes = 0
        try:
            with tracing.track_counters(self.counters), device_constants(loc._count_h2d):
                page, dicts = self._execute_to_page(node)
                return loc._materialize(page, dicts)
        finally:
            # blocking sub-plans ran on the embedded LocalExecutor, which may
            # have started prefetch producers and reserved build memory
            loc.close_producers()
            loc._release_reserved()
            self.counters.host_reads += loc.host_reads
            self.counters.host_bytes += loc.host_bytes
            self.counters.h2d_bytes += loc.h2d_bytes

    def _decline(self, node, reason: str):
        """Record why a fragment cannot run on the mesh (deepest cause wins:
        the first decline bubbling out of a recursive compile)."""
        if self._decline_reason is None:
            self._decline_reason = f"{type(node).__name__}: {reason}"
        return None

    def _trace(self, node, mode: str, reason: str = None):
        label = type(node).__name__
        if isinstance(node, P.TableScan):
            label = f"TableScan[{node.table}]"
        self.exec_trace.append((label, mode, reason))

    def _take_decline(self) -> str:
        r = self._decline_reason or "fragment shape not distributable"
        self._decline_reason = None
        return r

    def _note_skew(self, site: str, node, per_worker, wall_s: float,
                   kind: str = "exchange", fields=None):
        """Fold a per-position load vector the caller already read into the
        query's shard_stats, keyed by plan node for EXPLAIN ANALYZE."""
        bpr = None
        if fields:
            bpr = sum(np.dtype(f.type.dtype).itemsize for f in fields
                      if np.dtype(f.type.dtype) != object) or None
        rec = record_shard_stats(site, per_worker, wall_s=wall_s, kind=kind,
                                 op=None if node is None else type(node).__name__,
                                 bytes_per_row=bpr)
        if node is not None and rec is not None:
            self.skew_by_node[id(node)] = rec
        return rec

    # ------------------------------------------------------------ positions
    def _ctx(self, w: int):
        """Position w's device as the current one (multi-card meshes)."""
        return torch.cuda.device(self.mesh.devices[w]) if self._switch \
            else contextlib.nullcontext()

    def _each(self, fn, *seqs) -> list:
        """``[fn(w, a[w], b[w], ...)]`` over the positions, each with its
        device current: one per-worker step on every position."""
        out = []
        for w in range(self.n_workers):
            with self._ctx(w):
                out.append(fn(w, *(s[w] for s in seqs)))
        return out

    def _read(self, values, site: str) -> list:
        """Host values of 0-d device tensors in ONE counted read (each
        device's tensors stacked into one copy); python scalars pass as they
        are, and a list of them reads nothing."""
        by_dev: dict = {}
        for i, v in enumerate(values):
            if isinstance(v, torch.Tensor):
                by_dev.setdefault(v.device, []).append(i)
        out = [v if not isinstance(v, torch.Tensor) else None for v in values]
        if not by_dev:
            return [int(v) for v in out]
        groups = list(by_dev.values())
        got = self.local._host(
            [torch.stack([values[i].reshape(()).to(torch.int64) for i in idx])
             for idx in groups], site=site)
        for idx, arr in zip(groups, got):
            for i, x in zip(idx, arr.tolist()):
                out[i] = x
        return [int(v) for v in out]

    # ---------------------------------------------------------------- retries
    def _retry_exchange(self, run_once):
        """The overflow side channel's host half: run a fragment; when any
        position reports an exchange or expansion bucket overflow, climb the
        ladder (bigger buckets) and run again from scratch.  Returns the
        result, or None when the fragment cannot run on the mesh."""
        for pf, ef in _EXCHANGE_LADDER:
            self._probe_factor, self._expand_factor = pf, ef
            out = run_once()
            if out is None:
                return None
            result, oflow = out
            if not oflow:
                return result
        return None  # pathological expansion: the local executor takes it

    # ---------------------------------------------------------------- plan walk
    def _execute_to_page(self, node: P.PlanNode):
        loc = self.local
        if isinstance(node, P.Output):
            child, dicts = self._execute_to_page(node.child)
            return Page(node.schema, child.columns, child.null_masks, child.valid), dicts
        if isinstance(node, P.Sort):
            out = self._run_sort(node)
            if out is not None:
                self._trace(node, "mesh")
                return out
            self._trace(node, "coordinator", self._take_decline())
            child, dicts = self._execute_to_page(node.child)
            return loc._sort_or_topn(child, node.keys, None, dicts), dicts
        if isinstance(node, P.Window):
            out = self._run_window_dist(node)
            if out is not None:
                self._trace(node, "mesh")
                return out
            self._trace(node, "local", self._take_decline())
            return loc._execute_to_page(node)
        if isinstance(node, P.Limit):
            if isinstance(node.child, P.Sort):
                # TopN over a streamable fragment: a running top-N per
                # position and one ordered merge (reference: TopNOperator
                # per task + MergeOperator at the gather stage)
                def once(node=node):
                    stream = self._compile_stream(node.child.child)
                    if stream is None:
                        return None
                    return self._run_topn(stream, node.child.keys, node.count, node=node)

                out = self._retry_exchange(once)
                if out is not None:
                    self._trace(node, "mesh")
                    return out
                self._trace(node, "coordinator", self._take_decline())
            child, dicts = self._execute_to_page(node.child)
            return loc._limit_page(child, node.count), dicts
        if isinstance(node, P.Aggregate):
            return self._run_aggregate(node)
        if isinstance(node, P.Union):
            # grouping sets (and set-op ALL) plan to a Union of aggregate
            # branches: each branch runs distributed, and the (small,
            # post-aggregation) pages gather on the coordinator
            parts = [self._execute_to_page(c) for c in node.inputs]
            self._trace(node, "coordinator", "gather of distributed branches")
            cols_list, nulls_list = [], []
            for pg, _ in parts:
                v, pcols, pnulls = loc._host_page(pg)  # one read per branch
                cols_list.append([np.asarray(c)[v] for c in pcols])
                nulls_list.append([None if m is None else np.asarray(m)[v] for m in pnulls])
            ncols = len(node.schema.fields)
            out_cols = tuple(np.concatenate([p[i] for p in cols_list]) for i in range(ncols))
            out_nulls = tuple(
                np.concatenate([n[i] if n[i] is not None else np.zeros(len(c[i]), bool)
                                for n, c in zip(nulls_list, cols_list)])
                if any(n[i] is not None for n in nulls_list) else None
                for i in range(ncols))
            return Page(node.schema, out_cols, out_nulls, None), parts[0][1]

        def once(node=node):
            stream = self._compile_stream(node)
            if stream is None:
                return None
            return self._materialize_dstream(stream, node=node)

        out = self._retry_exchange(once)
        if out is not None:
            self._trace(node, "mesh")
            return out
        if isinstance(node, (P.Project, P.Filter)):
            # a Project/Filter ABOVE a blocking operator (post-aggregation
            # projections, HAVING filters) is not part of a scan-fed stream:
            # the child runs distributed and the expressions apply to its
            # (small) materialized page here
            self._trace(node, "coordinator", self._take_decline())
            child, cdicts = self._execute_to_page(node.child)
            return self._apply_rowwise(node, child, cdicts)
        self._trace(node, "local", self._take_decline())
        return loc._execute_to_page(node)

    def _apply_rowwise(self, node, child: Page, cdicts):
        """A Project/Filter over one materialized page, on the device."""
        child = self.local._device_page(child)
        valid = child.valid_mask()
        if isinstance(node, P.Filter):
            valid = evaluate_predicate(node.predicate, child.columns, child.null_masks, valid)
            return Page(node.schema, child.columns, child.null_masks, valid), cdicts
        vs, ns = _eval_project(node.exprs, child.columns, child.null_masks, valid)
        return Page(node.schema, vs, ns, child.valid), _resolve_project_dicts(node, cdicts)

    # ---------------------------------------------------------------- streaming
    def _compile_stream(self, node: P.PlanNode) -> Optional[_DStream]:
        """The distributed streaming fragment, or None when it has no
        distributable scan spine (the executor then falls back)."""
        mesh, W = self.mesh, self.n_workers
        if isinstance(node, P.TableScan):
            conn = self.catalogs[node.catalog]
            dicts = tuple(conn.dictionaries(node.table).get(c) for c in node.columns) \
                if hasattr(conn, "dictionaries") else tuple(None for _ in node.columns)
            if not hasattr(conn, "generate_traced"):
                # host-fed sharded scan: the coordinator's split queue feeds
                # fixed-capacity per-position batches
                if not (hasattr(conn, "generate") and hasattr(conn, "splits")):
                    return self._decline(node, "connector has no split scan "
                                               "surface (no splits/generate)")
                if any(np.dtype(f.type.dtype) == object for f in node.schema.fields):
                    return self._decline(node, "wide-decimal (object) columns "
                                               "cannot cross to the device")
                batches = _HostFedBatches(conn, node.table, node.columns, node.schema,
                                          mesh, self.local._count_h2d)
                rows = batches[0][0][2].shape[0] if len(batches) else 0
                return _DStream(node.schema, dicts, batches, lambda b: b, rows,
                                _identity_transform)
            splits = conn.splits(node.table, n_hint=W)
            step = splits[0].hi - splits[0].lo
            lo_batches = [[splits[b * W + d].lo for d in range(W)]
                          for b in range(len(splits) // W)]

            def scan_fn(los, conn=conn, node=node, step=step):
                def one(w, lo):
                    cols, valid = conn.generate_traced(node.table, lo, step, node.columns)
                    if valid is None:
                        valid = torch.ones(cols[0].shape, dtype=torch.bool,
                                           device=cols[0].device)
                    dev = mesh.devices[w]
                    return (tuple(c.to(dev) for c in cols), tuple(None for _ in cols),
                            valid.to(dev))
                return self._each(one, los)

            return _DStream(node.schema, dicts, lo_batches, scan_fn, step,
                            _identity_transform)

        if isinstance(node, P.Filter):
            up = self._compile_stream(node.child)
            if up is None:
                return None

            def transform(shards, up=up, pred=node.predicate):
                shards, of = up.transform(shards)
                return self._each(lambda w, sh: (sh[0], sh[1], evaluate_predicate(
                    pred, sh[0], sh[1], sh[2])), shards), of

            return dataclasses.replace(up, transform=transform)

        if isinstance(node, P.Project):
            up = self._compile_stream(node.child)
            if up is None:
                return None

            def transform(shards, up=up, exprs=node.exprs):
                shards, of = up.transform(shards)
                return self._each(lambda w, sh: _eval_project(exprs, *sh) + (sh[2],),
                                  shards), of

            return dataclasses.replace(up, schema=node.schema,
                                       dicts=_resolve_project_dicts(node, up.dicts),
                                       transform=transform)

        if isinstance(node, P.Join):
            if node.kind == "mark":
                return self._decline(node, "mark joins (EXISTS in expression position) "
                                           "run the local executor")
            up = self._compile_stream(node.left)
            if up is None:
                return None
            # build side: local (blocking) execution, kept across ladder rungs
            hit = self._build_cache.get(("page", id(node)))
            if hit is None:
                hit = self.local._execute_to_page_streamed(node.right)
                self._build_cache[("page", id(node))] = hit
            build_page, build_dicts = hit
            build_key_types = tuple(node.right.schema.fields[i].type for i in node.right_keys)
            if build_page.capacity == 0:
                # an empty build probes a tiny all-invalid table: inner/semi
                # match nothing, left/anti keep every probe row
                build_page = _pad_page(build_page, 16)
            multi = self._has_duplicate_keys(build_page, node.right_keys, build_key_types)
            # NOT IN three-valued-logic facts (shared with the local executor)
            build_null_stats = self.local._build_null_stats(build_page, node.right_keys)
            # distribution: the planner's stats-driven hint decides when
            # present; AUTOMATIC plans ('replicated') fall back to the size
            n_build = self._read([torch.sum(build_page.valid_mask(), dtype=torch.int64)],
                                 "dist.join.buildsize")[0]
            hint = getattr(node, "distribution", "replicated")
            partitioned = (hint == "partitioned"
                           or (hint != "broadcast" and n_build >= self.partition_threshold))
            if partitioned:
                if multi:
                    return self._compile_partitioned_multi_join(
                        node, up, build_page, build_dicts, build_key_types,
                        build_null_stats)
                return self._compile_partitioned_join(node, up, build_page, build_dicts,
                                                      build_key_types, build_null_stats)
            if multi:
                return self._compile_broadcast_multi_join(
                    node, up, build_page, build_dicts, build_key_types, build_null_stats)
            table = self._build_cache.get(("btable", id(node)))
            if table is None:
                table = self.local._build_join_table(build_page, node.right_keys,
                                                     build_key_types)
                if table is None:
                    return self._decline(node, "duplicate build keys with a residual "
                                               "filter shape the multi-join paths do "
                                               "not cover")
                table = self._build_cache[("btable", id(node))] = mesh.replicate(table)
            semi = node.kind in ("semi", "anti")

            def probe_one(w, sh, node=node, semi=semi, tables=table):
                cols, nulls, valid = sh
                jt = tables[w]
                row_ids, matched = probe(jt, tuple(cols[i] for i in node.left_keys),
                                         build_key_types, valid)
                for i in node.left_keys:
                    if nulls[i] is not None:
                        matched = matched & ~nulls[i]
                if node.filter is not None:
                    # the residual filter is part of the MATCH condition for
                    # every join kind (unique build: one candidate row)
                    fcols, fnulls = _gather_build(jt, row_ids, matched, "left")
                    matched = matched & evaluate_predicate(
                        node.filter, tuple(cols) + fcols, tuple(nulls) + fnulls, matched)
                if node.kind == "anti":
                    valid = _null_aware_anti(node, valid & ~matched, nulls, *build_null_stats)
                elif node.kind in ("inner", "semi"):
                    valid = valid & matched
                if semi:
                    return cols, nulls, valid
                bcols, bnulls = _gather_build(jt, row_ids, matched, node.kind)
                return tuple(cols) + bcols, tuple(nulls) + bnulls, valid

            def transform(shards, up=up):
                shards, of = up.transform(shards)
                return self._each(probe_one, shards), of

            dicts = up.dicts if semi else up.dicts + build_dicts
            return dataclasses.replace(up, schema=node.schema, dicts=dicts,
                                       transform=transform)

        return self._decline(node, "operator is not part of a streamable "
                                   "fragment (blocking or unsupported shape)")

    def _has_duplicate_keys(self, build_page: Page, key_channels, key_types) -> bool:
        """Duplicate-key check on the materialized build page, in one read at
        ``dist.build.dupcheck``.  Device mode sorts the packed keys (valid
        rows first) and reads one boolean; the host spool reads the masks
        and the packed keys.  Both read a fingerprint collision as a
        duplicate, the conservative direction (the multi-match path)."""
        valid = build_page.valid_mask()
        for ch in key_channels:
            nm = build_page.null_masks[ch]
            if nm is not None:
                valid = valid & ~nm
        packed, _ = pack_keys(tuple(build_page.columns[ch] for ch in key_channels),
                              key_types)
        if self.device_exchange:
            order = _lexsort([packed, (~valid).to(torch.int8)], packed.shape[0],
                             packed.device)
            sp, sv = packed[order], valid[order]
            dup = torch.any((sp[1:] == sp[:-1]) & sv[1:] & sv[:-1])
            return bool(self._read([dup], "dist.build.dupcheck")[0])
        v, keys = self.local._host([valid, packed], site="dist.build.dupcheck")
        n = int(v.sum())
        return n > 0 and len(np.unique(keys[v])) < n

    # ------------------------------------------------------------- the exchange
    def _route_rows(self, shards, pids, bucket: int):
        """Hash-route one batch of shards across the mesh: pack the columns
        and present null masks, ``bucketize`` by partition id, exchange all
        to all, and re-slot the null masks on the receive side.  The one
        routing protocol of the partitioned join's build and probe, the
        collect paths and the group merge.  Returns (received shards,
        per-position SEND-side overflow flags)."""
        W = self.n_workers
        ncols = len(shards[0][0])
        null_slots = sorted({ci for _, nulls, _ in shards
                             for ci, m in enumerate(nulls) if m is not None})

        def pack(w, sh, pid):
            cols, nulls, valid = sh
            payload = tuple(cols) + tuple(
                torch.zeros_like(valid) if nulls[ci] is None else nulls[ci]
                for ci in null_slots)
            return bucketize(payload, valid, pid, W, bucket)

        sent = self._each(pack, shards, pids)
        recv, recv_valid = exchange_all_to_all(self.mesh, [s[0] for s in sent],
                                               [s[1] for s in sent])
        out = []
        for w in range(W):
            rnulls = [None] * ncols
            for j, ci in enumerate(null_slots):
                rnulls[ci] = recv[w][ncols + j]
            out.append((recv[w][:ncols], tuple(rnulls), recv_valid[w]))
        return out, [s[2] for s in sent]

    def _probe_bucket(self, n: int) -> int:
        """Per-partition probe-exchange bucket for an n-row batch: ~(factor/W)
        * n on the ladder's adaptive rungs, exact n on the safe rung."""
        pf = self._probe_factor
        if pf is None:
            return n
        return max(min(n, -(-n * pf // self.n_workers)), 1)

    # ---------------------------------------------------------------- partitioned join
    def _compile_partitioned_join(self, node: P.Join, up: _DStream, build_page,
                                  build_dicts, build_key_types,
                                  build_null_stats=(False, True)) -> _DStream:
        """Hash-partitioned join: BOTH sides route through the hash exchange
        (FIXED_HASH).  The build page shards across the positions, each
        chunk routes to its hash owners, and each position builds the table
        of its own key range (``hash_insert_``), so a position holds
        O(build/W) rows; every probe batch routes the same way."""
        W = self.n_workers
        semi = node.kind in ("semi", "anti")

        def make_table(ccols, cnulls, cvalid, cap_r, n_recv, node=node):
            rpage = Page(node.right.schema, ccols, cnulls, cvalid)
            jt = build_insert(build_table_init(2 * cap_r, rpage),
                              tuple(ccols[ch] for ch in node.right_keys),
                              build_key_types, cvalid)
            # skew overflow: more rows hashed to this position than cap_r holds
            return dataclasses.replace(jt, overflow=jt.overflow | (n_recv > cap_r))

        tables = self._build_cache.get(("ptable", id(node)))
        if tables is None:
            tables = self._sharded_build_exchange(node, build_page, make_table)
            self._build_cache[("ptable", id(node))] = tables

        def probe_one(w, sh, node=node):
            rcols, rnulls, recv_valid = sh
            jt = tables[w]
            kvalid = recv_valid
            for i in node.left_keys:
                if rnulls[i] is not None:
                    kvalid = kvalid & ~rnulls[i]
            row_ids, matched = probe(jt, tuple(rcols[i] for i in node.left_keys),
                                     build_key_types, kvalid)
            matched = matched & kvalid
            if node.filter is not None:
                # match-condition residual for every join kind (unique build)
                fcols, fnulls = _gather_build(jt, row_ids, matched, "left")
                matched = matched & evaluate_predicate(
                    node.filter, tuple(rcols) + fcols, tuple(rnulls) + fnulls, matched)
            if node.kind in ("inner", "semi"):
                out_valid = recv_valid & matched
            elif node.kind == "anti":
                out_valid = _null_aware_anti(node, recv_valid & ~matched, rnulls,
                                             *build_null_stats)
            else:  # left
                out_valid = recv_valid
            if semi:
                return tuple(rcols), tuple(rnulls), out_valid
            gcols, gnulls = _gather_build(jt, row_ids, matched, node.kind)
            return tuple(rcols) + gcols, tuple(rnulls) + gnulls, out_valid

        def transform(shards, up=up, node=node):
            shards, of = up.transform(shards)
            # NULL probe keys never match but must SURVIVE for left/anti:
            # they route (to their hash bucket) like any other row
            pids = self._each(lambda w, sh: partition_ids(
                tuple(sh[0][i] for i in node.left_keys), W), shards)
            routed, r_of = self._route_rows(shards, pids,
                                            self._probe_bucket(shards[0][2].shape[0]))
            return self._each(probe_one, routed), [a | b for a, b in zip(of, r_of)]

        dicts = up.dicts if semi else up.dicts + build_dicts
        return dataclasses.replace(up, schema=node.schema, dicts=dicts, transform=transform)

    def _sharded_build_exchange(self, node: P.Join, build_page, make_table) -> list:
        """The partitioned-join build both table layouts share: shard the
        build page across the positions, route each chunk to its hash
        owners, compact each received partition to cap_r rows
        (``compact_rows``) and build that position's table with
        ``make_table(ccols, cnulls, cvalid, cap_r, n_recv)``.  cap_r grows
        4x until no position overflows; the flags of all W positions are
        read in one read a try."""
        W = self.n_workers
        n_b = build_page.capacity
        chunk = max((n_b + W - 1) // W, 4)
        padded = _pad_page(build_page, W * chunk)
        valid = padded.valid_mask()
        for ch in node.right_keys:
            nm = padded.null_masks[ch]
            if nm is not None:
                valid = valid & ~nm  # NULL build keys never match: not routed

        def chunk_of(a, w):
            return None if a is None else a[w * chunk:(w + 1) * chunk]

        shards = self.mesh.place([
            (tuple(chunk_of(c, w) for c in padded.columns),
             tuple(chunk_of(m, w) for m in padded.null_masks), chunk_of(valid, w))
            for w in range(W)])
        pids = self._each(lambda w, sh: partition_ids(
            tuple(sh[0][ch] for ch in node.right_keys), W), shards)
        # the same capacity on every position, grown together; start at ~2x
        # the balanced share to absorb moderate hash skew without a retry
        cap_r = max(1 << max(2 * chunk - 1, 1).bit_length(), 32)
        while True:
            _exchange_fault("exchange_write", "dist.join.build_exchange")
            with maybe_span("exchange.route"):
                # the send bucket is the chunk: a position sends at most its
                # chunk's rows in total, so it never overflows
                routed, _ = self._route_rows(shards, pids, chunk)

                def build(w, sh, cap_r=cap_r):
                    rcols, rnulls, recv_valid = sh
                    n_recv = torch.sum(recv_valid, dtype=torch.int64)
                    packed, _ = compact_rows(tuple(rcols) + tuple(rnulls), recv_valid, cap_r)
                    cvalid = torch.arange(cap_r, device=recv_valid.device) < n_recv
                    return make_table(packed[:len(rcols)], packed[len(rcols):], cvalid,
                                      cap_r, n_recv)

                tables = self._each(build, routed)
            if not any(self._read([t.overflow for t in tables], "dist.join.overflow")):
                return tables
            cap_r *= 4

    # ---------------------------------------------------------------- multi-match joins
    def _compile_broadcast_multi_join(self, node: P.Join, up: _DStream, build_page,
                                      build_dicts, build_key_types,
                                      build_null_stats) -> _DStream:
        """Duplicate-key build, replicated: one slot-grouped MultiJoinTable
        (PositionLinks' counterpart) on every device; each position expands
        its own probe batch at a static bucket (overflow -> a ladder retry)."""
        semi = node.kind in ("semi", "anti")
        mts = self._build_cache.get(("bmtable", id(node)))
        if mts is None:
            capacity = max(1 << max(build_page.capacity - 1, 1).bit_length(), 16) * 2
            mt = multi_build(capacity, build_page, node.right_keys, build_key_types,
                             lambda arrays: self.local._host(arrays,
                                                             site="dist.join.multi.overflow"))
            mts = self._build_cache[("bmtable", id(node))] = self.mesh.replicate(mt)
        ef = self._expand_factor

        def expand_one(w, sh):
            cols, nulls, valid = sh
            E = max(ef * valid.shape[0], 1024)
            return _multi_probe_expand(node, mts[w], build_key_types, tuple(cols),
                                       tuple(nulls), valid, E, build_null_stats, semi)

        def transform(shards, up=up):
            shards, of = up.transform(shards)
            out = self._each(expand_one, shards)
            return [o[:3] for o in out], [a | o[3] for a, o in zip(of, out)]

        dicts = up.dicts if semi else up.dicts + build_dicts
        return dataclasses.replace(up, schema=node.schema, dicts=dicts, transform=transform)

    def _compile_partitioned_multi_join(self, node: P.Join, up: _DStream, build_page,
                                        build_dicts, build_key_types,
                                        build_null_stats) -> _DStream:
        """Duplicate-key build, partitioned: the build routes through the
        same exchange as the unique path, and each position builds a
        slot-grouped MultiJoinTable over ITS key partition; probe batches
        route per batch and expand per position.  (Reference: per-task
        PositionLinks over the FIXED_HASH exchange.)"""
        W = self.n_workers
        semi = node.kind in ("semi", "anti")

        def make_table(ccols, cnulls, cvalid, cap_r, n_recv, node=node):
            table = torch.full((2 * cap_r + 1,), EMPTY_KEY, dtype=torch.int64,
                               device=cvalid.device)
            counts, starts, order, boflow = _multi_build_step(
                table, tuple(ccols[ch] for ch in node.right_keys), build_key_types, cvalid)
            return MultiJoinTable(table, counts, starts, order, ccols, cnulls,
                                  boflow | (n_recv > cap_r))

        mts = self._build_cache.get(("pmtable", id(node)))
        if mts is None:
            mts = self._sharded_build_exchange(node, build_page, make_table)
            self._build_cache[("pmtable", id(node))] = mts
        ef = self._expand_factor

        def transform(shards, up=up, node=node):
            shards, of = up.transform(shards)
            n = shards[0][2].shape[0]
            pids = self._each(lambda w, sh: partition_ids(
                tuple(sh[0][i] for i in node.left_keys), W), shards)
            routed, r_of = self._route_rows(shards, pids, self._probe_bucket(n))
            E = max(ef * n, 1024)
            out = self._each(lambda w, sh: _multi_probe_expand(
                node, mts[w], build_key_types, tuple(sh[0]), tuple(sh[1]), sh[2], E,
                build_null_stats, semi), routed)
            return [o[:3] for o in out], [a | b | o[3] for a, b, o in zip(of, r_of, out)]

        dicts = up.dicts if semi else up.dicts + build_dicts
        return dataclasses.replace(up, schema=node.schema, dicts=dicts, transform=transform)

    # ---------------------------------------------------------------- sort
    def _run_sort(self, node: P.Sort):
        """Distributed full ORDER BY: sample-based range partitioning
        (splitters from the first scan batch) routes every row to the
        position owning its key range; each position sorts its range, and
        the ranges concatenate in rank order.  Ties on the primary key all
        land on one position (searchsorted is value-deterministic), so the
        secondary keys resolve within a shard.  Reference: per-task
        OrderByOperator + the merging exchange, re-planned as a range
        exchange and shard-parallel sorts."""
        return self._retry_exchange(lambda: self._run_sort_once(node))

    def _run_sort_once(self, node: P.Sort):
        stream = self._compile_stream(node.child)
        if stream is None or not len(stream.scan_lo_batches):
            return None
        keys = node.keys
        if not keys:
            return None
        fields = stream.schema.fields
        if not _rankable(keys, fields, stream.dicts):
            return self._decline(node, "a string sort key whose dictionary cannot "
                                       "rank on the device")
        W = self.n_workers
        luts = _collation_luts(keys, fields, stream.dicts)
        pk = keys[0]
        ch = pk.channel
        luts_d = self._each(lambda w: {c: device_array(l, self.mesh.devices[w])
                                       for c, l in luts.items()})

        # the sample pass: batch 0's primary-key ranks give the W-1 range
        # splitters.  Device mode reads only the key channel and validity,
        # and batch 0 routes on the mesh with every other batch; the host
        # spool reads the whole batch, whose rows seed the collect buffers
        shards, of = _stream_batch(stream, stream.scan_lo_batches[0])
        if self.device_exchange:
            fetch = []
            for cols, nulls, valid in shards:
                nm = nulls[ch] if nulls[ch] is not None else torch.zeros_like(valid)
                fetch += [cols[ch], nm, valid]
            got = self.local._host(fetch + [f for f in of if isinstance(f, torch.Tensor)],
                                   site="dist.sort.sample")
            if any(bool(np.any(g)) for g in got[3 * W:]):
                return None, True
            key0 = np.concatenate(got[0:3 * W:3])
            keynull0 = np.concatenate(got[1:3 * W:3])
            valid0 = np.concatenate(got[2:3 * W:3])
            seed, skip = None, 0
        else:
            full = _full_nulls(shards)
            nc = len(fields)
            fetch = [a for cols, nulls, valid in full for a in (*cols, *nulls, valid)]
            got = self.local._host(fetch + [f for f in of if isinstance(f, torch.Tensor)],
                                   site="dist.sort.sample")
            if any(bool(np.any(g)) for g in got[W * (2 * nc + 1):]):
                return None, True
            per = [got[w * (2 * nc + 1):(w + 1) * (2 * nc + 1)] for w in range(W)]
            cols0 = [np.concatenate([p[i] for p in per]) for i in range(nc)]
            nulls0 = [np.concatenate([p[nc + i] for p in per]) for i in range(nc)]
            valid0 = np.concatenate([p[2 * nc] for p in per])
            key0, keynull0 = cols0[ch], nulls0[ch]
        lut_np = luts.get(ch)

        def rank_host(c):
            if lut_np is not None:
                c = lut_np[np.clip(c, 0, len(lut_np) - 1)]
            if c.dtype == np.bool_:
                c = c.astype(np.int8)
            return -c if not pk.ascending else c

        rv0 = rank_host(key0)
        ok = valid0 & ~keynull0
        ranks = np.sort(rv0[ok])
        if ranks.size:
            splitters = ranks[[(i * ranks.size) // W for i in range(1, W)]]
        else:
            splitters = np.zeros((W - 1,), rv0.dtype)
        if not self.device_exchange:
            # batch 0 routes on the host (the searchsorted the device runs)
            pid0 = np.searchsorted(splitters, rv0, side="left").astype(np.int32)
            pid0 = np.where(keynull0, 0 if pk.nulls_first else W - 1, pid0)
            seed = ([[[cols0[i][valid0 & (pid0 == w)]] for i in range(len(fields))]
                     for w in range(W)],
                    [[[nulls0[i][valid0 & (pid0 == w)]] for i in range(len(fields))]
                     for w in range(W)])
            skip = 1
        spl_d = self._each(lambda w: torch.as_tensor(splitters, device=self.mesh.devices[w]))

        def pid_fn(w, cols, nulls, valid):
            c = cols[ch]
            lut = luts_d[w].get(ch)
            if lut is not None:
                c = lut[torch.clamp(c, 0, lut.shape[0] - 1).to(torch.int64)]
            if c.dtype == torch.bool:
                c = c.to(torch.int8)
            rv = -c if not pk.ascending else c
            pid = torch.searchsorted(spl_d[w].to(rv.dtype), rv, side="left").to(torch.int32)
            nm = nulls[ch]
            if nm is not None:
                pid = torch.where(nm, 0 if pk.nulls_first else W - 1, pid).to(torch.int32)
            return pid

        # exact per-partition bucket (= n): range keys are routinely CLUSTERED
        # (a key correlated with scan order sends whole batches to one
        # range), which would overflow the hash-uniform ~2n/W bucket
        collected = self._exchange_collect(stream, pid_fn, skip_batches=skip, seed=seed,
                                           bucket_of=lambda n: n, node=node)
        if collected is None:
            return None, True
        shards, counts = collected
        if sum(counts) == 0:
            page = Page(stream.schema, tuple(_zeros(0, torch_dtype(f.type),
                                                    self.local.device) for f in fields),
                        tuple(None for _ in fields), None)
            return (page, stream.dicts), False

        def sort_shard(w, sh):
            cols, nulls, valid = sh
            idx = _lex_indices(keys, luts_d[w], cols, nulls, valid)
            return tuple(c[idx] for c in cols), tuple(m[idx] for m in nulls)

        # sorted shards: valid rows lead (``~valid`` is the last lex key), so
        # position w contributes exactly its counts[w] head rows, in rank order
        out = self._each(sort_shard, shards)
        page = self._page_from_shards(stream.schema, [o[0] for o in out],
                                      [o[1] for o in out], counts)
        return (page, stream.dicts), False

    # ---------------------------------------------------------------- window
    def _run_window_dist(self, node: P.Window):
        """Distributed window evaluation: rows hash-route by the (shared)
        PARTITION BY key so each position owns whole partitions, then the
        local window kernel runs per shard (pad rows form their own
        partition through its ``valid``).  Reference: the hash exchange
        below WindowNode + per-task WindowOperator."""
        specs = node.specs
        part = specs[0].partition
        if not part or any(s.partition != part for s in specs):
            return None  # no common non-empty PARTITION BY -> not routable
        return self._retry_exchange(lambda: self._run_window_once(node))

    def _run_window_once(self, node: P.Window):
        stream = self._compile_stream(node.child)
        if stream is None or not len(stream.scan_lo_batches):
            return None
        specs = node.specs
        part = specs[0].partition
        W = self.n_workers
        spec_dicts = _window_spec_dicts(specs, stream.dicts)

        def pid_fn(w, cols, nulls, valid):
            kc = []
            for c in part:
                v = cols[c]
                nm = nulls[c]
                if nm is not None:
                    v = torch.where(nm, torch.zeros((), dtype=v.dtype, device=v.device), v)
                    kc.append(nm)  # NULL is its own partition value
                kc.append(v)
            return partition_ids(tuple(kc), W)

        collected = self._exchange_collect(stream, pid_fn, node=node)
        if collected is None:
            return None, True
        shards, counts = collected
        if sum(counts) == 0:
            cols = tuple(_zeros(0, torch_dtype(f.type), self.local.device)
                         for f in node.schema.fields)
            page = Page(node.schema, cols, tuple(None for _ in node.schema.fields), None)
            return (page, stream.dicts + spec_dicts), False

        def wstep(w, sh):
            cols, nulls, valid = sh
            ocols, onulls = _window_kernel(specs, cols, nulls, valid)
            return (tuple(cols) + tuple(ocols),
                    tuple(nulls) + tuple(torch.zeros_like(valid) if m is None else m
                                         for m in onulls))

        out = self._each(wstep, shards)
        page = self._page_from_shards(node.schema, [o[0] for o in out],
                                      [o[1] for o in out], counts)
        return (page, stream.dicts + spec_dicts), False

    # ------------------------------------------------- the blocking exchange
    def _exchange_collect(self, stream: _DStream, pid_fn, skip_batches: int = 0,
                          seed=None, bucket_of=None, node=None):
        """Run the stream batch by batch, route rows to their owning position
        (``pid_fn(w, cols, nulls, valid)``: a partition id per row) and
        collect each position's received rows: the blocking exchange of the
        full sort and the window.

        Device-resident by default: routed batches append into per-position
        device receive buffers (``append_rows``), and the run reads only the
        cursors and overflow flags of all W positions, in one read.
        ``TRINO_TPU_DEVICE_EXCHANGE=0`` (or the sort's seeded host sample)
        takes the host spool: each batch's routed rows come to the host and
        restage once collected.

        Returns (W shards (cols, nulls with every mask present, valid), host
        row counts per position), or None on a bucket overflow (ladder
        retry)."""
        W = self.n_workers
        bucket_of = bucket_of if bucket_of is not None else self._probe_bucket
        fields = stream.schema.fields
        ncols = len(fields)
        if self.device_exchange and seed is None and not skip_batches \
                and len(stream.scan_lo_batches):
            return self._exchange_collect_device(stream, pid_fn, bucket_of, node=node)
        if seed is not None:
            per_cols, per_nulls = seed
        else:
            per_cols = [[[] for _ in range(ncols)] for _ in range(W)]
            per_nulls = [[[] for _ in range(ncols)] for _ in range(W)]
        t0 = time.perf_counter()
        for b in range(skip_batches, len(stream.scan_lo_batches)):
            _exchange_fault("exchange_write", "dist.exchange.route")
            with maybe_span("exchange.route"):
                shards, of = _stream_batch(stream, stream.scan_lo_batches[b])
                pids = self._each(lambda w, sh: pid_fn(w, *sh), shards)
                routed, r_of = self._route_rows(shards, pids,
                                                bucket_of(shards[0][2].shape[0]))
                routed = _full_nulls(routed)
                flags = [f for f in of + r_of if isinstance(f, torch.Tensor)]
                got = self.local._host(
                    [a for cols, nulls, valid in routed for a in (*cols, *nulls, valid)]
                    + flags, site="dist.exchange.collect")
            if any(bool(np.any(g)) for g in got[W * (2 * ncols + 1):]):
                return None
            for w in range(W):
                p = got[w * (2 * ncols + 1):(w + 1) * (2 * ncols + 1)]
                v = p[2 * ncols]
                for i in range(ncols):
                    per_cols[w][i].append(p[i][v])
                    per_nulls[w][i].append(p[ncols + i][v])
        out_cols = [[np.concatenate(per_cols[w][i]) for i in range(ncols)] for w in range(W)]
        out_nulls = [[np.concatenate(per_nulls[w][i]) for i in range(ncols)]
                     for w in range(W)]
        counts = [len(out_cols[w][0]) if ncols else 0 for w in range(W)]
        self._note_skew("dist.exchange.collect", node, counts, time.perf_counter() - t0,
                        fields=fields)
        _exchange_fault("exchange_read", "dist.exchange.read")
        return self._stack_shards(out_cols, out_nulls, counts, fields), counts

    def _stack_shards(self, per_cols, per_nulls, counts, fields) -> list:
        """The host spool's re-entry into the mesh: each position's host rows
        padded to a common length and staged to its device (counted H2D)."""
        W = self.n_workers
        nmax = max(max(counts), 1)
        out = []
        for w in range(W):
            cols = tuple(np.concatenate([np.asarray(per_cols[w][i]).astype(
                np.dtype(f.type.dtype), copy=False), np.zeros((nmax - counts[w],),
                                                              np.dtype(f.type.dtype))])
                for i, f in enumerate(fields))
            nulls = tuple(np.concatenate([per_nulls[w][i], np.zeros((nmax - counts[w],), bool)])
                          for i in range(len(fields)))
            valid = np.arange(nmax) < counts[w]
            page, nbytes, _ = _page_to_device(Page(Schema(tuple(fields)), cols, nulls, valid),
                                              self.mesh.devices[w], None)
            self.local._count_h2d(nbytes)
            out.append((page.columns, page.null_masks, page.valid))
        return out

    def _page_from_shards(self, schema, cols_g, nulls_g, counts) -> Page:
        """One page on the coordinator's device from per-position shards:
        position w contributes its ``counts[w]`` head rows, positions in
        mesh order (the host knows the counts: slices, no compaction)."""
        dev = self.local.device
        cols = tuple(torch.cat([cols_g[w][i][:counts[w]].to(dev) for w in range(len(counts))])
                     for i in range(len(schema.fields)))
        nulls = tuple(torch.cat([nulls_g[w][i][:counts[w]].to(dev)
                                 for w in range(len(counts))])
                      for i in range(len(schema.fields)))
        return Page(schema, cols, nulls, None)

    # ------------------------------------------------- device-resident exchange
    def _recv_capacity(self, stream: _DStream) -> int:
        """Initial receive-buffer capacity: 2x the scan's total rows per
        position (absorbs moderate routing skew without a growth retry),
        pow2-rounded."""
        est = stream.rows * max(len(stream.scan_lo_batches), 1)
        return max(1 << (max(2 * est, 1024) - 1).bit_length(), 1024)

    def _recv_state_init(self, cap: int, dtypes) -> list:
        """Zeroed receive state per position: per column ``[cap + 1]`` value
        and null-mask buffers (the last slot is append_rows' drop sink), a
        write cursor, and the ladder and capacity overflow flags."""
        def init(w):
            dev = self.mesh.devices[w]
            return [tuple(_zeros(cap + 1, dt, dev) for dt in dtypes),
                    tuple(_zeros(cap + 1, torch.bool, dev) for _ in dtypes),
                    torch.zeros((), dtype=torch.int64, device=dev), False, False]
        return self._each(init)

    def _slim_shards(self, state, counts) -> list:
        """Receive buffers trimmed to the smallest pow2 cover of the largest
        shard, with per-row validity from the cursors."""
        nmax = max(max(counts), 1)
        nmax_p2 = 1 << (nmax - 1).bit_length()
        return self._each(lambda w, st: (
            tuple(b[:nmax_p2] for b in st[0]), tuple(b[:nmax_p2] for b in st[1]),
            torch.arange(nmax_p2, device=st[2].device) < st[2]), state)

    def _append(self, st, cols, nulls, valid, flags):
        """One batch's shard appended to one position's receive state."""
        bufs, ncur, b_of = append_rows(
            st[0] + st[1], st[2],
            tuple(c.to(b.dtype) for c, b in zip(cols, st[0]))
            + tuple(torch.zeros_like(valid) if m is None else m for m in nulls), valid)
        k = len(st[0])
        return [bufs[:k], bufs[k:], ncur, st[3] | flags, st[4] | b_of]

    def _run_receive(self, stream, step, site: str):
        """Drive the receive buffers over every batch: ``step(state, batch)``
        appends one batch.  Grows the capacity 4x on a receive overflow.
        Returns (state, counts, wall) or None on a ladder overflow."""
        dtypes = [torch_dtype(f.type) for f in stream.schema.fields]
        cap = self._recv_capacity(stream)
        while True:
            t0 = time.perf_counter()
            state = self._recv_state_init(cap, dtypes)
            for batch in stream.scan_lo_batches:
                state = step(state, batch)
            W = self.n_workers
            got = self._read([st[2] for st in state] + [st[3] for st in state]
                             + [st[4] for st in state], site)
            if any(got[W:2 * W]):
                return None  # exchange or expansion bucket overflow: ladder retry
            if not any(got[2 * W:]):
                return state, got[:W], time.perf_counter() - t0
            cap *= 4
            if cap > (1 << 28):
                return None  # pathological skew: ladder / local fallback

    def _exchange_collect_device(self, stream: _DStream, pid_fn, bucket_of, node=None):
        """Route AND receive per batch: each batch bucketizes and exchanges,
        then ``append_rows`` packs every position's received lanes into its
        receive buffers at the cursor.  Host traffic per RUN is one read of
        the W cursors and flags; a receive overflow grows the capacity 4x
        and runs again (rows past the capacity went to the drop sink, so no
        partial state leaks); a ladder overflow returns None as the spool
        does."""
        def step(state, batch):
            _exchange_fault("exchange_write", "dist.exchange.route")
            with maybe_span("exchange.route"):
                shards, of = _stream_batch(stream, batch)
                pids = self._each(lambda w, sh: pid_fn(w, *sh), shards)
                routed, r_of = self._route_rows(shards, pids,
                                                bucket_of(shards[0][2].shape[0]))
                return self._each(lambda w, st, sh, a, b: self._append(st, *sh, a | b),
                                  state, routed, of, r_of)

        run = self._run_receive(stream, step, "dist.exchange.flags")
        if run is None:
            return None
        state, counts, wall = run
        # skew from the cursors the flags read already holds
        self._note_skew("dist.exchange.flags", node, counts, wall,
                        fields=stream.schema.fields)
        _exchange_fault("exchange_read", "dist.exchange.read")
        return self._slim_shards(state, counts), counts

    # ---------------------------------------------------------------- topN
    def _run_topn(self, stream: _DStream, sort_keys, count: int, node=None):
        """Distributed TopN: each position keeps a running top-``count``
        shard across its batches (a device sort over state + batch), then
        the W small shards merge on the coordinator's device, which pulls
        only the final rows (reference: per-task TopNOperator + ordered
        MergeOperator)."""
        fields = stream.schema.fields
        if not _rankable(sort_keys, fields, stream.dicts):
            return self._decline(node, "a string sort key whose dictionary cannot "
                                       "rank on the device")
        k = max(count, 1)
        luts = _collation_luts(sort_keys, fields, stream.dicts)
        luts_d = self._each(lambda w: {c: device_array(l, self.mesh.devices[w])
                                       for c, l in luts.items()})
        dtypes = [torch_dtype(f.type) for f in fields]
        state = self._each(lambda w: (
            tuple(_zeros(k, dt, self.mesh.devices[w]) for dt in dtypes),
            tuple(_zeros(k, torch.bool, self.mesh.devices[w]) for _ in dtypes),
            _zeros(k, torch.bool, self.mesh.devices[w]), False))

        def step(w, st, sh, of):
            scols, snulls, svalid, s_of = st
            cols, nulls, valid = sh
            cat_cols = tuple(torch.cat([sc, c.to(sc.dtype)]) for sc, c in zip(scols, cols))
            cat_nulls = tuple(torch.cat([sn, torch.zeros_like(valid) if m is None else m])
                              for sn, m in zip(snulls, nulls))
            cat_valid = torch.cat([svalid, valid])
            idx = _lex_indices(sort_keys, luts_d[w], cat_cols, cat_nulls, cat_valid)[:k]
            return (tuple(c[idx] for c in cat_cols), tuple(m[idx] for m in cat_nulls),
                    cat_valid[idx], s_of | of)

        t0 = time.perf_counter()
        for batch in stream.scan_lo_batches:
            shards, of = _stream_batch(stream, batch)
            state = self._each(step, state, shards, of)
        W = self.n_workers
        got = self._read([torch.sum(st[2], dtype=torch.int64) for st in state]
                         + [st[3] for st in state], "dist.topn.states")
        oflow = any(got[W:])
        if not oflow:
            # per-position surviving-candidate counts from the same read
            self._note_skew("dist.topn.states", node, got[:W], time.perf_counter() - t0,
                            kind="topn", fields=fields)
        dev = self.local.device
        page = Page(stream.schema,
                    tuple(torch.cat([st[0][i].to(dev) for st in state])
                          for i in range(len(fields))),
                    tuple(torch.cat([st[1][i].to(dev) for st in state])
                          for i in range(len(fields))),
                    torch.cat([st[2].to(dev) for st in state]))
        return (self.local._sort_or_topn(page, sort_keys, count, stream.dicts),
                stream.dicts), oflow

    # ---------------------------------------------------------------- aggregation
    def _run_aggregate(self, node: P.Aggregate):
        out = self._retry_exchange(lambda: self._run_aggregate_once(node))
        if out is None:
            self._trace(node, "local", self._take_decline())
            return self.local._run_aggregate(node)
        self._trace(node, "mesh")
        return out

    def _run_aggregate_once(self, node: P.Aggregate):
        """One ladder attempt: ((page, dicts), oflow), or None when the child
        has no distributable scan spine."""
        if any(s.kind in P.SORTED_AGG_KINDS for s in node.aggs):
            return self._decline(node, "sort-based aggregates run the local "
                                       "selection runner")
        stream = self._compile_stream(node.child)
        if stream is None:
            return None
        key_types = tuple(stream.schema.fields[i].type for i in node.keys)
        acc_specs, acc_exprs, acc_kinds = self.local._agg_accumulators(node)
        if not node.keys:
            return self._run_global_aggregate(node, stream, acc_specs, acc_exprs, acc_kinds)
        merge_kinds = [_MERGE_KIND[k] for k in acc_kinds]
        W = self.n_workers
        capacity = node.capacity or DEFAULT_GROUP_CAPACITY
        key_dtypes = tuple(t.dtype for t in key_types)

        def insert(w, state, sh):
            cols, nulls, valid = sh
            inputs = [(None, None) if e is None else _broadcast(evaluate(e, cols, nulls), valid)
                      for e in acc_exprs]
            return hashagg.groupby_insert(state, tuple(cols[i] for i in node.keys),
                                          key_types, valid, inputs, acc_kinds,
                                          tuple(nulls[i] for i in node.keys))

        while True:
            t0 = time.perf_counter()
            states = self._each(lambda w: hashagg.groupby_init(
                capacity, key_dtypes, acc_specs, device=self.mesh.devices[w]))
            of_acc = [False] * W
            for batch in stream.scan_lo_batches:
                shards, of = _stream_batch(stream, batch)
                states = self._each(insert, states, shards)
                of_acc = [a | b for a, b in zip(of_acc, of)]
            # the partial phase's read: the exchange buckets' and the partial
            # tables' overflow, and the live groups per position (they size
            # the merge's send buckets)
            got = self._read(of_acc + [s.overflow for s in states]
                             + self._each(lambda w, st: hashagg.group_count(st), states),
                             "dist.agg.overflow")
            if any(got[:W]):
                return None, True  # exchange bucket overflow: ladder retry
            if any(got[W:2 * W]) and capacity < MAX_GROUP_CAPACITY:
                capacity *= 4
                continue
            merged, nocc = self._merge_states(states, key_types, acc_specs, merge_kinds,
                                              max(got[2 * W:]))
            got = self._read([m.overflow for m in merged] + nocc, "dist.agg.overflow")
            if not any(got[:W]) or capacity >= MAX_GROUP_CAPACITY:
                agg_wall = time.perf_counter() - t0
                break
            capacity *= 4
        counts = got[W:]
        _exchange_fault("exchange_read", "dist.agg.groups")
        # occupancy skew from the live-group counts the flags read carries
        self._note_skew("dist.agg.overflow", node, counts, agg_wall, kind="occupancy")
        nk = len(node.keys)
        if self.device_exchange:
            # the occupied groups pack on each position (compact_rows keeps
            # slot order) and concatenate on the coordinator's device: no
            # read of the tables
            out_cap = 1 << (max(max(counts), 1) - 1).bit_length()

            def pack(w, m):
                C = m.capacity
                packed, _ = compact_rows(
                    tuple(c[:C] for c in m.key_cols) + tuple(c[:C] for c in m.key_nulls)
                    + tuple(a[:C] for a in m.accs), m.table[:C] != EMPTY_KEY, out_cap)
                return packed

            packed = self._each(pack, merged)
            dev = self.local.device
            cols = [torch.cat([p[i][:counts[w]].to(dev) for w, p in enumerate(packed)])
                    for i in range(len(packed[0]))]
        else:
            # the host spool: every position's whole table in one read, the
            # occupied groups concatenated there and staged back
            got = self.local._host([a for m in merged for a in
                                    (m.table, *m.key_cols, *m.key_nulls, *m.accs)],
                                   site="dist.agg.groups")
            per = 1 + 2 * nk + len(acc_kinds)
            occ = [got[w * per][:m.capacity] != EMPTY_KEY for w, m in enumerate(merged)]
            cols = [self.local._to_device(np.concatenate(
                [got[w * per + i][:m.capacity][occ[w]] for w, m in enumerate(merged)]))
                for i in range(1, per)]
        keys, key_nulls, accs = cols[:nk], cols[nk:2 * nk], cols[2 * nk:]
        n_groups = sum(counts)
        fin_cols, fin_nulls, bad = _finalize_aggs_device(node.aggs, tuple(accs))
        dicts = tuple(stream.dicts[i] for i in node.keys) + tuple(None for _ in node.aggs)
        if self._read([bad], "dist.agg.envelope")[0]:
            return (self.local._finalize_exact(node, keys, key_nulls, fin_cols, fin_nulls,
                                               accs, n_groups), dicts), False
        return (Page(node.schema, tuple(keys) + tuple(fin_cols),
                     tuple(key_nulls) + tuple(fin_nulls), None), dicts), False

    def _merge_states(self, states, key_types, acc_specs, merge_kinds, max_groups: int):
        """Hash-exchange the group entries across the positions and insert
        them again (the final aggregation).  Each position first packs its
        live entries in slot order (``compact_rows``) into ``bucket`` =
        pow2(``max_groups``, the most live groups of a position, read with
        the partial flags) rows, which is also the send bucket: every
        entry of a position may route to one partition, and bucketize drops
        rows past the bucket, so a smaller one would lose groups under skew.
        The entries arrive in the reference's order (sender, then slot).
        Returns (merged states, live groups per position as 0-d tensors)."""
        W = self.n_workers
        nk = len(key_types)
        bucket = 1 << (max(max_groups, 1) - 1).bit_length()

        def entries(w, st):
            C = st.capacity
            occ = st.table[:C] != EMPTY_KEY
            packed, live = compact_rows(
                tuple(k[:C] for k in st.key_cols) + tuple(n[:C] for n in st.key_nulls)
                + tuple(a[:C] for a in st.accs), occ, bucket)
            valid = torch.arange(bucket, device=occ.device) < live
            return ((packed, (None,) * len(packed), valid),
                    partition_ids(packed[:nk], W))

        _exchange_fault("exchange_write", "dist.agg.merge")
        with maybe_span("exchange.merge"):
            ent = self._each(entries, states)
            routed, _ = self._route_rows([e[0] for e in ent], [e[1] for e in ent], bucket)

            def merge(w, st, sh):
                rcols, _, recv_valid = sh
                fresh = hashagg.groupby_init(st.capacity, tuple(t.dtype for t in key_types),
                                             acc_specs, device=recv_valid.device)
                merged = hashagg.groupby_insert(
                    fresh, rcols[:nk], key_types, recv_valid,
                    [(a, None) for a in rcols[2 * nk:]], merge_kinds, rcols[nk:2 * nk])
                C = merged.capacity
                return merged, torch.sum(merged.table[:C] != EMPTY_KEY, dtype=torch.int64)

            out = self._each(merge, states, routed)
        return [o[0] for o in out], [o[1] for o in out]

    def _run_global_aggregate(self, node, stream: _DStream, acc_specs, acc_exprs,
                              acc_kinds):
        """Ungrouped aggregation: per-position reductions, then one combine
        across the positions on the coordinator's device (reference: the
        partial + final AggregationOperator pair)."""
        W = self.n_workers
        states = self._each(lambda w: _global_init_state(acc_specs, self.mesh.devices[w]))
        of_acc = [False] * W
        for batch in stream.scan_lo_batches:
            shards, of = _stream_batch(stream, batch)
            states = self._each(lambda w, st, sh: _global_agg_update(
                st, sh[0], sh[1], sh[2], acc_exprs, acc_kinds), states, shards)
            of_acc = [a | b for a, b in zip(of_acc, of)]
        dev = self.local.device
        accs = []
        for i, kind in enumerate(acc_kinds):
            vals = torch.stack([st[i].to(dev) for st in states])
            mk = _MERGE_KIND[kind]
            accs.append((vals.sum(dtype=vals.dtype) if mk == "sum" else
                         vals.min() if mk == "min" else vals.max()).reshape(1))
        fin_cols, fin_nulls, bad = _finalize_aggs_device(node.aggs, tuple(accs))
        got = self._read(of_acc + [bad], "dist.agg.states")
        if any(got[:W]):
            return None, True  # exchange bucket overflow: ladder retry
        dicts = tuple(None for _ in node.aggs)
        if got[W]:
            return (self.local._finalize_exact(node, (), (), fin_cols, fin_nulls, accs, 1),
                    dicts), False
        return (Page(node.schema, fin_cols, fin_nulls, None), dicts), False

    # ---------------------------------------------------------------- materialize
    def _materialize_dstream(self, stream: _DStream, node=None):
        """Run a streaming-only fragment.  Device-resident by default: every
        position's batch output appends into its own receive buffers (no
        routing) and the page assembles from the device shards;
        ``TRINO_TPU_DEVICE_EXCHANGE=0`` reads each batch to the host."""
        fields = stream.schema.fields
        if not len(stream.scan_lo_batches):  # an empty table: no split
            return (Page(stream.schema, tuple(_zeros(0, torch_dtype(f.type), self.local.device)
                                              for f in fields),
                         tuple(None for _ in fields), None), stream.dicts), False
        if self.device_exchange:
            return self._materialize_dstream_device(stream, node=node)
        W = self.n_workers
        ncols = len(fields)
        parts_cols, parts_nulls = [], []
        rows_w = [0] * W
        t0 = time.perf_counter()
        for batch in stream.scan_lo_batches:
            shards, of = _stream_batch(stream, batch)
            full = _full_nulls(shards)
            flags = [f for f in of if isinstance(f, torch.Tensor)]
            got = self.local._host([a for cols, nulls, valid in full
                                    for a in (*cols, *nulls, valid)] + flags,
                                   site="dist.stream.collect")
            if any(bool(np.any(g)) for g in got[W * (2 * ncols + 1):]):
                return None, True  # exchange bucket overflow: ladder retry
            for w in range(W):
                p = got[w * (2 * ncols + 1):(w + 1) * (2 * ncols + 1)]
                v = p[2 * ncols]
                rows_w[w] += int(v.sum())
                parts_cols.append([c[v] for c in p[:ncols]])
                parts_nulls.append([m[v] for m in p[ncols:2 * ncols]])
        self._note_skew("dist.stream.collect", node, rows_w, time.perf_counter() - t0,
                        kind="stream", fields=fields)
        cols = tuple(np.concatenate([p[i] for p in parts_cols]).astype(
            np.dtype(f.type.dtype), copy=False) for i, f in enumerate(fields))
        nulls_np = [np.concatenate([p[i] for p in parts_nulls]) for i in range(ncols)]
        nulls = tuple(m if m.any() else None for m in nulls_np)
        # staged, counted, injectable H2D
        page, nbytes, _ = _page_to_device(Page(stream.schema, cols, nulls, None),
                                          self.local.device, None)
        self.local._count_h2d(nbytes)
        return (page, stream.dicts), False

    def _materialize_dstream_device(self, stream: _DStream, node=None):
        """Device-resident materialize: the receive buffers of
        ``_exchange_collect_device`` without the routing: each position's
        batch output packs (``append_rows``) into its own buffers, one read
        per run of the cursors and flags, and the page assembles on the
        device (``_page_from_shards``)."""
        def step(state, batch):
            shards, of = _stream_batch(stream, batch)
            return self._each(lambda w, st, sh, f: self._append(st, *sh, f),
                              state, shards, of)

        run = self._run_receive(stream, step, "dist.stream.flags")
        if run is None:
            return None, True
        state, counts, wall = run
        self._note_skew("dist.stream.flags", node, counts, wall, kind="stream",
                        fields=stream.schema.fields)
        return (self._page_from_shards(stream.schema, [st[0] for st in state],
                                       [st[1] for st in state], counts),
                stream.dicts), False
