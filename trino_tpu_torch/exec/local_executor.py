"""Single-device page-loop executor over torch tensors
(counterpart of ``trino_tpu/exec/local_executor.py``).

A plan runs as streaming segments: a ``_Stream`` pairs a page source (one
generated page per connector split) with a fused transform (filter, project,
join probe) applied to each page eagerly, on the engine's device.  Pipeline
breakers (aggregation, join build, sort, top-N) materialize.  These are the
page-loop paths of the reference, with its Grace-partitioned and streaming
operators over the tiered spill (``exec/spill.py``) and its index join
(``_index_lookup_stream``: a small build side's distinct keys become one
keyed lookup at a connector that supports it).  Where a plan asks for a path
that is not ported the executor raises ``NotImplementedError`` naming the
node and the path.

Dispatch coalescing, as in the reference: every per-page consumer loop (the
stream materialization, the compaction boundary, the direct, hash and
streaming group-by inserts, the ungrouped aggregation) takes the stream's
pages in groups of ``dispatch_batch`` shape-uniform pages
(``_coalesced_batches``), concatenated per column with ``torch.cat``
(``_stack_pages``), and runs the group's transform, its kernel launches and
its live-count read once.  The reference pads a short last group to exactly
K pages so that XLA compiles one executable per page shape; the port
compiles nothing, so a short group runs at its own size, and
``coalesced_splits`` counts the real splits of each group of two or more.
Rows keep split order, so a group computes what its pages compute one by
one.  The reference's coalescing double buffer overlaps a host-to-device
copy of each generated page; the port generates on the device, so there is
no copy to overlap (``_staged_scan_pages`` keeps the ``h2d`` point and its
count).

The scan-fused whole-scan runners, as in the reference, where a stream's
pages are a generator's splits (``_TracedSrc``): the grouped aggregation
(``_run_aggregate_scan_fused``), the ungrouped one
(``_run_global_scan_fused``) and the materialization (``_concat_traced``, a
count pass and a fill pass) run one body, generate -> stage transforms ->
insert, accumulate or pack, per split offset.  On a CUDA engine the body is
captured once per (plan node, mode, shapes) as a CUDA graph
(``_fused_scan``), and each split is one replay that reads its offset from
the device and advances the index inside the graph; on the CPU the same body
runs in a plain loop.  They are on by default on a CUDA engine and off on
the CPU (``_scan_fused_enabled``, ``TRINO_TPU_SCAN_FUSED``); eligibility is
decided from the compiled plan before any capture, and a capture or replay
error raises.

Every device -> host read goes through ``LocalExecutor._host``, which counts
them (``host_reads``) and their bytes (``host_bytes``).  Host arrays the query
hands to the device (planner tables such as element heaps, once per query;
host pages moved back) are counted in ``h2d_bytes``.

The engine's device buffer pool (``execution/bufferpool.py``), when the
executor is given one, serves two tiers here: a scan whose table, splits and
columns were read to completion before comes back as ONE device page of the
whole scan (``_scan_pages_source``), and a join whose build fragment was
built before checks out the finished build page and hash table
(``_build_cache_key``) instead of running the fragment and inserting its
rows.

Plan templates: ``exec_params`` holds a query's bound parameter slots (host
numpy values).  ``execute`` stages them to the device once, counts their
bytes, and publishes them for the query (``_params_scope``, which also opens
``ir.bind_params``); a filter over a parameter prunes splits per execution
from the host values (``_param_pruned_source``).  ``execute_batched`` runs
one template plan for several bindings at once: one scan feeds every lane,
each lane's transform runs under its own binding, and each lane's rows are
exactly what its own serial execution gives.

Per-node execution stats, as in the reference: ``stats`` (id(node) ->
rows, cumulative wall, structural path and CBO estimate) at pipeline-breaker
granularity, registered only through ``_node_stats``; ``boundary``
(id(node) -> launches plus host reads, host reads and their bytes charged
while that operator ran, innermost scope wins, plus a ``"Result"`` entry
for the final read); ``_plan_facts`` (scan split counts, join build rows and
walls) for the plan history.  Row counts stay on the device as 0-d tensors:
recording them reads nothing.  ``begin_plan`` stamps the node paths and
estimates, and ``plan_fingerprint`` the structural fingerprint, through
``plan_memo``: the engine hands the executors of statements that run again
its memo keyed by plan root, so a warm statement walks neither again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import enum
import functools
import hashlib
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from decimal import Decimal
from typing import Callable, Optional

import numpy as np
import torch

from ..execution import faults, tracing
from ..ops import cuda_kernels, hashagg
from ..ops.arrays import (ArrayData, MapData, compact_rows, pack_span, span_len,
                          span_start, unnest_indices)
from ..ops.cuda_kernels import _ranged
from ..ops.hashing import ceil_pow2
from ..ops.hashjoin import (DIRECT_JOIN_RANGE_MAX, DirectJoinTable,
                            DirectMultiJoinTable, build_insert, build_table_init,
                            direct_build, direct_multi_build, direct_probe,
                            direct_probe_slots, expand_counts, multi_build, probe,
                            probe_slots)
from ..page import Page, Schema
from ..sql import plan as P
from ..sql.ir import (Call, FieldRef, bind_params, current_params, device_array,
                      device_constants, evaluate, evaluate_predicate)
from ..types import ArrayType, BIGINT, DecimalType, MapType, TimestampType, torch_dtype

__all__ = ["BatchUnsupported", "LocalExecutor", "MaterializedResult"]

DEFAULT_GROUP_CAPACITY = 1 << 16
MAX_GROUP_CAPACITY = 1 << 25

_I64_MAX = int(np.iinfo(np.int64).max)
_I64_MIN = int(np.iinfo(np.int64).min)


@dataclasses.dataclass
class MaterializedResult:
    """Host-side query result."""

    names: tuple
    types: tuple
    columns: list  # numpy arrays, decoded (strings as objects, decimals as floats)
    raw_columns: list  # undecoded numpy arrays (dict ids / scaled ints)

    def __len__(self):
        return 0 if not self.columns else len(self.columns[0])

    def rows(self):
        return list(zip(*self.columns))

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({n: c for n, c in zip(self.names, self.columns)})


@dataclasses.dataclass
class _ScanInfo:
    """Provenance of a stream's page source: lets joins prune probe splits
    against build-side key domains."""

    conn: object
    splits: list
    scan_columns: tuple  # column names requested from the connector
    columns: tuple  # per OUTPUT channel: source column name | None
    replayable: bool = True  # False once compaction transformed the pages
    catalog: str = ""  # catalog and table: a split-pruning replacement
    table: str = ""  # rebuilds its page source through _scan_pages_source,
    # which keys the buffer pool on them


@dataclasses.dataclass(frozen=True)
class _TracedSrc:
    """Provenance of a stream whose pages a generator can make again on the
    device: every page equals ``conn.generate_traced(table, split.lo,
    length, scan_cols)`` pushed through ``stages`` (the chains before a
    compaction boundary, whose packing changes no live row) and then the
    stream's own transform.  The scan-fused runners read it."""

    conn: object
    table: str
    splits: tuple  # equal-length split ranges, after static and dynamic pruning
    scan_cols: tuple  # the columns generate_traced makes
    stages: tuple = ()  # earlier _Streams whose (transform, aux) apply first


@dataclasses.dataclass
class _Stream:
    """A streaming pipeline segment: a source of raw pages + a fused transform.
    ``aux`` carries the segment's device state (join tables)."""

    schema: Schema
    dicts: tuple  # Dictionary|None per channel
    pages: Callable  # () -> iterator of raw source Pages
    transform: Callable  # (cols, nulls, valid, aux) -> (cols, nulls, valid)
    scan_info: Optional[_ScanInfo] = None
    aux: tuple = ()
    clustered_by: tuple = ()  # source columns whose equal-value rows are contiguous
    compacted: bool = False  # a compaction boundary already shrank this chain
    traced_src: Optional[_TracedSrc] = None  # regenerable on the device

    def run_group(self, pages):
        """The transform of a coalesced group (``_coalesced_batches``): one
        page runs alone, two or more stacked in order run once."""
        if len(pages) == 1:
            return self.run(pages[0])
        return self.transform(*_stack_pages(pages), self.aux)

    def run(self, page: Page):
        try:
            return self.transform(page.columns, page.null_masks, page.valid_mask(),
                                  self.aux)
        except (TypeError, AttributeError, OverflowError) as e:
            # exact wide-decimal sums live on the host: only FieldRefs pass them
            if any(isinstance(c, np.ndarray) for c in page.columns):
                raise NotImplementedError(_WIDE_EXPR_MSG) from e
            raise


_WIDE_EXPR_MSG = ("expressions over an exact wide-decimal aggregate (sum beyond 2^63) "
                  "are not supported yet — such sums can only be output directly")


def _identity(c, n, v, aux):
    return c, n, v


# nodes that run to completion before their consumer sees a row
_BLOCKING = (P.Aggregate, P.Sort, P.Limit, P.Output, P.Window)
# ... and those that a streaming consumer also takes as one page
_BLOCKING_NODES = _BLOCKING + (P.Unnest, P.MatchRecognize)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to trino_tpu_torch")


def _dispatch_batch_default() -> int:
    """The process default of the ``dispatch_batch`` session property, the
    dispatch-coalescing width: ``TRINO_TPU_DISPATCH_BATCH`` (4 unset, at
    least 1; 1 runs every split on its own), read as the reference reads
    it.  The session property overrides it per statement and enters the
    plan-cache key (``engine._plan_shape_props``)."""
    import os

    try:
        v = int(os.environ.get("TRINO_TPU_DISPATCH_BATCH", "4"))
    except ValueError:
        return 4
    return max(v, 1)


def _scan_fused_enabled(device) -> bool:
    """Do the scan-fused runners take eligible streams?  They trade
    generating the scan again on the device (twice for a materialization)
    for one host dispatch per split and one read per scan: on by default
    where the engine's device is CUDA, off on the CPU, where generation is
    the cost and dispatches are free.  ``TRINO_TPU_SCAN_FUSED=1/0`` forces
    either way (the CPU tests force them on), read per statement."""
    import os

    mode = os.environ.get("TRINO_TPU_SCAN_FUSED")
    if mode is not None:
        return mode not in ("0", "false", "no")
    return torch.device(device).type == "cuda"


# the fused runners capture CUDA graphs on a CUDA device; False runs the same
# body eagerly in a loop there too (the card tests and chip_smoke hold a
# replay against that eager run)
FUSED_GRAPHS = True


def _page_batch_sig(page):
    """Shape-class signature of a page for dispatch coalescing, or None when
    it never coalesces (a host column, an empty page).  Pages group only
    with equal signatures."""
    if page.capacity == 0 or not all(isinstance(c, torch.Tensor) for c in page.columns):
        return None
    return (tuple((c.dtype, tuple(c.shape), c.device) for c in page.columns),
            tuple(m is not None for m in page.null_masks), page.valid is not None)


def _coalesced_batches(pages_iter, batch: int):
    """Consecutive shape-uniform pages in groups of at most ``batch``: lists
    of pages, a one-page list for a page that runs alone.  A group of two
    or more counts its splits (``tracing.record_coalesced``: EXPLAIN
    ANALYZE's "splits coalesced").  The last group of a run of equal
    signatures may be short, and runs at its own size (no padding: the port
    compiles nothing per shape).  ``batch`` 1 gives one page at a time.
    Closing this generator closes its source."""
    try:
        if batch <= 1:
            for pg in pages_iter:
                yield [pg]
            return
        buf: list = []
        sig = None

        def flush():
            while buf:
                group = buf[:batch]
                del buf[:batch]
                if len(group) > 1:
                    tracing.record_coalesced(len(group))
                yield group

        for pg in pages_iter:
            s = _page_batch_sig(pg)
            if s is None:
                yield from flush()
                sig = None
                yield [pg]
                continue
            if sig is not None and s != sig:
                yield from flush()
            sig = s
            buf.append(pg)
            if len(buf) >= batch:
                yield from flush()
        yield from flush()
    finally:
        close = getattr(pages_iter, "close", None)
        if close is not None:
            close()


def _stack_pages(pages):
    """(cols, nulls, valid) of uniform pages concatenated in order: rows
    keep split order, so every row-wise transform computes what it computes
    page by page."""
    nc = len(pages[0].columns)
    cols = tuple(torch.cat([p.columns[ci] for p in pages]) for ci in range(nc))
    nulls = tuple(
        None if all(p.null_masks[ci] is None for p in pages) else torch.cat([
            torch.zeros((p.capacity,), dtype=torch.bool, device=p.columns[ci].device)
            if p.null_masks[ci] is None else p.null_masks[ci] for p in pages])
        for ci in range(nc))
    return cols, nulls, torch.cat([p.valid_mask() for p in pages])


class PlanMemo:
    """Bounded map from a plan root to what its executions compute from it
    alone (``{"est": (paths, estimates), "fp": fingerprint}``), least
    recently used out first.  Keyed by ``id(root)``; each entry holds its
    root, so the id stays the plan's while the entry lives.  The engine
    keeps one, hands it to the executors of plans that run again, and
    clears it in ``_invalidate`` (estimates read connector statistics)."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # id(root) -> (root, dict)

    def entry(self, root) -> dict:
        with self._lock:
            hit = self._entries.get(id(root))
            if hit is not None and hit[0] is root:
                self._entries.move_to_end(id(root))
                return hit[1]
            ent: dict = {}
            self._entries[id(root)] = (root, ent)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            return ent

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


def _tree_sig(obj, leaves: list):
    """Structure of ``obj`` (tuples, lists, dataclasses, None, host and
    numpy scalars and strings around tensors), each tensor appended to ``leaves`` and
    standing in the structure by its shape and dtype; None where something
    else (a host array) sits in it.  Hashable: the key of a captured body's
    inputs."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T", tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, (tuple, list)):
        subs = tuple(_tree_sig(o, leaves) for o in obj)
        return None if any(x is None for x in subs) else (type(obj).__name__, subs)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        subs = tuple((f.name, _tree_sig(getattr(obj, f.name), leaves))
                     for f in dataclasses.fields(obj))
        return None if any(x is None for _, x in subs) else ("D", type(obj), subs)
    if obj is None or isinstance(obj, (bool, int, float, str, np.generic)):
        return ("V", type(obj), obj)
    return None


def _tree_build(sig, leaves):
    """The structure ``sig`` (from ``_tree_sig``) over the tensors of the
    iterator ``leaves``."""
    kind = sig[0]
    if kind == "T":
        return next(leaves)
    if kind == "tuple":
        return tuple(_tree_build(x, leaves) for x in sig[1])
    if kind == "list":
        return [_tree_build(x, leaves) for x in sig[1]]
    if kind == "D":
        return sig[1](**{name: _tree_build(x, leaves) for name, x in sig[2]})
    return sig[2]


class _FusedGraph:
    """One captured whole-scan body: the CUDA graph and the static tensors
    it reads and writes (its inputs are copied in before the replays of a
    statement, its state read out after), the planner constants it reads,
    and the kernel launches one replay holds.  ``node`` keeps the plan node
    whose id keys it alive."""

    def __init__(self, node, graph, los, idx, state, aux, params, consts, launches):
        self.lock = threading.Lock()
        self.node, self.graph, self.los, self.idx = node, graph, los, idx
        self.state, self.aux, self.params = state, aux, params
        self.consts, self.launches = consts, launches
        self.los_host = None


# every captured body's intermediates come from one private memory pool per
# card, shared by every engine's graphs: all of them replay on the card's
# one (default) stream, so never two at once, and none keeps a tensor of the
# pool past its replay (each copies what it keeps into static tensors made
# outside it), so the pool holds the largest body's intermediates, not their
# sum.  Captures into it take turns under the lock.  A pool ends with the
# last graph that used it (torch frees it then), so a capture after that
# takes a new one: device index -> [pool handle, live graphs].
_GRAPH_POOLS: dict = {}
_CAPTURE_LOCK = threading.RLock()

# the bytes of static tensors (states, stage state, offsets) a fused cache
# keeps before it drops its least recently used graphs
FUSED_CACHE_BYTES = 4 << 30


def _graph_pool(device, graph):
    """The card's shared graph pool for a capture of ``graph`` (call under
    ``_CAPTURE_LOCK``)."""
    idx = torch.device(device).index or 0
    slot = _GRAPH_POOLS.get(idx)
    if slot is None or slot[1] == 0:
        slot = _GRAPH_POOLS[idx] = [torch.cuda.graph_pool_handle(), 0]
    slot[1] += 1

    def release(slot=slot):
        with _CAPTURE_LOCK:
            slot[1] -= 1

    weakref.finalize(graph, release)
    return slot[0]


class FusedGraphCache:
    """The scan-fused runners' captured bodies (``_FusedGraph``) and the
    output layouts of their chains, keyed by plan node identity, mode and
    shapes, least recently used out first, at most ``max_entries`` and
    ``max_bytes`` of static tensors.  The engine keeps one for the plans
    that run again and clears it in ``_invalidate``; an executor without it
    keeps its own and clears it when its statement ends.  ``pool_bytes``
    counts the device memory its captures added to the card's graph pool
    (the statements' counters hold the captures and replays).  The
    engine's cache outlives its statements, so it holds both its static
    bytes and ``pool_bytes`` in the engine's ``memory_pool`` (tag
    ``fused-graphs``) while it keeps them: the static bytes until their
    entry leaves, the pool's until ``clear``.  An executor's own cache
    ends with its statement, like the statement's other temporaries, and
    holds nothing (``memory_pool`` None)."""

    TAG = "fused-graphs"

    def __init__(self, max_entries: int = 64, max_bytes: Optional[int] = None,
                 memory_pool=None):
        self.max_entries = max_entries
        self.max_bytes = FUSED_CACHE_BYTES if max_bytes is None else max_bytes
        self.memory_pool = memory_pool
        self.lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (value, static bytes)
        self._bytes = 0
        self.pool_bytes = 0

    def _held(self, delta: int) -> None:
        if self.memory_pool is not None and delta:
            if delta > 0:
                self.memory_pool.hold(delta, self.TAG)
            else:
                self.memory_pool.release(-delta, self.TAG)

    def add_pool_bytes(self, nbytes: int) -> None:
        """Count what a capture added to the card's graph pool."""
        with self.lock:
            self.pool_bytes += nbytes
            self._held(nbytes)

    def get(self, key):
        with self.lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self._entries.move_to_end(key)
            return hit[0]

    def put(self, key, value, nbytes: int = 0) -> None:
        with self.lock:
            before = self._bytes
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while len(self._entries) > 1 and (len(self._entries) > self.max_entries
                                              or self._bytes > self.max_bytes):
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
            self._held(self._bytes - before)

    def graphs(self) -> int:
        with self.lock:
            return sum(isinstance(v, _FusedGraph) for v, _ in self._entries.values())

    def clear(self) -> None:
        with self.lock:
            self._held(-(self._bytes + self.pool_bytes))
            self._entries.clear()
            self._bytes = 0
            self.pool_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)


def _gb_flat(state) -> list:
    """A ``GroupByState`` as the flat tensor list a fused body carries."""
    return [state.table, *state.key_cols, *state.key_nulls, *state.accs, state.overflow]


def _gb_state(flat, nk: int):
    """``_gb_flat``'s inverse for ``nk`` keys."""
    return hashagg.GroupByState(flat[0], tuple(flat[1:1 + nk]), tuple(flat[1 + nk:1 + 2 * nk]),
                                tuple(flat[1 + 2 * nk:-1]), flat[-1])


_PARAM_TLS = threading.local()


@contextlib.contextmanager
def _params_scope(values, host_values=(), batch_hosts=()):
    """Publish the current query's bound parameters on this thread:
    ``values`` are the staged ``(0-d value, 0-d isnull)`` device pairs, one
    per template slot, which ``ir.bind_params`` hands to every ``Parameter``
    leaf (the one place they are kept); ``host_values`` the numpy pairs they
    were staged from, which bind-time split pruning reads without a device
    read.  ``batch_hosts`` holds the numpy slot tuples of every member of a
    fused template batch: split pruning then keeps the union of their kept
    splits.  A fused batch publishes only ``batch_hosts``: ``values`` stays
    empty, so a path that evaluates a parameter outside its lane's binding
    raises instead of computing one member's answer for every lane."""
    old = (getattr(_PARAM_TLS, "host_values", ()), getattr(_PARAM_TLS, "batch_hosts", ()))
    _PARAM_TLS.host_values = host_values
    _PARAM_TLS.batch_hosts = batch_hosts
    try:
        with bind_params(values):
            yield
    finally:
        _PARAM_TLS.host_values, _PARAM_TLS.batch_hosts = old


def _current_host_params() -> tuple:
    return getattr(_PARAM_TLS, "host_values", ())


def _current_batch_host_params() -> tuple:
    """Host slot tuples of every member of the current fused template batch,
    or () outside one (see ``_params_scope``)."""
    return getattr(_PARAM_TLS, "batch_hosts", ())


class BatchUnsupported(Exception):
    """A plan or page the fused template batch cannot run: a plan outside
    the streaming subset, or a host (object-dtype) page.  The engine marks
    the template unbatchable and the batcher runs every member of the
    window on its own serial path."""


# test seam: when set, called (lane, nlanes) before each member's result is
# decoded; tests raise in one lane to show a member's error is its own
BATCH_LANE_TEST_HOOK = None


def _batchable_plan(node) -> bool:
    """Can this template plan take the fused path?  The streaming core
    (scan, filter, project, plus Union and Values) only: Sort and Limit,
    although templates cover them, stay serial."""
    allowed = (P.Output, P.Project, P.Filter, P.TableScan, P.Union, P.Values)
    if not isinstance(node, allowed):
        return False
    return all(_batchable_plan(c) for c in node.children)


class LocalExecutor:
    """Executes a plan tree on one device (``cuda`` or ``cpu``)."""

    def __init__(self, catalogs: dict, device, memory_pool=None, buffer_pool=None):
        from ..memory import MemoryPool

        self.catalogs = catalogs
        self.device = torch.device(device)
        self.memory_pool = memory_pool if memory_pool is not None \
            else MemoryPool(device=self.device)
        # the engine's DeviceBufferPool, shared by every executor it makes;
        # ``page_cache`` is the query's session-property override (None: the
        # pool's budget decides)
        self.buffer_pool = buffer_pool
        self.page_cache = None
        # the pool epoch this executor started under: a page or build store
        # after a write's invalidation is refused (it may hold pre-write rows)
        self._pool_epoch = buffer_pool.epoch if buffer_pool is not None else None
        self.host_reads = 0
        self.host_bytes = 0
        self.h2d_bytes = 0
        self._reserved: list = []  # join-build bytes held until the query ends
        # live prefetch producers of the current query, (stop flag, thread)
        # pairs registered by _prefetched_pages, and the tiered spills
        # (exec/spill.SpilledPartitions) its Grace-partitioned operators
        # made: close_producers stops and closes them on every exit path, so
        # an error cannot strand a producer thread, a "spill" reservation or
        # a spill file behind its traceback
        self._producers: list = []
        self._spills: list = []
        # a plan template's bound slots for the query: per slot a (0-d numpy
        # value in the planned dtype, isnull) pair, or None
        self.exec_params = None
        # per-node stats of the current plan: id(node) -> {"rows" (a 0-d
        # device tensor or an int), "wall_s", "op", "path", "est_rows"}
        self.stats: dict = {}
        # the current plan's structural node paths and CBO row estimates,
        # stamped by begin_plan for _node_stats to capture
        self._node_paths: dict = {}
        self._node_ests: dict = {}
        # plan-history facts: id(node) -> (node, {"splits": n} or
        # {"build_rows": device count, "wall_s": s}) for the scans and join
        # build sides that stats never records
        self._plan_facts: dict = {}
        # per-operator attribution: id(node) -> {"label", "dispatches",
        # "transfers", "bytes"}, plus "result" for the final read
        self.boundary: dict = {}
        self._op_labels: dict = {}  # id(node) -> "<Type>#<k>" in execution order
        # the engine's per-plan-root memo of estimates and fingerprint, for
        # plans that run again (None: computed for this run alone)
        self.plan_memo = None
        # node-result substitutions, id(node) -> (Page, dicts): fault-tolerant
        # execution and the cluster install a fragment's spooled output here,
        # so the rest of the plan reads it instead of running the subtree
        # again (reference: ExchangeOperator reading spooled task output)
        self._overrides: dict = {}
        # a task's share of a scan, id(TableScan) -> splits: a partial
        # aggregation or probe task (exec/fte) runs its fragment over these
        # splits through the same page sources and transforms as a whole scan
        self._split_restriction: dict = {}
        # the statement's dispatch-coalescing width (None: the process
        # default, TRINO_TPU_DISPATCH_BATCH); the engine sets it per
        # statement from the ``dispatch_batch`` session property
        self.dispatch_batch = None
        # the scan-fused runners' captured bodies: the engine's cache for
        # plans that run again (set by the engine), else this executor's
        # own, cleared when its statement ends
        self.fused_cache = FusedGraphCache(max_entries=16)
        self._fused_own = True

    def _batch(self) -> int:
        """The statement's dispatch-coalescing width (at least 1)."""
        b = self.dispatch_batch
        if b is None or int(b) <= 0:
            return _dispatch_batch_default()
        return int(b)

    def _outs(self, stream: _Stream, pages=None):
        """The transformed (cols, nulls, valid) of ``stream``'s pages (or of
        ``pages``, an iterator of its raw pages), one per coalesced group of
        ``_batch()`` pages."""
        src = stream.pages() if pages is None else pages
        for group in _coalesced_batches(src, self._batch()):
            yield stream.run_group(group)

    def use_fused_cache(self, cache: "FusedGraphCache") -> None:
        """Keep captured bodies in ``cache`` (the engine's) instead of this
        executor's own."""
        self.fused_cache = cache
        self._fused_own = False

    # ------------------------------------------------------------------ stats
    def begin_plan(self, root: P.PlanNode) -> None:
        """Stamp the structural node paths and CBO row estimates of the plan
        about to run (``execution/history.py``), so ``_node_stats`` captures
        them at registration.  A host walk, memoized per plan root."""
        ent = self.plan_memo.entry(root) if self.plan_memo is not None else {}
        hit = ent.get("est")
        if hit is None:
            from ..execution.history import estimate_plan_rows, plan_node_paths

            try:
                hit = (plan_node_paths(root), estimate_plan_rows(root, self.catalogs))
            except Exception:  # noqa: BLE001 - estimation is advisory
                hit = ({}, {})
            ent["est"] = hit
        self._node_paths, self._node_ests = hit

    def plan_fingerprint(self, root: P.PlanNode) -> str:
        """Memoized structural fingerprint of ``root`` (the history key)."""
        ent = self.plan_memo.entry(root) if self.plan_memo is not None else {}
        fp = ent.get("fp")
        if fp is None:
            fp = ent["fp"] = _plan_fingerprint(root, self.catalogs)
        return fp

    def _reset_stats(self, root: P.PlanNode) -> None:
        self.stats = {}
        self.boundary = {}
        self._op_labels = {}
        self._plan_facts = {}
        self.begin_plan(root)

    def _op_label(self, node) -> str:
        lbl = self._op_labels.get(id(node))
        if lbl is None:
            lbl = self._op_labels[id(node)] = f"{type(node).__name__}#{len(self._op_labels)}"
        return lbl

    def _boundary_sink(self, key, label: str) -> dict:
        sink = self.boundary.get(key)
        if sink is None:
            sink = self.boundary[key] = {"label": label, "dispatches": 0,
                                         "transfers": 0, "bytes": 0}
        return sink

    def _node_stats(self, node) -> dict:
        """THE per-node stats registration point: the first registration
        captures the node's structural path and CBO estimate from the
        begin_plan maps (tests/test_torch_isolation.py holds that nothing
        else writes ``stats``)."""
        s = self.stats.get(id(node))
        if s is None:
            s = self.stats[id(node)] = {"rows": 0, "wall_s": 0.0}  # stats-ok: the registration point
            s["op"] = type(node).__name__
            path = self._node_paths.get(id(node))
            if path is not None:
                s["path"] = path
            est = self._node_ests.get(id(node))
            if est is not None:
                s["est_rows"] = est
        return s

    def _record(self, node, page: Page, t0: float) -> None:
        """Pipeline-breaker stats: the output's live rows, kept on the
        device (no read), and the wall since ``t0``, cumulative over the
        node's subtree."""
        s = self._node_stats(node)
        s["rows"] = _live_rows(page)
        s["wall_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------------ public
    def execute(self, node: P.PlanNode) -> MaterializedResult:
        self.host_reads = 0
        self.host_bytes = 0
        self.h2d_bytes = 0
        self._reset_stats(node)
        host = tuple(self.exec_params or ())
        try:
            with device_constants(self._count_h2d):
                # the bound scalars reach the device once per query: one copy
                # per slot's value and one of every slot's null flag
                dev = ()
                if host:
                    isnull = self._to_device(np.array([bool(n) for _, n in host]))
                    dev = tuple((self._to_device(np.asarray(v)), isnull[i])
                                for i, (v, _) in enumerate(host))
                with _params_scope(dev, host):
                    page, dicts = self._execute_to_page(node)
                    # the final read belongs to no plan node: a "Result"
                    # operator keeps the per-operator sums equal the totals
                    with tracing.operator_scope(
                            "Result", self._boundary_sink("result", "Result")):
                        return self._materialize(page, dicts)
        finally:
            self.close_producers()
            self._release_reserved()

    def _release_reserved(self) -> None:
        for nbytes in self._reserved:
            self.memory_pool.free(nbytes, "join-build")
        self._reserved.clear()

    def close_producers(self, join_timeout: float = 2.0) -> int:
        """Stop every prefetch producer this executor started for the query
        (set each stop flag, then briefly join the threads) and close every
        spill it registered (``close`` is idempotent).  Called on every exit
        of ``execute`` and ``execute_batched``; returns the number of
        producers that were registered."""
        procs, self._producers = self._producers, []
        for stop, _t in procs:
            stop.set()
        deadline = time.monotonic() + join_timeout
        for _stop, t in procs:
            if t.is_alive():
                t.join(timeout=max(deadline - time.monotonic(), 0.05))
        spills, self._spills = self._spills, []
        for sp in spills:
            sp.close()
        if self._fused_own:
            self.fused_cache.clear()  # the executor's own graphs end with it
        return len(procs)

    def forget_plan(self, plan: P.PlanNode) -> None:
        """Drop what this executor keeps of a plan the caller replaces (a
        worker's evicted fragment, a coordinator's stale plan): its stats,
        boundary records and plan-history facts.  The port caches no
        streams; its captured scan-fused bodies hold the nodes they are
        keyed by, so their ids stay theirs until the fused cache lets them
        go."""
        ids = set()

        def walk(n):
            ids.add(id(n))
            for c in n.children:
                walk(c)

        walk(plan)
        for store in (self.stats, self.boundary, self._plan_facts, self._op_labels):
            for key in [k for k in list(store) if k in ids]:
                store.pop(key, None)

    def execute_batched(self, node: P.PlanNode, runtimes) -> list:
        """One fused execution of a template plan for R bound runtimes (each a
        tuple of per-slot ``(numpy value, isnull)`` pairs).  Every slot's R
        values stage to the device in one copy; each source page is read
        once, and the stream's transform runs on it once per lane under that
        lane's binding; each lane's live rows pack through the compaction
        kernel.  Returns a list aligned with ``runtimes``: a
        ``MaterializedResult`` per member, or that member's own exception.
        Raises ``BatchUnsupported`` where the plan or a page cannot take
        this path."""
        if not runtimes or not runtimes[0]:
            raise BatchUnsupported("empty batch or parameterless template")
        if not _batchable_plan(node):
            raise BatchUnsupported("plan shape outside the fused template subset")
        self.host_reads = 0
        self.host_bytes = 0
        self.h2d_bytes = 0
        self._reset_stats(node)
        n = len(runtimes)
        out_schema = node.schema if isinstance(node, P.Output) else None
        inner = node.child if isinstance(node, P.Output) else node
        try:
            with device_constants(self._count_h2d):
                stacked = tuple(
                    (self._to_device(np.stack([np.asarray(r[s][0]) for r in runtimes])),
                     self._to_device(np.array([bool(r[s][1]) for r in runtimes])))
                    for s in range(len(runtimes[0])))
                lanes = [tuple((v[i], nl[i]) for v, nl in stacked) for i in range(n)]
                # the device-value scope stays empty: only a lane's own
                # bind_params makes its values visible
                with _params_scope((), batch_hosts=tuple(tuple(r) for r in runtimes)):
                    label = self._op_label(inner)
                    with tracing.operator_scope(label, self._boundary_sink(id(inner), label)):
                        stream = self._compile_stream(inner)
                        parts = self._batched_parts(stream, lanes)
                    schema = out_schema if out_schema is not None else stream.schema
                    with tracing.operator_scope(
                            "Result", self._boundary_sink("result", "Result")):
                        return self._demux_batched(schema, stream.dicts, parts, n)
        finally:
            self.close_producers()
            self._release_reserved()

    def _batched_parts(self, stream: _Stream, lanes) -> list:
        """Per lane, the packed live rows of every page, as ``_concat_stream``
        packs one stream's: the lanes' live counts are read in one read per
        chunk of eight pages, and each lane's part takes its pow2 bucket."""
        nc = len(stream.schema.fields)
        parts: list = [[] for _ in lanes]
        staged, sums = [], []

        def drain():
            counts = self._host([torch.stack(sums)], site="batch.counts")[0]
            counts = counts.reshape(len(staged), len(lanes))
            for outs, row in zip(staged, counts):
                for lane, ((cols, nulls, valid), c) in enumerate(zip(outs, row)):
                    c = int(c)
                    if c == 0:
                        continue
                    bucket = min(max(1 << max(c - 1, 1).bit_length(), 1024),
                                 valid.shape[0])
                    packed, _ = compact_rows(tuple(cols) + tuple(nulls), valid, bucket)
                    parts[lane].append((packed[:nc], packed[nc:], c))
            staged.clear()
            sums.clear()

        for page in stream.pages():
            outs = []
            for lane in lanes:
                with bind_params(lane):
                    cols, nulls, valid = stream.run(page)
                if any(isinstance(c, np.ndarray) for c in cols):
                    raise BatchUnsupported("a host (object-dtype) page cannot batch")
                outs.append((cols, nulls, valid))
                sums.append(torch.sum(valid, dtype=torch.int32))
            staged.append(outs)
            if len(staged) >= 8:
                drain()
        if staged:
            drain()
        return parts

    def _demux_batched(self, schema, dicts, parts, n: int) -> list:
        """Per-lane results of a fused batch: every lane's rows and null
        masks pulled in ONE read, then each lane decoded on its own.  A lane
        whose decode raises carries its exception in the returned list."""
        fetch, layout = [], []
        for lane_parts in parts:
            if not lane_parts:
                layout.append(None)
                continue
            nc = len(lane_parts[0][0])
            start = len(fetch)
            fetch += [torch.cat([cols[ci][:c] for cols, _, c in lane_parts])
                      for ci in range(nc)]
            has_null = []
            for ci in range(nc):
                if all(nulls[ci] is None for _, nulls, _ in lane_parts):
                    has_null.append(False)
                    continue
                has_null.append(True)
                fetch.append(torch.cat([
                    torch.zeros((c,), dtype=torch.bool, device=cols[ci].device)
                    if nulls[ci] is None else nulls[ci][:c]
                    for cols, nulls, c in lane_parts]))
            layout.append((start, nc, has_null))
        got = self._host(fetch, site="result.batched") if fetch else []
        results: list = []
        hook = BATCH_LANE_TEST_HOOK
        for lane in range(n):
            try:
                if hook is not None:
                    hook(lane, n)
                lay = layout[lane]
                if lay is None:
                    cols = [torch.zeros((0,), dtype=torch_dtype(f.type)).numpy()
                            for f in schema.fields]
                    nulls = [None] * len(cols)
                else:
                    start, nc, has_null = lay
                    cols = got[start:start + nc]
                    rest = iter(got[start + nc:start + nc + sum(has_null)])
                    nulls = [next(rest) if h else None for h in has_null]
                rows = len(cols[0]) if cols else 0
                results.append(_materialize_host(schema, np.ones((rows,), bool), cols,
                                                 nulls, dicts))
            except Exception as e:  # noqa: BLE001 - the lane's own error
                results.append(e)
        return results

    # ------------------------------------------------------- the buffer pool
    def _page_cache_on(self) -> bool:
        """Does this query read and fill the buffer pool's page and build
        tiers?  The ``page_cache`` session property decides where it is set;
        otherwise the pool's budget (0: off, the CPU default).  The property
        gates the use of a configured pool: it makes no budget."""
        bp = self.buffer_pool
        if bp is None or not bp.enabled:
            return False
        return True if self.page_cache is None else bool(self.page_cache)

    def _scan_pages_source(self, conn, catalog: str, table: str, splits, columns):
        """Page source of a (possibly split-pruned) scan, through the page
        tier.  A hit yields the whole scan as one device page: no generation,
        and every per-split loop downstream runs once.  A miss runs the
        per-split source, keeps its pages, and stores them as one page only
        once the scan ran to completion: a consumer that stops early (LIMIT)
        or an error leaves the generator before the store.  The lookup, its
        accounting and the store run on the query's thread.  A ``HOST_DECODE``
        connector's pages (numpy) are staged to the device by a prefetch
        producer (``_prefetched_pages``); the static, bind-time and dynamic
        pruners rebuild their sources here, so they keep that staging."""
        splits, columns = list(splits), tuple(columns)
        raw = _scan_pages(conn, table, splits, columns)
        if getattr(conn, "HOST_DECODE", False):
            # host-decoded pages (the file connectors): decoded and staged to
            # the device on a producer thread, whatever the dispatch batch,
            # so decode and the copy overlap the consumer's work; each page
            # is an ``h2d`` fault point and its bytes count in h2d_bytes
            raw = _prefetched_pages(raw, to_device=True, owner=self)
        elif len(splits) > 1 and _dispatch_batch_default() > 1:
            raw = _staged_scan_pages(raw)
        bp = self.buffer_pool

        def pages(self=self):
            if not (splits and bp is not None and self._page_cache_on()
                    and bp.cacheable(conn)):
                yield from raw()
                return
            key = bp.page_key(catalog, conn, table, splits, columns)
            hit = bp.get_page(key)
            if hit is not None:
                page, nbytes = hit
                tracing.record_page_cache(hits=1, bytes_saved=nbytes)
                yield page
                return
            tracing.record_page_cache(misses=1)
            acc = None if bp.has_page(key) else []
            acc_bytes = 0
            for pg in raw():
                if acc is not None:
                    # a scan past the whole budget, or with host columns,
                    # is not kept: its pages free as they are consumed
                    acc_bytes += _page_bytes(pg)
                    if acc_bytes > bp.budget() or not all(
                            isinstance(c, torch.Tensor) for c in pg.columns):
                        acc = None
                    else:
                        acc.append(pg)
                yield pg
            if acc:
                # staging launches and allocates: an entry lets the watchdog
                # see a store that hangs.  A store that fails (an injected
                # fault, a staging error) does not fail a query whose scan
                # completed, and admits nothing: put_page takes only the
                # fully staged page
                try:
                    with tracing.inflight("cache-store", site=f"scan.{table}.store"):
                        bp.put_page(key, self._stage_scan_entry(acc), self._pool_epoch)
                except tracing.StallKilledError:
                    raise  # a watchdog kill is never neutralized here
                except Exception:  # noqa: BLE001 - uncached, not failed
                    pass

        return pages

    def _stage_scan_entry(self, pages) -> Page:
        """One device page of a completed scan: the pages concatenated in
        split order, then, where lanes are dead (generated tables mask rows
        past their bound), the live rows packed in order by the compaction
        kernel, every lane of the stored page live.  Row order is split
        order either way, so the page gives exactly what the splits give.
        Each page is an ``h2d`` fault point, as the reference stages each
        through ``_page_to_device`` here."""
        for _ in pages:
            faults.maybe_inject("h2d", "page_to_device")
        nc = len(pages[0].columns)
        cols = [torch.cat([p.columns[ci] for p in pages]) for ci in range(nc)]
        nulls = [None if all(p.null_masks[ci] is None for p in pages) else torch.cat([
            torch.zeros((p.capacity,), dtype=torch.bool, device=p.columns[ci].device)
            if p.null_masks[ci] is None else p.null_masks[ci] for p in pages])
            for ci in range(nc)]
        if all(p.valid is None for p in pages):
            return Page(pages[0].schema, tuple(cols), tuple(nulls), None)
        valid = torch.cat([p.valid_mask() for p in pages])
        n = int(valid.shape[0])
        live = int(self._host([torch.sum(valid, dtype=torch.int64)],
                              site="cache.store.count")[0])
        if live == 0 or live == n:
            return Page(pages[0].schema, tuple(cols), tuple(nulls), valid)
        packed, _ = compact_rows(tuple(cols) + tuple(nulls), valid, live)
        return Page(pages[0].schema, packed[:nc], packed[nc:], None)

    def _store_build(self, key, payload, anchor) -> bool:
        """Admit a finished build to the build tier.  A store that fails (an
        injected fault, a pool error) does not fail a join whose build is
        done: the build is then not shared, and nothing is admitted."""
        try:
            return self.buffer_pool.put_build(key, payload, self._pool_epoch, anchor)
        except tracing.StallKilledError:
            raise  # a watchdog kill is never neutralized here
        except Exception:  # noqa: BLE001 - unshared, not failed
            return False

    def _build_cache_key(self, node: P.Join):
        """Build-tier key of this join's build fragment, or None when it must
        not be cached (the tiers are off for this query, or the fragment
        reads a volatile connector): ("build", structural fingerprint, right
        keys, catalogs, filter is None).  invalidate_catalog matches the
        catalogs (key[3]); plan_versions are in the fingerprint."""
        bp = self.buffer_pool
        if bp is None or not self._page_cache_on():
            return None
        if self._overrides and self._subtree_overridden(node.right):
            return None  # the build reads this query's spooled output
        cats: set = set()
        cacheable = True

        def walk(n):
            nonlocal cacheable
            if isinstance(n, P.TableScan):
                conn = self.catalogs.get(n.catalog)
                if conn is None or not bp.cacheable(conn):
                    cacheable = False
                cats.add(n.catalog)
            for c in n.children:
                walk(c)

        walk(node.right)
        if not cacheable:
            return None
        return ("build", _plan_fingerprint(node.right, self.catalogs),
                tuple(node.right_keys), tuple(sorted(cats)), node.filter is None)

    # ------------------------------------------------------ device -> host reads
    def _host(self, arrays, site: str):
        """THE device -> host chokepoint: one call is one counted read of
        every array in ``arrays`` (``site`` names the caller).  It holds an
        in-flight ``host_pull`` entry while it reads: each read synchronises,
        so a kernel that hangs shows here to the stall watchdog.  It is a
        ``dispatch`` and a ``host_pull`` fault point (``execution/faults``),
        inside that entry."""
        out = []
        nbytes = 0
        reg = tracing.current_inflight()
        tok = reg.enter("host_pull", site)
        try:
            if tracing.DISPATCH_TEST_HOOK is not None:
                tracing.DISPATCH_TEST_HOOK(tracing.full_site_label(site))
            faults.maybe_inject("dispatch", site)
            faults.maybe_inject("host_pull", site)
            self.host_reads += 1
            for a in arrays:
                if isinstance(a, torch.Tensor):
                    nbytes += a.numel() * a.element_size()
                    out.append(a.cpu().numpy())
                else:
                    out.append(None if a is None else np.asarray(a))
        finally:
            reg.exit(tok)
        self.host_bytes += nbytes
        tracing.record_host_read(nbytes, site)
        return out

    def _count_h2d(self, nbytes: int):
        self.h2d_bytes += int(nbytes)

    def _to_device(self, arr, dtype=None) -> torch.Tensor:
        """A host array on the engine's device, its bytes counted."""
        arr = np.asarray(arr)
        self._count_h2d(arr.nbytes)
        t = torch.as_tensor(arr, device=self.device)
        return t if dtype is None else t.to(dtype)

    def _host_page(self, page: Page, site="page"):
        """(valid, cols, nulls) as numpy, in one read."""
        nc = len(page.columns)
        has_valid = page.valid is not None
        got = self._host(list(page.columns) + list(page.null_masks)
                         + ([page.valid] if has_valid else []), site=site)
        valid = got[-1] if has_valid else np.ones((page.capacity,), bool)
        return valid, got[:nc], got[nc:nc + len(page.null_masks)]

    # ---------------------------------------------------------------- internal
    def _execute_to_page(self, node: P.PlanNode):
        """Run a (sub)plan to completion: one Page + its dictionaries.  Every
        launch and host read while the node runs charges its boundary record
        (innermost node wins: a streaming chain charges the breaker that
        drives it).  An overridden node returns its installed output."""
        if self._overrides:
            hit = self._overrides.get(id(node))
            if hit is not None:
                return hit
        label = self._op_label(node)
        with tracing.operator_scope(label, self._boundary_sink(id(node), label)):
            return self._execute_node(node)

    def _execute_node(self, node: P.PlanNode):
        t0 = time.perf_counter()
        if isinstance(node, P.Output):
            child, dicts = self._execute_to_page(node.child)
            return Page(node.schema, child.columns, child.null_masks, child.valid), dicts
        if isinstance(node, P.Sort):
            child, dicts = self._execute_to_page(node.child)
            page = self._sort_or_topn(child, node.keys, None, dicts)
            self._record(node, page, t0)
            return page, dicts
        if isinstance(node, P.Limit):
            if isinstance(node.child, P.Sort):
                # TopN: select the top rows before pulling them
                child, dicts = self._execute_to_page(node.child.child)
                page = self._sort_or_topn(child, node.child.keys, node.count, dicts)
                self._record(node, page, t0)
                return page, dicts
            if not isinstance(node.child, _BLOCKING):
                # streaming child: stop pulling pages once the limit is reached
                page, dicts = self._limited_stream_page(node)
                self._record(node, page, t0)
                return page, dicts
            child, dicts = self._execute_to_page(node.child)
            return self._limit_page(child, node.count), dicts
        if isinstance(node, P.Aggregate):
            page, dicts = self._run_aggregate(node)
        elif isinstance(node, P.Window):
            page, dicts = self._run_window(node)
        elif isinstance(node, P.Unnest):
            child, cdicts = self._execute_to_page(node.child)
            page, dicts = self._run_unnest(node, child, cdicts)
        elif isinstance(node, P.MatchRecognize):
            child, cdicts = self._execute_to_page(node.child)
            page, dicts = self._run_match_recognize(node, child, cdicts)
        else:
            # streaming leaf reached directly (scan/filter/project/join-probe):
            # materialize
            stream = self._compile_stream(node)
            page, dicts = self._concat_stream(stream, node), stream.dicts
        self._record(node, page, t0)
        return page, dicts

    # -- page compaction at pipeline boundaries ------------------------------
    def _compactable_fraction(self, node) -> bool:
        """Compact this streaming subtree's output before an expensive consumer
        when the CBO estimates <= 1/8 of the scan's lanes survive."""
        cur = node
        while isinstance(cur, (P.Project, P.Filter)):
            cur = cur.child
        if not isinstance(cur, P.Join) or cur.est_rows is None:
            return False
        scan = cur
        while not isinstance(scan, P.TableScan):
            if isinstance(scan, P.Join):
                scan = scan.left
            elif isinstance(scan, (P.Project, P.Filter)):
                scan = scan.child
            else:
                return False
        conn = self.catalogs.get(scan.catalog)
        if conn is None or not hasattr(conn, "row_count"):
            return False
        return float(cur.est_rows) <= float(conn.row_count(scan.table)) / 8.0

    def _compacted_stream(self, up: _Stream) -> _Stream:
        """Per page: run the upstream chain, read the surviving-row count, and
        pack live rows into the smallest bucket (n/4, n/16, n/64) that holds
        them, through the compaction kernel; dense pages pass untouched."""

        def pages(up=up, self=self):
            for cols, nulls, valid in self._outs(up):
                n = int(valid.shape[0])
                count = int(self._host([torch.sum(valid)], site="compact.count")[0])
                bucket = n
                for sh in (6, 4, 2):  # smallest sufficient bucket wins
                    if count <= (n >> sh):
                        bucket = max(n >> sh, 1)
                        break
                if bucket >= n:
                    yield Page(up.schema, cols, nulls, valid)
                    continue
                packed, total = compact_rows(tuple(cols) + tuple(nulls), valid, bucket)
                cvalid = torch.arange(bucket, device=valid.device) < total
                yield Page(up.schema, packed[:len(cols)], packed[len(cols):], cvalid)

        si = up.scan_info
        if si is not None:
            si = dataclasses.replace(si, replayable=False)
        # compaction moves live rows and changes none: a regenerated page
        # runs the upstream chain as a stage before this one
        tsrc = up.traced_src
        if tsrc is not None:
            tsrc = dataclasses.replace(tsrc, stages=tsrc.stages + (up,))
        return _Stream(up.schema, up.dicts, pages, _identity, si,
                       clustered_by=up.clustered_by, compacted=True, traced_src=tsrc)

    # -- streaming segment compilation ---------------------------------------
    def _subtree_overridden(self, node) -> bool:
        return id(node) in self._overrides \
            or any(self._subtree_overridden(c) for c in node.children)

    def _compile_stream(self, node: P.PlanNode) -> _Stream:
        if self._overrides and id(node) in self._overrides:
            # a durable fragment output (the FTE spool, a remote task)
            # stands for the subtree: one page, so streaming consumers read
            # the spooled result instead of running the fragment again
            page, dicts = self._overrides[id(node)]
            page = self._device_page(page)
            return _Stream(node.schema, dicts, lambda page=page: iter((page,)), _identity)
        if isinstance(node, P.TableScan):
            conn = self.catalogs[node.catalog]
            dicts = tuple(conn.dictionaries(node.table).get(c) for c in node.columns)
            splits = self._split_restriction.get(id(node)) if self._split_restriction else None
            if splits is None:
                with tracing.inflight("split-generation", site=f"scan.{node.table}"):
                    splits = conn.splits(node.table)
            # plan-history fact: the split count the advisor tunes
            # dispatch_batch from
            self._plan_facts[id(node)] = (node, {"splits": len(splits)})
            si = _ScanInfo(conn, splits, tuple(node.columns), tuple(node.columns),
                           catalog=node.catalog, table=node.table)
            clustered = tuple(conn.clustered_by(node.table)) \
                if hasattr(conn, "clustered_by") else ()
            pages = self._scan_pages_source(conn, node.catalog, node.table, splits,
                                            node.columns)
            # a generator's equal-length splits can be made again on the
            # device from their offsets: the scan-fused runners' source
            tsrc = None
            if (hasattr(conn, "generate_traced") and not getattr(conn, "HOST_DECODE", False)
                    and splits and all(hasattr(sp, "lo") and hasattr(sp, "hi")
                                       for sp in splits)
                    and len({sp.hi - sp.lo for sp in splits}) == 1):
                tsrc = _TracedSrc(conn, node.table, tuple(splits), tuple(node.columns))
            return _Stream(node.schema, dicts, pages, _identity, si, clustered_by=clustered,
                           traced_src=tsrc)

        if isinstance(node, P.Filter):
            up = self._compile_stream(node.child)
            pred = node.predicate

            def transform(cols, nulls, valid, aux, up=up, pred=pred):
                cols, nulls, valid = up.transform(cols, nulls, valid, aux)
                return cols, nulls, evaluate_predicate(pred, cols, nulls, valid)

            pruned = _static_pruned_stream(up, pred)
            if pruned is not None:
                # the kept splits key their own page-tier entry
                psi = pruned[1]
                pruned = (self._scan_pages_source(psi.conn, psi.catalog, psi.table,
                                                  psi.splits, psi.scan_columns), psi)
            pages, si = pruned if pruned is not None else (up.pages, up.scan_info)
            tsrc = up.traced_src
            if pruned is not None and tsrc is not None:
                tsrc = dataclasses.replace(tsrc, splits=tuple(si.splits))
            # bind-time split pruning: a parameter carries no plan-time value,
            # so the pass above cannot see it; prune per execution from the
            # bound values, starting from the statically kept splits
            rt = self._param_pruned_source(up, pred, si)
            if rt is not None:
                pages = rt
                tsrc = None  # the kept splits change with each binding
            return _Stream(up.schema, up.dicts, pages, transform, si, aux=up.aux,
                           clustered_by=up.clustered_by, compacted=up.compacted,
                           traced_src=tsrc)

        if isinstance(node, P.Project):
            up = self._compile_stream(node.child)
            planner_dicts = node.dicts or tuple(None for _ in node.exprs)
            dicts = tuple(
                pd if pd is not None
                else (up.dicts[e.index] if isinstance(e, FieldRef) else None)
                for pd, e in zip(planner_dicts, node.exprs))

            def transform(cols, nulls, valid, aux, up=up, exprs=node.exprs):
                cols, nulls, valid = up.transform(cols, nulls, valid, aux)
                out = [evaluate(e, cols, nulls) for e in exprs]
                # constants evaluate to 0-d tensors: broadcast to the row count
                vs = tuple(v.expand(valid.shape) if v.ndim == 0 else v for v, _ in out)
                ns = tuple(None if m is None
                           else (m.expand(valid.shape) if m.ndim == 0 else m)
                           for _, m in out)
                return vs, ns, valid

            si = None
            if up.scan_info is not None:
                si = dataclasses.replace(up.scan_info, columns=tuple(
                    up.scan_info.columns[e.index] if isinstance(e, FieldRef) else None
                    for e in node.exprs))
            return _Stream(node.schema, dicts, up.pages, transform, si, aux=up.aux,
                           clustered_by=up.clustered_by, compacted=up.compacted,
                           traced_src=up.traced_src)

        if isinstance(node, P.Join):
            return self._compile_join(node)

        if isinstance(node, P.Union):
            # UNION ALL: each branch's transformed pages in turn; the first
            # branch's dictionaries label the output, as in the reference
            subs = [self._compile_stream(c) for c in node.inputs]

            def pages(subs=subs, node=node):
                for sub in subs:
                    for page in sub.pages():
                        yield Page(node.schema, *sub.run(page))

            return _Stream(node.schema, subs[0].dicts, pages, _identity)

        if isinstance(node, P.Values):
            page = self._values_page(node)
            return _Stream(node.schema, tuple(None for _ in node.schema.fields),
                           lambda page=page: iter((page,)), _identity)

        if isinstance(node, _BLOCKING_NODES):
            # blocking sub-plan feeding a streaming consumer: run it, emit its page
            page, dicts = self._execute_to_page(node)
            page = self._device_page(page)
            return _Stream(node.schema, dicts, lambda page=page: iter((page,)), _identity)

        raise _not_ported(f"{type(node).__name__} node in a streaming pipeline")

    # -- aggregation sink ----------------------------------------------------
    def _key_ranges(self, stream, node):
        """Static (lo, hi) bounds per group key channel, from dictionaries, type,
        or connector stats."""
        si = stream.scan_info
        table_name = None
        if si is not None and si.splits and hasattr(si.splits[0], "table"):
            table_name = si.splits[0].table
        out = []
        for i in node.keys:
            t = stream.schema.fields[i].type
            d = stream.dicts[i]
            if d is not None and getattr(d, "values", None) is not None:
                out.append((0, max(len(d.values) - 1, 0)))
            elif t.name == "boolean":
                out.append((0, 1))
            elif t.is_floating:
                out.append(None)
            else:
                rng = None
                if (si is not None and i < len(si.columns)
                        and si.columns[i] is not None and table_name is not None
                        and hasattr(si.conn, "column_range")):
                    r = si.conn.column_range(table_name, si.columns[i])
                    if r and r[0] is not None and r[1] is not None:
                        rng = (int(r[0]), int(r[1]))
                out.append(rng)
        return tuple(out)

    def _agg_capacity_estimate(self, stream, node, key_ranges):
        """Upper-bound estimate of the group count from static key ranges and
        the source table's row bound (saturates at MAX_GROUP_CAPACITY)."""
        est = None
        prod = 1
        for r in key_ranges:
            if r is None:
                prod = None
                break
            prod = min(prod * max(int(r[1]) - int(r[0]) + 1, 1), MAX_GROUP_CAPACITY)
        if prod is not None:
            est = prod
        si = stream.scan_info
        if si is not None and si.splits and hasattr(si.conn, "row_count") \
                and hasattr(si.splits[0], "table"):
            bound = int(si.conn.row_count(si.splits[0].table))
            est = bound if est is None else min(est, bound)
        return est

    def _streaming_agg_order(self, stream, node):
        """Group-key source names when the stream's clustering makes every
        group's rows contiguous, else None."""
        if not stream.clustered_by or stream.scan_info is None:
            return None
        si = stream.scan_info
        names = []
        for ch in node.keys:
            nm = si.columns[ch] if ch < len(si.columns) else None
            if nm is None:
                return None
            names.append(nm)
        nk = len(names)
        if len(set(names)) != nk or set(names) != set(stream.clustered_by[:nk]):
            return None
        return tuple(names)

    # -- the scan-fused whole-scan runners ------------------------------------
    def _traced_chain(self, stream):
        """``_traced_chain_always`` where the fused runners are on."""
        if not _scan_fused_enabled(self.device):
            return None
        return self._traced_chain_always(stream)

    def _traced_chain_always(self, stream):
        """(chain, split offsets, stage auxes) of a regenerable stream, or
        None.  ``chain(lo, auxes)`` makes one split's raw page from its
        offset ``lo`` (a host int or a 0-d device tensor) and pushes it
        through every stage: (cols, nulls, valid).  The stages' device state
        is an argument, never closed over, so a captured body reads the
        copies it is given.  A stream whose state holds anything but
        tensors and host scalars is not eligible."""
        ts = stream.traced_src
        if ts is None or not ts.splits:
            return None
        stages = ts.stages + (stream,)
        auxes = tuple(st.aux for st in stages)
        if _tree_sig(auxes, []) is None:
            return None
        length = int(ts.splits[0].hi - ts.splits[0].lo)
        los = tuple(int(sp.lo) for sp in ts.splits)
        transforms = tuple(st.transform for st in stages)

        def chain(lo, auxes, ts=ts, length=length, transforms=transforms):
            cols, valid = ts.conn.generate_traced(ts.table, lo, length, ts.scan_cols)
            if valid is None:
                valid = torch.ones(cols[0].shape, dtype=torch.bool, device=cols[0].device)
            nulls = tuple(None for _ in cols)
            for tf, aux in zip(transforms, auxes):
                cols, nulls, valid = tf(cols, nulls, valid, aux)
            return cols, nulls, valid

        return chain, los, auxes

    def _chain_layout(self, node, chain, los, auxes):
        """(column dtypes, which columns carry a null mask, rows per split)
        of a chain's output, or None where a column is not a device tensor.
        The chain runs once on the first split (the reference's
        ``eval_shape`` runs nothing), and its launches count as the
        statement's; the layout is kept in the fused cache, so a warm
        statement runs nothing."""
        key = ("layout", id(node), len(los))
        hit = self.fused_cache.get(key)
        if hit is None:
            cols, nulls, valid = chain(los[0], auxes)
            if all(isinstance(c, torch.Tensor) and c.dim() == 1 for c in cols):
                lay = (tuple(c.dtype for c in cols), tuple(m is not None for m in nulls),
                       int(valid.shape[0]))
            else:
                lay = None
            hit = (node, lay)
            self.fused_cache.put(key, hit)
        return hit[1]

    def _fused_scan(self, key, node, site: str, los, state, aux, body):
        """Run ``body(lo, state, aux) -> state`` (flat lists of tensors of
        fixed shapes) over every split offset in ``los``; returns the final
        state, tensors the caller owns.

        On the CPU, or with ``FUSED_GRAPHS`` off, a plain loop.  On the card
        the body is captured once as a CUDA graph (cached in
        ``fused_cache`` under ``key`` and the shapes of its inputs) that
        reads its split's offset from a device array at an index the graph
        advances itself; a statement copies its initial state, its stage
        state and its bound parameters into the graph's static tensors,
        replays the graph once per split, and takes a copy of the final
        state.  A body that updates its state in place (the group-by
        inserts, the traced concat's buffers) writes the static tensors
        themselves; the capture copies back only the leaves it returns
        anew (counters, scalar accumulators).  Each replay is a
        ``dispatch`` fault point, holds an in-flight entry, and charges the
        kernel launches its body holds.
        ``body`` reads no device tensor but its arguments and those it makes:
        a graph replays the addresses it saw at capture."""
        n = len(los)
        if self.device.type != "cuda" or not FUSED_GRAPHS:
            offs = torch.as_tensor(np.asarray(los, dtype=np.int64)) \
                if self.device.type == "cpu" \
                else self._to_device(np.asarray(los, dtype=np.int64))
            state = list(state)
            for i in range(n):
                faults.maybe_inject("dispatch", site)
                state = list(body(offs[i], state, aux))
            return state
        aux_leaves, par_leaves = [], []
        asig = _tree_sig(aux, aux_leaves)
        params = current_params()
        psig = _tree_sig(params, par_leaves)
        gkey = key + (n, asig, psig,
                      tuple((tuple(t.shape), t.dtype) for t in state))
        entry = self.fused_cache.get(gkey)
        if entry is None:
            entry = self._fused_capture(gkey, node, los, state, aux_leaves, asig,
                                        par_leaves, psig, body)
        reg = tracing.current_inflight()
        with entry.lock:
            for dst, src in zip(entry.state, state):
                dst.copy_(src)
            for dst, src in zip(entry.aux, aux_leaves):
                dst.copy_(src)
            for dst, src in zip(entry.params, par_leaves):
                dst.copy_(src)
            if entry.los_host != tuple(los):
                entry.los.copy_(self._to_device(np.asarray(los, dtype=np.int64)))
                entry.los_host = tuple(los)
            entry.idx.zero_()
            for _ in range(n):
                tok = reg.enter("dispatch", site)
                try:
                    faults.maybe_inject("dispatch", site)
                    entry.graph.replay()
                finally:
                    reg.exit(tok)
                cuda_kernels.charge_launches(entry.launches)
            tracing.record_graph(replays=n)
            return [t.clone() for t in entry.state]

    def _fused_capture(self, gkey, node, los, state, aux_leaves, asig, par_leaves, psig,
                       body):
        """Capture ``body`` over static copies of its inputs (see
        ``_fused_scan``).  The body first runs once eagerly on a scratch copy
        of the state, on a side stream: that builds the kernels, copies the
        planner constants it reads to the device (kept by the entry: a
        capture copies nothing from the host) and loads every CUDA module it
        needs; its launches run on the card and count as the statement's
        (the capture's launch nothing).  The static tensors and what the
        capture adds to the graph pool are held in the engine cache's memory
        pool (``FusedGraphCache``).  A capture that fails raises."""
        cache = self.fused_cache
        dev = self.device
        with _CAPTURE_LOCK:
            hit = cache.get(gkey)
            if hit is not None:
                return hit
            cur = torch.cuda.current_stream(dev)
            sstate = [t.clone() for t in state]
            saux = [t.clone() for t in aux_leaves]
            spar = [t.clone() for t in par_leaves]
            aux = _tree_build(asig, iter(saux))
            params = _tree_build(psig, iter(spar))
            offs = self._to_device(np.asarray(los, dtype=np.int64))
            idx = torch.zeros((), dtype=torch.int64, device=dev)
            consts: dict = {}
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            with device_constants(self._count_h2d, cache=consts, scalars=True), \
                    bind_params(params), cuda_kernels.recording_launches() as rec:
                with torch.cuda.stream(side):
                    scratch = [t.clone() for t in sstate]
                    body(offs[0], scratch, aux)
                    del scratch
                side.synchronize()
                cuda_kernels.charge_launches(rec)
                rec.clear()
                before = torch.cuda.memory_reserved(dev)
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=_graph_pool(dev, graph),
                                        capture_error_mode="thread_local")
                    try:
                        lo = offs.index_select(0, idx.view(1)).view(())
                        out = body(lo, sstate, aux)
                        for dst, src in zip(sstate, out):
                            if src is not dst:
                                dst.copy_(src)
                        idx.add_(1)
                        del out, lo
                    except BaseException:
                        try:
                            graph.capture_end()
                        except Exception:  # noqa: BLE001 - the body's error is raised
                            pass
                        raise
                    graph.capture_end()
                cur.wait_stream(side)
                launches = list(rec)
            cache.add_pool_bytes(max(torch.cuda.memory_reserved(dev) - before, 0))
            tracing.record_graph(captures=1)
            entry = _FusedGraph(node, graph, offs, idx, sstate, saux, spar, consts, launches)
            entry.los_host = tuple(los)
            cache.put(gkey, entry, sum(t.numel() * t.element_size()
                                       for t in (*sstate, *saux, *spar, offs)))
            return entry

    def _run_aggregate_scan_fused(self, node, stream, key_types, acc_specs, acc_exprs,
                                  acc_kinds):
        """Whole-scan grouped aggregation, generate -> transform (filters,
        projections, single-match join probes) -> group insert per split, in
        one captured body (``_fused_scan``): one host read per scan instead
        of the page loop's chunked reads.  The table cannot grow inside the
        scan: direct mode reserves its table and runs once (keys out of the
        statistics' ranges: hash mode); hash mode is sized from the
        statistics (up to 2^24 slots, the page loop's 2^20: an undershoot
        costs a whole scan again) and runs again at 4x on overflow, past the
        ceiling or the memory pool the Grace-partitioned path takes it.  A
        clustered input with a huge or unknown group count is left to the
        streaming aggregation.  None: the stream is not regenerable or the
        runners are off."""
        traced = self._traced_chain(stream)
        if traced is None:
            return None
        chain, los, auxes = traced
        key_dtypes = tuple(t.dtype for t in key_types)
        key_ranges = self._key_ranges(stream, node)
        nk = len(node.keys)
        cfg = None
        if all(r is not None for r in key_ranges):
            lay = self._chain_layout(node, chain, los, auxes)
            if lay is None:
                return None
            cfg = hashagg.direct_config(key_ranges, tuple(lay[1][i] for i in node.keys))
        key_w = sum(np.dtype(t.dtype).itemsize + 1 for t in key_types)
        acc_w = sum(np.dtype(dt).itemsize for dt, _ in acc_specs)

        def state_bytes(cap):
            return (cap + 1) * (8 + key_w + acc_w)

        def make_body(insert):
            def body(lo, flat, auxes):
                cols, nulls, valid = chain(lo, auxes)
                inputs = [(None, None) if e is None else _broadcast(evaluate(e, cols, nulls),
                                                                   valid)
                          for e in acc_exprs]
                return _gb_flat(insert(_gb_state(flat, nk), tuple(cols[i] for i in node.keys),
                                       tuple(nulls[i] for i in node.keys), inputs, valid))
            return body

        grace = node.grace_parts or 4
        if cfg is not None and self.memory_pool.try_reserve(state_bytes(cfg.capacity),
                                                            "group-by"):
            try:
                body = make_body(lambda st, kv, kn, inp, v: hashagg.direct_groupby_insert(
                    st, cfg, kv, v, inp, acc_kinds, kn, inplace=True))
                init = hashagg.direct_groupby_init(cfg, key_dtypes, acc_specs,
                                                   device=self.device)
                state = _gb_state(self._fused_scan(("agg", id(node), "direct", cfg), node,
                                                   "scan_fused.agg", los, _gb_flat(init),
                                                   auxes, body), nk)
                if not bool(self._host([state.overflow], "agg.fused.overflow")[0]):
                    return self._finalize_groups(node, stream, state)
            finally:
                self.memory_pool.free(state_bytes(cfg.capacity), "group-by")
            # stale statistics put keys out of range, or no memory: hash mode
        if self._streaming_agg_order(stream, node) is not None:
            est = self._agg_capacity_estimate(stream, node, key_ranges)
            if est is None or 2 * est > MAX_GROUP_CAPACITY:
                return None
        capacity = node.capacity or DEFAULT_GROUP_CAPACITY
        if not node.capacity:
            est = self._agg_capacity_estimate(stream, node, key_ranges)
            if est is not None:
                target = 1 << max(2 * est - 1, 1).bit_length()
                capacity = max(capacity, min(target, 1 << 24))
        capacity = ceil_pow2(capacity)
        if not self.memory_pool.try_reserve(state_bytes(capacity), "group-by"):
            return self._run_aggregate_partitioned(node, grace, stream)
        resv = state_bytes(capacity)
        body = make_body(lambda st, kv, kn, inp, v: hashagg.groupby_insert(
            st, kv, key_types, v, inp, acc_kinds, kn, inplace=True))
        try:
            while True:
                init = hashagg.groupby_init(capacity, key_dtypes, acc_specs,
                                            device=self.device)
                state = _gb_state(self._fused_scan(("agg", id(node), "hash"), node,
                                                   "scan_fused.agg", los, _gb_flat(init),
                                                   auxes, body), nk)
                if not bool(self._host([state.overflow], "agg.fused.overflow")[0]):
                    return self._finalize_groups(node, stream, state)
                grown = capacity * 4
                delta = state_bytes(grown) - state_bytes(capacity)
                if grown > MAX_GROUP_CAPACITY \
                        or not self.memory_pool.try_reserve(delta, "group-by"):
                    return self._run_aggregate_partitioned(node, grace, stream)
                resv += delta
                capacity = grown
        finally:
            self.memory_pool.free(resv, "group-by")

    def _run_global_scan_fused(self, node, stream, acc_specs, acc_exprs, acc_kinds):
        """The ungrouped variant: the accumulators are the body's state, and
        the scan costs one read (the envelope check).  None where the
        runners do not take the stream."""
        traced = self._traced_chain(stream)
        if traced is None:
            return None
        chain, los, auxes = traced

        def body(lo, state, auxes):
            cols, nulls, valid = chain(lo, auxes)
            return _global_agg_update(tuple(state), cols, nulls, valid, acc_exprs, acc_kinds)

        state = self._fused_scan(("global", id(node)), node, "scan_fused.global", los,
                                 list(_global_init_state(acc_specs, self.device)), auxes, body)
        return self._finish_global(node, state)

    def _concat_traced(self, stream: _Stream, node):
        """Whole-scan materialization of a regenerable stream in two fused
        passes and one read: a count pass sums every split's live rows, a
        fill pass packs each split's live rows (the compaction kernel) into
        one buffer of the pow2 bucket of that total (at least 1024 rows) at
        a running offset.  The scan is generated twice.  None where the
        runners do not take the stream."""
        traced = self._traced_chain(stream)
        if traced is None:
            return None
        chain, los, auxes = traced
        lay = self._chain_layout(node, chain, los, auxes)
        if lay is None:
            return None
        dtypes, has_null, rows = lay
        dev = self.device

        def count_body(lo, state, auxes):
            _, _, valid = chain(lo, auxes)
            return [state[0] + torch.sum(valid, dtype=torch.int64)]

        tot = self._fused_scan(("concat-count", id(node)), node, "scan_fused.concat", los,
                               [torch.zeros((), dtype=torch.int64, device=dev)], auxes,
                               count_body)[0]
        total = int(self._host([tot], site="concat.fused.count")[0])
        if total == 0:
            cols = tuple(torch.zeros((0,), dtype=dt, device=dev) for dt in dtypes)
            return Page(stream.schema, cols, tuple(None for _ in cols), None)
        cap = max(1 << max(total - 1, 1).bit_length(), 1024)
        nc = len(dtypes)
        nn = sum(has_null)

        def fill_body(lo, state, auxes):
            # every device tensor the body reads is made inside it or passed
            # in: a captured graph keeps the addresses it saw
            off, bufs = state[0], state[1:]
            cols, nulls, valid = chain(lo, auxes)
            lanes = torch.arange(rows, dtype=torch.int64, device=dev)
            masks = tuple(torch.zeros_like(valid) if m is None else m
                          for m, h in zip(nulls, has_null) if h)
            packed, live = compact_rows(tuple(cols) + masks, valid, rows)
            dst = torch.where(lanes < live, off + lanes, cap)
            for b, p in zip(bufs, packed):
                b.index_put_((dst,), p)
            return [off + live] + list(bufs)

        init = [torch.zeros((), dtype=torch.int64, device=dev)] \
            + [torch.zeros((cap + 1,), dtype=dt, device=dev) for dt in dtypes] \
            + [torch.zeros((cap + 1,), dtype=torch.bool, device=dev) for _ in range(nn)]
        out = self._fused_scan(("concat-fill", id(node)), node, "scan_fused.concat", los,
                               init, auxes, fill_body)
        cols = tuple(b[:cap] for b in out[1:1 + nc])
        masks = iter(out[1 + nc:])
        nulls = tuple(next(masks)[:cap] if h else None for h in has_null)
        return Page(stream.schema, cols, nulls, torch.arange(cap, device=dev) < total)

    def _run_aggregate(self, node: P.Aggregate):
        if any(s.kind in P.SORTED_AGG_KINDS for s in node.aggs):
            return self._run_sorted_aggregate(node)
        if not node.keys:
            return self._run_global_aggregate(node)
        stream, key_types, acc_specs, acc_exprs, acc_kinds, _ = self._agg_compiled(node)
        fused = self._run_aggregate_scan_fused(node, stream, key_types, acc_specs,
                                               acc_exprs, acc_kinds)
        if fused is not None:
            return fused
        capacity = node.capacity or DEFAULT_GROUP_CAPACITY

        # transformed pages: the first one is computed up front because its
        # null masks decide the direct layout (key nullability); the rest
        # run a coalesced group at a time into the table, or a page at a
        # time into the Grace partitions (the spill routes pages, as the
        # reference's does)
        page_iter = iter(stream.pages())
        first = next(page_iter, None)
        first_out = None
        cfg = None
        if first is not None:
            first_out = stream.run(first)
            key_ranges = self._key_ranges(stream, node)
            if all(r is not None for r in key_ranges):
                key_nullable = tuple(first_out[1][i] is not None for i in node.keys)
                cfg = hashagg.direct_config(key_ranges, key_nullable)
            if cfg is None and not node.capacity:
                # hash mode: size the table from the key-range product and the
                # input row bound; growth by rehash covers undershoots
                est = self._agg_capacity_estimate(stream, node, key_ranges)
                if est is not None:
                    target = 1 << max(2 * est - 1, 1).bit_length()
                    capacity = max(capacity, min(target, 1 << 20))
        outs = itertools.chain([first_out], self._outs(stream, page_iter)) \
            if first is not None else iter(())

        def paged():  # the same pages, not yet read, one at a time
            return itertools.chain([first_out], (stream.run(p) for p in page_iter)) \
                if first is not None else iter(())

        key_w = sum(np.dtype(t.dtype).itemsize + 1 for t in key_types)
        acc_w = sum(np.dtype(dt).itemsize for dt, _ in acc_specs)

        def state_bytes(cap):
            return (cap + 1) * (8 + key_w + acc_w)

        # streaming aggregation: the scan's clustering makes every group's
        # rows contiguous, so segmented reduces replace the probe loop; the
        # direct table still wins where it applies
        if cfg is None and self._streaming_agg_order(stream, node) is not None:
            return self._run_streaming_aggregate(node, stream, key_types, acc_specs,
                                                 acc_exprs, acc_kinds, capacity, outs,
                                                 state_bytes)

        # memory gate: group-by state lives on the device; when it cannot fit
        # the pool, Grace-partition (the spill).  Growth re-checks it.
        capacity = ceil_pow2(capacity)
        grace = node.grace_parts or 4
        if cfg is not None and not self.memory_pool.try_reserve(
                state_bytes(cfg.capacity), "group-by"):
            cfg = None  # direct table too large: try the (smaller) hash table
        resv = {"bytes": 0 if cfg is None else state_bytes(cfg.capacity)}
        if cfg is None:
            if not self.memory_pool.try_reserve(state_bytes(capacity), "group-by"):
                # no pass read the input yet: route the pages already begun
                return self._run_aggregate_partitioned(node, grace, stream, paged())
            resv["bytes"] = state_bytes(capacity)
        key_dtypes = tuple(t.dtype for t in key_types)
        try:
            while True:
                if cfg is not None:
                    state = hashagg.direct_groupby_init(cfg, key_dtypes, acc_specs,
                                                        device=self.device)
                    for cols, nulls, valid in outs:
                        inputs = [(None, None) if e is None else evaluate(e, cols, nulls)
                                  for e in acc_exprs]
                        state = hashagg.direct_groupby_insert(
                            state, cfg, tuple(cols[i] for i in node.keys), valid,
                            inputs, acc_kinds, tuple(nulls[i] for i in node.keys))
                    if not bool(self._host([state.overflow], "agg.direct.overflow")[0]):
                        break
                    # stale stats put keys out of range: hash mode
                    self.memory_pool.free(resv["bytes"], "group-by")
                    cfg, resv["bytes"] = None, 0
                    if not self.memory_pool.try_reserve(state_bytes(capacity), "group-by"):
                        return self._run_aggregate_partitioned(node, grace, stream)
                    resv["bytes"] = state_bytes(capacity)
                    outs = self._outs(stream)
                    continue
                state = hashagg.groupby_init(capacity, key_dtypes, acc_specs,
                                             device=self.device)
                state = self._run_hash_inserts(node, key_types, acc_exprs, acc_kinds,
                                               state, outs, state_bytes, resv)
                if not bool(self._host([state.overflow], "agg.hash.overflow")[0]):
                    break
                # growth stopped at the capacity or memory ceiling
                return self._run_aggregate_partitioned(node, grace, stream)
            return self._finalize_groups(node, stream, state)
        finally:
            self.memory_pool.free(resv["bytes"], "group-by")

    def _agg_compiled(self, node: P.Aggregate):
        """(stream, key_types, acc_specs, acc_exprs, acc_kinds, step) of a
        grouped aggregation: its compiled input, and ``step(state, page,
        aux)``, which runs one raw source page through the input's transform
        and inserts its live rows into hash-mode group-by state.  The
        executor's page loop and a fault-tolerant partial task
        (``exec/fte._partial_once``) take their aggregation from here."""
        stream = self._compile_stream(node.child)
        key_types = tuple(stream.schema.fields[i].type for i in node.keys)
        acc_specs, acc_exprs, acc_kinds = self._agg_accumulators(node)

        def step(state, page, aux, stream=stream, node=node, key_types=key_types,
                 acc_exprs=tuple(acc_exprs), acc_kinds=tuple(acc_kinds)):
            cols, nulls, valid = stream.transform(page.columns, page.null_masks,
                                                  page.valid_mask(), aux)
            inputs = [(None, None) if e is None else _broadcast(evaluate(e, cols, nulls), valid)
                      for e in acc_exprs]
            return hashagg.groupby_insert(state, tuple(cols[i] for i in node.keys), key_types,
                                          valid, inputs, list(acc_kinds),
                                          tuple(nulls[i] for i in node.keys))

        return stream, key_types, acc_specs, acc_exprs, acc_kinds, step

    def _agg_accumulators(self, node: P.Aggregate):
        """(acc_specs, acc_exprs, acc_kinds) of a grouped aggregation."""
        acc_specs, acc_exprs, acc_kinds = [], [], []
        for spec in node.aggs:
            for kind, dtype, init in _accumulators_for(spec):
                acc_specs.append((dtype, init))
                acc_exprs.append(_acc_input_expr(spec))
                acc_kinds.append(kind)
        return acc_specs, acc_exprs, acc_kinds

    def _run_streaming_aggregate(self, node, stream, key_types, acc_specs, acc_exprs,
                                 acc_kinds, capacity, outs, state_bytes):
        """Aggregation over clustered input (reference: the streaming
        aggregation over pre-grouped input).  Per page the live rows pack to
        the front in order (the compaction kernel), key changes mark
        segments, every accumulator reduces per segment, and the per-segment
        partial rows merge into a hash table with the merge kinds, which
        also joins groups that span pages.  A merge table past the capacity
        or memory ceiling Grace-partitions."""
        merge_kinds = [_MERGE_KIND[k] for k in acc_kinds]
        key_dtypes = tuple(t.dtype for t in key_types)
        capacity = ceil_pow2(capacity)
        grace = node.grace_parts or 4
        if not self.memory_pool.try_reserve(state_bytes(capacity), "group-by"):
            return self._run_aggregate_partitioned(node, grace, stream, outs)
        resv = state_bytes(capacity)
        try:
            while True:
                state = hashagg.groupby_init(capacity, key_dtypes, acc_specs,
                                             device=self.device)
                for cols, nulls, valid in outs:
                    kcols, knulls, accs, new = _segment_partials(
                        node, cols, nulls, valid, acc_exprs, acc_specs, acc_kinds)
                    state = hashagg.groupby_insert(state, kcols, key_types, new,
                                                   [(a, None) for a in accs],
                                                   merge_kinds, knulls)
                if not bool(self._host([state.overflow], "agg.stream.overflow")[0]):
                    return self._finalize_groups(node, stream, state)
                # the merge table overflowed: grow and stream again
                grown = ceil_pow2(capacity * 4)
                delta = state_bytes(grown) - resv
                if grown > MAX_GROUP_CAPACITY \
                        or not self.memory_pool.try_reserve(delta, "group-by"):
                    return self._run_aggregate_partitioned(node, grace, stream)
                resv += delta
                capacity = grown
                outs = self._outs(stream)
        finally:
            self.memory_pool.free(resv, "group-by")

    # -- Grace-partitioned aggregation ------------------------------------------
    def _run_aggregate_partitioned(self, node: P.Aggregate, parts: int, stream,
                                   outs=None):
        """Grace-partitioned aggregation over the tiered spill
        (``exec/spill.py``): one pass transforms the input and routes its
        rows by the hash of the group keys into per-partition tier buffers;
        the partitions then aggregate one at a time (reference:
        SpillableHashAggregationBuilder).  ``stream`` is the aggregation's
        compiled input; ``outs`` its transformed pages when no pass has read
        them yet (the memory gate refused the first table), else the input
        is read again from its source.  Unlike the reference, which reads it
        again in both cases, a source that is itself a spill pass (a
        partitioned join's probe) then runs once."""
        from ..ops.exchange import partition_ids
        from .spill import SpilledPartitions

        key_types = tuple(stream.schema.fields[i].type for i in node.keys)
        acc_specs, acc_exprs, acc_kinds = self._agg_accumulators(node)

        def route(cols, nulls):
            # NULL key lanes are made canonical before hashing, as the
            # insert does: the NULL group lands in one partition
            routed = tuple(cols[i] if nulls[i] is None
                           else torch.where(nulls[i], torch.zeros_like(cols[i]), cols[i])
                           for i in node.keys)
            return partition_ids(routed, parts)

        spill = SpilledPartitions(stream.schema, parts, self,
                                  memory_pool=self.memory_pool,
                                  buffer_pool=self.buffer_pool)
        if outs is None:
            outs = (stream.run(p) for p in stream.pages())
        try:
            return self._consume_partitioned_agg(node, stream, spill, parts, key_types,
                                                 acc_specs, acc_exprs, acc_kinds, route,
                                                 outs)
        finally:
            spill.close()

    def _consume_partitioned_agg(self, node, stream, spill, parts, key_types,
                                 acc_specs, acc_exprs, acc_kinds, route, outs):
        for cols, nulls, valid in outs:
            spill.add_page(cols, nulls, valid, route(cols, nulls))
        st = self._node_stats(node)
        st["spilled_bytes"] = spill.spilled_bytes
        st["spill_partitions"] = parts
        st["spill_tiers"] = dict(spill.tier_bytes)
        key_dtypes = tuple(t.dtype for t in key_types)
        pages_out, dicts = [], None
        for p in range(parts):
            # the spill pass counted this partition's rows exactly: seed its
            # table from them (groups <= rows; 2x for probe headroom); the
            # overflow loop covers the rest, MAX_GROUP_CAPACITY caps it
            capacity = min(MAX_GROUP_CAPACITY // 4,
                           ceil_pow2(max(2 * spill.rows[p], 1024)))
            while True:
                state = hashagg.groupby_init(capacity, key_dtypes, acc_specs,
                                             device=self.device)
                # a capacity retry replays from the spill tiers, never the
                # source; host and disk chunks stage through the prefetch
                # producer, device chunks are already on the device
                src = functools.partial(spill.partition_pages, p)
                if spill.needs_staging(p):
                    src = _prefetched_pages(src, to_device=True, owner=self)
                for page in src():
                    cols, nulls, valid = page.columns, page.null_masks, page.valid_mask()
                    inputs = [(None, None) if e is None else _broadcast(
                        evaluate(e, cols, nulls), valid) for e in acc_exprs]
                    state = hashagg.groupby_insert(
                        state, tuple(cols[i] for i in node.keys), key_types, valid,
                        inputs, acc_kinds, tuple(nulls[i] for i in node.keys))
                if not bool(self._host([state.overflow], "agg.partition.overflow")[0]):
                    break
                if capacity >= MAX_GROUP_CAPACITY:
                    if parts >= 1 << 16:
                        raise MemoryError(
                            f"aggregation exceeds {MAX_GROUP_CAPACITY} groups per "
                            f"partition even at {parts} partitions")
                    # a partition still passed the ceiling: free this spill
                    # first (the restart routes the whole input again), then
                    # run again with 4x the partitions
                    spill.close()
                    return self._run_aggregate_partitioned(node, parts * 4, stream)
                capacity *= 4
            page, dicts = self._finalize_groups(node, stream, state)
            pages_out.append(page)
            spill.release_partition(p)  # consumed: its host bytes and file go
        return _concat_pages(node.schema, pages_out, self._host), dicts

    def _run_global_aggregate(self, node: P.Aggregate):
        """Ungrouped aggregation: every page folds into one accumulator per
        aggregate by masked reductions; one read checks the exact-int64
        envelope of wide decimal sums.  The one-row result stays on the
        device."""
        stream = self._compile_stream(node.child)
        acc_specs, acc_exprs, acc_kinds = self._agg_accumulators(node)
        fused = self._run_global_scan_fused(node, stream, acc_specs, acc_exprs, acc_kinds)
        if fused is not None:
            return fused
        state = _global_init_state(acc_specs, self.device)
        for cols, nulls, valid in self._outs(stream):
            state = _global_agg_update(state, cols, nulls, valid, acc_exprs, acc_kinds)
        return self._finish_global(node, state)

    def _finish_global(self, node: P.Aggregate, state):
        """The one-row result of an ungrouped aggregation's accumulators."""
        accs = tuple(a.reshape(1) for a in state)
        fin_cols, fin_nulls, bad = _finalize_aggs_device(node.aggs, accs)
        if bool(self._host([bad], "agg.global.envelope")[0]):
            return self._finalize_exact(node, (), (), fin_cols, fin_nulls, accs, 1), \
                tuple(None for _ in node.aggs)
        return Page(node.schema, fin_cols, fin_nulls, None), tuple(None for _ in node.aggs)

    def _run_hash_inserts(self, node, key_types, acc_exprs, acc_kinds, state, outs,
                          state_bytes, resv):
        """Insert transformed pages into hash-mode group-by state, compacting
        live rows first when pages are sparse.  Live-row counts are read in
        chunks of four pages; a chunk that overflows the table is replayed
        against the pre-chunk state after a 4x rehash.  Pages claim slots in
        the state's table in place, so each chunk first keeps a snapshot of
        the state with its own copy of the table: one table copy per chunk."""
        staged: list = []

        def insert(state, keys, knulls, inputs, valid):
            return hashagg.groupby_insert(state, keys, key_types, valid, inputs,
                                          acc_kinds, knulls)

        def insert_chunk(state, counts):
            for (keys, knulls, inputs, valid, _), n in zip(staged, counts):
                if n == 0:
                    continue
                width = valid.shape[0]
                bucket = max(1 << max(n - 1, 1).bit_length(), 1024)
                if bucket * 2 >= width:
                    # dense page: compaction would not shrink it meaningfully
                    state = insert(state, keys, knulls, inputs, valid)
                    continue
                present = [v for v, _ in inputs if v is not None]
                packed, _ = compact_rows(
                    tuple(keys) + tuple(knulls) + tuple(present)
                    + tuple(nu for v, nu in inputs if v is not None), valid, bucket)
                nk, nv = len(keys), len(present)
                ckeys, cknulls = packed[:nk], packed[nk:2 * nk]
                rest_v = list(packed[2 * nk:2 * nk + nv])
                rest_n = list(packed[2 * nk + nv:])
                cinputs = [(None, None) if v is None else (rest_v.pop(0), rest_n.pop(0))
                           for v, _ in inputs]
                cvalid = torch.arange(bucket, device=valid.device) < n
                state = insert(state, ckeys, cknulls, cinputs, cvalid)
            return state

        def drain(state):
            if not staged:
                return state, False
            counts = [int(c) for c in self._host([st[-1] for st in staged],
                                                 site="agg.stream.counts")]
            # inserts update the table in place and leave the key captures
            # and accumulators of the state they were given untouched
            snapshot = dataclasses.replace(state, table=state.table.clone())
            capacity = state.capacity
            while True:
                state = insert_chunk(state, counts)
                if not bool(self._host([state.overflow], "agg.stream.overflow")[0]):
                    staged.clear()
                    return state, False
                grown = capacity * 4
                delta = state_bytes(grown) - state_bytes(capacity)
                if grown > MAX_GROUP_CAPACITY or not self.memory_pool.try_reserve(delta):
                    staged.clear()
                    return state, True  # ceiling: the caller raises
                resv["bytes"] += delta
                # replay from the pre-chunk state; rehash leaves it untouched,
                # so a further overflow replays from it again
                state = hashagg.rehash(snapshot, grown, tuple(acc_kinds))
                capacity = grown

        for cols, nulls, valid in outs:
            keys = tuple(cols[i] for i in node.keys)
            knulls = tuple(nulls[i] for i in node.keys)
            inputs = tuple((None, None) if e is None else _broadcast(
                evaluate(e, cols, nulls), valid) for e in acc_exprs)
            staged.append((keys, knulls, inputs, valid, torch.sum(valid, dtype=torch.int32)))
            if len(staged) >= 4:
                state, ceiling = drain(state)
                if ceiling:
                    return state
        state, _ = drain(state)
        return state

    def _finalize_groups(self, node: P.Aggregate, stream, state):
        """Pack the occupied groups on the device and finalize there; one read
        checks the exact-int64 envelope of wide decimal sums."""
        n_groups = int(self._host([hashagg.group_count(state)], "agg.groups.count")[0])
        bucket = max(1 << max(n_groups - 1, 1).bit_length(), 64)
        keys, key_nulls, accs = hashagg.compact_groups(state, bucket)
        dicts = tuple(stream.dicts[i] for i in node.keys) + tuple(None for _ in node.aggs)
        fin_cols, fin_nulls, bad = _finalize_aggs_device(node.aggs, tuple(accs))
        if bool(self._host([bad], "agg.finalize.envelope")[0]):
            return self._finalize_exact(node, keys, key_nulls, fin_cols, fin_nulls, accs,
                                        n_groups), dicts
        out_cols = tuple(k[:n_groups] for k in keys) + tuple(c[:n_groups] for c in fin_cols)
        out_nulls = tuple(kn[:n_groups] for kn in key_nulls) + tuple(
            None if fn is None else fn[:n_groups] for fn in fin_nulls)
        return Page(node.schema, out_cols, out_nulls, None), dicts

    def _finalize_exact(self, node, keys, key_nulls, fin_cols, fin_nulls, accs, n):
        """The host-exact finalization, once a wide decimal sum left the
        int64 envelope: one read of the device-finalized page and of the
        accumulators; each decimal sum and avg is recombined from its two
        limbs as exact python ints (an object column past int64, decoded
        through ``Decimal`` at the surface).  The page stays on the host."""
        parts = [list(keys), list(key_nulls), list(fin_cols), list(fin_nulls), list(accs)]
        flat = [None if a is None else a[:n] for part in parts for a in part]
        got = iter(self._host(flat, site="agg.finalize.exact"))
        keys, key_nulls, cols, nulls, accs = ([next(got) for _ in part] for part in parts)
        i = 0
        for j, spec in enumerate(node.aggs):
            width = len(_accumulators_for(spec))
            if _accumulators_for(spec)[0][0] == "sum_hi32":  # decimal sum or avg
                exact = [h * (1 << 32) + lo for h, lo in zip(accs[i].tolist(),
                                                           accs[i + 1].tolist())]
                if spec.kind == "avg":  # HALF_UP on the exact sum; fits the input type
                    exact = [_div_half_up(v, max(c, 1))
                             for v, c in zip(exact, accs[i + 2].tolist())]
                fits = all(_I64_MIN <= v <= _I64_MAX for v in exact)
                cols[j] = np.array(exact, dtype=np.int64 if fits else object)
            i += width
        nulls = [None if m is None or not m.any() else m for m in key_nulls + nulls]
        return Page(node.schema, tuple(keys + cols), tuple(nulls), None)

    # -- sort-based aggregation -----------------------------------------------
    def _run_sorted_aggregate(self, node: P.Aggregate):
        """approx_percentile (exact selection at round(p * (count - 1))),
        max_by / min_by, listagg, the bitwise aggregates and the aggregates
        whose results are arrays or maps (``_nested_agg``), by sorting.

        One key-major sort of the concatenated input gives the groups: their
        dense ids, sizes and starts stay on the device, and one read carries
        the live and group counts.  Each aggregate then sorts the rows by
        (group, value NULL, value), which orders every group's values in
        the same position range, and one read per aggregate carries its
        results (with the group keys, on the first).  The page returned
        lives on the host, as the reference's does."""
        for s_ in node.aggs:
            if s_.kind not in P.SORTED_AGG_KINDS:
                raise NotImplementedError(
                    "sort-based aggregates (approx_percentile/listagg/"
                    "max_by/array_agg/...) cannot mix with other "
                    "aggregates yet")
            if not isinstance(s_.arg, FieldRef):
                raise NotImplementedError(f"{s_.kind} argument must be a plain column")
        stream = self._compile_stream(node.child)
        page = self._concat_stream(stream, node.child)
        n = page.capacity

        def empty(rows):
            """No group, or (a global aggregate over no input) one NULL row."""
            cols = tuple(np.zeros((rows,), np.dtype(f.type.dtype)) for f in node.schema.fields)
            nulls = tuple(np.ones((1,), bool) if rows else None for _ in cols)
            return Page(node.schema, cols, nulls, None), tuple(None for _ in cols)

        if n == 0:
            return empty(0 if node.keys else 1)
        dev = page.columns[0].device
        valid = page.valid_mask()
        kcols = [page.columns[i] for i in node.keys]
        knulls = [page.null_masks[i] for i in node.keys]
        order, gid, count = _sorted_groups(kcols, knulls, valid)
        m, g = (int(x) for x in self._host([torch.sum(valid, dtype=torch.int64), count],
                                           site="agg.sorted.counts"))
        if not node.keys:
            g = 1 if m else 0
        if g == 0:
            return empty(0)
        gid = torch.clamp(gid, max=g)  # dead rows: the sink slot g
        sizes = torch.zeros((g + 1,), dtype=torch.int64, device=dev).index_add_(
            0, gid, valid.to(torch.int64))[:g]
        starts = torch.cumsum(sizes, 0) - sizes
        key_fetch = [k[order[starts]] for k in kcols] + \
            [kn[order[starts]] for kn in knulls if kn is not None]

        def group_sort(primary, pnull):
            """Row permutation by (group, value NULL, value), and each group's
            count of non-NULL values."""
            idx = _lexsort([_sort_key(primary), gid * 2 + pnull.to(torch.int64)], n, dev)
            live = (valid & ~pnull).to(torch.int64)
            cnt = torch.zeros((g + 1,), dtype=torch.int64, device=dev).index_add_(
                0, gid, live)[:g]
            return idx, cnt

        def read(arrays):
            """One read per aggregate; the first also carries the group keys."""
            extra = key_fetch if not agg_vals else []
            got = self._host(list(arrays) + extra, site="agg.sorted.fetch")
            if extra:
                rest = got[len(arrays):]
                out_keys.extend(rest[:len(kcols)])
                it = iter(rest[len(kcols):])
                out_knulls.extend(None if kn is None else next(it) for kn in knulls)
            return got[:len(arrays)]

        out_keys, out_knulls, agg_vals, agg_nulls, agg_dicts = [], [], [], [], []
        for s_ in node.aggs:
            vch = s_.arg.index
            v = page.columns[vch]
            vn = page.null_masks[vch]
            vnull = torch.zeros((n,), dtype=torch.bool, device=dev) if vn is None else vn
            d_out = None
            if s_.kind in ("approx_percentile", "max_by", "min_by"):
                rank = v
                vd = stream.dicts[vch]
                if s_.kind != "approx_percentile" and getattr(vd, "values", None) is not None:
                    # string ranking follows the values, not the dictionary ids
                    lut = device_array(_collation_rank_lut(vd), dev)
                    rank = lut[torch.clamp(v, 0, len(lut) - 1).to(torch.int64)]
                idx, cnt = group_sort(rank, vnull)
                last = torch.clamp(cnt - 1, min=0)
                if s_.kind == "approx_percentile":
                    off = torch.round(float(s_.param) * last.to(torch.float64)).to(torch.int64)
                    tgt = starts + torch.minimum(torch.clamp(off, min=0), last)
                    src, srcn = v, None
                else:
                    tgt = starts + last if s_.kind == "max_by" else starts
                    src, srcn = page.columns[int(s_.param)], page.null_masks[int(s_.param)]
                    d_out = stream.dicts[int(s_.param)]
                at = idx[torch.clamp(tgt, 0, n - 1)]
                got = read([src[at], cnt] + ([] if srcn is None else [srcn[at]]))
                vals, vnull_out = got[0], got[1] == 0
                if srcn is not None:
                    vnull_out = vnull_out | got[2]
            elif s_.kind == "listagg":
                vals, vnull_out, d_out = self._listagg(s_, page, stream.dicts, v, vnull,
                                                       group_sort, sizes, read)
            elif s_.kind in _ARRAY_AGG_KINDS:
                vals, vnull_out, d_out = self._nested_agg(s_, page, stream, vnull, gid, g,
                                                          group_sort, read)
            else:  # bitwise_and_agg, bitwise_or_agg, bitwise_xor_agg
                idx, _ = group_sort(v, vnull)
                sv, svn, sz = read([v[idx], vnull[idx], sizes])
                fold = {"bitwise_and_agg": np.bitwise_and, "bitwise_or_agg": np.bitwise_or,
                        "bitwise_xor_agg": np.bitwise_xor}[s_.kind]
                vals, vnull_out = np.zeros(g, np.int64), np.zeros(g, bool)
                for gi, (s0, e0) in enumerate(_segments(sz)):
                    vv = sv[s0:e0][~svn[s0:e0]]
                    if len(vv):
                        vals[gi] = fold.reduce(vv.astype(np.int64))
                    else:
                        vnull_out[gi] = True
            agg_vals.append(np.asarray(vals))
            agg_nulls.append(vnull_out if vnull_out.any() else None)
            agg_dicts.append(d_out)
        nulls = [None if kn is None or not kn.any() else kn for kn in out_knulls] + agg_nulls
        dicts = tuple(stream.dicts[i] for i in node.keys) + tuple(agg_dicts)
        return Page(node.schema, tuple(out_keys + agg_vals), tuple(nulls), None), dicts

    def _nested_agg(self, spec, page, stream, vnull, gid, g, group_sort, read):
        """array_agg(v), map_agg(k, v), histogram(v) and
        approx_most_frequent(b, v, c) (exact counts, as the reference's) over
        the group sort of ``v`` (of ``k`` for map_agg; NULLs skipped).
        Each group's heap entries are picked on the device: every live value
        for array_agg (in value order), the first row of each run of equal
        values otherwise (map_agg's first value per key, a histogram's count
        per value; approx_most_frequent keeps the ``b`` most frequent, by
        count, then value).  The compaction kernel packs them; one read sizes
        it and one carries the heaps and each group's entry count.  Spans
        and heaps are built on the host; a group without live values is
        NULL.  Returns (spans, NULL flags, ArrayData | MapData)."""
        n, kind = page.capacity, spec.kind
        ch = spec.arg.index
        v = page.columns[ch]
        dev = v.device
        idx, cnt = group_sort(v, vnull)
        sv, sg = v[idx], gid[idx]
        live = (gid < g) & ~vnull
        slive = live[idx]
        if kind == "array_agg":
            entry = slive
        else:  # the first row of each run of one value in a group
            same = (sg[1:] == sg[:-1]) & (sv[1:] == sv[:-1])
            entry = slive & ~torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev), same])
        pack = [sv]
        if kind in ("histogram", "approx_most_frequent"):
            run = torch.cumsum(entry.to(torch.int64), 0) - 1
            counts = torch.zeros((n + 1,), dtype=torch.int64, device=dev).index_add_(
                0, torch.where(slive, run, n), torch.ones_like(run))
            pack.append(counts[torch.clamp(run, min=0)])
        if kind == "approx_most_frequent":
            # per group, runs by (count desc, value asc): a stable sort of the
            # value-ordered runs by (group, -count); keep the first b
            grp = torch.where(entry, sg, g)
            order = _lexsort([-pack[1], grp], n, dev)
            sgrp = grp[order]
            per = torch.zeros((g + 1,), dtype=torch.int64, device=dev).index_add_(
                0, sgrp, torch.ones_like(sgrp))
            rank = torch.arange(n, device=dev) - (torch.cumsum(per, 0) - per)[sgrp]
            entry = (sgrp < g) & (rank < int(spec.param))
            sg, pack = sgrp, [p[order] for p in pack]
        if kind == "map_agg":
            vch = int(spec.param)
            pack.append(page.columns[vch][idx])
            if page.null_masks[vch] is not None:
                pack.append(page.null_masks[vch][idx])
        lens = torch.zeros((g + 1,), dtype=torch.int64, device=dev).index_add_(
            0, torch.where(entry, sg, g), torch.ones_like(sg))[:g]
        r = int(self._host([torch.sum(entry, dtype=torch.int64)], site="agg.sorted.size")[0])
        packed = compact_rows(tuple(pack), entry, r)[0] if r else [p[:0] for p in pack]
        got = read(list(packed) + [lens, cnt])
        heaps, lens_h, cnt_h = got[:-2], got[-2], got[-1]
        spans = pack_span(np.cumsum(lens_h) - lens_h, lens_h).astype(np.int64)
        max_len = int(lens_h.max()) if g else 0
        out_null = cnt_h == 0
        elem_t, d = stream.schema.fields[ch].type, stream.dicts[ch]
        if kind == "array_agg":
            data = ArrayData(heaps[0], elem_t, elem_dict=d, max_len=max_len)
        elif kind == "map_agg":
            vals = heaps[1]
            if len(heaps) > 2 and heaps[2].any():  # a NULL value decodes to None
                vals = vals.astype(object)
                vals[heaps[2]] = None
            data = MapData(heaps[0], vals, elem_t, stream.schema.fields[vch].type,
                           key_dict=d, value_dict=stream.dicts[vch], max_len=max_len)
        else:
            data = MapData(heaps[0], heaps[1], spec.arg.type, BIGINT, key_dict=d,
                           max_len=max_len)
        return spans, out_null, data

    def _listagg(self, spec, page, dicts, v, vnull, group_sort, sizes, read):
        """listagg(x, sep) WITHIN GROUP (ORDER BY o): the rows sorted by the
        order key inside each group, then each group's strings decoded and
        joined on the host into a new dictionary (one entry per group)."""
        from ..connectors.tpch import Dictionary

        sep, order_ch, asc = spec.param
        d = dicts[spec.arg.index]
        if d is None:
            raise NotImplementedError("listagg needs a dictionary-encoded string channel")
        okey = page.columns[order_ch] if order_ch is not None else v
        od = dicts[order_ch] if order_ch is not None else d
        if getattr(od, "values", None) is not None:
            lut = device_array(_collation_rank_lut(od), okey.device)
            okey = lut[torch.clamp(okey, 0, len(lut) - 1).to(torch.int64)]
        if not asc:
            okey = -okey if okey.is_floating_point() else ~okey
        idx, _ = group_sort(okey, vnull)
        sv, svn, sz = read([v[idx], vnull[idx], sizes])
        joined, out_null = [], np.zeros(len(sz), bool)
        for gi, (s0, e0) in enumerate(_segments(sz)):
            ids = sv[s0:e0][~svn[s0:e0]]
            out_null[gi] = len(ids) == 0
            joined.append(sep.join(str(x) for x in d.decode(ids)) if len(ids) else "")
        return (np.arange(len(sz), dtype=np.int32), out_null,
                Dictionary(values=np.array(joined, dtype=object)))

    # -- joins ----------------------------------------------------------------
    def _compile_join(self, node: P.Join) -> _Stream:
        if node.kind not in ("inner", "left", "semi", "anti", "mark"):
            raise _not_ported(f"{node.kind} join")
        # build tier: a structurally equal build fragment finished by any
        # executor of this pool checks out its page and table instead of
        # running the fragment and inserting its rows again
        bkey = self._build_cache_key(node)
        cached = None
        if bkey is not None:
            cached = self.buffer_pool.get_build(bkey)
            tracing.record_build_cache(
                hits=int(cached is not None), misses=int(cached is None),
                bytes_saved=cached["nbytes"] if cached is not None else 0)
        if cached is not None:
            build_page, build_dicts = cached["page"], cached["dicts"]
            build_wall = 0.0
        else:
            t0 = time.perf_counter()
            build_page, build_dicts = self._execute_to_page_streamed(node.right)
            build_wall = time.perf_counter() - t0
        # plan-history fact: the build side's live rows (kept on the device,
        # read with the other counts at collection) and wall; nothing else
        # records a streaming build side
        self._plan_facts[id(node.right)] = (node.right, {
            "build_rows": _live_rows(build_page), "wall_s": build_wall})
        probe_stream = self._compile_stream(node.left)
        build_key_types = tuple(node.right.schema.fields[i].type for i in node.right_keys)
        if node.kind in ("inner", "semi") and node.filter is None:
            # a connector index lookup first (the build keys' SET pushed to
            # the source); else dynamic filtering prunes probe splits outside
            # the build keys' domain
            ix = self._index_lookup_stream(probe_stream, node, build_page, build_dicts)
            pruned = None
            if ix is not None:
                probe_stream = ix
            else:
                pruned = self._dynamic_pruned_pages(probe_stream, node, build_page)
            if pruned is not None:
                pages_fn, kept = pruned
                repl = {"pages": pages_fn}
                if probe_stream.scan_info is not None:
                    repl["scan_info"] = dataclasses.replace(probe_stream.scan_info,
                                                            splits=list(kept))
                if probe_stream.traced_src is not None:
                    repl["traced_src"] = dataclasses.replace(probe_stream.traced_src,
                                                             splits=tuple(kept))
                probe_stream = dataclasses.replace(probe_stream, **repl)
        if not probe_stream.compacted and self._compactable_fraction(node.left):
            # probe cost scales with lanes: do not drag dead rows through the probe
            probe_stream = self._compacted_stream(probe_stream)
        # memory gate: build columns (+ compaction copies) and the 4x-pow2 table.
        # A build that does not fit Grace-partitions where the join's kind
        # allows (inner, left, semi on keys, no residual filter); the others
        # proceed unreserved, as the reference's do.  A build in the buffer pool is
        # held by the pool's reservation: a checked-out one reserves nothing
        # here (it fit when it was built), and a fresh one gives its
        # reservation back once the pool took it (_join_with_build), so no
        # build is ever counted twice
        reserved = 0
        if cached is None:
            need = _page_bytes(build_page) * 2 \
                + 12 * 4 * ceil_pow2(max(build_page.capacity, 16))
            if self.memory_pool.try_reserve(need, "join-build"):
                self._reserved.append(need)
                reserved = need
            elif node.kind in ("inner", "left", "semi") and node.left_keys \
                    and node.filter is None:
                parts, free = 2, max(self.memory_pool.free_bytes(), 1)
                while need // parts > free // 2 and parts < 64:
                    parts *= 2
                return self._compile_partitioned_local_join(
                    node, build_page, build_dicts, probe_stream, build_key_types, parts)
        return self._join_with_build(node, build_page, build_dicts, probe_stream,
                                     build_key_types, bkey, cached, reserved)

    def _join_with_build(self, node: P.Join, build_page, build_dicts, probe_stream,
                         build_key_types, cache_key=None, cached=None,
                         reserved: int = 0) -> _Stream:
        # "mark": the probe channels plus one boolean matched channel, no
        # lane filtering (EXISTS in expression position)
        semi = node.kind in ("semi", "anti", "mark")
        if cached is not None:
            # a build-tier hit: the null statistics, the direct span and the
            # table (or multi-match layout), with their host reads and
            # inserts, were made when the entry was stored
            null_stats, span = cached["null_stats"], cached["span"]
            table, mt = cached["table"], cached["multi"]
        else:
            null_stats = self._build_null_stats(build_page, node.right_keys)
            span = self._direct_join_span(build_page, node.right_keys, build_key_types)
            table = mt = None
            if node.filter is None and build_page.capacity > 0:
                table = self._build_join_table(build_page, node.right_keys,
                                               build_key_types, span)
            if table is None:
                mt = self._multi_join_table(node, build_page, build_key_types, span)
            if cache_key is not None and self._store_build(cache_key, {
                    "page": build_page, "dicts": build_dicts, "null_stats": null_stats,
                    "span": span, "table": table, "multi": mt}, node.right) and reserved:
                self._reserved.remove(reserved)
                self.memory_pool.free(reserved, "join-build")
        if table is None:
            # an empty build, duplicate build keys or a residual filter
            return self._compile_multi_join(node, mt, build_dicts, probe_stream,
                                            build_key_types, null_stats)

        def transform(cols, nulls, valid, aux, up=probe_stream, node=node):
            up_aux, table = aux
            cols, nulls, valid = up.transform(cols, nulls, valid, up_aux)
            keys = tuple(cols[i] for i in node.left_keys)
            if isinstance(table, DirectJoinTable):
                row_ids, matched = direct_probe(table, keys[0], valid)
            else:
                row_ids, matched = probe(table, keys, build_key_types, valid)
            for i in node.left_keys:  # NULL keys never match
                if nulls[i] is not None:
                    matched = matched & ~nulls[i]
            if node.kind in ("inner", "semi"):
                valid = valid & matched
            elif node.kind == "anti":
                valid = _null_aware_anti(node, valid & ~matched, nulls, *null_stats)
            if node.kind == "mark":
                return tuple(cols) + (matched & valid,), tuple(nulls) + (None,), valid
            if semi:
                return cols, nulls, valid
            bcols, bnulls = _gather_build(table, row_ids, matched, node.kind)
            return tuple(cols) + bcols, tuple(nulls) + bnulls, valid

        si = None
        if probe_stream.scan_info is not None:
            n_build = 1 if node.kind == "mark" else 0 if semi else len(build_page.columns)
            si = dataclasses.replace(
                probe_stream.scan_info,
                columns=tuple(probe_stream.scan_info.columns) + (None,) * n_build)
        return _Stream(node.schema, _join_dicts(node, probe_stream, build_dicts),
                       probe_stream.pages, transform, si,
                       aux=(probe_stream.aux, table), compacted=probe_stream.compacted,
                       traced_src=probe_stream.traced_src)

    def _compile_partitioned_local_join(self, node: P.Join, build_page, build_dicts,
                                        probe_stream, build_key_types,
                                        parts: int) -> _Stream:
        """Grace-partitioned join over the tiered spill (``exec/spill.py``):
        both sides route by the hash of the join keys, the build page at
        once (its device columns free once the caller lets go) and the probe in one
        transformed pass per execution, then each partition joins on its
        own.  A probe row lands in exactly one partition, so inner, left and
        semi joins hold partition by partition (reference:
        PartitionedConsumption.java over FileSingleStreamSpiller).

        The build spill keeps its host chunks out of the executor's pool, as
        the reference's does (a reservation there must mean live per-query
        state), and honours the host watermark.  The reference keeps it with
        the compiled stream across executions; the port compiles no stream,
        so it closes with the query (``close_producers``)."""
        from ..ops.exchange import partition_ids
        from .spill import SpilledPartitions

        def route(cols, nulls, keys):
            # NULL key lanes canonical: they never match, and land in one part
            return partition_ids(tuple(
                cols[i] if nulls[i] is None
                else torch.where(nulls[i], torch.zeros_like(cols[i]), cols[i])
                for i in keys), parts)

        build_spill = SpilledPartitions(build_page.schema, parts, self, tag="spill-build")
        build_spill.add_page(build_page.columns, build_page.null_masks,
                             build_page.valid_mask(),
                             route(build_page.columns, build_page.null_masks,
                                   node.right_keys))

        def pages(self=self, node=node):
            probe_spill = SpilledPartitions(probe_stream.schema, parts, self,
                                            memory_pool=self.memory_pool,
                                            buffer_pool=self.buffer_pool)
            try:
                for page in probe_stream.pages():
                    cols, nulls, valid = probe_stream.run(page)
                    probe_spill.add_page(cols, nulls, valid,
                                         route(cols, nulls, node.left_keys))
                st = self._node_stats(node)
                st["spilled_bytes"] = build_spill.spilled_bytes + probe_spill.spilled_bytes
                st["spill_partitions"] = parts
                st["spill_tiers"] = {t: build_spill.tier_bytes[t] + probe_spill.tier_bytes[t]
                                     for t in probe_spill.tier_bytes}
                for p in range(parts):
                    src = functools.partial(probe_spill.partition_pages, p)
                    if probe_spill.needs_staging(p):
                        src = _prefetched_pages(src, to_device=True, owner=self)
                    sub_stream = _Stream(probe_stream.schema, probe_stream.dicts, src,
                                         _identity)
                    sub = self._join_with_build(node, build_spill.partition_page(p),
                                                build_dicts, sub_stream, build_key_types)
                    for page in sub.pages():
                        yield Page(node.schema, *sub.run(page))
                    probe_spill.release_partition(p)
            finally:
                probe_spill.close()

        return _Stream(node.schema, _join_dicts(node, probe_stream, build_dicts), pages,
                       _identity)

    def _multi_join_table(self, node: P.Join, build_page, build_key_types, span):
        """The multi-match layout of a build: rows grouped by slot, direct or
        hashed (an empty build gets one never-matching dummy row, which keeps
        the gathers defined)."""
        if build_page.capacity == 0:
            cols = tuple(torch.zeros((1,), dtype=torch_dtype(f.type), device=self.device)
                         for f in node.right.schema.fields)
            build_page = Page(node.right.schema, cols, tuple(None for _ in cols),
                              torch.zeros((1,), dtype=torch.bool, device=self.device))
        if span is not None:
            return direct_multi_build(span[0], span[1], build_page, node.right_keys[0])
        capacity = max(1 << max(build_page.capacity - 1, 1).bit_length(), 16) * 4
        return multi_build(capacity, build_page, node.right_keys, build_key_types,
                           lambda arrays: self._host(arrays, site="join.multi.overflow"))

    def _compile_multi_join(self, node: P.Join, mt, build_dicts, probe_stream,
                            build_key_types, null_stats) -> _Stream:
        """Join with duplicate build keys and/or a residual match filter over
        the multi-match layout ``mt``: a count step per probe page, and an
        expand step that emits one lane per candidate match.  The expanded
        page's size is data-dependent: one host read per page sizes it to a
        power of two."""
        semi = node.kind in ("semi", "anti", "mark")

        def count_step(page):
            cols, nulls, valid = probe_stream.run(page)
            keys = tuple(cols[i] for i in node.left_keys)
            kvalid = valid
            for i in node.left_keys:
                if nulls[i] is not None:
                    kvalid = kvalid & ~nulls[i]
            if isinstance(mt, DirectMultiJoinTable):
                slot, matched = direct_probe_slots(mt, keys[0], kvalid)
            else:
                slot, matched = probe_slots(mt.table, keys, build_key_types, kvalid)
            matched = matched & kvalid
            cnt = torch.where(matched, mt.counts[slot.to(torch.int64)], 0)
            out_cnt = torch.where(valid, torch.clamp(cnt, min=1), 0) \
                if node.kind == "left" else cnt
            incl = torch.cumsum(out_cnt, 0, dtype=torch.int32)
            return cols, nulls, valid, slot, matched, cnt, out_cnt, incl

        def expand_step(size, cols, nulls, valid, slot, matched, cnt, out_cnt, incl):
            pidx, k, in_range = expand_counts(incl, out_cnt, size)
            pl = pidx.to(torch.int64)
            is_match = matched[pl] & (k < cnt[pl]) & in_range
            pos = torch.clamp(mt.starts[slot[pl].to(torch.int64)] + k, 0,
                              mt.order.shape[0] - 1)
            brow = torch.where(is_match, mt.order[pos.to(torch.int64)], 0).to(torch.int64)
            ocols = tuple(c[pl] for c in cols) + tuple(c[brow] for c in mt.build_columns)
            onulls = tuple(None if n is None else n[pl] for n in nulls) + tuple(
                None if n is None else n[brow] for n in mt.build_null_masks)
            passed = evaluate_predicate(node.filter, ocols, onulls, is_match) \
                if node.filter is not None else is_match
            if semi or node.kind == "left":
                # per probe row: did any candidate pass?  Out-of-range lanes
                # have passed = False, so they mark nothing
                any_pass = torch.zeros(valid.shape, dtype=torch.int32,
                                       device=valid.device).scatter_reduce_(
                    0, pl, passed.to(torch.int32), "amax", include_self=True).to(torch.bool)
                if semi:
                    return any_pass
                keep = passed | ((k == 0) & ~any_pass[pl] & in_range & valid[pl])
                onulls = onulls[:len(cols)] + tuple(
                    (torch.zeros_like(passed) if n is None else n) | ~passed
                    for n in onulls[len(cols):])
                return ocols, onulls, keep
            return ocols, onulls, passed  # inner

        def pages():
            for page in probe_stream.pages():
                cols, nulls, valid, slot, matched, cnt, out_cnt, incl = count_step(page)
                if semi and node.filter is None:
                    mark = matched
                elif incl.shape[0] == 0:
                    continue
                else:
                    total = int(self._host([incl[-1]], site="join.multi.total")[0])
                    size = max(1 << max(total - 1, 1).bit_length(), 1024)
                    out = expand_step(size, cols, nulls, valid, slot, matched, cnt,
                                      out_cnt, incl)
                    if not semi:
                        yield Page(node.schema, *out)
                        continue
                    mark = out
                if node.kind == "mark":
                    yield Page(node.schema, tuple(cols) + (mark & valid,),
                               tuple(nulls) + (None,), valid)
                    continue
                v = valid & mark if node.kind == "semi" \
                    else _null_aware_anti(node, valid & ~mark, nulls, *null_stats)
                yield Page(probe_stream.schema, cols, nulls, v)

        return _Stream(node.schema, _join_dicts(node, probe_stream, build_dicts), pages,
                       _identity)

    def _build_null_stats(self, build_page: Page, key_channels):
        """(build has a NULL key, build is non-empty) for null-aware anti
        joins, in one read."""
        if build_page.capacity == 0:
            return False, False
        valid = build_page.valid_mask()
        stats = [torch.any(valid)]
        for ch in key_channels:
            nm = build_page.null_masks[ch]
            if nm is not None:
                stats.append(torch.any(nm & valid))
        got = self._host(stats, site="join.build.nulls")
        return any(bool(x) for x in got[1:]), bool(got[0])

    def _execute_to_page_streamed(self, node):
        """Materialize a sub-plan into one device page (join build side,
        window input)."""
        if self._overrides and id(node) in self._overrides:
            page, dicts = self._overrides[id(node)]
            return self._device_page(page), dicts
        if isinstance(node, _BLOCKING_NODES):
            page, dicts = self._execute_to_page(node)
            return self._device_page(page), dicts
        stream = self._compile_stream(node)
        return self._concat_stream(stream, node), stream.dicts

    def _device_page(self, page: Page) -> Page:
        """A page whose columns were pulled to the host (sort, TopN, limit,
        sort-based or exact aggregation) back on the device, every row live.
        Exact wide-decimal (object) columns stay on the host."""
        if all(isinstance(c, torch.Tensor) for c in page.columns):
            return page
        cols = tuple(c if isinstance(c, torch.Tensor) or np.asarray(c).dtype == object
                     else self._to_device(c, torch_dtype(f.type))
                     for c, f in zip(page.columns, page.schema.fields))
        nulls = tuple(None if m is None else m if isinstance(m, torch.Tensor)
                      else self._to_device(m) for m in page.null_masks)
        valid = None
        if any(isinstance(c, np.ndarray) for c in cols):  # the row mask stays on the device
            valid = torch.ones((page.capacity,), dtype=torch.bool, device=self.device)
        return Page(page.schema, cols, nulls, valid)

    # -- window, limit, values -------------------------------------------------
    def _run_window(self, node: P.Window):
        """Blocking window evaluation: materialize the input, then sort,
        segmented scans and a scatter back (``_window_kernel``)."""
        page, dicts = self._execute_to_page_streamed(node.child)
        spec_dicts = _window_spec_dicts(node.specs, dicts)
        if page.capacity == 0:
            cols = tuple(page.columns) + tuple(
                torch.zeros((0,), dtype=torch_dtype(s.type), device=self.device)
                for s in node.specs)
            return (Page(node.schema, cols,
                         tuple(page.null_masks) + tuple(None for _ in node.specs), None),
                    tuple(dicts) + spec_dicts)
        out_cols, out_nulls = _window_kernel(node.specs, page.columns, page.null_masks,
                                             page.valid)
        return (Page(node.schema, tuple(page.columns) + out_cols,
                     tuple(page.null_masks) + out_nulls, page.valid),
                tuple(dicts) + spec_dicts)

    # -- UNNEST and MATCH_RECOGNIZE -------------------------------------------
    def _run_unnest(self, node: P.Unnest, child: Page, cdicts):
        """UNNEST (reference: operator/unnest/UnnestOperator.java) as the
        searchsorted expansion map of ``ops/arrays.unnest_indices``, the
        multi-match join's shape: parallel arrays zip by position and the
        shorter ones pad with NULL; replicated channels repeat per element.
        One read of the total sizes the output page (a power of two, at
        least 16); the element heaps come from the query's device copies."""
        child = self._device_page(child)
        if child.capacity == 0:
            # one dead row keeps the gathers defined (zero rows out)
            child = Page(child.schema,
                         tuple(torch.zeros((1,), dtype=c.dtype, device=self.device)
                               for c in child.columns),
                         tuple(None for _ in child.columns),
                         torch.zeros((1,), dtype=torch.bool, device=self.device))
        valid = child.valid_mask()
        spans = [child.columns[ch] for ch in node.unnest_channels]
        lens, per_ch = None, []
        for sp, nm in zip(spans, (child.null_masks[ch] for ch in node.unnest_channels)):
            ln = span_len(sp)
            if nm is not None:
                ln = torch.where(nm, torch.zeros_like(ln), ln)
            ln = torch.where(valid, ln, torch.zeros_like(ln))
            per_ch.append(ln)
            lens = ln if lens is None else torch.maximum(lens, ln)
        total = int(self._host([torch.sum(lens)], site="unnest.total")[0])
        cap = max(1 << max(total - 1, 1).bit_length(), 16)
        row, ordinal, in_range = unnest_indices(lens, cap)
        row = row.to(torch.int64)
        cols, nulls, dicts = [], [], []
        for ch in node.replicate:
            cols.append(child.columns[ch][row])
            nm = child.null_masks[ch]
            nulls.append(None if nm is None else nm[row])
            dicts.append(cdicts[ch] if cdicts and ch < len(cdicts) else None)
        for sp, ln, data in zip(spans, per_ch, node.array_datas):
            heap = device_array(np.asarray(data.values), self.device)
            if heap.shape[0]:
                pos = torch.clamp(span_start(sp)[row] + ordinal, 0, heap.shape[0] - 1)
                cols.append(heap[pos])
            else:
                cols.append(torch.zeros((cap,), dtype=heap.dtype, device=self.device))
            nulls.append(ordinal >= ln[row])  # zipped shorter arrays pad with NULL
            dicts.append(data.elem_dict)
        if node.ordinality:
            cols.append((ordinal + 1).to(torch.int64))
            nulls.append(None)
            dicts.append(None)
        return Page(node.schema, tuple(cols), tuple(nulls), in_range), tuple(dicts)

    def _run_match_recognize(self, node: P.MatchRecognize, child: Page, cdicts):
        """Row-pattern matching over sorted partitions (reference:
        operator/window/matcher/, and the reference engine's subset: linear
        patterns with ?/*/+, alternation groups, DEFINE with PREV/NEXT,
        FIRST/LAST measures, ONE or ALL ROWS PER MATCH, AFTER MATCH SKIP PAST
        LAST ROW, empty matches skipped).

        On the device: the sort by (partition, order) keys, partition
        starts, the navigation channels shifted inside each partition and
        one condition vector per DEFINE variable.  ONE ROW PER MATCH takes
        ``ops/matcher.vector_match`` where its gate admits the pattern: the
        match geometry for every start in one device pass and one read; the
        host walks the chain of matches (non-overlapping, skip past last
        row) and the measure rows are gathered on the device.  ALL ROWS PER
        MATCH and refused patterns read the sorted page and run the host
        backtracker."""
        from ..ops.matcher import vector_match

        keys = tuple(P.SortKey(ch, True, False) for ch in node.partition) + tuple(node.order)
        page = self._sorted_device_page(child, keys, cdicts)
        n = page.capacity
        cols, nulls = list(page.columns), list(page.null_masks)
        dev = self.device
        new_part = torch.zeros((n,), dtype=torch.bool, device=dev)
        new_part[:1] = True
        for ch in node.partition:
            c, nm = cols[ch], nulls[ch]
            diff = c[1:] != c[:-1]
            if nm is not None:
                # NULL keys form one partition; their fill values never compare
                diff = (diff & ~(nm[1:] | nm[:-1])) | (nm[1:] != nm[:-1])
            new_part[1:] |= diff
        part_id = torch.cumsum(new_part.to(torch.int64), 0)
        ext_cols, ext_nulls = list(cols), list(nulls)
        for ch, off in node.nav:  # off < 0: PREV, > 0: NEXT; NULL across edges
            src = torch.arange(n, device=dev) + off
            ok = (src >= 0) & (src < n)
            safe = torch.clamp(src, 0, max(n - 1, 0))
            if n:
                ok = ok & (part_id[safe] == part_id)
            nm = nulls[ch]
            ext_cols.append(cols[ch][safe])
            ext_nulls.append((torch.zeros((n,), dtype=torch.bool, device=dev) if nm is None
                              else nm[safe]) | ~ok)
        defined = dict(node.defines)
        conds = {}
        for el, _ in node.pattern:
            for var in (el if isinstance(el, tuple) else (el,)):
                e = defined.get(var)
                if e is None:  # an undefined variable matches every row
                    conds[var] = torch.ones((n,), dtype=torch.bool, device=dev)
                    continue
                v, nu = evaluate(e, ext_cols, ext_nulls)
                v = v.expand((n,))
                conds[var] = v if nu is None else (v & ~nu.expand((n,)))
        all_rows = getattr(node, "all_rows", False)
        vm = None
        if not all_rows:
            measure_vars = {var for _, var, _, _ in node.measures if var is not None}
            vm = vector_match(node.pattern, conds, new_part, measure_vars,
                              host=lambda arrays: self._host(arrays, site="mr.vector"))
        if vm is not None:
            out_cols, out_nulls = self._vector_matches(node, vm, cols, nulls, n)
        else:
            out_cols, out_nulls = self._backtrack_matches(node, conds, new_part, cols, nulls, n)
        measure_dicts = tuple(cdicts[ch] if cdicts and ch < len(cdicts) else None
                              for _, _, ch, _ in node.measures)
        lead = range(len(cols)) if all_rows else node.partition
        dicts = tuple(cdicts[ch] if cdicts and ch < len(cdicts) else None
                      for ch in lead) + measure_dicts
        return Page(node.schema, tuple(out_cols), tuple(out_nulls), None), dicts

    def _vector_matches(self, node, vm, cols, nulls, n):
        """ONE ROW PER MATCH from the vectorized geometry: the chain of match
        starts (the next usable start, then past the match's last row) on the
        host, each measure's row by numpy, the values gathered on the
        device."""
        nxt, end = vm.nxt.tolist(), vm.end.tolist()
        starts, i = [], 0
        while True:
            i = nxt[i]
            if i >= n:
                break
            starts.append(i)
            i = end[i]
        st = np.asarray(starts, np.int64)
        stop = vm.end[st].astype(np.int64) if len(st) else st
        picks = [(st, None, ch) for ch in node.partition]
        for kind, var, ch, _ in node.measures:
            if kind == "col":
                picks.append((stop - 1, None, ch))
            elif var is not None:
                k = vm.var_element[var]
                lo, hi = vm.pos[k][st].astype(np.int64), vm.pos[k + 1][st].astype(np.int64)
                picks.append((lo if kind == "first" else hi - 1, hi <= lo, ch))
            else:
                picks.append((st if kind == "first" else stop - 1, None, ch))
        out_cols, out_nulls = [], []
        for (rows, absent, ch), f in zip(picks, node.schema.fields):
            rows_d = self._to_device(np.maximum(rows, 0))
            out_cols.append(cols[ch][rows_d].to(torch_dtype(f.type)))
            nm = None if nulls[ch] is None else nulls[ch][rows_d]
            if absent is not None and absent.any():
                a = self._to_device(absent)
                nm = a if nm is None else (nm | a)
            out_nulls.append(nm)
        return out_cols, out_nulls

    def _backtrack_matches(self, node, conds, new_part, cols, nulls, n):
        """The reference's host matcher: greedy with backtracking over the
        condition vectors (regex semantics; alternation prefers its leftmost
        variable), for ALL ROWS PER MATCH (RUNNING measures: each row sees
        the match up to itself) and the patterns ``vector_match`` refuses.
        One read carries the conditions and the sorted page."""
        names = list(conds)
        nc = len(cols)
        got = self._host([conds[v] for v in names] + [new_part] + cols
                         + [m for m in nulls if m is not None], site="mr.backtrack")
        cond = dict(zip(names, (g.astype(bool) for g in got[:len(names)])))
        new_part = got[len(names)]
        hcols = got[len(names) + 1:len(names) + 1 + nc]
        it = iter(got[len(names) + 1 + nc:])
        hnulls = [None if m is None else next(it) for m in nulls]
        all_rows = getattr(node, "all_rows", False)

        def elem_conds(el):
            if not isinstance(el, tuple):
                return cond[el], None
            ok = np.zeros(n, bool)
            who = np.empty(n, object)
            for v in reversed(el):
                who[cond[v]] = v
                ok |= cond[v]
            return ok, who

        pat = [elem_conds(el) + (q, el) for el, q in node.pattern]

        def find_match(start, end):
            """(stop, [(row, var), ...]) or None."""
            def rec(i, pi):
                if pi == len(pat):
                    return i, []
                ok, who, q, el = pat[pi]

                def tag(k):
                    return who[k] if who is not None else el

                if q is None:
                    if i < end and ok[i]:
                        r = rec(i + 1, pi + 1)
                        if r is not None:
                            return r[0], [(i, tag(i))] + r[1]
                    return None
                if q == "?":
                    if i < end and ok[i]:
                        r = rec(i + 1, pi + 1)
                        if r is not None:
                            return r[0], [(i, tag(i))] + r[1]
                    return rec(i, pi + 1)
                j = i
                while j < end and ok[j]:
                    j += 1
                lo = i + (1 if q == "+" else 0)
                while j >= lo:
                    r = rec(j, pi + 1)
                    if r is not None:
                        return r[0], [(k, tag(k)) for k in range(i, j)] + r[1]
                    j -= 1
                return None

            return rec(start, 0)

        def value(ch, row):
            nm = hnulls[ch]
            return None if (nm is not None and nm[row]) else hcols[ch][row]

        bounds = list(np.flatnonzero(new_part)) + [n]
        out_rows: list = []
        for pi in range(len(bounds) - 1):
            s, e = int(bounds[pi]), int(bounds[pi + 1])
            i = s
            while i < e:
                m = find_match(i, e)
                if m is None or m[0] == i:  # no match, or an empty one: advance
                    i += 1
                    continue
                stop, assign = m
                by_var: dict = {}
                for row, var in assign:
                    by_var.setdefault(var, []).append(row)
                if all_rows:
                    for r, _ in assign:
                        vals_r = []
                        for kind, var, ch, _ in node.measures:
                            if kind == "col":
                                row = r
                            elif var is not None:
                                rows_v = [x for x in by_var.get(var, ()) if x <= r]
                                if not rows_v:
                                    vals_r.append(None)
                                    continue
                                row = rows_v[0] if kind == "first" else rows_v[-1]
                            else:
                                row = i if kind == "first" else r
                            vals_r.append(value(ch, row))
                        out_rows.append(tuple(value(ch, r) for ch in range(nc))
                                        + tuple(vals_r))
                else:
                    vals = []
                    for kind, var, ch, _ in node.measures:
                        if kind == "col":
                            row = stop - 1
                        elif var is not None:
                            rows_v = by_var.get(var)
                            if not rows_v:
                                vals.append(None)
                                continue
                            row = rows_v[0] if kind == "first" else rows_v[-1]
                        else:
                            row = i if kind == "first" else stop - 1
                        vals.append(value(ch, row))
                    out_rows.append(tuple(value(ch, i) for ch in node.partition)
                                    + tuple(vals))
                i = stop
        out_cols, out_nulls = [], []
        for j, f in enumerate(node.schema.fields):
            arr = np.zeros(len(out_rows), np.dtype(f.type.dtype))
            nm = np.zeros(len(out_rows), bool)
            for r, row in enumerate(out_rows):
                if row[j] is None:
                    nm[r] = True
                else:
                    arr[r] = row[j]
            out_cols.append(self._to_device(arr))
            out_nulls.append(self._to_device(nm) if nm.any() else None)
        return out_cols, out_nulls

    def _param_pruned_source(self, up: _Stream, pred, si=None):
        """Page source with bind-time split pruning for a predicate over
        parameters, or None where it does not apply.  Per execution, each
        binding's host values replace its parameters in the predicate's
        conjuncts (constant casts fold), and the kept splits, in split
        order, run through ``_scan_pages_source``, so each binding keys its
        own page-tier entry.  A NULL binding or a floating column never
        prunes.  In a fused batch the scan reads the union of the members'
        kept splits.  ``si``: the statically pruned scan info, if any."""
        if si is None:
            si = up.scan_info
        if si is None or not si.replayable or not hasattr(si.conn, "split_range"):
            return None
        from ..sql import ir as _ir

        def has_params(e) -> bool:
            if isinstance(e, _ir.Parameter):
                return True
            if isinstance(e, _ir.Call):
                return any(has_params(a) for a in e.args)
            return False

        if pred is None or not has_params(pred):
            return None
        from ..sql.analyzer import _coerce
        from ..sql.domain_translator import (domain_to_split_pruner, extract_domains,
                                             split_conjuncts)

        class _NullParam(Exception):
            pass

        def subst(e, host):
            """Parameter -> Constant(bound value); constant casts fold so the
            domain translator sees the bare Constant it matches."""
            if isinstance(e, _ir.Parameter):
                v, isnull = host[e.slot]
                if isnull:
                    raise _NullParam()  # NULL never prunes
                return _ir.Constant(v.item() if hasattr(v, "item") else v, e.type)
            if isinstance(e, _ir.Call):
                args = tuple(subst(a, host) for a in e.args)
                if e.op == "cast" and len(args) == 1 \
                        and isinstance(args[0], _ir.Constant) \
                        and not isinstance(args[0].value, np.ndarray) \
                        and args[0].value is not None:
                    folded = _coerce(args[0], e.type)
                    if isinstance(folded, _ir.Constant):
                        return folded
                return dataclasses.replace(e, args=args)
            return e

        def kept_idx_for(host):
            """Indices into si.splits one binding keeps, in split order."""
            kept = list(range(len(si.splits)))
            resolved = []
            for c in split_conjuncts(pred):
                try:
                    resolved.append(subst(c, host))
                except (_NullParam, IndexError):
                    continue  # this conjunct cannot prune; the filter applies
            if resolved:
                td = extract_domains(resolved).tuple_domain
                if td.is_none:
                    kept = []
                elif not td.is_all:
                    by_col: dict = {}
                    for ch, dom in td.domains.items():
                        col = si.columns[ch] if ch < len(si.columns) else None
                        if col is not None and not up.schema.fields[ch].type.is_floating:
                            by_col[col] = dom.intersect(by_col[col]) if col in by_col else dom
                    if by_col:
                        keep = domain_to_split_pruner(by_col, si.conn)
                        kept = [i for i, sp in enumerate(si.splits) if keep(sp)]
            return kept

        def pages(self=self):
            batch = _current_batch_host_params()
            if batch:
                # one scan over the union feeds every lane: rows of a split
                # one member pruned fail that member's own predicate in its
                # lane.  Where the members keep different splits, each split
                # is read through its own page-tier entry, the one a binding
                # that keeps only it stores, so a window's union (which
                # rarely repeats) neither misses those entries nor stores
                # another copy of their rows
                lists = [kept_idx_for(host) for host in batch]
                union = sorted(set().union(*lists))
                parts = [union] if all(lst == lists[0] for lst in lists) \
                    else [[i] for i in union]
            else:
                parts = [kept_idx_for(_current_host_params())]
            for part in parts:
                yield from self._scan_pages_source(si.conn, si.catalog, si.table,
                                                   [si.splits[i] for i in part],
                                                   si.scan_columns)()

        return pages

    def _limited_stream_page(self, node: P.Limit):
        """LIMIT over a streaming child: pull pages only until ``count`` live
        rows exist, then stop the source.  One read per page counts its live
        rows; each part's rows pack through the compaction kernel."""
        stream = self._compile_stream(node.child)
        nc = len(stream.schema.fields)
        parts, total = [], 0
        for page in stream.pages():
            cols, nulls, valid = stream.run(page)
            n = int(self._host([torch.sum(valid, dtype=torch.int32)], site="limit.count")[0])
            if n == 0:
                continue
            n = min(n, node.count - total)
            bucket = max(1 << max(n - 1, 1).bit_length(), 1024)
            packed, _ = compact_rows(tuple(cols) + tuple(nulls), valid,
                                     min(bucket, valid.shape[0]))
            parts.append((packed[:nc], packed[nc:], n))
            total += n
            if total >= node.count:
                break
        if not parts:
            cols = tuple(torch.zeros((0,), dtype=torch_dtype(f.type), device=self.device)
                         for f in stream.schema.fields)
            return Page(stream.schema, cols, tuple(None for _ in cols), None), stream.dicts
        cols = tuple(torch.cat([c[ci][:n] for c, _, n in parts]) for ci in range(nc))
        nulls = []
        for ci in range(nc):
            if all(nm[ci] is None for _, nm, _ in parts):
                nulls.append(None)
            else:
                nulls.append(torch.cat([
                    torch.zeros((n,), dtype=torch.bool, device=self.device)
                    if nm[ci] is None else nm[ci][:n] for _, nm, n in parts]))
        return Page(stream.schema, cols, tuple(nulls), None), stream.dicts

    def _limit_page(self, page: Page, count: int) -> Page:
        """The first ``count`` live rows of a blocking child's page, on the
        host."""
        if all(isinstance(c, torch.Tensor) for c in page.columns):
            valid, pcols, pnulls = self._host_page(page, site="limit.page")
        else:  # already pulled (sort, TopN): every row live
            pcols, pnulls = page.columns, page.null_masks
            valid = np.ones((len(pcols[0]) if pcols else 0,), bool)
        cols = tuple(np.asarray(c)[valid][:count] for c in pcols)
        nulls = tuple(None if m is None else np.asarray(m)[valid][:count] for m in pnulls)
        return Page(page.schema, cols, nulls, None)

    def _values_page(self, node: P.Values) -> Page:
        cols = tuple(self._to_device(np.array([r[ci] for r in node.rows]), torch_dtype(f.type))
                     for ci, f in enumerate(node.schema.fields))
        return Page(node.schema, cols, tuple(None for _ in cols), None)

    def _direct_join_span(self, build_page: Page, key_channels, key_types):
        """(lo, span) when the build keys form one dense integer range small
        enough for direct addressing, else None."""
        if len(key_channels) != 1 or key_types[0].is_floating \
                or build_page.capacity == 0:
            return None
        ch = key_channels[0]
        valid = build_page.valid_mask()
        nm = build_page.null_masks[ch]
        if nm is not None:
            valid = valid & ~nm
        k64 = build_page.columns[ch].to(torch.int64)
        got = self._host([torch.min(torch.where(valid, k64, _I64_MAX)),
                          torch.max(torch.where(valid, k64, _I64_MIN)),
                          torch.sum(valid, dtype=torch.int64)], site="join.direct.range")
        kmin, kmax, nlive = (int(x) for x in got)
        if nlive == 0 or kmax - kmin + 1 > DIRECT_JOIN_RANGE_MAX:
            return None
        return kmin, kmax - kmin + 1

    def _build_join_table(self, build_page: Page, key_channels, key_types, span=None):
        n = build_page.capacity
        # 4x build rows (load <= 0.25) keeps probe chains short
        capacity = max(1 << max(n - 1, 1).bit_length(), 16) * 4
        keys = tuple(build_page.columns[i] for i in key_channels)
        valid = build_page.valid_mask()
        for ch in key_channels:
            nm = build_page.null_masks[ch]
            if nm is not None:
                valid = valid & ~nm
        if span is not None:
            dt = direct_build(span[0], span[1], build_page, key_channels[0])
            if int(self._host([dt.dup_count], site="join.direct.dups")[0]) > 0:
                return None  # duplicate keys: the multi-match strategy
            return dt
        while True:
            table = build_insert(build_table_init(capacity, build_page), keys, key_types,
                                 valid)
            overflow, dups = (int(x) for x in self._host(
                [table.overflow, table.dup_count], site="join.build.flags"))
            if not overflow:
                break
            capacity *= 4
        return None if dups > 0 else table

    # the most distinct build keys shipped into one connector index lookup
    # (sqlite's default bound-parameter cap is 999; past ~500 keys a lookup
    # rarely beats scanning the remote table)
    INDEX_JOIN_MAX_KEYS = 500
    # build rows above which the index join is not attempted
    INDEX_JOIN_MAX_PROBE = 1 << 16

    def _index_lookup_stream(self, probe_stream: _Stream, node, build_page: Page,
                             build_dicts):
        """The index join (reference: operator/index/IndexLoader): where the
        probe side scans a connector with keyed lookups
        (``supports_index_lookup``) and the build side's distinct join keys
        are few, the probe's splits are replaced by one lookup split that
        ships only the rows matching those keys.  Returns the replacement
        probe stream, or None.  ``TRINO_TPU_INDEX_JOIN=0`` (read per join)
        turns it off.

        The distinct keys are found on the device in fixed-size buffers, as
        the reference's fixed-size unique finds them, and read back with
        their count and the live count in one counted read (site
        ``join.index.keys``); past ``INDEX_JOIN_MAX_KEYS`` there are too
        many.  The lookup's pages go through ``_scan_pages_source``, so a
        host-decoding connector's are staged like any scan's."""
        import os

        if os.environ.get("TRINO_TPU_INDEX_JOIN", "1") == "0":
            return None
        if self._split_restriction:
            return None  # a task's lookup would return every task's rows
        if len(node.right_keys) != 1:
            return None
        si = probe_stream.scan_info
        if si is None or not si.replayable or not si.splits \
                or not hasattr(si.splits[0], "table"):
            return None
        conn = si.conn
        table = si.splits[0].table
        if not getattr(conn, "supports_index_lookup", False) \
                or getattr(conn, "is_pushdown_handle", lambda t: False)(table):
            return None
        pk = node.left_keys[0]
        key_col = si.columns[pk] if pk < len(si.columns) else None
        if key_col is None:
            return None
        key_t = probe_stream.schema.fields[pk].type
        if not (key_t.is_integer or key_t.is_string):
            return None
        if build_page.capacity == 0 or build_page.capacity > self.INDEX_JOIN_MAX_PROBE:
            return None
        try:
            remote_rows = int(conn.row_count(table))
        except Exception:  # noqa: BLE001 - no estimate, no lookup
            return None
        bk = node.right_keys[0]
        v = build_page.columns[bk]
        nm = build_page.null_masks[bk]
        live = build_page.valid_mask()
        if nm is not None:
            live = live & ~nm
        # dead lanes fold onto lane 0's value (a spurious key only
        # over-fetches; the join still filters).  Sorted, each run's first
        # row takes the next slot; runs past the budget land in the last
        # slot, which is never read as a key
        cap = self.INDEX_JOIN_MAX_KEYS
        srt = torch.sort(torch.where(live, v, v[0])).values
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        pos = torch.cumsum(first, 0) - 1
        slot = torch.where(first & (pos < cap), pos, torch.full_like(pos, cap))
        buf = torch.zeros(cap + 1, dtype=srt.dtype, device=srt.device).scatter_(0, slot, srt)
        got = self._host([buf, pos[-1] + 1, torch.sum(live, dtype=torch.int64)],
                         site="join.index.keys")
        if int(got[2]) == 0:
            # an all-dead build: the dynamic pruner's empty-build path ships
            # nothing, where a lookup would ship a dead lane's value
            return None
        n_keys = int(got[1])
        if n_keys > cap:
            return None
        keys = got[0][:n_keys]
        # worth it on the lookup's actual size, not the build's lanes
        if remote_rows < 4 * len(keys):
            return None
        bd = build_dicts[bk]
        if key_t.is_string:
            if bd is None or getattr(bd, "values", None) is None:
                return None
            keys = [str(x) for x in bd.decode(keys.astype(np.int64))]
        else:
            keys = [int(x) for x in keys.tolist()]
        handle = conn.apply_index_lookup(table, key_col, keys)
        new_splits = conn.splits(handle)
        pages = self._scan_pages_source(conn, si.catalog, handle, new_splits,
                                        si.scan_columns)
        self._node_stats(node)["index_join_keys"] = len(keys)
        # the lookup's pages are not the generator's splits
        return dataclasses.replace(probe_stream, pages=pages,
                                   scan_info=dataclasses.replace(si, splits=list(new_splits)),
                                   traced_src=None)

    def _dynamic_pruned_pages(self, probe_stream: _Stream, node, build_page: Page):
        """(page source, kept splits) skipping probe splits disjoint from the
        build keys' value domain, or None when nothing prunes."""
        si = probe_stream.scan_info
        if si is None or not si.replayable or not hasattr(si.conn, "split_range"):
            return None
        exact_ok = build_page.capacity <= 65536
        if build_page.capacity and exact_ok:
            bvalid = self._host([build_page.valid_mask()], site="join.prune.valid")[0]
            nonempty = bool(bvalid.any())
        elif build_page.capacity:
            bvalid = None
            nonempty = bool(self._host([torch.any(build_page.valid_mask())],
                                       site="join.prune.nonempty")[0])
        else:
            bvalid, nonempty = None, False
        if not nonempty:
            return (lambda: iter(())), ()  # empty build: no probe row can match
        from ..spi.predicate import UNION_LIMIT, Domain, Range
        from ..sql.domain_translator import domain_to_split_pruner

        domains = {}
        span_stats, span_cols = [], []
        for pch, bch in zip(node.left_keys, node.right_keys):
            col = si.columns[pch] if pch < len(si.columns) else None
            if col is None:
                continue
            f = node.right.schema.fields[bch]
            if f.type.is_string or f.type.is_floating:
                continue
            nm = build_page.null_masks[bch]
            if exact_ok:
                got = self._host([build_page.columns[bch]] + ([nm] if nm is not None else []),
                                 site="join.prune.keys")
                vals = got[0][bvalid]
                if nm is not None:
                    vals = vals[~got[1][bvalid]]
                if len(vals) == 0:
                    continue
                uniq = np.unique(vals)
                if len(uniq) <= UNION_LIMIT:
                    domains[col] = Domain.multiple_values([int(v) for v in uniq])
                else:
                    domains[col] = Domain.from_range(
                        Range.between(int(vals.min()), int(vals.max())))
            else:
                live = build_page.valid_mask()
                if nm is not None:
                    live = live & ~nm
                c64 = build_page.columns[bch].to(torch.int64)
                span_stats.extend([torch.min(torch.where(live, c64, _I64_MAX)),
                                   torch.max(torch.where(live, c64, _I64_MIN)),
                                   torch.any(live)])
                span_cols.append(col)
        if span_cols:
            got = self._host(span_stats, site="join.prune.span")
            for i, col in enumerate(span_cols):
                if bool(got[3 * i + 2]):
                    domains[col] = Domain.from_range(
                        Range.between(int(got[3 * i]), int(got[3 * i + 1])))
        if not domains:
            return None
        keep = domain_to_split_pruner(domains, si.conn)
        kept = tuple(s for s in si.splits if keep(s))
        # the kept splits key their own page-tier entry: a pruned probe scan
        # never serves or stores the whole table
        return self._scan_pages_source(si.conn, si.catalog, si.table, kept,
                                       si.scan_columns), kept

    # -- materialization ------------------------------------------------------
    def _concat_stream(self, stream: _Stream, node=None) -> Page:
        """Materialize a streaming segment into one compacted device page:
        live-row counts are read per chunk of eight coalesced groups, each
        group's live rows pack into a pow2 bucket (compaction kernel), and
        the parts concatenate on the device.  A regenerable stream of plan
        node ``node`` takes the scan-fused count and fill passes
        (``_concat_traced``) where they are on."""
        if node is not None:
            fused = self._concat_traced(stream, node)
            if fused is not None:
                return fused
        parts = []
        staged, sums = [], []

        def drain():
            counts = [int(c) for c in self._host(sums, site="compact.counts")]
            for (cols, nulls, valid), n in zip(staged, counts):
                if n == 0:
                    continue
                if any(isinstance(c, np.ndarray) for c in cols):
                    # exact wide-decimal columns: the live rows on the host
                    got = self._host([valid] + list(cols) + list(nulls),
                                     site="compact.host")
                    v = got[0]
                    parts.append((tuple(c[v] for c in got[1:1 + len(cols)]),
                                  tuple(None if m is None else m[v]
                                        for m in got[1 + len(cols):]), None))
                    continue
                bucket = min(max(1 << max(n - 1, 1).bit_length(), 1024), valid.shape[0])
                packed, _ = compact_rows(tuple(cols) + tuple(nulls), valid, bucket)
                pvalid = torch.arange(bucket, device=valid.device) < n
                parts.append((packed[:len(cols)], packed[len(cols):], pvalid))
            staged.clear()
            sums.clear()

        for cols, nulls, valid in self._outs(stream):
            staged.append((cols, nulls, valid))
            sums.append(torch.sum(valid, dtype=torch.int32))
            if len(staged) >= 8:
                drain()
        if staged:
            drain()
        if not parts:
            cols = tuple(torch.zeros((0,), dtype=torch_dtype(f.type), device=self.device)
                         for f in stream.schema.fields)
            return Page(stream.schema, cols, tuple(None for _ in cols), None)
        if len(parts) == 1:
            ccols, cnulls, pvalid = parts[0]
            return Page(stream.schema, ccols, cnulls, pvalid)
        if parts[0][2] is None:  # host parts
            cols = tuple(np.concatenate([p[0][ci] for p in parts])
                         for ci in range(len(parts[0][0])))
            nulls = tuple(None if all(p[1][ci] is None for p in parts) else np.concatenate([
                np.zeros(len(p[0][ci]), bool) if p[1][ci] is None else p[1][ci]
                for p in parts]) for ci in range(len(cols)))
            return Page(stream.schema, cols, nulls, None)
        ncols = len(parts[0][0])
        cols_out, nulls_out = [], []
        for ci in range(ncols):
            cols_out.append(torch.cat([p[0][ci] for p in parts]))
            if any(p[1][ci] is not None for p in parts):
                nulls_out.append(torch.cat([
                    p[1][ci] if p[1][ci] is not None else torch.zeros_like(p[2])
                    for p in parts]))
            else:
                nulls_out.append(None)
        valid = torch.cat([p[2] for p in parts])
        return Page(stream.schema, tuple(cols_out), tuple(nulls_out), valid)

    def _sort_or_topn(self, page: Page, keys, count, dicts) -> Page:
        """Sort (count=None) or TopN on the device; on the host where a key is
        a string whose dictionary cannot rank ids on the device (a formatter
        dictionary: names derived from keys)."""
        rankable = all(
            not page.schema.fields[k.channel].type.is_string
            or getattr(dicts[k.channel], "values", None) is not None for k in keys)
        if rankable and all(isinstance(c, torch.Tensor) for c in page.columns):
            return self._topn_page_device(page, keys, count, dicts)
        return self._sort_page_host(page, keys, count, dicts)

    def _sort_page_host(self, page: Page, keys, count, dicts) -> Page:
        """Host-side lexicographic sort of the pulled live rows; string keys
        sort by their decoded values."""
        valid, pcols, pnulls = self._host_page(page, site="sort.host")
        cols = [c[valid] for c in pcols]
        nulls = [None if n is None else n[valid] for n in pnulls]
        sort_cols = list(cols)
        for k in keys:
            d = dicts[k.channel]
            if d is not None and page.schema.fields[k.channel].type.is_string:
                sort_cols[k.channel] = d.decode(cols[k.channel]).astype(str)
        order = np.arange(len(cols[0]) if cols else 0)
        for k in reversed(keys):
            c = sort_cols[k.channel][order]
            nm_k = nulls[k.channel]
            if nm_k is not None and len(c):
                # NULL rows hold arbitrary fill values: pin them to one value
                c = c.copy()
                c[nm_k[order]] = c[0]
            if not np.issubdtype(c.dtype, np.number):
                _, c = np.unique(c, return_inverse=True)  # string -> collation rank
            if not k.ascending:
                c = -c.astype(np.int64 if np.issubdtype(c.dtype, np.integer)
                              else np.float64)
            order = order[np.argsort(c, kind="stable")]
            if nm_k is not None:
                # null placement outranks the value ordering for this key
                ind = nm_k[order].astype(np.int8)
                order = order[np.argsort(-ind if k.nulls_first else ind, kind="stable")]
        order = order[:count] if count is not None else order
        return Page(page.schema, tuple(c[order] for c in cols),
                    tuple(None if n is None else n[order] for n in nulls), None)

    def _topn_page_device(self, page: Page, keys, count, dicts=None) -> Page:
        """Device-side sort (count=None) or TopN: one lexicographic sort over
        collation-ranked keys, then pull only the selected rows."""
        n = page.capacity
        valid = page.valid_mask()
        if count is None:
            count = int(self._host([torch.sum(valid, dtype=torch.int64)],
                                   site="sort.count")[0])
            all_live = True
        else:
            all_live = False
        idx = _lexsort(_sort_lex(page, keys, dicts), n, valid.device)[:count]
        nc = len(page.columns)
        fetch = [c[idx] for c in page.columns]
        fetch += [nm[idx] for nm in page.null_masks if nm is not None]
        if not all_live:
            fetch.append(valid[idx])
        got = self._host(fetch, site="sort.pull")
        pos = nc
        nulls = []
        for nm in page.null_masks:
            if nm is None:
                nulls.append(None)
            else:
                nulls.append(got[pos])
                pos += 1
        cols = tuple(got[:nc])
        if not all_live:
            v = got[pos]
            cols = tuple(c[v] for c in cols)
            nulls = [None if m is None else m[v] for m in nulls]
        return Page(page.schema, cols, tuple(nulls), None)

    def _sorted_device_page(self, page: Page, keys, dicts) -> Page:
        """The live rows of a page in ``keys`` order, on the device: the
        lexicographic sort of ``_topn_page_device`` (input order among equal
        keys) where every key ranks on the device, else the host sort moved
        back.  One read counts the live rows."""
        if not all(not page.schema.fields[k.channel].type.is_string
                   or getattr(dicts[k.channel], "values", None) is not None for k in keys):
            return self._device_page(self._sort_page_host(page, keys, None, dicts))
        page = self._device_page(page)
        valid = page.valid_mask()
        count = int(self._host([torch.sum(valid, dtype=torch.int64)], site="sort.count")[0])
        idx = _lexsort(_sort_lex(page, keys, dicts), page.capacity, valid.device)[:count]
        return Page(page.schema, tuple(c[idx] for c in page.columns),
                    tuple(None if m is None else m[idx] for m in page.null_masks), None)

    def _materialize(self, page: Page, dicts) -> MaterializedResult:
        if all(isinstance(c, torch.Tensor) for c in page.columns):
            valid, pcols, pnulls = self._host_page(page, site="result")
        else:  # a sorted page: already pulled, every row live
            pcols, pnulls = page.columns, page.null_masks
            valid = np.ones((len(pcols[0]) if pcols else 0,), bool)
        return _materialize_host(page.schema, valid, pcols, pnulls, dicts)


# -- helpers ------------------------------------------------------------------------------


def _sort_lex(page: Page, keys, dicts):
    """The sort keys of a page for ``_lexsort`` (the last is primary):
    collation-ranked strings, each key's NULL placement above its values,
    dead lanes last."""
    lex = []
    for k in reversed(keys):
        c = page.columns[k.channel]
        t = page.schema.fields[k.channel].type
        d = dicts[k.channel] if dicts is not None else None
        if t.is_string:
            rank = device_array(_collation_rank_lut(d), c.device)
            c = rank[torch.clamp(c, 0, max(len(rank) - 1, 0)).to(torch.int64)]
        if c.dtype == torch.bool:
            c = c.to(torch.int8)
        nm = page.null_masks[k.channel]
        if nm is not None:
            # NULL lanes hold arbitrary fill values: pin them to one constant
            c = torch.where(nm, torch.zeros_like(c), c)
        if not k.ascending:
            c = ~c if not c.is_floating_point() else -c
        lex.append(c)
        ind = torch.zeros(c.shape, dtype=torch.int8, device=c.device) if nm is None \
            else nm.to(torch.int8)
        lex.append(-ind if k.nulls_first else ind)
    lex.append((~page.valid_mask()).to(torch.int8))  # invalid lanes last
    return lex


def _scan_pages(conn, table: str, splits, columns):
    """Page source over ``splits``: one generated page per split, each
    generation a ``generate`` fault point (site ``scan.<table>``)."""
    splits, columns = list(splits), list(columns)

    def pages():
        for s in splits:
            faults.maybe_inject("generate", f"scan.{table}")
            yield conn.generate(s, columns)

    return pages


def _staged_scan_pages(pages_fn):
    """``pages_fn`` with each page an ``h2d`` fault point, where the
    reference's scan stages a generated page to the device (its prefetch
    wrap of a multi-split scan while dispatches coalesce,
    ``_rewrap_pruned_pages``; the port reads the process default,
    ``TRINO_TPU_DISPATCH_BATCH``).  The port generates on the engine's
    device, so there is nothing to copy: the point keeps the reference's
    chokepoint and its count."""
    def pages():
        for p in pages_fn():
            faults.maybe_inject("h2d", "page_to_device")
            yield p

    return pages


def _broadcast(vn, valid):
    v, nu = vn
    v = v.expand(valid.shape) if v.dim() == 0 else v
    if nu is not None and nu.dim() == 0:
        nu = nu.expand(valid.shape)
    return v, nu


def _lexsort(lex, n: int, device) -> torch.Tensor:
    """numpy.lexsort order (the LAST key is primary) by successive stable sorts."""
    order = torch.arange(n, device=device)
    for key in lex:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _static_pruned_stream(up: _Stream, pred):
    """Split pruning from the pushed-down predicate's TupleDomain: (pages,
    scan_info) with the kept splits, or None when nothing prunes.  ``pages``
    is None where splits are kept: the caller builds their page source."""
    si = up.scan_info
    if si is None or not si.replayable or not hasattr(si.conn, "split_range"):
        return None
    from ..sql.domain_translator import (domain_to_split_pruner, extract_domains,
                                         split_conjuncts)

    td = extract_domains(split_conjuncts(pred)).tuple_domain
    if td.is_none:
        return None, dataclasses.replace(si, splits=[])
    if td.is_all:
        return None
    by_col: dict = {}
    for ch, dom in td.domains.items():
        col = si.columns[ch] if ch < len(si.columns) else None
        # float stats exclude NaN: never prune on floating columns
        if col is not None and not up.schema.fields[ch].type.is_floating:
            by_col[col] = dom.intersect(by_col[col]) if col in by_col else dom
    if not by_col:
        return None
    keep = domain_to_split_pruner(by_col, si.conn)
    kept = [s for s in si.splits if keep(s)]
    if len(kept) == len(si.splits):
        return None
    return None, dataclasses.replace(si, splits=kept)


def _gather_build(table, row_ids, matched, kind):
    """Build-side columns for the probe rows; unmatched rows read row 0, and
    a left join marks them NULL."""
    safe = torch.where(matched, row_ids, 0).to(torch.int64)
    cols, nulls = [], []
    for c, nmask in zip(table.build_columns, table.build_null_masks):
        cols.append(c[safe])
        base = torch.zeros_like(matched) if nmask is None else nmask[safe]
        nulls.append((base | ~matched) if kind == "left"
                     else (None if nmask is None else base))
    return tuple(cols), tuple(nulls)


def _join_dicts(node: P.Join, probe_stream, build_dicts) -> tuple:
    if node.kind == "mark":
        return probe_stream.dicts + (None,)
    if node.kind in ("semi", "anti"):
        return probe_stream.dicts
    return probe_stream.dicts + build_dicts


def _null_aware_anti(node, anti_valid, nulls, build_has_null, build_nonempty):
    """NOT IN three-valued logic: a NULL among the build keys, or a NULL probe
    key against a non-empty build, makes the predicate UNKNOWN (row rejected).
    NOT EXISTS anti joins (``null_aware`` False) skip this."""
    if not node.null_aware:
        return anti_valid
    if build_has_null:
        return torch.zeros_like(anti_valid)
    if build_nonempty:
        for i in node.left_keys:
            if nulls[i] is not None:
                anti_valid = anti_valid & ~nulls[i]
    return anti_valid


# how per-segment partial accumulators merge (streaming aggregation): a
# partial count adds, the two limbs of an exact decimal sum add as they are
_MERGE_KIND = {"sum": "sum", "count": "sum", "count_star": "sum",
               "min": "min", "max": "max", "sum_sq": "sum",
               "sum_hi32": "sum", "sum_lo32": "sum"}


def _segment_partials(node, cols, nulls, valid, acc_exprs, acc_specs, acc_kinds):
    """One page of clustered input reduced per key segment: the live rows
    pack to the front in order (the compaction kernel), a row whose key
    (value or null flag) differs from the previous live row starts a
    segment, and each accumulator reduces per segment.  -> (keys, key null
    flags, per-row totals of the row's segment, segment-start mask)."""
    n = valid.shape[0]
    vn_raw = []
    for e in acc_exprs:
        if e is None:
            vn_raw.append(None)
            continue
        v, nu = evaluate(e, cols, nulls)
        v = v.expand(valid.shape) if v.ndim == 0 else v
        if nu is not None and nu.ndim == 0:
            nu = nu.expand(valid.shape)
        vn_raw.append((v, nu))
    to_pack = [cols[ch] for ch in node.keys] + [nulls[ch] for ch in node.keys] \
        + [a for vn in vn_raw if vn is not None for a in vn]
    packed, count = compact_rows(tuple(to_pack), valid, n)
    live = torch.arange(n, device=valid.device) < count
    it = iter(packed)
    kcols = [next(it) for _ in node.keys]
    knulls = [kn if kn is not None else torch.zeros((n,), dtype=torch.bool,
                                                     device=valid.device)
              for kn in (next(it) for _ in node.keys)]
    new = torch.zeros((n,), dtype=torch.bool, device=valid.device)
    if n:
        new[0] = True
    for k, kn in zip(kcols, knulls):
        kv = torch.where(kn, torch.zeros((), dtype=k.dtype, device=k.device), k)
        new[1:] |= (kv[1:] != kv[:-1]) | (kn[1:] != kn[:-1])
    new &= live
    seg = torch.clamp(torch.cumsum(new, 0) - 1, 0, max(n - 1, 0)).to(torch.int32)
    accs = []
    for vn_r, (dt, init), kind in zip(vn_raw, acc_specs, acc_kinds):
        vn = None if vn_r is None else (next(it), next(it))
        acc0 = torch.full((n + 1,), init, dtype=torch_dtype(dt), device=valid.device)
        accs.append(hashagg.agg_update(acc0, kind, seg, live, vn)[seg])
    return tuple(kcols), tuple(knulls), tuple(accs), new


def _concat_pages(schema, pages, host) -> Page:
    """The partitions' finalized pages as one page, every row live: device
    columns concatenate on the device; where a partition's finalize left a
    column on the host (an exact wide-decimal sum), every page comes to the
    host in one counted read (``host``) and concatenates there."""
    w = len(schema.fields)
    if not pages:
        return Page(schema, tuple(np.empty((0,), np.dtype(f.type.dtype))
                                  for f in schema.fields), (None,) * w, None)
    if all(isinstance(c, torch.Tensor) for pg in pages for c in pg.columns):
        cols = tuple(torch.cat([pg.columns[i] for pg in pages]) for i in range(w))
        nulls = []
        for i in range(w):
            if all(pg.null_masks[i] is None for pg in pages):
                nulls.append(None)
            else:
                nulls.append(torch.cat([
                    pg.null_masks[i] if pg.null_masks[i] is not None
                    else torch.zeros((pg.columns[i].shape[0],), dtype=torch.bool,
                                     device=pg.columns[i].device)
                    for pg in pages]))
        return Page(schema, cols, tuple(nulls), None)
    flat = host([a for pg in pages for a in tuple(pg.columns) + tuple(pg.null_masks)],
                site="agg.partition.pull")
    hp = [(flat[k * 2 * w:k * 2 * w + w], flat[k * 2 * w + w:(k + 1) * 2 * w])
          for k in range(len(pages))]
    from .spill import concat_host_chunks

    cols, nulls = concat_host_chunks(schema, hp)
    return Page(schema, tuple(cols), tuple(nulls), None)


def _prefetched_pages(pages_fn, depth: int = 2, to_device: bool = False, owner=None):
    """``pages_fn`` with its pages made up to ``depth`` ahead on a producer
    thread; ``to_device`` also stages each page's host (numpy) arrays to
    ``owner``'s device there, so the copy overlaps the consumer's work.
    Exceptions re-raise at the consumer.  The producer carries the
    consumer's counter set and query id, so what it records (fault
    firings) charges the query; the H2D bytes it staged are counted by the
    consumer.  ``owner`` (the executor) registers the producer's stop flag
    and thread so ``close_producers`` stops it on every exit path, and the
    producer stops when the consumer is closed.

    On a CUDA device the copies run on a side stream from pinned buffers;
    the consumer's stream waits on an event recorded after them, and each
    staged tensor is marked as used by the consumer's stream so the caching
    allocator does not hand its memory out while the consumer's kernels
    may still read it."""
    import queue as _queue

    device = owner.device if owner is not None else torch.device("cpu")
    cuda = to_device and device.type == "cuda"

    def pages():
        it = pages_fn()
        q: _queue.Queue = _queue.Queue(maxsize=depth)
        done = object()
        closed = threading.Event()
        counters = tracing.current_counters()
        qid = tracing.current_query_id()
        side = torch.cuda.Stream(device=device) if cuda else None

        def producer():
            def put(item) -> bool:
                while not closed.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except _queue.Full:
                        continue
                return False

            with contextlib.ExitStack() as scopes:
                if counters is not None:
                    scopes.enter_context(tracing.track_counters(counters))
                if qid is not None:
                    scopes.enter_context(tracing.query_scope(qid))
                if side is not None:
                    scopes.enter_context(torch.cuda.stream(side))
                try:
                    for p in it:
                        item = _page_to_device(p, device, side) if to_device \
                            else (p, 0, None)
                        if not put(item):
                            return
                    put(done)
                except BaseException as e:  # noqa: BLE001 - surfaces in the consumer
                    put(e)
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()

        t = threading.Thread(target=producer, daemon=True, name="prefetch-producer")
        if owner is not None:
            owner._producers.append((closed, t))
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                page, nbytes, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(device)
                    cur.wait_event(event)
                    for a in tuple(page.columns) + tuple(page.null_masks) + (page.valid,):
                        if isinstance(a, torch.Tensor):
                            a.record_stream(cur)
                if nbytes and owner is not None:
                    owner._count_h2d(nbytes)
                yield page
        finally:
            closed.set()

    return pages


def _page_to_device(page: Page, device, side):
    """(page on ``device``, bytes staged, event or None): every numpy array
    of ``page`` copied to the device (object columns stay on the host).  On
    a CUDA ``side`` stream the copies are asynchronous from pinned memory
    and an event recorded after them comes back with the page.  Every page
    passed in is an ``h2d`` fault point, host arrays or not, as in the
    reference."""
    faults.maybe_inject("h2d", "page_to_device")
    nbytes = 0

    def up(a):
        nonlocal nbytes
        if isinstance(a, np.ndarray) and a.dtype != object:
            nbytes += a.nbytes
            a = np.ascontiguousarray(a)
            # a decoder's buffer may be read-only: torch takes a writable one
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
            if side is not None:
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)
        return a

    out = Page(page.schema, tuple(up(c) for c in page.columns),
               tuple(None if m is None else up(m) for m in page.null_masks),
               None if page.valid is None else up(page.valid))
    event = None
    if side is not None:
        event = torch.cuda.Event()
        event.record(side)
    return out, nbytes, event


def _live_rows(page: Page):
    """A page's live-row count: a 0-d int64 tensor for a device page (no
    read), an int for a host one."""
    if not page.capacity:
        return 0
    if page.valid is None:
        return page.capacity
    if isinstance(page.valid, torch.Tensor):
        return torch.sum(page.valid, dtype=torch.int64)
    return int(np.count_nonzero(page.valid))


def _page_bytes(page: Page) -> int:
    """Device bytes held by a page's columns + null masks."""
    total = sum(page.capacity * c.element_size() for c in page.columns)
    return total + sum(page.capacity for m in page.null_masks if m is not None)


# digests of object arrays, by identity: id -> (weak reference, digest).  An
# entry is used only while its weak reference still names the array, so a
# reused id never finds another array's digest
_OBJECT_DIGESTS: dict = {}

# value types whose repr is their whole value
_BY_REPR = (Decimal, datetime.date, datetime.time, datetime.timedelta, enum.Enum)


def _plan_fingerprint(node: P.PlanNode, catalogs: dict) -> str:
    """Structural fingerprint of a plan subtree: the build-tier key and the
    result tier's.  Two structurally equal fragments collide even when they
    are different plan objects (another statement with the same subquery),
    so the walk is by content: dataclass leaves print by value, children
    recurse, and a TableScan prints its catalog, table, columns and the
    connector's plan_version.  numpy arrays (planner lookup tables and
    dictionaries, IN lists) print as a digest of their contents, numpy
    scalars, decimals and dates by value.  Only a value of another kind
    prints by identity, and the pool's entry holds the fragment it was
    keyed on, so that identity is not reused while the entry lives."""

    def val(v):
        if v is None or isinstance(v, (str, int, float, bool, bytes)):
            return repr(v)
        if isinstance(v, (tuple, list)):
            return "(" + ",".join(val(x) for x in v) + ")"
        if isinstance(v, P.PlanNode):
            return fp(v)
        if isinstance(v, np.ndarray):
            if v.dtype == object:
                return f"nd(object,{v.shape},{object_digest(v)})"
            digest = hashlib.blake2b(np.ascontiguousarray(v).tobytes(),
                                     digest_size=16).hexdigest()
            return f"nd({v.dtype},{v.shape},{digest})"
        if isinstance(v, np.generic):
            return f"{v.dtype}:{v.item()!r}"
        if isinstance(v, _BY_REPR):
            return f"{type(v).__name__}:{v!r}"
        if isinstance(v, type):
            return f"type:{v.__module__}.{v.__qualname__}"
        if dataclasses.is_dataclass(v):
            return f"{type(v).__name__}(" + ",".join(
                val(getattr(v, f.name)) for f in dataclasses.fields(v)) + ")"
        return f"{type(v).__name__}#{id(v)}"

    def object_digest(v):
        memo = _OBJECT_DIGESTS.get(id(v))
        if memo is not None and memo[0]() is v:
            return memo[1]
        digest = hashlib.blake2b("\x1f".join(val(x) for x in v.ravel().tolist())
                                 .encode("utf-8", "surrogatepass"),
                                 digest_size=16).hexdigest()

        def forget(ref, k=id(v)):
            if _OBJECT_DIGESTS.get(k, (None,))[0] is ref:
                del _OBJECT_DIGESTS[k]

        _OBJECT_DIGESTS[id(v)] = (weakref.ref(v, forget), digest)
        return digest

    def fp(n):
        if isinstance(n, P.TableScan):
            conn = catalogs.get(n.catalog)
            ver = conn.plan_version() if hasattr(conn, "plan_version") else 0
            return f"TableScan({n.catalog},{n.table},{','.join(n.columns)},v{ver})"
        return f"{type(n).__name__}(" + ";".join(
            val(getattr(n, f.name)) for f in dataclasses.fields(n)) + ")"

    return fp(node)


def _acc_input_expr(spec: P.AggSpec):
    """The expression an aggregate's accumulators consume: checksum sums
    the rows' hashes, every other aggregate its argument."""
    if spec.kind == "checksum" and spec.arg is not None:
        return Call("hash", (spec.arg,), BIGINT)
    return spec.arg


def _accumulators_for(spec: P.AggSpec):
    """(kind, dtype, init) accumulator list for one agg call."""
    t = spec.type
    if spec.kind in ("count_star", "count"):
        return [(spec.kind, np.int64, 0)]
    if spec.kind in ("sum", "avg"):
        # the trailing count tells an all-NULL group (NULL) from a zero sum
        in_t = t if spec.kind == "sum" else spec.arg.type
        if isinstance(in_t, DecimalType):
            # exact wide sum: two int64 limbs recombined exactly at finalization
            return [("sum_hi32", np.int64, 0), ("sum_lo32", np.int64, 0),
                    ("count", np.int64, 0)]
        return [("sum", np.float64 if in_t.is_floating else np.int64, 0),
                ("count", np.int64, 0)]
    if spec.kind in ("min", "max"):
        dtype = spec.arg.type.dtype
        return [(spec.kind, dtype, hashagg._extreme(dtype, 1 if spec.kind == "min" else -1))]
    if spec.kind in _VARIANCE_KINDS:
        # (sum, sum of squares, count): the merge-friendly form of the
        # reference's VarianceState
        return [("sum", np.float64, 0), ("sum_sq", np.float64, 0), ("count", np.int64, 0)]
    if spec.kind in ("bool_and", "bool_or"):
        kind = "min" if spec.kind == "bool_and" else "max"
        return [(kind, np.int8, hashagg._extreme(np.int8, 1 if kind == "min" else -1))]
    if spec.kind == "arbitrary":
        dtype = spec.arg.type.dtype
        return [("min", dtype, hashagg._extreme(dtype, 1))]
    if spec.kind == "checksum":
        # the wrapping int64 sum of the rows' splitmix64 hashes, and a count
        # (strings hash their dictionary ids, as in the reference)
        return [("sum", np.int64, 0), ("count", np.int64, 0)]
    raise _not_ported(f"aggregate {spec.kind}")


# sort-based aggregates whose results are arrays or maps
_ARRAY_AGG_KINDS = ("array_agg", "histogram", "map_agg", "approx_most_frequent")


_VARIANCE_KINDS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")


def _global_init_state(acc_specs, device) -> tuple:
    """One 0-d accumulator per (dtype, init) spec of an ungrouped aggregation."""
    return tuple(torch.tensor(init, dtype=torch_dtype(dt), device=device)
                 for dt, init in acc_specs)


def _global_agg_update(state, cols, nulls, valid, acc_exprs, acc_kinds) -> tuple:
    """One page folded into the ungrouped-aggregation accumulators."""
    out = []
    for st, e, kind in zip(state, acc_exprs, acc_kinds):
        if kind == "count_star":
            out.append(st + torch.sum(valid, dtype=st.dtype))
            continue
        v, nu = _broadcast(evaluate(e, cols, nulls), valid)
        mask = valid if nu is None else (valid & ~nu)
        if kind == "count":
            out.append(st + torch.sum(mask, dtype=st.dtype))
        elif kind == "sum":
            out.append(st + torch.sum(torch.where(mask, v, torch.zeros_like(v)),
                                      dtype=st.dtype))
        elif kind in ("sum_hi32", "sum_lo32"):
            v64 = v.to(torch.int64)
            h = (v64 >> 32) if kind == "sum_hi32" else (v64 & 0xFFFFFFFF)
            out.append(st + torch.sum(torch.where(mask, h, 0), dtype=st.dtype))
        elif kind == "sum_sq":
            vv = v.to(st.dtype)
            out.append(st + torch.sum(torch.where(mask, vv * vv, 0), dtype=st.dtype))
        elif kind in ("min", "max"):
            if v.numel() == 0:
                out.append(st)
                continue
            ident = hashagg._extreme(st.dtype, 1 if kind == "min" else -1)
            fill = torch.where(mask, v.to(st.dtype), torch.full_like(st, ident))
            red = torch.min(fill) if kind == "min" else torch.max(fill)
            out.append(torch.minimum(st, red) if kind == "min" else torch.maximum(st, red))
        else:
            raise _not_ported(f"ungrouped accumulator {kind}")
    return tuple(out)


def _limbs_device(hi, lo):
    """Two-limb decimal sum recombination on the device: exact int64 inside
    the +-2^62 envelope; the flag marks the out-of-envelope case."""
    approx = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
    bad = torch.any(torch.abs(approx) >= float(1 << 62))
    return hi * (1 << 32) + lo, bad


def _finalize_aggs_device(aggs, acc_cols):
    """Device finalization: (cols, nulls, bad) with ``bad`` a 0-d bool set when
    a wide decimal sum leaves the exact-int64 envelope."""
    out, nulls = [], []
    dev = acc_cols[0].device if acc_cols else torch.device("cpu")
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    i = 0
    for spec in aggs:
        if spec.kind == "avg" and spec.arg is not None \
                and isinstance(spec.arg.type, DecimalType):
            hi, lo, c = acc_cols[i], acc_cols[i + 1], acc_cols[i + 2]
            i += 3
            v, b = _limbs_device(hi, lo)
            bad = bad | b
            n = torch.clamp(c.to(torch.int64), min=1)
            a = torch.abs(v)
            q = torch.div(a, n, rounding_mode="floor")
            r = a - q * n
            res = (q + (2 * r >= n).to(torch.int64)) * torch.where(v >= 0, 1, -1)
            out.append(res.to(torch.int64))
            nulls.append(c == 0)
        elif spec.kind == "avg":
            s, c = acc_cols[i], acc_cols[i + 1]
            i += 2
            # in float64: torch divides two integer tensors in float32
            out.append(s.to(torch.float64) / torch.where(c == 0, torch.ones_like(c), c))
            nulls.append(c == 0)
        elif spec.kind == "sum" and isinstance(spec.type, DecimalType):
            hi, lo, c = acc_cols[i], acc_cols[i + 1], acc_cols[i + 2]
            i += 3
            v, b = _limbs_device(hi, lo)
            bad = bad | b
            out.append(v)
            nulls.append(c == 0)
        elif spec.kind in ("sum", "checksum"):
            s, c = acc_cols[i], acc_cols[i + 1]
            i += 2
            out.append(s.to(torch_dtype(spec.type)))
            nulls.append(c == 0)
        elif spec.kind in _VARIANCE_KINDS:
            s, ssq, c = acc_cols[i], acc_cols[i + 1], acc_cols[i + 2]
            i += 3
            c_safe = torch.where(c == 0, 1, c).to(torch.float64)
            m2 = torch.clamp(ssq - s * s / c_safe, min=0.0)  # fp cancellation
            if spec.kind.endswith("_pop"):
                var = m2 / c_safe
                null = c == 0
            else:  # undefined below two rows
                var = torch.where(c < 2, 0.0, m2 / torch.where(c < 2, 1, c - 1))
                null = c < 2
            out.append(torch.sqrt(var) if spec.kind.startswith("stddev") else var)
            nulls.append(null)
        else:
            col = acc_cols[i]
            i += 1
            out.append(col.to(torch_dtype(spec.type)))
            if spec.kind in ("min", "max", "arbitrary", "bool_and", "bool_or"):
                # a surviving init sentinel marks an all-NULL group
                nulls.append(col == _accumulators_for(spec)[0][2])
            else:  # counts are 0 for empty groups, never NULL
                nulls.append(None)
    return tuple(out), tuple(nulls), bad


def _div_half_up(v: int, c: int) -> int:
    q, r = divmod(abs(v), c)
    return (q + (2 * r >= c)) * (1 if v >= 0 else -1)


def _sort_key(c):
    """A column as a sort key whose order is the SQL order and the same on
    every device: bools as int8; floats as their total-order bit patterns,
    -0.0 as 0.0 and every NaN last."""
    if c.dtype == torch.bool:
        return c.to(torch.int8)
    if not c.is_floating_point():
        return c
    f = c.to(torch.float64)
    f = torch.where(f == 0, torch.zeros_like(f), f)
    f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
    b = f.view(torch.int64)
    return torch.where(b < 0, b ^ _I64_MAX, b)


def _sorted_groups(kcols, knulls, valid):
    """The groups of a sort-based aggregation: one lexicographic sort by
    (live, key NULL, key) per key, most significant first.  Returns (the sort
    order, each row's dense group id in key order (``n`` for dead rows), the
    group count), all on the device."""
    n = valid.shape[0]
    lex = []
    for k, kn in zip(reversed(kcols), reversed(knulls)):
        lex.append(_sort_key(k))
        if kn is not None:
            lex.append(kn.to(torch.int8))
    lex.append((~valid).to(torch.int8))
    order = _lexsort(lex, n, valid.device)
    svalid = valid[order]
    new = torch.zeros((n,), dtype=torch.bool, device=valid.device)
    new[:1] = True
    for k, kn in zip(kcols, knulls):
        sk = k[order]
        diff = sk[1:] != sk[:-1]
        if kn is not None:
            skn = kn[order]
            diff = (diff & ~(skn[1:] & skn[:-1])) | (skn[1:] != skn[:-1])
        new[1:] |= diff
    new = new & svalid
    gid_sorted = torch.where(svalid, torch.cumsum(new, 0) - 1, n)
    gid = torch.empty_like(gid_sorted)
    gid[order] = gid_sorted
    return order, gid, torch.sum(new, dtype=torch.int64)


def _segments(sizes):
    """[start, end) of each group from its size (host)."""
    ends = np.cumsum(sizes)
    return zip((ends - sizes).tolist(), ends.tolist())


def _collation_rank_lut(d):
    """id -> collation-rank LUT for a values dictionary, cached on the
    Dictionary instance (ORDER BY compares decoded values)."""
    lut = getattr(d, "_rank_lut", None)
    if lut is None or len(lut) != len(d.values):
        lut = np.empty(len(d.values), np.int64)
        order = np.argsort(np.asarray(d.values, dtype=object))
        lut[order] = np.arange(len(d.values))
        object.__setattr__(d, "_rank_lut", lut)
    return lut


def _materialize_host(schema, valid, pcols, pnulls, dicts) -> MaterializedResult:
    """Host-side result decode over pulled numpy arrays."""
    names, types, columns, raw = [], [], [], []
    for i, f in enumerate(schema.fields):
        arr = np.asarray(pcols[i])[valid]
        raw.append(arr)
        dec = arr
        if isinstance(f.type, DecimalType):
            if arr.dtype == object:
                # exact wide-decimal sums (python ints past 2^63): decode
                # through Decimal so no digit is lost at the surface
                q = Decimal(10) ** f.type.scale
                dec = np.array([Decimal(int(v)) / q for v in arr.tolist()], dtype=object)
            else:
                dec = arr.astype(np.float64) / (10**f.type.scale)
        elif f.type.is_string and dicts[i] is not None:
            dec = dicts[i].decode(arr)
        elif isinstance(f.type, (ArrayType, MapType)) and dicts[i] is not None:
            dec = dicts[i].decode(arr)  # spans -> python lists / dicts
        elif f.type.name == "date":
            dec = arr.astype("datetime64[D]")
        elif isinstance(f.type, TimestampType):
            # epoch units of 10^-p seconds -> datetime64 (us up to p = 6)
            p = f.type.precision
            dec = (arr * 10 ** (6 - p)).astype("datetime64[us]") if p <= 6 \
                else (arr * 10 ** (9 - p)).astype("datetime64[ns]")
        if pnulls[i] is not None:
            nm = np.asarray(pnulls[i])[valid]
            if nm.any():
                dec = np.array([None if m else v for v, m in zip(dec.tolist(), nm)],
                               dtype=object)
        names.append(f.name)
        types.append(f.type)
        columns.append(dec)
    return MaterializedResult(tuple(names), tuple(types), columns, raw)


# -- windows ------------------------------------------------------------------------------


def _window_spec_dicts(specs, dicts):
    """Output dictionaries per window spec: value-passing kinds inherit the
    argument channel's dictionary."""
    return tuple(
        dicts[s.arg] if s.kind in ("min", "max", "lag", "lead", "first_value",
                                   "last_value") and s.arg is not None else None
        for s in specs)


def _scatter_back(res, perm):
    """Results in sorted order -> row order (``perm`` is a permutation)."""
    out = torch.empty_like(res)
    out[perm] = res
    return out


@_ranged("window")
def _window_kernel(specs, cols, nulls, valid=None):
    """Evaluate all window specs over one materialized page (``ops/window``).

    Specs with the same (partition, order) clause share one sort.  ``valid``
    (optional) marks live rows: invalid (pad) rows form their own partition,
    sorted last, so they never join a real partition; their outputs are
    garbage the caller drops."""
    from ..ops import window as W

    n = cols[0].shape[0]
    dev = cols[0].device
    pad = None if valid is None else ~valid
    cache: dict = {}

    def keyed(ch):
        """(indicator, value) sort/segment columns of a channel: NULL rows
        group together and sort by the indicator, not their fill value."""
        nm = nulls[ch]
        if nm is None:
            return [(None, cols[ch])]
        c = cols[ch]
        return [(nm, torch.where(nm, torch.zeros((), dtype=c.dtype, device=dev), c))]

    def sorted_order(s):
        kcols, desc = [], []
        if pad is not None:
            kcols.append(pad)  # pads sort after every live row
            desc.append(False)
        for c in s.partition:
            for ind, v in keyed(c):
                if ind is not None:
                    kcols.append(ind)
                    desc.append(False)
                kcols.append(v)
                desc.append(False)
        for k in s.order:
            for ind, v in keyed(k.channel):
                if ind is not None:
                    # nulls_first: the NULL indicator sorts first (descending)
                    kcols.append(ind)
                    desc.append(bool(k.nulls_first))
                kcols.append(v)
                desc.append(not k.ascending)
        perm = W.window_order(kcols, desc) if kcols \
            else torch.arange(n, dtype=torch.int64, device=dev)

        def seg_cols(channels):
            out = []
            for c in channels:
                for ind, v in keyed(c):
                    if ind is not None:
                        out.append(ind[perm])
                    out.append(v[perm])
            return out

        pad_seg = [] if pad is None else [pad[perm]]
        if s.partition or pad is not None:
            part_new = W.segments(pad_seg + seg_cols(s.partition))
        else:
            part_new = torch.zeros((n,), dtype=torch.bool, device=dev)
            part_new[:1] = True
        peer_new = part_new | W.segments(seg_cols([k.channel for k in s.order])) \
            if s.order else part_new
        return perm, part_new, peer_new

    out_cols, out_nulls = [], []
    for s in specs:
        ck = (s.partition, s.order)
        if ck not in cache:
            cache[ck] = sorted_order(s)
        perm, part_new, peer_new = cache[ck]
        framed = bool(s.order)  # ORDER BY -> running frame; else whole partition
        # explicit ROWS/RANGE BETWEEN frame: per-row [lo, hi] bounds; empty
        # frames (hi < lo) are legal and NULL
        frame = s.frame
        lo_f = hi_f = empty_f = None
        if frame is not None:
            order_vals = None
            if frame[0] == "range" and (frame[1] in ("p", "f") or frame[3] in ("p", "f")):
                # value-offset RANGE bounds: the single ORDER BY key's sorted
                # values, ascending-normalized, NULL rows pushed past the
                # reachable range so they frame only among themselves
                k0 = s.order[0]
                ov = cols[k0.channel][perm]
                if not k0.ascending:
                    ov = -ov
                nm0 = nulls[k0.channel]
                if nm0 is not None:
                    nmv = nm0[perm]
                    gap = 2 * (max(frame[2], frame[4]) + 1)
                    nn_min = torch.min(torch.where(nmv, torch.max(ov), ov))
                    nn_max = torch.max(torch.where(nmv, torch.min(ov), ov))
                    sent = nn_min - gap if bool(k0.nulls_first) else nn_max + gap
                    ov = torch.where(nmv, sent, ov)
                order_vals = ov
            lo_f, hi_f = W.frame_bounds(part_new, peer_new, frame, order_vals)
            empty_f = hi_f < lo_f

        def wsum(v, dt=None):
            if frame is not None:
                return W.framed_sum(v, lo_f, hi_f, dt)
            return (W.segmented_scan_sum(v, part_new, peer_new, dt) if framed
                    else W.partition_total(v, part_new, dt))

        def wminmax(v, kind):
            if frame is not None:
                return W.framed_minmax(v, lo_f, hi_f, kind)
            return W.segmented_scan_minmax(v, part_new, peer_new if framed else part_new,
                                           kind)

        def count_of(mask):
            return wsum(torch.where(mask, 1, 0))

        vals = vmask = None  # vmask: True where the input value counts
        if s.arg is not None:
            vals = cols[s.arg][perm]
            nm = nulls[s.arg]
            vmask = None if nm is None else ~nm[perm]

        null_out = None
        if s.kind == "row_number":
            res = W.row_number(part_new)
        elif s.kind == "rank":
            res = W.rank(part_new, peer_new)
        elif s.kind == "dense_rank":
            res = W.dense_rank(part_new, peer_new)
        elif s.kind in ("count", "count_star"):
            ones = torch.ones((n,), dtype=torch.int64, device=dev)
            if s.kind == "count" and vmask is not None:
                ones = torch.where(vmask, 1, 0)
            res = wsum(ones)  # empty frames count 0
        elif s.kind in ("sum", "avg"):
            acc_dt = torch.float64 if s.type.is_floating else torch.int64
            v = vals if vmask is None else torch.where(vmask, vals, 0)
            total = wsum(v, acc_dt)
            nn_cnt = None
            if vmask is not None:
                nn_cnt = count_of(vmask)
                null_out = nn_cnt == 0  # all-NULL (or empty) frame -> NULL
            elif empty_f is not None:
                null_out = empty_f
            if s.kind == "sum":
                res = total
            else:
                cnt = nn_cnt if nn_cnt is not None \
                    else wsum(torch.ones((n,), dtype=torch.int64, device=dev))
                cnt_safe = torch.clamp(cnt, min=1)
                if s.type.is_floating:
                    res = total / cnt_safe
                else:  # decimal avg: HALF_UP, as the aggregation path rounds
                    a = torch.abs(total)
                    q = torch.div(a, cnt_safe, rounding_mode="floor")
                    r = a - q * cnt_safe
                    res = (q + (2 * r >= cnt_safe).to(torch.int64)) * torch.sign(total)
        elif s.kind in ("min", "max"):
            v = vals
            if vmask is not None:
                ident = hashagg._extreme(vals.dtype, 1 if s.kind == "min" else -1)
                v = torch.where(vmask, vals, torch.tensor(ident, dtype=vals.dtype,
                                                          device=dev))
                null_out = count_of(vmask) == 0  # all-NULL frame -> NULL
            elif empty_f is not None:
                null_out = empty_f
            res = wminmax(v, s.kind)
        elif s.kind in ("lag", "lead"):
            off = s.offset if s.kind == "lag" else -s.offset
            fill = torch.tensor(0 if s.default is None else s.default, dtype=vals.dtype,
                                device=dev)
            if s.ignore_nulls and vmask is not None:
                # navigate over non-NULL rows only (rank arithmetic over a
                # non-null position index)
                res, miss = W.shift_ignore_nulls(vals, vmask, part_new, off, fill)
            else:
                res, miss = W.shift_in_partition(vals, part_new, off, fill)
            if s.default is None:
                null_out = miss
            else:
                res = torch.where(miss, fill, res)
                null_out = torch.zeros((n,), dtype=torch.bool, device=dev)
            if not (s.ignore_nulls and vmask is not None) and vmask is not None:
                shifted_null, _ = W.shift_in_partition(
                    ~vmask, part_new, off, torch.zeros((), dtype=torch.bool, device=dev))
                null_out = null_out | (shifted_null & ~miss)
        elif s.kind in ("percent_rank", "cume_dist"):
            size = W.partition_total(torch.ones((n,), dtype=torch.int64, device=dev),
                                     part_new)
            if s.kind == "percent_rank":
                rk = W.rank(part_new, peer_new)
                res = torch.where(size > 1, (rk - 1).to(torch.float64)
                                  / torch.clamp(size - 1, min=1), 0.0)
            else:
                pos = W._ends(peer_new) - W._starts(part_new) + 1
                res = pos.to(torch.float64) / size
        elif s.kind == "ntile":
            # the first (size % n) buckets take one extra row
            nb = s.offset
            size = W.partition_total(torch.ones((n,), dtype=torch.int64, device=dev),
                                     part_new)
            rn = W.row_number(part_new)
            q, r = size // nb, size % nb
            boundary = r * (q + 1)
            res = torch.where(rn <= boundary,
                              torch.div(rn - 1, torch.clamp(q + 1, min=1),
                                        rounding_mode="floor"),
                              r + torch.div(rn - 1 - boundary, torch.clamp(q, min=1),
                                            rounding_mode="floor")) + 1
        elif s.kind == "nth_value":
            # a frame holding fewer than k rows yields NULL; the default
            # frame is RANGE UNBOUNDED PRECEDING .. CURRENT ROW
            k = s.offset
            starts = lo_f if frame is not None else W._starts(part_new)
            frame_end = hi_f if frame is not None else W._ends(peer_new)
            if s.ignore_nulls and vmask is not None:
                res, null_out = W.framed_nth_nonnull(vals, vmask, starts, frame_end, k)
            else:
                idx = torch.clamp(starts + (k - 1), 0, n - 1)
                res = vals[idx]
                null_out = (frame_end - starts + 1) < k
                if vmask is not None:
                    null_out = null_out | ~vmask[idx]
        elif s.kind in ("first_value", "last_value"):
            starts = lo_f if frame is not None else W._starts(part_new)
            frame_end = hi_f if frame is not None \
                else W._ends(peer_new if framed else part_new)
            if s.ignore_nulls and vmask is not None:
                res, null_out = W.framed_nth_nonnull(
                    vals, vmask, starts, frame_end, 1, from_end=(s.kind == "last_value"))
            else:
                idx = torch.clamp(starts if s.kind == "first_value" else frame_end,
                                  0, n - 1)
                null_out = empty_f
                res = vals[idx]
                if vmask is not None:
                    miss = ~vmask[idx]
                    null_out = miss if null_out is None else (null_out | miss)
        else:
            raise _not_ported(f"window function {s.kind}")

        out_cols.append(_scatter_back(res, perm).to(torch_dtype(s.type)))
        out_nulls.append(None if null_out is None else _scatter_back(null_out, perm))
    return tuple(out_cols), tuple(out_nulls)
