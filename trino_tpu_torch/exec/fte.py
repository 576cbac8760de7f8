"""Fault-tolerant execution: retryable tasks over a spooled exchange
(counterpart of ``trino_tpu/exec/fte.py``; reference:
EventDrivenFaultTolerantQueryScheduler.java:209, TaskDescriptorStorage.java,
FileSystemExchangeManager.java, DeduplicatingDirectExchangeBuffer.java,
FailureInjector.java:53).

Every blocking plan node (aggregate, join, window, sort, unnest) is a
retryable fragment: its inputs replay (leaf scans generate again from their
splits; interior fragments read their children's spooled outputs), its
output spools to the local filesystem with an atomic first-commit-wins
rename, and a failed attempt retries against the same inputs.  A scan-fed
grouped aggregation also splits into per-split-batch partial tasks whose
partial-state pages merge downstream.  The task bodies are module-level
(``run_partial_aggregate``, ``run_fragment``, ``run_stream_splits``) so the
cluster's worker processes (``server/cluster.py``) run the same code; they
take the executor they run on, whose ``_host`` counts every device read.

A task's share of a scan runs through the executor's own page sources and
transforms (``LocalExecutor._split_restriction``), so a partial or probe
task sees the pages a whole scan would, pruning and compaction included.

The page codec: a frame is magic ``TTPG``, a flag byte (low bits the codec:
none, zlib, zstd; high bit AES-GCM encrypted), the CRC32 of the payload,
its length (8 bytes, little-endian), and the payload, an ``npz`` of the
page's host columns and null masks; frames are byte-compatible with the
reference's.  ``TRINO_TPU_PAGE_CODEC`` picks the codec (read at import).
Unset, it is zstd level 1 where the ``zstandard`` binding is installed and
zlib level 1 where it is not (the card machine has none); an explicit
``zstd`` without the binding fails at the first frame.
``TRINO_TPU_EXCHANGE_KEY`` (hex, 16, 24 or 32 bytes) encrypts and
authenticates frames.  A fragment output is an envelope: one frame and the
pickled dictionaries of its string columns.

``is_retryable_failure`` is the one retry classification of the port: the
retry loop, the cluster's task status and a template's probation failure
(``engine._maybe_template_execute``) consult it.  A memory failure
(``MemoryError``, the pool's refusal, ``torch.OutOfMemoryError``) in a
partial aggregation bisects its split set instead (``_is_memory_failure``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
import random
import shutil
import threading
import types
import zlib
from typing import Optional

import numpy as np
import torch

from ..execution import faults, tracing
from ..ops import hashagg
from ..page import Page, Schema
from ..sql import plan as P
from ..sql.ir import device_constants
from ..types import torch_dtype
from .local_executor import (_MERGE_KIND, DEFAULT_GROUP_CAPACITY, LocalExecutor,
                             _accumulators_for)

__all__ = ["PAGE_CODEC", "FailureInjector", "InjectedFailure", "SpoolingExchange",
           "TaskDescriptor", "FaultTolerantExecutor", "serialize_page", "deserialize_page",
           "serialize_fragment_output", "deserialize_fragment_output",
           "is_retryable_failure", "run_partial_aggregate", "run_fragment",
           "run_stream_splits", "merge_partial_outputs", "read_fragment_outputs",
           "resolve_remote_sources"]

_MAGIC = b"TTPG"
_CODECS = {"none": 0, "zlib": 1, "zstd": 2}
_ENC_FLAG = 0x80
PAGE_CODEC = os.environ.get("TRINO_TPU_PAGE_CODEC", "zstd")
if PAGE_CODEC not in _CODECS:  # pragma: no cover - config error
    raise ValueError(f"TRINO_TPU_PAGE_CODEC must be one of {sorted(_CODECS)}")
if PAGE_CODEC == "zstd" and os.environ.get("TRINO_TPU_PAGE_CODEC") is None:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        PAGE_CODEC = "zlib"


def _exchange_key():
    h = os.environ.get("TRINO_TPU_EXCHANGE_KEY")
    if not h:
        return None
    key = bytes.fromhex(h)
    if len(key) not in (16, 24, 32):
        raise ValueError("TRINO_TPU_EXCHANGE_KEY must be 16/24/32 hex bytes")
    return key


def _compress(payload: bytes, codec: int) -> bytes:
    if codec == 1:
        return zlib.compress(payload, 1)
    if codec == 2:
        import zstandard

        return zstandard.ZstdCompressor(level=1).compress(payload)
    return payload


def _decompress(payload: bytes, codec: int) -> bytes:
    if codec == 1:
        return zlib.decompress(payload)
    if codec == 2:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(payload)
    return payload


def serialize_page(columns, null_masks, compress: bool = True) -> bytes:
    """One frame of host columns and null masks (numpy arrays; a caller
    with device tensors reads them first, through its executor's counted
    ``_host``)."""
    arrays = {}
    for i, c in enumerate(columns):
        if isinstance(c, torch.Tensor):
            raise TypeError("serialize_page takes host arrays: read device "
                            "tensors through LocalExecutor._host first")
        arrays[f"c{i}"] = c
        if null_masks[i] is not None:
            arrays[f"n{i}"] = null_masks[i]
    buf = io.BytesIO()
    np.savez(buf, ncols=np.int64(len(columns)), **arrays)
    codec = _CODECS[PAGE_CODEC] if compress else 0
    payload = _compress(buf.getvalue(), codec)
    flag = codec
    key = _exchange_key()
    if key is not None:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        nonce = os.urandom(12)
        # the frame prefix is the AAD: a frame cannot be relabelled
        flag = codec | _ENC_FLAG
        payload = nonce + AESGCM(key).encrypt(nonce, payload, _MAGIC + bytes([flag]))
    crc = zlib.crc32(payload)
    return _MAGIC + bytes([flag]) + crc.to_bytes(4, "little") \
        + len(payload).to_bytes(8, "little") + payload


def deserialize_page(data: bytes):
    """-> (columns, null_masks) as numpy arrays; raises on a bad magic, a
    checksum mismatch, a missing key or a failed authentication."""
    if data[:4] != _MAGIC:
        raise ValueError("bad page frame magic")
    flag = data[4]
    crc = int.from_bytes(data[5:9], "little")
    length = int.from_bytes(data[9:17], "little")
    payload = data[17:17 + length]
    if zlib.crc32(payload) != crc:
        raise ValueError("page frame checksum mismatch")
    codec = flag & ~_ENC_FLAG
    if flag & _ENC_FLAG:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        key = _exchange_key()
        if key is None:
            raise ValueError("page frame is encrypted but TRINO_TPU_EXCHANGE_KEY is not set")
        payload = AESGCM(key).decrypt(payload[:12], payload[12:], _MAGIC + bytes([flag]))
    # allow_pickle: exact wide-decimal (object) columns pickle inside the
    # npz; frames are read only from the spill directory this process wrote
    z = np.load(io.BytesIO(_decompress(payload, codec)), allow_pickle=True)
    n = int(z["ncols"])
    cols = [z[f"c{i}"] for i in range(n)]
    nulls = [z[f"n{i}"] if f"n{i}" in z.files else None for i in range(n)]
    return cols, nulls


def is_retryable_failure(e: BaseException) -> bool:
    """Task-retry classification, the reference's (retry policies consult
    the error kind: USER_ERROR against INTERNAL and EXTERNAL, spi/ErrorType
    .java).  A deterministic error (bad SQL, an unsupported feature, a
    planner fault, a query past its memory limit, a fatal injected fault)
    fails alike on every attempt, so a retry burns the budget and hides the
    message; anything else (connector IO, a transient device error, a
    retryable injected fault) may retry.  A query the cluster's low-memory
    policy killed (``QueryKilledError``) would meet the same pressure."""
    from ..execution.faults import FatalInjectedFaultError
    from ..memory import QueryKilledError, QueryMemoryLimitError
    from ..spi.security import AccessDeniedError
    from ..sql.analyzer import SemanticError
    from ..sql.parser import ParseError

    deterministic = (SemanticError, ParseError, AccessDeniedError, NotImplementedError,
                     AssertionError, AttributeError, NameError, QueryKilledError,
                     QueryMemoryLimitError, FatalInjectedFaultError)
    return isinstance(e, Exception) and not isinstance(e, deterministic)


# -- the fragment-output envelope ------------------------------------------------------
def serialize_fragment_output(cols, nulls, dicts) -> bytes:
    """One frame of host columns and the pickled dictionaries of the
    output's channels (string columns travel as dictionary ids).  The pickle
    rides the HMAC-authenticated cluster channel or this process's spool."""
    return serialize_page(cols, nulls) + pickle.dumps(dicts)


def _split_envelope(data: bytes):
    """(frame bytes, tail), from the frame header's payload length: the one
    place that knows the envelope's layout."""
    length = int.from_bytes(data[9:17], "little")
    return data[:17 + length], data[17 + length:]


def deserialize_fragment_output(data: bytes):
    """-> (columns, null_masks, dicts)."""
    frame, tail = _split_envelope(data)
    cols, nulls = deserialize_page(frame)
    return cols, nulls, pickle.loads(tail)


# -- injection ----------------------------------------------------------------------------
class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    """Deterministic failures at named points of a task (reference:
    FailureInjector.java:53-57: TASK_FAILURE, TASK_GET_RESULTS_FAILURE, ...;
    and POST_COMMIT_FAILURE after the output is durable)."""

    def __init__(self):
        self._plans: dict = {}  # (task_id, point) -> failures left

    def inject(self, task_id, point: str, times: int = 1) -> None:
        self._plans[(task_id, point)] = times

    def maybe_fail(self, task_id, point: str) -> None:
        left = self._plans.get((task_id, point), 0)
        if left > 0:
            self._plans[(task_id, point)] = left - 1
            raise InjectedFailure(f"injected {point} on task {task_id}")


# -- the spooled exchange -----------------------------------------------------------------
class SpoolingExchange:
    """A directory per exchange; each task commits one output file by an
    atomic rename, the first commit wins and a retry's duplicate is dropped
    (reference: DeduplicatingDirectExchangeBuffer)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _final(self, task_id) -> str:
        return os.path.join(self.directory, f"task_{task_id}.page")

    def commit(self, task_id, attempt: int, data: bytes) -> bool:
        """False when an earlier attempt already committed.  An
        ``exchange_write`` fault point (site ``task.<id>``), past that early
        exit so a fire means a store was attempted: ``drop`` loses the commit
        (the retry loop or the coordinator's deadline recovers it), a raise
        is a retryable task failure."""
        if os.path.exists(self._final(task_id)):
            return False
        if faults.maybe_inject("exchange_write", f"task.{task_id}") == "drop":
            return False
        tmp = os.path.join(self.directory,
                           f".task_{task_id}.attempt_{attempt}.{os.getpid()}."
                           f"{random.random():.9f}")
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            os.rename(tmp, self._final(task_id))  # atomic on POSIX
            return True
        except OSError:
            os.unlink(tmp)
            return False

    def is_committed(self, task_id) -> bool:
        return os.path.exists(self._final(task_id))

    def read(self, task_id) -> bytes:
        """A task's committed output; an ``exchange_read`` fault point."""
        faults.maybe_inject("exchange_read", f"task.{task_id}")
        with open(self._final(task_id), "rb") as f:
            return f.read()

    def spooled_bytes(self) -> int:
        """Bytes committed under this exchange's directory, its nested
        partial-aggregation exchanges included."""
        total = 0
        for root, _dirs, files in os.walk(self.directory):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
        return total


@dataclasses.dataclass(frozen=True)
class TaskDescriptor:
    """A task's replayable input (reference: TaskDescriptorStorage.java:66)."""

    task_id: int
    splits: tuple


@contextlib.contextmanager
def counted(local: LocalExecutor):
    """Fold the host reads, their bytes and the H2D bytes ``local`` makes
    inside into the counter set open on this thread (the engine folds an
    executor's counts after ``execute``; task bodies drive it past that).
    The executor's counts start from zero inside and are restored after, so
    blocks nest; a block holds at most one ``execute``, which zeroes them."""
    saved = (local.host_reads, local.host_bytes, local.h2d_bytes)
    local.host_reads = local.host_bytes = local.h2d_bytes = 0
    try:
        yield
    finally:
        c = tracing.current_counters()
        if c is not None:
            c.host_reads += local.host_reads
            c.host_bytes += local.host_bytes
            c.h2d_bytes += local.h2d_bytes
        local.host_reads, local.host_bytes, local.h2d_bytes = saved


def _spine_scan(node):
    """The TableScan under a pure Filter/Project chain, or None."""
    while isinstance(node, (P.Filter, P.Project)):
        node = node.child
    return node if isinstance(node, P.TableScan) else None


@contextlib.contextmanager
def _restricted(local: LocalExecutor, scan, splits):
    """Compile and run ``scan`` over ``splits`` only, inside."""
    saved = local._split_restriction
    if scan is not None and splits is not None:
        local._split_restriction = {**saved, id(scan): list(splits)}
    try:
        yield
    finally:
        local._split_restriction = saved


def _host_rows(local: LocalExecutor, page: Page, site: str):
    """The live rows of ``page`` as host (cols, nulls), in one read."""
    valid, pcols, pnulls = local._host_page(page, site=site)
    cols = [np.asarray(c)[valid] for c in pcols]
    nulls = [None if (n is None or not np.asarray(n)[valid].any()) else np.asarray(n)[valid]
             for n in pnulls]
    return cols, nulls


# -- the executor ---------------------------------------------------------------------------
class FaultTolerantExecutor:
    """Executes plans with task-level retries (reference: RetryPolicy.TASK,
    task_retry_attempts_per_task): every blocking node is a retryable
    fragment over replayable inputs, and a scan-fed grouped aggregation
    splits into per-split-batch partial tasks merged downstream.  ``device``
    is the executor's (None: the card, raising without one); the private
    executor shares ``memory_pool`` and ``buffer_pool`` when given."""

    _FRAGMENT_NODES = (P.Aggregate, P.Join, P.Window, P.Sort, P.Unnest)

    def __init__(self, catalogs: dict, spool_dir: str,
                 injector: Optional[FailureInjector] = None,
                 max_attempts: int = 4, splits_per_task: int = 2, device=None,
                 memory_pool=None, buffer_pool=None):
        from ..engine import _resolve_device

        self.catalogs = catalogs
        self.spool_dir = spool_dir
        self.injector = injector or FailureInjector()
        self.max_attempts = max_attempts
        self.splits_per_task = splits_per_task
        self.local = LocalExecutor(catalogs, _resolve_device(device),
                                   memory_pool=memory_pool, buffer_pool=buffer_pool)
        self._exchange_seq = 0
        self.task_attempts: dict = {}  # task -> attempts used
        self.adaptive_swaps = 0
        self.last_spool_bytes = 0  # bytes the last query committed to its spool
        # fragment outputs install into the private executor's overrides:
        # queries run one at a time
        self._lock = threading.Lock()

    # -- public ----------------------------------------------------------------
    def execute(self, plan: P.PlanNode, dispatch_batch=None):
        """Run ``plan`` to a ``MaterializedResult``; the private executor
        coalesces at ``dispatch_batch`` (None: the process default) for this
        query."""
        local = self.local
        with self._lock:
            local.dispatch_batch = dispatch_batch
            local._overrides = {}
            self._task_seq = 0
            self._exchange_seq += 1
            self._exchange = SpoolingExchange(
                os.path.join(self.spool_dir, f"exchange_{os.getpid()}_{self._exchange_seq}"))
            try:
                local._reset_stats(plan)
                with counted(local), device_constants(local._count_h2d):
                    self._exec_ft(plan)
                    page, dd = local._execute_to_page(plan)
                    return local._materialize(page, dd)
            finally:
                local._overrides = {}
                local.dispatch_batch = None
                local.close_producers()
                local._release_reserved()
                # the spool is the query's durable state, not a cache: a
                # long-lived engine must not grow its temporary disk per query
                self.last_spool_bytes = self._exchange.spooled_bytes()
                shutil.rmtree(self._exchange.directory, ignore_errors=True)

    # -- fragments ---------------------------------------------------------------
    def _exec_ft(self, node: P.PlanNode) -> None:
        """Bottom-up: every blocking fragment's output becomes durable, so
        each fragment task's inputs replay."""
        for c in node.children:
            self._exec_ft(c)
        if not isinstance(node, self._FRAGMENT_NODES):
            return
        # fragment ids ("frag0", ...) keep apart from the partial tasks'
        # integer ids inside an aggregation
        tid = f"frag{self._task_seq}"
        self._task_seq += 1
        if isinstance(node, P.Aggregate) and node.keys \
                and not any(s.kind in P.SORTED_AGG_KINDS for s in node.aggs) \
                and self._scan_fed(node.child):
            page, agg_dicts = self._run_fte_aggregate(node)
            data = self._serialize_result(page)
            dicts = self._commit_with_retries(tid, lambda: (data, agg_dicts))
        else:
            exec_node = self._maybe_swap_join(node)

            def compute(node=exec_node, tid=tid):
                self.injector.maybe_fail(tid, "TASK_FAILURE")
                page, dd = self.local._execute_to_page(node)
                data = self._serialize_result(page)
                self.injector.maybe_fail(tid, "TASK_GET_RESULTS_FAILURE")
                return data, dd

            dicts = self._commit_with_retries(tid, compute)
        cols, nulls = deserialize_page(self._exchange.read(tid))
        from .spill import padded_page

        self.local._overrides[id(node)] = (padded_page(node.schema, cols, nulls, self.local),
                                           dicts)

    def _maybe_swap_join(self, node):
        """Adaptive replanning (reference: AdaptivePlanner.java:121): when
        both children of an inner equi-join are materialized fragments and
        the build side came out clearly larger than the probe, the sides
        swap, and a projection restores the column order."""
        from ..sql import ir

        if not isinstance(node, P.Join) or node.kind != "inner" \
                or node.filter is not None or not node.left_keys:
            return node

        def actual_rows(child):
            while isinstance(child, P.Project):  # row-preserving wrappers
                child = child.child
            hit = self.local._overrides.get(id(child))
            return None if hit is None else hit[0].capacity

        lr, rr = actual_rows(node.left), actual_rows(node.right)
        if lr is None or rr is None or rr <= 2 * max(lr, 1):
            return node
        self.adaptive_swaps += 1
        lf = tuple(node.left.schema.fields)
        rf = tuple(node.right.schema.fields)
        swapped = P.Join("inner", node.right, node.left, node.right_keys, node.left_keys,
                         Schema(rf + lf), distribution=node.distribution,
                         est_rows=node.est_rows)
        exprs = tuple(ir.FieldRef(len(rf) + i, f.type, f.name) for i, f in enumerate(lf)) \
            + tuple(ir.FieldRef(i, f.type, f.name) for i, f in enumerate(rf))
        return P.Project(swapped, exprs, node.schema)

    def _scan_fed(self, node) -> bool:
        """A pure stream over one scan with no fragment below: a join-fed
        aggregate reads the join's spooled output instead of replaying it."""
        def has_fragment(n):
            return isinstance(n, self._FRAGMENT_NODES) or any(has_fragment(c)
                                                              for c in n.children)

        if has_fragment(node) or _spine_scan(node) is None:
            return False
        try:
            stream = self.local._compile_stream(node)
        except NotImplementedError:
            return False
        return stream.scan_info is not None and bool(stream.scan_info.splits)

    def _serialize_result(self, page: Page) -> bytes:
        cols, nulls = _host_rows(self.local, page, "fte.result")
        return serialize_page(cols, nulls)

    def _commit_with_retries(self, task_id, compute):
        return self._retry_loop(task_id, self._exchange, compute)

    def _retry_loop(self, task_id, exchange, compute):
        """The one retry, classify, dedup and exhaust policy of both task
        shapes.  ``compute`` returns bytes or (bytes, side payload); the
        side payload of the attempt that committed comes back."""
        last_error = None
        extra = None
        for attempt in range(self.max_attempts):
            self.task_attempts[task_id] = attempt + 1
            if attempt:
                tracing.record_task_retry(site="fte.task.retry")
            try:
                out = compute()
                data, extra = out if isinstance(out, tuple) else (out, None)
                exchange.commit(task_id, attempt, data)
                if not exchange.is_committed(task_id):
                    # a lost commit (an exchange_write drop): success here
                    # would leave the reader a missing file
                    raise RuntimeError(f"task {task_id} output commit did not become "
                                       f"visible (attempt {attempt + 1})")
                # a failure after the commit must not duplicate the output
                self.injector.maybe_fail(task_id, "POST_COMMIT_FAILURE")
                return extra
            except Exception as e:
                if not is_retryable_failure(e):
                    raise
                last_error = e
                if exchange.is_committed(task_id):
                    return extra  # durable: a retry would be dropped anyway
        raise RuntimeError(f"task {task_id} failed after {self.max_attempts} attempts: "
                           f"{last_error}") from last_error

    # -- stage 1: partial aggregation tasks ------------------------------------
    def _run_fte_aggregate(self, node: P.Aggregate):
        stream, key_types, acc_specs, _, acc_kinds, step = self.local._agg_compiled(node)
        splits = list(stream.scan_info.splits)
        k = self.splits_per_task
        tasks = [TaskDescriptor(i, tuple(splits[i * k:(i + 1) * k]))
                 for i in range((len(splits) + k - 1) // k)]
        # nested under the query's exchange: its cleanup removes them too
        exchange = SpoolingExchange(os.path.join(self._exchange.directory,
                                                 f"agg_{self._task_seq}"))
        for task in tasks:
            def compute(task=task):
                self.injector.maybe_fail(task.task_id, "TASK_FAILURE")
                data = run_partial_aggregate_splits(self.local, node, key_types,
                                                    acc_specs, task.splits)
                self.injector.maybe_fail(task.task_id, "TASK_GET_RESULTS_FAILURE")
                return data

            self._retry_loop(task.task_id, exchange, compute)
        payloads = [exchange.read(t.task_id) for t in tasks]
        return merge_partial_pages(self.local, node, stream, key_types, acc_specs, acc_kinds,
                                   payloads)


# -- task bodies --------------------------------------------------------------------------
# Module-level, so the cluster's worker processes run the same code as the
# in-process tasks (reference: one binary, the role set by configuration).

def _is_memory_failure(e: BaseException) -> bool:
    """Device or host memory exhaustion: the task retries at a smaller
    footprint (reference: ExponentialGrowthPartitionMemoryEstimator.java:57).
    A policy kill or a query's own limit does not shrink."""
    from ..memory import MemoryPoolExhaustedError, QueryKilledError, QueryMemoryLimitError

    if isinstance(e, (QueryKilledError, QueryMemoryLimitError)):
        return False
    oom = getattr(torch, "OutOfMemoryError", None) or torch.cuda.OutOfMemoryError
    return isinstance(e, (MemoryError, MemoryPoolExhaustedError, oom))


def _state_bytes(capacity: int, key_types, acc_specs) -> int:
    key_w = sum(np.dtype(t.dtype).itemsize + 1 for t in key_types)
    acc_w = sum(np.dtype(dt).itemsize for dt, _ in acc_specs)
    return (capacity + 1) * (8 + key_w + acc_w)


def run_partial_aggregate_splits(local: LocalExecutor, node, key_types, acc_specs, splits,
                                 tick=None) -> bytes:
    """Partial aggregation over a split subset -> a framed partial page
    (keys and raw accumulators).  A memory failure bisects the split set and
    merges the halves' partial states: the task retries at half its working
    set instead of failing alike."""
    try:
        return _partial_once(local, node, key_types, acc_specs, splits, tick)
    except Exception as e:
        if not _is_memory_failure(e) or len(splits) <= 1:
            raise
        mid = len(splits) // 2
        a = run_partial_aggregate_splits(local, node, key_types, acc_specs, splits[:mid], tick)
        b = run_partial_aggregate_splits(local, node, key_types, acc_specs, splits[mid:], tick)
        return _merge_partial_raw(local, node, key_types, acc_specs, [a, b])


def _partial_once(local: LocalExecutor, node, key_types, acc_specs, splits,
                  tick=None) -> bytes:
    """One pass of ``node``'s input over ``splits`` into hash-mode group-by
    state (``LocalExecutor._agg_compiled``'s step), reserved from the
    executor's pool; an overflow starts again at 4x the capacity."""
    capacity = node.capacity or DEFAULT_GROUP_CAPACITY
    key_dtypes = tuple(t.dtype for t in key_types)
    pool = local.memory_pool
    with _restricted(local, _spine_scan(node.child), splits):
        stream, _, _, _, _, step = local._agg_compiled(node)
        while True:
            nbytes = _state_bytes(capacity, key_types, acc_specs)
            pool.reserve(nbytes, "group-by")
            try:
                state = hashagg.groupby_init(capacity, key_dtypes, acc_specs,
                                             device=local.device)
                for page in stream.pages():
                    state = step(state, page, stream.aux)
                    if tick is not None:
                        tick()  # a split boundary: the fair scheduler's preemption point
                if not bool(local._host([state.overflow], "fte.partial.overflow")[0]):
                    return _serialize_partial_state(local, node, state, len(node.keys))
            finally:
                pool.free(nbytes, "group-by")
            capacity *= 4


def _serialize_partial_state(local: LocalExecutor, node, state, nk) -> bytes:
    n_groups = int(local._host([hashagg.group_count(state)], "fte.partial.count")[0])
    bucket = max(1 << max(n_groups - 1, 1).bit_length(), 64)
    keys, key_nulls, accs = hashagg.compact_groups(state, bucket)
    got = local._host(list(keys) + list(key_nulls) + list(accs), site="fte.partial.groups")
    cols = [g[:n_groups] for g in got[:nk]] + [g[:n_groups] for g in got[2 * nk:]]
    nulls = [g[:n_groups] for g in got[nk:2 * nk]] + [None] * len(accs)
    nulls = [n if (n is not None and n.any()) else None for n in nulls]
    return serialize_page(cols, nulls)


def _merge_partial_state(local: LocalExecutor, key_types, acc_specs, merge_kinds, nk,
                         payloads):
    """Framed partial pages -> one populated group-by state (the loop both
    merge shapes share); the table starts at twice their rows."""
    pages = [deserialize_page(d) for d in payloads]
    pages = [(c, n) for c, n in pages if c and c[0].shape[0]]
    rows = sum(c[0].shape[0] for c, _ in pages)
    capacity = max(DEFAULT_GROUP_CAPACITY, 1 << max(2 * rows - 1, 1).bit_length())
    key_dtypes = tuple(t.dtype for t in key_types)
    while True:
        state = hashagg.groupby_init(capacity, key_dtypes, acc_specs, device=local.device)
        for cols, nulls in pages:
            kcols = tuple(local._to_device(c, torch_dtype(t))
                          for c, t in zip(cols[:nk], key_types))
            knulls = tuple(None if m is None else local._to_device(m) for m in nulls[:nk])
            accs = [(local._to_device(c), None) for c in cols[nk:]]
            valid = torch.ones((cols[0].shape[0],), dtype=torch.bool, device=local.device)
            state = hashagg.groupby_insert(state, kcols, key_types, valid, accs,
                                           merge_kinds, knulls)
        if not bool(local._host([state.overflow], "fte.merge.overflow")[0]):
            return state
        capacity *= 4


def _acc_layout(node):
    acc_specs, acc_kinds = [], []
    for spec in node.aggs:
        for kind, dtype, init in _accumulators_for(spec):
            acc_specs.append((dtype, init))
            acc_kinds.append(kind)
    return acc_specs, acc_kinds


def _merge_partial_raw(local: LocalExecutor, node, key_types, acc_specs, payloads) -> bytes:
    """Partial pages -> one partial page (the accumulators stay raw: the
    final merge finalizes)."""
    _, acc_kinds = _acc_layout(node)
    merge_kinds = [_MERGE_KIND[k] for k in acc_kinds]
    nk = len(node.keys)
    state = _merge_partial_state(local, key_types, acc_specs, merge_kinds, nk, payloads)
    return _serialize_partial_state(local, node, state, nk)


def run_partial_aggregate(local: LocalExecutor, node, splits, exchange_dir: str = None,
                          stream_sources=None, fetch_stream=None, tick=None) -> bytes:
    """Worker entry: the partial task over ``splits``, its output envelope
    carrying the group keys' dictionaries, so the coordinator merges without
    compiling the input itself.  RemoteSource children resolve from the
    exchange, like the other task bodies'."""
    saved = local._overrides
    if exchange_dir is not None:
        local._overrides = resolve_remote_sources(local, exchange_dir, node, stream_sources,
                                                  fetch_stream)
    try:
        with device_constants(local._count_h2d):
            with _restricted(local, _spine_scan(node.child), splits):
                stream, key_types, acc_specs, _, _, _ = local._agg_compiled(node)
            data = run_partial_aggregate_splits(local, node, key_types, acc_specs,
                                                list(splits), tick)
        key_dicts = tuple(stream.dicts[i] for i in node.keys)
    finally:
        local._overrides = saved
    return data + pickle.dumps(key_dicts)


# -- fragment task bodies (the cluster) -------------------------------------------------
def _empty_page(local: LocalExecutor, schema):
    from .spill import padded_page

    cols = [np.empty((0,), np.dtype(f.type.dtype)) for f in schema.fields]
    return (padded_page(schema, cols, [None] * len(cols), local),
            tuple(None for _ in schema.fields))


def read_fragment_outputs(local: LocalExecutor, exchange: SpoolingExchange, task_ids, schema):
    """The spooled outputs of a fragment's tasks as one override page on
    ``local``'s device (the ExchangeOperator's gather, filesystem edition).
    No task (a source with no split) gives an empty page."""
    from .spill import concat_host_chunks, padded_page

    if not task_ids:
        return _empty_page(local, schema)
    with tracing.maybe_span("exchange.read", tasks=len(task_ids)):
        parts = []
        for t in task_ids:
            # one in-flight entry per read: a long fan-in that progresses
            # never reads as a stall
            with tracing.inflight("exchange-segment", site="exchange.read"):
                data = exchange.read(t)
            parts.append(deserialize_fragment_output(data))
    cols, nulls = concat_host_chunks(schema, [(p[0], p[1]) for p in parts])
    return padded_page(schema, cols, nulls, local), parts[0][2]


def read_streamed_outputs(local: LocalExecutor, fetch_stream, task_ids, schema):
    """A RemoteSource's output from the producing workers' streaming
    buffers instead of the spool (reference: ExchangeOperator over
    HttpPageBufferClient): ``fetch_stream(task_id)`` yields envelopes as the
    producer emits them."""
    from .spill import concat_host_chunks, padded_page

    parts = []
    for t in task_ids:
        with tracing.maybe_span("exchange.stream", task=str(t)) as sp:
            n0 = len(parts)
            it = iter(fetch_stream(t))
            while True:
                # one in-flight entry per chunk: a stream that keeps
                # delivering never ages into a stall
                with tracing.inflight("exchange-segment", site="exchange.stream"):
                    chunk = next(it, None)
                if chunk is None:
                    break
                parts.append(deserialize_fragment_output(chunk))
            if sp is not None:
                sp.attributes["pages"] = len(parts) - n0
    if not parts:
        return _empty_page(local, schema)
    cols, nulls = concat_host_chunks(schema, [(p[0], p[1]) for p in parts])
    return padded_page(schema, cols, nulls, local), parts[0][2]


def resolve_remote_sources(local: LocalExecutor, exchange_dir: str, node,
                           stream_sources=None, fetch_stream=None) -> dict:
    """Overrides for every RemoteSource under ``node``: each one's task
    outputs read from the spool, or, where its task ids are in
    ``stream_sources``, fetched live from the producers through
    ``fetch_stream`` (the pipelined exchange; no disk)."""
    overrides = {}

    def walk(n):
        if isinstance(n, P.RemoteSource):
            if stream_sources and fetch_stream is not None \
                    and all(t in stream_sources for t in n.task_ids):
                overrides[id(n)] = read_streamed_outputs(local, fetch_stream, n.task_ids,
                                                         n.schema)
            else:
                overrides[id(n)] = read_fragment_outputs(
                    local, SpoolingExchange(exchange_dir), n.task_ids, n.schema)
        for c in n.children:
            walk(c)

    walk(node)
    return overrides


def run_fragment(local: LocalExecutor, node, exchange_dir: str, stream_sources=None,
                 fetch_stream=None) -> bytes:
    """Worker entry: a blocking fragment (sort, window, join, an aggregate
    over a join ...) whose RemoteSource leaves resolve from the spool or the
    producers' buffers -> its output envelope.  The task has the executor
    to itself (overrides are executor state)."""
    saved = local._overrides
    local._overrides = resolve_remote_sources(local, exchange_dir, node, stream_sources,
                                              fetch_stream)
    try:
        with device_constants(local._count_h2d):
            page, dicts = local._execute_to_page(node)
            cols, nulls = _host_rows(local, page, "fte.fragment")
    finally:
        local._overrides = saved
    return serialize_fragment_output(cols, nulls, dicts)


def run_stream_splits(local: LocalExecutor, node, exchange_dir: str, splits,
                      stream_sources=None, fetch_stream=None, sink=None, tick=None) -> bytes:
    """Worker entry: a streaming fragment (a join's probe pipeline) over a
    subset of its probe scan's splits, its build side run on this worker.
    With ``sink`` each split's surviving rows ship as their own envelope as
    soon as they exist, and the return value is empty."""
    from .spill import concat_host_chunks

    saved = local._overrides
    local._overrides = resolve_remote_sources(local, exchange_dir, node, stream_sources,
                                              fetch_stream)
    probe = node.left if isinstance(node, P.Join) else node
    try:
        with device_constants(local._count_h2d), \
                _restricted(local, _spine_scan(probe), splits):
            stream = local._compile_stream(node)
            parts = []
            for page in stream.pages():
                cols, nulls, valid = stream.run(page)
                ncols = len(cols)
                got = local._host([valid] + list(cols) + [n for n in nulls if n is not None],
                                  site="fte.stream.split")
                v = got[0]
                ccols = [c[v] for c in got[1:1 + ncols]]
                rest = got[1 + ncols:]
                cnulls = [None if n is None else rest.pop(0)[v] for n in nulls]
                if sink is not None:
                    sink(serialize_fragment_output(ccols, cnulls, stream.dicts))
                else:
                    parts.append((ccols, cnulls))
                if tick is not None:
                    tick()  # a split boundary: the fair scheduler's preemption point
            dicts = stream.dicts
    finally:
        local._overrides = saved
    if sink is not None:
        return b""
    cols, nulls = concat_host_chunks(stream.schema, parts)
    return serialize_fragment_output(cols, nulls, dicts)


def merge_partial_outputs(local: LocalExecutor, node, payloads):
    """The final aggregation over partial-output envelopes (the coordinator
    side): the merge's layout comes from the plan alone and the key
    dictionaries from the envelopes, so the coordinator never compiles the
    input (which would build join tables just to merge)."""
    key_types = tuple(node.child.schema.fields[i].type for i in node.keys)
    acc_specs, acc_kinds = _acc_layout(node)
    key_dicts = None
    frames = []
    for data in payloads:
        frame, tail = _split_envelope(data)
        frames.append(frame)
        if key_dicts is None:
            key_dicts = pickle.loads(tail)
    child_dicts = [None] * len(node.child.schema.fields)
    for ch, d in zip(node.keys, key_dicts or ()):
        child_dicts[ch] = d
    return _merge_partial_cols(local, node, types.SimpleNamespace(dicts=tuple(child_dicts)),
                               key_types, acc_specs, acc_kinds, frames)


def merge_partial_pages(local: LocalExecutor, node, stream, key_types, acc_specs, acc_kinds,
                        payloads):
    """The final aggregation over framed partial pages (in-process FTE)."""
    return _merge_partial_cols(local, node, stream, key_types, acc_specs, acc_kinds, payloads)


def _merge_partial_cols(local: LocalExecutor, node, stream, key_types, acc_specs, acc_kinds,
                        payloads):
    """Merge the partial pages and finalize the groups on the device, as
    the executor's own aggregation does (``_finalize_groups``: exact wide
    decimal sums included) -> (page, dicts)."""
    merge_kinds = [_MERGE_KIND[k] for k in acc_kinds]
    state = _merge_partial_state(local, key_types, acc_specs, merge_kinds, len(node.keys),
                                 payloads)
    return local._finalize_groups(node, stream, state)
