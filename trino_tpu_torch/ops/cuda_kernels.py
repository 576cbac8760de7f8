"""The port's hand-written CUDA kernels, their plain PyTorch versions, and the
one chokepoint that picks between them (counterpart of
``trino_tpu/ops/pallas_kernels.py``).

Four kernels, each in its own source under
``trino_tpu_torch/csrc/`` (the source note at the top of each file says which
TPU kernel it replaces, what bounds it on the card and what its design does
about that):

- ``hash_insert`` / ``hash_insert_`` (``csrc/hash_insert.cu``)
  open-addressing insert, into a copy or in place;
- ``hash_probe``   (``csrc/hash_probe.cu``)   open-addressing probe, hashing
  each key in the kernel (``csrc/hashing.cuh``, shared with the insert);
- ``compact_rows`` (``csrc/compact_rows.cu``) order-preserving compaction;
- ``fused_segment_agg`` (``csrc/segment_agg.cu``) per-slot counts and
  float32 sums in one pass.  Like its TPU counterpart it has no caller in
  the engine; it is held to its own contract.

The choice follows the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  There is no fallback
and no switch.  Each wrapper is a ``dispatch`` fault point
(``execution/faults``, site = the kernel's name) before that choice: an
injected fault raises there, and the wrapper then launches nothing and runs
no plain version; disarmed, the point is one global read.  The plain versions are the torch form of the reference's XLA
paths; the tests and ``chip_smoke.py`` compare against them.

Build: at first use on the card, ``nvcc`` compiles each source (all started
together) into a shared library with a plain C interface under
``build/trino_tpu_torch/`` beside the package, keyed by the hash of the source
and of every header it includes (``#include "..."``), and ``ctypes`` loads
it.  Kernels launch on ``torch.cuda.current_stream()``, do not synchronise,
allocate nothing (the wrappers allocate outputs and scratch with torch; a C
entry may zero them with a memset on the stream), and each C entry returns
``cudaGetLastError()``.

Each wrapper counts its launches in ``STATS[name].launches`` (under a lock:
statements on several threads launch at once) and records the shapes it
launched at in ``STATS[name].shapes``; it charges the launch to the counters
of the statement running on its thread too (``execution/tracing``), and, while a profiler
records, opens a ``torch.profiler.record_function`` range named after its
kernel, so a profile attributes the wrapper's host time and every device
operation it causes (allocations' fills, copies) to it.

Inside ``recording_launches()`` (the scan-fused runners' CUDA graph capture
and its eager warm-up) a launch is not counted: ``_launch`` appends its
(kernel, shape) to the recording instead.  The warm-up's recording is
charged once (``charge_launches``: to ``STATS``, to the statement's counters
and to the operator scope), and each replay of the captured graph charges
the capture's recording once, as if the body's kernels had been launched
one by one.

Every launch goes through ``_launch``, which holds an in-flight ``dispatch``
entry (``tracing.INFLIGHT``) around the C entry's call: the enqueue, not the
kernel's run (launches are asynchronous; a hung kernel shows at the next
synchronising host read).  The launch that finds the libraries unbuilt runs
``build_kernels`` inside its entry, flagged ``compiling``, and each library
built or loaded then is one record of the compile log
(``tracing.record_compile``: its nvcc seconds, its bytes, its source digest,
``cached`` when the build cache served it), charged to the statement and the
wrapper that triggered it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch
from torch.profiler import record_function

from ..execution import faults, tracing
from .hashing import EMPTY_KEY, probe_step, splitmix64

__all__ = ["hash_insert", "hash_insert_", "hash_probe", "compact_rows", "fused_segment_agg",
           "hash_insert_plain", "hash_insert_plain_", "hash_probe_plain",
           "compact_rows_plain",
           "fused_segment_agg_plain", "build_kernels", "STATS", "reset_stats",
           "recording_launches", "charge_launches",
           "MAX_PROBES", "SEGMENT_SLOTS_MAX"]

MAX_PROBES = 64  # must match ops/hashagg.py / ops/hashjoin.py
SEGMENT_SLOTS_MAX = 128  # fused_segment_agg's slot ceiling (the reference's)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "trino_tpu_torch")
_SHAPES_KEPT = 4096
_COMPACT_TILE = 4096  # rows per tile of csrc/compact_rows.cu (kThreads * kItems)


@dataclasses.dataclass
class KernelStats:
    """Launch count and launch shapes of one kernel wrapper."""

    name: str
    source: str  # path in the repo
    replaces: str  # the TPU kernel it replaces (file:line of its entry)
    launches: int = 0
    shapes: list = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False, compare=False)

    def record(self, shape: tuple, seconds) -> None:
        """One launch at ``shape`` whose C entry took ``seconds`` of host time
        (None: a launch inside a graph replay, which has no C entry of its
        own and stays out of the latency histogram)."""
        with self._lock:
            self.launches += 1
            if len(self.shapes) < _SHAPES_KEPT:
                self.shapes.append(shape)
        tracing.record_launch(self.name, seconds)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.shapes.clear()


STATS = {
    "hash_insert": KernelStats("hash_insert", "trino_tpu_torch/csrc/hash_insert.cu",
                               "trino_tpu/ops/pallas_kernels.py:315"),
    "hash_probe": KernelStats("hash_probe", "trino_tpu_torch/csrc/hash_probe.cu",
                              "trino_tpu/ops/pallas_kernels.py:221"),
    "compact_rows": KernelStats("compact_rows", "trino_tpu_torch/csrc/compact_rows.cu",
                                "trino_tpu/ops/pallas_kernels.py:467"),
    "fused_segment_agg": KernelStats("fused_segment_agg",
                                     "trino_tpu_torch/csrc/segment_agg.cu",
                                     "trino_tpu/ops/pallas_kernels.py:579"),
}

_SIGNATURES = {
    # entry: (source, argtypes)
    "trino_hash_insert": ("hash_insert.cu", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]),
    "trino_hash_probe": ("hash_probe.cu", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]),
    "trino_compact_rows": ("compact_rows.cu", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]),
    "trino_segment_agg": ("segment_agg.cu", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
}

_lock = threading.Lock()
_entries: dict = {}  # C entry name -> ctypes function


def reset_stats() -> None:
    for s in STATS.values():
        s.reset()


_RECORDING = threading.local()


@contextlib.contextmanager
def recording_launches():
    """Record this thread's launches as (kernel, shape) pairs instead of
    counting them: the list the context yields."""
    prev = getattr(_RECORDING, "launches", None)
    rec: list = []
    _RECORDING.launches = rec
    try:
        yield rec
    finally:
        _RECORDING.launches = prev


def charge_launches(recorded) -> None:
    """Count one replay of a captured body that holds the launches
    ``recorded`` (from ``recording_launches``)."""
    for kernel, shape in recorded:
        STATS[kernel].record(shape, None)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME)")
    return found


def _tmp_name(path: str) -> str:
    """This process's temporary name for a build output at ``path``."""
    return f"{path}.{os.getpid()}.tmp"


def source_digest(path: str) -> str:
    """Hash of a source and, recursively, of every header it includes with
    ``#include "..."`` (resolved beside the including file): the build key,
    so an edit of a shared header rebuilds every library that includes it."""
    h = hashlib.sha256()
    seen = set()

    def add(p):
        if p in seen:
            return
        seen.add(p)
        with open(p, "rb") as f:
            text = f.read()
        h.update(text)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            add(os.path.normpath(os.path.join(os.path.dirname(p), inc.decode())))

    add(os.path.normpath(path))
    return h.hexdigest()[:16]


def build_kernels(site: str = "build") -> dict:
    """Compile every source not yet built (one nvcc each, all started
    together) and load the C entries.  Returns {"seconds": build wall time,
    "log": per source, ``-Xptxas -v``'s register and shared-memory report,
    "libraries": per source {"seconds", "bytes", "digest", "cached"}}.  The
    report is kept beside each library (``<lib>.log``), so a build served
    from the cache returns it too.  Each library is one compile-log record
    under ``site`` (the kernel wrapper whose launch triggered the build):
    its nvcc seconds, or, served from the cache, the seconds it took to
    load.  Once every entry is loaded it returns at once and records
    nothing: a thread that lost the race to build waits on the lock and
    leaves the winner's records alone."""
    with _lock:
        if all(entry in _entries for entry in _SIGNATURES):
            return {"seconds": 0.0, "log": {}, "libraries": {}}
        t0 = time.perf_counter()
        os.makedirs(_BUILD, exist_ok=True)
        sources = sorted({src for src, _ in _SIGNATURES.values()})
        libs, digests, procs, ends = {}, {}, {}, {}
        for src in sources:
            path = os.path.join(_CSRC, src)
            digests[src] = source_digest(path)
            out = os.path.join(_BUILD, f"{src[:-3]}_{digests[src]}.so")
            libs[src] = out
            if os.path.exists(out) and os.path.exists(out[:-3] + ".log"):
                continue
            # temporary names are this process's own: worker processes that
            # start together on an empty build directory each compile into
            # their own files, and each os.replace below stays atomic
            cmd = [_nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", _tmp_name(out), path]
            # the report goes to a file, so a full pipe never stalls a build
            # while another is waited on, and each build's end is its own
            report = open(_tmp_name(out[:-3] + ".log"), "w")
            procs[src] = (subprocess.Popen(cmd, stdout=report, stderr=subprocess.STDOUT),
                          report)
        while len(ends) < len(procs):
            for src, (p, _) in procs.items():
                if src not in ends and p.poll() is not None:
                    ends[src] = time.perf_counter()
            if len(ends) < len(procs):
                time.sleep(0.005)
        failed = []
        for src, (p, report) in procs.items():
            report.close()
            log_tmp = _tmp_name(libs[src][:-3] + ".log")
            if p.returncode != 0:
                with open(log_tmp) as f:
                    failed.append(f"{src}:\n{f.read()}")
                os.unlink(log_tmp)
                continue
            # the report first: a library that exists always has its report
            os.replace(log_tmp, libs[src][:-3] + ".log")
            os.replace(_tmp_name(libs[src]), libs[src])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        log, loaded, built = {}, {}, {}
        for src, path in libs.items():
            with open(path[:-3] + ".log") as f:
                log[src] = f.read()
            t_load = time.perf_counter()
            loaded[src] = ctypes.CDLL(path)
            cached = src not in procs
            built[src] = {"seconds": (time.perf_counter() - t_load) if cached
                          else ends[src] - t0,
                          "bytes": os.path.getsize(path), "digest": digests[src],
                          "cached": cached}
        for entry, (src, argtypes) in _SIGNATURES.items():
            fn = getattr(loaded[src], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[entry] = fn
        for src, b in built.items():
            tracing.record_compile(b["seconds"], site=site, signature=b["digest"],
                                   sig_key=b["digest"], exe_bytes=b["bytes"],
                                   library=src, cached=b["cached"])
        return {"seconds": time.perf_counter() - t0, "log": log, "libraries": built}


def _launch(kernel: str, entry: str, shape: tuple, *args, count: bool = True) -> None:
    """Launch C entry ``entry`` for ``kernel`` with ``args`` inside an
    in-flight ``dispatch`` entry labelled with the kernel (the enqueue
    only), and with ``count`` count it at ``shape``.  The launch that finds
    the libraries unbuilt builds them inside its entry, flagged
    ``compiling``.  A failing launch raises; nothing falls back."""
    fn = _entries.get(entry)
    reg = tracing.current_inflight()
    tok = reg.enter("dispatch", kernel, compiling=fn is None)
    try:
        if tracing.DISPATCH_TEST_HOOK is not None:
            tracing.DISPATCH_TEST_HOOK(tracing.full_site_label(kernel))
        if fn is None:
            build_kernels(site=kernel)
            fn = _entries[entry]
        t0 = time.perf_counter()
        rc = fn(*args)
        dt = time.perf_counter() - t0
    finally:
        reg.exit(tok)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
    if count:
        rec = getattr(_RECORDING, "launches", None)
        if rec is not None:
            rec.append((kernel, shape))
        else:
            STATS[kernel].record(shape, dt)


def _on_card(*tensors) -> bool:
    """THE chokepoint: True for CUDA tensors (launch the kernel), False for
    CPU tensors (plain version); anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"} or not kinds:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def _ranged(name: str):
    """Run the wrapper inside a profiler range named after its kernel while a
    profiler records (a range costs ~10 us of host time, so it is opened
    only then)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require(t: torch.Tensor, dtype, name: str) -> torch.Tensor:
    if t.dtype != dtype or t.dim() != 1:
        raise TypeError(f"{name}: expected a 1-D {dtype} tensor, got {t.dtype} "
                        f"of shape {tuple(t.shape)}")
    return t.contiguous()


# ------------------------------------------------------------------ hash insert
@_ranged("hash_insert")
def hash_insert_(table, packed, valid, max_probes: int = MAX_PROBES):
    """Insert packed keys into an open-addressing table, in place.

    table: [C+1] int64 (pow2 C, word C a sink), contiguous; it is updated in
    place.  packed: [n] int64, valid: [n] bool.  Returns (slot [n] int32,
    placed [n] bool) with the contract of ``hashagg._probe_insert``.  The
    callers that create their table (join builds, rehash) and the group-by
    page loop (which snapshots once per chunk) use this form."""
    if table.dtype != torch.int64 or table.dim() != 1 or not table.is_contiguous():
        raise TypeError(f"hash_insert_: the table must be a contiguous 1-D int64 tensor, "
                        f"got {table.dtype} of shape {tuple(table.shape)}")
    faults.maybe_inject("dispatch", "hash_insert")
    if not _on_card(table, packed, valid):
        return hash_insert_plain_(table, packed, valid, max_probes)
    return _insert_into(table, packed, valid, max_probes)


@_ranged("hash_insert")
def hash_insert(table, packed, valid, max_probes: int = MAX_PROBES):
    """The functional form of ``hash_insert_``: inserts into a copy of
    ``table`` and returns (table', slot, placed); the input table is not
    modified."""
    faults.maybe_inject("dispatch", "hash_insert")
    if not _on_card(table, packed, valid):
        return hash_insert_plain(table, packed, valid, max_probes)
    out = _require(table, torch.int64, "hash_insert table").clone()
    slot, placed = _insert_into(out, packed, valid, max_probes)
    return out, slot, placed


def _insert_into(table, packed, valid, max_probes):
    packed = _require(packed, torch.int64, "hash_insert packed")
    valid = _require(valid, torch.bool, "hash_insert valid")
    C = table.shape[0] - 1
    n = packed.shape[0]
    if C < 2 or C & (C - 1) or valid.shape[0] != n:
        raise ValueError(f"hash_insert: bad shapes table={C + 1} packed={n} "
                         f"valid={valid.shape[0]}")
    slot = torch.empty((n,), dtype=torch.int32, device=table.device)
    placed = torch.empty((n,), dtype=torch.bool, device=table.device)
    if n == 0:
        return slot, placed
    _launch("hash_insert", "trino_hash_insert", (n, C), table.data_ptr(), packed.data_ptr(),
            valid.data_ptr(), n, C, int(max_probes), slot.data_ptr(), placed.data_ptr(),
            _stream())
    return slot, placed


def hash_insert_plain_(table, packed, valid, max_probes: int = MAX_PROBES):
    """Torch form of the reference's XLA claim protocol
    (``hashagg._probe_insert``), writing into ``table``: per round, rows
    gather their slot, matching rows finish, rows seeing EMPTY contend with
    scatter-min over their keys, and the winners finish.  Returns (slot,
    placed)."""
    C = table.shape[0] - 1
    h0 = splitmix64(packed)
    stp = probe_step(h0)
    slot = torch.full(packed.shape, C, dtype=torch.int32, device=table.device)
    placed = ~valid
    empty = torch.tensor(EMPTY_KEY, dtype=torch.int64, device=table.device)
    for p in range(max_probes):
        if bool(placed.all()):
            break
        idx = ((h0 + p * stp) & (C - 1)).to(torch.int64)
        idx = torch.where(placed, C, idx)
        cur = table[idx]
        hit = (cur == packed) & ~placed
        slot = torch.where(hit, idx.to(torch.int32), slot)
        placed = placed | hit
        contend = (cur == EMPTY_KEY) & ~placed
        sidx = torch.where(contend, idx, C)
        table.scatter_reduce_(0, sidx, torch.where(contend, packed, empty), "amin",
                              include_self=True)
        table[C] = EMPTY_KEY  # the sink may have been clobbered by routed writes
        cur2 = table[idx]
        won = (cur2 == packed) & ~placed
        slot = torch.where(won, idx.to(torch.int32), slot)
        placed = placed | won
    return slot, placed


def hash_insert_plain(table, packed, valid, max_probes: int = MAX_PROBES):
    """``hash_insert_plain_`` into a copy: returns (table', slot, placed)."""
    table = table.clone()
    slot, placed = hash_insert_plain_(table, packed, valid, max_probes)
    return table, slot, placed


# ------------------------------------------------------------------- hash probe
@_ranged("hash_probe")
def hash_probe(table, vals, packed, valid, max_probes: int = MAX_PROBES):
    """Probe an open-addressing table; each key's chain (splitmix64 and its
    odd step) is computed inside the probe.

    table: [C] int64 (the [:C] slice of a build table, pow2 C); vals: [C]
    int32 per-slot payload, or None for the slot index itself (the
    multi-match layout's ``probe_slots``); packed: [n] int64 key words;
    valid: [n] bool.  Returns (payload at the match or 0 [n] int32, matched
    [n] bool), bit-identical to the XLA loop of ``hashjoin.probe``."""
    faults.maybe_inject("dispatch", "hash_probe")
    if not _on_card(table, vals, packed, valid):
        return hash_probe_plain(table, vals, packed, valid, max_probes)
    table = _require(table, torch.int64, "hash_probe table")
    packed = _require(packed, torch.int64, "hash_probe packed")
    valid = _require(valid, torch.bool, "hash_probe valid")
    C, n = table.shape[0], packed.shape[0]
    if vals is not None:
        vals = _require(vals, torch.int32, "hash_probe vals")
    if C < 2 or C & (C - 1) or valid.shape[0] != n or (vals is not None
                                                       and vals.shape[0] != C):
        raise ValueError(f"hash_probe: bad shapes table={C} "
                         f"vals={None if vals is None else vals.shape[0]} rows={n} "
                         f"valid={valid.shape[0]}")
    # two allocations cost the host less than slicing and re-viewing one
    out = torch.empty((n,), dtype=torch.int32, device=table.device)
    matched = torch.empty((n,), dtype=torch.bool, device=table.device)
    if n == 0:
        return out, matched
    _launch("hash_probe", "trino_hash_probe", (n, C), table.data_ptr(),
            None if vals is None else vals.data_ptr(), packed.data_ptr(), valid.data_ptr(),
            n, C, int(max_probes), out.data_ptr(), matched.data_ptr(), _stream())
    return out, matched


def hash_probe_plain(table, vals, packed, valid, max_probes: int = MAX_PROBES):
    """Torch form of the reference's XLA probe loop (``hashjoin.probe``),
    hashing the keys itself; ``vals=None`` returns the slot index."""
    C = table.shape[0]
    h0 = splitmix64(packed)
    stp = probe_step(h0)
    row_ids = torch.zeros(packed.shape, dtype=torch.int32, device=table.device)
    matched = torch.zeros(packed.shape, dtype=torch.bool, device=table.device)
    done = ~valid
    for p in range(max_probes):
        if bool(done.all()):
            break
        idx = ((h0 + p * stp) & (C - 1)).to(torch.int64)
        cur = table[idx]
        hit = (cur == packed) & ~done
        row_ids = torch.where(hit, idx.to(torch.int32) if vals is None else vals[idx],
                              row_ids)
        matched = matched | hit
        done = done | hit | (cur == EMPTY_KEY)
    return row_ids, matched


# ----------------------------------------------------------------- compaction
@_ranged("compact_rows")
def compact_rows(arrays, valid, out_len: int):
    """Order-preserving masked-lane pack (the contract of
    ``trino_tpu/ops/arrays.compact_rows``): live lanes of every array move to
    the front of ``out_len``-row outputs, zeros beyond the live count,
    overflow dropped; ``None`` entries pass through.  Returns (packed tuple,
    live count as a 0-d int64 tensor).  On the card the outputs come from
    ``torch.empty`` and the kernel writes every byte of them; one scratch
    tensor holds the scan's tile words and the count."""
    arrs = [a for a in arrays if a is not None]
    faults.maybe_inject("dispatch", "compact_rows")
    if not _on_card(valid, *arrs):
        return compact_rows_plain(arrays, valid, out_len)
    valid = _require(valid, torch.bool, "compact_rows valid")
    n = valid.shape[0]
    dev = valid.device
    srcs = []
    for a in arrs:
        if a.dim() != 1 or a.shape[0] != n:
            raise ValueError(f"compact_rows: column of shape {tuple(a.shape)} "
                             f"for {n} rows")
        if a.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"compact_rows: unsupported dtype {a.dtype}")
        srcs.append(a.contiguous())
    if not srcs:
        return tuple(arrays), valid.sum()
    outs = [torch.empty((out_len,), dtype=a.dtype, device=dev) for a in srcs]
    ntiles = (n + _COMPACT_TILE - 1) // _COMPACT_TILE
    scratch = torch.empty((ntiles + 2,), dtype=torch.int64, device=dev)
    k = len(srcs)
    src_ptrs = (ctypes.c_void_p * k)(*[a.data_ptr() for a in srcs])
    dst_ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * k)(*[a.element_size() for a in srcs])
    _launch("compact_rows", "trino_compact_rows",
            (n, int(out_len), tuple(a.element_size() for a in srcs)), valid.data_ptr(), n,
            int(out_len), k, src_ptrs, dst_ptrs, widths, scratch.data_ptr(), _stream())
    it = iter(outs)
    return tuple(None if a is None else next(it) for a in arrays), scratch[ntiles + 1]


def compact_rows_plain(arrays, valid, out_len: int):
    """Torch form of the reference's XLA cumsum-scatter: destinations are
    unique plus one drop sink at ``out_len``."""
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    dst = torch.where(valid, torch.clamp(pos, max=out_len), out_len)
    packed = []
    for a in arrays:
        if a is None:
            packed.append(None)
            continue
        buf = torch.zeros((out_len + 1,), dtype=a.dtype, device=a.device)
        buf[dst] = a  # unique destinations except the sink
        packed.append(buf[:out_len])
    return tuple(packed), valid.sum()


# ------------------------------------------------------------ fused segment agg
@_ranged("fused_segment_agg")
def fused_segment_agg(slot, valid, value_cols, n_slots: int):
    """Per-slot count of live rows and float32 sum of each value column, in
    one pass (the contract of ``pallas_kernels.fused_segment_agg``).

    slot: [n] integer slot per row (< n_slots <= 128), valid: [n] bool,
    value_cols: k [n] numeric columns (cast to float32).  Returns
    ([n_slots] int32 counts, tuple of k [n_slots] float32 sums).  The slot
    is taken as int32 first, as the reference takes it (an int64 slot wraps);
    rows whose slot then lies outside [0, n_slots) count nowhere.  On the
    card the outputs are views of one buffer that the kernel's C entry
    zeroes."""
    if not 1 <= n_slots <= SEGMENT_SLOTS_MAX:
        raise ValueError(f"fused_segment_agg: n_slots={n_slots} outside "
                         f"[1, {SEGMENT_SLOTS_MAX}]")
    n = slot.shape[0]
    if valid.shape[0] != n or any(v.dim() != 1 or v.shape[0] != n for v in value_cols):
        raise ValueError(f"fused_segment_agg: columns do not all have {n} rows")
    faults.maybe_inject("dispatch", "fused_segment_agg")
    if not _on_card(slot, valid, *value_cols):
        return fused_segment_agg_plain(slot, valid, value_cols, n_slots)
    slot = _require(slot.to(torch.int32), torch.int32, "fused_segment_agg slot")
    valid = _require(valid, torch.bool, "fused_segment_agg valid")
    cols = [v.to(torch.float32).contiguous() for v in value_cols]
    k = len(cols)
    out = torch.empty((n_slots * (k + 1),), dtype=torch.int32, device=slot.device)
    ptrs = (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in cols])
    # an empty input launches only to zero the outputs, and is not counted
    _launch("fused_segment_agg", "trino_segment_agg", (n, int(n_slots), k), slot.data_ptr(),
            valid.data_ptr(), ptrs, k, n, int(n_slots), out.data_ptr(), _stream(), count=bool(n))
    sums = out[n_slots:].view(torch.float32).view(k, n_slots)
    return out[:n_slots], tuple(sums[j] for j in range(k))


def fused_segment_agg_plain(slot, valid, value_cols, n_slots: int):
    """A bincount for the counts and a float32 ``index_add_`` per column for
    the sums; dead and out-of-range rows go to a dropped sink slot.  The slot
    is cast to int32 before the range test, as the reference and the kernel
    take it."""
    slot = slot.to(torch.int32)
    live = valid & (slot >= 0) & (slot < n_slots)
    idx = torch.where(live, slot.to(torch.int64), n_slots)
    counts = torch.bincount(idx, minlength=n_slots + 1)[:n_slots].to(torch.int32)
    sums = []
    for v in value_cols:
        acc = torch.zeros((n_slots + 1,), dtype=torch.float32, device=slot.device)
        acc.index_add_(0, idx, v.to(torch.float32))
        sums.append(acc[:n_slots])
    return counts, tuple(sums)
