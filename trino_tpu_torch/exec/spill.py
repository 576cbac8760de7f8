"""Tiered spill for Grace-partitioned operators: device, host RAM, disk
(counterpart of ``trino_tpu/exec/spill.py``; reference: the spilling
operators' partition-at-a-time consumption, PartitionedConsumption.java,
over FileSingleStreamSpiller.java).

One pass routes every transformed page's rows into per-partition buffers,
then the partitions stream back one at a time, each small enough for the
memory pool.  The input is read and transformed exactly once.

- **The route** is one stable sort of the page by partition id (invalid
  rows sink past the last partition) and a ``searchsorted`` for the
  partition bounds, on the page's device; order within a partition is the
  page's.  It costs at most one counted host read a page (the bounds, or
  the routed page and its bounds), through the owning executor's ``_host``.
- **Device tier** (``hbm``): the routed page stays on the device, its bytes
  claimed from the buffer pool's page and build budget
  (``DeviceBufferPool.reserve_spill``, tag ``spill``).  A partition reads
  back as ``a[lo:hi]`` views of it: no copy, no host staging.  (The
  reference pads these slices, and host pages, to power-of-two buckets only
  to reuse its XLA compiles; the port compiles nothing, and reads back
  unpadded pages whose rows are all live.)
- **Host tier** (``host``): numpy buffers per partition, reserved under the
  ``spill`` tag of the executor's MemoryPool and bounded by the
  ``TRINO_TPU_SPILL_HOST_BYTES`` watermark (unset: the pool alone bounds it).
- **Disk tier** (``disk``): one append-only file per partition under
  ``TRINO_TPU_SPILL_DIR`` (default ``$TMPDIR/trino_tpu_spill``), frames of
  the ``exec/fte.py`` page codec.  Unlike the reference, which writes a
  frame per chunk, a partition's chunks gather up to ``DISK_FRAME_BYTES``
  into one frame.  When it refuses (an OS error or an injected
  ``disk_full``), :class:`SpillCapacityError` surfaces typed.

Host and disk chunks read back concatenated in their order, up to
``READ_BATCH_ROWS`` rows a page (the reference yields one page a chunk).

Fault points ``spill_write`` (sites ``spill.hbm``, ``spill.host``,
``spill.disk``) and ``spill_read`` (``spill.<tier>.read``) fire here.
Every admitted chunk is counted by ``tracing.record_spill``.  Reservations
release as partitions are consumed (``release_partition``) and ``close``
is idempotent; the executor also closes every spill it registered on each
exit path (``LocalExecutor.close_producers``), so no reservation and no
file outlives the query.  The reference keeps a partitioned join's build
spill with its compiled stream across executions; the port compiles no
stream, so that spill too closes with its query.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..execution import faults, tracing
from ..page import Page
from ..types import torch_dtype

__all__ = ["SpilledPartitions", "SpillCapacityError", "concat_host_chunks",
           "padded_page", "padded_host_page", "spill_dir", "live_spill_files",
           "spill_host_budget"]

# host and disk chunks of a partition read back concatenated, up to this
# many rows a page: a partition's chunks are slices of routed pages, often a
# few rows each, and one page of many costs one launch of each kernel
# downstream instead of one per chunk
READ_BATCH_ROWS = 1 << 20
# a partition's disk chunks collect in memory up to this many bytes and go
# to its file as one codec frame: a frame costs ~0.5 ms of container work
# besides its compression, and a chunk is often a few KiB (so at most
# parts x this many bytes wait unwritten)
DISK_FRAME_BYTES = 256 << 10


class SpillCapacityError(MemoryError):
    """Every spill tier refused (the host watermark or the pool denied, and
    the disk tier is full or unavailable): the ladder's typed last error."""


def spill_dir() -> str:
    """The disk tier's directory (TRINO_TPU_SPILL_DIR; default a
    ``trino_tpu_spill`` folder of the temporary directory), made on demand."""
    d = os.environ.get("TRINO_TPU_SPILL_DIR")
    if not d:
        import tempfile

        d = os.path.join(tempfile.gettempdir(), "trino_tpu_spill")
    os.makedirs(d, exist_ok=True)
    return d


def spill_host_budget() -> Optional[int]:
    """Host-tier watermark in bytes (TRINO_TPU_SPILL_HOST_BYTES): ``0`` sends
    every overflow to disk; unset, the pool's capacity is the only bound."""
    raw = os.environ.get("TRINO_TPU_SPILL_HOST_BYTES")
    if raw is None:
        return None
    try:
        return max(int(raw), 0)
    except ValueError:
        return None


# live per-query spill files of this process: what the leak checks read
_files_lock = threading.Lock()
_LIVE_SPILL_FILES: set = set()


def live_spill_files() -> list:
    with _files_lock:
        return sorted(_LIVE_SPILL_FILES)


def _register_file(path: str) -> None:
    with _files_lock:
        _LIVE_SPILL_FILES.add(path)


def _unregister_file(path: str) -> None:
    with _files_lock:
        _LIVE_SPILL_FILES.discard(path)


def concat_host_chunks(schema, chunks):
    """Concatenate host row chunks ``[(cols, nulls, ...)]`` into one column
    set; a channel whose every chunk lacks a mask (or whose merged mask has
    no set bit) gets None.  Only ``[0]`` and ``[1]`` of a chunk are read."""
    ncols = len(schema.fields)
    if not chunks:
        return ([np.empty((0,), np.dtype(f.type.dtype)) for f in schema.fields],
                [None] * ncols)
    cols, nulls = [], []
    for i in range(ncols):
        cols.append(np.concatenate([c[0][i] for c in chunks]))
        ms = [c[1][i] for c in chunks]
        if all(m is None for m in ms):
            nulls.append(None)
        else:
            m = np.concatenate([mm if mm is not None
                                else np.zeros(c[0][i].shape[0], bool)
                                for mm, c in zip(ms, chunks)])
            nulls.append(m if m.any() else None)
    return cols, nulls


def route_sorted(payload, valid, pid, parts: int):
    """Group a page's valid rows by partition id: one stable sort; invalid
    rows sink past the last partition bound.  -> (routed payload, bounds)
    with partition ``p`` at ``[bounds[p], bounds[p + 1])``."""
    sort_key = torch.where(valid, pid.to(torch.int32),
                           torch.full_like(pid, parts, dtype=torch.int32))
    skey, order = torch.sort(sort_key, stable=True)
    bounds = torch.searchsorted(
        skey, torch.arange(parts + 1, dtype=torch.int32, device=skey.device))
    return tuple(c[order] for c in payload), bounds


def _arrays_nbytes(arrays) -> int:
    """Byte size of device or host arrays, from their shapes."""
    total = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif getattr(a, "dtype", None) != object:
            total += int(a.nbytes)
    return total


def _read_fault(site: str) -> None:
    """spill_read chokepoint: error and fatal raise inside maybe_inject; any
    returned action is a typed read failure (the rows exist only here)."""
    act = faults.maybe_inject("spill_read", site)
    if act is not None:
        raise faults.InjectedFaultError(f"injected {act} at spill_read/{site}")


class SpilledPartitions:
    """Per-partition buffers of transformed rows, tiered device, host RAM,
    disk.  ``owner`` is the executor: its ``_host`` makes the counted reads
    and it sweeps this spill on every exit path.  ``memory_pool`` accounts
    the host tier (tag ``tag``); ``buffer_pool`` lends the device tier its
    budget.  A spill with neither (the partitioned join's build side) keeps
    its host chunks unaccounted, as the reference's build spill does, and
    still honours the host watermark."""

    def __init__(self, schema, parts: int, owner, memory_pool=None, buffer_pool=None,
                 tag: str = "spill"):
        self.schema = schema
        self.parts = parts
        self.owner = owner
        self.memory_pool = memory_pool
        self.buffer_pool = buffer_pool
        self.tag = tag
        self.chunks: list = [[] for _ in range(parts)]  # (cols, nulls, nbytes)
        self.rows = [0] * parts
        self.spilled_bytes = 0
        self.tier_bytes = {t: 0 for t in tracing.SPILL_TIERS}
        # host seconds per tier: of writing (routing a page and storing its
        # chunks, the route's synchronising read included) and of reading
        # back (making the pages the consumer gets, on the producer thread
        # where it stages; the consumer's work between pages left out)
        self.write_s = {t: 0.0 for t in tracing.SPILL_TIERS}
        self.read_s = {t: 0.0 for t in tracing.SPILL_TIERS}
        # one entry per device-tier page: {"payload", "bounds" (host),
        # "ncols", "null_slots"}
        self._device_chunks: list = []
        self._disk: dict = {}  # p -> {"path", "fh", "bytes"}
        self._disk_buf: dict = {}  # p -> [chunks, bytes] not yet framed
        self._host_budget = spill_host_budget()
        self._host_reserved = 0
        self._hbm_reserved = 0
        self._closed = False
        owner._spills.append(self)

    # -- write path ------------------------------------------------------------
    def add_page(self, cols, nulls, valid, pid) -> None:
        """Route one device page into the partition tiers."""
        t0 = time.perf_counter()
        null_slots = [i for i, m in enumerate(nulls) if m is not None]
        payload = tuple(cols) + tuple(nulls[i] for i in null_slots)
        routed, bounds = route_sorted(payload, valid, pid, self.parts)
        nbytes = _arrays_nbytes(routed)
        if self._try_hbm(nbytes):
            (b,) = self.owner._host([bounds], site="spill.route.bounds")
            self._device_chunks.append({"payload": routed, "bounds": b,
                                        "ncols": len(cols), "null_slots": null_slots})
            for p in range(self.parts):
                self.rows[p] += int(b[p + 1]) - int(b[p])
            self._hbm_reserved += nbytes
            self._account("hbm", nbytes)
            self.write_s["hbm"] += time.perf_counter() - t0
            return
        got = self.owner._host(list(routed) + [bounds], site="spill.route")
        b = got[-1]
        ncols = len(cols)
        rest = got[ncols:-1]
        for p in range(self.parts):
            lo, hi = int(b[p]), int(b[p + 1])
            if hi <= lo:
                continue
            pcols = [np.ascontiguousarray(c[lo:hi]) for c in got[:ncols]]
            pnulls = []
            for i in range(ncols):
                if i in null_slots:
                    m = np.ascontiguousarray(rest[null_slots.index(i)][lo:hi])
                    pnulls.append(m if m.any() else None)
                else:
                    pnulls.append(None)
            tier = self._add_host_or_disk(p, pcols, pnulls)
            self.rows[p] += hi - lo
            now = time.perf_counter()
            self.write_s[tier] += now - t0  # the route's read goes to the first
            t0 = now

    def _try_hbm(self, nbytes: int) -> bool:
        """Device tier admission from the buffer pool's budget; a ``deny`` or
        ``disk_full`` fault here overflows to the host tier."""
        bp = self.buffer_pool
        if bp is None or not bp.enabled or nbytes <= 0:
            return False
        if faults.maybe_inject("spill_write", "spill.hbm") in ("deny", "disk_full"):
            return False
        return bp.reserve_spill(nbytes)

    def _add_host_or_disk(self, p: int, pcols, pnulls) -> str:
        nbytes = sum(c.nbytes for c in pcols) + sum(m.nbytes for m in pnulls
                                                    if m is not None)
        if self._admit_host(nbytes):
            self.chunks[p].append((pcols, pnulls, nbytes))
            self._host_reserved += nbytes
            self._account("host", nbytes)
            return "host"
        self._write_disk(p, pcols, pnulls, nbytes)
        return "disk"

    def _admit_host(self, nbytes: int) -> bool:
        """Host tier admission: under the watermark and reservable under the
        pool's tag.  A refusal (watermark, pool, injected fault) goes to
        disk."""
        if faults.maybe_inject("spill_write", "spill.host") in ("deny", "disk_full"):
            return False
        if self._host_budget is not None \
                and self._host_reserved + nbytes > self._host_budget:
            return False
        if self.memory_pool is not None:
            return self.memory_pool.try_reserve(nbytes, self.tag)
        return True

    def _write_disk(self, p: int, pcols, pnulls, nbytes: int) -> None:
        """Disk tier, the last rung: the chunk joins the partition's frame
        buffer, written out as one codec frame once it holds
        ``DISK_FRAME_BYTES``.  A refusal here is terminal and typed."""
        act = faults.maybe_inject("spill_write", "spill.disk")
        if act in ("deny", "disk_full"):
            raise SpillCapacityError(f"spill disk tier refused partition {p} "
                                     f"({nbytes} bytes): injected {act}")
        buf = self._disk_buf.setdefault(p, [[], 0])
        buf[0].append((pcols, pnulls))
        buf[1] += nbytes
        self._account("disk", nbytes)
        if buf[1] >= DISK_FRAME_BYTES:
            self._flush_disk(p)

    def _flush_disk(self, p: int) -> None:
        """Append partition ``p``'s buffered chunks to its file as one frame
        (the file is made at the first); an OS error is typed.  The caller
        times it as a write."""
        buf = self._disk_buf.pop(p, None)
        if buf is None:
            return
        from .fte import serialize_page

        frame = serialize_page(*concat_host_chunks(self.schema, buf[0]))
        rec = self._disk.get(p)
        try:
            if rec is None:
                path = os.path.join(spill_dir(),
                                    f"spill-{os.getpid()}-{id(self):x}-p{p}.pages")
                fh = open(path, "wb")
                _register_file(path)
                rec = self._disk[p] = {"path": path, "fh": fh, "bytes": 0}
            rec["fh"].write(frame)
        except OSError as e:
            raise SpillCapacityError(
                f"spill disk write failed for partition {p}: {e}") from e
        rec["bytes"] += buf[1]

    def _flush_before_read(self, p: int) -> None:
        """The last frame of partition ``p``, written before it is read back
        (its seconds are the disk tier's write seconds)."""
        t0 = time.perf_counter()
        self._flush_disk(p)
        self.write_s["disk"] += time.perf_counter() - t0

    def _account(self, tier: str, nbytes: int) -> None:
        self.spilled_bytes += nbytes
        self.tier_bytes[tier] += nbytes
        tracing.record_spill(tier, nbytes, site=f"spill.{tier}")

    # -- read path -------------------------------------------------------------
    def needs_staging(self, p: int) -> bool:
        """Does partition ``p`` hold host or disk chunks, which read back
        through the prefetch producer?  Device chunks are already there."""
        return bool(self.chunks[p]) or p in self._disk or p in self._disk_buf

    def partition_pages(self, p: int):
        """Stream partition ``p`` back in the order it was written: each
        device chunk as a view on the device, then the host chunks and the
        disk frames as host pages (numpy columns) of up to
        ``READ_BATCH_ROWS`` rows, concatenated in order, for the consumer's
        prefetch to stage."""
        for ch in self._device_chunks:
            lo, hi = int(ch["bounds"][p]), int(ch["bounds"][p + 1])
            if hi <= lo:
                continue
            _read_fault("spill.hbm.read")
            yield self._device_partition_page(ch, lo, hi)
        if self.chunks[p]:
            _read_fault("spill.host.read")
            yield from self._batched(((c, n) for c, n, _nb in self.chunks[p]), "host")
        self._flush_before_read(p)
        rec = self._disk.get(p)
        if rec is not None:
            _read_fault("spill.disk.read")
            yield from self._batched(self._disk_frames(rec), "disk")

    def _batched(self, chunks, tier: str):
        """Host pages of consecutive ``(cols, nulls)`` chunks, each up to
        ``READ_BATCH_ROWS`` rows (a larger chunk is a page of its own)."""
        batch, rows = [], 0
        t0 = time.perf_counter()
        for cols, nulls in chunks:
            n = int(cols[0].shape[0])
            if batch and rows + n > READ_BATCH_ROWS:
                page = padded_host_page(self.schema, *concat_host_chunks(self.schema, batch))
                self.read_s[tier] += time.perf_counter() - t0
                yield page
                t0 = time.perf_counter()
                batch, rows = [], 0
            batch.append((list(cols), list(nulls)))
            rows += n
        if batch:
            page = padded_host_page(self.schema, *concat_host_chunks(self.schema, batch))
            self.read_s[tier] += time.perf_counter() - t0
            yield page

    def _device_partition_page(self, ch, lo: int, hi: int) -> Page:
        payload = ch["payload"]
        ncols, null_slots = ch["ncols"], ch["null_slots"]
        out = [a[lo:hi] for a in payload]
        rest = out[ncols:]
        nulls = tuple(rest[null_slots.index(i)] if i in null_slots else None
                      for i in range(ncols))
        return Page(self.schema, tuple(out[:ncols]), nulls, None)

    def _disk_frames(self, rec):
        """The codec frames of one partition file, one frame at a time (the
        disk tier engages when host RAM is scarce: reading a whole file
        would make the spike it exists to avoid)."""
        from .fte import deserialize_page

        fh = rec.get("fh")
        if fh is not None and not fh.closed:
            fh.flush()
        with open(rec["path"], "rb") as f:
            while True:
                head = f.read(17)
                if len(head) < 17:
                    return
                length = int.from_bytes(head[9:17], "little")
                yield deserialize_page(head + f.read(length))

    def partition_page(self, p: int) -> Page:
        """Partition ``p`` as one device page (the partitioned join's build
        side): device chunks' slices in one counted read, the host and disk
        chunks beside them, concatenated on the host and staged once."""
        chunks = list(self.chunks[p])
        t0 = time.perf_counter()
        for ch in self._device_chunks:
            lo, hi = int(ch["bounds"][p]), int(ch["bounds"][p + 1])
            if hi <= lo:
                continue
            _read_fault("spill.hbm.read")
            got = self.owner._host([a[lo:hi] for a in ch["payload"]],
                                   site="spill.hbm.pull")
            ncols, null_slots = ch["ncols"], ch["null_slots"]
            rest = got[ncols:]
            chunks.append((got[:ncols], [rest[null_slots.index(i)] if i in null_slots
                                         else None for i in range(ncols)]))
        t1 = time.perf_counter()
        self.read_s["hbm"] += t1 - t0
        self._flush_before_read(p)
        t1 = time.perf_counter()
        rec = self._disk.get(p)
        if rec is not None:
            _read_fault("spill.disk.read")
            for cols, nulls in self._disk_frames(rec):
                chunks.append((list(cols), list(nulls)))
        t2 = time.perf_counter()
        self.read_s["disk"] += t2 - t1
        if self.chunks[p]:
            _read_fault("spill.host.read")
        cols, nulls = concat_host_chunks(self.schema, chunks)
        page = padded_page(self.schema, cols, nulls, self.owner)
        # the concatenation and the copy to the device, with the host tier
        self.read_s["host"] += time.perf_counter() - t2
        return page

    # -- release ---------------------------------------------------------------
    def release_partition(self, p: int) -> None:
        """Free partition ``p``'s host reservation and disk file (consumed).
        Device chunks span partitions and release at ``close``."""
        freed = sum(nb for _c, _n, nb in self.chunks[p])
        self.chunks[p] = []
        if freed:
            self._host_reserved -= freed
            if self.memory_pool is not None:
                self.memory_pool.free(freed, self.tag)
        self._remove_disk(p)

    def _remove_disk(self, p: int) -> None:
        self._disk_buf.pop(p, None)
        rec = self._disk.pop(p, None)
        if rec is None:
            return
        try:
            if not rec["fh"].closed:
                rec["fh"].close()
        except OSError:
            pass
        try:
            os.remove(rec["path"])
        except OSError:
            pass
        _unregister_file(rec["path"])

    def close(self) -> None:
        """Release every tier (idempotent): device reservations back to the
        buffer pool, host ones to the memory pool, disk files removed."""
        if self._closed:
            return
        self._closed = True
        if self._hbm_reserved and self.buffer_pool is not None:
            self.buffer_pool.release_spill(self._hbm_reserved)
        self._hbm_reserved = 0
        self._device_chunks = []
        if self._host_reserved and self.memory_pool is not None:
            self.memory_pool.free(self._host_reserved, self.tag)
        self._host_reserved = 0
        self.chunks = [[] for _ in range(self.parts)]
        for p in set(self._disk) | set(self._disk_buf):
            self._remove_disk(p)


def padded_host_page(schema, cols, nulls) -> Page:
    """Host rows as a host page, every row live.  The name is the
    reference's, which pads to power-of-two buckets for its compiles; the
    port needs no padding.  Staging to the device is the consumer's
    prefetch producer's work."""
    return Page(schema, tuple(cols), tuple(nulls), None)


def padded_page(schema, cols, nulls, owner) -> Page:
    """Host rows as a device page on ``owner``'s device, every row live, the
    bytes counted as H2D (object columns stay on the host)."""
    dcols = tuple(c if np.asarray(c).dtype == object
                  else owner._to_device(c, torch_dtype(f.type))
                  for c, f in zip(cols, schema.fields))
    dnulls = tuple(None if m is None else owner._to_device(m) for m in nulls)
    return Page(schema, dcols, dnulls, None)
