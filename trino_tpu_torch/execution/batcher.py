"""Continuous template batching (counterpart of
``trino_tpu/execution/batcher.py``): the per-template rendezvous that runs N
in-flight executions of ONE plan template as a single fused execution.

Each template-cache key owns a LANE:

- the FIRST request on an idle lane is the LEADER: it runs the exact
  single-statement path at once, so an empty window adds no latency and no
  work;
- requests arriving while the lane is busy QUEUE; when the leader finishes
  it hands the lane to the first queued member, which becomes the DRIVER:
  it sleeps the gather window (``TRINO_TPU_BATCH_WINDOW_MS``, default 2.0),
  takes up to ``TRINO_TPU_BATCH_MAX`` (default 16) members, and runs ONE
  fused execution (``LocalExecutor.execute_batched``) whose per-lane results
  resolve every member;
- a whole-batch failure (``BatchUnsupported``, a device fault) re-runs EVERY
  member on its own serial path: no member inherits another's error, and a
  per-lane decode error fails only its own request.

``TRINO_TPU_TEMPLATE_BATCH=0`` turns the batcher off.  It is on by default,
as in the reference, although the fused execution runs each lane's own
transform and compaction over every page of the union: on an H100 fused
windows took 0.94-2.19x their members' serial walls summed, and a point
lookup shape sent through the coordinator from 16 clients ran at
0.26-0.35x of the batcher-off rate in two runs (``chip_smoke.py`` phase
13).  The
batcher is host thread choreography only and imports nothing but the
standard library: the fused execution's device work is accounted on the
driver's statement."""

from __future__ import annotations

import os
import threading
import time

__all__ = ["TemplateBatcher"]


# test seam: when set, called with the lane key by a LEADER after its own
# serial execution completes and BEFORE it hands the lane to a queued
# driver — tests park the leader here to deterministically accumulate a
# multi-member window instead of racing the wall clock
LEADER_EXIT_HOOK = None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class _Member:
    __slots__ = ("runtime", "event", "drive", "serial", "result", "error",
                 "batched_with")

    def __init__(self, runtime):
        self.runtime = runtime
        self.event = threading.Event()
        self.drive = False  # woken to DRIVE the next window
        self.serial = False  # woken to fall back to its own serial run
        self.result = None
        self.error = None
        self.batched_with = 0


class _Lane:
    __slots__ = ("busy", "queue")

    def __init__(self):
        self.busy = False
        self.queue: list = []


class TemplateBatcher:
    """Per-template-key execution lanes (see module docstring).

    ``execute`` is the only entry point; ``info()`` snapshots the metrics
    surface (/v1/metrics template-batch counters + size histogram)."""

    def __init__(self, window_ms=None, max_batch=None, enabled=None):
        self.window_s = (_env_float("TRINO_TPU_BATCH_WINDOW_MS", 2.0)
                         if window_ms is None else float(window_ms)) / 1000.0
        self.max_batch = max(_env_int("TRINO_TPU_BATCH_MAX", 16)
                             if max_batch is None else int(max_batch), 1)
        if enabled is None:
            enabled = os.environ.get("TRINO_TPU_TEMPLATE_BATCH", "1") \
                not in ("0", "false", "no")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._lanes: dict = {}
        self.batches_total = 0
        self.batched_requests_total = 0
        self._size_hist: dict = {}  # fused batch size -> count

    def execute(self, key, runtime, serial_fn, batch_fn):
        """Run one template request through the lane for ``key``.

        ``serial_fn(runtime) -> result`` is the exact single-statement path;
        ``batch_fn(runtimes) -> [result|Exception, ...]`` the fused one.
        Returns ``(result, batched_with)``: ``batched_with == 0`` means the
        request executed serially (idle-lane leader, singleton window, or
        fallback); > 0 is the fused batch size that served it.  Raises the
        member's OWN error only."""
        if not self.enabled:
            return serial_fn(runtime), 0
        with self._lock:
            lane = self._lanes.setdefault(key, _Lane())
            member = None
            if lane.busy:
                member = _Member(runtime)
                lane.queue.append(member)
            else:
                lane.busy = True
        if member is None:
            # leader on an idle lane: the unmodified serial path, now
            try:
                return serial_fn(runtime), 0
            finally:
                hook = LEADER_EXIT_HOOK
                if hook is not None:
                    try:
                        hook(key)
                    except Exception:
                        pass
                self._handoff(lane)
        member.event.wait()
        if member.drive:
            return self._drive(lane, member, serial_fn, batch_fn)
        if member.serial:
            # the window's fused run failed as a whole: run our own serial
            return serial_fn(member.runtime), 0
        if member.error is not None:
            raise member.error
        return member.result, member.batched_with

    def _drive(self, lane, member, serial_fn, batch_fn):
        """First queued member after a handoff: gather a window, run the
        fused batch, resolve every member, hand the lane on."""
        if self.window_s > 0:
            time.sleep(self.window_s)
        with self._lock:
            take = lane.queue[:self.max_batch - 1]
            del lane.queue[:len(take)]
        group = [member] + take
        if len(group) == 1:
            # nobody joined the window: the serial path is strictly better
            # (already compiled, no lane padding)
            try:
                return serial_fn(member.runtime), 0
            finally:
                self._handoff(lane)
        try:
            results = batch_fn([m.runtime for m in group])
            if not isinstance(results, (list, tuple)) \
                    or len(results) != len(group):
                raise RuntimeError(
                    "batch executor returned %r results for %d members"
                    % (None if results is None else len(results),
                       len(group)))
        except BaseException as e:
            # whole-batch failure: every OTHER member re-runs serially on
            # its own thread; this thread does the same (after freeing
            # them), unless the interpreter itself is going down
            for m in group[1:]:
                m.serial = True
                m.event.set()
            self._handoff(lane)
            if isinstance(e, (KeyboardInterrupt, SystemExit, GeneratorExit)):
                raise
            return serial_fn(member.runtime), 0
        n = len(group)
        with self._lock:
            self.batches_total += 1
            self.batched_requests_total += n
            self._size_hist[n] = self._size_hist.get(n, 0) + 1
        for m, r in zip(group, results):
            m.batched_with = n
            if isinstance(r, BaseException):
                m.error = r
            else:
                m.result = r
        for m in group[1:]:
            m.event.set()
        self._handoff(lane)
        if member.error is not None:
            raise member.error
        return member.result, member.batched_with

    def _handoff(self, lane) -> None:
        """Release the lane: promote the first queued member to driver, or
        mark the lane idle.  Every exit path of a lane holder runs this —
        a queued member can never be stranded."""
        with self._lock:
            if lane.queue:
                nxt = lane.queue.pop(0)
                nxt.drive = True
                nxt.event.set()
            else:
                lane.busy = False

    def info(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "window_ms": self.window_s * 1000.0,
                    "max_batch": self.max_batch,
                    "batches_total": self.batches_total,
                    "batched_requests_total": self.batched_requests_total,
                    "sizes": dict(self._size_hist)}
