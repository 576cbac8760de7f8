"""Time-shared worker execution across concurrent queries (counterpart of
``trino_tpu/execution/fair_scheduler.py``, copied: pure Python).

Reference: the worker's TaskExecutor time-shares a fixed thread pool over all
queries' splits in ~1s quanta (executor/timesharing/PrioritizedSplitRunner.java:49,187),
and a five-level feedback queue keyed by each query's ACCUMULATED scheduled
time decides who runs next (executor/timesharing/MultilevelSplitQueue.java:41)
— so a short query overtakes a long one instead of queueing behind it.

A fragment task's natural quantum is the SPLIT step (one page through the
task's pipeline: a launched kernel is not preemptible, and per-split steps
are the boundaries the task body already has).  Tasks run in their own threads holding one of N concurrency SLOTS;
between splits they call ``tick()``, which charges the elapsed quantum to
their query and yields the slot whenever a lower-level (less-served) query is
waiting — or unconditionally after the quantum expires with anyone waiting
(round-robin within a level).  Yielding keeps the task's executor state (the
group table lives on); only the slot token moves, which is exactly the
reference's split-runner re-queue."""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict

__all__ = ["FairScheduler", "LEVEL_THRESHOLDS"]

# accumulated-scheduled-seconds boundaries of the five feedback levels
# (MultilevelSplitQueue.java:41 — LEVEL_THRESHOLD_SECONDS {0, 1, 10, 60, 300})
LEVEL_THRESHOLDS = (0.0, 1.0, 10.0, 60.0, 300.0)
MAX_TRACKED_QUERIES = 256  # sched_time LRU bound (a long-lived worker serves
# unbounded queries; the other worker registries are capped the same way)


class FairScheduler:
    """N-slot admission with multilevel-feedback priority per QUERY."""

    def __init__(self, slots: int, quantum: float = None):
        self.slots = max(1, int(slots))
        self.quantum = float(
            os.environ.get("TRINO_TPU_SCHED_QUANTUM", "1.0")
            if quantum is None else quantum)
        self._cv = threading.Condition()
        self._running: dict = {}  # token -> (query_key, mark, held_since)
        self._waiters: list = []  # [(query_key, seq, token, enqueued_at)]
        self._seq = 0
        self._tokens = itertools.count()  # unique slot tokens: duplicate
        # task ids (speculation / wedged-task re-dispatch landing on the same
        # worker) must never share accounting entries
        self.sched_time: OrderedDict = OrderedDict()  # query -> seconds (LRU)
        self.preemptions = 0  # observability: quanta yielded to a waiter

    # -- priority ------------------------------------------------------------
    def _level(self, qk) -> int:
        t = self.sched_time.get(qk, 0.0)
        lvl = 0
        for i, th in enumerate(LEVEL_THRESHOLDS):
            if t >= th:
                lvl = i
        return lvl

    def _charge(self, qk: str, seconds: float) -> None:
        """Accumulate scheduled time under the LRU bound (call under cv)."""
        self.sched_time[qk] = self.sched_time.get(qk, 0.0) + seconds
        self.sched_time.move_to_end(qk)
        while len(self.sched_time) > MAX_TRACKED_QUERIES:
            self.sched_time.popitem(last=False)

    def _effective_level(self, w) -> int:
        """Level with AGING: a waiter starving past 10 quanta drops one level
        per further 10-quanta wait, so a steady stream of fresh queries
        cannot starve a long one forever (the reference avoids starvation
        with level-time RATIOS, MultilevelSplitQueue.java:41 computeTargetScheduledTime;
        aging is the same guarantee in this cooperative design)."""
        qk, _seq, _tok, enq = w
        waited = time.monotonic() - enq
        boost = int(waited / max(10.0 * self.quantum, 0.5))
        return max(self._level(qk) - boost, 0)

    def _best_waiter(self):
        return min(self._waiters,
                   key=lambda w: (self._effective_level(w), w[1]),
                   default=None)

    # -- slot lifecycle ------------------------------------------------------
    def new_token(self, task_id: str) -> str:
        """Unique per-execution slot token: two live executions of the same
        task id (speculative duplicate, wedged-task re-dispatch) must hold
        two slots, like the semaphore this scheduler replaced."""
        return f"{task_id}#{next(self._tokens)}"

    def acquire(self, query_key: str, token: str) -> None:
        """Block until this task holds a slot; grants go to the waiter whose
        query sits at the lowest (aged) feedback level, FIFO within one.

        Condition-variable notification, not a poll interval: every state
        change that can grant a slot notifies (release(), tick()'s yield, and
        the grant below — taking one of several free slots changes who is
        best, so the NEXT waiter must re-evaluate), so a blocked acquire
        wakes in notify latency, not at a 50ms poll boundary.  One wrinkle:
        the grant ORDER also depends on wall-clock aging, which can flip
        which waiter is "best" with no accompanying notify (two waiters each
        conclude "not me" around an aging boundary and both sleep over a free
        slot).  A coarse backstop wait at the aging-boundary granularity
        (10 quanta — the rate at which _effective_level can change at all)
        self-heals that stranding without reintroducing per-grant polling."""
        backstop = max(10.0 * self.quantum, 0.5)
        with self._cv:
            self._seq += 1
            w = (query_key, self._seq, token, time.monotonic())
            self._waiters.append(w)
            while not (len(self._running) < self.slots
                       and self._best_waiter() is w):
                self._cv.wait(backstop)
            self._waiters.remove(w)
            now = time.monotonic()
            self._running[token] = (query_key, now, now)
            self._cv.notify_all()  # remaining free slots go to the next-best

    def release(self, token: str) -> None:
        with self._cv:
            ent = self._running.pop(token, None)
            if ent is not None:
                qk, mark, _held = ent
                self._charge(qk, time.monotonic() - mark)
            self._cv.notify_all()

    def tick(self, token: str) -> None:
        """Split-boundary preemption point: charge the elapsed quantum; yield
        the slot when a less-served query waits, or when this quantum expired
        with ANY waiter (round-robin within the level)."""
        qk = None
        with self._cv:
            ent = self._running.get(token)
            if ent is None:
                return
            qk, mark, held_since = ent
            now = time.monotonic()
            self._charge(qk, now - mark)
            self._running[token] = (qk, now, held_since)
            if not self._waiters:
                return
            best = self._best_waiter()
            expired = (now - held_since) >= self.quantum
            if not (self._effective_level(best) < self._level(qk) or expired):
                return
            del self._running[token]
            self.preemptions += 1
            self._cv.notify_all()
        self.acquire(qk, token)  # rejoin behind the woken waiter

    def info(self) -> dict:
        with self._cv:
            recent = list(self.sched_time.items())[-16:]  # bounded payload
            return {"slots": self.slots,
                    "running": len(self._running),
                    "waiting": len(self._waiters),
                    "preemptions": self.preemptions,
                    "scheduled_time": {k: round(v, 3) for k, v in recent}}
