"""Hierarchical resource groups: admission control + fair queueing.

Reference: execution/resourcegroups/InternalResourceGroup.java — a tree of
groups, each with hard/soft concurrency limits and queue bounds; queries queue
at a leaf and start when every ancestor has a free slot.  Scheduling weight is
honored per-subgroup (WeightedFairQueue); here the queue drain picks the
eligible subgroup with the lowest running/weight ratio.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

__all__ = ["ResourceGroup", "ResourceGroupManager", "QueryQueueFullError"]


class QueryQueueFullError(RuntimeError):
    pass


class ResourceGroup:
    def __init__(self, name: str, parent: Optional["ResourceGroup"] = None,
                 hard_concurrency_limit: int = 100, max_queued: int = 1000,
                 scheduling_weight: int = 1):
        self.name = name
        self.parent = parent
        self.hard_concurrency_limit = hard_concurrency_limit
        self.max_queued = max_queued
        self.scheduling_weight = scheduling_weight
        self.children: dict[str, ResourceGroup] = {}
        self._running = 0
        self._queue: collections.deque = collections.deque()

    @property
    def full_name(self) -> str:
        return self.name if self.parent is None else f"{self.parent.full_name}.{self.name}"

    def subgroup(self, name: str, **kw) -> "ResourceGroup":
        g = self.children.get(name)
        if g is None:
            g = ResourceGroup(name, parent=self, **kw)
            self.children[name] = g
        return g

    # internal (manager holds the lock) ---------------------------------------
    def _can_run_more(self) -> bool:
        g: Optional[ResourceGroup] = self
        while g is not None:
            if g._total_running() >= g.hard_concurrency_limit:
                return False
            g = g.parent
        return True

    def _total_running(self) -> int:
        return self._running + sum(c._total_running() for c in self.children.values())

    def _total_queued(self) -> int:
        return len(self._queue) + sum(c._total_queued() for c in self.children.values())


class ResourceGroupManager:
    """Owns the group tree; queries enter through `submit` and run via the
    returned start callback when admitted (reference:
    InternalResourceGroupManager.submit, dispatcher/DispatchManager.java:256)."""

    def __init__(self, root: Optional[ResourceGroup] = None,
                 admission_gate: Optional[Callable[[], bool]] = None):
        self.root = root or ResourceGroup("global")
        self._lock = threading.Lock()
        # memory-pressure admission gate (round 11, the escalation ladder's
        # "deny admission" rung): a callable returning False while the node
        # should DEFER new admissions (engine pools blocked).  Deferral only
        # engages while something is running — every finish() re-drains the
        # queue, so progress is guaranteed and an idle tree always admits
        # (queueing with nothing running would deadlock the queue).
        self.admission_gate = admission_gate
        self.memory_queued_total = 0  # lifetime count of gate deferrals

    def _gate_blocks(self) -> bool:
        """Caller holds the lock.  True = defer admission (memory pressure
        with work still running that will drain the queue)."""
        gate = self.admission_gate
        if gate is None or self.root._total_running() == 0:
            return False
        try:
            return not gate()
        except Exception:  # a broken gate must never wedge admission
            return False

    def get_or_create(self, path: str, **kw) -> ResourceGroup:
        g = self.root
        for part in path.split("."):
            if part and part != self.root.name:
                g = g.subgroup(part, **kw)
        return g

    def submit(self, group: ResourceGroup, start: Callable[[], None],
               queued: Optional[Callable[[], None]] = None,
               queued_on_memory: Optional[Callable[[], None]] = None) -> None:
        """Run `start` now if the group tree has capacity AND the admission
        gate passes, else queue it (FIFO within a group, weighted-fair
        across groups).  ``queued_on_memory`` fires additionally when the
        MEMORY gate (not concurrency) caused the deferral — the ladder's
        per-query rung record.  Raises QueryQueueFullError beyond
        max_queued."""
        with self._lock:
            gate_blocked = self._gate_blocks()
            if group._can_run_more() and not gate_blocked:
                group._running += 1
            else:
                if len(group._queue) >= group.max_queued:
                    raise QueryQueueFullError(
                        f"Too many queued queries for \"{group.full_name}\"")
                group._queue.append(start)
                if gate_blocked:
                    self.memory_queued_total += 1
                    if queued_on_memory is not None:
                        queued_on_memory()
                if queued is not None:
                    queued()
                return
        start()

    def finish(self, group: ResourceGroup) -> None:
        """Called when a query completes: release the slot and drain queues."""
        to_start = []
        with self._lock:
            group._running -= 1
            nxt = self._next_runnable(self.root)
            while nxt is not None:
                g, fn = nxt
                g._running += 1
                to_start.append(fn)
                nxt = self._next_runnable(self.root)
        for fn in to_start:
            fn()

    def _next_runnable(self, group: ResourceGroup):
        """Weighted-fair pick: among eligible groups with queued queries, choose
        the one with the lowest running/weight ratio (reference: WeightedFairQueue)."""
        if self._gate_blocks():
            return None  # memory still blocked with work running: the next
            # finish() (freed memory) re-drains; running==0 always drains
        best = None
        stack = [group]
        while stack:
            g = stack.pop()
            stack.extend(g.children.values())
            if g._queue and g._can_run_more():
                ratio = g._total_running() / max(g.scheduling_weight, 1)
                if best is None or ratio < best[0]:
                    best = (ratio, g)
        if best is None:
            return None
        g = best[1]
        return g, g._queue.popleft()

    def info(self) -> list[dict]:
        out = []
        stack = [self.root]
        with self._lock:
            while stack:
                g = stack.pop()
                stack.extend(g.children.values())
                out.append({
                    "name": g.full_name,
                    "running": g._total_running(),
                    "queued": g._total_queued(),
                    "hard_concurrency_limit": g.hard_concurrency_limit,
                    "max_queued": g.max_queued,
                    "scheduling_weight": g.scheduling_weight,
                })
        return out
