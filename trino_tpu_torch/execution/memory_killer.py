"""Cluster low-memory kill policies.

Reference: memory/ClusterMemoryManager.java:92 polls every node's pool into a
cluster view and, when nodes sit blocked, asks a pluggable LowMemoryKiller to
pick a victim query —
memory/TotalReservationOnBlockedNodesQueryLowMemoryKiller.java chooses the
query holding the most memory summed over the BLOCKED nodes;
TotalReservationLowMemoryKiller sums over all nodes.  Killing one query frees
the cluster instead of letting every query on the wedged node starve.

The coordinator feeds policies the per-node view its heartbeats already
collect (node pools report per-query attribution via MemoryPool.by_query)."""

from __future__ import annotations

from typing import Optional

__all__ = ["TotalReservationOnBlockedNodesKiller", "TotalReservationKiller",
           "NoneKiller", "BLOCKED_FRACTION"]

BLOCKED_FRACTION = 0.9  # a node past this pool use is "blocked" (matches the
# coordinator's cluster_memory() view and worker admission gating)


def _blocked(node: dict) -> bool:
    return bool(node.get("mem_max")) \
        and node.get("mem_reserved", 0) > BLOCKED_FRACTION * node["mem_max"]


class TotalReservationOnBlockedNodesKiller:
    """Victim = the query with the highest total reservation across BLOCKED
    nodes (the reference's default-recommended policy)."""

    def pick_victim(self, nodes: list) -> Optional[str]:
        totals: dict = {}
        for n in nodes:
            if not _blocked(n):
                continue
            for q, b in (n.get("mem_by_query") or {}).items():
                totals[q] = totals.get(q, 0) + b
        if not totals:
            return None
        victim = max(totals, key=totals.get)
        return victim if totals[victim] > 0 else None


class TotalReservationKiller:
    """Victim = the query with the highest reservation across ALL nodes —
    engages only when some node is blocked (TotalReservationLowMemoryKiller)."""

    def pick_victim(self, nodes: list) -> Optional[str]:
        if not any(_blocked(n) for n in nodes):
            return None
        totals: dict = {}
        for n in nodes:
            for q, b in (n.get("mem_by_query") or {}).items():
                totals[q] = totals.get(q, 0) + b
        if not totals:
            return None
        victim = max(totals, key=totals.get)
        return victim if totals[victim] > 0 else None


class NoneKiller:
    """Disable cluster kills (the reference's 'none' policy)."""

    def pick_victim(self, nodes: list) -> Optional[str]:
        return None
