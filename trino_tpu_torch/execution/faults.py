"""Deterministic fault injection at the port's device-boundary chokepoints
(counterpart of ``trino_tpu/execution/faults.py``; reference:
execution/FailureInjector.java).

Design rules, as in the reference:

- **Deterministic.**  Triggers are counter-based ("the Nth match", "every
  Nth") or seeded-hash probabilities (splitmix64 over (seed, match index)),
  never wall clock, never the global RNG.
- **Zero cost when disarmed.**  ``maybe_inject`` is one module-global read
  and a ``None`` test: no launch, no host read, no allocation.
- **Typed outcomes.**  ``action=error`` raises :class:`InjectedFaultError`;
  ``action=fatal`` raises :class:`FatalInjectedFaultError`; ``delay`` sleeps
  inline; ``drop``, ``deny``, ``disk_full`` and ``kill_worker`` return the
  action for the chokepoint to enact.

Arming: ``TRINO_TPU_FAULTS`` (read once at import; rules separated by
``;``, ``key=value`` fields by ``,``), or ``faults.arm(spec)`` /
``faults.disarm()`` / the ``faults.injected(spec)`` context manager.
Fields: ``point`` (required), ``site`` (fnmatch glob over the bare site tag
and the composed "<Op>#<k>/<site>" label), ``query``, ``action``, ``s``
(delay seconds), ``nth`` / ``every`` / ``p`` + ``seed``, ``times``.

The point vocabulary (``POINTS``) is the reference's.  The port wires the
points in ``WIRED``, at its chokepoints:

    dispatch       every kernel wrapper of ops/cuda_kernels (hash_insert_,
                   hash_insert, hash_probe, compact_rows, fused_segment_agg;
                   site = the kernel's name), before the device branch, so
                   it fires at the plain versions on the CPU too; and
                   exec/local_executor.LocalExecutor._host (site = the read's
                   tag).  Together these are what ``device_dispatches``
                   counts.  A fault here raises: the wrapper launches
                   nothing and never falls back
    host_pull      LocalExecutor._host, inside its in-flight entry
    generate       exec/local_executor._scan_pages, once per split (site
                   scan.<table>): every path that generates a split crosses
                   it, the page tier's miss path included
    h2d            exec/local_executor._page_to_device (the spill
                   readback's producer thread), _stage_scan_entry (once per
                   page of a scan stored in the page tier) and the scan's
                   page loop wherever the reference stages a generated page
                   (_scan_pages_source: a multi-split scan while
                   TRINO_TPU_DISPATCH_BATCH is above 1), site page_to_device
    reserve        memory.MemoryPool.try_reserve (site = the tag); ``deny``
                   refuses the reservation
    cache_checkout execution/bufferpool get_page / get_build / get_result
                   (sites page.<table>, build, result); ``deny`` serves a miss
    cache_store    put_page / put_build / put_result (same sites); ``deny``
                   skips the admission, and an ``error`` is caught by the
                   caller's store guard: the statement succeeds, no entry
    spill_write    tier admission and write (sites spill.hbm, spill.host,
                   spill.disk).  ``deny`` makes that tier refuse, and the
                   chunk overflows to the next tier; ``disk_full`` (or
                   ``deny``) at the disk tier, the last one, raises
                   ``exec.spill.SpillCapacityError``
    spill_read     partition readback (sites spill.<tier>.read): any
                   returned action is a typed read failure
    exchange_write the worker mesh's exchange (exec/distributed.py
                   _exchange_fault), before each routed batch of the
                   blocking collect (site dist.exchange.route), the group
                   merge (dist.agg.merge) and each try of the partitioned
                   join's build exchange (dist.join.build_exchange); and the
                   spooled exchange's commit (exec/fte.SpoolingExchange,
                   site task.<id>), where ``drop`` loses the commit and the
                   retry loop or the coordinator recovers it
    exchange_read  the collected rows' hand-off to their consumer
                   (dist.exchange.read) and the merged groups' read
                   (dist.agg.groups), and the spooled exchange's read (site
                   task.<id>).  At the mesh's points any RETURNED action
                   (drop, deny) raises InjectedFaultError: the mesh exchange
                   is one lockstep program and cannot drop or defer rows
    task           the cluster worker's task body (server/cluster.py, site
                   <kind>.<task id>): ``kill_worker`` makes the worker look
                   crashed (its HTTP server stops; the coordinator's failure
                   detector and re-dispatch recover), a raise fails the task

A firing on a producer thread (the spill readback's ``_prefetched_pages``)
is charged to the query: the producer carries the consumer's counter set
and query id.  ``dispatch`` counts kernel-wrapper calls and host reads
here, jitted steps in the reference, so an ``nth`` rule lands on another
operation in each package; the outcome (recovered, or a typed error, and
no leak) is what the chaos matrix holds.

Every point of the vocabulary is wired (``WIRED`` equals ``POINTS``);
``arm`` and ``injected`` still refuse a point outside ``WIRED``: a rule
that is armed and can never fire would pass a chaos check for nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import threading
import time
from typing import Optional

__all__ = ["InjectedFaultError", "FatalInjectedFaultError", "FaultRule",
           "FaultPlan", "POINTS", "WIRED", "ACTIVE", "arm", "disarm", "active",
           "injected", "maybe_inject"]

POINTS = ("dispatch", "host_pull", "generate", "h2d", "cache_store",
          "cache_checkout", "exchange_write", "exchange_read", "task",
          "reserve", "spill_write", "spill_read")

# the points the port's chokepoints call maybe_inject for
WIRED = ("dispatch", "host_pull", "generate", "h2d", "reserve", "cache_checkout",
         "cache_store", "spill_write", "spill_read", "exchange_write", "exchange_read",
         "task")

ACTIONS = ("error", "fatal", "delay", "drop", "deny", "kill_worker",
           "disk_full")


class InjectedFaultError(RuntimeError):
    """A RETRYABLE injected fault: retry paths classify it like transient
    connector IO."""


class FatalInjectedFaultError(InjectedFaultError):
    """A NON-RETRYABLE injected fault — classified deterministic; every retry
    path must surface it immediately instead of burning its budget."""


_M64 = (1 << 64) - 1


def _mix64(seed: int, i: int) -> int:
    """splitmix64-style mix of (seed, match index): the seeded-probability
    trigger's only randomness source — reproducible across runs/processes."""
    x = (seed * 0x9E3779B97F4A7C15 + i * 0xBF58476D1CE4E5B9 + 1) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


@dataclasses.dataclass
class FaultRule:
    point: str
    site: str = "*"            # fnmatch glob over the site label
    query: str = "*"           # fnmatch glob over the active query/task id
    action: str = "error"
    seconds: float = 0.0       # delay duration for action=delay
    nth: Optional[int] = None    # fire exactly on the Nth match (1-based)
    every: Optional[int] = None  # fire on every Nth match
    p: Optional[float] = None    # seeded probability per match
    seed: int = 0
    times: Optional[int] = None  # max fires (None = unlimited)
    # runtime state (not part of the spec)
    matches: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(expected one of {POINTS})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")
        if self.times is None and self.nth is not None:
            self.times = 1  # "the Nth match" is inherently a single fire

    def should_fire(self) -> bool:
        """Caller holds the plan lock and has already bumped ``matches``."""
        if self.times is not None and self.fires >= self.times:
            return False
        if self.nth is not None:
            return self.matches == self.nth
        if self.every is not None:
            return self.matches % self.every == 0
        if self.p is not None:
            return _mix64(self.seed, self.matches) < int(self.p * (_M64 + 1))
        return True

    def spec(self) -> str:
        parts = [f"point={self.point}"]
        if self.site != "*":
            parts.append(f"site={self.site}")
        if self.query != "*":
            parts.append(f"query={self.query}")
        parts.append(f"action={self.action}")
        if self.action == "delay":
            parts.append(f"s={self.seconds}")
        for k in ("nth", "every", "p", "times"):
            v = getattr(self, k)
            if v is not None:
                parts.append(f"{k}={v}")
        if self.p is not None:
            parts.append(f"seed={self.seed}")
        return ",".join(parts)


def _parse_rule(text: str) -> FaultRule:
    kw: dict = {}
    for field in text.split(","):
        field = field.strip()
        if not field:
            continue
        if "=" not in field:
            raise ValueError(f"fault rule field {field!r} is not key=value "
                             f"(in rule {text!r})")
        k, v = field.split("=", 1)
        k, v = k.strip(), v.strip()
        if k in ("point", "site", "query", "action"):
            kw[k] = v
        elif k in ("nth", "every", "times", "seed"):
            kw[k] = int(v)
        elif k == "p":
            kw[k] = float(v)
        elif k == "s":
            kw["seconds"] = float(v)
        else:
            raise ValueError(f"unknown fault rule key {k!r} in {text!r}")
    if "point" not in kw:
        raise ValueError(f"fault rule {text!r} has no point=")
    return FaultRule(**kw)


class FaultPlan:
    """An armed set of rules.  ``fire`` is the one entry the chokepoints
    call; per-rule match counters live under one lock so concurrent worker
    threads see one deterministic global match order per rule (entry order is
    scheduler-dependent under true concurrency — single-threaded chaos runs,
    the test suite's shape, are fully deterministic)."""

    def __init__(self, rules):
        self.rules = list(rules)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules = [_parse_rule(r) for r in spec.split(";") if r.strip()]
        if not rules:
            raise ValueError(f"fault spec {spec!r} contains no rules")
        return cls(rules)

    def fire(self, point: str, site: str, query: Optional[str],
             label: Optional[str] = None) -> Optional[str]:
        """Match + trigger every rule for this event.  ``site`` is the bare
        chokepoint tag; ``label`` the composed "<Op>#<k>/<site>" form when an
        operator scope is active — a rule's site glob may address either.
        Raises for error/fatal actions, sleeps for delay, returns
        "drop"/"deny"/"kill_worker"/"disk_full" for the chokepoint to enact
        (first such action wins), else None."""
        fired: list = []
        with self._lock:
            for r in self.rules:
                if r.point != point:
                    continue
                if r.site != "*" \
                        and not fnmatch.fnmatchcase(site, r.site) \
                        and not (label is not None
                                 and fnmatch.fnmatchcase(label, r.site)):
                    continue
                if r.query != "*" and not fnmatch.fnmatchcase(query or "",
                                                              r.query):
                    continue
                r.matches += 1
                if r.should_fire():
                    fired.append(r)
        if not fired:
            return None
        from . import tracing

        result = None
        for r in fired:
            # count the fire as the action is ENACTED, not at match time: if
            # an earlier rule's raise aborts this loop, the unenacted rules
            # keep their ``times`` budget (and their ``fires`` stays honest —
            # chaos "fires>=1" assertions must imply the action happened)
            with self._lock:
                if r.times is not None and r.fires >= r.times:
                    continue  # a concurrent event enacted the last fire
                r.fires += 1
            tracing.record_fault(site=f"fault.{point}.{r.action}")
            msg = (f"injected {r.action} at {point}/{label or site} "
                   f"({r.spec()})")
            if r.action == "fatal":
                raise FatalInjectedFaultError(msg)
            if r.action == "error":
                raise InjectedFaultError(msg)
            if r.action == "delay":
                time.sleep(r.seconds)
            elif result is None:
                result = r.action  # drop | deny | kill_worker | disk_full
        return result

    def stats(self) -> list:
        with self._lock:
            return [{"rule": r.spec(), "matches": r.matches, "fires": r.fires}
                    for r in self.rules]

    def total_fires(self) -> int:
        with self._lock:
            return sum(r.fires for r in self.rules)


# the process-global armed plan; None (the default) = injection disabled.
# Chokepoints read this through maybe_inject — one global load + None test.
ACTIVE: Optional[FaultPlan] = None


def arm(plan) -> FaultPlan:
    """Arm a FaultPlan (or parse and arm a spec string).  Returns the plan so
    tests can read its per-rule stats afterwards."""
    global ACTIVE
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    unwired = sorted({r.point for r in plan.rules} - set(WIRED))
    if unwired:
        raise ValueError(f"fault point(s) {unwired} are not wired in trino_tpu_torch "
                         f"yet (wired: {list(WIRED)}); such a rule could never fire")
    ACTIVE = plan
    return plan


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def active() -> Optional[FaultPlan]:
    return ACTIVE


@contextlib.contextmanager
def injected(spec):
    """Arm ``spec`` (string or FaultPlan) for the duration of a with-block —
    the chaos suite's per-scenario arming, restoring whatever was armed
    before (normally nothing)."""
    global ACTIVE
    prev = ACTIVE
    plan = arm(spec)
    try:
        yield plan
    finally:
        ACTIVE = prev


def maybe_inject(point: str, site: Optional[str] = None) -> Optional[str]:
    """The chokepoint hook.  Disarmed: one global read, returns None.  Armed:
    evaluates the plan against (point, bare site tag, composed
    "<Op>#<k>/<site>" label, active query id); may raise a typed fault,
    sleep, or return an action string for the caller."""
    plan = ACTIVE
    if plan is None:
        return None
    from . import tracing

    tag = site or ""
    return plan.fire(point, tag, tracing.current_query_id(),
                     label=tracing.full_site_label(tag))


def _arm_from_env() -> None:
    """One-shot env arming (TRINO_TPU_FAULTS) at import, for whole
    processes; tests use the arm()/injected() API instead."""
    import os

    spec = os.environ.get("TRINO_TPU_FAULTS")
    if spec:
        arm(FaultPlan.parse(spec))


_arm_from_env()
