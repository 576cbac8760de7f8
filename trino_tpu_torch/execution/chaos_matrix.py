"""The chaos matrix (counterpart of ``trino_tpu/execution/chaos_matrix.py``),
shared by the CPU tests (``tests/test_torch_chaos.py``,
``tests/test_torch_result_cache.py``, ``tests/test_torch_spill.py``) and the
card run (``chip_smoke.py``'s phases 16 and 17), so both hold the same
contract: a recoverable fault is invisible (the result byte-identical to the
fault-free run), an unrecoverable one fails with a typed error, and nothing
leaks (``leak_report``).

- ``QUERIES``: the reference's inlined q1, q3, q9 and q18.
- ``SCENARIOS``: the eight local scenarios, ``(name, spec, kind,
  clear_pool, cache_on)``, and their views ``RECOVERABLE`` (name -> (spec,
  clear_pool)) and ``FAILING`` (name -> (spec, cache_on)).  ``clear_pool``
  empties the buffer pool first (a warm pool never stores); ``cache_on``
  False runs the ``page_cache = false`` session (a page-tier hit never
  generates).
- ``RESULT_SCENARIOS`` and ``run_result_scenario``: the result tier's
  checkout and store faults, on a result-enabled engine.
- ``PRESSURE`` and ``run_pressure_scenario``: the memory-pressure
  scenarios (and ``producer_faults``, faults that land on the spill
  readback's producer thread), each ``(name, cfg, fault spec or None,
  kind)``:

  - ``cfg["pool_bytes"]``: the executor MemoryPool's capacity (small: Grace
    aggregation and the partitioned join);
  - ``cfg["page_cache"]``: the DeviceBufferPool budget (above 0 opens the
    spill's device tier; 0 closes it, and the host tier comes next);
  - ``cfg["spill_host"]``: TRINO_TPU_SPILL_HOST_BYTES for the scenario (0
    forces disk; None: the pool alone bounds the host tier);
  - ``cfg["expect_tier"]``: a tier whose counter must be above 0 (None: any).

  ``recover`` holds the result byte-identical to the unconstrained run;
  ``fail`` holds a typed error (InjectedFaultError, SpillCapacityError).
  After every scenario the leak check holds: no live spill file, the
  ``spill`` reservations of the executor's pool and the buffer pool back to
  0, no spill still registered with the executor.

The port's ``dispatch`` point counts kernel-wrapper calls and host reads,
where the reference's counts jitted steps, so a scenario's ``nth`` lands on
another operation in each package: the outcome is held, not the site.

- ``DIST_SCENARIOS``, ``DIST_QUERIES`` and ``run_dist_scenario``: the
  worker mesh's exchange faults (``exchange_write``, ``exchange_read``) on a
  distributed window and group-by; every returned action fails typed.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from . import tracing

__all__ = ["QUERIES", "SCENARIOS", "RECOVERABLE", "FAILING", "RESULT_SCENARIOS",
           "DIST_SCENARIOS", "DIST_QUERIES", "run_dist_scenario", "PRESSURE",
           "PRESSURE_QUERY", "leak_report", "result_signature", "producer_faults",
           "run_pressure_scenario", "run_result_scenario", "settle"]

# the reference's four (inlined from the TPC-H spec, so the matrix does not
# drift with a generator or benchmark edit)
QUERIES = {
    "q1": """
    select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
           sum(l_extendedprice) as sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
           avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
           avg(l_discount) as avg_disc, count(*) as count_order
    from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
    group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus""",
    "q3": """
    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
      and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
      and l_shipdate > date '1995-03-15'
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate limit 10""",
    "q9": """
    select nation, o_year, sum(amount) as sum_profit from (
      select n_name as nation, extract(year from o_orderdate) as o_year,
        l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey and ps_partkey = l_partkey
        and p_partkey = l_partkey and o_orderkey = l_orderkey
        and s_nationkey = n_nationkey and p_name like '%green%') as profit
    group by nation, o_year order by nation, o_year desc""",
    "q18": """
    select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
    from customer, orders, lineitem
    where o_orderkey in (select l_orderkey from lineitem group by l_orderkey
                         having sum(l_quantity) > 300)
      and c_custkey = o_custkey and o_orderkey = l_orderkey
    group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
    order by o_totalprice desc, o_orderdate limit 100""",
}

# (name, spec, kind, clear_pool, cache_on).  kind "recover" asserts
# byte-identical results, "fail" asserts the typed error.  clear_pool empties
# the buffer pool first (store scenarios never fire against a warm pool —
# a warm pool never stores); cache_on=False runs the page_cache=false session
# for the generate/h2d classes (a warm pool hit never generates).
SCENARIOS = [
    ("cache-checkout-deny", "point=cache_checkout,action=deny,every=1",
     "recover", False, True),
    ("cache-store-error", "point=cache_store,action=error,every=1",
     "recover", True, True),
    ("reserve-deny", "point=reserve,action=deny,nth=1", "recover", False,
     True),
    ("dispatch-delay", "point=dispatch,action=delay,s=0.001,every=2",
     "recover", False, True),
    ("dispatch-error", "point=dispatch,action=error,nth=3", "fail", False,
     True),
    ("generate-error", "point=generate,action=error,nth=2", "fail", False,
     False),
    ("host-pull-fatal", "point=host_pull,action=fatal,nth=1", "fail", False,
     True),
    ("h2d-error", "point=h2d,action=error,nth=2", "fail", False, False),
]

# the test suite's parametrization views: recovery must be invisible
# (name -> (spec, clear_pool)), local failure must be typed-clean
# (name -> (spec, cache_on))
RECOVERABLE = {name: (spec, clear_pool)
               for name, spec, kind, clear_pool, _cache_on in SCENARIOS
               if kind == "recover"}
FAILING = {name: (spec, cache_on)
           for name, spec, kind, _clear_pool, cache_on in SCENARIOS
           if kind == "fail"}

# the result tier's matrix: an engine with its result tier on (enabling it
# for the main matrix would answer warm statements from the cache, and the
# dispatch and generate classes would never fire).  (name, spec, kind):
# "recover" holds byte-identical results, at least one fire and the leak
# check
RESULT_SCENARIOS = [
    ("result-checkout-deny",
     "point=cache_checkout,site=result,action=deny,every=1", "recover"),
    ("result-store-deny",
     "point=cache_store,site=result,action=deny,every=1", "recover"),
    ("result-store-error",
     "point=cache_store,site=result,action=error,nth=1", "recover"),
]


# the worker mesh's exchange matrix.  Routed rows live in per-position device
# receive buffers inside one lockstep run, so a RETURNED action (drop, deny)
# cannot silently lose or defer them: every returned action raises typed
# (InjectedFaultError), and only the non-raising action (delay) recovers.
# (name, query, spec, kind): "window" routes every orders row through the
# blocking collect (dist.exchange.route / .read), "agg" takes the group
# merge's exchange and the merged groups' read (dist.agg.merge / .groups);
# "recover" holds byte-identity with the local baseline, "fail" the typed
# error; every scenario ends with the leak check and a fault-free rerun
DIST_SCENARIOS = [
    ("dist-route-delay", "window",
     "point=exchange_write,site=dist.*,action=delay,s=0.001,every=1",
     "recover"),
    ("dist-route-error", "window",
     "point=exchange_write,site=dist.exchange.route,action=error,nth=1",
     "fail"),
    ("dist-route-drop", "window",
     "point=exchange_write,site=dist.exchange.route,action=drop,nth=1",
     "fail"),
    ("dist-read-error", "window",
     "point=exchange_read,site=dist.exchange.read,action=error,nth=1",
     "fail"),
    ("dist-merge-deny", "agg",
     "point=exchange_write,site=dist.agg.merge,action=deny,nth=1", "fail"),
    ("dist-groups-error", "agg",
     "point=exchange_read,site=dist.agg.groups,action=error,nth=1", "fail"),
]

# the exchange's queries: a partitioned window (the blocking collect's
# receive buffers) and a distributed group-by (the merge's hash exchange and
# the merged groups' read)
DIST_QUERIES = {
    "window": """
        select o_custkey, o_orderkey,
               row_number() over (partition by o_custkey
                   order by o_totalprice desc, o_orderkey) rk
        from orders order by o_custkey, o_orderkey limit 29""",
    "agg": """
        select o_custkey, count(*) n, sum(o_totalprice) s from orders
        group by o_custkey order by n desc, o_custkey limit 17""",
}


def run_dist_scenario(engine, sql, session, mesh, baseline_sig, name, spec,
                      kind) -> dict:
    """One exchange scenario: arm ``spec``, run ``sql`` on the worker mesh,
    hold the outcome (byte-identity for "recover", the typed error for
    "fail"), at least one fire, the leak check, and a fault-free
    distributed rerun.  Returns ``{"ok": bool, ...}``."""
    from . import faults
    from .faults import InjectedFaultError

    rec = {"scenario": name, "kind": kind}
    try:
        with faults.injected(spec) as plan:
            if kind == "fail":
                try:
                    engine.execute_sql(sql, session, distributed=True, mesh=mesh)
                    rec["ok"] = False
                    rec["detail"] = "no error raised"
                except InjectedFaultError as e:
                    rec["ok"] = True
                    rec["error_type"] = type(e).__name__
            else:
                got = result_signature(engine.execute_sql(sql, session, distributed=True,
                                                          mesh=mesh))
                rec["ok"] = got == baseline_sig
                if not rec["ok"]:
                    rec["detail"] = "result diverged"
        rec["fires"] = plan.total_fires()
        if rec["fires"] < 1:
            rec["ok"] = False
            rec["detail"] = "scenario never fired"
        leaks = leak_report(engine)
        if leaks:
            rec["ok"] = False
            rec["leaks"] = leaks
        if rec["ok"]:
            # the raised exchange left no partial state behind: executors
            # and their receive buffers live for one statement
            again = result_signature(engine.execute_sql(sql, session, distributed=True,
                                                        mesh=mesh))
            if again != baseline_sig:
                rec["ok"] = False
                rec["detail"] = "post-fault rerun diverged"
    except Exception as e:  # noqa: BLE001 - a harness failure is the record's
        rec["ok"] = False
        rec["detail"] = f"{type(e).__name__}: {e}"
    return rec


_POOL = 1 << 19  # 512 KiB: Grace aggregation and the partitioned join at SF<=0.1
PRESSURE = [
    ("tier-hbm", {"pool_bytes": _POOL, "page_cache": 256 << 20,
                  "spill_host": None, "expect_tier": "hbm"}, None, "recover"),
    ("tier-host", {"pool_bytes": _POOL, "page_cache": 0,
                   "spill_host": None, "expect_tier": "host"}, None, "recover"),
    ("tier-disk", {"pool_bytes": _POOL, "page_cache": 0,
                   "spill_host": 0, "expect_tier": "disk"}, None, "recover"),
    ("tier-mixed", {"pool_bytes": _POOL, "page_cache": 1 << 16,
                    "spill_host": 1 << 16, "expect_tier": "disk"}, None, "recover"),
    ("hbm-deny-overflows", {"pool_bytes": _POOL, "page_cache": 256 << 20,
                            "spill_host": None, "expect_tier": None},
     "point=spill_write,site=spill.hbm,action=deny,every=1", "recover"),
    ("spill-write-error", {"pool_bytes": _POOL, "page_cache": 0,
                           "spill_host": 0, "expect_tier": None},
     "point=spill_write,site=spill.disk,action=error,nth=2", "fail"),
    ("disk-full", {"pool_bytes": _POOL, "page_cache": 0, "spill_host": 0,
                   "expect_tier": None},
     "point=spill_write,site=spill.disk,action=disk_full,nth=1", "fail"),
    ("read-deny", {"pool_bytes": _POOL, "page_cache": 0,
                   "spill_host": None, "expect_tier": None},
     "point=spill_read,action=deny,nth=1", "fail"),
]



def producer_faults(scan_splits: int) -> list:
    """The faults that land on the spill readback's producer thread
    (``exec/local_executor._prefetched_pages``, the port's one producer),
    for ``PRESSURE_QUERY`` over a scan of ``scan_splits`` splits with the
    host tier and then the disk tier forced: ``spill_read`` at the second
    partition read, and ``h2d`` at the second staged readback page (past
    the scan's own ``h2d`` points, one per page of a multi-split scan).
    Each ``(name, cfg, spec)`` runs through ``run_pressure_scenario`` as a
    ``fail`` scenario."""
    from ..exec.local_executor import _dispatch_batch_default

    scan_h2d = scan_splits if scan_splits > 1 and _dispatch_batch_default() > 1 else 0
    out = []
    for name, cfg, _spec, _kind in PRESSURE:
        if name in ("tier-host", "tier-disk"):
            tier = name.split("-")[1]
            out.append((f"spill_read-{tier}", cfg, "point=spill_read,action=error,nth=2"))
            out.append((f"h2d-{tier}", cfg, f"point=h2d,action=error,nth={scan_h2d + 2}"))
    return out


# a wide GROUP BY (one group per orderkey): its group table does not fit
# the tiny pool
PRESSURE_QUERY = """
    select o_orderkey, count(*) n from orders
    group by o_orderkey order by n desc, o_orderkey limit 13"""


def run_pressure_scenario(engine, plan, baseline_sig, name, cfg, spec, kind,
                          scratch_dir) -> dict:
    """One scenario against ``plan`` on a fresh executor sized by ``cfg``
    on the engine's device, with ``spec`` armed; the outcome and the leak
    check fold into the returned record (``{"ok": bool, ...}``), with the
    tiers' bytes (``tiers``), the partition count (``spill_partitions``)
    and the executor's counters."""
    import contextlib
    import os

    from ..exec import spill as spill_mod
    from ..exec.local_executor import LocalExecutor
    from ..exec.spill import SpillCapacityError
    from ..execution.bufferpool import DeviceBufferPool
    from ..memory import MemoryPool
    from . import faults
    from .faults import InjectedFaultError

    rec = {"scenario": name, "kind": kind}
    prev = {k: os.environ.get(k)
            for k in ("TRINO_TPU_SPILL_HOST_BYTES", "TRINO_TPU_SPILL_DIR")}
    os.environ["TRINO_TPU_SPILL_DIR"] = scratch_dir
    if cfg.get("spill_host") is None:
        os.environ.pop("TRINO_TPU_SPILL_HOST_BYTES", None)
    else:
        os.environ["TRINO_TPU_SPILL_HOST_BYTES"] = str(cfg["spill_host"])
    bp = DeviceBufferPool(budget_bytes=cfg.get("page_cache", 0), device=engine.device)
    ex = LocalExecutor(engine.catalogs, engine.device,
                       memory_pool=MemoryPool(max_bytes=cfg["pool_bytes"]),
                       buffer_pool=bp)
    counters = tracing.QueryCounters()
    try:
        ctx = faults.injected(spec) if spec else contextlib.nullcontext()
        with ctx as plan_f, tracing.track_counters(counters):
            if kind == "fail":
                try:
                    ex.execute(plan)
                    rec["ok"] = False
                    rec["detail"] = "no error raised"
                except (InjectedFaultError, SpillCapacityError) as e:
                    rec["ok"] = True
                    rec["error_type"] = type(e).__name__
            else:
                rec["signature"] = result_signature(ex.execute(plan))
                rec["ok"] = rec["signature"] == baseline_sig
                if not rec["ok"]:
                    rec["detail"] = "result diverged"
        if spec:
            rec["fires"] = plan_f.total_fires()
            if rec["fires"] < 1:
                rec["ok"] = False
                rec["detail"] = "scenario never fired"
        rec["counters"] = counters
        rec["tiers"] = {t: getattr(counters, f"spill_tier_{t}")
                        for t in tracing.SPILL_TIERS}
        rec["spill_partitions"] = [st["spill_partitions"] for st in ex.stats.values()
                                   if st.get("spill_partitions")]
        expect = cfg.get("expect_tier")
        if kind == "recover" and expect and not rec["tiers"].get(expect):
            rec["ok"] = False
            rec["detail"] = f"tier {expect} never engaged: {rec['tiers']}"
        ex.close_producers()  # the exit-path sweep (execute ran it already)
        leaks = []
        if ex._spills:
            leaks.append("executor-held-spills")
        n = ex.memory_pool.info()["by_tag"].get("spill", 0)
        if n:
            leaks.append(f"spill-reservation:{n}")
        if bp.memory_pool is not None:
            nb = bp.memory_pool.info()["by_tag"].get(DeviceBufferPool.SPILL_TAG, 0)
            if nb:
                leaks.append(f"hbm-spill-reservation:{nb}")
        files = spill_mod.live_spill_files()
        if files:
            leaks.append(f"live-spill-files:{len(files)}")
        leftover = os.listdir(scratch_dir) if os.path.isdir(scratch_dir) else []
        if leftover:
            leaks.append(f"orphaned-spill-files:{leftover}")
        if leaks:
            rec["ok"] = False
            rec["leaks"] = leaks
    except Exception as e:  # noqa: BLE001 - a harness failure is the record's
        rec["ok"] = False
        rec["detail"] = f"{type(e).__name__}: {e}"
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rec


def run_result_scenario(engine, sql, session, baseline_sig, name, spec,
                        kind) -> dict:
    """One result-tier scenario on a result-enabled engine: a clean pass
    first (a checkout scenario needs an entry to deny; a store scenario then
    clears the pool so that a store is attempted), then ``spec`` armed; the
    result byte-identical to ``baseline_sig``, at least one fire, no entry
    admitted under a store fault, the leak check, and a fault-free rerun
    that still matches.  Returns ``{"ok": bool, ...}``."""
    from . import faults

    rec = {"scenario": name, "kind": kind}
    try:
        engine.execute_sql(sql, session)
        if "store" in name:
            engine.buffer_pool.clear()
        with faults.injected(spec) as plan:
            got = result_signature(engine.execute_sql(sql, session))
        rec["ok"] = got == baseline_sig
        if not rec["ok"]:
            rec["detail"] = "result diverged"
        rec["fires"] = plan.total_fires()
        if rec["fires"] < 1:
            rec["ok"] = False
            rec["detail"] = "scenario never fired"
        if "store" in name and rec["ok"] \
                and engine.buffer_pool.info()["result_entries"]:
            rec["ok"] = False
            rec["detail"] = "entry admitted under a store fault"
        leaks = leak_report(engine)
        if leaks:
            rec["ok"] = False
            rec["leaks"] = leaks
        if rec["ok"]:
            # the fault left no partial state: a clean pass stores again and
            # still matches
            again = result_signature(engine.execute_sql(sql, session))
            if again != baseline_sig:
                rec["ok"] = False
                rec["detail"] = "post-fault rerun diverged"
    except Exception as e:  # noqa: BLE001 - a harness failure is the record's
        rec["ok"] = False
        rec["detail"] = f"{type(e).__name__}: {e}"
    return rec


def result_signature(result):
    """Byte-level result signature: dtype and raw bytes per column (object
    columns, decoded strings, by value)."""
    out = []
    for c in result.columns:
        a = np.asarray(c)
        out.append((str(a.dtype),
                    tuple(a.tolist()) if a.dtype == object else a.tobytes()))
    return tuple(out)


def settle(timeout: float = 8.0) -> list:
    """Poll until no prefetch producer thread is alive and the in-flight
    registry is empty; returns the leftovers (empty: clean)."""
    deadline = time.time() + timeout
    while True:
        leftovers = [t.name for t in threading.enumerate()
                     if t.name.startswith("prefetch-producer") and t.is_alive()]
        if tracing.INFLIGHT.depth() > 0:
            leftovers += [e["label"] for e in tracing.INFLIGHT.snapshot()]
        if not leftovers or time.time() >= deadline:
            return leftovers
        time.sleep(0.05)


def leak_report(engine, timeout: float = 8.0) -> list:
    """The post-scenario contract as a list of violations (empty: clean):
    no surviving prefetch producer, no in-flight entry, no ``spill``
    reservation in the engine's pool (every executor the engine makes
    reserves from it; the port keeps no executors between statements, so
    there is no executor list to walk), buffer-pool reservations equal to
    its resident bytes (an unreleased device spill breaks the equality), and
    no live spill file."""
    leftovers = settle(timeout)
    n = engine.memory_pool.info()["by_tag"].get("spill", 0)
    if n:
        leftovers.append(f"spill-reservation:{n}")
    bp = engine.buffer_pool
    pool = bp.memory_pool
    if pool is not None and pool.reserved != bp.info()["bytes"]:
        leftovers.append(f"pool-reservation-mismatch:{pool.reserved}!="
                         f"{bp.info()['bytes']}")
    from ..exec.spill import live_spill_files

    files = live_spill_files()
    if files:
        leftovers.append(f"live-spill-files:{len(files)}")
    return leftovers
