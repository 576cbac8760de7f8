"""The memory-pressure scenarios of the chaos matrix (counterpart of the
pressure part of ``trino_tpu/execution/chaos_matrix.py``), shared by the
CPU tests (``tests/test_torch_spill.py``) and the card run
(``chip_smoke.py``'s phase 16), so both hold the same contract.

Each PRESSURE entry is ``(name, cfg, fault spec or None, kind)``:

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
``spill`` reservations of the executor's pool and the buffer pool back to 0,
no spill still registered with the executor.

Not ported yet: the other scenarios (dispatch, host reads, generation,
caches, exchange), which come with their fault points (ROADMAP A6).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from . import tracing

__all__ = ["PRESSURE", "PRESSURE_QUERY", "leak_report", "result_signature",
           "run_pressure_scenario", "settle"]

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
