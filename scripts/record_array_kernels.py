#!/usr/bin/env python3
"""Which of the kernel paths the JAX reference reaches for each statement of
``chip_smoke.py``'s phase 10 (arrays, maps, UNNEST and MATCH_RECOGNIZE:
A1-A7): the recording behind ``chip_smoke.ARRAYS_REQUIRED``.

    python3 scripts/record_array_kernels.py [--sf 0.1] [--out array_kernels.json]

Builds ``orders_nested`` in the reference's memory catalog from its TPC-H
orders and lineitem at ``--sf`` (``chip_smoke.nested_orders``, the card
run's table), then runs ``chip_smoke.ARRAYS`` at ``--sf`` and
``chip_smoke.ARRAYS_ALL_ROWS`` at ``chip_smoke.ARRAYS_SF_ALL_ROWS`` through
``trino_tpu``'s ``Engine`` on the CPU (``TpchConnector(split_rows=1<<21)``,
the card run's split size), with the engine's entries to each kernel path
wrapped as ``scripts/record_function_kernels.py`` wraps them.  Compiled
programs are cleared before each statement, so each traces afresh.  Prints
one ``REC`` line per statement, then the ``ARRAYS_REQUIRED`` table to paste
into ``chip_smoke.py``.  This script imports JAX; the port does not need it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(sf: float) -> dict:
    """{statement: sorted kernel names} over A1-A7."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, _ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke
    import trino_tpu.exec.local_executor as LE
    import trino_tpu.ops.hashagg as HA
    import trino_tpu.ops.hashjoin as HJ
    from trino_tpu import Engine
    from trino_tpu.connectors.memory import MemoryConnector
    from trino_tpu.connectors.tpch import TpchConnector

    seen: set = set()

    def wrap(mod, name, kernel):
        f = getattr(mod, name)

        def counted(*a, **kw):
            seen.add(kernel)
            return f(*a, **kw)

        setattr(mod, name, counted)

    wrap(HA, "groupby_insert", "hash_insert")
    for mod in (HJ, LE):
        for name, kernel in (("build_insert", "hash_insert"), ("multi_build", "hash_insert"),
                             ("probe", "hash_probe"), ("probe_slots", "hash_probe")):
            if hasattr(mod, name):
                wrap(mod, name, kernel)
    wrap(LE, "compact_rows", "compact_rows")

    def engine(scale):
        e = Engine()
        e.register_catalog("tpch", TpchConnector(sf=scale, split_rows=1 << 21))
        e.register_catalog("memory", MemoryConnector())
        return e, e.create_session("memory")

    out = {}
    for scale, statements in ((sf, chip_smoke.ARRAYS),
                              (chip_smoke.ARRAYS_SF_ALL_ROWS, chip_smoke.ARRAYS_ALL_ROWS)):
        e, sess = engine(scale)
        li = e.execute_sql("select l_orderkey, l_linenumber, l_partkey, l_suppkey, "
                           "l_shipmode from tpch.lineitem", sess)
        od = e.execute_sql("select o_orderkey, o_custkey, o_orderdate from tpch.orders", sess)
        cols = chip_smoke.nested_orders(od.raw_columns, [li.raw_columns[i] for i in range(4)]
                                        + [li.columns[4]])
        e.execute_sql(chip_smoke.NESTED_DDL, sess)
        e.catalogs["memory"].append("orders_nested", cols)
        e._invalidate()
        for q, sql in statements.items():
            jax.clear_caches()
            seen.clear()
            t0 = time.time()
            e.execute_sql(sql, sess)
            out[q] = sorted(seen)
            print(f"REC {q} {out[q]} {time.time() - t0:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    got = record(args.sf)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1)
    print(f"# scripts/record_array_kernels.py --sf {args.sf:g}")
    print("ARRAYS_REQUIRED = {")
    for q, kernels in got.items():
        if kernels:
            print(f'    "{q}": {tuple(kernels)!r},')
    print("}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
