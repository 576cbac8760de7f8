#!/usr/bin/env python3
"""Which of the kernel paths the JAX reference reaches for each query of
``chip_smoke.py``'s phase 9 (the function library's path, F1-F7): the
recording behind ``chip_smoke.FUNCTIONS_REQUIRED``.

    python3 scripts/record_function_kernels.py [--sf 0.1] [--out function_kernels.json]

Runs ``chip_smoke.FUNCTIONS`` through ``trino_tpu``'s ``Engine`` on the CPU
at ``--sf`` (``TpchConnector(split_rows=1<<21)``, the card run's split
size), with the engine's entries to each kernel path wrapped, as
``scripts/record_memory_kernels.py`` wraps them: ``hashagg.groupby_insert``
and the join builds ``build_insert`` / ``multi_build`` count as
``hash_insert``, ``probe`` / ``probe_slots`` as ``hash_probe``, and
``local_executor.compact_rows`` as ``compact_rows``.  Compiled programs are
cleared before each query, so each traces afresh and every path it takes is
seen.  Prints one ``REC`` line per query, then the ``FUNCTIONS_REQUIRED``
table to paste into ``chip_smoke.py`` (queries that reach none of the paths
are left out).  This script imports JAX; the port does not need it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(sf: float) -> dict:
    """{query: sorted kernel names} over ``chip_smoke.FUNCTIONS``."""
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

    engine = Engine()
    engine.register_catalog("tpch", TpchConnector(sf=sf, split_rows=1 << 21))
    sess = engine.create_session("tpch")
    out = {}
    for q, sql in chip_smoke.FUNCTIONS.items():
        jax.clear_caches()
        seen.clear()
        t0 = time.time()
        engine.execute_sql(sql, sess)
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
    print(f"# scripts/record_function_kernels.py --sf {args.sf:g}")
    print("FUNCTIONS_REQUIRED = {")
    for q, kernels in got.items():
        if kernels:
            print(f'    "{q}": {tuple(kernels)!r},')
    print("}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
