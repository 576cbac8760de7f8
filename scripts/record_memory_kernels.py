#!/usr/bin/env python3
"""Which of the kernel paths the JAX reference reaches for each statement of
``chip_smoke.py``'s phase 8 (TPC-H's refresh path over the memory catalog):
the recording behind ``chip_smoke.MEMORY_REQUIRED``.

    python3 scripts/record_memory_kernels.py [--sf 0.1] [--out memory_kernels.json]

Runs ``chip_smoke.refresh_path``'s statements through ``trino_tpu``'s
``Engine`` on the CPU at ``--sf`` (``TpchConnector(split_rows=1<<21)``, the
card run's split size, and a ``MemoryConnector`` as the session catalog): the
load, RF1, the query block (``chip_smoke.MEMORY_QUERIES``, Q15 through its
view) and RF2, with the engine's entries to each kernel path wrapped, as
``scripts/record_tpcds_kernels.py`` wraps them: ``hashagg.groupby_insert``
and the join builds ``build_insert`` / ``multi_build`` count as
``hash_insert``, ``probe`` / ``probe_slots`` as ``hash_probe``, and
``local_executor.compact_rows`` as ``compact_rows``.  Compiled programs are
cleared before each statement, so each traces afresh and every path it takes
is seen.  Also Q15 over ``tpch`` alone (the view over the generated
lineitem, as phase 2 runs it), under the label ``tpch_q15``.

The default scale is SF0.1: the reference writes through python lists
(``_coerce_host`` per value), which at SF1 takes the CPU many minutes and
gigabytes; over memory tables, which report no column ranges, the joins and
group-bys take the hash paths at every scale.  Prints one ``REC`` line per
statement, then the ``MEMORY_REQUIRED`` table to paste into
``chip_smoke.py`` (statements that reach none of the paths are left out).
DELETE's compaction is the port's own (the reference deletes with a boolean
index) and is checked by ``chip_smoke.py`` separately.  This script imports
JAX; the port does not need it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(sf: float) -> dict:
    """{statement label: sorted kernel names} over the refresh path."""
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

    tpch = TpchConnector(sf=sf, split_rows=1 << 21)
    engine = Engine()
    engine.register_catalog("tpch", tpch)
    engine.register_catalog("memory", MemoryConnector())
    sess = engine.create_session("memory")
    out = {}

    def run(label, sql, session=sess):
        jax.clear_caches()
        seen.clear()
        t0 = time.time()
        engine.execute_sql(sql, session)
        if label is not None:
            out[label] = sorted(seen)
            print(f"REC {label} {out[label]} {time.time() - t0:.1f} s", flush=True)

    tpch_sess = engine.create_session("tpch")
    run(None, chip_smoke.Q15_VIEW, tpch_sess)
    run("tpch_q15", chip_smoke.ALL_QUERIES["q15"], tpch_sess)
    run(None, "drop view revenue0", tpch_sess)
    path = chip_smoke.refresh_path(tpch.row_count("orders"))
    for step in ("load", "rf1"):
        for label, sql in path[step]:
            run(label, sql)
    for q in chip_smoke.MEMORY_QUERIES:
        if q == "q15":
            run(None, chip_smoke.Q15_VIEW)
        run(q, chip_smoke.ALL_QUERIES[q])
        if q == "q15":
            run(None, "drop view revenue0")
    for label, sql in path["rf2"]:
        run(label, sql)
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
    print(f"# scripts/record_memory_kernels.py --sf {args.sf:g}")
    print("MEMORY_REQUIRED = {")
    for label, kernels in got.items():
        if kernels and label != "tpch_q15":
            print(f'    "{label}": {tuple(kernels)!r},')
    print("}")
    print(f"tpch_q15 (phase 2's REQUIRED): {tuple(got['tpch_q15'])!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
