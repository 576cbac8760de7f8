#!/usr/bin/env python3
"""Which of the four kernel paths the JAX reference reaches for each TPC-DS
corpus query: the recording behind ``chip_smoke.TPCDS_REQUIRED``.

    python3 scripts/record_tpcds_kernels.py [--sf 1] [--workers 3]
                                            [--out tpcds_kernels.json]

Runs every query of the corpus (``trino_tpu_torch.connectors.tpcds_queries``,
the SQL of tests/test_tpcds*.py) through ``trino_tpu``'s ``Engine`` on the
CPU at ``--sf`` (``TpcdsConnector(split_rows=1<<21)``, chip_smoke's split
size), with the engine's entries to each kernel path wrapped:
``hashagg.groupby_insert`` and the join builds ``build_insert`` /
``multi_build`` count as ``hash_insert``, ``probe`` / ``probe_slots`` as
``hash_probe``, and ``local_executor.compact_rows`` as ``compact_rows``.
Compiled programs are cleared before each query, so each query traces
afresh and every path it takes is seen.  The queries are dealt round robin
to ``--workers`` processes.  Prints one ``REC`` line per query, then the
``TPCDS_REQUIRED`` table to paste into ``chip_smoke.py`` (queries that
reach none of the paths are left out of it); ``--out`` also writes
{query: [kernel, ...]} as JSON.  This script imports JAX; the port does not
need it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(sf: float, worker: int, workers: int) -> dict:
    """{query: sorted kernel names, or "ERR ..."} for this worker's share."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, _ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)
    import trino_tpu.exec.local_executor as LE
    import trino_tpu.ops.hashagg as HA
    import trino_tpu.ops.hashjoin as HJ
    from trino_tpu import Engine
    from trino_tpu.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.connectors.tpcds_queries import corpus

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
    engine.register_catalog("tpcds", TpcdsConnector(sf=sf, split_rows=1 << 21))
    out = {}
    for i, (q, sql) in enumerate(corpus().items()):
        if i % workers != worker:
            continue
        jax.clear_caches()
        seen.clear()
        t0 = time.time()
        try:
            engine.execute_sql(sql, engine.create_session("tpcds"))
            out[q] = sorted(seen)
        except Exception as e:  # noqa: BLE001 - recorded and reported, not hidden
            out[q] = f"ERR {e!r}"[:200]
        print(f"REC {q} {out[q]} {time.time() - t0:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.worker is not None:
        print("RESULT " + json.dumps(record(args.sf, args.worker, args.workers)), flush=True)
        return 0
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sf", str(args.sf),
                               "--workers", str(args.workers), "--worker", str(w)],
                              stdout=subprocess.PIPE, text=True)
             for w in range(args.workers)]
    got = {}
    for p in procs:
        for line in p.stdout:
            if line.startswith("RESULT "):
                got.update(json.loads(line[len("RESULT "):]))
            else:
                print(line, end="", flush=True)
        if p.wait() != 0:
            print(f"record_tpcds_kernels: a worker exited {p.returncode}", file=sys.stderr)
            return 1
    sys.path.insert(0, _ROOT)
    from trino_tpu_torch.connectors.tpcds_queries import corpus

    got = {q: got[q] for q in corpus()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1)
    errors = [q for q, v in got.items() if isinstance(v, str)]
    print("TPCDS_REQUIRED = {")
    for q, kernels in got.items():
        if kernels and not isinstance(kernels, str):
            print(f'    "{q}": {tuple(kernels)!r},')
    print("}")
    if errors:
        print(f"record_tpcds_kernels: {len(errors)} queries raised: {' '.join(errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
