#!/usr/bin/env python3
"""Per-query warm wall times of two ``trino_tpu_torch`` checkouts on one
card, in turns, so that a change is compared with its parent on the same
card and host in one run.

    python3 scripts/warm_walls.py --base parent --rounds 2 [--sf 1]
                                  [--out walls.json]

Each round runs every TPC-H query of ``chip_smoke.ALL_QUERIES`` (cold once,
then the faster of two warm runs, ``chip_smoke.run_queries``) first in the
checkout under ``--base`` and then in this one, and the next round in the
other order (base, change, change, base for two rounds).  Each side runs in
its own process, so the two packages never share a CUDA context or an
allocator.  Prints one line per query with every run's warm wall and the
medians, and the medians' sums.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_side(package_root: str, sf: float) -> dict:
    """Run in a child process: {query: warm seconds} of the package under
    ``package_root``."""
    sys.path.insert(0, _ROOT)
    from chip_smoke import ALL_QUERIES, Q15_VIEW, SPLIT_ROWS, run_queries

    sys.path.insert(0, os.path.abspath(package_root))
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import cuda_kernels as ck

    ck.build_kernels()
    conn = TpchConnector(sf=sf, split_rows=SPLIT_ROWS)
    engine = Engine(device="cuda")
    engine.register_catalog("tpch", conn)
    engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))  # the view Q15 reads
    got = run_queries(engine, ALL_QUERIES, conn.exact_row_count("lineitem"), "walls")
    return {q: r["warm_s"] for q, r in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="checkout to compare with (its root)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--side", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side is not None:
        print(json.dumps(one_side(args.side, args.sf)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("warm_walls: no CUDA device available", file=sys.stderr)
        return 2
    sides = {"base": args.base, "change": _ROOT}
    runs = {"base": [], "change": []}
    for r in range(args.rounds):
        for side in (("base", "change") if r % 2 == 0 else ("change", "base")):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--base",
                                  args.base, "--sf", str(args.sf), "--side", sides[side]],
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            runs[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(f"round {r} {side}: done", flush=True)
    report = {"sf": args.sf, "rounds": args.rounds, "queries": {}}
    for q in runs["base"][0]:
        b = [x[q] for x in runs["base"]]
        c = [x[q] for x in runs["change"]]
        report["queries"][q] = {"base_s": b, "change_s": c, "base_median_s": statistics.median(b),
                                "change_median_s": statistics.median(c)}
        print(f"{q}: base={b} change={c} median base={statistics.median(b)} "
              f"change={statistics.median(c)}", flush=True)
    for side in ("base", "change"):
        report[f"{side}_median_sum_s"] = sum(v[f"{side}_median_s"]
                                             for v in report["queries"].values())
    print(f"sum of medians: base={report['base_median_sum_s']} "
          f"change={report['change_median_sum_s']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(report) + "\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
