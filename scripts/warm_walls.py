#!/usr/bin/env python3
"""Per-query warm wall times of two ``trino_tpu_torch`` checkouts on one
card, in turns, so that a change is compared with its parent on the same
card and host in one run.

    python3 scripts/warm_walls.py --base parent --rounds 2 [--sf 1]
                                  [--templates 8] [--also-env KEY=VALUE]
                                  [--out walls.json]

Each round runs every TPC-H query of ``chip_smoke.ALL_QUERIES`` (cold once,
then the faster of two warm runs, ``chip_smoke.run_queries``) first in the
checkout under ``--base`` and then in this one, and the next round in the
other order (base, change, change, base for two rounds; with a third side
each round starts one side later).  Each side runs in
its own process, so the two packages never share a CUDA context or an
allocator.  ``--templates N`` also times ``chip_smoke.TEMPLATES`` (T1-T6):
each is prepared and executed once (the miss), then N bindings each run
once untimed and once timed as a template hit; a side's number is the
median hit.  ``--also-env KEY=VALUE`` adds a third side: this checkout with
that variable set.  Prints one line per query and template with every
run's wall and the medians, and the medians' sums.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def template_hits(engine, n: int) -> dict:
    """{template: median seconds of its hits}: ``n`` bindings of each of
    T1-T6 (``numpy.random.default_rng(14)``, no NULL and none outside the
    domain), each run once untimed (its first request may store a split)
    and once timed."""
    import numpy as np

    from chip_smoke import (SF_MAIN, TEMPLATE_EXECUTES, TEMPLATE_NULL_AT, TEMPLATE_OUTSIDE_AT,
                            TEMPLATES, check, sql_literal, template_sessions, template_values,
                            timed_statement)

    gen = np.random.default_rng(14)
    (sess,) = template_sessions(engine)
    plans = {"plans": 0}
    out = {}
    for name, text in TEMPLATES.items():
        vals = [v for i, v in enumerate(template_values(gen, name, TEMPLATE_EXECUTES, SF_MAIN))
                if i not in (TEMPLATE_NULL_AT, TEMPLATE_OUTSIDE_AT)][:n + 1]
        stmts = [f"execute {name} using " + ", ".join(sql_literal(x) for x in v) for v in vals]
        engine.execute_sql(f"prepare {name} from {text}", sess)
        engine.execute_sql(stmts[0], sess)  # the miss that creates the template
        walls = []
        for stmt in stmts[1:]:
            engine.execute_sql(stmt, sess)
            _, r = timed_statement(engine, stmt, sess, plans)
            check(r["hits"] == 1, f"{name}: not a template hit ({r})")
            walls.append(r["wall_s"])
        out[name] = statistics.median(walls)
    return out


def one_side(package_root: str, sf: float, templates: int) -> dict:
    """Run in a child process: {query or template: warm seconds} of the
    package under ``package_root``."""
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
    out = {q: r["warm_s"] for q, r in got.items()}
    if templates:
        out.update(template_hits(engine, templates))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="checkout to compare with (its root)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--templates", type=int, default=0,
                    help="template hits timed per statement of T1-T6 (0: none)")
    ap.add_argument("--also-env", default=None, metavar="KEY=VALUE",
                    help="a third side: this checkout with this variable set")
    ap.add_argument("--out", default=None)
    ap.add_argument("--side", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side is not None:
        print(json.dumps(one_side(args.side, args.sf, args.templates)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("warm_walls: no CUDA device available", file=sys.stderr)
        return 2
    sides = {"base": (args.base, {}), "change": (_ROOT, {})}
    if args.also_env:
        key, _, value = args.also_env.partition("=")
        sides[f"change+{key}={value}"] = (_ROOT, {key: value})
    runs = {side: [] for side in sides}
    names = list(sides)
    for r in range(args.rounds):
        # each round starts one side later: with as many rounds as sides,
        # every side runs once in every position
        for side in names[r % len(names):] + names[:r % len(names)]:
            root, env = sides[side]
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--base",
                                  args.base, "--sf", str(args.sf), "--templates",
                                  str(args.templates), "--side", root],
                                 capture_output=True, text=True, env={**os.environ, **env})
            if out.returncode:
                print(out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            runs[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(f"round {r} {side}: done", flush=True)
    report = {"sf": args.sf, "rounds": args.rounds, "templates": args.templates,
              "queries": {}}
    for q in runs["base"][0]:
        rec = report["queries"][q] = {}
        for side in sides:
            got = [x[q] for x in runs[side]]
            rec[f"{side}_s"], rec[f"{side}_median_s"] = got, statistics.median(got)
        print(f"{q}: " + " ".join(f"{side}={rec[side + '_s']}" for side in sides)
              + " median " + " ".join(f"{side}={rec[side + '_median_s']}" for side in sides),
              flush=True)
    for side in sides:
        report[f"{side}_median_sum_s"] = sum(v[f"{side}_median_s"]
                                             for q, v in report["queries"].items()
                                             if q.startswith("q"))
    print("sum of the queries' medians: " + " ".join(
        f"{side}={report[side + '_median_sum_s']}" for side in sides), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(report) + "\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
