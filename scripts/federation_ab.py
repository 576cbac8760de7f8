#!/usr/bin/env python3
"""Warm walls of ``chip_smoke.py`` phase 18's federated statements (18b's Q3
and reconciliation, 18c's index join) in one ``trino_tpu_torch`` checkout,
on the card, over a sqlite copy of TPC-H SF1 orders and customer.  Compare
two checkouts by running this once per side in turns on one machine
(parent, change, change, parent), each side in its own process:

    python3 scripts/federation_ab.py . remote.db load      # write the database once
    for side in parent . . parent; do
        python3 scripts/federation_ab.py $side remote.db
    done

The first argument is the checkout whose package and ``chip_smoke.py`` are
imported.  Each statement runs four times: the first is cold, the other
three warm.  Prints one JSON line per side with every wall, the warm
median, ``h2d_bytes`` and the first rows.  The buffer pool's tiers and the
adaptive advisor are off, as in phase 18.  Needs a CUDA card.
"""

import json
import os
import statistics
import sys
import time

root, db = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if sys.argv[3:] == ["load"]:
    from trino_tpu_torch.connectors.tpch import TpchConnector
    t0 = time.perf_counter()
    print("loaded", cs.load_remote(db, TpchConnector(sf=1, split_rows=cs.SPLIT_ROWS, device="cpu")),
          time.perf_counter() - t0, flush=True)
    sys.exit(0)
os.environ["TRINO_TPU_PAGE_CACHE"] = "0"
os.environ["TRINO_TPU_RESULT_CACHE"] = "0"
os.environ["TRINO_TPU_ADAPTIVE"] = "0"
e = cs.fed_engine(db, "cuda")
for t in cs.FED_TABLES:
    e.catalogs["db"].dictionaries(t)
out = {"root": root}
for label, sql in (("q3", cs.FED_Q3), ("reconcile", cs.FED_RECONCILE), ("index", cs.FED_INDEX)):
    walls = []
    s = e.create_session("db")
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = e.execute_sql(sql, s)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[label] = {"cold": walls[0], "warm": walls[1:], "warm_median": statistics.median(walls[1:]),
                  "h2d_bytes": e.last_query_counters["h2d_bytes"], "rows": r.rows()[:2]}
print(json.dumps(out, default=str), flush=True)
