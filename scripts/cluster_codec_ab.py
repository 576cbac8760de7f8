#!/usr/bin/env python3
"""The cluster's spool codec on one card: bench.py's Q18 at SF1, Q9 at SF10
and Q9 at SF1 (chip_smoke.QUERIES) through a coordinator and two worker
processes (``chip_smoke.start_workers``, phase 20's catalogs and shares),
with the frame codec zlib (the default where ``zstandard`` is missing, as
on the card machine) and with none, in turns: zlib, none, zlib, none.  Each
statement runs twice a turn (the first cold); after the first ``none`` turn
one worker is killed by SIGKILL in the middle of Q9 (``chip_smoke.cluster_kill``).

    python3 scripts/cluster_codec_ab.py

Prints the card's ``nvidia-smi`` line and one line per statement and turn:
the two walls, the spool bytes, the workers' host bytes and the local
fallbacks; then the kill record.  Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cluster_codec_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from trino_tpu_torch.exec import fte
    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.server.cluster import ClusterCoordinator

    print(cs.card_line(), flush=True)
    ck.build_kernels()
    os.environ.update(TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_RESULT_CACHE="0",
                      TRINO_TPU_ADAPTIVE="0")
    engine = cs.cluster_engine(cs.SF_BIG)
    killed = False
    for codec in ("zlib", "none", "zlib", "none"):
        spool = tempfile.mkdtemp(prefix="trino-codec-ab-")
        fte.PAGE_CODEC = codec  # read per frame
        coord = ClusterCoordinator(engine, spool, heartbeat_interval=0.2)
        url = coord.start()
        procs = cs.start_workers(url, spool, 2, spool, {"TRINO_TPU_PAGE_CODEC": codec})
        try:
            coord.wait_for_workers(2, timeout=cs.CLUSTER_WORKER_START_S)
            for cat, q in (("tpch", "q18"), ("tpch_big", "q9"), ("tpch", "q9")):
                sess = engine.create_session(cat)
                sess.properties["page_cache"] = False
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    coord.execute_sql(cs.QUERIES[q], sess)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                print(f"codec {codec} {cat} {q}: walls {walls} spool {coord.last_spool_bytes} "
                      f"worker host bytes {coord._qc_workers.host_bytes} "
                      f"fallbacks {coord.local_fallbacks}", flush=True)
            if codec == "none" and not killed:
                local_q9 = engine.execute_sql(cs.QUERIES["q9"], engine.create_session("tpch"))
                cs.cluster_kill(coord, engine, procs, local_q9)
                killed = True
        finally:
            cs.stop_workers(procs)
            coord.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
