#!/usr/bin/env python3
"""Where concurrent statements lose time on one card: bench.py's five TPC-H
queries (chip_smoke.QUERIES) through ``Engine.execute_sql`` and through the
coordinator server, from one thread and from four at once.

    python3 scripts/server_concurrency.py [--sf 1] [--threads 4] [--profile] [--sample]

Modes, each timed on the host clock after a warm-up, every statement run
twice per thread (in a rotated order per thread):

- ``direct_1`` / ``direct_N``: ``engine.execute_sql`` from 1 or N threads;
- ``server_N``: ``Client.execute`` from N threads against a
  ``CoordinatorServer(dispatch_threads=N)`` in this process.

Each mode also reports the process's CPU seconds over its window
(``time.process_time``).  ``--profile`` then runs ``direct_1`` and
``direct_N`` once more under ``torch.profiler`` and prints, for each, the
device's busy share of the window (the union of its device operations'
intervals over the wall) and the operators with the most host time.
``--sample`` runs ``direct_1`` and ``direct_N`` once more while a sampler
thread reads the worker threads' Python stacks every 2 ms
(``sys._current_frames``) and prints the innermost frames (file:line
function) they were found in most often: where the statements' threads
spend their wall time, waits inside C calls included.

Prints the card's ``nvidia-smi`` line, one line per mode (statements/s,
median and max statement wall) and a JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_threads(n, names, one):
    """Run ``one(q)`` for each query of ``names`` twice per thread, from
    ``n`` threads at once; returns (seconds, CPU seconds, statement walls)."""
    orders = [names[i % len(names):] + names[:i % len(names)] for i in range(n)]
    walls, errors = [], []

    def body(i):
        try:
            for q in orders[i] + orders[i][::-1]:
                t0 = time.perf_counter()
                one(q, i)
                walls.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    t0, c0 = time.perf_counter(), time.process_time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0, time.process_time() - c0, walls


def busy_share(events, wall_us):
    """The union of device operations' intervals over the window's wall."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0, None
    for a, z in spans:
        if end is None or a > end:
            busy += z - a
            end = z
        elif z > end:
            busy += z - end
            end = z
    return busy / wall_us if wall_us else None


def profiled(k, names, one):
    """One round of a mode under torch.profiler: its wall, the device's
    busy share and the 12 operators with the most self host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs, cpu, walls = run_threads(k, names, one)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    share = busy_share(dev, secs * 1e6)
    top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
    rows = [{"name": a.key[:60], "calls": a.count,
             "self_cpu_s": a.self_cpu_time_total / 1e6} for a in top]
    print(f"profile {k} thread(s): {len(walls)} statements in {secs} s, {cpu} CPU s, "
          f"device busy {share}", flush=True)
    for r in rows:
        print(f"  {r['name']}: {r['calls']} calls, {r['self_cpu_s']} s self host time",
              flush=True)
    return {"seconds": secs, "cpu_seconds": cpu, "device_busy_share": share, "top": rows}


def sampled(k, names, one, top=15):
    """One round of a mode while a sampler thread records, every 2 ms, the
    innermost Python frame of each thread that runs statements: the frames
    seen most often."""
    import collections

    counts: collections.Counter = collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            workers = {t.ident for t in threading.enumerate() if t.name.endswith("(body)")}
            for tid, frame in sys._current_frames().items():
                if tid in workers:
                    code = frame.f_code
                    counts[f"{os.path.basename(code.co_filename)}:{frame.f_lineno} "
                           f"{code.co_name}"] += 1
            time.sleep(0.002)

    t = threading.Thread(target=sample)
    t.start()
    try:
        secs, cpu, walls = run_threads(k, names, one)
    finally:
        stop.set()
        t.join()
    total = sum(counts.values())
    rows = [{"frame": f, "share": c / total} for f, c in counts.most_common(top)]
    print(f"samples {k} thread(s): {total} samples over {secs} s", flush=True)
    for r in rows:
        print(f"  {r['share']:.3f} {r['frame']}", flush=True)
    return {"seconds": secs, "samples": total, "top": rows}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sample", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("server_concurrency: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.server import Client, CoordinatorServer

    print(cs.card_line(), flush=True)
    ck.build_kernels()
    engine = Engine()
    engine.register_catalog("tpch", TpchConnector(sf=args.sf, split_rows=cs.SPLIT_ROWS))
    names = list(cs.QUERIES)
    srv = CoordinatorServer(engine, port=0, dispatch_threads=args.threads)
    srv.start()

    def direct(q, i):
        engine.execute_sql(cs.QUERIES[q], engine.create_session("tpch"))
        torch.cuda.synchronize()

    def server(q, i):
        Client(srv.url, catalog="tpch").execute(cs.QUERIES[q])

    n = args.threads
    modes = [("direct_1", 1, direct), (f"direct_{n}", n, direct),
             (f"server_{n}", n, server)]
    out = {"card": cs.card_line(), "sf": args.sf, "threads": n, "modes": {}}
    try:
        for q in names:  # warm-up
            direct(q, 0)
        for label, k, fn in modes:
            secs, cpu, walls = run_threads(k, names, fn)
            rec = {"statements": len(walls), "seconds": secs, "cpu_seconds": cpu,
                   "statements_per_s": len(walls) / secs,
                   "median_wall_s": statistics.median(walls), "max_wall_s": max(walls)}
            out["modes"][label] = rec
            print(f"{label}: {rec['statements']} statements in {secs} s = "
                  f"{rec['statements_per_s']} statements/s, {cpu} CPU s; wall median "
                  f"{rec['median_wall_s']} s, max {rec['max_wall_s']} s", flush=True)
        if args.profile:
            out["profiles"] = {m[0]: profiled(m[1], names, m[2]) for m in modes[:2]}
        if args.sample:
            out["samples"] = {m[0]: sampled(m[1], names, m[2]) for m in modes[:2]}
    finally:
        srv.stop()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
