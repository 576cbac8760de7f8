#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port: one warm run of each TPC-H
query (``chip_smoke.ALL_QUERIES``: every query but Q15) under
``torch.profiler`` on the card.

    python3 scripts/torch_profile.py [--sf 1] [--out profile_sf1.json]

Per query it reports the host wall time, the summed device time of every
kernel the run launched, the device busy share (device time / wall), the
number of kernel launches, the device time of the port's own CUDA kernels
(``trino_tpu_torch/csrc``), and the top kernels by device time.  Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

TOP = 8  # kernels listed per query
# device kernel names of trino_tpu_torch/csrc, by the wrapper that launches them
PORT_KERNELS = {"hash_insert": ("hash_insert_kernel",),
                "hash_probe": ("hash_probe_kernel",),
                "compact_rows": ("block_counts_kernel", "scan_offsets_kernel",
                                 "scatter_kernel"),
                "fused_segment_agg": ("segment_agg_kernel",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--out", default=None, help="write the JSON report here too")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import ALL_QUERIES, card_line
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import cuda_kernels as ck

    ck.build_kernels()
    engine = Engine(device="cuda")
    engine.register_catalog("tpch", TpchConnector(sf=args.sf, split_rows=1 << 21))
    report = {"card": card_line(), "sf": args.sf, "queries": {}}
    for q, sql in ALL_QUERIES.items():
        sess = engine.create_session("tpch")
        engine.execute_sql(sql, sess)  # cold run: CUDA context, allocator, caches
        torch.cuda.synchronize()
        with profile(acc_events=True,
                     activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.execute_sql(sql, sess)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.time_range.elapsed_us() for e in kernels)
        port_us = {w: sum(e.time_range.elapsed_us() for e in kernels
                          if any(k in e.name for k in names))
                   for w, names in PORT_KERNELS.items()}
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host-side operator rows repeat their kernels' time
            dt = getattr(ev, "self_device_time_total", None)
            if dt is None:
                dt = getattr(ev, "self_cuda_time_total", 0)
            if dt > 0:
                rows.append((dt, ev.key, ev.count))
        rows.sort(reverse=True)
        report["queries"][q] = {
            "wall_ms": wall * 1e3,
            "device_ms": device_us / 1e3,
            "device_busy_share": (device_us / 1e6) / wall if wall else None,
            "kernel_launches": len(kernels),
            "port_kernels_ms": {w: us / 1e3 for w, us in port_us.items()},
            "host_reads": engine.last_query_counters.get("host_reads"),
            "top_kernels": [{"kernel": k, "device_ms": dt / 1e3, "calls": c}
                            for dt, k, c in rows[:TOP]],
        }
        r = report["queries"][q]
        print(f"{q}: wall_ms={r['wall_ms']:.3f} device_ms={r['device_ms']:.3f} "
              f"busy={r['device_busy_share']:.3f} launches={r['kernel_launches']} "
              f"host_reads={r['host_reads']} port_kernels_ms={r['port_kernels_ms']}",
              flush=True)
        for t in r["top_kernels"]:
            print(f"    {t['device_ms']:9.3f} ms  {t['calls']:6d}  {t['kernel'][:90]}")
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
