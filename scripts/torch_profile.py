#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port: one warm run of each TPC-H
query (``chip_smoke.ALL_QUERIES``: every query but Q15) under
``torch.profiler`` on the card, then every kernel wrapper split into kernel,
other device work, device idle and host time.

    python3 scripts/torch_profile.py [--sf 1] [--out profile_sf1.json]
                                     [--package-root DIR]

Per query it reports the host wall time, the summed device time of every
kernel the run launched, the device busy share (device time / wall), the
number of device operations, the top kernels by device time, and per port
kernel wrapper: the device time and launch count of its own CUDA kernels
(``trino_tpu_torch/csrc``, read from the sources by ``port_kernels``), and the
totals of its ``record_function`` range (calls, host time, and the device
span the profiler mirrors onto the card's timeline).  Sums over the 21
queries follow.

Then ``compact_rows``, ``hash_insert`` and ``hash_probe`` are each called at
the largest and at the most frequent shape the queries launched them at
(synthetic inputs, ``chip_smoke.compact_case`` / ``insert_case`` /
``probe_case``), ``hash_insert`` also on the main path's own keys
(``chip_smoke.lineitem_keys``), and ``fused_segment_agg``, which no query
launches, at ``chip_smoke.segment_cases`` (Q1's group-by over one lineitem
split, and its 128-slot ceiling); each call's time is split by
``chip_smoke.device_split``: wall, kernel-only device time, the wrapper's
other device operations, device idle between launches, and host enqueue
time.  ``hash_insert`` is split in its functional form and, where the
package has it, its in-place form ``hash_insert_``; ``hash_probe`` with a
payload array and in slot mode (a package whose probe takes h0 and step gets
them, and an iota payload, computed outside the timed call), and as
``hashjoin.probe`` (pack, hash and probe: the same call in every version of
the package, so the fair comparison of a parent and a change).

``--set tpcds`` profiles, instead, the TPC-DS corpus queries that run a
window function (``OVER``; the SQL of tests/test_tpcds*.py) at ``--sf`` on
``TpcdsConnector(split_rows=1<<21)``, with no wrapper splits.  For every
query, each set also splits the device time by kernel kind (sort, scan,
gather/scatter, reduce, elementwise, the port's kernels, other) and reports
the host's share, wall less device time; the ``window`` range (the window
kernel: sorts, scans and the scatter back) reports its host time and the
device span the profiler mirrors onto the card.  The set then profiles the
window queries four more times, in turns with the window module's
fixed-order floating prefix sum and with ``torch.cumsum`` in its place
(``compare_cumsum``).

``--package-root DIR`` profiles the ``trino_tpu_torch`` found under DIR (for
example an unpacked parent commit) with this script's own measurement code.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

TOP = 8  # kernels listed per query
SPLIT_KERNELS = ("compact_rows", "hash_insert", "hash_probe", "fused_segment_agg")
# device kernel kinds, by name, first match wins (after the port's kernels)
KINDS = (("sort", r"(?i)sort|radix"), ("scan", r"(?i)scan|cumsum|cummax|cummin"),
         ("gather/scatter", r"(?i)index|gather|scatter"), ("reduce", r"(?i)reduce"),
         ("elementwise", r"(?i)elementwise|vectorized|unrolled"))


def kinds_ms(dev, kernels):
    """Device ms per kernel kind (KINDS, the port's kernels, other)."""
    import re

    from chip_smoke import is_port_kernel

    out = collections.Counter()
    ports = [n for names in kernels.values() for n in names]
    for e in dev:
        ms = e.time_range.elapsed_us() / 1e3
        if is_port_kernel(e.name, ports):
            out["port kernels"] += ms
            continue
        out[next((k for k, rx in KINDS if re.search(rx, e.name)), "other")] += ms
    return dict(out)


def port_kernels(ck):
    """{wrapper: the __global__ kernels of its source}."""
    from chip_smoke import kernel_names

    return {w: kernel_names(w) for w in ck.STATS}


def profile_queries(engine, queries, ck, kernels, catalog="tpch"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_events, is_port_kernel

    report = {}
    for q, sql in queries.items():
        sess = engine.create_session(catalog)
        engine.execute_sql(sql, sess)  # cold run: CUDA context, allocator, caches
        torch.cuda.synchronize()
        with profile(acc_events=True,
                     activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.execute_sql(sql, sess)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        dev = device_events(prof)
        device_us = sum(e.time_range.elapsed_us() for e in dev)
        wrappers = {}
        for w, names in kernels.items():
            mine = [e for e in dev if is_port_kernel(e.name, names)]
            ranges = [e for e in events if e.name == w]
            host_r = [e for e in ranges
                      if e.device_type == torch.autograd.DeviceType.CPU]
            dev_r = [e for e in ranges
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            wrappers[w] = {
                "kernel_ms": sum(e.time_range.elapsed_us() for e in mine) / 1e3,
                "kernel_launches": len(mine),
                "range_calls": len(host_r),
                "range_host_ms": sum(e.time_range.elapsed_us() for e in host_r) / 1e3,
                "range_device_span_ms":
                    sum(e.time_range.elapsed_us() for e in dev_r) / 1e3 if dev_r else None,
            }
        # the executor's window range (the window kernel), besides the wrappers'
        win = [e for e in events if e.name == "window"]
        win_host = [e for e in win if e.device_type == torch.autograd.DeviceType.CPU]
        win_dev = [e for e in win if e.device_type == torch.autograd.DeviceType.CUDA]
        ranges = {"window": {
            "calls": len(win_host),
            "host_ms": sum(e.time_range.elapsed_us() for e in win_host) / 1e3,
            "device_span_ms":
                sum(e.time_range.elapsed_us() for e in win_dev) / 1e3 if win_dev else None}}
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in kernels \
                    or ev.key == "window":
                continue  # host operator rows repeat their kernels' time; ranges too
            dt = getattr(ev, "self_device_time_total", None)
            if dt is None:
                dt = getattr(ev, "self_cuda_time_total", 0)
            if dt > 0:
                rows.append((dt, ev.key, ev.count))
        rows.sort(reverse=True)
        report[q] = {
            "wall_ms": wall * 1e3,
            "device_ms": device_us / 1e3,
            "device_busy_share": (device_us / 1e6) / wall if wall else None,
            "device_ops": len(dev),
            "port_kernels": wrappers,
            "host_reads": engine.last_query_counters.get("host_reads"),
            "device_ms_by_kind": kinds_ms(dev, kernels),
            "host_ms": (wall * 1e3 - device_us / 1e3),
            "ranges": ranges,
            "top_kernels": [{"kernel": k, "device_ms": dt / 1e3, "calls": c}
                            for dt, k, c in rows[:TOP]],
        }
        r = report[q]
        port = {w: round(x["kernel_ms"], 4) for w, x in wrappers.items() if x["kernel_launches"]}
        print(f"{q}: wall_ms={r['wall_ms']:.3f} device_ms={r['device_ms']:.3f} "
              f"busy={r['device_busy_share']:.3f} device_ops={r['device_ops']} "
              f"host_reads={r['host_reads']} port_kernel_ms={port}", flush=True)
        print("    by kind: " + " ".join(f"{k}={v:.3f}" for k, v in
                                      sorted(r["device_ms_by_kind"].items()))
              + f" host={r['host_ms']:.3f} ranges={r['ranges']}", flush=True)
        for t in r["top_kernels"]:
            print(f"    {t['device_ms']:9.3f} ms  {t['calls']:6d}  {t['kernel'][:90]}")
    return report


def totals(report, kernels):
    """Sums over the queries: wall, device time, and per wrapper."""
    out = {"wall_ms": sum(r["wall_ms"] for r in report.values()),
           "device_ms": sum(r["device_ms"] for r in report.values()), "port_kernels": {},
           "device_ms_by_kind": dict(sum((collections.Counter(r["device_ms_by_kind"])
                                          for r in report.values()), collections.Counter()))}
    out["device_busy_share"] = out["device_ms"] / out["wall_ms"] if out["wall_ms"] else None
    for w in kernels:
        rs = [r["port_kernels"][w] for r in report.values()]
        spans = [x["range_device_span_ms"] for x in rs if x["range_device_span_ms"] is not None]
        out["port_kernels"][w] = {
            "kernel_ms": sum(x["kernel_ms"] for x in rs),
            "kernel_launches": sum(x["kernel_launches"] for x in rs),
            "range_calls": sum(x["range_calls"] for x in rs),
            "range_host_ms": sum(x["range_host_ms"] for x in rs),
            "range_device_span_ms": sum(spans) if spans else None,
        }
    return out


def _probe_forms(ck, table, rows, packed, valid):
    """{form: (call, setup)} of the probe at one shape: the wrapper with a
    payload and in slot mode, and hashjoin.probe."""
    import inspect

    import torch

    from chip_smoke import join_probe_call

    C = table.shape[0] - 1
    t = table[:C]
    if "h0" in inspect.signature(ck.hash_probe).parameters:
        # a package whose probe takes the hashes: computed here, untimed
        from trino_tpu_torch.ops.hashing import probe_step, splitmix64

        h0 = splitmix64(packed)
        stp = probe_step(h0)
        iota = torch.arange(C, dtype=torch.int32, device=table.device)
        payload = lambda: ck.hash_probe(t, rows[:C], packed, h0, stp, valid)  # noqa: E731
        slots = lambda: ck.hash_probe(t, iota, packed, h0, stp, valid)  # noqa: E731
    else:
        payload = lambda: ck.hash_probe(t, rows[:C], packed, valid)  # noqa: E731
        slots = lambda: ck.hash_probe(t, None, packed, valid)  # noqa: E731
    return {"hash_probe": (payload, None), "hash_probe slots": (slots, None),
            "hashjoin.probe": (join_probe_call(table, rows, packed, valid), None)}


def split_kernels(ck, shapes, kernels, conn, seed=7):
    """device_split of every kernel wrapper (module docstring): at the
    largest and the most frequent shape of the queries' run, and at the
    extra cases each kernel has."""
    import numpy as np
    import torch

    from chip_smoke import (Q1_COLUMNS, compact_case, device_split, insert_case,
                            lineitem_keys, probe_case, segment_cases)
    from trino_tpu_torch.ops.hashing import EMPTY_KEY

    gen = np.random.default_rng(seed)
    out = []
    for w in SPLIT_KERNELS:
        seen = [tuple(s) for s in shapes[w]]
        cases = []
        if seen:
            largest = max(seen, key=lambda s: (s[0], s[1]))
            frequent = collections.Counter(seen).most_common(1)[0][0]
            cases = [("largest", largest), ("most_frequent", frequent)]
        if w == "hash_insert":
            cases.append(("lineitem_orderkey", None))
        if w == "fused_segment_agg":
            page = conn.generate(conn.splits("lineitem")[0], Q1_COLUMNS)
            cases = [(label, case) for label, case in segment_cases(page)]
        for which, shape in cases:
            if w == "compact_rows":
                n, out_len, widths = shape
                cols, valid = compact_case(gen, n, out_len, widths)
                forms = {"compact_rows": (lambda: ck.compact_rows(cols, valid, out_len),
                                          None)}
                shape = [n, out_len, list(widths)]
            elif w == "hash_probe":
                forms = _probe_forms(ck, *probe_case(gen, *shape))
            elif w == "fused_segment_agg":
                case = shape
                shape = [case["slot"].shape[0], case["n_slots"], len(case["values"])]
                forms = {"fused_segment_agg": (
                    lambda: ck.fused_segment_agg(case["slot"], case["valid"],
                                                 case["values"], case["n_slots"]), None)}
            else:
                if shape is None:
                    packed, valid = lineitem_keys(conn)
                    distinct = int(torch.unique(packed[valid]).numel())
                    shape = (packed.shape[0], 1 << (2 * distinct - 1).bit_length())
                else:
                    packed, valid = insert_case(gen, *shape)
                n, C = shape
                table0 = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64,
                                    device=packed.device)
                forms = {"hash_insert": (lambda: ck.hash_insert(table0, packed, valid), None)}
                if hasattr(ck, "hash_insert_"):
                    table = table0.clone()
                    forms["hash_insert_"] = (lambda: ck.hash_insert_(table, packed, valid),
                                             lambda: table.fill_(EMPTY_KEY))
            for form, (fn, setup) in forms.items():
                got = device_split(fn, kernels[w], setup=setup)
                rec = {"kernel": w, "form": form, "which": which, "shape": list(shape), **got}
                out.append(rec)
                print(f"split {form} {which} {rec['shape']}: "
                      + " ".join(f"{k}={v}" for k, v in got.items()), flush=True)
            torch.cuda.empty_cache()
    return out


def profile_tpcds(args, ck, kernels) -> int:
    """The TPC-DS window queries under the profiler (module docstring)."""
    import re

    from chip_smoke import card_line
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.connectors.tpcds_queries import corpus

    queries = {q: sql for q, sql in corpus().items()
               if re.search(r"(?i)\bover\s*\(", sql)}
    engine = Engine(device="cuda")
    engine.register_catalog("tpcds", TpcdsConnector(sf=args.sf, split_rows=1 << 21))
    report = {"card": card_line(), "sf": args.sf, "set": "tpcds", "port_kernels": kernels}
    print(f"card: {report['card']}", flush=True)
    report["queries"] = profile_queries(engine, queries, ck, kernels, "tpcds")
    report["totals"] = totals(report["queries"], kernels)
    print("totals: " + json.dumps(report["totals"]), flush=True)
    report["cumsum"] = compare_cumsum(engine, queries, ck, kernels)
    _write(report, args.out)
    return 0


def compare_cumsum(engine, queries, ck, kernels):
    """The window queries with the window module's floating prefix sum
    (``ops/window._cumsum``, a fixed-order log-step scan) and with
    ``torch.cumsum`` in its place, in turns (scan, torch, torch, scan):
    per round the sums over the queries of wall, device time, device
    operations, and the ``window`` range's host time and device span."""
    import torch

    from trino_tpu_torch.ops import window

    scan = window._cumsum
    variants = {"scan": scan, "torch.cumsum": lambda v: torch.cumsum(v, 0)}
    rounds = []
    for name in ("scan", "torch.cumsum", "torch.cumsum", "scan"):
        window._cumsum = variants[name]
        try:
            got = profile_queries(engine, queries, ck, kernels, "tpcds")
        finally:
            window._cumsum = scan
        win = [r["ranges"]["window"] for r in got.values()]
        rec = {"variant": name,
               "wall_ms": sum(r["wall_ms"] for r in got.values()),
               "device_ms": sum(r["device_ms"] for r in got.values()),
               "device_ops": sum(r["device_ops"] for r in got.values()),
               "window_calls": sum(w["calls"] for w in win),
               "window_host_ms": sum(w["host_ms"] for w in win),
               "window_device_span_ms": sum(w["device_span_ms"] or 0.0 for w in win)}
        rounds.append(rec)
        print("cumsum " + json.dumps(rec), flush=True)
    return rounds


def _write(report, path):
    text = json.dumps(report)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text + "\n")
    print(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--out", default=None, help="write the JSON report here too")
    ap.add_argument("--set", default="tpch", choices=("tpch", "tpcds"),
                    help="the TPC-H queries and wrapper splits, or the TPC-DS "
                         "window queries")
    ap.add_argument("--package-root", default=None,
                    help="profile the trino_tpu_torch under this directory")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import ALL_QUERIES, card_line

    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import cuda_kernels as ck

    ck.build_kernels()
    kernels = port_kernels(ck)
    if args.set == "tpcds":
        return profile_tpcds(args, ck, kernels)
    engine = Engine(device="cuda")
    conn = TpchConnector(sf=args.sf, split_rows=1 << 21)
    engine.register_catalog("tpch", conn)
    report = {"card": card_line(), "sf": args.sf, "package": os.path.dirname(
        os.path.dirname(os.path.abspath(ck.__file__))), "port_kernels": kernels}
    print(f"card: {report['card']}  package: {report['package']}", flush=True)
    ck.reset_stats()
    report["queries"] = profile_queries(engine, ALL_QUERIES, ck, kernels)
    report["totals"] = totals(report["queries"], kernels)
    print("totals: " + json.dumps(report["totals"]), flush=True)
    shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
    del engine
    torch.cuda.empty_cache()
    report["split"] = split_kernels(ck, shapes, kernels, conn)
    _write(report, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
