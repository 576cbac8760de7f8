"""Interactive SQL CLI (reference: client/trino-cli Console.java:84 — JLine console with
aligned output; here a stdlib REPL with the same aligned-table default)."""

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "format_aligned"]


def format_aligned(column_names, rows) -> str:
    cols = [str(c) for c in column_names]
    table = [[("NULL" if v is None else str(v)) for v in row] for row in rows]
    widths = [len(c) for c in cols]
    for row in table:
        for i, v in enumerate(row):
            widths[i] = max(widths[i], len(v))
    sep = "-+-".join("-" * w for w in widths)
    lines = [" | ".join(c.ljust(w) for c, w in zip(cols, widths)), sep]
    for row in table:
        lines.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
    lines.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(lines)


def _local_engine(sf: float, device=None):
    """An in-process port engine over TPC-H and a memory catalog, on the card
    unless ``device`` names another (``"cpu"``)."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector

    e = Engine(device=device)
    e.register_catalog("tpch", TpchConnector(sf=sf))
    e.register_catalog("memory", MemoryConnector())
    return e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu",
                                 description="trino_tpu_torch SQL console")
    ap.add_argument("--server", help="coordinator URL (omit for in-process engine)")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="TPC-H scale factor for the in-process engine")
    ap.add_argument("--device", default=None,
                    help="device of the in-process engine (default: the CUDA "
                         "card; 'cpu' runs it on the CPU)")
    args = ap.parse_args(argv)

    if args.server:
        from .client import Client

        client = Client(args.server, catalog=args.catalog)

        def run(sql):
            r = client.execute(sql)
            return r.column_names, r.rows
    else:
        engine = _local_engine(args.sf, args.device)
        session = engine.create_session(args.catalog)

        def run(sql):
            res = engine.execute_sql(sql, session)
            if res is None:
                return ["result"], [[True]]
            return list(res.names), res.rows()

    def run_and_print(sql) -> None:
        try:
            names, rows = run(sql)
            print(format_aligned(names, rows))
        except Exception as e:  # noqa: BLE001 - console surface
            print(f"error: {e}", file=sys.stderr)

    if args.execute:
        run_and_print(args.execute)
        return 0

    buf = []
    while True:
        try:
            line = input("trino-tpu> " if not buf else "        -> ")
        except EOFError:
            break
        if not buf and line.strip().lower() in ("quit", "exit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            run_and_print("\n".join(buf))
            buf = []
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
