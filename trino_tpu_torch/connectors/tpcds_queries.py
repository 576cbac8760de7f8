"""The TPC-DS query corpus: the SQL of every query in the repository's
TPC-DS tests (``tests/test_tpcds.py`` to ``tests/test_tpcds6.py``), read from
those files as they state it.  The tests hold the JAX engine to a pandas
oracle at SF0.01; the port runs the same SQL (``chip_smoke.py`` on the card,
``tests/test_torch_tpcds.py`` on the CPU).

A query's key is its test's name without ``test_``, with ``_1``, ``_2``, ...
appended where the test runs several statements.  The files are parsed, not
imported, so reading them needs neither the tests' packages nor JAX.
"""

import ast
import glob
import os

__all__ = ["corpus"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def corpus(root: str = _ROOT) -> dict:
    """{key: SQL} of every ``execute_sql`` call in ``root``'s
    ``tests/test_tpcds*.py``, in file and test order."""
    paths = sorted(glob.glob(os.path.join(root, "tests", "test_tpcds*.py")))
    if not paths:
        raise FileNotFoundError(f"no tests/test_tpcds*.py under {root}")
    out = {}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
                continue
            calls = sorted((c for c in ast.walk(fn) if isinstance(c, ast.Call)
                            and getattr(c.func, "attr", "") == "execute_sql"),
                           key=lambda c: (c.lineno, c.col_offset))
            sqls = [c.args[0].value for c in calls]
            name = fn.name[len("test_"):]
            for i, sql in enumerate(sqls):
                key = f"{name}_{i + 1}" if len(sqls) > 1 else name
                if key in out:
                    raise ValueError(f"corpus key {key} appears twice ({path})")
                out[key] = sql
    return out
