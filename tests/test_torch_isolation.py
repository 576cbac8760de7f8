"""The port stands alone: ``trino_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``trino_tpu``, the package imports and runs a query in a
process where both are blocked, and ``chip_smoke.py`` refuses to run without
a card or without the package beside it.

And the port's share of the reference's boundary lint
(tests/test_boundary_lint.py): per-node stats are written only through
``LocalExecutor._node_stats`` (a line may opt out with ``# stats-ok``), and
nothing under ``exec/`` or ``sql/`` reads ``plan_history``: decisions from
history are the adaptive advisor's."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "trino_tpu_torch")


def _port_sources():
    out = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(_PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _banned(name: str) -> bool:
    return name is not None and any(
        name == m or name.startswith(m + ".") for m in ("jax", "jaxlib", "trino_tpu"))


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_banned(n) for n in names), \
            f"{os.path.relpath(path, _ROOT)}:{node.lineno} imports {names}"


_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "trino_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import pkgutil, importlib
import trino_tpu_torch
for m in pkgutil.walk_packages(trino_tpu_torch.__path__, "trino_tpu_torch."):
    importlib.import_module(m.name)
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
e = Engine(device="cpu")
e.register_catalog("tpch", TpchConnector(sf=0.001))
r = e.execute_sql("select l_returnflag, count(*) from lineitem group by l_returnflag "
                  "order by l_returnflag", e.create_session("tpch"))
assert len(r) == 3, len(r)
assert not any(k == "jax" or k.startswith(("jax.", "trino_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED-OK")
"""


def test_imports_and_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True, text=True,
                         cwd=_ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED-OK" in out.stdout


def _run_smoke(cwd, script):
    return subprocess.run([sys.executable, script], capture_output=True, text=True,
                          cwd=cwd, timeout=300)


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusals are checked where there is none")
    out = _run_smoke(_ROOT, os.path.join(_ROOT, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), alone)
    out = _run_smoke(str(tmp_path), str(alone))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _stats_writes(tree, source_lines):
    """(line, enclosing function) of every ``<x>.stats[...] = ...`` and
    ``<x>.stats.setdefault(...)`` outside ``_node_stats`` whose line carries
    no ``# stats-ok``."""
    hits = []

    def is_stats(node):
        return isinstance(node, ast.Attribute) and node.attr == "stats"

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        flagged = False
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            flagged = any(isinstance(t, ast.Subscript) and is_stats(t.value) for t in targets)
        elif isinstance(node, ast.Call):
            f = node.func
            flagged = isinstance(f, ast.Attribute) and f.attr == "setdefault" \
                and is_stats(f.value)
        if flagged and fn != "_node_stats" \
                and "# stats-ok" not in source_lines[node.lineno - 1]:
            hits.append((node.lineno, fn))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(tree, None)
    return hits


def _history_reads(tree):
    return [node.lineno for node in ast.walk(tree)
            if (isinstance(node, ast.Attribute) and node.attr == "plan_history")
            or (isinstance(node, ast.Name) and node.id == "plan_history")]


@pytest.mark.parametrize("path", [p for p in _port_sources() if "trino_tpu_torch" in p],
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_stats_register_through_node_stats(path):
    src = open(path).read()
    hits = _stats_writes(ast.parse(src), src.splitlines())
    assert not hits, (f"{os.path.relpath(path, _ROOT)}: per-node stats written outside "
                      f"_node_stats at {hits}: register through _node_stats(node), so the "
                      "plan history sees the node, or mark the line '# stats-ok: <why>'")


@pytest.mark.parametrize("path", [p for p in _port_sources()
                                  if os.sep + "exec" + os.sep in p
                                  or os.sep + "sql" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_exec_and_sql_never_read_plan_history(path):
    lines = _history_reads(ast.parse(open(path).read()))
    assert not lines, (f"{os.path.relpath(path, _ROOT)} reads plan_history at lines "
                       f"{lines}: history reaches the planner only as the adaptive "
                       "advisor's corrections")


def test_the_lint_rules_catch_violations():
    src = ("class X:\n"
           "    def run(self, node):\n"
           "        self.stats[id(node)] = {}\n"                      # line 3: flagged
           "        self.stats.setdefault(id(node), {})\n"            # line 4: flagged
           "        self.stats[id(node)] = {}  # stats-ok: test\n"
           "        return engine.plan_history\n"                     # line 6: a read
           "    def _node_stats(self, node):\n"
           "        self.stats[id(node)] = {}\n")
    tree = ast.parse(src)
    assert _stats_writes(tree, src.splitlines()) == [(3, "run"), (4, "run")]
    assert _history_reads(tree) == [6]
