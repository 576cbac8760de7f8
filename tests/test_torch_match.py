"""The port's MATCH_RECOGNIZE against the JAX package.

Statement level: the SQL of tests/test_match_recognize.py (linear patterns
with ?/*/+, alternation groups, DEFINE with PREV/NEXT, FIRST/LAST measures,
ONE and ALL ROWS PER MATCH, the random-walk V-shape) and the shapes of
``chip_smoke.py``'s A6 and A7 over TPC-H orders at SF0.01, restated as
parametrised cases (``chip_smoke.MATCH_CASES`` over ``MATCH_SETUP``'s memory
tables, which phase 10a also runs on the card), run in both packages with
the parity rules of ``tests/test_torch_arrays.py`` (``run_both``).
``classifier()``, which the reference refuses, is a case too.

The vectorized matcher: the port's ``ops/matcher.vector_match`` against the
reference's on the gate's accepts (equal geometry) and refusals (both
``None``), and the engine's results with it against the host backtracker.
"""

import os
import sys

import numpy as np
import pytest

import trino_tpu.ops.matcher as JM
import trino_tpu_torch.ops.matcher as TM
from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from test_torch_dml import run_both

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import MATCH_CASES, MATCH_SETUP, V_SHAPE_TICKS  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def engines():
    j, t = JaxEngine(), TorchEngine(device="cpu")
    for e, tpch, mem in ((j, JaxTpch, JaxMemory), (t, TorchTpch, TorchMemory)):
        e.register_catalog("tpch", tpch(sf=0.01))
        e.register_catalog("mem", mem())
    sessions = {c: (j.create_session(c), t.create_session(c)) for c in ("tpch", "mem")}
    for sql in MATCH_SETUP:
        run_both(j, t, sql, *sessions["mem"])
    return j, t, sessions


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_statement_equal(engines, case):
    j, t, sessions = engines
    catalog, sql = MATCH_CASES[case]
    run_both(j, t, sql, *sessions[catalog])


def test_vector_path_agrees_with_the_backtracker(engines, monkeypatch):
    """tests/test_match_recognize.py::test_vectorized_matcher_agrees_with_backtracker
    over the port: DOWN+ UP+ takes the vector path, and forcing the host
    backtracker gives the same rows."""
    _, t, sessions = engines
    s = sessions["mem"][1]
    calls = {"n": 0}
    orig = TM.vector_match

    def counting(*a, **kw):
        out = orig(*a, **kw)
        calls["n"] += out is not None
        return out

    monkeypatch.setattr(TM, "vector_match", counting)
    fast = t.execute_sql(V_SHAPE_TICKS, s).rows()
    assert calls["n"] == 1, "the vector path did not take DOWN+ UP+"
    monkeypatch.setattr(TM, "vector_match", lambda *a, **kw: None)
    slow = t.execute_sql(V_SHAPE_TICKS, s).rows()
    assert fast == slow and len(fast) > 10


def _geometry_equal(a, b):
    for f in ("usable", "end", "pos", "nxt"):
        np.testing.assert_array_equal(np.asarray(getattr(b, f)), np.asarray(getattr(a, f)), f)
    assert a.var_element == b.var_element


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_vector_match_equals_the_reference(seed):
    """Disjoint conditions (the gate's accepts) over random partitions: the
    same geometry for every start, for each quantifier."""
    rng = np.random.default_rng(seed)
    n = 200
    new_part = rng.random(n) < 0.08
    new_part[0] = True
    walk = rng.integers(-3, 4, n)
    conds = {"d": walk < 0, "u": walk > 0, "f": walk == 0,
             "a": np.ones(n, bool)}
    patterns = [((("d", "+"), ("u", "+")), {"d", "u"}),
                ((("a", None), ("d", "*"), ("u", "?")), {"a", "d", "u"}),
                ((("d", "?"), ("f", "+"), ("u", None)), {"f"}),
                (((("d", "u"), "+"), ("f", None)), set())]
    for pattern, mvars in patterns:
        j = JM.vector_match(pattern, conds, new_part, mvars)
        t = TM.vector_match(pattern, conds, new_part, mvars)
        assert j is not None and t is not None, pattern
        _geometry_equal(j, t)
        starts = np.flatnonzero(j.usable)[:5]
        assert [j.by_var(int(i)) for i in starts] == [t.by_var(int(i)) for i in starts]


def test_vector_match_refuses_what_the_reference_refuses():
    n = 8
    new_part = np.zeros(n, bool)
    new_part[0] = True
    ones = {"a": np.ones(n, bool), "b": np.ones(n, bool)}
    alt = {"a": np.arange(n) % 2 == 0, "b": np.arange(n) % 2 == 1}
    refused = [
        ((("a", "+"), ("b", None)), ones, set()),  # overlapping conditions
        ((("a", "{2}"), ("b", None)), alt, set()),  # a quantifier outside ?/*/+
        (((("a", "b"), "+"),), alt, {"a"}),  # a measure variable in an alternation
        ((("a", None), ("a", "+")), alt, {"a"}),  # a measure variable twice
    ]
    for pattern, conds, mvars in refused:
        assert JM.vector_match(pattern, conds, new_part, mvars) is None, pattern
        assert TM.vector_match(pattern, conds, new_part, mvars) is None, pattern
    assert TM.vector_match((("a", "+"),), alt, np.zeros(0, bool), set()) is None
    # disjoint conditions pass, and a run clipped at a partition's end does
    # not let the next element match in the next partition
    ok_a = np.array([False, True, True, False, False, False])
    ok_b = np.array([False, False, False, True, False, False])
    part = np.array([True, False, False, True, False, False])
    j = JM.vector_match((("a", "+"), ("b", None)), {"a": ok_a, "b": ok_b}, part, set())
    t = TM.vector_match((("a", "+"), ("b", None)), {"a": ok_a, "b": ok_b}, part, set())
    _geometry_equal(j, t)
    assert not t.usable.any()
