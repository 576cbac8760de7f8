"""The port's remaining aggregates against the JAX package.

The SQL of tests/test_agg_functions.py, test_agg_functions2.py,
test_percentile.py, test_decimal128.py and test_decimal38.py, restated as
parametrised cases, and the slice's queries F1-F7 (``chip_smoke.FUNCTIONS``)
at SF0.01, run in both packages (``trino_tpu.Engine`` and
``trino_tpu_torch.Engine(device="cpu")``) over TPC-H at SF0.01 (also with
splits of 2^13 rows, so sort-based aggregation concatenates many pages) and
over memory tables.  Outcomes must agree under the port's parity rules
(``run_both`` of ``tests/test_torch_dml.py``): integer, decimal (exact wide
sums included), date and string columns exactly, DOUBLE within rtol 1e-9,
row order where the statement orders its rows, and an error of the same type
with the same message.  The aggregates cover every path that takes
accumulators: direct (TPC-H keys with column ranges), hash (memory tables
and computed keys) and global.

Left out, by the name of their test: the distributed and fault-tolerant
cases (test_decimal128.py::test_wide_sum_fault_tolerant_and_distributed is
restated in tests/test_torch_cluster.py;
test_agg_functions2.py::test_checksum_distributed_matches_local), parquet
(A5: test_decimal38.py::test_parquet_decimal38_roundtrip), SHOW FUNCTIONS
(A6: test_agg_functions2.py::test_show_functions_has_new_aggs) and the
aggregates whose results are arrays or maps (test_array_agg,
test_array_agg_strings, test_histogram, test_map_agg of
test_agg_functions2.py and test_functions_stats.py::test_approx_most_frequent),
which ``tests/test_torch_arrays.py`` holds; ``test_array_aggregates_raise_naming_a4``
holds them over this file's table too.
test_decimal128.py::test_wide_sum_rehash_growth, which drives the reference's
``hashagg`` directly, is restated over the port's ``hashagg``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from trino_tpu import Engine as JaxEngine
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu_torch import Engine as TorchEngine
from trino_tpu_torch.connectors.memory import MemoryConnector as TorchMemory
from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from test_torch_dml import run_both

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import AGGREGATE_CASES, AGGREGATE_SETUP  # noqa: E402  (no torch at load)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

@pytest.fixture(scope="module")
def engines():
    j, t = JaxEngine(), TorchEngine(device="cpu")
    for e, tpch, mem in ((j, JaxTpch, JaxMemory), (t, TorchTpch, TorchMemory)):
        e.register_catalog("tpch", tpch(sf=0.01))
        e.register_catalog("tpchs", tpch(sf=0.01, split_rows=1 << 13))
        e.register_catalog("mem", mem())
    sessions = {c: (j.create_session(c), t.create_session(c))
                for c in ("tpch", "tpchs", "mem")}
    for sql in AGGREGATE_SETUP:
        run_both(j, t, sql, *sessions["mem"])
    return j, t, sessions


@pytest.mark.parametrize("case", sorted(AGGREGATE_CASES))
def test_statement_equal(engines, case):
    j, t, sessions = engines
    catalog, sql = AGGREGATE_CASES[case]
    run_both(j, t, sql, *sessions[catalog])


def test_wide_sums_decode_exactly(engines):
    """Sums past 2^63 reach the surface as exact ``Decimal`` values from an
    object column of python ints, in both packages."""
    from decimal import Decimal

    j, t, sessions = engines
    want = sum(Decimal(f"{8_600_000_000_000_000 + i * 7}.25") for i in range(40))
    for e, s in zip((j, t), sessions["mem"]):
        r = e.execute_sql("select sum(v) s from big", s)
        assert r.raw_columns[0].dtype == object
        assert r.rows() == [(want,)]
        assert isinstance(r.rows()[0][0], Decimal)


def test_array_aggregates_raise_naming_a4(engines):
    # the aggregates whose results are arrays or maps no longer wait for A4:
    # they equal the reference, as decoded lists and dicts too
    j, t, sessions = engines
    for agg in ("array_agg(n)", "histogram(s)", "map_agg(s, n)",
                "approx_most_frequent(2, s, 10)"):
        run_both(j, t, f"select g, {agg} from t group by g", *sessions["mem"])


def test_wide_sum_rehash_growth():
    """Limb accumulators survive the hash table's growth: rehash re-inserts
    them by plain addition (the port's ``hashagg``)."""
    from trino_tpu_torch.ops import hashagg
    from trino_tpu_torch.types import BIGINT

    state = hashagg.groupby_init(8, (np.int64,), [(np.int64, 0), (np.int64, 0)])
    keys = (torch.arange(6, dtype=torch.int64),)
    v = 8_600_000_000_000_000_000  # near int64's ceiling
    vals = torch.full((6,), v, dtype=torch.int64)
    valid = torch.ones((6,), dtype=torch.bool)
    state = hashagg.groupby_insert(state, keys, (BIGINT,), valid,
                                   [(vals, None), (vals, None)], ["sum_hi32", "sum_lo32"])
    grown = hashagg.rehash(state, 32, ("sum_hi32", "sum_lo32"))
    assert int(hashagg.group_count(grown)) == 6
    _, _, accs = hashagg.compact_groups(grown, 8)
    hi, lo = accs[0][:6].tolist(), accs[1][:6].tolist()
    assert sum(h * (1 << 32) + lo_ for h, lo_ in zip(hi, lo)) == 6 * v


def test_sort_keys_order_zeros_and_nans_alike():
    """Sort-based aggregation orders -0.0 with 0.0 and every NaN after +inf,
    by integer keys, so the card's radix sort and the CPU's agree."""
    from trino_tpu_torch.exec.local_executor import _sort_key

    x = torch.tensor([1.0, -0.0, float("nan"), -float("inf"), 0.0, float("inf"), -1.5,
                      -float("nan")], dtype=torch.float64)
    order = torch.argsort(_sort_key(x), stable=True).tolist()
    assert order == [3, 6, 1, 4, 0, 5, 2, 7]
