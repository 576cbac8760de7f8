"""The port's TPC-H generator against the JAX package's: every column of every
table at SF0.01, split by split, equal in value and dtype, with the same
split list, validity masks and connector metadata."""

import numpy as np
import pytest

from trino_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TABLES = ("lineitem", "orders", "customer", "part", "supplier", "partsupp",
          "nation", "region")


@pytest.fixture(scope="module")
def torch_sf001():
    return TorchTpch(sf=0.01, device="cpu")


@pytest.mark.parametrize("table", TABLES)
def test_table_equal_split_by_split(tpch_sf001, torch_sf001, table):
    js, ts = tpch_sf001.splits(table), torch_sf001.splits(table)
    assert [(s.table, s.lo, s.hi) for s in js] == [(s.table, s.lo, s.hi) for s in ts]
    for a, b in zip(js, ts):
        pa, pb = tpch_sf001.generate(a), torch_sf001.generate(b)
        assert pa.schema.names == pb.schema.names
        assert (pa.valid is None) == (pb.valid is None)
        if pa.valid is not None:
            np.testing.assert_array_equal(np.asarray(pa.valid), pb.valid.numpy())
        for name, ca, cb in zip(pa.schema.names, pa.columns, pb.columns):
            ca, cb = np.asarray(ca), cb.numpy()
            assert ca.dtype == cb.dtype, name
            np.testing.assert_array_equal(ca, cb, err_msg=f"{table}.{name}")


@pytest.mark.parametrize("table", TABLES)
def test_metadata_equal(tpch_sf001, torch_sf001, table):
    assert torch_sf001.row_count(table) == tpch_sf001.row_count(table)
    assert torch_sf001.exact_row_count(table) == tpch_sf001.exact_row_count(table)
    assert torch_sf001.clustered_by(table) == tpch_sf001.clustered_by(table)
    assert torch_sf001.primary_key(table) == tpch_sf001.primary_key(table)
    assert torch_sf001.schema(table).names == tpch_sf001.schema(table).names
    for f in tpch_sf001.schema(table).fields:
        assert torch_sf001.column_range(table, f.name) == \
            tpch_sf001.column_range(table, f.name)
    for s in tpch_sf001.splits(table):
        for f in tpch_sf001.schema(table).fields:
            assert torch_sf001.split_range(s, f.name) == tpch_sf001.split_range(s, f.name)
    js, ts = tpch_sf001.table_stats(table), torch_sf001.table_stats(table)
    assert js.row_count == ts.row_count
    assert set(js.columns) == set(ts.columns)


def test_column_subset_and_dictionaries(tpch_sf001, torch_sf001):
    split = tpch_sf001.splits("lineitem")[0]
    cols = ["l_shipdate", "l_returnflag", "l_orderkey"]
    pa = tpch_sf001.generate(split, cols)
    pb = torch_sf001.generate(torch_sf001.splits("lineitem")[0], cols)
    assert pb.schema.names == tuple(cols)
    for ca, cb in zip(pa.columns, pb.columns):
        np.testing.assert_array_equal(np.asarray(ca), cb.numpy())
    for table in TABLES:
        jd, td = tpch_sf001.dictionaries(table), torch_sf001.dictionaries(table)
        assert set(jd) == set(td)
        for k in jd:
            size = len(jd[k].values) if jd[k].values is not None else 5
            ids = np.arange(min(size, 5))
            np.testing.assert_array_equal(jd[k].decode(ids), td[k].decode(ids))


def test_page_to_numpy_decodes_like_the_reference(tpch_sf001, torch_sf001):
    for table in ("lineitem", "customer"):
        a = tpch_sf001.generate(tpch_sf001.splits(table)[0]).to_numpy(
            tpch_sf001.dictionaries(table))
        b = torch_sf001.generate(torch_sf001.splits(table)[0]).to_numpy(
            torch_sf001.dictionaries(table))
        assert list(a) == list(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{table}.{name}")
