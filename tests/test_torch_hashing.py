"""Bit-identity of the port's hashing and key packing with the JAX package.

The same numpy inputs (from a seed) go through ``trino_tpu.ops.hashing`` and
``trino_tpu_torch.ops.hashing``; every output word must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import types as jt
from trino_tpu.ops import hashing as jh
from trino_tpu_torch import types as tt
from trino_tpu_torch.ops import hashing as th

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

I64 = np.iinfo(np.int64)


def _ints(seed, n=512):
    rng = np.random.default_rng(seed)
    a = rng.integers(I64.min, I64.max, size=n, dtype=np.int64, endpoint=True)
    a[:6] = [I64.min, I64.max, -1, 0, 1, I64.max - 1]
    return a


def _columns(seed, n=512):
    rng = np.random.default_rng(seed)
    return {
        "bigint": _ints(seed, n),
        "integer": rng.integers(-2**31, 2**31, size=n, dtype=np.int32),
        "double": np.concatenate([[0.0, -0.0, np.inf, -np.inf, 1e308],
                                  rng.normal(size=n - 5) * 1e6]),
        "boolean": rng.random(n) < 0.5,
        "varchar": rng.integers(0, 8464, size=n, dtype=np.int32),  # dictionary ids
        "date": rng.integers(8000, 11000, size=n, dtype=np.int32),
    }


def _same(j, t):
    a, b = np.asarray(j), t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitmix64_and_probe_step_bit_identical(seed):
    x = _ints(seed)
    _same(jh.splitmix64(jnp.asarray(x)), th.splitmix64(torch.as_tensor(x)))
    h = np.array(jh.splitmix64(jnp.asarray(x)))
    _same(jh.probe_step(jnp.asarray(h)), th.probe_step(torch.as_tensor(h)))


@pytest.mark.parametrize("names", [("bigint",), ("integer",), ("double",), ("boolean",),
                                   ("varchar",), ("bigint", "integer", "double"),
                                   ("boolean", "varchar", "date", "bigint")])
def test_hash_columns_bit_identical(names):
    cols = _columns(3)
    _same(jh.hash_columns([jnp.asarray(cols[n]) for n in names]),
          th.hash_columns([torch.as_tensor(cols[n]) for n in names]))


_JT = {"bigint": jt.BIGINT, "integer": jt.INTEGER, "double": jt.DOUBLE,
       "boolean": jt.BOOLEAN, "varchar": jt.VarcharType.of(25), "date": jt.DATE}
_TT = {"bigint": tt.BIGINT, "integer": tt.INTEGER, "double": tt.DOUBLE,
       "boolean": tt.BOOLEAN, "varchar": tt.VarcharType.of(25), "date": tt.DATE}


@pytest.mark.parametrize("names,ranges", [
    (("bigint",), None),                       # single 64-bit key: the value itself
    (("integer",), None),                      # 32-bit offset packing
    (("double",), None),
    (("boolean", "varchar"), None),            # 33 bits: exact packing
    (("varchar", "date"), None),               # 64 bits: hash fingerprint
    (("bigint", "integer"), None),             # fingerprint
    (("boolean", "bigint", "boolean", "date", "boolean", "integer"), None),
    (("integer", "date"), ((-2**31, 2**31 - 1), (8000, 11000))),  # ranges given
    (("varchar", "bigint"), ((0, 8463), (None, None))),           # one range unknown
])
def test_pack_keys_bit_identical(names, ranges):
    cols = _columns(4)
    jp, jex = jh.pack_keys(tuple(jnp.asarray(cols[n]) for n in names),
                           tuple(_JT[n] for n in names), ranges)
    tp, tex = th.pack_keys(tuple(torch.as_tensor(cols[n]) for n in names),
                           tuple(_TT[n] for n in names), ranges)
    assert jex == tex
    _same(jp, tp)


def test_pack_keys_remaps_the_empty_sentinel():
    x = np.array([jh.EMPTY_KEY, jh.EMPTY_KEY - 1, 5], dtype=np.int64)
    jp, _ = jh.pack_keys((jnp.asarray(x),), (jt.BIGINT,))
    tp, _ = th.pack_keys((torch.as_tensor(x),), (tt.BIGINT,))
    _same(jp, tp)
    assert int(tp[0]) == th.EMPTY_KEY - 1


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 1000, 1 << 20, (1 << 20) + 1])
def test_ceil_pow2_and_key_bits(n):
    assert th.ceil_pow2(n) == jh.ceil_pow2(n)
    for name in _JT:
        assert th.key_bits(_TT[name]) == jh.key_bits(_JT[name])
