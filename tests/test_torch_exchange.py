"""The port's mesh exchange against the JAX package on the CPU: ``bucketize``
and ``exchange_all_to_all`` (``trino_tpu_torch/ops/exchange.py``),
``append_rows`` (``ops/arrays.py``) and the worker mesh
(``parallel/mesh.py``).

The same numpy inputs, made from a seed, go through both packages.
``bucketize`` is held byte-identical to both of the reference's branches
(its XLA sort branch, and its Pallas branch run in interpret mode, as
tests/test_pallas_kernels.py runs it), the overflow flag included;
``exchange_all_to_all`` to the reference's ``lax.all_to_all`` under
``shard_map`` on the conftest's 8 CPU devices; ``append_rows`` to the
reference's scatter, whole buffers (drop sink included) and cursor, across a
run that passes the capacity.  The mesh: positions cycle over the devices,
``place`` and ``replicate`` (one copy per distinct device), and
``init_multihost``'s three cases (tests/test_ops.py:117 restated as far as
the port goes: a full configuration raises instead of joining).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from trino_tpu.ops import arrays as jarrays, exchange as jexchange
from trino_tpu.ops import pallas_kernels as pk
from trino_tpu.parallel.mesh import WORKER_AXIS, worker_mesh as jax_mesh
from trino_tpu_torch.ops import arrays, exchange
from trino_tpu_torch.parallel import mesh as M
from torch_threads import one_torch_thread  # noqa: F401  (autouse module fixture)

W = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bucketize_inputs(seed=8, n=2048):
    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, 1 << 40, n), rng.random(n), rng.random(n) < 0.5)
    valid = rng.random(n) < 0.9
    pid = rng.integers(0, W, n).astype(np.int32)
    return cols, valid, pid


@pytest.mark.parametrize("bucket", [320, 200], ids=["fits", "overflows"])
@pytest.mark.parametrize("branch", ["xla", "pallas"])
def test_bucketize_is_byte_identical_to_the_reference(branch, bucket):
    cols, valid, pid = _bucketize_inputs()
    pk.force(branch == "pallas")
    jax.clear_caches()
    try:
        rp, rv, ro = jexchange.bucketize(tuple(jnp.asarray(c) for c in cols),
                                         jnp.asarray(valid), jnp.asarray(pid), W, bucket)
        rp, rv, ro = [np.asarray(c) for c in rp], np.asarray(rv), bool(ro)
    finally:
        pk.force(None)
        jax.clear_caches()
    gp, gv, go = exchange.bucketize(tuple(_t(c) for c in cols), _t(valid), _t(pid), W,
                                    bucket)
    assert go == ro == (bucket == 200)
    assert np.array_equal(gv.numpy(), rv)
    for r, g in zip(rp, gp):
        assert g.numpy().dtype == r.dtype and np.array_equal(g.numpy(), r)


def test_bucketize_of_no_rows_is_empty():
    packed, pvalid, oflow = exchange.bucketize(
        (torch.zeros((0,), dtype=torch.int64),), torch.zeros((0,), dtype=torch.bool),
        torch.zeros((0,), dtype=torch.int32), W, 4)
    assert packed[0].shape == (W * 4,) and not pvalid.any() and not bool(oflow)


def test_exchange_all_to_all_equals_the_reference_shard_map():
    from trino_tpu.exec.distributed import shard_map

    assert len(jax.devices()) >= W, "conftest must force 8 CPU devices"
    rng = np.random.default_rng(11)
    b = 37
    cols = (rng.integers(-1 << 50, 1 << 50, (W, W * b)), rng.random((W, W * b)))
    valid = rng.random((W, W * b)) < 0.7
    jm = jax_mesh(W)

    def body(c0, c1, v):
        (r0, r1), rv = jexchange.exchange_all_to_all((c0[0], c1[0]), v[0],
                                                     WORKER_AXIS, W)
        return r0[None], r1[None], rv[None]

    f = partial(shard_map, mesh=jm, in_specs=(PS(WORKER_AXIS),) * 3,
                out_specs=(PS(WORKER_AXIS),) * 3)(body)
    ref = [np.asarray(x) for x in jax.jit(f)(*(jnp.asarray(a) for a in (*cols, valid)))]
    mesh = M.worker_mesh(W, devices=["cpu"] * W)
    got_cols, got_valid = exchange.exchange_all_to_all(
        mesh, [(_t(cols[0][s]), _t(cols[1][s])) for s in range(W)],
        [_t(valid[s]) for s in range(W)])
    for w in range(W):
        assert np.array_equal(got_cols[w][0].numpy(), ref[0][w])
        assert np.array_equal(got_cols[w][1].numpy(), ref[1][w])
        assert np.array_equal(got_valid[w].numpy(), ref[2][w])


def test_append_rows_is_byte_identical_across_a_run_past_the_capacity():
    rng = np.random.default_rng(5)
    cap, n = 100, 48
    jbufs = (jnp.zeros((cap + 1,), jnp.int64), jnp.zeros((cap + 1,), jnp.float64),
             jnp.zeros((cap + 1,), bool))
    tbufs = (torch.zeros((cap + 1,), dtype=torch.int64),
             torch.zeros((cap + 1,), dtype=torch.float64),
             torch.zeros((cap + 1,), dtype=torch.bool))
    jcur = jnp.zeros((), jnp.int64)
    tcur = torch.zeros((), dtype=torch.int64)
    over = []
    for step in range(5):  # ~32 live rows a step: the capacity passes at step 3
        a = (rng.integers(1, 1 << 40, n), rng.random(n) + 1.0, rng.random(n) < 0.5)
        valid = rng.random(n) < 0.7
        before = [b.numpy().copy() for b in tbufs]
        jbufs, jcur, jof = jarrays.append_rows(jbufs, jcur,
                                               tuple(jnp.asarray(x) for x in a),
                                               jnp.asarray(valid))
        tbufs, tcur, tof = arrays.append_rows(tbufs, tcur, tuple(_t(x) for x in a),
                                              _t(valid))
        assert int(tcur) == int(jcur) and bool(tof) == bool(jof)
        for r, g in zip(jbufs, tbufs):
            assert np.array_equal(g.numpy(), np.asarray(r))
        # the slots under the cursor at the step's start never change
        start = int(tcur) - int(valid.sum())
        for b0, g in zip(before, tbufs):
            assert np.array_equal(g.numpy()[:min(start, cap)], b0[:min(start, cap)])
        over.append(bool(tof))
    assert over[0] is False and over[-1] is True


def test_worker_mesh_places_and_replicates():
    m = M.worker_mesh(8, devices=["cpu", "cpu"])
    assert m.size == 8 and m.distinct_devices == (torch.device("cpu"),)
    assert M.worker_mesh(2, devices=["cpu"] * 8).size == 2
    xs = [torch.full((3,), w) for w in range(8)]
    placed = m.place(xs)
    assert [int(p[0]) for p in placed] == list(range(8))
    table = (torch.arange(4), None)
    reps = m.replicate(table)
    # one copy per distinct device, shared by the positions on it
    assert len(reps) == 8 and all(r is reps[0] for r in reps)
    assert reps[0][1] is None and torch.equal(reps[0][0], table[0])
    with pytest.raises(ValueError):
        m.place(xs[:3])
    with pytest.raises(ValueError):
        M.worker_mesh(devices=[])


def test_worker_mesh_without_a_card_needs_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        M.worker_mesh(8)


def test_init_multihost_cases(monkeypatch):
    """Without configuration a no-op returning False, as the reference; a
    partial configuration raises the reference's ValueError; a full one
    raises: the port's mesh is single-process."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_multihost() is False
    with pytest.raises(ValueError, match="partial multi-host"):
        M.init_multihost("10.0.0.1:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="partial multi-host"):
        M.init_multihost()
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        M.init_multihost("10.0.0.1:8476", 2, 0)
