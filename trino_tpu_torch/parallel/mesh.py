"""The worker mesh (counterpart of ``trino_tpu/parallel/mesh.py``).

The reference distributes over a 1-D jax device ``Mesh`` whose axis "w"
holds the worker positions, and runs one SPMD program over it through
``shard_map``: one Python process drives every position.  The port keeps
that single-controller design.  A :class:`Mesh` is an ordered tuple of
``torch.device``s, one per worker position; the distributed executor runs
each per-worker step once per position on that position's device, and the
exchange moves tensors between the positions' devices.

Positions may share a device: ``worker_mesh(8)`` on a machine with one card
gives eight positions on ``cuda:0`` (a *virtual* mesh, the counterpart of
the reference's ``--xla_force_host_platform_device_count``), and
``worker_mesh(8, devices=["cpu"] * 8)`` is the CPU mesh the tests use.

The reference's two shardings become the mesh's two placements:
``row_sharded`` is :meth:`Mesh.place` (one tensor per position, each on its
position's device) and ``replicated`` is :meth:`Mesh.replicate` (one copy
per DISTINCT device, shared by the positions on it: a broadcast build table
on a virtual mesh is one tensor, not one per position).

``init_multihost`` keeps the reference's configuration contract, but the
single-process mesh cannot span processes: a full multi-host configuration
raises until the multi-process cluster (``torch.distributed``) is ported.
"""

from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["Mesh", "WORKER_AXIS", "worker_mesh", "same_device", "init_multihost"]

WORKER_AXIS = "w"


def same_device(a, b) -> bool:
    """Do ``a`` and ``b`` name one device?  A CUDA device without an index
    is the current one (``torch.device("cuda")`` and ``"cuda:0"`` agree on a
    one-card machine)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if (a.index is None or b.index is None) else 0
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def _to(x, device):
    """``x`` (a tensor, a tuple of them, a dataclass of them such as a join
    table, or anything else, which passes as it is) with every tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    return x


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of worker positions: ``devices[w]`` is position w's."""

    devices: tuple

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a worker mesh needs at least one position")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple:
        """The mesh's devices, each once, in first-position order."""
        out = []
        for d in self.devices:
            if not any(same_device(d, o) for o in out):
                out.append(d)
        return tuple(out)

    def place(self, xs) -> list:
        """Row-sharded placement: ``xs[w]`` on position w's device."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} shards for a mesh of {self.size} positions")
        return [_to(x, d) for x, d in zip(xs, self.devices)]

    def replicate(self, x) -> list:
        """Replicated placement: one copy of ``x`` per distinct device,
        returned per position (positions on one device share the object)."""
        copies = []
        out = []
        for d in self.devices:
            hit = next((c for dd, c in copies if same_device(dd, d)), None)
            if hit is None:
                hit = _to(x, d)
                copies.append((d, hit))
            out.append(hit)
        return out

    def __repr__(self) -> str:
        names = [str(d) for d in self.distinct_devices]
        return f"Mesh({self.size} positions over {names})"


def worker_mesh(n_workers: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over every visible CUDA device, or over ``devices``.
    ``n_workers`` past the device count cycles the positions over the
    devices (a virtual mesh); fewer takes the first ``n_workers``."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices=[...] "
                               "(for example devices=['cpu'] * 8) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("worker_mesh: an empty device list")
    if n_workers is None:
        n_workers = len(devices)
    if n_workers < 1:
        raise ValueError(f"worker_mesh: {n_workers} workers")
    return Mesh(tuple(devices[w % len(devices)] for w in range(n_workers)))


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """The reference's multi-host entry: False without configuration (a
    single host, nothing to join).  Configuration comes from the arguments
    or ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``, read as the reference reads them; a partial one
    raises the reference's ``ValueError``.  A full one raises
    ``NotImplementedError``: the port's mesh lives in one process (one
    controller drives every position), and joining hosts needs one process
    per rank with the exchange over ``torch.distributed`` (ROADMAP A7).
    The multi-process cluster (``server/cluster.py``) is another design:
    fragments over HTTP, not one program over a mesh."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    pid = process_id if process_id is not None else \
        int(os.environ.get("JAX_PROCESS_ID", "-1") or -1)
    on_pod = os.environ.get("TPU_WORKER_HOSTNAMES") is not None
    explicit = coordinator is not None and num > 1 and pid >= 0
    if not on_pod and not explicit:
        if coordinator is not None or num > 0 or pid >= 0:
            raise ValueError(
                "partial multi-host configuration: need coordinator address, "
                "num_processes > 1 AND process_id >= 0 together")
        return False  # single-host: local mesh only
    raise NotImplementedError(
        "multi-host execution is not ported to trino_tpu_torch yet: the worker "
        "mesh is single-process; joining hosts needs one process per rank with "
        "the exchange over torch.distributed")
