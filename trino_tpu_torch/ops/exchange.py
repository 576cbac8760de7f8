"""The hash-partitioned exchange (counterpart of ``trino_tpu/ops/exchange.py``;
reference: PagePartitioner's hash routing and the partitioned output buffers).

``partition_ids`` gives the same id as the reference for every row: the
same 64-bit hash (``ops/hashing.hash_columns``), ``abs`` that wraps at
INT64_MIN as ``jnp.abs`` does, and a floor modulo (``torch.remainder``, as
``%`` on jax integers), so the one hash that stays negative after ``abs``
still lands in ``[0, n)``.  Callers make NULL key lanes canonical before
hashing, so the NULL group lands in one partition.

``bucketize`` packs one position's rows into a fixed ``[n_partitions *
bucket]`` send layout: one order-preserving compaction per destination (the
``compact_rows`` kernel on the card), the reference's Pallas branch, whose
layout is byte-identical to its sort branch.  Rows past a partition's
bucket are dropped and reported in the overflow flag, so the executor can run
again with bigger buckets.

``exchange_all_to_all`` is the reference's ``lax.all_to_all(..., tiled=True)``
over a single-process mesh (``parallel/mesh.py``): position w receives chunk
w of every sender, concatenated in sender order.  A chunk moves with
``.to`` the receiver's device, a no-op where positions share a device and a
peer copy between cards.
"""

from __future__ import annotations

import torch

from .arrays import compact_rows
from .hashing import hash_columns

__all__ = ["partition_ids", "bucketize", "exchange_all_to_all"]


def partition_ids(key_cols, n_partitions: int) -> torch.Tensor:
    """Row -> partition id in [0, n_partitions), int32."""
    h = hash_columns(key_cols)
    return torch.remainder(torch.abs(h), n_partitions).to(torch.int32)


def bucketize(cols, valid, pid, n_partitions: int, bucket: int):
    """Pack rows into a ``[n_partitions * bucket]`` send layout.

    Returns (packed_cols, packed_valid, overflow): row r of partition p lands
    at ``p * bucket + rank_of_r_within_p``; slots past a partition's row
    count are invalid and zero.  ``overflow`` is a 0-d bool: some partition
    had more rows than ``bucket``."""
    dev = valid.device
    n = valid.shape[0]
    if n == 0:
        size = n_partitions * bucket
        return (tuple(torch.zeros((size,), dtype=c.dtype, device=dev) for c in cols),
                torch.zeros((size,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    packed_p, counts = [], []
    for p in range(n_partitions):
        pp, cnt = compact_rows(tuple(cols), valid & (pid == p), bucket)
        packed_p.append(pp)
        counts.append(cnt)
    packed = tuple(torch.cat([pp[i] for pp in packed_p]) for i in range(len(cols)))
    counts = torch.stack(counts)
    out_valid = (torch.arange(bucket, device=dev)[None, :]
                 < torch.clamp(counts, max=bucket)[:, None]).reshape(-1)
    return packed, out_valid, torch.any(counts > bucket)


def exchange_all_to_all(mesh, packed_cols, packed_valid):
    """Swap partition buckets across the mesh.  ``packed_cols[s]`` is sender
    s's tuple of ``[W * bucket]`` send columns and ``packed_valid[s]`` its
    mask (``bucketize``'s layout); returns (recv_cols, recv_valid), per
    receiver w the chunks w of every sender in sender order, on w's
    device."""
    W = mesh.size

    def a2a(send):
        b = send[0].shape[0] // W
        return [torch.cat([send[s][w * b:(w + 1) * b].to(mesh.devices[w])
                           for s in range(W)]) for w in range(W)]

    ncols = len(packed_cols[0])
    per_col = [a2a([packed_cols[s][i] for s in range(W)]) for i in range(ncols)]
    recv_cols = [tuple(per_col[i][w] for i in range(ncols)) for w in range(W)]
    return recv_cols, a2a(packed_valid)
