"""Hash partitioning of rows (counterpart of ``partition_ids`` in
``trino_tpu/ops/exchange.py``; reference: PagePartitioner's hash routing).

``partition_ids`` gives the same id as the reference for every row: the
same 64-bit hash (``ops/hashing.hash_columns``), ``abs`` that wraps at
INT64_MIN as ``jnp.abs`` does, and a floor modulo (``torch.remainder``, as
``%`` on jax integers), so the one hash that stays negative after ``abs``
still lands in ``[0, n)``.  Callers make NULL key lanes canonical before
hashing, so the NULL group lands in one partition.

Not ported yet: ``bucketize`` and ``exchange_all_to_all``, the mesh
exchange (ROADMAP A7).
"""

from __future__ import annotations

import torch

from .hashing import hash_columns

__all__ = ["partition_ids"]


def partition_ids(key_cols, n_partitions: int) -> torch.Tensor:
    """Row -> partition id in [0, n_partitions), int32."""
    h = hash_columns(key_cols)
    return torch.remainder(torch.abs(h), n_partitions).to(torch.int32)
