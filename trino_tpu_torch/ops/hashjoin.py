"""Hash join build + probe (counterpart of ``trino_tpu/ops/hashjoin.py``).

The build side is a fixed-capacity int64 table of packed keys claimed with the
``hash_insert`` kernel (shared with hash aggregation) plus a parallel ``rows``
array mapping slot -> build row id; the probe walks each row's chain with the
``hash_probe`` kernel, which hashes the packed keys itself; matches gather the
build columns by row id.  Dense
single integer keys skip hashing (direct mode: slot = key - lo).

Duplicate build keys (``dup_count > 0``) take the multi-match layout: build
rows grouped by slot (``multi_build`` through the ``hash_insert`` kernel, or
``direct_multi_build`` for dense keys), probed for the slot
(``probe_slots``, the ``hash_probe`` kernel in slot mode) and
expanded into one output row per candidate match (``expand_counts``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_kernels
from .hashing import EMPTY_KEY, ceil_pow2, pack_keys

__all__ = ["JoinTable", "build_table_init", "build_insert", "probe", "MAX_PROBES",
           "MultiJoinTable", "multi_build", "probe_slots", "expand_counts",
           "DirectJoinTable", "direct_build", "direct_probe", "DirectMultiJoinTable",
           "direct_multi_build", "direct_probe_slots", "DIRECT_JOIN_RANGE_MAX"]

MAX_PROBES = 64
_ROW_MAX = 2**31 - 1


@dataclasses.dataclass
class JoinTable:
    table: torch.Tensor  # [capacity+1] packed keys
    rows: torch.Tensor  # [capacity+1] int32 build row index per slot
    build_columns: tuple  # full build-side columns (device)
    build_null_masks: tuple
    n_build_rows: torch.Tensor  # int32 scalar
    dup_count: torch.Tensor  # int32 scalar: valid build rows minus occupied slots
    overflow: torch.Tensor  # bool scalar

    @property
    def capacity(self):
        return self.table.shape[0] - 1


def build_table_init(capacity: int, build_page) -> JoinTable:
    capacity = ceil_pow2(capacity)  # double-hash coverage needs a pow2 table
    dev = build_page.device
    return JoinTable(
        table=torch.full((capacity + 1,), EMPTY_KEY, dtype=torch.int64, device=dev),
        rows=torch.full((capacity + 1,), _ROW_MAX, dtype=torch.int32, device=dev),
        build_columns=build_page.columns,
        build_null_masks=build_page.null_masks,
        n_build_rows=torch.zeros((), dtype=torch.int32, device=dev),
        dup_count=torch.zeros((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def build_insert(jt: JoinTable, key_cols, key_types, valid) -> JoinTable:
    """Insert build rows (rows with NULL keys are dropped by the caller via
    ``valid``).  ``jt.table`` and ``jt.rows`` are updated in place (the
    ``hash_insert_`` kernel; ``build_table_init`` makes them for this build
    alone) and shared with the returned table."""
    packed, _ = pack_keys(key_cols, key_types)
    packed = torch.where(valid, packed, torch.full_like(packed, EMPTY_KEY - 1))
    table = jt.table
    slot, placed = cuda_kernels.hash_insert_(table, packed, valid, max_probes=MAX_PROBES)
    live = valid & placed
    C = jt.capacity
    row_idx = torch.arange(packed.shape[0], dtype=torch.int32, device=packed.device)
    sidx = torch.where(live, slot, C).to(torch.int64)
    # min: the first build row wins deterministically for duplicate keys
    rows = jt.rows.scatter_reduce_(0, sidx, torch.where(live, row_idx, _ROW_MAX), "amin",
                                   include_self=True)
    rows[C] = 0
    n_valid = torch.sum(valid, dtype=torch.int32)
    occupied = torch.sum(table[:C] != EMPTY_KEY, dtype=torch.int32)
    return JoinTable(
        table=table,
        rows=rows,
        build_columns=jt.build_columns,
        build_null_masks=jt.build_null_masks,
        n_build_rows=jt.n_build_rows + n_valid,
        dup_count=jt.n_build_rows + n_valid - occupied,
        overflow=jt.overflow | torch.any(valid & ~placed),
    )


def probe(jt: JoinTable, key_cols, key_types, valid):
    """Gather-only probe: (build_row_ids[int32], matched[bool]) per probe row,
    through the ``hash_probe`` kernel."""
    packed, _ = pack_keys(key_cols, key_types)
    C = jt.capacity
    return cuda_kernels.hash_probe(jt.table[:C], jt.rows[:C], packed, valid,
                                   max_probes=MAX_PROBES)


# ---------------------------------------------------------------------------- direct index
# Dense single-key joins: slot = key - lo, no hashing, no probe rounds — the build
# is one scatter, the probe one gather.

DIRECT_JOIN_RANGE_MAX = 1 << 26  # <= 64M slots (256MB of int32 rows)


@dataclasses.dataclass
class DirectJoinTable:
    """Unique-key direct-address join table: rows[key - lo] = build row id."""

    rows: torch.Tensor  # [R+1] int32 build row per slot (min-claim)
    occ: torch.Tensor  # [R+1] bool
    build_columns: tuple
    build_null_masks: tuple
    dup_count: torch.Tensor  # int32 scalar
    lo: int


def direct_build(lo: int, span: int, build_page, key_channel: int) -> DirectJoinTable:
    """span = hi - lo + 1 slots; lo/hi were measured from the build page itself."""
    key = build_page.columns[key_channel]
    valid = build_page.valid_mask()
    nm = build_page.null_masks[key_channel]
    if nm is not None:
        valid = valid & ~nm
    dev = key.device
    slot = (key.to(torch.int64) - lo).to(torch.int32)
    live = valid & (slot >= 0) & (slot < span)
    idx = torch.where(live, slot, span).to(torch.int64)
    row_idx = torch.arange(key.shape[0], dtype=torch.int32, device=dev)
    rows = torch.full((span + 1,), _ROW_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, idx, torch.where(live, row_idx, _ROW_MAX), "amin", include_self=True)
    # dead rows route to the sink word, which is cleared after the scatter
    occ = torch.zeros((span + 1,), dtype=torch.bool, device=dev).index_put(
        (idx,), torch.ones_like(live))
    occ[span] = False
    dup = torch.sum(live, dtype=torch.int32) - torch.sum(occ[:span], dtype=torch.int32)
    return DirectJoinTable(rows, occ, build_page.columns, build_page.null_masks, dup, lo)


def direct_probe(dt: DirectJoinTable, key_col, valid):
    """(build_row_ids, matched) — one gather, no rounds."""
    span = dt.occ.shape[0] - 1
    slot = (key_col.to(torch.int64) - dt.lo).to(torch.int32)
    inr = (slot >= 0) & (slot < span)
    cslot = torch.clamp(slot, 0, span - 1).to(torch.int64)
    matched = valid & inr & dt.occ[cslot]
    row_ids = torch.where(matched, dt.rows[cslot], 0)
    return row_ids, matched


@dataclasses.dataclass
class DirectMultiJoinTable:
    """Duplicate-capable direct-address layout: slot = key - lo; counts,
    starts and order as in MultiJoinTable (the same expansion serves both)."""

    counts: torch.Tensor  # [span+1] int32 (sink = 0)
    starts: torch.Tensor  # [span+1] int32 exclusive prefix sum
    order: torch.Tensor  # [n_rows] int32 build rows grouped by slot
    build_columns: tuple
    build_null_masks: tuple
    lo: int


def _slot_layout(slot_v, live, n_slots: int):
    """(counts, starts, order) of build rows grouped by ``slot_v`` (dead rows
    carry the sink ``n_slots``, the largest value, so they sort to the tail
    and no count addresses them)."""
    counts = torch.zeros((n_slots + 1,), dtype=torch.int32, device=slot_v.device)
    counts.index_add_(0, slot_v, live.to(torch.int32))
    counts[n_slots] = 0
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    order = torch.argsort(slot_v, stable=True).to(torch.int32)
    return counts, starts, order


def direct_multi_build(lo: int, span: int, build_page,
                       key_channel: int) -> DirectMultiJoinTable:
    key = build_page.columns[key_channel]
    valid = build_page.valid_mask()
    nm = build_page.null_masks[key_channel]
    if nm is not None:
        valid = valid & ~nm
    slot = (key.to(torch.int64) - lo).to(torch.int32)
    live = valid & (slot >= 0) & (slot < span)
    slot_v = torch.where(live, slot, span).to(torch.int64)
    counts, starts, order = _slot_layout(slot_v, live, span)
    return DirectMultiJoinTable(counts, starts, order, build_page.columns,
                                build_page.null_masks, lo)


def direct_probe_slots(dt: DirectMultiJoinTable, key_col, valid):
    """(slot, matched), compatible with the MultiJoinTable expansion."""
    span = dt.counts.shape[0] - 1
    slot = (key_col.to(torch.int64) - dt.lo).to(torch.int32)
    inr = (slot >= 0) & (slot < span)
    cslot = torch.clamp(slot, 0, span - 1)
    matched = valid & inr & (dt.counts[cslot.to(torch.int64)] > 0)
    return torch.where(matched, cslot, 0), matched


# ---------------------------------------------------------------------------- multi-match
# Duplicate build keys: build rows grouped contiguously by hash slot (an argsort
# by slot), slot -> (start, count) into a row-order array.  The probe finds the
# slot; expansion is a searchsorted over the per-probe-row cumulative counts.


@dataclasses.dataclass
class MultiJoinTable:
    table: torch.Tensor  # [capacity+1] packed keys
    counts: torch.Tensor  # [capacity+1] int32 build rows per slot (sink = 0)
    starts: torch.Tensor  # [capacity+1] int32 exclusive prefix sum over slots
    order: torch.Tensor  # [n_rows] int32 build row ids grouped by slot
    build_columns: tuple
    build_null_masks: tuple
    overflow: torch.Tensor  # bool scalar

    @property
    def capacity(self):
        return self.table.shape[0] - 1


def _multi_build_step(table, key_cols, key_types, valid):
    """Insert the build keys into the fresh ``table`` in place and lay the
    rows out by slot."""
    packed, _ = pack_keys(key_cols, key_types)
    packed = torch.where(valid, packed, torch.full_like(packed, EMPTY_KEY - 1))
    slot, placed = cuda_kernels.hash_insert_(table, packed, valid, max_probes=MAX_PROBES)
    C = table.shape[0] - 1
    live = valid & placed
    slot_v = torch.where(live, slot, C).to(torch.int64)
    counts, starts, order = _slot_layout(slot_v, live, C)
    return counts, starts, order, torch.any(valid & ~placed)


def multi_build(capacity: int, build_page, key_channels, key_types,
                host) -> MultiJoinTable:
    """Build with capacity growth (x4 while a row fails to place).  ``host``
    reads device scalars to the host (the executor's counted chokepoint)."""
    key_cols = tuple(build_page.columns[i] for i in key_channels)
    valid = build_page.valid_mask()
    for ch in key_channels:
        nm = build_page.null_masks[ch]
        if nm is not None:
            valid = valid & ~nm
    capacity = ceil_pow2(capacity)  # double-hash coverage needs a pow2 table
    while True:
        table = torch.full((capacity + 1,), EMPTY_KEY, dtype=torch.int64,
                           device=valid.device)
        counts, starts, order, overflow = _multi_build_step(table, key_cols, key_types,
                                                            valid)
        if not bool(host([overflow])[0]):
            break
        capacity *= 4
    return MultiJoinTable(table, counts, starts, order, build_page.columns,
                          build_page.null_masks, overflow)


def probe_slots(table, key_cols, key_types, valid):
    """(slot[int32], matched[bool]) per probe row: the ``hash_probe`` kernel
    in slot mode (the slot index itself is the payload; no payload array)."""
    packed, _ = pack_keys(key_cols, key_types)
    C = table.shape[0] - 1
    return cuda_kernels.hash_probe(table[:C], None, packed, valid, max_probes=MAX_PROBES)


def expand_counts(incl, out_counts, size: int):
    """Expanded row index -> (probe row index, ordinal k within the row's
    matches, in-range flag).  ``incl`` is the inclusive cumsum of per-probe-row
    output counts; ``size`` (>= incl[-1]) the output capacity."""
    n = incl.shape[0]
    i = torch.arange(size, dtype=incl.dtype, device=incl.device)
    pidx = torch.clamp(torch.searchsorted(incl, i, right=True), 0, n - 1)
    excl = incl[pidx] - out_counts[pidx]
    k = i - excl
    in_range = i < incl[n - 1]
    return pidx.to(torch.int32), k, in_range
