"""Hash aggregation over fixed-capacity open-addressing tables
(counterpart of ``trino_tpu/ops/hashagg.py``).

Keys pack to one int64 word per row (``hashing.pack_keys``); the table is a
``[capacity+1]`` int64 tensor whose last word is an overflow sink.  Inserting
a page assigns each live row a slot (``_probe_insert``: the ``hash_insert``
CUDA kernel on the card, the reference's claim protocol on the CPU), and the
per-slot accumulators update with scatter-adds.  Small static key ranges skip
hashing entirely (direct mode: slot = packed key), and direct tables of at
most 128 slots aggregate by masked reductions over a one-hot instead of
scatters.

Every update returns a new ``GroupByState`` value.  The hash-mode insert
(``groupby_insert``) claims slots in the state's table IN PLACE (the
``hash_insert_`` kernel) and shares that table with the state it returns;
key captures and accumulators are new tensors.  A caller that needs the
pre-insert state later keeps a snapshot with its own copy of the table (the
executor takes one per chunk of pages, for the replay after growth).
Direct-mode updates and ``rehash`` leave their input state untouched.
With ``inplace=True`` both inserts write every tensor of the state they are
given and return a state of those same tensors: the scan-fused runners'
captured bodies update their static state so, the counterpart of XLA
updating a ``lax.scan`` carry in place.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..types import BOOLEAN as _BOOL_KEY, torch_dtype
from . import cuda_kernels
from .arrays import compact_rows
from .hashing import EMPTY_KEY, ceil_pow2, pack_keys

__all__ = ["GroupByState", "groupby_init", "groupby_insert", "agg_update",
           "DirectConfig", "direct_config", "direct_groupby_init",
           "direct_groupby_insert", "rehash", "compact_groups", "group_count"]

MAX_PROBES = 64

DIRECT_BITS_MAX = 24  # <= 16M slots: slot = packed key, no probing at all
ONEHOT_CAP_MAX = 128  # <= 128 slots: masked-reduce aggregation, no scatter at all


@dataclasses.dataclass
class GroupByState:
    """Open-addressing table + per-slot aggregate accumulators."""

    table: torch.Tensor  # [capacity+1] int64 packed keys; EMPTY_KEY = free; last = sink
    key_cols: tuple  # per-key original values captured at insert ([capacity+1] each)
    key_nulls: tuple  # per-key null flag per slot
    accs: tuple  # per-accumulator arrays ([capacity+1])
    overflow: torch.Tensor  # bool scalar: some row failed to place within MAX_PROBES

    @property
    def capacity(self) -> int:
        return self.table.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.table.device


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=torch_dtype(dtype), device=device)


def groupby_init(capacity: int, key_dtypes, acc_specs, device="cpu") -> GroupByState:
    """acc_specs: sequence of (dtype, init_scalar) per accumulator array."""
    capacity = ceil_pow2(capacity)  # double-hash coverage needs a pow2 table
    table = torch.full((capacity + 1,), EMPTY_KEY, dtype=torch.int64, device=device)
    key_cols = tuple(torch.zeros((capacity + 1,), dtype=torch_dtype(dt), device=device)
                     for dt in key_dtypes)
    key_nulls = tuple(torch.zeros((capacity + 1,), dtype=torch.bool, device=device)
                      for _ in key_dtypes)
    accs = tuple(_full(capacity + 1, init, dt, device) for dt, init in acc_specs)
    return GroupByState(table, key_cols, key_nulls, accs,
                        torch.zeros((), dtype=torch.bool, device=device))


@dataclasses.dataclass(frozen=True)
class DirectConfig:
    """Static layout of a direct-indexed group-by: per key (nullable, lo, hi,
    value_bits), most-significant first.  slot = bit-concatenation of
    [null_flag?, (value - lo)] fields; total_bits <= DIRECT_BITS_MAX."""

    entries: tuple
    total_bits: int

    @property
    def capacity(self) -> int:
        return 1 << self.total_bits


def direct_config(key_ranges, key_nullable, max_bits: int = DIRECT_BITS_MAX):
    """A DirectConfig, or None when ranges are unknown or too wide."""
    entries, total = [], 0
    for rng, nullable in zip(key_ranges, key_nullable):
        if rng is None or rng[0] is None or rng[1] is None:
            return None
        lo, hi = int(rng[0]), int(rng[1])
        if hi < lo:
            hi = lo
        vb = max(int(hi - lo).bit_length(), 1)
        total += vb + (1 if nullable else 0)
        entries.append((bool(nullable), lo, hi, vb))
    if total > max_bits:
        return None
    return DirectConfig(tuple(entries), total)


def direct_groupby_init(cfg: DirectConfig, key_dtypes, acc_specs,
                        device="cpu") -> GroupByState:
    """Direct-mode state: key columns are pre-filled by unpacking each slot
    index (packing is injective), so inserts never scatter key captures."""
    C = cfg.capacity
    table = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=device)
    slots = torch.arange(C + 1, dtype=torch.int64, device=device)
    key_cols, key_nulls = [], []
    shift = cfg.total_bits
    for (nullable, lo, hi, vb), dt in zip(cfg.entries, key_dtypes):
        if nullable:
            shift -= 1
            flag = ((slots >> shift) & 1).to(torch.bool)
        else:
            flag = torch.zeros((C + 1,), dtype=torch.bool, device=device)
        shift -= vb
        val = (((slots >> shift) & ((1 << vb) - 1)) + lo).to(torch_dtype(dt))
        key_cols.append(torch.where(flag, torch.zeros_like(val), val))
        key_nulls.append(flag)
    accs = tuple(_full(C + 1, init, dt, device) for dt, init in acc_specs)
    return GroupByState(table, tuple(key_cols), tuple(key_nulls), accs,
                        torch.zeros((), dtype=torch.bool, device=device))


def _direct_slot(cfg: DirectConfig, key_vals, key_nulls, valid):
    """(slot[int32], in_range[bool]) — slot is the packed key; rows outside the
    static ranges raise the overflow flag so the caller falls back to hash mode."""
    n = key_vals[0].shape[0]
    dev = key_vals[0].device
    acc = torch.zeros((n,), dtype=torch.int64, device=dev)
    ok = torch.ones((n,), dtype=torch.bool, device=dev)
    for (nullable, lo, hi, vb), kv, kn in zip(cfg.entries, key_vals, key_nulls):
        isnull = kn if kn is not None else torch.zeros((n,), dtype=torch.bool, device=dev)
        mv = torch.where(isnull, torch.zeros_like(kv), kv) if kn is not None else kv
        v64 = mv.to(torch.int64)
        ok = ok & (isnull | ((v64 >= lo) & (v64 <= hi)))
        if nullable:
            acc = (acc << 1) | isnull.to(torch.int64)
        elif kn is not None:
            # a later page introduced a null mask the config reserved no flag
            # bit for: route NULL rows to overflow (hash-mode fallback)
            ok = ok & ~isnull
        acc = (acc << vb) | ((v64 - lo) & ((1 << vb) - 1))
    return acc.to(torch.int32), ok


def direct_groupby_insert(state: GroupByState, cfg: DirectConfig, key_vals,
                          valid, agg_inputs, agg_updates,
                          key_nulls=None, inplace: bool = False) -> GroupByState:
    """One page -> updated direct-mode state.  No probing: slot = packed key.
    Capacities <= ONEHOT_CAP_MAX aggregate via masked reductions over a
    [rows, capacity] one-hot — zero scatters.  ``inplace``: see the module
    note."""
    if key_nulls is None:
        key_nulls = tuple(None for _ in key_vals)
    C = cfg.capacity
    dev = state.device
    slot, ok = _direct_slot(cfg, key_vals, key_nulls, valid)
    live = valid & ok
    overflow = _or(state.overflow, torch.any(valid & ~ok), inplace)

    if C <= ONEHOT_CAP_MAX:
        lanes = torch.arange(C, dtype=torch.int32, device=dev)
        onehot = (slot[:, None] == lanes[None, :]) & live[:, None]  # [n, C]
        occ = torch.cat([torch.any(onehot, dim=0),
                         torch.zeros((1,), dtype=torch.bool, device=dev)])
        table = torch.where(occ, torch.arange(C + 1, dtype=torch.int64, device=dev),
                            state.table)
        if inplace:
            table = state.table.copy_(table)
        accs = tuple(
            _onehot_agg_update(acc, kind, onehot, vals_nulls, inplace)
            for acc, kind, vals_nulls in zip(state.accs, agg_updates, agg_inputs))
        return GroupByState(table, state.key_cols, state.key_nulls, accs, overflow)

    idx = torch.where(live, slot, C).to(torch.int64)
    words = torch.where(live, idx, torch.full_like(idx, EMPTY_KEY))
    table = state.table.index_put_((idx,), words) if inplace \
        else state.table.index_put((idx,), words)
    table[C:].fill_(EMPTY_KEY)  # a fill on the device: no host copy
    accs = tuple(
        agg_update(acc, kind, slot, live, vals_nulls, inplace)
        for acc, kind, vals_nulls in zip(state.accs, agg_updates, agg_inputs))
    return GroupByState(table, state.key_cols, state.key_nulls, accs, overflow)


def _or(flag, more, inplace: bool):
    """``flag | more`` for 0-d bools, into ``flag`` where ``inplace``."""
    return flag.logical_or_(more) if inplace else flag | more


def _onehot_agg_update(acc, kind, onehot, vals_nulls, inplace: bool = False):
    """Aggregate one page into [capacity]-wide accumulators via masked
    reductions over the one-hot (the overflow sink stays untouched); into
    ``acc`` where ``inplace``."""
    out = _onehot_agg_value(acc, kind, onehot, vals_nulls)
    return acc.copy_(out) if inplace else out


def _onehot_agg_value(acc, kind, onehot, vals_nulls):
    vals, nulls = vals_nulls if vals_nulls is not None else (None, None)
    C = onehot.shape[1]
    mask = onehot if (nulls is None or vals is None) else (onehot & ~nulls[:, None])
    head, sink = acc[:C], acc[C:]
    if kind in ("count_star", "count"):
        m = onehot if kind == "count_star" else mask
        return torch.cat([head + m.sum(dim=0).to(acc.dtype), sink])
    if kind in ("sum", "sum_hi32", "sum_lo32", "sum_sq"):
        if kind == "sum_hi32":
            v = vals >> 32
        elif kind == "sum_lo32":
            v = vals & 0xFFFFFFFF
        elif kind == "sum_sq":
            v = vals.to(acc.dtype)
            v = v * v
        else:
            v = vals
        v = torch.broadcast_to(v, mask.shape[:1])[:, None].to(acc.dtype)
        delta = torch.where(mask, v, torch.zeros((), dtype=acc.dtype, device=acc.device))
        return torch.cat([head + delta.sum(dim=0), sink])
    if kind in ("min", "max"):
        ext = _extreme(acc.dtype, +1 if kind == "min" else -1)
        v = torch.broadcast_to(vals, mask.shape[:1])[:, None].to(acc.dtype)
        filled = torch.where(mask, v, torch.full((), ext, dtype=acc.dtype,
                                                 device=acc.device))
        if kind == "min":
            return torch.cat([torch.minimum(head, filled.amin(dim=0)), sink])
        return torch.cat([torch.maximum(head, filled.amax(dim=0)), sink])
    raise NotImplementedError(kind)


def _probe_insert(table, packed, valid):
    """Assign each valid row a slot whose table word == its packed key,
    claiming EMPTY slots of ``table`` in place.  Returns (slot[int32],
    placed[bool]); the ``hash_insert_`` kernel on the card, its plain
    version on the CPU."""
    return cuda_kernels.hash_insert_(table, packed, valid, max_probes=MAX_PROBES)


def groupby_insert(state: GroupByState, key_vals: Sequence, key_types, valid,
                   agg_inputs: Sequence, agg_updates: Sequence[str],
                   key_nulls: Sequence = None, inplace: bool = False) -> GroupByState:
    """One page of input -> updated state, whose table is ``state.table``
    updated in place (see the module note; ``inplace``: every tensor).

    agg_inputs[i]: (values|None, null_mask|None); agg_updates[i]: update kind;
    key_nulls[i]: null mask of key i or None (SQL GROUP BY: NULLs form ONE
    group).  The packed layout is identical for every page of one aggregation:
    a single key reserves a sentinel word for its NULL group, multiple keys
    carry one flag bit each, always."""
    if key_nulls is None:
        key_nulls = tuple(None for _ in key_vals)
    if len(key_vals) == 1:
        kv, kt, kn = key_vals[0], key_types[0], key_nulls[0]
        mv = torch.where(kn, torch.zeros_like(kv), kv) if kn is not None else kv
        masked_vals = [mv]
        packed, _ = pack_keys((mv,), (kt,))
        if kn is not None:
            packed = torch.where(packed == EMPTY_KEY - 2, packed + 1, packed)
            packed = torch.where(kn, torch.full_like(packed, EMPTY_KEY - 2), packed)
    else:
        pack_cols, pack_types, masked_vals = [], [], []
        for kv, kt, kn in zip(key_vals, key_types, key_nulls):
            mv = kv if kn is None else torch.where(kn, torch.zeros_like(kv), kv)
            masked_vals.append(mv)
            pack_cols.append(torch.zeros(kv.shape, dtype=torch.int8, device=kv.device)
                             if kn is None else kn.to(torch.int8))
            pack_types.append(_BOOL_KEY)
            pack_cols.append(mv)
            pack_types.append(kt)
        packed, _ = pack_keys(tuple(pack_cols), tuple(pack_types))
    table = state.table
    slot, placed = _probe_insert(table, packed, valid)
    overflow = _or(state.overflow, torch.any(valid & ~placed), inplace)
    live = valid & placed

    # capture original key values per slot (idempotent writes: same key -> same value)
    def capture(col, vals):
        sink = col.shape[0] - 1
        idx = torch.where(live, slot, sink).to(torch.int64)
        words = torch.where(live, vals.to(col.dtype), col[-1])
        return col.index_put_((idx,), words) if inplace else col.index_put((idx,), words)

    key_cols = tuple(capture(kc, kv) for kc, kv in zip(state.key_cols, masked_vals))
    state_knulls = tuple(sk if kn is None else capture(sk, kn)
                         for sk, kn in zip(state.key_nulls, key_nulls))
    accs = tuple(
        agg_update(acc, kind, slot, live, vals_nulls, inplace)
        for acc, kind, vals_nulls in zip(state.accs, agg_updates, agg_inputs))
    return GroupByState(table, key_cols, state_knulls, accs, overflow)


def agg_update(acc, kind, slot, live, vals_nulls, inplace: bool = False):
    """One scatter update of a [capacity+1] accumulator; masked rows go to the
    sink.  ``inplace``: into ``acc``, which it returns."""
    vals, nulls = vals_nulls if vals_nulls is not None else (None, None)
    mask = live if (nulls is None or vals is None) else (live & ~nulls)
    sink = acc.shape[0] - 1
    idx = torch.where(mask, slot, sink).to(torch.int64)
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    add = acc.index_add_ if inplace else acc.index_add
    if kind == "count_star":
        return add(0, idx, live.to(acc.dtype))
    if kind == "count":
        return add(0, idx, mask.to(acc.dtype))
    if kind in ("sum", "sum_hi32", "sum_lo32", "sum_sq"):
        if kind == "sum_hi32":
            v = vals >> 32
        elif kind == "sum_lo32":
            # two-limb exact decimal sum: v == (v >> 32) * 2^32 + (v & 0xFFFFFFFF)
            v = vals & 0xFFFFFFFF
        elif kind == "sum_sq":
            v = vals.to(acc.dtype)
            v = v * v
        else:
            v = vals
        v = torch.broadcast_to(v, mask.shape).to(acc.dtype)
        return add(0, idx, torch.where(mask, v, zero))
    if kind in ("min", "max"):
        ext = _extreme(acc.dtype, +1 if kind == "min" else -1)
        v = torch.broadcast_to(vals, mask.shape).to(acc.dtype)
        v = torch.where(mask, v, torch.full((), ext, dtype=acc.dtype, device=acc.device))
        red = acc.scatter_reduce_ if inplace else acc.scatter_reduce
        return red(0, idx, v, "amin" if kind == "min" else "amax", include_self=True)
    raise NotImplementedError(kind)


def _extreme(dtype, sign):
    dt = torch_dtype(dtype)
    if dt.is_floating_point:
        return float("inf") * sign
    if dt == torch.bool:
        return sign > 0
    info = torch.iinfo(dt)
    return info.max if sign > 0 else info.min


_REHASH_KIND = {"sum": "sum", "count": "sum", "count_star": "sum",
                "min": "min", "max": "max", "sum_sq": "sum",
                # limb accumulators re-insert by plain addition (already split)
                "sum_hi32": "sum", "sum_lo32": "sum"}


def rehash(state: GroupByState, new_capacity: int, acc_kinds: tuple = ()) -> GroupByState:
    """Re-insert every occupied entry into a new, larger table (``state`` is
    left untouched); accumulators re-insert as partial values (count ->
    sum)."""
    C = state.capacity
    dev = state.device
    occupied = state.table[:C] != EMPTY_KEY
    keys = tuple(k[:C] for k in state.key_cols)
    knulls = tuple(kn[:C] for kn in state.key_nulls)
    accs = tuple(a[:C] for a in state.accs)
    fresh = GroupByState(
        table=torch.full((new_capacity + 1,), EMPTY_KEY, dtype=torch.int64, device=dev),
        key_cols=tuple(torch.zeros((new_capacity + 1,), dtype=k.dtype, device=dev)
                       for k in state.key_cols),
        key_nulls=tuple(torch.zeros((new_capacity + 1,), dtype=torch.bool, device=dev)
                        for _ in state.key_nulls),
        accs=tuple(torch.full((new_capacity + 1,), _init_for(kind, a.dtype),
                              dtype=a.dtype, device=dev)
                   for kind, a in zip(acc_kinds, state.accs)),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )
    key_types = tuple(_KT(k.dtype) for k in keys)
    merge = [_REHASH_KIND[k] for k in acc_kinds]
    return groupby_insert(fresh, keys, key_types, occupied,
                          [(a, None) for a in accs], merge, knulls)


def _init_for(kind: str, dtype):
    if kind == "min":
        return _extreme(dtype, +1)
    if kind == "max":
        return _extreme(dtype, -1)
    return 0


class _KT:
    """Minimal Type stand-in for rehash key packing: maps the stored dtype back
    to its widest type class, which reproduces the original packed layout."""

    _NAMES = {torch.int64: "bigint", torch.int32: "integer", torch.int16: "smallint",
              torch.int8: "tinyint", torch.bool: "boolean", torch.float64: "double",
              torch.float32: "real"}

    def __init__(self, dtype):
        self.dtype = dtype
        self.name = self._NAMES.get(dtype, "bigint")
        self.is_string = False
        self.is_floating = dtype.is_floating_point


def group_count(state: GroupByState):
    """Occupied-slot count (device scalar)."""
    C = state.capacity
    return torch.sum(state.table[:C] != EMPTY_KEY, dtype=torch.int32)


def compact_groups(state: GroupByState, size: int):
    """The occupied groups packed to the front of ``size``-row arrays, on the
    device, through the compaction kernel (rows past the group count are
    zero; the reference pads with slot 0's values — callers read only the
    first group-count rows)."""
    C = state.capacity
    occupied = state.table[:C] != EMPTY_KEY
    cols = tuple(k[:C] for k in state.key_cols) + tuple(kn[:C] for kn in state.key_nulls) \
        + tuple(a[:C] for a in state.accs)
    packed, _ = compact_rows(cols, occupied, size)
    nk = len(state.key_cols)
    return packed[:nk], packed[nk:2 * nk], packed[2 * nk:]

