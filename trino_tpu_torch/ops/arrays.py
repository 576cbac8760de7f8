"""Array/map value runtime and compaction (counterpart of ``trino_tpu/ops/arrays.py``).

An array(T) column is one int64 column of packed spans (start << 24 | length)
into a host-side element heap; heaps ride the planner's per-channel
dictionary slot, whose ``decode`` the result path calls.  Element access
(subscript, contains, UNNEST) gathers from a device copy of the heap that the
executor makes once per query (``sql/ir.py``).

Ported: the heap classes, ``encode_arrays`` (the storage path of the memory
connector), ``unnest_indices`` (UNNEST's expansion map), ``compact_rows``,
the shared filter -> compaction step, which runs through the ``compact_rows``
CUDA kernel on the card, and ``append_rows``, the distributed exchange's
accumulation step built on it.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from . import cuda_kernels

__all__ = ["SPAN_BITS", "ArrayData", "MapData", "pack_span", "span_start",
           "span_len", "encode_arrays", "compact_rows", "append_rows", "unnest_indices"]

SPAN_BITS = 24  # max 16M elements per array; 2^39 heap rows
_LEN_MASK = (1 << SPAN_BITS) - 1


def pack_span(start, length):
    return (start << SPAN_BITS) | length


def span_start(span):
    return span >> SPAN_BITS


def span_len(span):
    return span & _LEN_MASK


@dataclasses.dataclass
class ArrayData:
    """Heap for one array(T) column (host-side numpy; device-transferred at the
    access sites).  ``elem_dict`` decodes string elements; plugged into the
    engine's dictionary slot so results decode through the normal path."""

    values: np.ndarray  # flattened element heap
    elem_type: object
    elem_dict: object = None
    max_len: int = 0

    def decode(self, spans: np.ndarray) -> np.ndarray:
        """Span column -> object array of python lists (result materialization)."""
        starts = np.asarray(span_start(spans))
        lens = np.asarray(span_len(spans))
        vals = self.values
        if self.elem_dict is not None:
            vals = self.elem_dict.decode(vals.astype(np.int64))
        elif getattr(self.elem_type, "is_decimal", False):
            vals = vals.astype(np.float64) / (10 ** self.elem_type.scale)
        out = np.empty(len(starts), dtype=object)
        for i, (s, l) in enumerate(zip(starts.tolist(), lens.tolist())):
            out[i] = list(vals[s:s + l].tolist())
        return out


@dataclasses.dataclass
class MapData:
    """Parallel key/value heaps for one map(K, V) column."""

    keys: np.ndarray
    values: np.ndarray
    key_type: object
    value_type: object
    key_dict: object = None
    value_dict: object = None
    max_len: int = 0

    @staticmethod
    def _decode_side(vals, d, t):
        """Dictionary ids -> strings; scaled decimals -> floats; DATE /
        TIMESTAMP epoch ints -> datetime64 (temporal values decode at every
        result surface)."""
        if d is not None:
            return d.decode(vals.astype(np.int64))
        if getattr(t, "is_decimal", False):
            return vals.astype(np.float64) / (10 ** t.scale)
        name = getattr(t, "name", "")
        if name == "date":
            return vals.astype(np.int64).astype("datetime64[D]")
        if name.startswith("timestamp"):
            unit = {0: "s", 3: "ms", 6: "us", 9: "ns"}.get(
                getattr(t, "precision", None))
            if unit:
                return vals.astype(np.int64).astype(f"datetime64[{unit}]")
        return vals

    def decode(self, spans: np.ndarray) -> np.ndarray:
        starts = np.asarray(span_start(spans))
        lens = np.asarray(span_len(spans))
        ks = self._decode_side(self.keys, self.key_dict, self.key_type)
        vs = self._decode_side(self.values, self.value_dict, self.value_type)
        out = np.empty(len(starts), dtype=object)
        for i, (s, l) in enumerate(zip(starts.tolist(), lens.tolist())):
            out[i] = dict(zip(ks[s:s + l].tolist(), vs[s:s + l].tolist()))
        return out


def encode_arrays(rows, elem_dtype, encoder=None):
    """Python lists (None allowed) -> (spans int64, null mask, heap ndarray).

    The storage path (memory connector INSERT, literal folding): elements
    flatten into one heap in row order; each row's span points at its slice."""
    rows = list(rows)
    nulls = np.fromiter((r is None for r in rows), bool, len(rows))
    lens = np.fromiter((0 if r is None else len(r) for r in rows), np.int64, len(rows))
    flat = list(itertools.chain.from_iterable(r for r in rows if r is not None))
    if encoder:
        flat = [encoder(v) for v in flat]
    spans = np.where(nulls, 0, pack_span(np.cumsum(lens) - lens, lens))
    heap = np.asarray(flat, dtype=elem_dtype) if flat else np.zeros(0, elem_dtype)
    return spans, (nulls if nulls.any() else None), heap


def compact_rows(arrays, valid, out_len: int):
    """Order-preserving masked-lane pack, THE shared filter->compaction step:
    live lanes move to the front of ``out_len``-sized outputs (zeros beyond
    the live count, overflow lanes dropped), ``None`` entries pass through.
    Returns (packed tuple, live-count device scalar).  Byte-identical to the
    reference's XLA cumsum-scatter."""
    return cuda_kernels.compact_rows(tuple(arrays), valid, out_len)


def append_rows(bufs, cursor, arrays, valid):
    """Masked append into fixed-capacity receive buffers, the distributed
    exchange's accumulation step.  ``bufs[i]`` is a ``[cap + 1]`` buffer
    whose last slot is a drop sink; the live lanes of ``arrays`` (packed in
    order by ``compact_rows``) land at ``cursor .. cursor + count - 1``
    (``cursor`` a 0-d int64 tensor).  Rows past ``cap`` collapse into the
    sink: slots below the cursor are never touched, and the overflow flag
    is the only casualty, so the executor can discard the run and retry with
    a bigger capacity.  The buffers are written IN PLACE and returned.

    Byte-identical to the reference's last-wins scatter, sink included:
    lanes routed to the sink are a suffix of the lanes, so the sink ends
    with the last lane's value; every sink lane writes that one value here,
    which keeps the duplicate writes to the sink deterministic on the card.
    Returns (bufs, new_cursor, overflowed)."""
    n = valid.shape[0]
    packed, cnt = compact_rows(tuple(arrays), valid, n)
    if n == 0:
        return tuple(bufs), cursor, cursor > bufs[0].shape[0] - 1
    cap = bufs[0].shape[0] - 1
    idx = torch.arange(n, dtype=torch.int64, device=valid.device)
    dst = torch.where(idx < cnt, torch.clamp(cursor + idx, max=cap), cap)
    sink = dst == cap
    for b, p in zip(bufs, packed):
        b.index_put_((dst,), torch.where(sink, p[n - 1], p))
    new_cursor = cursor + cnt
    return tuple(bufs), new_cursor, new_cursor > cap


def unnest_indices(lens, total: int):
    """Expansion map for UNNEST: output slot j -> (input row i, ordinal k,
    in_range), on the device of ``lens``.  The same searchsorted shape as the
    multi-match join's expansion.  ``lens`` = per input row output count (0
    for invalid rows); ``total`` is the output capacity."""
    lens = lens.to(torch.int64).contiguous()
    incl = torch.cumsum(lens, 0)
    j = torch.arange(total, dtype=torch.int64, device=lens.device)
    if lens.shape[0] == 0:
        zeros = torch.zeros((total,), dtype=torch.int32, device=lens.device)
        return zeros, zeros, torch.zeros((total,), dtype=torch.bool, device=lens.device)
    row = torch.searchsorted(incl, j, right=True)
    row_safe = torch.clamp(row, max=lens.shape[0] - 1)
    before = incl[row_safe] - lens[row_safe]
    ordinal = (j - before).to(torch.int32)
    return row_safe.to(torch.int32), ordinal, j < incl[-1]
