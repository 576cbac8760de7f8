"""Window function primitives over torch tensors (counterpart of
``trino_tpu/ops/window.py``).

A window function is computed for every row at once over the rows sorted by
(partition, order) keys:

- one stable multi-key sort puts partition rows and peer rows adjacent;
- partition and peer-group boundaries become boolean change masks;
- ranking functions are arithmetic over boundary prefix sums and running
  maxima;
- framed aggregates are differences of prefix sums, segmented scans or a
  sparse table, gathered at each row's frame edges;
- the caller scatters the results back through the sort permutation.

These are plain PyTorch, as the reference's are plain XLA: no TPU kernel
backs them.  Indices are int64 (the reference's are int32; the values are
equal).  Min and max are exact, so every primitive but the floating sums
matches the reference bit for bit.
"""

from __future__ import annotations

import torch

from ..types import torch_dtype

__all__ = ["window_order", "segments", "row_number", "rank", "dense_rank",
           "segmented_scan_sum", "segmented_scan_minmax", "partition_total",
           "frame_bounds", "nonnull_positions", "shift_ignore_nulls",
           "framed_nth_nonnull", "framed_sum", "framed_minmax",
           "shift_in_partition"]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _cast(v, dtype):
    return v if dtype is None else v.to(torch_dtype(dtype))


def window_order(key_cols, descending_flags) -> torch.Tensor:
    """Stable lexicographic sort permutation over key columns (first key
    primary).  A descending key sorts by its negation: floats as they are,
    every other dtype (bool included) widened to int64 first."""
    n = key_cols[0].shape[0]
    perm = _iota(n, key_cols[0].device)
    for col, desc in reversed(list(zip(key_cols, descending_flags))):
        k = col[perm]
        if desc:
            k = -k if k.is_floating_point() else -k.to(torch.int64)
        elif k.dtype == torch.bool:
            k = k.to(torch.int8)
        perm = perm[torch.sort(k, stable=True).indices]
    return perm


def segments(sorted_key_cols) -> torch.Tensor:
    """Boundary mask over sorted rows: True where a new group starts (row 0
    included)."""
    n = sorted_key_cols[0].shape[0]
    dev = sorted_key_cols[0].device
    new = torch.zeros((n,), dtype=torch.bool, device=dev)
    new[:1] = True
    for c in sorted_key_cols:
        new[1:] |= c[1:] != c[:-1]
    return new


def _starts(new) -> torch.Tensor:
    """Per-row index of its group's first row (running max of marked starts)."""
    idx = _iota(new.shape[0], new.device)
    return torch.cummax(torch.where(new, idx, 0), 0).values


def _ends(new) -> torch.Tensor:
    """Per-row index of its group's last row (reverse running min of marked
    ends)."""
    n = new.shape[0]
    idx = _iota(n, new.device)
    is_last = torch.cat([new[1:], torch.ones((1,), dtype=torch.bool, device=new.device)])
    marked = torch.where(is_last, idx, n - 1)
    return torch.flip(torch.cummin(torch.flip(marked, (0,)), 0).values, (0,))


def row_number(part_new) -> torch.Tensor:
    return _iota(part_new.shape[0], part_new.device) - _starts(part_new) + 1


def rank(part_new, peer_new) -> torch.Tensor:
    return _starts(peer_new) - _starts(part_new) + 1


def dense_rank(part_new, peer_new) -> torch.Tensor:
    d = torch.cumsum(peer_new.to(torch.int64), 0)
    return d - d[_starts(part_new)] + 1


def _cumsum(v):
    """Inclusive prefix sum.  Floats add in one fixed order on every device:
    a log-step (Hillis-Steele) scan of elementwise adds, so the card and the
    CPU give the same bits (``torch.cumsum`` adds in another order on the
    card, and a frame's sum, the difference of two prefix sums, can cancel
    to well below the prefixes' rounding).  Integers are exact either way."""
    if not v.is_floating_point():
        return torch.cumsum(v, 0)
    n = v.shape[0]
    d = 1
    while d < n:
        v = torch.cat([v[:d], v[d:] + v[:-d]])
        d *= 2
    return v


def _prefix_range_sum(v, lo, hi):
    """sum(v[lo..hi]) per row as a difference of inclusive prefix sums.  An
    empty frame's ``lo`` may lie past the last row: its index clamps, as a
    JAX gather clamps (the caller masks the row)."""
    csum = _cumsum(v)
    base = torch.where(lo > 0, csum[torch.clamp(lo - 1, 0, v.shape[0] - 1)],
                       torch.zeros((), dtype=v.dtype, device=v.device))
    return csum[hi] - base


def segmented_scan_sum(vals, part_new, peer_new, dtype=None):
    """Running sum per row over RANGE UNBOUNDED PRECEDING .. CURRENT ROW
    (peers share the value at their group's last row)."""
    return _prefix_range_sum(_cast(vals, dtype), _starts(part_new), _ends(peer_new))


def segmented_scan_minmax(vals, part_new, peer_new, kind: str):
    """Running min/max with partition resets: a log-step (Hillis-Steele)
    segmented inclusive scan over the sorted rows, gathered at each row's
    peer-group end.  Step d combines row i with row i-d when both lie in one
    partition; after the steps 1, 2, 4, ... every row holds the extreme of
    its partition's rows up to itself."""
    op = torch.minimum if kind == "min" else torch.maximum
    seg = torch.cumsum(part_new.to(torch.int64), 0)
    n = vals.shape[0]
    acc = vals.clone()
    d = 1
    while d < n:
        same = seg[d:] == seg[:-d]
        acc = torch.cat([acc[:d], torch.where(same, op(acc[d:], acc[:-d]), acc[d:])])
        d *= 2
    return acc[_ends(peer_new)]


def partition_total(vals, part_new, dtype=None):
    """Whole-partition aggregate broadcast to every partition row (no ORDER
    BY frame)."""
    return _prefix_range_sum(_cast(vals, dtype), _starts(part_new), _ends(part_new))


# ---------------------------------------------------------------------------- frames
# Explicit ROWS/RANGE BETWEEN frames.  Bound kinds: "up" UNBOUNDED PRECEDING |
# "p" k PRECEDING | "cr" CURRENT ROW | "f" k FOLLOWING | "uf" UNBOUNDED FOLLOWING.


def frame_bounds(part_new, peer_new, frame, order_vals=None):
    """Per-row inclusive [lo, hi] sorted indices of the frame; hi < lo is an
    empty frame.

    ROWS frames are index arithmetic clamped to the partition; RANGE frames
    with non-offset bounds use peer-group edges (CURRENT ROW in RANGE means
    "through my peers"); RANGE ``k PRECEDING/FOLLOWING`` bounds need
    ``order_vals``, the single ORDER BY key's values in sorted order,
    ascending-normalized, and resolve by one binary search over a
    partition-offset key that increases across the whole page."""
    unit, s_type, s_k, e_type, e_k = frame
    n = part_new.shape[0]
    i = _iota(n, part_new.device)
    p_start, p_end = _starts(part_new), _ends(part_new)
    if unit == "rows":
        lo = {"up": lambda: p_start, "p": lambda: i - s_k, "cr": lambda: i,
              "f": lambda: i + s_k}[s_type]()
        hi = {"uf": lambda: p_end, "p": lambda: i - e_k, "cr": lambda: i,
              "f": lambda: i + e_k}[e_type]()
    elif s_type in ("p", "f") or e_type in ("p", "f"):
        # w = (v - vmin) + seg * span, where span exceeds any in-partition
        # value range plus the largest offset: values stay ordered within a
        # partition and every partition's keys sit above the previous one's
        v = order_vals
        seg = torch.cumsum(part_new.to(v.dtype if v.is_floating_point() else torch.int64), 0)
        vmin = torch.min(v)
        span = (torch.max(v) - vmin) + (max(s_k, e_k) + 1)
        w = (v - vmin) + seg * span  # non-decreasing: rows sort by (partition, v)
        w = w.contiguous()

        def at(delta, right):
            r = torch.searchsorted(w, w + delta, right=right)
            return r - 1 if right else r

        lo = p_start if s_type == "up" else _starts(peer_new) if s_type == "cr" \
            else at(-s_k if s_type == "p" else s_k, False)
        hi = p_end if e_type == "uf" else _ends(peer_new) if e_type == "cr" \
            else at(e_k if e_type == "f" else -e_k, True)
    else:  # range: peer-group granularity
        lo = {"up": p_start, "cr": _starts(peer_new)}[s_type]
        hi = {"uf": p_end, "cr": _ends(peer_new)}[e_type]
    return torch.maximum(lo, p_start), torch.minimum(hi, p_end)


# ------------------------------------------------------------------ IGNORE NULLS
def nonnull_positions(valid):
    """(g, P): g[i] = 1-based count of non-null rows through i (sorted
    order); P[r] = index of the r-th non-null row (P[0] is a sink whose
    value is never used)."""
    n = valid.shape[0]
    g = torch.cumsum(valid.to(torch.int64), 0)
    P = torch.zeros((n + 1,), dtype=torch.int64, device=valid.device)
    P.scatter_(0, torch.where(valid, g, 0), _iota(n, valid.device))
    return g, P


def shift_ignore_nulls(vals, valid, part_new, offset: int, default):
    """lag/lead over NON-NULL rows only: the k-th non-null row before (after)
    each row within its partition.  offset > 0 = lag, < 0 = lead."""
    if offset == 0:
        # offset 0 addresses the current row; a NULL current value stays NULL
        return vals, ~valid
    if offset < 0:
        # lead = lag over the reversed order, whose partitions start at the
        # (reversed) last rows of the groups
        is_last = torch.cat([part_new[1:],
                             torch.ones((1,), dtype=torch.bool, device=part_new.device)])
        res, miss = shift_ignore_nulls(torch.flip(vals, (0,)), torch.flip(valid, (0,)),
                                       torch.flip(is_last, (0,)), -offset, default)
        return torch.flip(res, (0,)), torch.flip(miss, (0,))
    n = vals.shape[0]
    g, P = nonnull_positions(valid)
    # rank of the target: non-nulls strictly before me, minus (offset - 1)
    target = g - valid.to(torch.int64) - (offset - 1)
    cand = P[torch.clamp(target, 0, n)]
    ok = (target >= 1) & (cand >= _starts(part_new))
    return torch.where(ok, vals[torch.clamp(cand, 0, n - 1)], default), ~ok


def framed_nth_nonnull(vals, valid, lo, hi, k: int, from_end: bool = False):
    """(value, missing): the k-th non-null row inside each row's [lo, hi]
    frame, counted from the start (or from the end, for last_value)."""
    n = vals.shape[0]
    g, P = nonnull_positions(valid)
    before_lo = torch.where(lo > 0, g[torch.clamp(lo - 1, 0, n - 1)], 0)
    in_frame = g[torch.clamp(hi, 0, n - 1)] - before_lo
    rank_ = before_lo + in_frame - (k - 1) if from_end else before_lo + k
    cand = P[torch.clamp(rank_, 0, n)]
    ok = (hi >= lo) & (in_frame >= k) & (rank_ >= 1)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    return torch.where(ok, vals[torch.clamp(cand, 0, n - 1)], zero), ~ok


def framed_sum(vals, lo, hi, dtype=None):
    """Sum over each row's [lo, hi] (empty frames, hi < lo, yield 0)."""
    v = _cast(vals, dtype)
    s = _prefix_range_sum(v, lo, torch.clamp(hi, 0, v.shape[0] - 1))
    return torch.where(hi >= lo, s, torch.zeros((), dtype=v.dtype, device=v.device))


def framed_minmax(vals, lo, hi, kind: str):
    """Min/max over each row's [lo, hi] with a doubling sparse table:
    st[k][i] = op(v[i .. i+2^k-1]); a query combines two overlapping
    power-of-two blocks.  The table holds ``levels`` x n values
    (levels = bit length of n - 1).  The caller masks empty frames."""
    op = torch.minimum if kind == "min" else torch.maximum
    n = vals.shape[0]
    levels = max(int(n - 1).bit_length(), 1)
    st = [vals]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = st[-1]
        shifted = torch.cat([prev[half:], prev[-1:].expand(half)])
        st.append(op(prev, shifted))
    stk = torch.stack(st)  # [levels, n]
    length = torch.clamp(hi - lo + 1, min=1)
    # floor(log2(length)): length + 0.5 is never a power of two, so the float
    # log2 is far from an integer and the ceil is exact
    j = (torch.ceil(torch.log2(length.to(torch.float64) + 0.5)) - 1).to(torch.int64)
    j = torch.clamp(j, 0, levels - 1)
    lo_c = torch.clamp(lo, 0, n - 1)
    b = torch.clamp(hi - (torch.ones_like(j) << j) + 1, 0, n - 1)
    return op(stk[j, lo_c], stk[j, b])


def shift_in_partition(vals, part_new, offset: int, default):
    """lag (offset > 0) / lead (offset < 0) within the partition, sorted order."""
    n = vals.shape[0]
    src = _iota(n, vals.device) - offset
    src_c = torch.clamp(src, 0, n - 1)
    seg = torch.cumsum(part_new.to(torch.int64), 0)
    ok = (src >= 0) & (src < n) & (seg[src_c] == seg)
    return torch.where(ok, vals[src_c], default), ~ok
