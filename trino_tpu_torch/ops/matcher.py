"""Vectorized row-pattern matching for MATCH_RECOGNIZE
(counterpart of ``trino_tpu/ops/matcher.py``).

For the dominant class of patterns, greedy backtracking collapses to
run-length arithmetic that vectorizes over every candidate start at once:

    If every quantified element's condition is row-disjoint from every LATER
    element's condition, a greedy quantifier never benefits from giving rows
    back — any row it released would have to satisfy some later element,
    which disjointness forbids.  Maximal-run assignment IS the backtracking
    assignment.

Under that (runtime-checked) gate, a match starting at row i is a chain of
per-element run-length jumps: pos_0 = i, pos_{k+1} = pos_k + clip(run_k(pos_k)),
computed with gathers over precomputed run-length arrays for every start at
once, on the device of the condition vectors.  Patterns outside the subset
(overlapping quantified conditions, ALL ROWS PER MATCH) keep the executor's
exact host backtracker.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["vector_match", "VectorMatch"]


@dataclasses.dataclass
class VectorMatch:
    """Precomputed match geometry: usable[i] = a non-empty match starts at i;
    end[i] = its exclusive stop row; pos[k][i] = row where element k's span
    begins (pos[P][i] = end).  ``nxt[i]`` = first usable start at or after i
    (the skip-past-last-row jump table)."""

    usable: np.ndarray
    end: np.ndarray
    pos: np.ndarray  # [P+1, n]
    nxt: np.ndarray  # [n+1]
    var_element: dict  # var -> element index (single-element vars only)

    def by_var(self, i: int) -> dict:
        """first/last rows per measure-referenced variable for the match at i
        (enough for FIRST()/LAST() measure evaluation)."""
        out = {}
        for var, k in self.var_element.items():
            lo, hi = int(self.pos[k, i]), int(self.pos[k + 1, i])
            if hi > lo:
                out[var] = [lo, hi - 1]
        return out


def _reverse_cummin(x):
    """Suffix minimum: out[i] = min(x[i:])."""
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _host(arrays):
    return [a.cpu().numpy() for a in arrays]


def vector_match(pattern, conds: dict, new_part, measure_vars,
                 host=_host) -> VectorMatch | None:
    """Build the vectorized matcher, or None when the pattern/conditions fall
    outside the provably-equivalent subset (the caller uses the host
    matcher).  ``conds`` (var -> bool vector) and ``new_part`` are numpy
    arrays or tensors; the pass runs on their device.  ``host`` reads a list
    of tensors to numpy in one read (the executor passes its counted
    chokepoint): one read carries the gate, one the geometry."""
    n = len(new_part)
    if n == 0:
        return None
    els = []
    for el, q in pattern:
        if q not in (None, "?", "+", "*"):
            return None
        els.append((el if isinstance(el, tuple) else (el,), q))

    npart = torch.as_tensor(new_part)
    dev = npart.device
    ok_list = []
    for vars_, _ in els:
        ok = torch.zeros((n,), dtype=torch.bool, device=dev)
        for v in vars_:
            ok = ok | torch.as_tensor(conds[v], device=dev).to(torch.bool)
        ok_list.append(ok)

    # measure-referenced variables must live in exactly one
    # non-alternation element (their spans are then [pos_k, pos_{k+1}))
    var_element: dict = {}
    for k, (vars_, _) in enumerate(els):
        for v in vars_:
            var_element[v] = None if v in var_element or len(vars_) > 1 else k
    for v in measure_vars:
        if var_element.get(v) is None:
            return None
    var_element = {v: k for v, k in var_element.items()
                   if k is not None and v in measure_vars}

    # quantified elements must be disjoint from every later element
    overlaps = [torch.any(ok_list[k] & ok_list[m])
                for k, (_, q) in enumerate(els) if q is not None
                for m in range(k + 1, len(els))]
    if overlaps and any(bool(x) for x in host([torch.stack(overlaps)])[0]):
        return None

    # run lengths + the per-start jump chain
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    big = torch.full((n,), n, dtype=torch.int32, device=dev)
    # next partition start STRICTLY after i (runs must not cross it)
    starts_at = torch.where(npart, idx, big)
    boundary = torch.cat([_reverse_cummin(starts_at[1:]), big[:1]])

    runlens = []
    for ok in ok_list:
        nxt_false = _reverse_cummin(torch.where(~ok, idx, big))
        rl = torch.clamp(torch.minimum(nxt_false, boundary) - idx, min=0)
        runlens.append(torch.cat([rl, torch.zeros((1,), dtype=rl.dtype, device=dev)]))

    pos = idx
    match_ok = torch.ones((n,), dtype=torch.bool, device=dev)
    pos_stack = [pos]
    for (_, q), rl in zip(els, runlens):
        r = rl[torch.clamp(pos, 0, n).to(torch.int64)]
        # bound by the START row's partition: a quantified element's run
        # clipped at the boundary leaves pos on the NEXT partition's first
        # row, whose run length belongs to that partition
        r = torch.where(pos >= boundary, torch.zeros_like(r), r)
        take = torch.clamp(r, max=1) if q in (None, "?") else r
        need = 1 if q in (None, "+") else 0
        match_ok = match_ok & (r >= need)
        pos = pos + torch.where(match_ok, take, torch.zeros_like(take))
        pos_stack.append(pos)

    usable = match_ok & (pos > idx)
    usable_np, pos_np = host([usable, torch.stack(pos_stack)])
    iarr = np.arange(n)
    nxt = np.concatenate([
        np.minimum.accumulate(np.where(usable_np, iarr, n)[::-1])[::-1],
        [n]]).astype(np.int64)
    return VectorMatch(usable_np, pos_np[-1], pos_np, nxt, var_element)
