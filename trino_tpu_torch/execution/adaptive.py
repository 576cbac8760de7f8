"""Adaptive execution: the feedback loop from recorded plan-actuals and
measured compile costs to plan decisions (counterpart of
``trino_tpu/execution/adaptive.py``, copied: thresholds, EWMA, probation,
cooldown, the corrections and ``describe_decision`` are the reference's).

Reference: the reference engine's adaptive planning (FaultTolerantExecution
re-plans from runtime stats) and TQP (arxiv 2203.01877), which selects tensor
execution strategies from runtime shapes.  Per-node est-vs-actual
cardinalities (``PlanHistoryStore``) supply the benefit side, measured
re-plan costs supply the price side, and this module is THE chokepoint where
that record turns into a decision.  Nothing under exec/ or sql/ reads
``plan_history`` directly (tests/test_torch_isolation.py holds it): decision
logic lives here, the planner merely consumes the emitted correction facts.

The price on a CUDA engine: the reference prices a re-plan at the cold XLA
compile seconds a statement was seen to pay.  The port compiles no plans (its
kernels are built once per process), so the engine reports what a re-plan
costs it instead: ``compiles=1`` and ``compile_s`` = the statement's planning
seconds when it missed the plan cache, and 0 on a hit
(``Engine._adaptive_observe``).  The advisor's arithmetic is unchanged.  A
``dispatch_batch`` correction is computed as in the reference: it changes the
plan-cache key, and the corrected statement's executor coalesces at its width
(``Engine._run_select``; the cluster ships it in every task request).

``AdaptiveAdvisor`` is host-only: consult/observe are dict walks over
snapshots the engine already holds — zero kernel launches, zero ``_host``
reads.

Decision model
--------------
At statement admission the engine asks ``consult(key)`` with the statement's
plan-cache key.  The advisor keeps per-statement state fed by ``observe()``
(called on every clean completion with the execution's structural plan
fingerprint): the UNCORRECTED fingerprint is the history address, its
recorded per-node walls are the win model, and its observed cold
``compile_s`` is the primary re-plan price.

A statement becomes a re-plan candidate when its history holds a MATERIAL
misestimate: worst per-node ratio >= ``threshold`` (default 4x) on the
EWMA-backed ratio (``actual_rows_ewma`` vs est — one outlier execution is
damped by EWMA_ALPHA and cannot flip a plan), where the node has a real
estimate (``unestimated`` nodes — CBO-blind, not CBO-wrong — never produce a
correction) and the direction is actionable: "under" anywhere (the expensive
failure mode: undersized hash tables, missed partitioned joins), or "over"
on a join BUILD side (a partitioned build that measured tiny should flip
back to broadcast).

Corrections emitted (all host facts, applied by sql/exchanges at plan time):
  rows:           {node_path: observed EWMA rows} — cardinality facts the
                  estimator treats as CONFIDENT, so the existing
                  DetermineJoinDistributionType thresholds re-decide
                  broadcast vs partitioned from truth (correction (b) falls
                  out of correction (a));
  capacity:       {Aggregate path: pow2 slot count} seeded from observed
                  group counts (generalizes r11's exact-spilled-rows seed);
  grace_parts:    {Aggregate path: pow2 partitions} when the node spilled;
  dispatch_batch: K tuned up from observed split counts.

Win-vs-price: predicted win = sum over material nodes of their average
recorded wall x (1 - 1/min(ratio, 10)), amortized over ``horizon`` expected
re-executions; the price is the statement's own observed cold compile
seconds (fallback: per-op mean durations from the compile log).  Unknown
price = assume expensive, hold.  ``price_scale`` is the test hook (0 forces
re-plan, huge forces hold).

Probation (the r14 template pattern): a fresh correction freezes its token +
corrections (a drifting EWMA must never re-key a new plan every run) and
enters "probation"; the first WARM corrected run (compiles == 0) confirms it
when its wall is no worse than the uncorrected EWMA, else demotes.  A
demoted or failed correction enters a negative-cache cooldown counted in
uncorrected executions before the statement is reconsidered.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional

__all__ = ["AdaptiveAdvisor", "ADAPTIVE_THRESHOLD"]

# material-misestimate bar for a correction (2x merely counts as a
# misestimate in history; 4x is where a re-plan pays for itself)
ADAPTIVE_THRESHOLD = 4.0

# expected warm re-executions a correction's win amortizes its recompile over
DEFAULT_HORIZON = 8.0

# uncorrected executions a demoted statement sits out before reconsideration
DEFAULT_COOLDOWN = 8

# a warm corrected run regresses when its wall exceeds the uncorrected EWMA
# by this factor (plus a small absolute floor so millisecond statements do
# not demote on scheduler noise)
REGRESS_FACTOR = 1.5
REGRESS_FLOOR_S = 0.005

WALL_EWMA_ALPHA = 0.25  # same damping the history store uses for rows

MAX_CAPACITY = 1 << 24  # mirror of the executor's capacity-estimate cap
MAX_DISPATCH_BATCH = 16

_RATIO_CAP = 10.0  # win model: beyond 10x the extra ratio buys nothing


def _env_float(name: str, default: float) -> float:
    try:
        v = os.environ.get(name, "")
        return float(v) if v != "" else default
    except ValueError:
        return default


def _pow2_at_least(n: float) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def correction_token(corrections: dict) -> str:
    """Stable short token for one frozen corrections dict — the plan-cache /
    result-cache key component that keys corrected plans separately."""
    return hashlib.blake2b(repr(sorted(
        (k, sorted(v.items()) if isinstance(v, dict) else v)
        for k, v in corrections.items())).encode(),
        digest_size=6).hexdigest()


class AdaptiveAdvisor:
    """Per-statement adaptive state machine over the plan-history store and
    the compile log.  Thread-safe; bounded LRU over statement keys."""

    MAX_STATEMENTS = 256

    def __init__(self, history=None, compile_log=None,
                 threshold: Optional[float] = None,
                 horizon: Optional[float] = None,
                 cooldown: Optional[int] = None,
                 price_scale: float = 1.0):
        self.history = history
        self.compile_log = compile_log
        self.threshold = threshold if threshold is not None else _env_float(
            "TRINO_TPU_ADAPTIVE_THRESHOLD", ADAPTIVE_THRESHOLD)
        self.horizon = horizon if horizon is not None else _env_float(
            "TRINO_TPU_ADAPTIVE_HORIZON", DEFAULT_HORIZON)
        self.cooldown = cooldown if cooldown is not None else int(_env_float(
            "TRINO_TPU_ADAPTIVE_COOLDOWN", DEFAULT_COOLDOWN))
        # test/ops hook: multiplies the compile price in the comparison
        # (0.0 = re-plan whenever material, large = always hold)
        self.price_scale = price_scale
        self._lock = threading.Lock()
        self._states: OrderedDict = OrderedDict()  # stmt key -> state dict
        self.replans_total = 0
        self.holds_total = 0
        self.demotions_total = 0
        self.confirms_total = 0

    # ------------------------------------------------------------- state
    def _state(self, key) -> dict:
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = {
                "state": "watching", "base_fp": None, "sql": None,
                "base_wall_ewma": None, "base_execs": 0,
                "compile_s_obs": 0.0, "corrected_execs": 0,
                "corrections": None, "token": None, "decision": None,
                "cooldown": 0, "last_verdict": None}
            while len(self._states) > self.MAX_STATEMENTS:
                self._states.popitem(last=False)
        else:
            self._states.move_to_end(key)
        return st

    # ------------------------------------------------------------ consult
    def consult(self, key, peek: bool = False) -> Optional[dict]:
        """The admission-time question: should this statement's next
        execution run a corrected plan?  Returns None (no opinion — no
        history, nothing material, or cooling down without a counted hold
        when ``peek``), or a decision dict:

          {"verdict": "replan"|"hold", "token", "corrections",
           "predicted_win_s", "compile_price_s", "horizon",
           "fingerprint", "reasons": [...]}

        "replan" decisions are FROZEN: once emitted, the same token and
        corrections return on every consult until the correction confirms,
        demotes or fails — recomputing from a drifting EWMA would re-key (and
        recompile) a fresh plan every run.  ``peek`` is the read-only form
        (plain EXPLAIN): no state transition, no hold accounting."""
        hist = self.history
        if hist is None or not getattr(hist, "enabled", False):
            return None
        with self._lock:
            st = self._states.get(key)
            if st is None:
                return None
            self._states.move_to_end(key)
            if st["state"] in ("probation", "confirmed"):
                return dict(st["decision"])
            if st["state"] == "demoted":
                if peek:
                    return None
                dec = self._decision(st, "hold", reasons=[
                    f"demoted correction cooling down "
                    f"({st['cooldown']} uncorrected executions left)"])
                self.holds_total += 1
                st["last_verdict"] = "hold"
                return dec
            base_fp = st["base_fp"]
        if base_fp is None:
            return None
        ent = hist.get(base_fp)
        if ent is None or not ent.get("nodes"):
            return None
        material = self._material(base_fp)
        if not material:
            return None
        corrections, reasons = self._corrections(ent, material)
        if not corrections:
            return None
        win = self._predicted_win_s(material)
        with self._lock:
            st = self._state(key)
            if st["state"] != "watching":  # raced another thread
                return dict(st["decision"]) \
                    if st["state"] in ("probation", "confirmed") else None
            price = self._compile_price(st, ent)
            if peek:
                return self._decision(
                    st, "hold", corrections=corrections, win=win,
                    price=price, fingerprint=ent.get("fingerprint"),
                    reasons=reasons + ["peek: no state transition"])
            if price is None:
                dec = self._decision(
                    st, "hold", corrections=corrections, win=win,
                    price=None, fingerprint=ent.get("fingerprint"),
                    reasons=reasons + [
                        "compile price unknown — assume expensive"])
                self.holds_total += 1
                st["last_verdict"] = "hold"
                return dec
            scaled = price * self.price_scale
            if win * self.horizon <= scaled:
                dec = self._decision(
                    st, "hold", corrections=corrections, win=win,
                    price=price, fingerprint=ent.get("fingerprint"),
                    reasons=reasons + [
                        f"predicted win {win:.4f}s x {self.horizon:g} <= "
                        f"compile price {scaled:.4f}s"])
                self.holds_total += 1
                st["last_verdict"] = "hold"
                return dec
            # take the re-plan: freeze the corrections + token, enter
            # probation (r14 template pattern — unconfirmed until the first
            # warm corrected run measures no worse than the base EWMA)
            st["state"] = "probation"
            st["corrections"] = corrections
            st["token"] = correction_token(corrections)
            st["corrected_execs"] = 0
            dec = self._decision(
                st, "replan", corrections=corrections, win=win, price=price,
                fingerprint=ent.get("fingerprint"),
                reasons=reasons + [
                    f"predicted win {win:.4f}s x {self.horizon:g} > "
                    f"compile price {price * self.price_scale:.4f}s"])
            st["decision"] = dec
            self.replans_total += 1
            st["last_verdict"] = "replan"
            return dict(dec)

    def _decision(self, st, verdict, corrections=None, win=None, price=None,
                  fingerprint=None, reasons=None) -> dict:
        return {"verdict": verdict,
                "token": st.get("token") if verdict == "replan" else None,
                "corrections": corrections or st.get("corrections"),
                "predicted_win_s": None if win is None else round(win, 6),
                "compile_price_s": None if price is None else round(price, 6),
                "horizon": self.horizon,
                "fingerprint": fingerprint,
                "reasons": list(reasons or [])}

    # ------------------------------------------------------- the cost model
    def _material(self, fingerprint: str) -> dict:
        """{path: node record} for nodes whose misestimate is both LARGE
        (``history.misestimated`` — EWMA ratio >= threshold on a REAL
        estimate; CBO-blind nodes never qualify) and ACTIONABLE: direction
        "under" anywhere, or "over" on a join build side."""
        qualifying = self.history.misestimated(fingerprint, self.threshold)
        return {path: r for path, r in qualifying.items()
                if r.get("direction") == "under"
                or (r.get("direction") == "over" and r.get("build"))}

    def _corrections(self, ent: dict, material: dict) -> tuple:
        corrections: dict = {"rows": {}}
        reasons: list = []
        for path, r in sorted(material.items()):
            rows = max(float(r.get("actual_rows_ewma", 0.0)), 1.0)
            corrections["rows"][path] = rows
            reasons.append(
                f"{path}: est {r['est_rows']:.0f} -> observed {rows:.0f} "
                f"({r.get('misestimate_ratio')}x {r.get('direction')})")
            if r.get("op") == "Aggregate" and r.get("direction") == "under":
                # capacity seeded at 2x observed groups (the executor's own
                # estimate-to-capacity rule), pow2, capped like the executor
                cap = min(_pow2_at_least(2.0 * rows), MAX_CAPACITY)
                corrections.setdefault("capacity", {})[path] = cap
                reasons.append(f"{path}: capacity {cap}")
                if r.get("spill_tiers") or r.get("spilled_bytes"):
                    parts = max(4, _pow2_at_least(rows / float(1 << 20)))
                    corrections.setdefault("grace_parts", {})[path] = parts
                    reasons.append(f"{path}: grace_parts {parts}")
        # dispatch_batch K from observed split counts: rides along only when
        # a re-plan is already triggered — more splits per dispatch means
        # fewer device round-trips on deep scans
        splits = max((int(r.get("splits") or 0)
                      for r in ent.get("nodes", {}).values()), default=0)
        if splits:
            from ..exec.local_executor import _dispatch_batch_default

            cur = _dispatch_batch_default()
            if splits > 2 * cur:
                k = min(MAX_DISPATCH_BATCH,
                        max(cur, _pow2_at_least(splits / 4.0)))
                if k > cur:
                    corrections["dispatch_batch"] = k
                    reasons.append(f"dispatch_batch {cur} -> {k} "
                                   f"({splits} splits)")
        if not corrections["rows"]:
            return {}, []
        return corrections, reasons

    def _predicted_win_s(self, material: dict) -> float:
        win = 0.0
        for r in material.values():
            execs = max(int(r.get("executions", 1)), 1)
            avg_wall = float(r.get("wall_s_total", 0.0)) / execs
            ratio = min(float(r.get("misestimate_ratio", 1.0)), _RATIO_CAP)
            win += avg_wall * (1.0 - 1.0 / max(ratio, 1.0))
        return win

    def _compile_price(self, st: dict, ent: dict) -> Optional[float]:
        """Re-plan price in seconds: the statement's own observed cold
        compile cost when we saw one, else per-op mean compile durations
        from the census for the operators this plan holds.  None = unknown
        (assume expensive — the caller holds)."""
        if st.get("compile_s_obs", 0.0) > 0.0:
            return float(st["compile_s_obs"])
        log = self.compile_log
        if log is None:
            return None
        ops = {r.get("op") or p.partition("#")[0]
               for p, r in ent.get("nodes", {}).items()}
        sums: dict = {}
        counts: dict = {}
        try:
            recs = log.snapshot()
        except Exception:
            return None
        for rec in recs:
            op = str(rec.get("label", "")).partition("#")[0]
            if op in ops:
                sums[op] = sums.get(op, 0.0) + float(
                    rec.get("duration_s") or 0.0)
                counts[op] = counts.get(op, 0) + 1
        if not counts:
            return None
        return sum(sums[op] / counts[op] for op in counts)

    # ------------------------------------------------------------ feedback
    def observe(self, key, fingerprint: str, corrected: bool,
                wall_s: float, compiles: int = 0,
                compile_s: float = 0.0, sql: Optional[str] = None) -> None:
        """One clean completion's feedback (engine._record_plan_history).
        Uncorrected executions anchor the statement's history address (the
        base fingerprint), its wall EWMA (the regression yardstick) and its
        observed cold compile price; corrected executions drive the
        probation verdict — the first WARM corrected run (compiles == 0)
        confirms or demotes against the base EWMA."""
        with self._lock:
            st = self._state(key)
            if sql is not None and st["sql"] is None:
                st["sql"] = sql
            if not corrected:
                st["base_fp"] = fingerprint
                st["base_execs"] += 1
                w = float(wall_s)
                st["base_wall_ewma"] = w if st["base_wall_ewma"] is None \
                    else (WALL_EWMA_ALPHA * w
                          + (1.0 - WALL_EWMA_ALPHA) * st["base_wall_ewma"])
                if compiles > 0 and compile_s > st["compile_s_obs"]:
                    st["compile_s_obs"] = float(compile_s)
                if st["state"] == "demoted":
                    st["cooldown"] -= 1
                    if st["cooldown"] <= 0:
                        st["state"] = "watching"
                        st["corrections"] = None
                        st["token"] = None
                return
            st["corrected_execs"] += 1
            if st["state"] not in ("probation", "confirmed"):
                return
            if compiles > 0:
                return  # cold corrected run: its wall is compile-dominated
            base = st["base_wall_ewma"]
            if base is not None and float(wall_s) > (
                    base * REGRESS_FACTOR + REGRESS_FLOOR_S):
                self._demote(st)
            elif st["state"] == "probation":
                st["state"] = "confirmed"
                self.confirms_total += 1

    def failed(self, key) -> None:
        """A corrected execution RAISED: demote immediately (probation or
        confirmed — a correction that breaks a working statement is worse
        than any misestimate)."""
        with self._lock:
            st = self._states.get(key)
            if st is not None and st["state"] in ("probation", "confirmed"):
                self._demote(st)

    def _demote(self, st: dict) -> None:
        st["state"] = "demoted"
        st["cooldown"] = self.cooldown
        st["token"] = None
        self.demotions_total += 1

    # ------------------------------------------------------------ surfaces
    def decision_trace(self) -> list:
        """Per-statement decision state, LRU-oldest first — what
        ``scripts/query_counters.py --adaptive`` prints and the flight
        viewer summarizes."""
        with self._lock:
            out = []
            for key, st in self._states.items():
                dec = st.get("decision") or {}
                out.append({
                    "sql": st.get("sql"),
                    "state": st["state"],
                    "base_executions": st["base_execs"],
                    "corrected_executions": st["corrected_execs"],
                    "base_wall_ewma_s": st["base_wall_ewma"],
                    "compile_price_s": st["compile_s_obs"] or None,
                    "token": st.get("token"),
                    "cooldown": st.get("cooldown"),
                    "last_verdict": st.get("last_verdict"),
                    "corrections": st.get("corrections"),
                    "predicted_win_s": dec.get("predicted_win_s"),
                    "reasons": dec.get("reasons"),
                })
            return out

    def info(self) -> dict:
        with self._lock:
            return {"statements": len(self._states),
                    "replans_total": self.replans_total,
                    "holds_total": self.holds_total,
                    "demotions_total": self.demotions_total,
                    "confirms_total": self.confirms_total,
                    "threshold": self.threshold,
                    "horizon": self.horizon}


def describe_decision(dec: Optional[dict]) -> Optional[str]:
    """One-line human rendering of a decision dict (EXPLAIN ANALYZE's
    "Adaptive:" line, scripts/flight.py)."""
    if not dec:
        return None
    win = dec.get("predicted_win_s")
    price = dec.get("compile_price_s")
    arith = ""
    if win is not None:
        arith = f" predicted win {win:.4f}s x {dec.get('horizon', 0):g}" + (
            f" vs compile price {price:.4f}s" if price is not None
            else " vs unknown compile price")
    corr = dec.get("corrections") or {}
    parts = []
    for path, rows in sorted((corr.get("rows") or {}).items()):
        parts.append(f"rows {path} -> {rows:.0f}")
    for path, cap in sorted((corr.get("capacity") or {}).items()):
        parts.append(f"capacity {path} -> {cap}")
    for path, gp in sorted((corr.get("grace_parts") or {}).items()):
        parts.append(f"grace_parts {path} -> {gp}")
    if corr.get("dispatch_batch"):
        parts.append(f"dispatch_batch -> {corr['dispatch_batch']}")
    detail = ("; " + ", ".join(parts)) if parts else ""
    return f"{dec.get('verdict', '?')}{arith}{detail}"
