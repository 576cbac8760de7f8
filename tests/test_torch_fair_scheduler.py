"""The port's fair scheduler (``trino_tpu_torch/execution/fair_scheduler.py``,
a copy of the reference's pure-Python module) against the reference's.

Restates the 8 fast tests of tests/test_fair_scheduler.py; each runs on both
packages' ``FairScheduler`` (parametrized ``mod``) and holds the same
grants, preemptions and bounds.  The worker-level test (a point query
overtaking a long scan on a one-slot worker) is slow in the reference and
runs on the card in ``chip_smoke.py`` phase 20d.
"""

import threading
import time

import pytest

from trino_tpu.execution import fair_scheduler as jax_fair
from trino_tpu_torch.execution import fair_scheduler as port_fair


@pytest.fixture(params=["port", "jax"])
def mod(request):
    return port_fair if request.param == "port" else jax_fair


def test_modules_agree():
    assert port_fair.LEVEL_THRESHOLDS == jax_fair.LEVEL_THRESHOLDS
    assert port_fair.MAX_TRACKED_QUERIES == jax_fair.MAX_TRACKED_QUERIES


def test_scheduler_grants_low_level_first(mod):
    s = mod.FairScheduler(slots=1, quantum=10.0)
    s.sched_time["long"] = 30.0  # level 3 (>= 10s served)
    order = []

    s.acquire("long", "t-long")

    def waiter(qk, tok):
        s.acquire(qk, tok)
        order.append(tok)
        s.release(tok)

    a = threading.Thread(target=waiter, args=("long", "t-long2"))
    b = threading.Thread(target=waiter, args=("fresh", "t-fresh"))
    a.start()
    time.sleep(0.1)
    b.start()
    time.sleep(0.1)
    s.release("t-long")  # both waiting: the FRESH query must win despite FIFO
    a.join(timeout=5)
    b.join(timeout=5)
    assert order == ["t-fresh", "t-long2"], order


def test_tick_preempts_for_less_served_query(mod):
    s = mod.FairScheduler(slots=1, quantum=10.0)
    s.sched_time["long"] = 30.0
    s.acquire("long", "t1")
    state = {}

    def short():
        s.acquire("fresh", "t2")
        state["got"] = time.monotonic()
        s.release("t2")

    th = threading.Thread(target=short)
    th.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    s.tick("t1")  # less-served waiter -> must yield and re-acquire
    th.join(timeout=5)
    assert "got" in state and state["got"] >= t0
    assert s.preemptions == 1
    s.release("t1")


def test_tick_round_robins_within_level_after_quantum(mod):
    s = mod.FairScheduler(slots=1, quantum=0.05)
    s.acquire("a", "ta")
    got = []

    def other():
        s.acquire("b", "tb")
        got.append("b")
        s.release("tb")

    th = threading.Thread(target=other)
    th.start()
    time.sleep(0.1)  # same level (both ~0 served) but quantum expired
    s.tick("ta")
    th.join(timeout=5)
    assert got == ["b"]
    s.release("ta")


def test_no_yield_without_waiters(mod):
    s = mod.FairScheduler(slots=2, quantum=0.0)
    s.acquire("a", "t1")
    s.tick("t1")  # nobody waiting: keep the slot even with expired quantum
    assert s.preemptions == 0
    assert "t1" not in s._waiters
    s.release("t1")


# ------------------------------------------------------------- worker level


def test_duplicate_task_ids_hold_separate_slots(mod):
    """Speculative duplicates / wedged-task re-dispatch of the same task id
    must count as two slot holders (post-review hardening: token-keyed
    accounting must not alias)."""
    s = mod.FairScheduler(slots=2, quantum=10.0)
    t1 = s.new_token("t7")
    t2 = s.new_token("t7")
    assert t1 != t2
    s.acquire("q", t1)
    s.acquire("q", t2)
    assert len(s._running) == 2
    s.release(t1)
    assert len(s._running) == 1
    s.release(t2)


def test_aging_prevents_starvation(mod):
    """A long query's waiter gains priority as it starves: with fresh
    queries continuously arriving, the aged waiter eventually wins."""
    s = mod.FairScheduler(slots=1, quantum=0.01)
    s.sched_time["etl"] = 100.0  # level 4
    s.acquire("etl", "t-etl-run")
    got = []

    def etl_reacquire():
        s.acquire("etl", "t-etl2")
        got.append("etl")
        s.release("t-etl2")

    th = threading.Thread(target=etl_reacquire)
    th.start()
    time.sleep(0.3)  # waiter ages: 0.3s / (10 * 0.01s) = 3 levels of boost
    # fresh queries keep arriving but the aged ETL waiter must win soon
    deadline = time.time() + 10
    s.release("t-etl-run")
    while not got and time.time() < deadline:
        tok = s.new_token("pt")
        s.acquire("fresh%d" % (time.time_ns() % 97), tok)
        time.sleep(0.02)
        s.release(tok)
    th.join(timeout=10)
    assert got == ["etl"], "aged waiter starved behind fresh queries"


def test_acquire_wakes_on_notify_without_polling(mod):
    """A blocked acquire must wake by condition-variable NOTIFICATION, not by
    a poll interval elapsing: the pre-fix code re-checked every 50ms, adding
    up to a poll interval of latency per grant.  Waits may carry only the
    coarse aging-boundary backstop (>= 10 quanta — liveness against
    aging flipping the grant order with no notify), never a sub-second poll,
    and the grant arrives as soon as release() notifies."""
    s = mod.FairScheduler(slots=1, quantum=10.0)
    waits = []
    orig_wait = s._cv.wait

    def recording_wait(timeout=None):
        waits.append(timeout)
        return orig_wait(timeout)

    s._cv.wait = recording_wait
    tok1, tok2 = s.new_token("a"), s.new_token("b")
    s.acquire("qa", tok1)
    granted = []

    def blocked():
        s.acquire("qb", tok2)
        granted.append(time.monotonic())
        s.release(tok2)

    th = threading.Thread(target=blocked)
    th.start()
    time.sleep(0.1)  # the waiter is parked inside a backstop-only cv.wait
    assert not granted
    released_at = time.monotonic()
    s.release(tok1)
    th.join(timeout=5)
    assert granted, "blocked acquire never woke after release"
    assert waits and all(t is None or t >= 10.0 * s.quantum for t in waits), (
        f"acquire used short (polling) wait timeouts: {waits}")
    # notification latency, not a 50ms poll boundary (generous bound for a
    # loaded 1-core box; the wait-timeout assertion above is the real proof)
    assert granted[0] - released_at < 1.0


def test_sched_time_is_bounded(mod):
    MAX_TRACKED_QUERIES = mod.MAX_TRACKED_QUERIES
    s = mod.FairScheduler(slots=1, quantum=10.0)
    for i in range(MAX_TRACKED_QUERIES + 50):
        tok = s.new_token("t")
        s.acquire(f"q{i}", tok)
        s.release(tok)
    assert len(s.sched_time) <= MAX_TRACKED_QUERIES
    assert len(s.info()["scheduled_time"]) <= 16
