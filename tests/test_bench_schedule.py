"""bench.py's budget scheduler: the final JSON line must always land inside
the caller's wall-clock timeout (a run that measures every row and is then
cut before the final print loses all of them).  Pure host-side logic — no
accelerator, no subprocesses."""

import subprocess

import bench


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _runner(durations, results=None, hang=(), hang_once=()):
    """run_one stub advancing the fake clock by each item's duration.

    ``hang``: keys that time out on EVERY attempt; ``hang_once``: keys that
    time out on the first attempt only (a transient fault)."""
    results = results or {}
    hung = set()

    def run_one(key, timeout_s, clock=None):
        if key in hang or (key in hang_once and key not in hung):
            hung.add(key)
            clock.t += timeout_s
            raise subprocess.TimeoutExpired(cmd=key, timeout=timeout_s)
        clock.t += durations[key]
        return results.get(key, {key + "_ms": durations[key]})

    return run_one


def test_all_items_run_inside_budget():
    clock = FakeClock()
    durations = {"a": 10, "b": 20, "c": 30}
    run_one = _runner(durations)
    extras = bench._run_schedule(
        ["a", "b", "c"], lambda k, t: run_one(k, t, clock=clock),
        budget_s=1000, est={"a": 20, "b": 40, "c": 60}, timeouts={},
        now=clock,
    )
    assert set(extras) == {"a_ms", "b_ms", "c_ms"}
    assert "skipped" not in extras


def test_too_big_item_skipped_immediately_smaller_still_runs():
    """An item whose ESTIMATE exceeds the remaining budget is skipped without
    burning any clock, and a later, smaller item still runs."""
    clock = FakeClock()
    durations = {"big": 500, "small": 10}
    run_one = _runner(durations)
    extras = bench._run_schedule(
        ["big", "small"], lambda k, t: run_one(k, t, clock=clock),
        budget_s=100, est={"big": 400, "small": 20}, timeouts={},
        now=clock,
    )
    assert "big_ms" not in extras
    assert extras["small_ms"] == 10
    assert extras["skipped"] == ["big"]
    # the skip consumed no budget
    assert clock.t == 10


def test_item_timeout_capped_at_remaining_budget():
    """A hanging item is killed at the remaining budget, not its own (much
    larger) ceiling, so the final line still prints in time."""
    clock = FakeClock()
    durations = {"first": 50, "hangs": 0, "after": 10}
    run_one = _runner(durations, hang={"hangs"})
    extras = bench._run_schedule(
        ["first", "hangs", "after"], lambda k, t: run_one(k, t, clock=clock),
        budget_s=200, est={}, timeouts={"hangs": 3600}, now=clock,
    )
    assert extras["first_ms"] == 50
    assert extras["hangs_error"] == "timeout"
    # killed at remaining budget (200 - 50 - reserve), far below 3600
    assert clock.t <= 200
    assert extras["skipped"] == ["after"]


def test_estimates_cover_every_item():
    """Every registered item needs a warm estimate, or the scheduler falls
    back to the MIN_SLICE floor and may start something that cannot finish."""
    assert set(bench.ITEMS) == set(bench.ITEM_EST_S)


def test_hang_capped_at_multiple_of_estimate_later_items_survive():
    """A hanging item must not starve the rest of the ladder: its slice is
    capped at max(3x estimate, 300), leaving budget for later items."""
    clock = FakeClock()
    durations = {"hangs": 0, "after": 10}
    run_one = _runner(durations, hang={"hangs"})
    extras = bench._run_schedule(
        ["hangs", "after"], lambda k, t: run_one(k, t, clock=clock),
        budget_s=1000, est={"hangs": 50, "after": 20}, timeouts={"hangs": 3600},
        now=clock,
    )
    assert extras["hangs_error"] == "timeout"
    # killed at the 300 s floor (not at 985), run again once ("after" having
    # survived), and killed at the floor again
    assert clock.t <= 300 + 10 + 300
    assert extras["after_ms"] == 10
    assert "skipped" not in extras


def test_transient_failure_retried_after_full_pass():
    """An item that times out once (a transient fault, e.g. a hung device
    init, while the very next subprocess runs normally) is retried after the
    full pass and its result replaces the error; the retry must not run
    before later first-attempt items."""
    clock = FakeClock()
    order = []

    def tracking(run_one):
        def wrapped(key, t):
            order.append(key)
            return run_one(key, t, clock=clock)
        return wrapped

    durations = {"w8": 30, "w16": 10}
    run_one = _runner(durations, hang_once={"w8"})
    extras = bench._run_schedule(
        ["w8", "w16"], tracking(run_one),
        budget_s=2000, est={"w8": 30, "w16": 55}, timeouts={}, now=clock,
    )
    assert order == ["w8", "w16", "w8"]
    assert extras["w8_ms"] == 30
    assert "w8_error" not in extras
    assert extras["w16_ms"] == 10
    assert "skipped" not in extras


def test_retry_skipped_when_budget_exhausted():
    """No retry slice may eat into the final-line reserve."""
    clock = FakeClock()
    durations = {"w8": 30, "w16": 230}
    run_one = _runner(durations, hang_once={"w8"})
    extras = bench._run_schedule(
        ["w8", "w16"], lambda k, t: run_one(k, t, clock=clock),
        budget_s=560, est={"w8": 30, "w16": 230}, timeouts={}, now=clock,
    )
    # first attempt killed at the 300 s floor, w16 runs (clock 530); the
    # retry would need MIN_SLICE inside the reserve-guarded remainder (15 s)
    # and is therefore not started — the final line still prints in budget
    assert extras["w8_error"] == "timeout"
    assert extras["w16_ms"] == 230
    assert clock.t <= 560
