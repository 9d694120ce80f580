"""The window's arithmetic: a fixed number of whole ticks sized from
``--seconds``, and a mean over every tick of the window (a stall moves it)."""

from __future__ import annotations

from bblib import readers
from bblib.loop import Run, trace_ticks, window_ticks


def _run(ticks):
    return Run(window_kind="all",
               ticks=[{"tick": t, "gc": 1.0, "store": t / 2} for t in ticks])


def test_tick_mean_is_the_window_sum_over_its_ticks():
    run = _run([100.0] * 9 + [1100.0])
    # one stalled tick in ten moves the mean by a tenth of the stall; a
    # median would not move at all
    assert readers.tick_mean(run, "tick") == (9 * 101.0 + 1101.0) / 10
    assert readers.tick_mean(run, "store") == (9 * 50.0 + 550.0) / 10
    assert readers.tick_mean(_run([]), "tick") is None


def test_window_is_a_fixed_count_of_ticks():
    traffic = {"warm_ticks": 12, "nominal_tick_s": 2.0}
    assert window_ticks(traffic, 51) == 26
    assert window_ticks(traffic, 0.5) == 1
    assert trace_ticks(traffic, 51) == 12 + 26
    steady = {"warm_until": "steady", "warm_ticks_max": 8, "nominal_tick_s": 1.0}
    assert trace_ticks(steady, 10) == 8 + 10


def test_steady_only():
    run = _run([10.0])
    assert readers.steady_only(run, 5.0) is None
    run.window_kind = "steady"
    assert readers.steady_only(run, 5.0) == 5.0
