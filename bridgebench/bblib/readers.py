"""Arithmetic the metric readers share. A run's window is whole ticks;
every mean is the window's sum over its tick count."""

from __future__ import annotations


def tick_mean(run, key: str) -> float | None:
    """The window's mean of one phase (``tick`` adds the tick's
    between-tick collection)."""
    if not run.ticks:
        return None
    if key == "tick":
        return sum(t["tick"] + t["gc"] for t in run.ticks) / len(run.ticks)
    return sum(t.get(key, 0.0) for t in run.ticks) / len(run.ticks)


def steady_only(run, value):
    """``value`` where the run's window is a steady one, else None."""
    return value if run.window_kind == "steady" else None

