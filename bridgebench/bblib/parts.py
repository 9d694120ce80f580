"""Readers of the phases' parts: the program's spans and counters inside a
phase (the pending scan and inventory inside "store", the repair inside
"solve", the mirror's submits, status reads and sweep), which a tick's
phase dict carries beside its phases. A program whose ticks carry no such
part reads as None, not 0: the metric is left out of the line."""

from __future__ import annotations

from bblib.readers import steady_only, tick_mean


def part_mean(run, key: str) -> float | None:
    """The window's mean of one part, or None where no tick carries it."""
    if not any(key in t for t in run.ticks):
        return None
    return tick_mean(run, key)


def steady_part_mean(run, key: str) -> float | None:
    """:func:`part_mean` over a steady window."""
    return steady_only(run, part_mean(run, key))
