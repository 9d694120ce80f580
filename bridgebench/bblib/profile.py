"""The traced run: host ranges around the bridge's layers, the device's
timeline from ``torch.profiler``, and what is read from them.

Device busy time is the union of the intervals in which a kernel, copy or
memset ran (one stream or several); the idle share is what is left of the
traced window. Each idle interval is attributed to the innermost host range
open at that time, so the breakdown says what the host was doing while
the card waited. The ranges are the benchmark's own, set around the calls
into each layer of the program.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RANGE_CATS = {"user_annotation"}


def annotate(obj, attr: str, label: str) -> None:
    """Wrap ``obj.attr`` (an instance attribute from now on) in a profiler
    range named ``label``."""
    fn = getattr(obj, attr)

    def wrapped(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)

    setattr(obj, attr, wrapped)


def annotate_harness(h) -> None:
    sched = h.scheduler
    for obj, attr, label in (
        (h, "_arrive", "sim.arrive"),
        (sched, "tick", "scheduler.tick"),
        (sched, "_pending_set", "scheduler.store.pending"),
        (sched, "cluster_state", "scheduler.store.inventory"),
        (sched, "_solve_local", "scheduler.encode_solve"),
        (sched, "_solve", "scheduler.solve"),
        (sched, "_bind_batch", "scheduler.bind"),
        (h, "_mirror", "sim.mirror"),
        (h.cluster, "step", "sim.cluster_step"),
    ):
        annotate(obj, attr, label)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(prof, window: tuple[float, float] | None = None) -> dict:
    """Busy seconds, window seconds, device time by kernel name, idle time
    by host range, from a finished profiler. ``window`` (µs on the trace's
    clock) defaults to the span of the ``bench.traced`` range."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    dev: list[tuple[float, float]] = []
    by_name: dict[str, float] = {}
    ranges: list[tuple[float, float, str]] = []
    win = window
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            name = str(e.get("name", ""))[:96]
            by_name[name] = by_name.get(name, 0.0) + dur
        elif cat in RANGE_CATS:
            if e.get("name") == "bench.traced" and win is None:
                win = (ts, ts + dur)
            else:
                ranges.append((ts, ts + dur, str(e.get("name"))))
    if win is None:
        raise RuntimeError("the trace holds no bench.traced range")
    w0, w1 = win
    busy = _union([(max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    idle = []
    cur = w0
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        idle.append((cur, w1))
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(((k, v / 1e6) for k, v in by_name.items()),
                             key=lambda kv: -kv[1]),
        "idle_by_range": _attribute(idle, ranges),
    }


def _attribute(idle: list[tuple[float, float]], ranges: list[tuple[float, float, str]]):
    """Idle seconds by the innermost host range open at the time (ranges
    nest like the calls they wrap; time inside no range is the harness's
    own bookkeeping)."""
    marks = sorted([(a, 1, i) for i, (a, _b, _n) in enumerate(ranges)]
                   + [(b, 0, i) for i, (_a, b, _n) in enumerate(ranges)])
    out: dict[str, float] = {}
    open_: list[int] = []
    k = 0

    def advance(t: float) -> None:
        nonlocal k
        while k < len(marks) and marks[k][0] <= t:
            _t, opening, i = marks[k]
            if opening:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            k += 1

    for a, b in idle:
        advance(a)
        cur = a
        while cur < b:
            nxt = min(marks[k][0], b) if k < len(marks) else b
            name = ranges[open_[-1]][2] if open_ else "harness"
            out[name] = out.get(name, 0.0) + (nxt - cur) / 1e6
            cur = nxt
            advance(cur)
    return sorted(out.items(), key=lambda kv: -kv[1])
