"""One run of one cell: set-up, warm ticks, the measured window, the check.

The window drives ``SimHarness.run_tick`` back to back, as the harness's
own run loop does: the collector off during a tick and the heap frozen, a
young collection between ticks, timed and added to the tick it follows.
The window is a fixed number of whole ticks, ``--seconds`` over the
traffic's nominal tick wall, so two runs of one seed time the same ticks
whatever their speed; the trace covers the warm ticks and the window.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field

from bblib import gen, judge, profile, roofline, scenario

#: top-level module names nothing the benchmark runs may load
FORBIDDEN = ("jax", "jaxlib", "flax", "slurm_bridge_tpu", "bench", "benchmarks")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def window_ticks(traffic: dict, seconds: float) -> int:
    """The window's ticks: ``seconds`` at the traffic's nominal wall of a
    tick on the card (the harness's own work included), at least one."""
    return max(1, math.ceil(seconds / float(traffic["nominal_tick_s"])))


def trace_ticks(traffic: dict, seconds: float) -> int:
    warm = int(traffic.get("warm_ticks", traffic.get("warm_ticks_max", 0)))
    return warm + window_ticks(traffic, seconds)


@dataclass
class Run:
    """What the metric readers read."""

    window_kind: str
    setup_s: float = 0.0
    ticks: list[dict] = field(default_factory=list)
    profile: dict | None = None
    #: (cells, live rows, rows, nodes) of each scoring-kernel call
    launches: list[tuple[int, int, int, int]] = field(default_factory=list)


class LaunchCounter:
    """Counts each scoring call's needed cells on the card, without a host
    sync (the traced run only)."""

    def __init__(self):
        import slurm_bridge_tpu_torch.solver.auction as auction

        self.mod = auction
        self.orig = auction.bid_argmax
        self.calls: list = []

        def counted(free, node_part, node_feat, price, dem, job_part, req_feat, incumbent,
                    *a, live=None, **k):
            cells, live_rows = roofline.needed_cells(node_part, job_part, live)
            self.calls.append((cells, live_rows, int(job_part.shape[0]), int(free.shape[0])))
            return self.orig(free, node_part, node_feat, price, dem, job_part, req_feat,
                             incumbent, *a, live=live, **k)

        auction.bid_argmax = counted

    def close(self) -> list[tuple[int, int, int, int]]:
        self.mod.bid_argmax = self.orig
        return [(int(round(c.item())), int(lv.item()), p, n) for c, lv, p, n in self.calls]


def run_cell(cell, *, seed: int, seconds: float, traced: bool, device: str, t0: float,
             dtype: str | None = None) -> tuple[dict, dict, judge.Checks, Run]:
    """Returns (result without ``metrics``' values filled, the earlier
    line, the checks, the readers' input)."""
    import torch

    config, traffic = cell.config, cell.traffic
    split: dict[str, float] = {}
    mark = t0

    def lap(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        split[name] = now - mark
        mark = now

    from slurm_bridge_tpu_torch.sim.harness import SimHarness

    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    lap("import_and_cuda_init_s")
    if device == "cuda":
        from slurm_bridge_tpu_torch.ops import bid_argmax

        bid_argmax.build()
    lap("kernel_load_s")
    ticks_total = trace_ticks(traffic, seconds)
    cl, trace = gen.make(config, traffic, ticks_total, seed)
    h = SimHarness(scenario.build(config, ticks_total, seed, dtype=dtype), device=device)
    h.trace = scenario.arrivals(trace)
    try:
        rec = judge.Recorder(h)
        if traced:
            profile.annotate_harness(h)
        lap("harness_init_s")

        prof = traced_range = counter = None

        def start_profile():
            nonlocal prof, traced_range, counter
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            traced_range = torch.profiler.record_function("bench.traced")
            traced_range.__enter__()
            counter = LaunchCounter()

        tick_rows: list[dict] = []

        def one_tick(t: int) -> dict:
            rec.tick = t
            phases = dict(h.run_tick(t))
            g0 = time.perf_counter()
            with torch.profiler.record_function("bench.gc") if traced else contextlib.nullcontext():
                gc.collect()
                gc.freeze()
            phases["gc"] = (time.perf_counter() - g0) * 1e3
            phases["steady"] = bool(h._tick_meta[-1]["steady"])
            return phases

        run = Run(window_kind=traffic.get("window", "all"))
        was_enabled = gc.isenabled()
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            if traced and run.window_kind == "steady":
                # a steady window launches nothing on the device, and a
                # traced run must show the device's work: trace the cold
                # ticks' solves with it
                start_profile()
            t = 0
            if traffic.get("warm_until") == "steady":
                warm_max = int(traffic["warm_ticks_max"])
                reached = False
                while t < warm_max and not reached:
                    reached = one_tick(t)["steady"]
                    t += 1
            else:
                reached = True
                for t in range(int(traffic["warm_ticks"])):
                    one_tick(t)
                t = int(traffic["warm_ticks"])
            lap("warm_ticks_s")
            run.setup_s = time.perf_counter() - t0
            if traced and prof is None:
                start_profile()
            w0 = time.perf_counter()
            for _ in range(window_ticks(traffic, seconds)):
                tick_rows.append(one_tick(t))
                t += 1
            window_s = time.perf_counter() - w0
            last_tick = t - 1
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            gc.unfreeze()
            if was_enabled:
                gc.enable()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if prof is not None:
            run.launches = counter.close()
            traced_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            run.profile = profile.read(prof)
        run.ticks = tick_rows
        early = {
            "cell": cell.name,
            "seed": seed,
            "setup_split_s": split,
            "setup_s": run.setup_s,
            "trace_ticks": ticks_total,
            "window": {
                "wall_s": window_s,
                "ticks": len(tick_rows),
                "first_tick": last_tick - len(tick_rows) + 1,
                "steady_ticks": sum(r["steady"] for r in tick_rows),
                "bridge_s": sum(r["tick"] for r in tick_rows) / 1e3,
                "collection_s": sum(r["gc"] for r in tick_rows) / 1e3,
                "tick_ms": [round(r["tick"] + r["gc"], 1) for r in tick_rows],
                "cpu_ms": [round(r["cpu"], 1) for r in tick_rows],
            },
        }
        w = early["window"]
        w["harness_share"] = (1.0 - (w["bridge_s"] + w["collection_s"]) / window_s) if window_s else None

        checks, summary = judge.judge(h, rec, cl, trace, config, last_tick, device=device)
        checks.add("warm_reached", int(reached), 1, "min")
    finally:
        # the column pool's forked workers and the mirror thread end with the run
        h._cleanup()
    early["reference_s"] = summary["reference_s"]
    early["pods_checked"] = summary["pods"]
    result = {
        "correct": checks.ok,
        "attempted": summary["jobs"],
        "failed": summary["failed"],
        "metrics": {},
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.profile is not None:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in run.profile["device_ops"][:10]],
            "idle_gaps": [[k, v] for k, v in run.profile["idle_by_range"][:10]],
        }
    return result, early, checks, run
