"""Where the time of one headline solve, tick or simulator run goes on the card.

Profiles ``DeviceSolver.solve`` of the 57,635 × 10,000 headline scenario
(rounds=8, the ``bid_argmax`` kernel path) with ``torch.profiler`` after a
warm-up solve, and prints: the solve's wall time, the summed device time
of all kernels (and so the device's idle share of the solve), the device
time of the ``bid_argmax`` kernels, the count of host synchronisations
(``aten::item``, ``aten::_local_scalar_dense``, ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``) in the solve, and the operators that take the
most host and device time. Needs a CUDA card.

    python tools/port_profile.py [--rows 25] [--root DIR] [--tick | --churn | --sim [NAME] [--scale S]]

``--tick`` profiles tick 1 of chip_smoke.py's tick phase instead: a
``PlacementScheduler`` (``backend="auction"``, rounds=8) over the typed
headline inventory with its 50,000 jobs pending in a fresh store, after a
warm-up tick on another store; it also prints the tick's phase times.
``--churn`` profiles one churn tick of chip_smoke.py's streaming phase
instead: ``churn_scenario(10_000, 50_000, seed=5, load=0.7)`` with
``AuctionConfig(rounds=8)`` and the device engine, after the converging
tick and two churn ticks of 1,000 jobs (``default_rng(0)``), the second
of them timed without the profiler; it also prints both ticks' host
phases (departures, arrivals, padding, snapshot staging, batch staging,
the auction's host side, the wait for the device and ``free_after``, the
keep bookkeeping).
``--sim`` profiles chip_smoke.py's simulator run instead: ``SimHarness``
on ``full_50kx10k`` at full width (3 ticks, ``backend="auction"``,
rounds=8), after a warm-up run at 5 % scale; it also prints each tick's
phase times and the run's digest. ``--sim NAME --scale S`` profiles
another scenario pinned the same way (chip_smoke.py's ``pin_auction``):
``full_50kx10k_crash`` or ``full_500kx100k``, chip_smoke.py's phases 7
and 8.
``--root`` profiles the port package of another checkout (for example
an unpacked earlier commit), so two trees compare in one call.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

#: Host-side events that wait for the device.
SYNC_EVENTS = ("aten::item", "aten::_local_scalar_dense", "cudaStreamSynchronize",
               "cudaDeviceSynchronize")
HEADLINE = dict(seed=42, load=0.7, gpu_fraction=0.15, gang_fraction=0.05)


def solve_work():
    """(one headline solve of a warmed ``DeviceSolver``, extra record)."""
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver
    from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

    snap, batch = random_scenario(10_000, 50_000, **HEADLINE)
    solver = DeviceSolver(snap, AuctionConfig(rounds=8))
    solver.solve(batch)  # warm-up: kernel build, allocator, first launches
    return lambda: solver.solve(batch), dict


def tick_work():
    """(tick 1 of a fresh scheduler and store, its phase times), after a
    warm-up tick on another store."""
    import chip_smoke
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory

    logging.getLogger("sbt").setLevel(logging.ERROR)  # 50k PlacementFailed lines
    partitions, nodes, demands = random_inventory(10_000, 50_000, **HEADLINE)
    client, make_store = chip_smoke.port_tick_world(partitions, nodes, demands)

    def scheduler():
        return PlacementScheduler(
            make_store(), client, backend="auction",
            inventory_ttl=0, auction_config=AuctionConfig(rounds=8, candidates=0),
        )

    scheduler().tick()
    sched = scheduler()
    return sched.tick, lambda: {"phase_ms": sched.last_phase_ms, "route": sched.last_route}


def churn_work():
    """(one churn tick of a warmed ``StreamingSim``, its host phases and
    those of the unprofiled tick before it). Each tick is held to the JAX
    package's (chip_smoke.py's ``CHURN_REFERENCE``)."""
    import numpy as np

    import chip_smoke
    import slurm_bridge_tpu_torch.solver.session as session
    import slurm_bridge_tpu_torch.solver.streaming as streaming
    from slurm_bridge_tpu_torch.solver import AuctionConfig

    phases: dict[str, float] = {}

    def timed(owner, name, phase):
        real = getattr(owner, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                phases[phase] = phases.get(phase, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(owner, name, wrapper)

    timed(streaming.StreamingSim, "depart", "depart")
    timed(streaming, "random_scenario", "arrivals drawn")
    timed(streaming.StreamingSim, "arrive", "arrive")
    timed(streaming, "pad_batch", "pad")
    timed(session.DeviceSolver, "update_snapshot", "update_snapshot")
    timed(session, "stage_batch", "stage_batch")
    timed(session, "_auction_kernel", "auction (host side, async)")
    timed(session.PendingSolve, "result", "wait + free_after")
    timed(streaming, "_tick_result", "keep")
    timed(streaming.StreamingSim, "tick", "re-solve (sim.tick)")

    sim = streaming.churn_scenario(**chip_smoke.CHURN)
    sim.config = AuctionConfig(rounds=chip_smoke.ROUNDS)
    sim.engine = "device"
    rng = np.random.default_rng(0)
    ticks = []

    def run():
        phases.clear()
        t0 = time.perf_counter()
        res = chip_smoke.churn_tick(sim, streaming.churn_step, rng, len(ticks))
        torch.cuda.synchronize()
        summary = chip_smoke.churn_summary(res)
        if summary != chip_smoke.CHURN_REFERENCE[len(ticks)]:
            raise SystemExit(f"churn tick {len(ticks)} {summary} differs from the JAX package's")
        ticks.append(dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                          rows=int(res.placement.node_of.size),
                          pinned=int(res.incumbent.sum()),
                          summary=summary, phase_ms=dict(phases)))

    for _ in range(3):  # converge, then a churn tick that warms the session
        run()
    unprofiled = ticks[-1]

    def extra():
        profiled = ticks[-1]
        return {"churn_tick": len(ticks) - 1, "rows": profiled["rows"],
                "pinned": profiled["pinned"], "summary": profiled["summary"],
                "tick_wall_ms": profiled["wall_ms"], "phase_ms": profiled["phase_ms"],
                "unprofiled_tick": len(ticks) - 2, "unprofiled_wall_ms": unprofiled["wall_ms"],
                "unprofiled_phase_ms": unprofiled["phase_ms"]}

    return run, extra


def sim_work(name: str, scale: float):
    """(the scenario's run, its digest and per-tick phases), after a
    warm-up run at 5 % of its scale."""
    import chip_smoke
    from slurm_bridge_tpu_torch.sim.harness import SimHarness
    from slurm_bridge_tpu_torch.sim.scenarios import SCENARIOS

    def harness(scale):
        return SimHarness(chip_smoke.pin_auction(SCENARIOS[name](scale=scale)), device="cuda")

    harness(0.05 * scale).run()
    h = harness(scale)
    out = {}

    def extra():
        d = out["result"].determinism
        return {"sim": name, "scale": scale, "digest": d["digest"],
                "bound_total": d["bound_total"],
                "recovery_ms": out["result"].timing["recovery_ms"],
                "tick_phase_ms": [{k: round(v, 1) for k, v in ph.items()
                                   if isinstance(v, float)}
                                  for ph in h._tick_phases]}

    return lambda: out.update(result=h.run()), extra


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tick", action="store_true", help="profile one headline tick")
    ap.add_argument("--churn", action="store_true", help="profile one streaming churn tick")
    ap.add_argument("--sim", nargs="?", const="full_50kx10k", default="", metavar="NAME",
                    help="profile a simulator run (default full_50kx10k)")
    ap.add_argument("--scale", type=float, default=1.0, help="the --sim scenario's scale")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    work, extra = (sim_work(args.sim, args.scale) if args.sim
                   else tick_work() if args.tick else churn_work() if args.churn
                   else solve_work())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    # device-side entries only (kernels, copies, memsets): an operator's own
    # row repeats the time of the kernels it launched
    device_ms = sum(dev_us(e) for e in events if e.device_type == DeviceType.CUDA) / 1e3
    kernel_ms = sum(dev_us(e) for e in events
                    if "bid_argmax" in e.key and e.device_type == DeviceType.CUDA) / 1e3
    syncs = {e.key: e.count for e in events if e.key in SYNC_EVENTS}
    print(f"card: {smi}; package: {os.path.abspath(args.root)}")
    print(json.dumps({
        "work": ("sim" if args.sim else "tick" if args.tick else "churn" if args.churn
                 else "solve"),
        "wall_ms": wall_ms,
        "device_busy_ms": device_ms,
        "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
        "bid_argmax_device_ms": kernel_ms,
        "bid_argmax_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in events
                                  if "bid_argmax" in e.key and e.device_type == DeviceType.CUDA},
        "sync_events": syncs,
        **extra(),
    }))
    print(events.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    sort_dev = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    print(events.table(sort_by=sort_dev, row_limit=args.rows))


if __name__ == "__main__":
    main()
