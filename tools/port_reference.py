"""Reference numbers for the PyTorch port's on-card check (chip_smoke.py).

Default: runs the JAX package's auction on the CPU — dense full argmax
(``candidates=0``, ``use_pallas=False``), ``rounds=8`` — on one
``random_scenario`` and prints the placed-jobs count and the sha256 of
``node_of`` (little-endian int32).

``--tick``: runs the JAX package's ``PlacementScheduler`` twice over the
typed headline inventory (``random_inventory``): every job a pending
sizecar pod ``pod000000``… in the columnar ``ObjectStore``, one Ready
virtual node per partition (chip_smoke.py's ``tick_world``), the
inventory served by chip_smoke.py's ``InventoryClient`` in the JAX
package's messages, ``backend="auction"``, ``inventory_ttl=0`` and the same
dense config. It prints each tick's pods bound, route and tick digest
(chip_smoke.py's ``tick_digest``, the function the port's ticks are
digested with).

``--sim NAME``: runs the JAX package's simulator on scenario ``NAME`` at
``--scale`` (default 1.0) with the engine pinned as chip_smoke.py pins
it (``backend="auction"``, ``AuctionConfig(rounds=8, candidates=0)``)
and prints its determinism ``digest``, ``final_state_digest``,
``bound_total``, invariant violations and its tick p50 and phases. A
crash scenario adds its restarts, the objects each restart restored, its
recovery times and WAL counts; a sharded scenario runs every shard on
the single-device auction (``ShardConfig(device_solve=False)``: the port
carries no multi-device sweep, and the JAX package would take its
``shard_map`` route on a host with several devices) and adds the plan's
shard count and the cross-shard reconcile count.

chip_smoke.py holds the port's solve, tick and simulator run on the card
to these numbers.

    JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 2000 --jobs 10000
    JAX_PLATFORMS=cpu python tools/port_reference.py --tick --nodes 10000 --jobs 50000
    JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_50kx10k
    JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_50kx10k_crash
    JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_500kx100k --scale 0.1
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import InventoryClient, tick_digest, tick_world  # noqa: E402
from slurm_bridge_tpu.solver.auction import AuctionConfig, auction_place  # noqa: E402
from slurm_bridge_tpu.solver.snapshot import random_scenario  # noqa: E402

#: the scenario's shape beyond node and job counts
SCENARIO = dict(load=0.7, gpu_fraction=0.15, gang_fraction=0.05)


def run_ticks(num_nodes: int, num_jobs: int, seed: int, ticks: int = 2) -> dict:
    import slurm_bridge_tpu.bridge.objects as objects
    from slurm_bridge_tpu.bridge.objects import Pod
    from slurm_bridge_tpu.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu.bridge.store import ObjectStore
    from slurm_bridge_tpu.solver.snapshot import random_inventory
    from slurm_bridge_tpu.wire import convert, pb

    logging.getLogger("sbt").setLevel(logging.ERROR)
    partitions, nodes, demands = random_inventory(num_nodes, num_jobs, seed=seed, **SCENARIO)
    t0 = time.perf_counter()
    store = tick_world(objects, ObjectStore, partitions, demands)
    load_s = time.perf_counter() - t0
    sched = PlacementScheduler(
        store, InventoryClient(pb, convert, partitions, nodes), backend="auction",
        inventory_ttl=0,
        auction_config=AuctionConfig(rounds=8, candidates=0, use_pallas=False),
    )
    out = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        placed = sched.tick()
        wall = time.perf_counter() - t0
        out.append({
            "placed": placed,
            "route": sched.last_route,
            "tick_sha256": tick_digest(store.list(Pod.KIND)),
            "cpu_seconds_wall": round(wall, 3),
            "phase_ms": {k: round(v, 1) for k, v in sched.last_phase_ms.items()},
        })
    return {"load_seconds": round(load_s, 3), "ticks": out}


def run_sim(name: str, scale: float) -> dict:
    import dataclasses

    from slurm_bridge_tpu.sim.harness import run_scenario
    from slurm_bridge_tpu.sim.scenarios import SCENARIOS

    sc = dataclasses.replace(
        SCENARIOS[name](scale=scale), backend="auction",
        auction_config=AuctionConfig(rounds=8, candidates=0),
    )
    config = 'backend="auction", AuctionConfig(rounds=8, candidates=0)'
    if sc.sharding is not None:
        sc = dataclasses.replace(
            sc, sharding=dataclasses.replace(sc.sharding, device_solve=False)
        )
        config += f", {sc.sharding}"
    t0 = time.perf_counter()
    r = run_scenario(sc)
    d = r.determinism
    out = {
        "sim": name, "scale": scale, "config": config,
        "digest": d["digest"],
        "final_state_digest": d["final_state_digest"],
        "bound_total": d["bound_total"],
        "invariant_violations": len(d["invariant_violations"]),
        "vnode_deletions": d["vnode_deletions"],
        "shape": r.shape,
        "cpu_seconds_wall": round(time.perf_counter() - t0, 3),
        "tick_p50_ms": r.timing["tick_p50_ms"],
        "phases_p50_ms": r.timing["phases_p50_ms"],
    }
    if d["restarts"]:
        out.update(restarts=d["restarts"], restored_objects=d["restored_objects"],
                   recovery_ms=r.timing["recovery_ms"],
                   wal_records=r.timing["wal_records_total"],
                   snapshots=r.timing["wal_snapshots_total"])
    if "shard" in d:
        out.update(shard_count=d["shard"]["shard_count"],
                   reconcile_placed=d["shard"]["reconcile_placed"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--jobs", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tick", action="store_true",
                    help="run two PlacementScheduler ticks over the typed inventory")
    ap.add_argument("--sim", default="", metavar="NAME",
                    help="run the simulator's scenario NAME with the auction pinned")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="the --sim scenario's scale")
    args = ap.parse_args()
    if args.sim:
        res = run_sim(args.sim, args.scale)
        print(json.dumps({
            **res,
            "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        }))
        return
    scenario = {"nodes": args.nodes, "jobs": args.jobs, "seed": args.seed, **SCENARIO}
    config = "AuctionConfig(rounds=8, candidates=0, use_pallas=False)"
    if args.tick:
        res = run_ticks(args.nodes, args.jobs, args.seed)
        print(json.dumps({
            "scenario": scenario, "config": config, **res,
            "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        }))
        return
    snap, batch = random_scenario(args.nodes, args.jobs, seed=args.seed, **SCENARIO)
    cfg = AuctionConfig(rounds=8, candidates=0, use_pallas=False)
    t0 = time.perf_counter()
    pl = auction_place(snap, batch, cfg)
    secs = time.perf_counter() - t0
    print(json.dumps({
        "scenario": scenario,
        "shards": batch.num_shards,
        "config": config,
        "placed_jobs": len(pl.by_job(batch)),
        "placed_shards": int(pl.placed.sum()),
        "node_of_sha256": hashlib.sha256(pl.node_of.astype("<i4").tobytes()).hexdigest(),
        "cpu_seconds_wall": round(secs, 3),
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
    }))


if __name__ == "__main__":
    main()
