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
the single-device auction (``ShardConfig(device_solve=False)``: the JAX
package would take its ``shard_map`` route on a host with several
devices, and the port on its one card would not) and adds the plan's
shard count and the cross-shard reconcile count.

``--churn``: runs the JAX package's streaming reschedule at
chip_smoke.py's ``CHURN`` shape (BASELINE config #5: ``churn_scenario(
10_000, 50_000, seed=5, load=0.7)``; ``--nodes``/``--jobs`` override the
counts) on the device engine with the dense auction pinned
(``AuctionConfig(rounds=8, candidates=0, use_pallas=False)``): one
converging tick, then ``CHURN_TICKS`` ticks of ``CHURN_JOBS`` departing
and arriving jobs (``np.random.default_rng(0)``). It prints each tick's
``node_of`` digest, kept, preempted and started shard counts and
stability (chip_smoke.py's ``churn_summary``).

``--bridge``: runs the JAX package's agent and ``Bridge`` over the fake
Slurm CLI (``tests/fakeslurm``, put first on ``PATH``) at chip_smoke.py's
``BRIDGE`` width: a state directory whose ``cluster.json`` holds the
headline inventory (``fake_cluster``), the JAX ``WorkloadServicer`` served
over gRPC on a unix socket, and a ``Bridge(scheduler_backend="auction")``
with the dense auction pinned (``AuctionConfig(rounds=8, candidates=0,
use_pallas=False)``) that takes ``BRIDGE``'s jobs (``bridge_inventory``,
``bridge_jobs``) and makes its first placing tick before its daemons start
(``bridge_first_tick``). It prints the pods bound, the digest
(``bridge_digest``), the route and the tick's phases; ``--nodes``/``--jobs``
override the counts.

``--place``: runs the JAX package's ``PlacementSolverServicer`` (launched
with the same dense config, ``solver="auction"``) on a ``PlaceRequest`` for
the typed headline inventory (``random_inventory``, 57,635 shards ×
10,000 nodes; ``--nodes``/``--jobs`` override), built with chip_smoke.py's
``place_request`` in the JAX package's messages, then on the same request
with the busiest node drained. It prints each Place's assignment digest
(``place_digest``), response digest (``response_digest``: the serialized
response with ``solve_ms`` zeroed), placed count and drained node.

``--sharded``: runs the JAX package's multi-device sweep (``sharded_place``)
on the headline ``random_scenario`` (``--nodes``/``--jobs`` override the
counts) over four virtual CPU devices as a ``solver_mesh(devices[:4],
dp=2, mp=2)`` — four blocks of 28,818 shards × 5,000 nodes — with the
dense config, and prints its placed count and ``node_of`` digest. Then it
runs one forced-sharded ``PlacementScheduler`` tick (``sharded=True``,
``backend="auction"``, ``AuctionConfig(rounds=8, candidates=0)``) over the
typed headline inventory as ``--tick`` builds it, with the sweep's mesh
cut to one device (a 1×1 mesh, the one card chip_smoke.py has), and prints
its route and tick digest.

chip_smoke.py holds the port's solve, tick, simulator, streaming, sidecar
and sweep runs on the card to these numbers.

    JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 2000 --jobs 10000
    JAX_PLATFORMS=cpu python tools/port_reference.py --tick --nodes 10000 --jobs 50000
    JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_50kx10k
    JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_50kx10k_crash
    JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_500kx100k
    JAX_PLATFORMS=cpu python tools/port_reference.py --churn
    JAX_PLATFORMS=cpu python tools/port_reference.py --place --nodes 10000 --jobs 50000
    JAX_PLATFORMS=cpu python tools/port_reference.py --bridge
    JAX_PLATFORMS=cpu python tools/port_reference.py --sharded
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
if "--sharded" in sys.argv:
    # the sweep's 2x2 mesh needs four devices, fixed before jax starts
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    BRIDGE,
    CHURN,
    CHURN_TICKS,
    InventoryClient,
    bridge_first_tick,
    bridge_inventory,
    bridge_jobs,
    busiest_node,
    churn_summary,
    churn_tick,
    drained_request,
    fake_cluster,
    place_digest,
    place_request,
    response_digest,
    tick_digest,
    tick_world,
)
from slurm_bridge_tpu.solver.auction import AuctionConfig, auction_place  # noqa: E402
from slurm_bridge_tpu.solver.snapshot import random_scenario  # noqa: E402

#: the scenario's shape beyond node and job counts
SCENARIO = dict(load=0.7, gpu_fraction=0.15, gang_fraction=0.05)


def run_ticks(num_nodes: int, num_jobs: int, seed: int, ticks: int = 2,
              sharded: bool | None = None) -> dict:
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
        inventory_ttl=0, sharded=sharded,
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


def run_churn(num_nodes: int, num_jobs: int) -> dict:
    import numpy as np

    from slurm_bridge_tpu.solver.streaming import churn_scenario, churn_step

    shape = dict(CHURN, num_nodes=num_nodes, num_jobs=num_jobs)
    sim = churn_scenario(**shape)
    sim.config = AuctionConfig(rounds=8, candidates=0, use_pallas=False)
    sim.engine = "device"
    rng = np.random.default_rng(0)
    ticks = []
    for i in range(CHURN_TICKS + 1):
        t0 = time.perf_counter()
        res = churn_tick(sim, churn_step, rng, i)
        ticks.append({**churn_summary(res), "rows": int(res.placement.node_of.size),
                      "cpu_seconds_wall": round(time.perf_counter() - t0, 3)})
    return {"churn": shape, "config": "AuctionConfig(rounds=8, candidates=0, "
            "use_pallas=False), engine='device'", "ticks": ticks}


def run_place(num_nodes: int, num_jobs: int, seed: int) -> dict:
    from slurm_bridge_tpu.solver.service import PlacementSolverServicer
    from slurm_bridge_tpu.solver.snapshot import random_inventory
    from slurm_bridge_tpu.wire import convert, pb

    partitions, nodes, demands = random_inventory(num_nodes, num_jobs, seed=seed, **SCENARIO)
    request = pb.PlaceRequest.FromString(
        place_request(pb, convert, partitions, nodes, demands).SerializeToString()
    )
    servicer = PlacementSolverServicer(AuctionConfig(rounds=8, candidates=0, use_pallas=False))
    out = []
    drained = ""
    for req in ("first", "drained"):
        if req == "drained":
            drained = busiest_node(resp)
            request = drained_request(pb, request, drained)
        t0 = time.perf_counter()
        resp = servicer.Place(request, None)
        out.append({
            "place_sha256": place_digest(resp),
            "response_sha256": response_digest(pb, resp),
            "placed": resp.placed, "total": resp.total, "solver": resp.solver,
            "cpu_seconds_wall": round(time.perf_counter() - t0, 3),
        })
    return {"place": {"nodes": num_nodes, "jobs": num_jobs, "seed": seed, **SCENARIO},
            "config": "AuctionConfig(rounds=8, candidates=0, use_pallas=False), "
            "solver='auction'", "drained": drained, "places": out}


def run_bridge(num_nodes: int, num_jobs: int, seed: int) -> dict:
    import shutil
    import tempfile

    import slurm_bridge_tpu.bridge.objects as objects
    from slurm_bridge_tpu.agent import SlurmClient, WorkloadServicer
    from slurm_bridge_tpu.bridge import Bridge, BridgeJobSpec
    from slurm_bridge_tpu.solver.snapshot import random_inventory
    from slurm_bridge_tpu.wire import serve

    logging.getLogger("sbt").setLevel(logging.ERROR)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.mkdtemp(prefix="sbt-bridge-ref-")
    state = os.path.join(tmp, "state")
    os.makedirs(state)
    partitions, nodes, demands = bridge_inventory(random_inventory, num_nodes, num_jobs, seed)
    with open(os.path.join(state, "cluster.json"), "w") as f:
        json.dump(fake_cluster(partitions, nodes), f)
    os.environ["SBT_FAKESLURM_STATE"] = state
    os.environ["PATH"] = os.path.join(repo, "tests", "fakeslurm") + os.pathsep + os.environ["PATH"]
    sock = os.path.join(tmp, "agent.sock")
    server = serve({"WorkloadManager": WorkloadServicer(SlurmClient())}, sock)
    bridge = Bridge(sock, scheduler_backend="auction",
                    auction_config=AuctionConfig(rounds=8, candidates=0, use_pallas=False))
    try:
        t0 = time.perf_counter()
        tick = bridge_first_tick(bridge, objects, bridge_jobs(BridgeJobSpec, demands))
        secs = time.perf_counter() - t0
    finally:
        bridge.configurator.stop()
        bridge.client.close()
        server.stop(None)
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "bridge": {"nodes": num_nodes, "jobs": num_jobs, "seed": seed, **SCENARIO},
        "config": 'Bridge(scheduler_backend="auction"), AuctionConfig(rounds=8, '
        "candidates=0, use_pallas=False)",
        "placed": tick["placed"], "bridge_sha256": tick["digest"], "route": tick["route"],
        "tick_ms": round(tick["wall_ms"], 1),
        "phase_ms": {k: round(v, 1) for k, v in tick["phase_ms"].items()},
        "cpu_seconds_wall": round(secs, 3),
    }


def run_sharded(num_nodes: int, num_jobs: int, seed: int) -> dict:
    import jax

    import slurm_bridge_tpu.solver.sharded as sharded_mod
    from slurm_bridge_tpu.parallel.mesh import solver_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--sharded needs 4 devices, jax has {len(devices)}")
    snap, batch = random_scenario(num_nodes, num_jobs, seed=seed, **SCENARIO)
    cfg = AuctionConfig(rounds=8, candidates=0, use_pallas=False)
    mesh = solver_mesh(devices[:4], dp=2, mp=2)
    t0 = time.perf_counter()
    pl = sharded_mod.sharded_place(snap, batch, cfg, mesh=mesh)
    secs = time.perf_counter() - t0
    # the forced-sharded tick on a 1x1 mesh: the scheduler asks the sweep
    # for its default mesh, cut here to the first device
    one = solver_mesh(devices[:1])
    sharded_mod.solver_mesh = lambda: one
    tick = run_ticks(num_nodes, num_jobs, seed, ticks=1, sharded=True)
    return {
        "sharded": {"nodes": num_nodes, "jobs": num_jobs, "seed": seed, **SCENARIO},
        "shards": batch.num_shards,
        "config": "AuctionConfig(rounds=8, candidates=0, use_pallas=False), "
        "solver_mesh(devices[:4], dp=2, mp=2)",
        "placed_jobs": len(pl.by_job(batch)),
        "placed_shards": int(pl.placed.sum()),
        "node_of_sha256": hashlib.sha256(pl.node_of.astype("<i4").tobytes()).hexdigest(),
        "cpu_seconds_wall": round(secs, 3),
        "tick": {"mesh": "1x1", **tick},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=None,
                    help="node count (default 2000; --churn: CHURN's 10000)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="job count (default 10000; --churn: CHURN's 50000)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tick", action="store_true",
                    help="run two PlacementScheduler ticks over the typed inventory")
    ap.add_argument("--sim", default="", metavar="NAME",
                    help="run the simulator's scenario NAME with the auction pinned")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="the --sim scenario's scale")
    ap.add_argument("--churn", action="store_true",
                    help="run the streaming reschedule at chip_smoke.py's CHURN shape")
    ap.add_argument("--place", action="store_true",
                    help="run the solver sidecar's Place on the typed inventory")
    ap.add_argument("--bridge", action="store_true",
                    help="run the Bridge's first placing tick over the fake Slurm CLI")
    ap.add_argument("--sharded", action="store_true",
                    help="run the multi-device sweep on a 2x2 mesh of CPU devices and "
                    "one forced-sharded tick on a 1x1 mesh")
    args = ap.parse_args()
    if args.bridge:
        res = run_bridge(args.nodes or BRIDGE["num_nodes"], args.jobs or BRIDGE["num_jobs"],
                         args.seed)
        print(json.dumps({
            **res,
            "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        }))
        return
    if args.sharded:
        res = run_sharded(args.nodes or 10_000, args.jobs or 50_000, args.seed)
        print(json.dumps({
            **res,
            "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        }))
        return
    if args.churn:
        args.nodes = args.nodes or CHURN["num_nodes"]
        args.jobs = args.jobs or CHURN["num_jobs"]
    args.nodes = args.nodes or 2000
    args.jobs = args.jobs or 10000
    if args.churn or args.place:
        res = (
            run_churn(args.nodes, args.jobs) if args.churn
            else run_place(args.nodes, args.jobs, args.seed)
        )
        print(json.dumps({
            **res,
            "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        }))
        return
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
