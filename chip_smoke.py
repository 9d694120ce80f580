#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: the placement solve, the
placement tick, the bridge's job lifecycle on the simulated cluster, its
recovery from a crash, the sharded tick, the streaming reschedule, the
placement-solver sidecar, the bridge's daemons and the multi-device sweep.

    python3 chip_smoke.py

(``chip_smoke.py --sweep-rank RANK PORT DEVICE`` is one rank of phase 12's
two-process run; phase 12 starts both itself.)

Needs one CUDA card (Hopper, ``sm_90a``) and ``nvcc``; exits non-zero
without one. Imports nothing of JAX or of the JAX package. Phases, each of
which fails the run:

1. identify the card (``nvidia-smi`` name and power limit);
2. build ``slurm_bridge_tpu_torch/csrc/bid_argmax.cu`` from the checkout;
3. hold the kernel against its plain PyTorch version on the card: small
   shapes, a tie across a tile boundary, one round's operands of the
   57,635 × 10,000 headline solve, and every round of one instrumented
   headline solve with that round's live mask (the rows still unplaced) —
   bit-exact at ``affinity_weight=0``; at 0.3, ≥ 99.9 % equal choices and
   values within atol 1e-5. Per round it prints the live rows, the cells
   they need (each live row's partition's node count) and the kernel's
   device time in the solve (CUDA events around the wrapper's call, behind
   a gate so the host's launch rate is not timed); then the time per launch
   on all rows, and two bounds on the needed cells: the roofline at the
   data sheet's rates, and the per-pipe issue ceiling at the SM clock
   ``nvidia-smi`` reads while the kernel runs;
4. drive the main path at full width: ``choose_path`` must route the
   headline scenario to the device; ``DeviceSolver`` (rounds=8) solves it
   1 + 5 times, once through ``solve_async``, and once more after a node
   is drained; every solve must launch the kernel exactly 8 times, be
   feasible, and be deterministic; its ``node_of`` digest must equal the
   JAX package's (:data:`HEADLINE_REFERENCE`); the dense plain path on the
   card must place identically;
5. drive the bridge's placement tick at full width: the typed headline
   inventory (``random_inventory``), its 50,000 jobs as unbound sizecar
   pods in the port's ``ObjectStore``, one Ready virtual node per
   partition, the inventory answered by an in-process client;
   ``PlacementScheduler(backend="auction", inventory_ttl=0,
   AuctionConfig(rounds=8, candidates=0)).tick()`` twice — each tick must
   route ``"auction"``, launch the kernel exactly 8 times, and bind the
   JAX package's pods with its tick digest (:data:`TICK_REFERENCE`); what
   the kernel returned in each of those 16 calls is held bit-exact against
   its plain version on that call's own operands (the scheduler's batch,
   padded to 58,368 rows, and the round's live mask); then
   a fresh store and scheduler at the product defaults (``backend="auto"``,
   ``AuctionConfig(rounds=8)``) must route tick 1 to the card with the
   same digest, its kernel calls timed with the gated CUDA events of
   phase 3; prints each tick's phase times (store, encode, solve, bind);
6. drive the bridge's job lifecycle at full width: the simulator's
   ``full_50kx10k`` (10,000 nodes, 50,000 jobs, 3 ticks) through the
   port's ``SimHarness`` — operator, configurator, virtual-node providers
   submitting to and mirroring the simulated agent over the port's wire
   codec, the placement scheduler on the card — with the engine pinned
   (``backend="auction"``, ``AuctionConfig(rounds=8, candidates=0)``). Its
   determinism ``digest``, ``final_state_digest`` and ``bound_total`` must
   equal the JAX package's (:data:`SIM_REFERENCE`), with no invariant
   violated; every solving tick launches the kernel 8 times per solve;
   each of tick 0's kernel calls is held bit-exact against its plain
   version on its own operands; the providers' bulk RPCs must have gone
   through the column decoder (rows counted, no fallback) and their
   submits through the forked worker pool. Then the same scenario at the
   product default (``backend="auto"``) for one tick must reach the card
   with no violation. Prints each tick's phases (arrive, store, encode,
   solve, bind, mirror, other), the tick p50 and the phase's wall time;
7. recovery at full width: ``full_50kx10k_crash`` (10,000 nodes, 50,000
   front-loaded jobs, 4 ticks, a bridge crash at tick 2 that reloads the
   snapshot and WAL into a fresh store, scheduler and ``DeviceSolver``)
   with the same pinned engine. Its ``digest``, ``final_state_digest``,
   ``bound_total``, restarts and restored object count must equal the JAX
   package's (:data:`CRASH_REFERENCE`), with no invariant violated and no
   virtual node deleted; every solving tick launches the kernel 8 times
   per solve; each kernel call of the first solve after the restart is
   held bit-exact against its plain version on its own operands. Prints
   ``recovery_ms``, the WAL records and snapshots and each tick's phases;
8. the sharded tick at the headline's full size: ``full_500kx100k``
   uncut (100,000 nodes in 16 partitions, 500,000 front-loaded jobs, 5 %
   gangs, 15 % GPU nodes, its 3 ticks) with
   ``ShardConfig(max_nodes_per_shard=8192, workers=2, device_solve=False)``
   and the same pinned engine, under its own deadline
   (:data:`SHARD_DEADLINE_S`). The plan must have at least two shards,
   every shard's solve must launch the kernel 8 times, every kernel call
   of tick 0 (round 0 and the last round of its first and largest shard
   solves among them) is held bit-exact against the plain version on its
   own operands, and the ``digest``, ``final_state_digest``, ``bound_total`` and cross-shard
   ``reconcile_placed`` must equal the JAX package's
   (:data:`SHARD_REFERENCE`). Prints each tick's phases, the plan's shard
   sizes, the shard solves (rows, nodes, launches, ms), the tick p50 and
   the phase-sum drift beside the scenario's gates (``p50_gate_ms``,
   ``phase_reconcile_pct``; printed, as ``sim/cli.py`` enforces them and
   the harness does not), the device's and the host's peak memory, and
   the first and largest shard solves' kernel calls timed again on their
   operands;
9. the streaming reschedule at full width (BASELINE config #5):
   ``churn_scenario(10_000, 50_000, seed=5, load=0.7)`` with
   ``AuctionConfig(rounds=8)`` on the device engine — one converging tick,
   then 5 ticks in which 1,000 running jobs depart and 1,000 arrive
   (``np.random.default_rng(0)``). Each tick must launch the kernel 8
   times, and its ``node_of`` digest, kept, preempted and started shards
   and stability must equal the JAX package's (:data:`CHURN_REFERENCE`).
   Each kernel call of the first churn tick — the first whose rows are
   mostly pinned incumbents, each scoring only the node it holds — is held
   bit-exact against its plain version on its own operands, and timed again
   on them once the counts are read. Then one tick at ``engine="auto"``
   prints the route the production rule took. Prints each tick's rows,
   pinned rows, counts, wall and re-solve time;
10. the placement-solver sidecar in process: a ``PlaceRequest`` for the
   headline inventory (57,635 shards × 10,000 nodes) in the port's
   messages, serialized and parsed back, through
   ``PlacementSolverServicer.Place`` (``solver="auction"``,
   ``AuctionConfig(rounds=8)``), then again with the busiest node drained.
   Each Place must launch the kernel 8 times, and its assignments and its
   serialized response (``free_after`` included, ``solve_ms`` zeroed) must
   equal the JAX package's (:data:`PLACE_REFERENCE`); the drained Place
   must reuse the cached session; the first Place's kernel calls are held
   bit-exact against the plain version and timed again on their operands;
   ``SolverInfo`` must report
   ``cuda`` and one device. (The gRPC transport and the fleet are not
   driven here: the card's machine has no ``grpc``.)
11. the bridge's daemons at the headline inventory's width: a fake-Slurm
    state directory (``tests/fakeslurm`` first on ``PATH``) whose
    ``cluster.json`` holds the 10,000 headline nodes (:func:`fake_cluster`,
    drained nodes as ``DRAINED``), the port's agent
    ``WorkloadServicer(SlurmClient())``, and the port's
    ``Bridge(scheduler_backend="auction", AuctionConfig(rounds=8,
    candidates=0), kubelet_port=0)`` reaching it over a
    :class:`LoopbackChannel` (the card's machine has no ``grpc``; every
    request and response crosses as codec bytes). :data:`BRIDGE`'s 120
    jobs (the headline's first 120 demands, :func:`bridge_inventory`) go
    in through ``Bridge.submit``, each script echoing its marker; once every
    sizecar pod exists one scheduler tick places them on the card
    (:func:`bridge_first_tick`): 8 kernel launches, each held bit-exact
    against its plain version on its own operands and timed again on them,
    and the digest of (pod, node, placement hint) must equal the JAX
    package's (:data:`BRIDGE_REFERENCE`). Then the daemons start and run
    until every job has Succeeded with its stdout fetched (each fetched
    file holds its marker); prints the wall time from the first submit to
    the last, and one job's log read over the kubelet HTTP server;
12. the multi-device sweep on one card (``solver/sharded.py``): (a) the
    headline (57,635 × 10,000, ``AuctionConfig(rounds=8, candidates=0)``)
    on a :data:`SWEEP` grid of four ``cuda:0`` blocks — 32 kernel launches
    per solve, one per block and round, each with its global
    ``p_base``/``n_base``; round 0's four calls and the last round's are
    held bit-exact against the plain version on their own operands; the
    ``node_of`` must equal the JAX package's 2×2 sweep
    (:data:`SHARDED_REFERENCE`), be feasible, deterministic over four
    solves and place ≥ 90 % of phase 4's shards; prints the solve wall,
    the kernel's device time per block launch and per solve, an all-live
    block launch beside its bounds, and the per-round combine and gathers
    (gated CUDA events); (b) ``PlacementScheduler(backend="auction",
    sharded=True)`` on phase 5's headline tick world, a 1×1 grid: route
    ``"auction-sharded"``, 8 launches, the JAX package's forced-sharded
    tick digest; (c) two ranks of this script (``--sweep-rank``) joined
    over gloo on the one card (NCCL refuses two ranks on one card and needs
    two or more cards: not run), each a dp row of two ``cuda:0`` blocks
    (``hybrid_solver_mesh``) — 16 launches per solve each, both ranks'
    ``node_of`` equal to (a)'s; a rank that fails, hangs past
    :data:`SWEEP_RANK_DEADLINE_S` or exits nonzero fails the run;
13. hold the card against the JAX package's result on a reduced scenario
    (``tools/port_reference.py``): placed jobs within 0.5 %, digest shown;
14. print times with the card's name and power limit, and the run's wall
    time.

The second-to-last lines are the kernels' JSON record and the
``nvidia-smi`` line; the last line is the run's JSON verdict.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: The headline scenario (57,635 shards × 10,000 nodes, 4 partitions,
#: 15 % GPU nodes, 5 % of jobs as 4-node gangs) and the solve's config.
HEADLINE = dict(num_nodes=10_000, num_jobs=50_000, seed=42, load=0.7,
                gpu_fraction=0.15, gang_fraction=0.05)
ROUNDS = 8

#: The JAX package's dense solve of the reduced scenario on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 5000 --jobs 25000``
#: (a quarter of the headline's cells).
REFERENCE = dict(nodes=5000, jobs=25000, shards=28837, placed_jobs=22780,
                 node_of_sha256="968124f92cadbd7b5d47e629b7d0530ad83e6752926d736c68e116ea31fd76b4")
#: The JAX package's dense solve of the headline scenario on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 10000 --jobs 50000``.
#: Every headline solve on the card must give this ``node_of``.
HEADLINE_REFERENCE = dict(placed_jobs=45479, placed_shards=52307,
                          node_of_sha256="b6a4f8a8afea3192637cc0709c51544669a0e8be5195cdcf733ba7fca316ebcd")
#: The JAX package's two ``PlacementScheduler`` ticks over the typed
#: headline inventory on the CPU (pods bound, tick digest), from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --tick --nodes 10000 --jobs 50000``.
TICK_REFERENCE = [
    dict(placed=45777, tick_sha256="9e913c369ad1a6feb91985a4aca8cce906f678c60f0f9aeec489f338dee6e17f"),
    dict(placed=3090, tick_sha256="917cd82528af955f68fc31cb4bbdce74b451af11ac1aa02bfb51bb261940eba6"),
]
#: The JAX package's simulator on ``full_50kx10k`` at full width with the
#: auction pinned, on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_50kx10k``.
SIM_REFERENCE = dict(
    digest="a20adeb5771b4148b7d20deaa6d260dc8c036efd5b8b00f1d581a682c7baf8d4",
    final_state_digest="23cfdb80bae8777708c3dc74dc248331b1f2714726db2ee56e520d440cc0ee38",
    bound_total=46059,
)
#: The JAX package's simulator on ``full_50kx10k_crash`` at full width
#: (a bridge crash and snapshot + WAL reload at tick 2) with the auction
#: pinned, on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_50kx10k_crash``.
CRASH_REFERENCE = dict(
    digest="60745be0921ea6df00c11a84fe284ce0c21c76b4acb3ebbc47f576a1d104e03d",
    final_state_digest="fadf07b1ee032ee1c9b276455174ecfe101043aa54378f02ded9ef2109b410ca",
    bound_total=46059,
    restarts=1,
    restored_objects=[100004],
)
#: Phase 8 fails if a tick of its run ends more than this many seconds
#: after the run's harness was built (about twice what the run takes on
#: the card's host).
SHARD_DEADLINE_S = 480
#: The JAX package's simulator on ``full_500kx100k`` uncut (100,000 nodes
#: in 16 partitions, 500,000 front-loaded jobs, 3 ticks, ``ShardConfig(
#: max_nodes_per_shard=8192, workers=2)``) with the auction pinned and
#: every shard on the single-device auction, on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_500kx100k``
#: (438.3 s wall and 7,541 MiB peak RSS, 8,446 MiB with its forked pool
#: workers' PSS, on an 8-core host).
SHARD_REFERENCE = dict(
    digest="653fe44cd3918667a6b7e6360035fc3bb65b29d343f615a23989748fe5ca3721",
    final_state_digest="dc65c9cafdca1af0690431877aac0e0c457574b23570956d4f185b859e008f36",
    bound_total=462742,
    reconcile_placed=0,
)
#: The streaming reschedule at full width: BASELINE config #5's shape and
#: seed (``benchmarks/scenarios/__init__.py`` ``scenario_5``) — one
#: converging tick, then :data:`CHURN_TICKS` ticks in which
#: :data:`CHURN_JOBS` running jobs depart and as many arrive
#: (``np.random.default_rng(0)``).
CHURN = dict(num_nodes=10_000, num_jobs=50_000, seed=5, load=0.7)
CHURN_TICKS = 5
CHURN_JOBS = 1_000
#: The JAX package's streaming reschedule at :data:`CHURN` on the CPU, tick
#: for tick (the converging tick, then each churn tick): ``node_of`` digest,
#: kept, preempted and started shards and stability, with the device engine
#: and the dense auction pinned, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --churn``.
CHURN_REFERENCE = [
    dict(node_of_sha256="369a716a91ae7f24ac64943a35605fb1a4db0811ae1ed971bbe2cc21b2cdc001",
         kept=0, preempted=0, started=54144, stability=1.0),
    dict(node_of_sha256="4b7598564ae4d8b95cb3e726e32c7b03c749e91da2afd6e2bf4499f94b0cda87",
         kept=52213, preempted=802, started=1213, stability=0.9848722059794398),
    dict(node_of_sha256="8da70473a2cf99cc9c206162fee57f8fde52fc85283d11e0fca121532a9ebee5",
         kept=51529, preempted=756, started=1689, stability=0.9855407860763126),
    dict(node_of_sha256="862371ff210672d3d8c924fb985993e37f45f0b56270b160ae276af6f655dfa7",
         kept=51337, preempted=764, started=1698, stability=0.9853361739697895),
    dict(node_of_sha256="6cbe05ce49b569fa90d98a44f722e5e5ce6c4eab0114fb4a4631ada76fef13ce",
         kept=51065, preempted=838, started=1703, stability=0.9838544978132285),
    dict(node_of_sha256="7b7e9ad9aec58ba1c609d03a89f0823a54ab16a13172cd2d1059ecbdf896b249",
         kept=50828, preempted=781, started=1801, stability=0.9848669805654052),
]
#: The JAX package's ``PlacementSolverServicer.Place`` (``solver="auction"``,
#: the dense auction) on the headline inventory's ``PlaceRequest``, then on
#: the same request with its busiest node drained: each Place's assignment
#: and response digests (:func:`place_digest`, :func:`response_digest`),
#: from ``JAX_PLATFORMS=cpu python tools/port_reference.py --place --nodes
#: 10000 --jobs 50000``.
PLACE_REFERENCE = dict(
    drained="node00925",
    places=[
        dict(placed=45823,
             place_sha256="39a18d2126e02d568a7cb1d60378e6069fa4ba1b50ea5a892a6c3109f612da76",
             response_sha256="2085d505a29fc57a9cad656a4b3a8bbac5e32e05c017ff30a60cece77362eec2"),
        dict(placed=45823,
             place_sha256="4b8007d900f385bcbc78bc7b4fcfa249d6467bd721472de6719bd5b1211e5c72",
             response_sha256="3888ca1bac3f3e4163a9eea238a5218dd73658d78ed2a83db932f538f21c6b07"),
    ],
)
#: The bridge's daemons at the headline inventory's width: 10,000 nodes
#: (``random_inventory``'s headline shape), and the first ``num_jobs`` of its
#: 50,000 demands as ``BridgeJob``s (:func:`bridge_inventory`). The job count
#: is the phase's scale: the fake Slurm CLI reads every job record once per
#: node it lists, so each inventory fetch the providers make costs O(nodes ×
#: jobs) (``tools/fakeslurm_cost.py`` times it): on the card's machine 1,000
#: jobs outran the phase's deadline and 250 took ~4 minutes to succeed.
BRIDGE = dict(num_nodes=10_000, num_jobs=120)
#: The JAX package's ``Bridge`` first placing tick at :data:`BRIDGE` over the
#: fake Slurm CLI (pods bound, :func:`bridge_digest`), from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --bridge``.
BRIDGE_REFERENCE = dict(
    placed=120,
    bridge_sha256="580665ab440eafa64317089bed2f3af7b8d8754266eb71f5624fbbfdd7b6083c",
)
#: How long the bridge phase waits for every job to succeed and be fetched.
BRIDGE_DEADLINE_S = 600
#: Phase [12]'s grid: the headline solve's ("dp", "mp") blocks, all on
#: ``cuda:0``; in its two-rank run each rank holds one dp row of them.
SWEEP = dict(dp=2, mp=2)
#: The JAX package's multi-device sweep of the headline scenario on four
#: virtual CPU devices as a ``solver_mesh(devices[:4], dp=2, mp=2)`` (four
#: blocks of 28,818 shards × 5,000 nodes), and its forced-sharded
#: ``PlacementScheduler`` tick over the typed headline inventory on a 1×1
#: mesh (pods bound, tick digest), with the dense config, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --sharded``.
SHARDED_REFERENCE = dict(
    placed_jobs=45479, placed_shards=52307,
    node_of_sha256="b6a4f8a8afea3192637cc0709c51544669a0e8be5195cdcf733ba7fca316ebcd",
    tick_placed=45777,
    tick_sha256="9e913c369ad1a6feb91985a4aca8cce906f678c60f0f9aeec489f338dee6e17f",
)
#: How long phase [12] waits for its two ranks, start to exit.
SWEEP_RANK_DEADLINE_S = 300
#: What the JAX package's default (native-routed on the CPU) run of
#: ``full_50kx10k`` binds over its 3 ticks: printed beside the port's
#: auto-routed tick for reading, not compared.
SIM_NATIVE_BOUND = 45_561

#: Peak rates for the bound (NVIDIA H100 SXM data sheet): HBM bytes/s and
#: float32 non-tensor-core operations/s. Counting every integer and float
#: operation of the cell loop at the f32 rate gives a least time.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: Per-SM issue rates in lanes per clock (CUDA C++ programming guide,
#: arithmetic instruction throughput, compute capability 9.0): 32-bit
#: integer add/logic/compare, f32 add/multiply/compare, type conversion,
#: shared-memory loads; and the total a Hopper SM issues (four schedulers,
#: one warp instruction each). The H100 SXM has 132 SMs.
LANES_PER_CLOCK = dict(int=64, f32=128, cvt=16, lds=32)
ISSUE_LANES_PER_CLOCK = 128
SMS = 132


class SmokeFailure(RuntimeError):
    """A phase of the smoke run found the port wrong."""


def require(ok, msg) -> None:
    """Fail the run (an explicit check: ``assert`` vanishes under -O)."""
    if not ok:
        raise SmokeFailure(str(msg))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


#: Cycles of a spin kernel queued ahead of a timed window (~0.2 s at the
#: H100's 1.98 GHz): the host enqueues the whole window while the device
#: spins, so the events time the device's work and not the host's launch
#: rate. A window whose enqueue outlasted the gate is measured again.
GATE_CYCLES = 400_000_000
GATE_TRIES = 3


def cuda_ms(fn, reps: int, gate: bool = True) -> float:
    """Mean device time per call over ``reps`` calls, from CUDA events
    behind a :data:`GATE_CYCLES` gate (``gate=False`` for a call that
    launches more kernels than the launch queue holds; time it only where
    the device, not the host, is the limit)."""
    for _ in range(GATE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if gate:
            torch.cuda._sleep(GATE_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        gate_s = (time.perf_counter() - t0) - start.elapsed_time(stop) / 1e3
        if not gate or host_s < gate_s:
            return start.elapsed_time(stop) / reps
        log(f"  (host enqueue {host_s:.3f} s outlasted the {gate_s:.3f} s gate: timing again)")
    raise SmokeFailure("every timing window's enqueue outlasted its gate")


def digest(node_of: np.ndarray) -> str:
    return hashlib.sha256(node_of.astype("<i4").tobytes()).hexdigest()


def tick_digest(pods) -> str:
    """sha256 over pods sorted by name of (name, bound node, placement
    hint, reason) — what a tick decided for every pod. It reads only
    fields both packages' pods have: ``tools/port_reference.py`` and the
    tests digest the JAX package's store with it too."""
    h = hashlib.sha256()
    for p in sorted(pods, key=lambda p: p.meta.name):
        h.update("\x1f".join((
            p.meta.name, p.spec.node_name, ",".join(p.spec.placement_hint),
            p.status.reason,
        )).encode() + b"\n")
    return h.hexdigest()


class InventoryClient:
    """The inventory and cancel RPCs of a tick, answered in process in
    ``pb``'s messages the way the simulator's in-process agent answers
    them: the same ``PartitionResponse`` object per partition, ``Nodes``
    in request order with the inventory's version, and ``unchanged=True``
    when the caller's cursor matches. ``pb`` and ``convert`` are a
    package's ``wire.pb`` and ``wire.convert``: the port's here, the JAX
    package's in ``tools/port_reference.py`` and the tests."""

    def __init__(self, pb, convert, partitions, nodes):
        self.pb, self.convert = pb, convert
        self.partitions = {p.name: p for p in partitions}
        self.nodes = {n.name: n for n in nodes}
        self.version = 1
        self.cancelled = []
        self._part_protos = {}
        self._node_protos = {}

    def Partitions(self, request, timeout=None):
        return self.pb.PartitionsResponse(partitions=list(self.partitions))

    def Partition(self, request, timeout=None):
        resp = self._part_protos.get(request.partition)
        if resp is None:
            resp = self.convert.partition_to_proto(self.partitions[request.partition])
            self._part_protos[request.partition] = resp
        return resp

    def _node_proto(self, name):
        msg = self._node_protos.get(name)
        if msg is None:
            msg = self._node_protos[name] = self.convert.node_to_proto(self.nodes[name])
        return msg

    def Nodes(self, request, timeout=None):
        if request.since_version and request.since_version == self.version:
            return self.pb.NodesResponse(version=self.version, unchanged=True)
        return self.pb.NodesResponse(
            nodes=[self._node_proto(n) for n in request.names if n in self.nodes],
            version=self.version,
        )

    def CancelJob(self, request, timeout=None):
        self.cancelled.append(int(request.job_id))
        return self.pb.CancelJobResponse()

    def replace_node(self, node) -> None:
        """A changed node: the next ``Nodes`` call serves it, under a new
        version."""
        self.nodes[node.name] = node
        self._node_protos.pop(node.name, None)
        self.version += 1


def tick_world(objects, store_cls, partitions, demands):
    """A fresh ``store_cls`` holding every job as an unbound sizecar pod
    ``pod000000``… and one Ready virtual node per partition, built from
    ``objects`` (a package's ``bridge.objects``)."""
    o = objects
    store = store_cls()
    store.create_batch([
        o.Pod(meta=o.Meta(name=f"pod{j:06d}"),
              spec=o.PodSpec(role=o.PodRole.SIZECAR, partition=d.partition, demand=d))
        for j, d in enumerate(demands)
    ])
    for p in partitions:
        store.create(o.VirtualNode(meta=o.Meta(name=o.partition_node_name(p.name)),
                                   partition=p.name, conditions=[o.NodeCondition()]))
    return store


def port_tick_world(partitions, nodes, demands):
    """The port's side of a tick over ``random_inventory``'s lists: its
    :class:`InventoryClient`, and a function that builds a fresh
    :func:`tick_world` store."""
    import slurm_bridge_tpu_torch.bridge.objects as objects
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore
    from slurm_bridge_tpu_torch.wire import convert, pb

    client = InventoryClient(pb, convert, partitions, nodes)
    return client, lambda: tick_world(objects, ObjectStore, partitions, demands)


def churn_tick(sim, churn_step, rng, i: int):
    """Tick ``i`` of the streaming reschedule: tick 0 converges the
    initial placement, each later tick is one :data:`CHURN_JOBS`-job
    ``churn_step``. ``sim``/``churn_step`` are a package's
    ``solver.streaming`` objects: the port's here, the JAX package's in
    ``tools/port_reference.py --churn`` and the tests."""
    return sim.tick() if i == 0 else churn_step(sim, rng, CHURN_JOBS)


def churn_summary(result) -> dict:
    """What a streaming tick decided: the ``node_of`` digest and the kept,
    preempted and started shard counts, and its stability."""
    return dict(
        node_of_sha256=digest(result.placement.node_of),
        kept=int(result.kept.sum()), preempted=int(result.preempted.sum()),
        started=int(result.started.sum()), stability=result.stability,
    )


def place_request(pb, convert, partitions, nodes, demands, solver="auction"):
    """A ``PlaceRequest`` for ``random_inventory``'s lists, lowered as the
    scheduler's remote solve lowers a tick (``bridge/scheduler.py``
    ``_solve_remote``), in ``pb``'s messages (a package's ``wire.pb``)."""
    return pb.PlaceRequest(
        jobs=[convert.demand_to_place(d, job_id=str(j)) for j, d in enumerate(demands)],
        inventory=[convert.node_to_proto(n) for n in nodes],
        partitions=[convert.partition_to_proto(p) for p in partitions],
        solver=solver,
    )


def place_digest(resp) -> str:
    """sha256 over each job's assigned node names, in request order: the
    ``node_of`` of a ``PlaceResponse``."""
    h = hashlib.sha256()
    for a in resp.assignments:
        h.update((a.job_id + "\x1f" + ",".join(a.node_names)).encode() + b"\n")
    return h.hexdigest()


def response_digest(pb, resp) -> str:
    """sha256 of the serialized ``PlaceResponse`` with its wall-clock
    ``solve_ms`` zeroed: assignments, counts, solver and ``free_after``."""
    r = pb.PlaceResponse.FromString(resp.SerializeToString())
    r.solve_ms = 0.0
    return hashlib.sha256(r.SerializeToString()).hexdigest()


def busiest_node(resp) -> str:
    """The node the most shards of a ``PlaceResponse`` landed on (the
    first by name among equals)."""
    counts: dict[str, int] = {}
    for a in resp.assignments:
        for n in a.node_names:
            counts[n] = counts.get(n, 0) + 1
    return min(counts, key=lambda n: (-counts[n], n))


def drained_request(pb, request, name: str):
    """A copy of ``request`` with node ``name`` in state ``DRAIN``."""
    req = pb.PlaceRequest.FromString(request.SerializeToString())
    for n in req.inventory:
        if n.name == name:
            n.state = "DRAIN"
    return req


class LoopbackChannel:
    """A channel to a servicer in this process, for a machine without
    grpc: the port's ``ServiceClient`` builds its stubs on it as it builds
    them on a ``grpc.Channel``. Every request and response crosses as the
    bytes the stub's serializers write (the port's codec, byte for byte
    what ``workload_pb2`` writes), parsed on the far side with the
    method's message classes, and the servicer's method runs with the
    port's ``LocalContext``, whose ``abort`` raises the port's
    ``RpcError`` — what a stub on a grpc channel raises."""

    def __init__(self, servicer, service_name: str = "WorkloadManager"):
        from slurm_bridge_tpu_torch.wire.rpc import service_methods

        self.servicer = servicer
        full_name, specs = service_methods(service_name)
        self._specs = {f"/{full_name}/{m.name}": m for m in specs}
        self.calls = 0

    def _method(self, method, request_serializer, response_deserializer):
        from slurm_bridge_tpu_torch.wire.rpc import LocalContext

        spec = self._specs[method]
        fn = getattr(self.servicer, spec.name)

        def parse(req):
            return spec.req_cls.FromString(request_serializer(req))

        def answer(resp):
            return response_deserializer(
                resp if isinstance(resp, bytes) else resp.SerializeToString())

        def call(request, timeout=None, metadata=None):
            self.calls += 1
            req = (parse(r) for r in request) if spec.request_streaming else parse(request)
            resp = fn(req, LocalContext())
            return (answer(r) for r in resp) if spec.response_streaming else answer(resp)

        return call

    # grpc.Channel's four stub factories: the method's spec says which
    # sides stream
    unary_unary = unary_stream = stream_unary = stream_stream = _method

    def close(self) -> None:
        pass


@contextlib.contextmanager
def loopback_dial(servicer):
    """Within the block, the port's ``Bridge`` dials a
    :class:`LoopbackChannel` to ``servicer`` wherever it would open a grpc
    channel to its agent (``bridge/runtime.py``, the one place the bridge
    dials its agent). Yields the channels it handed out."""
    import slurm_bridge_tpu_torch.bridge.runtime as runtime

    real, channels = runtime.dial, []

    def dial(endpoint):
        channels.append(LoopbackChannel(servicer))
        return channels[-1]

    runtime.dial = dial
    try:
        yield channels
    finally:
        runtime.dial = real


def bridge_inventory(random_inventory, num_nodes: int, num_jobs: int, seed: int = 42):
    """The bridge phase's world from a package's ``random_inventory``: the
    inventory of ``num_nodes`` nodes at the headline's shape, and the first
    ``num_jobs`` demands of its ``5 × num_nodes`` jobs — the headline's
    jobs per node (50,000 on 10,000), so each job asks what a headline job
    asks (``random_inventory(10_000, 1_000)`` would spread the headline's
    load over 1,000 jobs of several hundred CPUs each, more than any node
    has)."""
    partitions, nodes, demands = random_inventory(
        num_nodes, 5 * num_nodes, seed=seed, load=HEADLINE["load"],
        gpu_fraction=HEADLINE["gpu_fraction"], gang_fraction=HEADLINE["gang_fraction"],
    )
    return partitions, nodes, demands[:num_jobs]


def fake_cluster(partitions, nodes) -> dict:
    """``cluster.json`` for the fake Slurm CLI (``tests/fakeslurm``) from
    typed inventory lists: every partition with its nodes (the first the
    default), every node with its CPUs, memory, GPUs, features, the
    allocation it starts with and its state (a drained node stays in, as
    ``DRAINED``)."""
    return {
        "partitions": {
            p.name: {"nodes": list(p.nodes), **({"default": True} if i == 0 else {})}
            for i, p in enumerate(partitions)
        },
        "nodes": {
            n.name: {"cpus": n.cpus, "memory_mb": n.memory_mb, "alloc_cpus": n.alloc_cpus,
                     "alloc_memory_mb": n.alloc_memory_mb, "gpus": n.gpus,
                     "gpu_type": n.gpu_type, "features": list(n.features), "state": n.state}
            for n in nodes
        },
    }


def job_marker(name: str) -> str:
    return f"sbt-marker-{name}"


def bridge_jobs(spec_cls, demands, result_to: str = "") -> list:
    """(name, spec) per demand, in a package's ``BridgeJobSpec``: the
    demand's partition, node count (gangs included), CPUs, memory per CPU,
    GPUs (``gres``) and priority, a script that echoes the job's marker,
    and its results fetched into ``result_to``."""
    out = []
    for j, d in enumerate(demands):
        name = f"job{j:05d}"
        out.append((name, spec_cls(
            partition=d.partition, sbatch_script=f"#!/bin/sh\necho {job_marker(name)}\n",
            nodes=d.nodes, cpus_per_task=d.cpus_per_task, mem_per_cpu_mb=d.mem_per_cpu_mb,
            gres=d.gres, priority=d.priority, result_to=result_to,
        )))
    return out


def bridge_digest(objects, store) -> str:
    """sha256 over the sizecar pods sorted by name of (name, bound node,
    placement hint): what a tick decided for every job. ``objects`` is a
    package's ``bridge.objects``."""
    h = hashlib.sha256()
    pods = [p for p in store.list(objects.Pod.KIND) if p.spec.role == objects.PodRole.SIZECAR]
    for p in sorted(pods, key=lambda p: p.meta.name):
        h.update("\x1f".join((p.meta.name, p.spec.node_name,
                              ",".join(p.spec.placement_hint))).encode() + b"\n")
    return h.hexdigest()


def bridge_first_tick(bridge, objects, jobs) -> dict:
    """The placing tick of a ``Bridge`` whose daemons have not started:
    every job submitted through ``Bridge.submit``, the operator's sweep
    creating every sizecar pod, the configurator bringing up one Ready
    virtual node per partition, then one ``scheduler.tick()`` on that fixed
    store — the only placement a digest can hold while the daemons' threads
    run. Returns the pods bound, the digest (:func:`bridge_digest`), the
    tick's route and phases."""
    for name, spec in jobs:
        bridge.submit(name, spec)
    names = [n for n, _ in jobs]
    for key in bridge.operator.sweep(names):
        bridge.operator.reconcile(key)
    sizecars = [p for p in bridge.store.list(objects.Pod.KIND)
                if p.spec.role == objects.PodRole.SIZECAR]
    require(len(sizecars) == len(jobs), f"{len(sizecars)} sizecar pods for {len(jobs)} jobs")
    bridge.configurator.reconcile()
    t0 = time.perf_counter()
    placed = bridge.scheduler.tick()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(placed=placed, digest=bridge_digest(objects, bridge.store),
                route=bridge.scheduler.last_route, wall_ms=wall_ms,
                phase_ms=dict(bridge.scheduler.last_phase_ms))


def check_feasible(snap, batch, pl) -> None:
    """Capacity, partition, features, gang all-or-nothing and distinct
    nodes within a gang."""
    placed = pl.placed
    nodes = pl.node_of[placed]
    require((nodes >= 0).all() and (nodes < snap.num_nodes).all(), "bad node id")
    used = np.zeros(snap.free.shape, np.float64)
    np.add.at(used, nodes, batch.demand[placed])
    require((used <= snap.free + 1e-3).all(), "node oversubscribed")
    jp = batch.partition_of[placed]
    require(((jp < 0) | (snap.partition_of[nodes] == jp)).all(), "wrong partition")
    rf = batch.req_features[placed]
    require(((snap.features[nodes] & rf) == rf).all(), "missing features")
    _, gang = np.unique(batch.gang_id, return_inverse=True)
    size = np.bincount(gang)
    got = np.bincount(gang, weights=placed.astype(np.float64))
    require(((got == 0) | (got == size)).all(), "gang partially placed")
    multi = placed & (size[gang] > 1)
    pairs = gang[multi].astype(np.int64) * (snap.num_nodes + 1) + pl.node_of[multi]
    require(np.unique(pairs).size == int(multi.sum()), "gang co-located")


def round_operands(snap, batch, device, seed=7):
    """One round's kernel operands of the headline solve: the snapshot's
    free capacity, a seeded price vector, the batch's demands."""
    from slurm_bridge_tpu_torch.solver.auction import resource_scale, to_device

    rng = np.random.default_rng(seed)
    scale = resource_scale(snap)
    return [
        to_device(snap.free, np.float32, device),
        to_device(snap.partition_of, np.int32, device),
        to_device(snap.features, np.int32, device),
        to_device(rng.uniform(0, 0.5, snap.num_nodes), np.float32, device),
        to_device(batch.demand, np.float32, device),
        to_device(batch.partition_of, np.int32, device),
        to_device(batch.req_features, np.int32, device),
        to_device(np.full(batch.num_shards, -1), np.int32, device),
        to_device(batch.demand * scale, np.float32, device),
        to_device(snap.free * scale, np.float32, device),
    ]


def small_operands(seed, n, p, device):
    rng = np.random.default_rng(seed)
    free = rng.uniform(0, 64, (n, 3)).astype(np.float32)
    dem = rng.uniform(0, 32, (p, 3)).astype(np.float32)
    scale = np.float32(1.0) / np.maximum(free.mean(0), 1)
    arrays = [
        free, rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 4, n).astype(np.int32),
        rng.uniform(0, 1, n).astype(np.float32), dem, rng.integers(-1, 4, p).astype(np.int32),
        rng.integers(0, 4, p).astype(np.int32),
        np.where(rng.random(p) < 0.3, rng.integers(0, n, p), -1).astype(np.int32),
        (dem * scale).astype(np.float32), (free * scale).astype(np.float32),
    ]
    return [torch.from_numpy(a).to(device) for a in arrays]


def compare(kern, args, salt, aw, n, label, live=None, got=None, jitter=1.0,
            p_base=0, n_base=0, **plain_kw):
    """Kernel vs plain on the same operands; returns the max |Δ| over
    finite values. Bit-exact at aw=0; the stated tolerance at aw≠0.
    ``got`` is the kernel's (values, choices) from a launch already made
    on these operands; without it the kernel is launched here.
    ``p_base``/``n_base`` are a sweep block's global offsets."""
    kw = dict(jitter=jitter, affinity_weight=aw, num_nodes=n, live=live)
    bv, bi = got if got is not None else kern.bid_argmax(*args, salt, p_base, n_base, **kw)
    torch.cuda.synchronize()
    pv, pi = kern.bid_argmax_plain(*args, salt, p_base, n_base, **kw, **plain_kw)
    same_idx = (bi == pi).float().mean().item()
    fin = torch.isfinite(pv)
    require(torch.equal(torch.isfinite(bv), fin), f"{label}: feasibility differs")
    err = (bv[fin] - pv[fin]).abs().max().item() if fin.any() else 0.0
    exact = torch.equal(bi, pi) and torch.equal(bv.view(torch.int32), pv.view(torch.int32))
    log(f"  {label} aw={aw}: choices equal {same_idx:.6f}, max|dv| {err:.3g}, bit-exact {exact}")
    if aw == 0.0:
        require(exact, f"{label}: kernel and plain differ at affinity_weight=0")
    else:
        require(same_idx >= 0.999 and err <= 1e-5, f"{label}: outside tolerance")
    return err


def needed_cells(node_part: np.ndarray, job_part: np.ndarray, live: np.ndarray) -> int:
    """Cells the kernel's inputs need: for each live row, the nodes of its
    partition (every node for a row of any partition)."""
    per_part = np.bincount(node_part[node_part >= 0]) if (node_part >= 0).any() else np.zeros(0, int)
    jp = job_part[live].astype(np.int64)
    known = (jp >= 0) & (jp < per_part.size)
    per_row = np.where(jp < 0, node_part.size, 0)
    per_row[known] = per_part[jp[known]]
    return int(per_row.sum())


def bounds(kern, cells: int, nbytes: int, sm_hz: float):
    """(roofline ms, what bounds it, per-pipe issue ceiling ms) for
    ``cells`` needed cells and ``nbytes`` of operands."""
    ops = kern.OPS_PER_CELL * cells
    roof_s = max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
    bound_by = "operations" if ops / ALU_OPS_PER_S > nbytes / HBM_BYTES_PER_S else "bytes"
    c = kern.CELL_OPS
    clocks_per_cell = max(
        max(c[k] / LANES_PER_CLOCK[k] for k in LANES_PER_CLOCK),
        sum(c.values()) / ISSUE_LANES_PER_CLOCK,
    )
    ceiling_s = cells * clocks_per_cell / SMS / sm_hz
    return roof_s * 1e3, bound_by, ceiling_s * 1e3


def sm_clock_mhz(busy) -> float:
    """The highest SM clock ``nvidia-smi`` samples while ``busy()`` runs."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        time.sleep(0.3)
        busy()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    vals = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    require(vals, "nvidia-smi read no SM clock")
    return max(vals)


@contextlib.contextmanager
def kernel_events(keep_operands: bool, timed: bool = True):
    """Within the block, one record per call of the kernel's wrapper by
    the auction or by the multi-device sweep's blocks. ``timed``: CUDA events around each call (behind a short
    gate, so they time the device's work: the wrapper's work list, node
    packing, scoring and finish), read into the record's ``ms`` once the
    block ends. ``keep_operands``: each call's operands, live mask and
    keywords, and a copy of what the kernel returned (``out``)."""
    import slurm_bridge_tpu_torch.solver.auction as auction_mod
    import slurm_bridge_tpu_torch.solver.sharded as sharded_mod

    real = auction_mod.bid_argmax
    calls = []

    def recorder(*args, **kw):
        rec = {}
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(GATE_CYCLES // 10)  # the gate of cuda_ms: device time only
            start.record()
        out = real(*args, **kw)
        if timed:
            stop.record()
            rec["events"] = (start, stop)
        if keep_operands:
            rec.update(args=[a.clone() for a in args[:10]], salt=args[10],
                       live=kw["live"].clone(), kw=kw, out=tuple(t.clone() for t in out))
        calls.append(rec)
        return out

    auction_mod.bid_argmax = sharded_mod.bid_argmax = recorder
    try:
        yield calls
    finally:
        auction_mod.bid_argmax = sharded_mod.bid_argmax = real
    torch.cuda.synchronize()
    for r in calls:
        if timed:
            r["ms"] = r["events"][0].elapsed_time(r["events"][1])


def compare_recorded(kern, r, label) -> float:
    """What the kernel returned in a recorded call (:func:`kernel_events`)
    against its plain version on that call's own operands, live mask and
    keywords."""
    kw = r["kw"]
    return compare(kern, r["args"], r["salt"], kw["affinity_weight"], kw["num_nodes"], label,
                   live=r["live"], got=r["out"], jitter=kw["jitter"],
                   p_base=kw.get("p_base", 0), n_base=kw.get("n_base", 0), bp=4096, bn=2048)


def instrumented_solve(snap, batch):
    """One headline ``DeviceSolver.solve`` under :func:`kernel_events`,
    keeping each round's operands and live mask. Returns (placement,
    rounds)."""
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver

    with kernel_events(keep_operands=True) as rounds:
        pl = DeviceSolver(snap, AuctionConfig(rounds=ROUNDS)).solve(batch)
    return pl, rounds


def tick_phase(kern, smi: str) -> dict:
    """Phase 5: the bridge's placement tick at full width (module
    docstring). Returns what the kernels line and the summary print."""
    from slurm_bridge_tpu_torch.bridge.objects import Pod
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.snapshot import PAD_PARTITION, random_inventory

    logging.getLogger("sbt").setLevel(logging.ERROR)  # 50k PlacementFailed lines
    partitions, nodes, demands = random_inventory(
        HEADLINE["num_nodes"], HEADLINE["num_jobs"], seed=HEADLINE["seed"],
        load=HEADLINE["load"], gpu_fraction=HEADLINE["gpu_fraction"],
        gang_fraction=HEADLINE["gang_fraction"],
    )
    client, make_store = port_tick_world(partitions, nodes, demands)

    def fresh_store():
        t0 = time.perf_counter()
        store = make_store()
        log(f"  store loaded: {len(demands)} pending sizecar pods, {len(partitions)} Ready "
            f"virtual nodes, {len(nodes)} nodes in {time.perf_counter() - t0:.2f} s")
        return store

    def run_tick(sched, store, label):
        before = kern.LAUNCHES
        t0 = time.perf_counter()
        placed = sched.tick()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = kern.LAUNCHES - before
        got = tick_digest(store.list(Pod.KIND))
        phases = ", ".join(f"{k} {v:.1f}" for k, v in sched.last_phase_ms.items())
        log(f"  {label}: route {sched.last_route}, bound {placed}, kernel launches {launches}, "
            f"digest {got[:16]}…; wall {wall_ms:.1f} ms ({phases} ms) [{smi}]")
        return dict(placed=placed, route=sched.last_route, launches=launches, digest=got,
                    wall_ms=wall_ms, phase_ms=dict(sched.last_phase_ms))

    # two headline ticks, held to the JAX package's; each kernel call's
    # operands and result kept (untimed) for the check against plain below
    store = fresh_store()
    sched = PlacementScheduler(store, client, backend="auction", inventory_ttl=0,
                               auction_config=AuctionConfig(rounds=ROUNDS, candidates=0))
    ticks = []
    for i, want in enumerate(TICK_REFERENCE):
        with kernel_events(keep_operands=True, timed=False) as calls:
            t = run_tick(sched, store, f"tick {i + 1}")
        t["calls"] = calls
        require(t["route"] == "auction", f"tick {i + 1} routed {t['route']}")
        require(t["launches"] == ROUNDS and len(calls) == ROUNDS,
                f"tick {i + 1}: {t['launches']} kernel launches")
        require(t["placed"] == want["placed"],
                f"tick {i + 1} bound {t['placed']}, the JAX package {want['placed']}")
        require(t["digest"] == want["tick_sha256"],
                f"tick {i + 1} digest {t['digest']} differs from the JAX package's")
        ticks.append(t)

    # every kernel call of both ticks against its plain version, on the
    # tick's own operands: the scheduler's padded batch (pad rows of
    # PAD_PARTITION stay live every round) and each round's live mask
    errs = []
    for i, t in enumerate(ticks):
        for j, r in enumerate(t.pop("calls")):
            p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
            errs.append(compare_recorded(kern, r, f"tick {i + 1} round {j} ({n},{p})"))
            log(f"    live rows {int(r['live'].sum())} of {p}, "
                f"pad rows {int((r['args'][5] == int(PAD_PARTITION)).sum())}")

    # the product defaults: auto routing and AuctionConfig(rounds=8), the
    # kernel's calls timed
    store = fresh_store()
    sched = PlacementScheduler(store, client, inventory_ttl=0,
                               auction_config=AuctionConfig(rounds=ROUNDS))
    with kernel_events(keep_operands=False) as calls:
        auto = run_tick(sched, store, "tick 1, backend auto (kernel timed, gates in the wall time)")
    require(auto["route"] == "auction", f"auto routed the headline tick to {auto['route']}")
    require(auto["launches"] == ROUNDS and len(calls) == ROUNDS, auto["launches"])
    require(auto["digest"] == TICK_REFERENCE[0]["tick_sha256"],
            "the auto-routed tick's digest differs from the JAX package's")
    auto["kernel_ms"] = sum(c["ms"] for c in calls)
    log(f"  tick digests and bound counts equal the JAX package's; the auto-routed tick's "
        f"kernel time {auto['kernel_ms']:.4f} ms over {len(calls)} calls, of its solve phase "
        f"{auto['phase_ms']['solve']:.1f} ms [{smi}]")
    return dict(ticks=ticks, auto=auto, errs=errs)


def pin_auction(sc):
    """The headline's engine pinned, as ``tools/port_reference.py --sim``
    pins the JAX package's run: ``backend="auction"``,
    ``AuctionConfig(rounds=8, candidates=0)``; each shard of a sharded
    scenario on the single-device auction."""
    import dataclasses

    from slurm_bridge_tpu_torch.solver import AuctionConfig

    sc = dataclasses.replace(sc, backend="auction",
                             auction_config=AuctionConfig(rounds=ROUNDS, candidates=0))
    if sc.sharding is not None:
        sc = dataclasses.replace(sc, sharding=dataclasses.replace(sc.sharding, device_solve=False))
    return sc


def run_sim(kern, smi: str, sc, label: str, keep=(), deadline_s: float | None = None):
    """One scenario through ``SimHarness`` on the card, counting each
    tick's kernel launches and solves and noting which scheduler ran it
    (a restart builds a new one); the kernel calls of the ticks in
    ``keep`` are kept (operands and results, untimed). Prints each tick's
    phases. With ``deadline_s``, a tick that ends more than that many
    seconds after the harness was built fails the run. Returns (result,
    ticks, {tick: calls}, wall seconds)."""
    from slurm_bridge_tpu_torch.sim.harness import PHASES, SimHarness

    t_built = time.perf_counter()
    h = SimHarness(sc, device="cuda")
    ticks, kept = [], {}
    real = h.run_tick

    def counted(tick, **kw):
        before, sched = kern.LAUNCHES, h.scheduler
        solves0 = sched.solves_total
        if tick in keep:
            with kernel_events(keep_operands=True, timed=False) as calls:
                phases = real(tick, **kw)
            kept[tick] = calls
        else:
            phases = real(tick, **kw)
        # a crash at this tick's boundary replaced the scheduler, whose
        # solve count starts from zero
        restarted = h.scheduler is not sched
        solves = h.scheduler.solves_total - (0 if restarted else solves0)
        ticks.append(dict(launches=kern.LAUNCHES - before, solves=solves, phases=phases,
                          restarted=restarted))
        if deadline_s is not None:
            spent = time.perf_counter() - t_built
            require(spent <= deadline_s,
                    f"{label}: tick {tick} ended {spent:.1f} s in, past the {deadline_s} s deadline")
        return phases

    h.run_tick = counted
    t0 = time.perf_counter()
    result = h.run()
    wall_s = time.perf_counter() - t0
    for i, t in enumerate(ticks):
        ph = t["phases"]
        log(f"  {label} tick {i}: {ph['tick']:.1f} ms ("
            + ", ".join(f"{k} {ph.get(k, 0.0):.1f}" for k in PHASES)
            + f" ms), solves {t['solves']}, kernel launches {t['launches']} [{smi}]")
    return result, ticks, kept, wall_s


def sim_phase(kern, smi: str) -> dict:
    """Phase 6: the bridge's job lifecycle on the simulated cluster at
    full width (module docstring). Returns what the kernels line and the
    summary print."""
    import dataclasses

    import slurm_bridge_tpu_torch.bridge.vnode as vnode
    from slurm_bridge_tpu_torch.sim.scenarios import full_50kx10k
    from slurm_bridge_tpu_torch.wire import coldec

    require(coldec.available(), "the column decoder's tables do not match the port's schema")

    counters = (coldec.rows_counter(), coldec.fallback_counter(), vnode._submit_pool_chunks)
    before = [c.total() for c in counters]
    pinned = pin_auction(full_50kx10k(scale=1.0))
    require((pinned.cluster.num_nodes, pinned.workload.jobs, pinned.ticks) == (10_000, 50_000, 3),
            "full_50kx10k is not at full width")
    result, ticks, kept, wall_s = run_sim(kern, smi, pinned, "full_50kx10k", keep=(0,))
    tick0 = kept.get(0, [])
    rows, fallbacks, pool_chunks = (c.total() - b for c, b in zip(counters, before))
    d = result.determinism
    log(f"  digest {d['digest'][:16]}…, final state {d['final_state_digest'][:16]}…, "
        f"bound {d['bound_total']}, violations {len(d['invariant_violations'])}; "
        f"coldec rows {rows:.0f}, fallbacks {fallbacks:.0f}, pool submit chunks {pool_chunks:.0f}; "
        f"tick p50 {result.timing['tick_p50_ms']:.1f} ms, phase wall {wall_s:.1f} s [{smi}]")
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    for key in ("digest", "final_state_digest", "bound_total"):
        require(d[key] == SIM_REFERENCE[key],
                f"full_50kx10k {key} {d[key]} differs from the JAX package's {SIM_REFERENCE[key]}")
    require(rows > 0 and fallbacks == 0, f"the bytes path did not carry the mirror ({rows}, {fallbacks})")
    require(pool_chunks > 0, "no submit chunk went through the forked worker pool")
    require(ticks[0]["solves"] >= 1, "tick 0 did not solve")
    for i, t in enumerate(ticks):
        require(t["launches"] == ROUNDS * t["solves"],
                f"tick {i}: {t['launches']} kernel launches for {t['solves']} solves")
    require(len(tick0) == ROUNDS * ticks[0]["solves"], f"{len(tick0)} kernel calls kept on tick 0")
    errs = []
    for j, r in enumerate(tick0):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(kern, r, f"sim tick 0 call {j} ({n},{p})"))

    auto, auto_ticks, _, auto_s = run_sim(kern, smi,
                                          dataclasses.replace(full_50kx10k(scale=1.0), ticks=1),
                                          "full_50kx10k, backend auto, 1 tick")
    auto_launches = sum(t["launches"] for t in auto_ticks)
    require(auto_launches > 0, "the auto-routed run never reached the card")
    require(auto.determinism["invariant_violations"] == [], "violations in the auto-routed run")
    log(f"  auto route: kernel launches {auto_launches}, bound {auto.determinism['bound_total']} "
        f"after 1 tick (the JAX package's native-routed 3-tick run binds {SIM_NATIVE_BOUND}); "
        f"{auto_s:.1f} s [{smi}]")
    return dict(result=result, ticks=ticks, errs=errs, wall_s=wall_s,
                auto_launches=auto_launches)


def crash_phase(kern, smi: str) -> dict:
    """Phase 7: recovery at full width (module docstring). Returns what
    the kernels line and the summary print."""
    from slurm_bridge_tpu_torch.sim.scenarios import full_50kx10k_crash

    sc = pin_auction(full_50kx10k_crash(scale=1.0))
    require((sc.cluster.num_nodes, sc.workload.jobs, sc.ticks) == (10_000, 50_000, 4),
            "full_50kx10k_crash is not at full width")
    crash_tick = sc.faults.faults[0].start_tick
    result, ticks, kept, wall_s = run_sim(kern, smi, sc, "full_50kx10k_crash",
                                          keep=range(crash_tick, sc.ticks))
    d, tm = result.determinism, result.timing
    log(f"  digest {d['digest'][:16]}…, final state {d['final_state_digest'][:16]}…, "
        f"bound {d['bound_total']}, restarts {d['restarts']}, restored objects "
        f"{d['restored_objects']}, violations {len(d['invariant_violations'])}, virtual-node "
        f"deletions {d['vnode_deletions']}; recovery_ms {tm['recovery_ms']}, wal_records "
        f"{tm['wal_records_total']}, snapshots {tm['wal_snapshots_total']}, WAL flush after "
        f"each tick p50 {tm['wal_flush_p50_ms']:.1f} / p95 {tm['wal_flush_p95_ms']:.1f} ms "
        f"(outside the tick clock); tick p50 "
        f"{tm['tick_p50_ms']:.1f} ms, phase wall {wall_s:.1f} s [{smi}]")
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    require(d["vnode_deletions"] == 0, f"{d['vnode_deletions']} virtual nodes deleted")
    for key, want in CRASH_REFERENCE.items():
        require(d[key] == want, f"full_50kx10k_crash {key} {d[key]} differs from the JAX "
                                f"package's {want}")
    require([t["restarted"] for t in ticks] == [i == crash_tick for i in range(sc.ticks)],
            "the bridge did not restart exactly at the crash tick")
    require(ticks[0]["solves"] >= 1, "tick 0 did not solve")
    for i, t in enumerate(ticks):
        require(t["launches"] == ROUNDS * t["solves"],
                f"tick {i}: {t['launches']} kernel launches for {t['solves']} solves")
    # the restarted scheduler's first solve: a fresh DeviceSolver over the
    # reloaded store, each of its kernel calls against the plain version
    first = next((i for i in range(crash_tick, sc.ticks) if ticks[i]["solves"]), None)
    require(first is not None, "no solve after the restart")
    calls = kept[first][:ROUNDS]
    require(len(calls) == ROUNDS, f"{len(calls)} kernel calls in the first post-restart solve")
    errs = []
    for j, r in enumerate(calls):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(kern, r, f"post-restart tick {first} call {j} ({n},{p})"))
    return dict(result=result, ticks=ticks, errs=errs, wall_s=wall_s, first=first)


def shard_phase(kern, smi: str, sm_hz: float) -> dict:
    """Phase 8: the sharded tick at the headline's full size (module
    docstring); ``sm_hz`` is phase 3's SM clock, for the timed solves'
    issue ceiling. Returns what the kernels line and the summary print."""
    import resource

    import slurm_bridge_tpu_torch.solver.session as session
    from slurm_bridge_tpu_torch.sim.scenarios import full_500kx100k

    sc = pin_auction(full_500kx100k(scale=1.0))
    require((sc.cluster.num_nodes, sc.cluster.num_partitions, sc.workload.jobs, sc.ticks)
            == (100_000, 16, 500_000, 3), "full_500kx100k is not at full size")
    require((sc.sharding.max_nodes_per_shard, sc.sharding.workers) == (8192, 2), sc.sharding)
    solves = []
    real_solve = session.DeviceSolver.solve

    def timed_solve(self, batch, *a, **kw):
        # every shard's solve, serialised under the executor's device lock
        before, t0 = kern.LAUNCHES, time.perf_counter()
        out = real_solve(self, batch, *a, **kw)
        solves.append(dict(rows=batch.num_shards, nodes=self.snapshot.num_nodes,
                           launches=kern.LAUNCHES - before,
                           ms=(time.perf_counter() - t0) * 1e3))
        return out

    torch.cuda.reset_peak_memory_stats()
    session.DeviceSolver.solve = timed_solve
    try:
        result, ticks, kept, wall_s = run_sim(kern, smi, sc, "full_500kx100k", keep=(0,),
                                              deadline_s=SHARD_DEADLINE_S)
    finally:
        session.DeviceSolver.solve = real_solve
    # the main path's launches and memory, read before the checks below
    # launch the kernel again
    launches = kern.LAUNCHES
    device_peak = torch.cuda.max_memory_allocated()
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    d, tm, fr = result.determinism, result.timing, result.flight_record
    shard = d["shard"]
    # tick 0 solves every shard once (every partition holds front-loaded
    # jobs): its solves' node counts are the plan's shard sizes
    sizes = sorted((sv["nodes"] for sv in solves[:ticks[0]["launches"] // ROUNDS]), reverse=True)
    log(f"  plan: {len(sizes)} shards of {sizes} nodes [{smi}]")
    for i, sv in enumerate(solves):
        log(f"  shard solve {i}: {sv['rows']} rows x {sv['nodes']} nodes, kernel launches "
            f"{sv['launches']}, {sv['ms']:.1f} ms [{smi}]")
    span, phase_sum = fr.get("tick_span_p50_ms") or 0.0, fr.get("phase_sum_p50_ms") or 0.0
    drift = abs(span - phase_sum) / span * 100.0 if span > 0 else float("nan")
    log(f"  digest {d['digest'][:16]}…, final state {d['final_state_digest'][:16]}…, "
        f"bound {d['bound_total']}, shards {shard['shard_count']}, reconcile placed "
        f"{shard['reconcile_placed']}, violations {len(d['invariant_violations'])}; tick p50 "
        f"{tm['tick_p50_ms']:.1f} ms (the scenario's gate {sc.p50_gate_ms:.0f} ms), phase sum "
        f"{phase_sum:.1f} ms vs tick span {span:.1f} ms p50: drift {drift:.2f} % (gate "
        f"±{sc.phase_reconcile_pct} %); phase wall {wall_s:.1f} s; device memory peak "
        f"{device_peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated), host peak RSS "
        f"{host_peak / 2**20:.0f} MiB [{smi}]")
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    require(shard["shard_count"] >= 2, f"the plan has {shard['shard_count']} shard(s)")
    for key, want in SHARD_REFERENCE.items():
        got = shard[key] if key in shard else d[key]
        require(got == want, f"full_500kx100k {key} {got} differs from the JAX package's {want}")
    require(len(solves) >= 2, f"{len(solves)} shard solves")
    require(all(sv["launches"] == ROUNDS for sv in solves),
            f"shard solves launched {[sv['launches'] for sv in solves]} kernels")
    require(sum(t["launches"] for t in ticks) == ROUNDS * len(solves),
            "kernel launches outside the shard solves")
    require(len(sizes) == shard["shard_count"] and sum(sizes) == sc.cluster.num_nodes,
            f"tick 0 solved shards of {sizes} nodes, of a plan of {shard['shard_count']}")
    calls = kept[0]
    require(calls and len(calls) == ticks[0]["launches"] and len(calls) % ROUNDS == 0,
            f"{len(calls)} kernel calls kept on tick 0 of {ticks[0]['launches']} launches")
    # every kernel call of tick 0 against the plain version on its own
    # operands and live mask; then each call of the first shard solve and
    # of the largest (the most cells its round 0 needs) timed again on
    # those operands (after the counts were read)
    errs = []
    for j, r in enumerate(calls):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(
            kern, r, f"shard solve {j // ROUNDS} of tick 0, round {j % ROUNDS} ({n},{p})"))
    tick0 = [calls[k:k + ROUNDS] for k in range(0, len(calls), ROUNDS)]

    def round0_cells(k):
        r = tick0[k][0]
        return needed_cells(r["args"][1].cpu().numpy(), r["args"][5].cpu().numpy(),
                            r["live"].cpu().numpy())

    held = sorted({0, max(range(len(tick0)), key=round0_cells)})
    kernel = []
    for k in held:
        t = time_calls(kern, tick0[k], f"shard solve {k} of tick 0", smi)
        r0 = tick0[k][0]
        p, n = r0["args"][4].shape[0], r0["kw"]["num_nodes"]
        # each call's operands and live mask read, its outputs written
        nbytes = sum(a.numel() * a.element_size() for a in r0["args"]) + 9 * p
        t["bound_ms"], t["bound_by"], t["ceiling_ms"] = bounds(kern, t["cells"], ROUNDS * nbytes,
                                                               sm_hz)
        log(f"  shard solve {k} of tick 0 ({n},{p}): kernel {t['ms_per_solve']:.4f} ms per solve, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), issue ceiling {t['ceiling_ms']:.4f} ms "
            f"[{smi}]")
        kernel.append(t)
    return dict(result=result, ticks=ticks, solves=solves, errs=errs, wall_s=wall_s,
                kernel=kernel, held=held, launches=launches, sizes=sizes,
                device_peak=device_peak, host_peak=host_peak, drift=drift,
                p50_gate_ms=sc.p50_gate_ms, drift_gate=sc.phase_reconcile_pct)


def churn_phase(kern, smi: str) -> dict:
    """Phase 9: the streaming reschedule at full width (module
    docstring). Returns what the kernels line and the summary print."""
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.streaming import churn_scenario, churn_step

    sim = churn_scenario(**CHURN)
    sim.config = AuctionConfig(rounds=ROUNDS)
    sim.engine = "device"
    rng = np.random.default_rng(0)
    # each tick's re-solve (sim.tick: stage, pad, solve, keep) timed apart
    # from the churn around it (departures, arrivals)
    real_tick, solve_ms = sim.tick, []

    def timed_tick():
        t0 = time.perf_counter()
        out = real_tick()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    sim.tick = timed_tick
    ticks, first_churn = [], []
    for i, want in enumerate(CHURN_REFERENCE):
        before, t0 = kern.LAUNCHES, time.perf_counter()
        # tick 1, the first whose rows are mostly pinned incumbents: every
        # kernel call kept with its operands for the check against plain
        with kernel_events(keep_operands=i == 1, timed=False) as calls:
            res = churn_tick(sim, churn_step, rng, i)
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = churn_summary(res)
        t = dict(got, launches=kern.LAUNCHES - before, wall_ms=wall_ms, solve_ms=solve_ms[-1],
                 rows=int(res.placement.node_of.size), pinned=int(res.incumbent.sum()))
        log(f"  churn tick {i}: rows {t['rows']}, pinned {t['pinned']}, kept {t['kept']}, "
            f"preempted {t['preempted']}, started {t['started']}, stability "
            f"{t['stability']:.6f}, kernel launches {t['launches']}, digest "
            f"{got['node_of_sha256'][:16]}…; tick {wall_ms:.1f} ms, re-solve "
            f"{solve_ms[-1]:.1f} ms [{smi}]")
        require(sim.last_engine == "device", f"churn tick {i} ran {sim.last_engine}")
        require(t["launches"] == ROUNDS, f"churn tick {i}: {t['launches']} kernel launches")
        require(got == want, f"churn tick {i} {got} differs from the JAX package's {want}")
        if i == 1:
            first_churn = calls
        ticks.append(t)
    require(ticks[1]["pinned"] * 2 > ticks[1]["rows"], "churn tick 1 is not mostly pinned")
    require(len(first_churn) == ROUNDS, f"{len(first_churn)} kernel calls kept on churn tick 1")
    errs = []
    for j, r in enumerate(first_churn):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(kern, r, f"churn tick 1 call {j} ({n},{p})"))
        log(f"    live rows {int(r['live'].sum())} of {p}, pinned rows "
            f"{int((r['args'][7] >= 0).sum())}")
    # the product default: the production routing rule picks the engine
    sim.engine = "auto"
    before, t0 = kern.LAUNCHES, time.perf_counter()
    auto = churn_step(sim, rng, CHURN_JOBS)
    auto_wall = (time.perf_counter() - t0) * 1e3
    auto_launches = kern.LAUNCHES - before
    require(auto_launches == (ROUNDS if sim.last_engine == "device" else 0),
            f"auto tick on {sim.last_engine}: {auto_launches} kernel launches")
    log(f"  churn tick, engine auto: route {sim.last_engine}, kernel launches {auto_launches}, "
        f"stability {auto.stability:.6f}, preempted {int(auto.preempted.sum())}; tick "
        f"{auto_wall:.1f} ms, re-solve {solve_ms[-1]:.1f} ms [{smi}]")
    churn_ms = [t["wall_ms"] for t in ticks[1:]]
    p50 = statistics.median(churn_ms)
    log(f"  digests, kept/preempted/started and stability equal the JAX package's on all "
        f"{len(ticks)} ticks; churn tick p50 {p50:.1f} ms, re-solve ms "
        f"{[round(t['solve_ms'], 1) for t in ticks]} [{smi}]")
    # the main path's launches, read before the timing below adds its own
    launches = kern.LAUNCHES
    kernel = time_calls(kern, first_churn, "churn tick 1", smi)
    return dict(ticks=ticks, errs=errs, p50_ms=p50, auto_route=sim.last_engine,
                auto_launches=auto_launches, launches=launches, kernel=kernel)


def sidecar_phase(kern, smi: str) -> dict:
    """Phase 10: the placement-solver sidecar in process (module
    docstring). Returns what the kernels line and the summary print."""
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.service import PlacementSolverServicer
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory
    from slurm_bridge_tpu_torch.wire import convert, pb
    from slurm_bridge_tpu_torch.wire.rpc import LocalContext

    partitions, nodes, demands = random_inventory(
        HEADLINE["num_nodes"], HEADLINE["num_jobs"], seed=HEADLINE["seed"],
        load=HEADLINE["load"], gpu_fraction=HEADLINE["gpu_fraction"],
        gang_fraction=HEADLINE["gang_fraction"],
    )
    t0 = time.perf_counter()
    raw = place_request(pb, convert, partitions, nodes, demands).SerializeToString()
    t1 = time.perf_counter()
    request = pb.PlaceRequest.FromString(raw)
    log(f"  PlaceRequest: {len(request.jobs)} jobs, {len(request.inventory)} nodes, "
        f"{len(raw)} bytes; encoded in {(t1 - t0) * 1e3:.1f} ms, parsed back in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    servicer = PlacementSolverServicer(AuctionConfig(rounds=ROUNDS))
    info = servicer.SolverInfo(pb.SolverInfoRequest(), LocalContext())
    log(f"  SolverInfo: backend {info.backend}, devices {info.devices}, mesh "
        f"{info.mesh!r}, solvers {list(info.solvers)}")
    require((info.backend, info.devices, info.mesh) == ("cuda", 1, ""),
            f"SolverInfo reports {info.backend}/{info.devices}/{info.mesh!r}")
    places, session, resp = [], None, None
    for i, want in enumerate(PLACE_REFERENCE["places"]):
        if i:
            drained = busiest_node(resp)
            require(drained == PLACE_REFERENCE["drained"],
                    f"busiest node {drained}, the JAX package's {PLACE_REFERENCE['drained']}")
            request = drained_request(pb, request, drained)
        before, t0 = kern.LAUNCHES, time.perf_counter()
        with kernel_events(keep_operands=i == 0, timed=False) as calls:
            resp = servicer.Place(request, LocalContext())
        wall_ms = (time.perf_counter() - t0) * 1e3
        t = dict(launches=kern.LAUNCHES - before, wall_ms=wall_ms, solve_ms=resp.solve_ms,
                 placed=resp.placed, place_sha256=place_digest(resp),
                 response_sha256=response_digest(pb, resp), calls=calls)
        log(f"  Place {i}{' (node ' + drained + ' drained)' if i else ''}: solver "
            f"{resp.solver}, placed {resp.placed}/{resp.total} jobs, kernel launches "
            f"{t['launches']}, assignment digest {t['place_sha256'][:16]}…, response bytes "
            f"equal the JAX package's: {t['response_sha256'] == want['response_sha256']}; "
            f"Place {wall_ms:.1f} ms, of it solve {resp.solve_ms:.1f} ms [{smi}]")
        require(resp.solver == "auction", f"Place {i} ran {resp.solver}")
        require(t["launches"] == ROUNDS, f"Place {i}: {t['launches']} kernel launches")
        require((t["placed"], t["place_sha256"]) == (want["placed"], want["place_sha256"]),
                f"Place {i}'s assignments differ from the JAX package's")
        require(t["response_sha256"] == want["response_sha256"],
                f"Place {i}'s response bytes differ from the JAX package's")
        if i:
            require(not any(drained in a.node_names for a in resp.assignments),
                    "the drained node still got a shard")
            require(list(servicer._sessions.values()) == [session],
                    "the drained Place did not reuse the cached session")
        else:
            require(len(servicer._sessions) == 1, f"{len(servicer._sessions)} sessions")
            session = next(iter(servicer._sessions.values()))
        places.append(t)
    errs = []
    calls = places[0].pop("calls")
    for j, r in enumerate(calls):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(kern, r, f"Place 0 call {j} ({n},{p})"))
    places[1].pop("calls")
    # the main path's launches, read before the timing below adds its own
    launches = kern.LAUNCHES
    kernel = time_calls(kern, calls, "Place 0", smi)
    return dict(places=places, errs=errs, launches=launches, kernel=kernel)


def kubelet_log(port: int, pod: str) -> bytes:
    """A pod's log read over the kubelet HTTP API (``bridge/vkhttp.py``):
    ``GET /containerLogs/default/<pod>/main``, chunked."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", f"/containerLogs/default/{pod}/main")
        resp = conn.getresponse()
        body = resp.read()
        require(resp.status == 200, f"kubelet log of {pod}: HTTP {resp.status} {body[:200]!r}")
        return body
    finally:
        conn.close()


def bridge_phase(kern, smi: str) -> dict:
    """Phase 11: the bridge's daemons over the fake Slurm CLI at the
    headline inventory's width (module docstring). Returns what the
    kernels line and the summary print."""
    import os
    import pathlib
    import shutil
    import tempfile

    import slurm_bridge_tpu_torch.bridge.objects as objects
    from slurm_bridge_tpu_torch.agent import SlurmClient, WorkloadServicer
    from slurm_bridge_tpu_torch.bridge import Bridge, BridgeJobSpec, FetchState, JobState
    from slurm_bridge_tpu_torch.bridge.operator import sizecar_name
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory

    fakeslurm = pathlib.Path(__file__).resolve().parent / "tests" / "fakeslurm"
    require((fakeslurm / "sbatch").is_file(), f"no fake Slurm CLI at {fakeslurm}")
    tmp = tempfile.mkdtemp(prefix="sbt-daemons-")
    state, results = os.path.join(tmp, "state"), os.path.join(tmp, "results")
    os.makedirs(state)
    partitions, nodes, demands = bridge_inventory(random_inventory, BRIDGE["num_nodes"],
                                                  BRIDGE["num_jobs"])
    with open(os.path.join(state, "cluster.json"), "w") as f:
        json.dump(fake_cluster(partitions, nodes), f)
    saved_env = {k: os.environ.get(k) for k in ("SBT_FAKESLURM_STATE", "PATH")}
    os.environ["SBT_FAKESLURM_STATE"] = state
    os.environ["PATH"] = f"{fakeslurm}{os.pathsep}{os.environ['PATH']}"
    jobs = bridge_jobs(BridgeJobSpec, demands, results)
    log(f"  fake Slurm: {len(nodes)} nodes in {len(partitions)} partitions "
        f"({sum(n.state == 'DRAINED' for n in nodes)} drained), {len(jobs)} jobs "
        f"({sum(d.nodes > 1 for d in demands)} gangs, {sum(bool(d.gres) for d in demands)} "
        f"asking GPUs)")
    log("  transport loopback (no grpc on this machine)")
    servicer = WorkloadServicer(SlurmClient(), tail_poll_interval=0.02)
    bridge = None
    try:
        with loopback_dial(servicer) as channels:
            bridge = Bridge("loopback", scheduler_backend="auction",
                            auction_config=AuctionConfig(rounds=ROUNDS, candidates=0),
                            kubelet_port=0)
        require(len(channels) == 1, f"{len(channels)} channels dialled")
        t_submit = time.perf_counter()
        before = kern.LAUNCHES
        with kernel_events(keep_operands=True, timed=False) as calls:
            tick = bridge_first_tick(bridge, objects, jobs)
        tick["launches"] = kern.LAUNCHES - before
        phases = ", ".join(f"{k} {v:.1f}" for k, v in tick["phase_ms"].items())
        log(f"  placing tick: route {tick['route']}, bound {tick['placed']}/{len(jobs)}, kernel "
            f"launches {tick['launches']}, digest {tick['digest'][:16]}…; wall "
            f"{tick['wall_ms']:.1f} ms ({phases} ms) [{smi}]")
        require(tick["route"] == "auction", f"the placing tick routed {tick['route']}")
        require(tick["launches"] == ROUNDS and len(calls) == ROUNDS,
                f"{tick['launches']} kernel launches in the placing tick")
        require(tick["placed"] == BRIDGE_REFERENCE["placed"],
                f"bound {tick['placed']}, the JAX package {BRIDGE_REFERENCE['placed']}")
        require(tick["digest"] == BRIDGE_REFERENCE["bridge_sha256"],
                f"placing tick digest {tick['digest']} differs from the JAX package's")

        # the daemons: operator, configurator and providers, scheduler
        # ticker, fetch worker, kubelet server and the admission pump
        bridge.start()
        done_at, next_note = {}, time.perf_counter() + 15
        deadline = time.perf_counter() + BRIDGE_DEADLINE_S
        while len(done_at) < len(jobs):
            require(time.perf_counter() < deadline,
                    f"{len(done_at)}/{len(jobs)} jobs done after {BRIDGE_DEADLINE_S} s")
            now = time.perf_counter()
            for job in bridge.list():
                st = job.status
                if job.meta.name in done_at:
                    continue
                require(st.state != JobState.FAILED, f"job {job.meta.name} failed")
                if st.state == JobState.SUCCEEDED and st.fetch_result in (
                        FetchState.SUCCEEDED, FetchState.FAILED):
                    require(st.fetch_result == FetchState.SUCCEEDED,
                            f"job {job.meta.name}'s stdout fetch failed")
                    done_at[job.meta.name] = now
            if now >= next_note:
                log(f"    {now - t_submit:.0f} s: {len(done_at)}/{len(jobs)} jobs succeeded "
                    f"and fetched")
                next_note = now + 15
            time.sleep(0.1)
        wall_s = max(done_at.values()) - t_submit
        fetched = os.listdir(results)
        for name, _ in jobs:
            files = [f for f in fetched if f.startswith(f"{name}-")]
            require(files, f"no fetched stdout for {name}")
            with open(os.path.join(results, files[0])) as f:
                require(job_marker(name) in f.read(), f"{name}'s fetched stdout lacks its marker")
        log(f"  every job Succeeded with its stdout fetched (marker checked): "
            f"{wall_s:.1f} s from the first submit to the last [{smi}]")

        name = jobs[0][0]
        body = kubelet_log(bridge.kubelet_server.port, sizecar_name(name))
        require(job_marker(name).encode() in body, f"kubelet log of {name} lacks its marker")
        log(f"  kubelet server on 127.0.0.1:{bridge.kubelet_server.port}: "
            f"/containerLogs/default/{sizecar_name(name)}/main holds {job_marker(name)!r}; "
            f"{channels[0].calls} loopback calls")
    finally:
        if bridge is not None:
            bridge.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    # the main path's launches, read before the checks below add their own
    launches = kern.LAUNCHES
    errs = []
    for j, r in enumerate(calls):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(kern, r, f"bridge tick call {j} ({n},{p})"))
    kernel = time_calls(kern, calls, "bridge tick", smi)
    return dict(tick=tick, wall_s=wall_s, errs=errs, launches=launches, kernel=kernel)


def time_calls(kern, calls, label: str, smi: str) -> dict:
    """Each recorded kernel call of one solve timed again on its own
    operands and live mask (gated CUDA events), beside the cells its live
    rows need. Returns the solve's kernel ms and needed cells."""
    ms_total, cells_total, pinned_total = 0.0, 0, 0
    for j, r in enumerate(calls):
        kw = dict(r["kw"], live=r["live"])
        ms = cuda_ms(lambda: kern.bid_argmax(*r["args"], r["salt"], **kw), 5)
        node_part, job_part = r["args"][1].cpu().numpy(), r["args"][5].cpu().numpy()
        live = r["live"].cpu().numpy()
        pinned = live & (r["args"][7].cpu().numpy() >= 0)
        cells = needed_cells(node_part, job_part, live)
        # a pinned row can place only on the node it holds: one cell
        # decides it, though the kernel scans its partition masked
        pinned_cells = cells - needed_cells(node_part, job_part, live & ~pinned)
        ms_total += ms
        cells_total += cells
        pinned_total += pinned_cells - int(pinned.sum())
        log(f"  {label} call {j}: live rows {int(live.sum())} ({int(pinned.sum())} pinned), "
            f"needed cells {cells} ({pinned_cells} of them pinned rows'), kernel {ms:.4f} ms "
            f"[{smi}]")
    log(f"  {label}: kernel {ms_total:.4f} ms per solve over {len(calls)} calls, "
        f"{cells_total} needed cells ({ms_total * 1e9 / max(cells_total, 1):.2f} ps per "
        f"cell), {pinned_total} of them cells a pinned row scans beyond its own node [{smi}]")
    return dict(ms_per_solve=ms_total, cells=cells_total, pinned_extra_cells=pinned_total)


@contextlib.contextmanager
def combine_times(sharded_mod, device: bool = True):
    """Within the block, the time in ms of each call of the sweep's
    per-round combine and gathers (``combine_blocks``): with ``device``,
    its device time from CUDA events behind the gate of
    :func:`kernel_events`; else its host time up to a synchronize (a rank
    whose "dp" gather crosses the group stages through host memory). The
    list fills once the block ends."""
    real = sharded_mod.combine_blocks
    events, host_ms = [], []

    def timed(*args, **kw):
        if not device:
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(GATE_CYCLES // 10)
        start.record()
        out = real(*args, **kw)
        stop.record()
        events.append((start, stop))
        return out

    sharded_mod.combine_blocks = timed
    ms = []
    try:
        yield ms
    finally:
        sharded_mod.combine_blocks = real
    torch.cuda.synchronize()
    ms.extend(host_ms + [a.elapsed_time(b) for a, b in events])


def sweep_rank(rank: int, port: int, device: str) -> int:
    """One of phase [12]'s two ranks (``chip_smoke.py --sweep-rank RANK
    PORT DEVICE``): joins a gloo group of two on ``127.0.0.1:PORT``, takes
    one dp row of :data:`SWEEP`'s grid — its mp blocks on DEVICE — and runs
    the headline sweep twice. Prints one JSON object: its grid, launches,
    wall and ``node_of`` digest per solve and the host time of each
    round's combine and gathers (the "dp" gather crosses the group)."""
    import slurm_bridge_tpu_torch.ops.bid_argmax as kern
    import slurm_bridge_tpu_torch.solver.sharded as sharded_mod
    from slurm_bridge_tpu_torch.parallel.distributed import hybrid_solver_mesh, init_distributed
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

    dev = torch.device(device)
    require(init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo"),
            "init_distributed made no group")
    grid = hybrid_solver_mesh(devices=[dev] * SWEEP["mp"])
    require(grid.shape == SWEEP and grid.local_rows(rank) == [rank], grid)
    snap, batch = random_scenario(**HEADLINE)
    solves = []
    with combine_times(sharded_mod, device=False) as combine_ms:
        for _ in range(2):
            kern.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pl = sharded_mod.sharded_place(snap, batch,
                                           AuctionConfig(rounds=ROUNDS, candidates=0),
                                           mesh=grid, device=dev.type)
            solves.append(dict(launches=kern.LAUNCHES, wall_ms=(time.perf_counter() - t0) * 1e3,
                               placed=int(pl.placed.sum()), digest=digest(pl.node_of)))
    backend = torch.distributed.get_backend()
    # every rank past its last collective before either tears down
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps(dict(rank=rank, shape=grid.shape, backend=backend, solves=solves,
                          combine_ms=combine_ms)), flush=True)
    return 0


def sweep_phase(kern, smi: str, snap, batch, single_shards: int, sm_hz: float,
                dev=torch.device("cuda", 0)) -> dict:
    """Phase [12]: the multi-device sweep on one card (module docstring),
    its blocks on ``dev``. Returns what the kernels line and the summary
    print."""
    import slurm_bridge_tpu_torch.solver.sharded as sharded_mod
    from slurm_bridge_tpu_torch.bridge.objects import Pod
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu_torch.parallel.mesh import solver_mesh
    from slurm_bridge_tpu_torch.solver import AuctionConfig
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory

    grid = solver_mesh([dev] * (SWEEP["dp"] * SWEEP["mp"]), **SWEEP)
    blocks = grid.devices.size
    cfg = AuctionConfig(rounds=ROUNDS, candidates=0)
    per_solve = ROUNDS * blocks

    # (a) the headline on a 2x2 grid of cuda:0 blocks: one instrumented
    # solve (each block call's operands kept, the kernel timed), three
    # timed solves, then one with the combine timed (its first calls in the
    # process load their kernels: a cost of the first solve alone)
    log(f"  (a) {SWEEP['dp']}x{SWEEP['mp']} grid of {dev} blocks, "
        f"{batch.num_shards} shards x {snap.num_nodes} nodes")
    before = kern.LAUNCHES
    with kernel_events(keep_operands=True) as calls:
        inst = sharded_mod.sharded_place(snap, batch, cfg, mesh=grid, device=dev.type)
    path_launches = kern.LAUNCHES - before  # the sweep's own, not the timing's below
    require(path_launches == per_solve and len(calls) == per_solve,
            f"{path_launches} kernel launches in the sweep ({per_solve} wanted)")
    solve_launches = [path_launches]  # each solve's count, as read
    errs, cells = [], []
    for j, r in enumerate(calls):
        kw = r["kw"]
        node_part = r["args"][1].cpu().numpy()
        node_part = np.where(node_part == 2**30, -1, node_part)  # pad nodes need no cell
        cells.append(needed_cells(node_part, r["args"][5].cpu().numpy(), r["live"].cpu().numpy()))
        rnd = j // blocks
        label = (f"sweep round {rnd} block p_base {kw['p_base']} n_base {kw['n_base']} "
                 f"({r['args'][0].shape[0]},{r['args'][4].shape[0]})")
        if rnd in (0, ROUNDS - 1):
            errs.append(compare_recorded(kern, r, label))
        log(f"    {label}: live rows {int(r['live'].sum())}, needed cells {cells[-1]}, "
            f"kernel {r['ms']:.4f} ms in the solve [{smi}]")
    kernel_ms = [r["ms"] for r in calls]
    ms_per_solve = sum(kernel_ms)
    r0 = calls[0]
    kw0 = dict(r0["kw"], live=None)
    block_ms = cuda_ms(lambda: kern.bid_argmax(*r0["args"], r0["salt"], **kw0), 20)
    nbytes = sum(a.numel() * a.element_size() for a in r0["args"]) + 9 * r0["args"][4].shape[0]
    block_cells = needed_cells(np.where(r0["args"][1].cpu().numpy() == 2**30, -1,
                                        r0["args"][1].cpu().numpy()),
                               r0["args"][5].cpu().numpy(), np.ones(r0["args"][4].shape[0], bool))
    block_bound, block_bound_by, block_ceiling = bounds(kern, block_cells, nbytes, sm_hz)
    solve_bound, _, solve_ceiling = bounds(kern, sum(cells), per_solve * nbytes, sm_hz)
    walls, outs = [], []
    for _ in range(3):
        before = kern.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sharded_mod.sharded_place(snap, batch, cfg, mesh=grid, device=dev.type))
        walls.append((time.perf_counter() - t0) * 1e3)
        solve_launches.append(kern.LAUNCHES - before)
    before = kern.LAUNCHES
    with combine_times(sharded_mod) as combine_ms:
        outs.append(sharded_mod.sharded_place(snap, batch, cfg, mesh=grid, device=dev.type))
    solve_launches.append(kern.LAUNCHES - before)
    require(solve_launches == [per_solve] * len(solve_launches),
            f"{solve_launches} launches per solve ({per_solve} wanted)")
    path_launches = sum(solve_launches)
    for pl in outs:
        np.testing.assert_array_equal(pl.node_of, inst.node_of)
    check_feasible(snap, batch, inst)
    got = digest(inst.node_of)
    require(got == SHARDED_REFERENCE["node_of_sha256"],
            f"sweep node_of digest {got} differs from the JAX package's")
    placed = int(inst.placed.sum())
    require(placed == SHARDED_REFERENCE["placed_shards"], placed)
    require(placed >= 0.9 * single_shards, f"sweep placed {placed} of {single_shards}")
    log(f"  (a) {1 + len(outs)} solves identical and feasible, {solve_launches} launches; "
        f"placed {placed} "
        f"shards ({placed / single_shards:.4f} of phase [4]'s {single_shards}); node_of digest "
        f"equals the JAX package's 2x2 sweep ({got[:16]}…); solve wall "
        f"{[round(w, 1) for w in walls]} ms; kernel {ms_per_solve:.4f} ms per solve over "
        f"{per_solve} block launches ({min(kernel_ms):.4f}–{max(kernel_ms):.4f} ms each), "
        f"{sum(cells)} needed cells, bound {solve_bound:.4f} ms, issue ceiling "
        f"{solve_ceiling:.4f} ms; a round-0 block all live {block_ms:.4f} ms/launch "
        f"({block_cells} cells, bound {block_bound:.4f} ms {block_bound_by}, ceiling "
        f"{block_ceiling:.4f} ms); combine and gathers {sum(combine_ms):.4f} ms per solve "
        f"({min(combine_ms):.4f}–{max(combine_ms):.4f} ms a round) [{smi}]")

    # (b) the product route: a forced-sharded scheduler tick on a 1x1 grid
    logging.getLogger("sbt").setLevel(logging.ERROR)
    partitions, nodes, demands = random_inventory(
        HEADLINE["num_nodes"], HEADLINE["num_jobs"], seed=HEADLINE["seed"],
        load=HEADLINE["load"], gpu_fraction=HEADLINE["gpu_fraction"],
        gang_fraction=HEADLINE["gang_fraction"],
    )
    client, make_store = port_tick_world(partitions, nodes, demands)
    store = make_store()
    sched = PlacementScheduler(store, client, backend="auction", inventory_ttl=0, sharded=True,
                               auction_config=cfg, device=dev.type)
    before = kern.LAUNCHES
    t0 = time.perf_counter()
    tick_placed = sched.tick()
    path_launches += kern.LAUNCHES - before
    tick = dict(placed=tick_placed, route=sched.last_route, launches=kern.LAUNCHES - before,
                digest=tick_digest(store.list(Pod.KIND)),
                wall_ms=(time.perf_counter() - t0) * 1e3, phase_ms=dict(sched.last_phase_ms))
    require(tick["route"] == "auction-sharded", f"the forced tick routed {tick['route']}")
    require(tick["launches"] == ROUNDS, f"{tick['launches']} launches in the forced tick")
    require((tick["placed"], tick["digest"]) == (SHARDED_REFERENCE["tick_placed"],
                                                 SHARDED_REFERENCE["tick_sha256"]),
            f"forced-sharded tick {tick['placed']} / {tick['digest']} differs from the JAX "
            "package's")
    log(f"  (b) PlacementScheduler(sharded=True) on a 1x1 grid: route {tick['route']}, bound "
        f"{tick['placed']}, {tick['launches']} launches, digest equals the JAX package's "
        f"({tick['digest'][:16]}…); wall {tick['wall_ms']:.1f} ms ("
        + ", ".join(f"{k} {v:.1f}" for k, v in tick["phase_ms"].items()) + f" ms) [{smi}]")

    # (c) two ranks on the one card over gloo, each a dp row of the grid
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sweep-rank", str(r),
                          str(port), str(dev)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    ranks = []
    try:
        deadline = time.monotonic() + SWEEP_RANK_DEADLINE_S
        for proc in procs:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            require(proc.returncode == 0, f"a sweep rank exited {proc.returncode}:\n{err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks_s = time.perf_counter() - t0
    for rk in ranks:
        require(rk["shape"] == SWEEP and rk["backend"] == "gloo", rk)
        for sv in rk["solves"]:
            require(sv["digest"] == got, f"rank {rk['rank']} digest {sv['digest']} differs")
            require(sv["launches"] == ROUNDS * SWEEP["mp"],
                    f"rank {rk['rank']}: {sv['launches']} launches in a solve")
        log(f"  (c) rank {rk['rank']} over gloo: {[sv['launches'] for sv in rk['solves']]} "
            f"launches, solve wall {[round(sv['wall_ms'], 1) for sv in rk['solves']]} ms, "
            f"digest equals (a)'s; combine and gathers per round "
            f"{min(rk['combine_ms']):.2f}–{max(rk['combine_ms']):.2f} ms (host, staged "
            f"through host memory) [{smi}]")
    log(f"  (c) both ranks' placements equal (a)'s; the two processes took {ranks_s:.1f} s. "
        f"NCCL arm: not run — it needs 2 or more cards, this machine has "
        f"{torch.cuda.device_count()}")
    return dict(errs=errs, walls=walls, kernel_ms=kernel_ms, ms_per_solve=ms_per_solve,
                solve_launches=solve_launches, launches=path_launches, solves=1 + len(outs),
                combine_ms=combine_ms, block_ms=block_ms,
                cells=sum(cells), tick=tick, ranks=ranks)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sweep-rank"]:
        return sweep_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import slurm_bridge_tpu_torch.ops.bid_argmax as kern
    from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver, auction_place
    from slurm_bridge_tpu_torch.solver.routing import choose_path, gang_shard_fraction
    from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    # 2. build
    t0 = time.perf_counter()
    out = kern.build(force=True)
    ptxas = [ln.strip() for ln in out.splitlines() if "ptxas" in ln or "registers" in ln]
    log(f"[2] built {kern._LIB.name} in {time.perf_counter() - t0:.1f} s")
    for ln in ptxas:
        log(f"  {ln}")

    # 3. kernel vs plain
    log("[3] kernel vs plain version on the card")
    errs = []
    for n, p in ((700, 300), (33, 1000), (1, 1)):
        args = small_operands(n * 1000 + p, n, p, dev)
        for aw in (0.0, 0.3):
            errs.append(compare(kern, args, 7, aw, n, f"({n},{p})"))
    tie = small_operands(1, 600, 260, dev)
    tie[0][:] = 100.0
    tie[0][:127] = 0.0
    tie[4][:] = 1.0
    tie[5][:] = -1
    tie[6][:] = 0
    tie[7][:] = -1
    tie[3][:] = 0.25
    bv, bi = kern.bid_argmax(*tie, 1, jitter=0.0, affinity_weight=0.0, num_nodes=600)
    pv, pi = kern.bid_argmax_plain(*tie, 1, jitter=0.0, affinity_weight=0.0, num_nodes=600)
    require((bi == 127).all() and torch.equal(bi, pi) and torch.equal(bv, pv), "tie rule")
    log("  tie across the kernel's tile boundary: node 127 wins everywhere")

    snap, batch = random_scenario(**HEADLINE)
    p_h, n_h = batch.num_shards, snap.num_nodes
    require((p_h, n_h) == (57_635, 10_000), (p_h, n_h))
    hargs = round_operands(snap, batch, dev)
    for aw in (0.0, 0.3):
        errs.append(compare(kern, hargs, 3, aw, n_h, f"headline ({n_h},{p_h})", bp=4096, bn=2048))

    # every round of one headline solve, with that round's live mask
    node_part_np, job_part_np = snap.partition_of, batch.partition_of
    inst_pl, rounds = instrumented_solve(snap, batch)
    require(len(rounds) == ROUNDS, f"{len(rounds)} kernel calls in the instrumented solve")
    require(digest(inst_pl.node_of) == HEADLINE_REFERENCE["node_of_sha256"],
            "instrumented solve's node_of differs from the JAX package's")
    solve_cells, solve_ms = [], []
    for i, r in enumerate(rounds):
        live_np = r["live"].cpu().numpy()
        cells = needed_cells(node_part_np, job_part_np, live_np)
        errs.append(compare(kern, r["args"], r["salt"], 0.0, n_h, f"headline round {i}",
                            live=r["live"], bp=4096, bn=2048))
        solve_cells.append(cells)
        solve_ms.append(r["ms"])
        log(f"  round {i}: live rows {int(live_np.sum())}, needed cells {cells}, "
            f"kernel {r['ms']:.4f} ms in the solve [{smi}]")
    ms_per_solve = sum(solve_ms)
    log(f"  per solve: {sum(solve_cells)} needed cells, kernel {ms_per_solve:.4f} ms over "
        f"{ROUNDS} calls [{smi}]")

    # time per launch on all rows of one round's operands, plain beside it;
    # node and row orders built once, as the solve builds them
    hk = dict(jitter=1.0, affinity_weight=0.0, num_nodes=n_h,
              nodes=kern.node_order(snap.partition_of, dev), rows=kern.row_order(hargs[5]))
    for _ in range(3):
        kern.bid_argmax(*hargs, 3, **hk)
    kernel_ms = cuda_ms(lambda: kern.bid_argmax(*hargs, 3, **hk), 20)
    pk = dict(jitter=1.0, affinity_weight=0.0, num_nodes=n_h, bp=4096, bn=2048)
    kern.bid_argmax_plain(*hargs, 3, **pk)
    plain_ms = cuda_ms(lambda: kern.bid_argmax_plain(*hargs, 3, **pk), 2, gate=False)

    def busy():
        end = time.perf_counter() + 1.5
        while time.perf_counter() < end:
            for _ in range(20):
                kern.bid_argmax(*hargs, 3, **hk)
            torch.cuda.synchronize()

    sm_mhz = sm_clock_mhz(busy)
    all_live = np.ones(p_h, bool)
    cells = needed_cells(node_part_np, job_part_np, all_live)
    bytes_moved = 4 * 9 * (n_h + p_h) + p_h + 8 * p_h  # operands, live mask, outputs
    bound_ms, bound_by, ceiling_ms = bounds(kern, cells, bytes_moved, sm_mhz * 1e6)
    solve_bound_ms, _, solve_ceiling_ms = bounds(kern, sum(solve_cells), ROUNDS * bytes_moved,
                                                 sm_mhz * 1e6)
    log(f"  all rows live: kernel {kernel_ms:.4f} ms/launch, plain {plain_ms:.1f} ms; "
        f"{cells} needed cells (of {p_h * n_h} dense); bound {bound_ms:.4f} ms ({bound_by}, "
        f"{kern.OPS_PER_CELL} ops/cell at {ALU_OPS_PER_S:.3g}/s), issue ceiling {ceiling_ms:.4f} ms "
        f"at SM clock {sm_mhz:.0f} MHz [{smi}]")
    log(f"  per solve: kernel {ms_per_solve:.4f} ms, bound {solve_bound_ms:.4f} ms, issue ceiling "
        f"{solve_ceiling_ms:.4f} ms [{smi}]")

    # 4. the main path at full width
    log("[4] main path: DeviceSolver on the headline scenario")
    backend = ensure_backend()
    path = choose_path(p_h, n_h, backend_name=backend,
                       gang_fraction=gang_shard_fraction(batch.gang_id))
    require(backend == "cuda" and path == "device", (backend, path))
    cfg = AuctionConfig(rounds=ROUNDS)
    kern.LAUNCHES = 0
    aux_before = kern.AUX_LAUNCHES
    solver = DeviceSolver(snap, cfg)
    results, wall_ms = [], []
    for i in range(6):  # 1 warm-up + 5 timed
        before = kern.LAUNCHES
        t0 = time.perf_counter()
        pl = solver.solve(batch)
        dt = (time.perf_counter() - t0) * 1e3
        require(kern.LAUNCHES - before == ROUNDS, f"{kern.LAUNCHES - before} launches in a solve")
        if i:
            wall_ms.append(dt)
        results.append(pl)
    before = kern.LAUNCHES
    pl_async = solver.solve_async(batch).result()
    require(kern.LAUNCHES - before == ROUNDS, f"{kern.LAUNCHES - before} launches in a solve")
    results.append(pl_async)
    drained_snap = random_scenario(**HEADLINE)[0]
    busiest = int(np.bincount(results[0].node_of[results[0].placed], minlength=n_h).argmax())
    drained_snap.free[busiest] = 0.0
    solver.update_snapshot(drained_snap)
    before = kern.LAUNCHES
    pl_drained = solver.solve(batch)
    require(kern.LAUNCHES - before == ROUNDS, f"{kern.LAUNCHES - before} launches in a solve")
    main_launches = kern.LAUNCHES
    require(main_launches == ROUNDS * 8, main_launches)

    for pl in results:
        check_feasible(snap, batch, pl)
        np.testing.assert_array_equal(pl.node_of, results[0].node_of)
    require(digest(results[0].node_of) == HEADLINE_REFERENCE["node_of_sha256"],
            f"headline node_of digest {digest(results[0].node_of)} differs from the JAX package's")
    check_feasible(drained_snap, batch, pl_drained)
    require(not (pl_drained.node_of == busiest).any(), "drained node still used")
    headline = results[0]
    placed_jobs = len(headline.by_job(batch))
    require((placed_jobs, int(headline.placed.sum())) == (
        HEADLINE_REFERENCE["placed_jobs"], HEADLINE_REFERENCE["placed_shards"]), placed_jobs)
    log(f"  {len(results)} solves identical and feasible; placed jobs {placed_jobs} "
        f"({int(headline.placed.sum())}/{p_h} shards); node_of digest equals the JAX "
        f"package's ({HEADLINE_REFERENCE['node_of_sha256'][:16]}…); drained node {busiest} "
        f"unused (placed jobs {len(pl_drained.by_job(batch))}); helper launches "
        f"{kern.AUX_LAUNCHES - aux_before}")

    dense = auction_place(snap, batch, AuctionConfig(rounds=ROUNDS, use_pallas=False, candidates=0))
    np.testing.assert_array_equal(dense.node_of, headline.node_of)
    log("  dense plain path on the card places identically")

    # 5. the bridge's placement tick at full width
    log("[5] main path: PlacementScheduler ticks on the headline inventory")
    kern.LAUNCHES = 0
    tick = tick_phase(kern, smi)
    tick_launches = kern.LAUNCHES
    require(tick_launches == ROUNDS * 3, f"{tick_launches} kernel launches in the tick phase")
    errs += tick["errs"]

    # 6. the bridge's job lifecycle on the simulated cluster at full width
    log("[6] main path: the simulator's full_50kx10k through the port's full bridge loop")
    kern.LAUNCHES = 0
    sim = sim_phase(kern, smi)
    sim_launches = kern.LAUNCHES
    require(sim_launches > 0, "no kernel launch in the simulator phase")
    errs += sim["errs"]

    # 7. recovery at full width: a bridge crash and snapshot + WAL reload
    log("[7] main path: the simulator's full_50kx10k_crash (restart at tick 2) through the "
        "port's full bridge loop")
    kern.LAUNCHES = 0
    crash = crash_phase(kern, smi)
    crash_launches = kern.LAUNCHES
    require(crash_launches > 0, "no kernel launch in the recovery phase")
    errs += crash["errs"]

    # 8. the sharded tick: every shard's solve on the kernel
    log("[8] main path: the simulator's full_500kx100k uncut (100,000 nodes, 500,000 jobs, "
        "3 ticks) with the shard executor's fan-out")
    kern.LAUNCHES = 0
    shard = shard_phase(kern, smi, sm_mhz * 1e6)
    shard_launches = shard["launches"]
    require(shard_launches > 0, "no kernel launch in the sharded phase")
    errs += shard["errs"]

    # 9. the streaming reschedule at full width: most rows pinned
    log("[9] main path: the streaming reschedule (BASELINE config #5) at full width")
    kern.LAUNCHES = 0
    churn = churn_phase(kern, smi)
    churn_launches = churn["launches"]
    require(churn_launches > 0, "no kernel launch in the streaming phase")
    errs += churn["errs"]

    # 10. the placement-solver sidecar, in process
    log("[10] main path: the placement-solver sidecar's Place on the headline inventory")
    kern.LAUNCHES = 0
    sidecar = sidecar_phase(kern, smi)
    sidecar_launches = sidecar["launches"]
    require(sidecar_launches == ROUNDS * len(PLACE_REFERENCE["places"]),
            f"{sidecar_launches} kernel launches in the sidecar phase")
    errs += sidecar["errs"]

    # 11. the bridge's daemons over the fake Slurm CLI
    log(f"[11] main path: the bridge's daemons — agent, Bridge, fetcher, kubelet server — over the "
        f"fake Slurm CLI with {BRIDGE['num_nodes']} nodes and {BRIDGE['num_jobs']} jobs")
    kern.LAUNCHES = 0
    daemons = bridge_phase(kern, smi)
    daemons_launches = daemons["launches"]
    require(daemons_launches >= ROUNDS, f"{daemons_launches} kernel launches in the bridge phase")
    errs += daemons["errs"]

    # 12. the multi-device sweep on one card
    log(f"[12] main path: the multi-device sweep on one card — the headline on a "
        f"{SWEEP['dp']}x{SWEEP['mp']} grid of cuda:0 blocks, the forced-sharded tick, two "
        "ranks over gloo")
    kern.LAUNCHES = 0
    sweep = sweep_phase(kern, smi, snap, batch, int(headline.placed.sum()), sm_mhz * 1e6)
    sweep_launches = sweep["launches"]
    require(sweep_launches == sweep["solves"] * ROUNDS * SWEEP["dp"] * SWEEP["mp"] + ROUNDS,
            f"{sweep_launches} kernel launches in the sweep phase")
    errs += sweep["errs"]

    # 13. the JAX package's result on the reduced scenario
    ref_snap, ref_batch = random_scenario(
        REFERENCE["nodes"], REFERENCE["jobs"], seed=42, load=0.7,
        gpu_fraction=0.15, gang_fraction=0.05,
    )
    require(ref_batch.num_shards == REFERENCE["shards"], ref_batch.num_shards)
    ref_pl = DeviceSolver(ref_snap, AuctionConfig(rounds=ROUNDS, candidates=0)).solve(ref_batch)
    check_feasible(ref_snap, ref_batch, ref_pl)
    ref_jobs = len(ref_pl.by_job(ref_batch))
    rel = abs(ref_jobs - REFERENCE["placed_jobs"]) / REFERENCE["placed_jobs"]
    match = digest(ref_pl.node_of) == REFERENCE["node_of_sha256"]
    log(f"[13] reduced scenario {REFERENCE['nodes']}x{REFERENCE['jobs']}: placed jobs {ref_jobs} "
        f"vs JAX {REFERENCE['placed_jobs']} (rel {rel:.5f}); node_of digest matches JAX: {match}")
    require(rel <= 0.005, rel)

    # 14. times
    p50 = statistics.median(wall_ms)
    log(f"[14] [{smi}] headline solve p50 {p50:.1f} ms over {len(wall_ms)} "
        f"(min {min(wall_ms):.1f}, max {max(wall_ms):.1f}); kernel {kernel_ms:.4f} ms/launch "
        f"(bound {bound_ms:.4f}, ceiling {ceiling_ms:.4f}), {ms_per_solve:.4f} ms per solve; "
        f"total run {time.perf_counter() - t_start:.0f} s")
    for i, t in enumerate(tick["ticks"]):
        log(f"[14] [{smi}] headline tick {i + 1}: wall {t['wall_ms']:.1f} ms, "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in t["phase_ms"].items())
            + f"; {t['launches']} kernel launches")
    for label, run, launches in (("full_50kx10k", sim, sim_launches),
                                 ("full_50kx10k_crash", crash, crash_launches),
                                 ("full_500kx100k", shard, shard_launches)):
        tm = run["result"].timing
        log(f"[14] [{smi}] {label}: tick p50 {tm['tick_p50_ms']:.1f} ms, "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in tm["phases_p50_ms"].items())
            + f" (p50 over {len(run['ticks'])} ticks); {launches} kernel launches; "
            f"phase wall {run['wall_s']:.1f} s")
    log(f"[14] [{smi}] recovery_ms {crash['result'].timing['recovery_ms']}; full_500kx100k: "
        f"{len(shard['sizes'])} shards of {shard['sizes']} nodes, shard solves "
        f"{[round(sv['ms'], 1) for sv in shard['solves']]} ms, kernel per solve of tick 0's shard "
        f"solves {shard['held']}: {[round(k['ms_per_solve'], 4) for k in shard['kernel']]} ms; "
        f"tick p50 {shard['result'].timing['tick_p50_ms']:.1f} ms (gate {shard['p50_gate_ms']:.0f}), "
        f"phase-sum drift {shard['drift']:.2f} % (gate ±{shard['drift_gate']} %); device memory "
        f"peak {shard['device_peak'] / 2**20:.1f} MiB, host peak RSS "
        f"{shard['host_peak'] / 2**20:.0f} MiB")
    log(f"[14] [{smi}] streaming reschedule: churn tick p50 {churn['p50_ms']:.1f} ms, "
        f"re-solve ms {[round(t['solve_ms'], 1) for t in churn['ticks']]}, "
        f"{churn_launches} kernel launches, kernel {churn['kernel']['ms_per_solve']:.4f} ms per "
        f"solve on churn tick 1; auto route {churn['auto_route']}")
    log(f"[14] [{smi}] sidecar Place ms {[round(t['wall_ms'], 1) for t in sidecar['places']]} "
        f"(solve {[round(t['solve_ms'], 1) for t in sidecar['places']]}), "
        f"{sidecar_launches} kernel launches, kernel {sidecar['kernel']['ms_per_solve']:.4f} ms "
        f"per solve on Place 0")
    tk = daemons["tick"]
    log(f"[14] [{smi}] bridge daemons: placing tick {tk['wall_ms']:.1f} ms ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in tk["phase_ms"].items())
        + f"), kernel {daemons['kernel']['ms_per_solve']:.4f} ms over {ROUNDS} launches; "
        f"{BRIDGE['num_jobs']} jobs submit to last Succeeded {daemons['wall_s']:.1f} s; "
        f"{daemons_launches} kernel launches")
    log(f"[14] [{smi}] multi-device sweep ({SWEEP['dp']}x{SWEEP['mp']} cuda:0 blocks): solve "
        f"wall {[round(w, 1) for w in sweep['walls']]} ms, kernel {sweep['ms_per_solve']:.4f} ms "
        f"per solve over {sweep['solve_launches'][0]} block launches, combine and gathers "
        f"{sum(sweep['combine_ms']):.4f} ms per solve; forced-sharded tick "
        f"{sweep['tick']['wall_ms']:.1f} ms; gloo ranks' solve wall "
        f"{[[round(sv['wall_ms'], 1) for sv in rk['solves']] for rk in sweep['ranks']]} ms; "
        f"{sweep_launches} kernel launches; total run {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "bid_argmax",
        "route": "cuda",
        "source": "slurm_bridge_tpu_torch/csrc/bid_argmax.cu",
        "replaces": "slurm_bridge_tpu/ops/bid_argmax.py:78",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_per_solve": ms_per_solve,
        "ceiling_ms": ceiling_ms,
        "launches_per_tick": [t["launches"] for t in tick["ticks"]]
        + [t["launches"] for t in sim["ticks"]] + [t["launches"] for t in crash["ticks"]]
        + [t["launches"] for t in shard["ticks"]],
        "launches_per_shard_solve": [sv["launches"] for sv in shard["solves"]],
        "shard_solves_timed": shard["held"],
        "shard_kernel_ms_per_solve": [k["ms_per_solve"] for k in shard["kernel"]],
        "shard_bound_ms_per_solve": [k["bound_ms"] for k in shard["kernel"]],
        "launches_per_churn_tick": [t["launches"] for t in churn["ticks"]]
        + [churn["auto_launches"]],
        "launches_per_place": [t["launches"] for t in sidecar["places"]],
        "launches_bridge_daemons": daemons_launches,
        "bridge_tick_kernel_ms": daemons["kernel"]["ms_per_solve"],
        "churn_kernel_ms_per_solve": churn["kernel"]["ms_per_solve"],
        "place_kernel_ms_per_solve": sidecar["kernel"]["ms_per_solve"],
        "tick_kernel_ms": tick["auto"]["kernel_ms"],
        "launches_per_sharded_solve": sweep["solve_launches"],
        "sharded_kernel_ms_per_solve": sweep["ms_per_solve"],
        "sharded_block_ms": sweep["block_ms"],
        "launches_sharded_tick": sweep["tick"]["launches"],
        "launches_per_rank_solve": [sv["launches"] for rk in sweep["ranks"]
                                    for sv in rk["solves"]],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
