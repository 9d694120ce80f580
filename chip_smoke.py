#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: the placement solve, the
placement tick, the bridge's job lifecycle on the simulated cluster and
its steady state, its recovery from a crash, the sharded tick and its
steady state, the streaming reschedule, the placement-solver sidecar, the
bridge's daemons, the multi-device sweep, the BASELINE configs #2 and #4
and the sampled auction path, the streaming-admission fast path, the
policy tick with preemption (the placement-quality scenarios), and the
fault gates (the chaos, fault and shard scenarios).

    python3 chip_smoke.py

(``chip_smoke.py --sweep-rank RANK PORT DEVICE`` is one rank of phase 12's
two-process run; phase 12 starts both itself. ``chip_smoke.py
--late-phases OUT`` runs phases 15 and 16; the run starts it itself.)

Needs one CUDA card (Hopper, ``sm_90a``) and ``nvcc``; exits non-zero
without one. Imports nothing of JAX or of the JAX package. Phases, each of
which fails the run:

1. identify the card (``nvidia-smi`` name and power limit);
2. build ``slurm_bridge_tpu_torch/csrc/bid_argmax.cu`` from the checkout;
3. hold the kernel against its plain PyTorch version on the card: small
   shapes, a tie across a tile boundary, one round's operands of the
   57,635 × 10,000 headline solve, and every round of one instrumented
   headline solve with that round's live mask (the rows still unplaced) —
   values and choices bit-exact at every ``affinity_weight`` (0, 0.3, and
   0.05 at jitter 0.7: the kernel rounds the affinity bid as its plain
   version and the JAX package's dense round do). Per round it prints the
   live rows, the cells
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
6. drive the bridge's job lifecycle at full width and its steady state:
   the simulator's ``full_50kx10k_steady`` (10,000 nodes, 50,000
   front-loaded jobs: ``full_50kx10k``'s 3 ticks and three more) through
   the port's ``SimHarness`` — operator, configurator, virtual-node providers
   submitting to and mirroring the simulated agent over the port's wire
   codec, the placement scheduler on the card — with the engine pinned
   (``backend="auction"``, ``AuctionConfig(rounds=8, candidates=0)``).
   After tick 2 (:data:`STEADY_CHECKPOINT_TICK`) its running determinism
   ``digest``, its ``final_state_digest`` and ``bound_total`` must equal
   the JAX package's 3-tick ``full_50kx10k`` (:data:`SIM_REFERENCE`), and
   at its end the JAX package's ``full_50kx10k_steady``
   (:data:`SIM_STEADY_REFERENCE`), with no invariant violated; it must
   have as many steady ticks as the JAX package's run, each with no
   solve, no kernel launch, no store commit and the JAX package's count
   of (cursor-scoped) ``JobsInfo`` calls, and their tick p50
   (``steady_tick_p50_ms``) within the scenario's ``steady_gate_ms``
   (50 ms), as ``sim/cli.py`` requires; every solving tick launches the
   kernel 8 times per solve;
   each of tick 0's kernel calls is held bit-exact against its plain
   version on its own operands; the providers' bulk RPCs must have gone
   through the column decoder (rows counted, no fallback) and their
   submits through the forked worker pool. Then the same scenario at the
   product default (``backend="auto"``) for one tick must reach the card
   with no violation. Prints each tick's phases (arrive, store, encode,
   solve, bind, mirror, other), store commits, ``JobsInfo`` calls and
   steady verdict, the tick p50 and the phase's wall time;
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
8. the sharded tick at the headline's full size and its steady state:
   ``full_500kx100k_steady`` uncut (100,000 nodes in 16 partitions,
   500,000 front-loaded jobs, 5 % gangs, 15 % GPU nodes:
   ``full_500kx100k``'s 3 ticks and three more) with
   ``ShardConfig(max_nodes_per_shard=8192, workers=2, device_solve=False)``
   and the same pinned engine, under its own deadline
   (:data:`SHARD_DEADLINE_S`). The plan must have at least two shards,
   every shard's solve must launch the kernel 8 times, every kernel call
   of tick 0 (round 0 and the last round of its first and largest shard
   solves among them) is held bit-exact against the plain version on its
   own operands; after tick 2 the ``digest``, ``final_state_digest`` and
   ``bound_total`` must equal the JAX package's 3-tick ``full_500kx100k``
   (:data:`SHARD_REFERENCE`), and at the end those and the cross-shard
   ``reconcile_placed`` the JAX package's ``full_500kx100k_steady``
   (:data:`SHARD_STEADY_REFERENCE`); its steady ticks are held as phase
   6's are (the gate: 1,000 ms). Prints each tick's phases, the plan's shard
   sizes, the shard solves (rows, nodes, launches, ms), the tick p50 over
   ticks 0-2 and their phase-sum drift beside ``full_500kx100k``'s gates
   (``p50_gate_ms``, ``phase_reconcile_pct``; printed, as ``sim/cli.py``
   enforces them and the harness does not), the device's and the host's
   peak memory, and
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
    request and response crosses as codec bytes). :data:`BRIDGE`'s 60
    jobs (the headline's first 60 demands, :func:`bridge_inventory`) go
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
13. the BASELINE configs the earlier phases do not solve
    (``benchmarks/scenarios/__init__.py``): (a) config #4, gang MPI jobsets
    on a fragmented cluster (:data:`BASELINE4`: 54,056 shards × 10,000
    nodes) with its own solve (:data:`BASELINE4_SOLVE`: 16 rounds, 8
    salvage rounds, gang-first, affinity 0.05) on ``DeviceSolver``, the
    kernel auto-selected — 1 + 5 solves, 16 launches each, identical and
    feasible, ``node_of`` digest, placed jobs and shards equal to the JAX
    package's (:data:`BASELINE4_REFERENCE`), each of the 16 kernel calls
    of the first held bit-exact against the plain version on its own
    operands and live mask; prints the auto route (``choose_path``: native,
    gang-dominated), each round's live rows, needed cells and kernel ms,
    an all-live launch beside its bounds and the plain version, the solve
    p50, the device memory peak and the native packer's placed jobs;
    (b) config #2 (:data:`BASELINE2`, 5,000 pods on 512 nodes, 8 rounds)
    the same way (:data:`BASELINE2_REFERENCE`), its solve p50 beside the
    native packer's; (c) the sampled auction path
    (``candidates=``:data:`SAMPLED_K`) on the headline (8 rounds) and on
    config #4: 6 solves each, no kernel launch, ``node_of`` equal to the
    JAX package's (:data:`SAMPLED_REFERENCE`); prints solve p50 and device
    memory peak;
14. the streaming-admission fast path at the headline's cluster width:
    ``interactive_storm`` at scale :data:`STORM_SCALE` (9,600 nodes in 2
    partitions, 44,000 jobs arriving diurnally over 16 ticks, 15 % gangs,
    30 % production class, two production probes at tick 0, 24 ticks)
    with its ``PolicyConfig()`` and ``AdmissionConfig()`` and the same
    pinned engine: the fast path binds interactive arrivals against the
    residual view each solve re-bases from its host ``free_after``. Its
    ``digest``, ``final_state_digest``, ``bound_total``, the admitter's
    attempts, binds, misses by reason and window re-bases, and the
    interactive arrivals and fast binds must equal the JAX package's
    (:data:`STORM_REFERENCE`), with no invariant violated; as
    ``sim/cli.py``'s admission gate holds them (``ADMISSION_GATES``): at
    least 10 fast binds, a non-empty ``FastPathAdmitter.misses``, and an
    interactive arrival-to-bind p99 of at most 100 ms (a fast bind costs
    its measured wall time, a batch bind half a tick period or more);
    every solving tick launches the kernel 8 times per solve, and each
    kernel call of the first solving tick is held bit-exact against its
    plain version on its own operands. Then its admission-off twin
    (``admission=None``): digests, bound, scorecard and utilization equal
    to the JAX package's twin (:data:`STORM_OFF_REFERENCE`), 8 launches
    per solve, batch utilization within ``ADMISSION_GATES["util_margin"]``
    of the on arm's (required where the JAX package's arms hold it) and
    a half tick period over the latency gate, as ``_admission`` requires.
    Prints each tick's phases, the fast binds and misses by reason, the
    p50 and p99 of one fast admission's wall time, and the twin's
    utilization beside the on arm's p99;
15. the policy tick with preemption at the headline's cluster width:
    ``sim/cli.py``'s quality scenarios (:data:`QUALITY_CELLS`) —
    ``priority_inversion`` at 80 (9,600 nodes, batch incumbents, a
    production gang storm at tick 5, ``preemption=True``) on, policy off
    and with the full tick; ``multi_tenant_storm`` at 40 (four tenants,
    48,000 front-loaded jobs) on and policy off; ``diurnal_load`` at 10
    (1,200 nodes; its own 2-round auction without repair) on, policy off
    and backfill off (both cut for the run's time); ``elastic_resize`` at
    33 (9,900 nodes, two resize windows) — each with the pinned engine
    (``diurnal_load``: its own auction, ``candidates=0``).
    Every arm's ``digest``, ``final_state_digest``, ``bound_total``,
    ``preempted_total``, events, restarts, per-tick solves and scorecard
    (without wall-clock latencies) must equal the JAX package's run of the
    same arm (:data:`QUALITY_REFERENCE`), with no invariant violated; every
    solving tick launches the kernel as many times per solve as the
    auction has rounds; each kernel call of ``priority_inversion``'s first
    solving tick from the storm on and of ``diurnal_load``'s first solving
    tick is held bit-exact against its plain version on its own operands;
    the full tick equals the incremental one in digests and scorecard.
    ``QUALITY_GATES`` apply as ``_quality`` applies them
    (:func:`quality_gates`): each gate the JAX package's run holds must
    hold; each it misses is printed beside its values. Prints each arm's
    ticks and phases, preempted, backfill binds, Jain, utilization, class
    wait p95, kernel launches, calls compared and wall time;
16. the fault gates (:data:`FAULT_CELLS`): every fault scenario of
    ``sim/cli.py``'s smoke, chaos and shard gates with the pinned engine —
    ``partition_vanish`` at 16 (4,800 nodes, 12,800 jobs; ``part1`` gone
    for ticks 3-10) and ``node_churn`` at 8 (2,400 nodes, 7,200 jobs;
    20 % of nodes drained for ticks 4-12, stale inventory and lost status
    for ticks 5-10), then at scale 1 the
    RPC flaps, the preemption storm, the bridge crash, the leader
    failover, the agent crash, the simultaneous crashes, a crash inside an
    RPC flap and into a vanished partition, and the sharded fan-out with
    its cross-shard gang reconcile; each scenario with a
    ``lossless_twin`` also runs its crash-free twin (the bridge and agent
    crashes stripped). Every run's ``digest``, ``final_state_digest``,
    ``final_outcome_digest``, ``bound_total``, recovery ticks, restarts,
    agent restarts, virtual-node deletions, RPC retries, wait reasons,
    per-tick solves and shard block must equal the JAX package's run
    (:data:`FAULT_REFERENCE`); ``_smoke``'s gates must hold
    (:func:`fault_gates`): no invariant violated, recovery within the
    scenario's bound, no virtual node deleted and a restart after a bridge
    fault, an agent restart after an agent fault, the twin's final digest
    equal, at least two shards and a reconciled gang. Every device solve
    (each shard's too) launches the kernel once per round; each kernel call
    of the group A runs' fault ticks (:func:`held_fault_ticks`) is held
    bit-exact against its plain version on its own operands. Prints each
    run's ticks, tick p50, bound, recovery ticks, restarts and their
    reload times, launches, calls held and wall time;
    Phases 15 and 16 run in a second process of this script
    (``chip_smoke.py --late-phases OUT``, :func:`late_phases`), started
    beside phase 6 and waited for before phase 8 times its shard solves:
    phases 6-8 time no kernel meanwhile, and the run's wall is the longer
    of the two paths, not their sum; their lines print in their place;
17. hold the card against the JAX package's result on a reduced scenario
    (``tools/port_reference.py``): placed jobs within 0.5 %, digest shown;
18. print times with the card's name and power limit, and the run's wall
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
#: The JAX package's simulator on ``full_50kx10k_steady`` (the
#: ``full_50kx10k`` shape run three ticks longer) at full width with the
#: auction pinned, on the CPU, from ``JAX_PLATFORMS=cpu python
#: tools/port_reference.py --sim full_50kx10k_steady`` (20.1 s wall and
#: 5,750 MiB peak RSS on an 8-core host). Tick 3 still binds (one solve,
#: 14 commits), so ticks 4-5 are its steady ticks. After tick 2 its
#: trace digest, state and bound are :data:`SIM_REFERENCE`'s.
SIM_STEADY_REFERENCE = dict(
    digest="9e6b76ab0ea23327f9e9cceb7b00d68336f64950f560f16296db4f897a8d64d0",
    final_state_digest="fadf07b1ee032ee1c9b276455174ecfe101043aa54378f02ded9ef2109b410ca",
    bound_total=46059,
    steady_ticks=2,
    steady_jobsinfo_calls=24,
)
#: The tick after which a ``*_steady`` run has done what its 3-tick twin
#: does: its running trace digest, state and bound equal the twin's end.
STEADY_CHECKPOINT_TICK = 2
#: Phase 8 fails if a tick of its run ends more than this many seconds
#: after the run's harness was built (about twice what the run takes on
#: the card's host).
SHARD_DEADLINE_S = 640
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
#: The JAX package's simulator on ``full_500kx100k_steady`` uncut (the
#: ``full_500kx100k`` shape run three ticks longer) with the auction
#: pinned and every shard on the single-device auction, on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim
#: full_500kx100k_steady`` (203.2 s wall and 7,611 MiB peak RSS on an
#: 8-core host). Tick 3 still binds (one solve, 23 commits), so ticks 4-5
#: are its steady ticks; each makes 240 ``JobsInfo`` calls, 15 per shard:
#: a provider's status pass sends its ~29,000 job ids in requests of 2,000
#: (``bridge/vnode.py``'s ``_BULK_CHUNK``), each cursor-scoped. After tick
#: 2 its trace digest, state and bound are :data:`SHARD_REFERENCE`'s.
SHARD_STEADY_REFERENCE = dict(
    digest="d7fc727051580fc9509c24a59da53793b98472f037ad3a579f44345683e73757",
    final_state_digest="66b2f4b0af025f9f3114bcb1822f1a3cb4b34fccde10d259937465667c7ffc9a",
    bound_total=462742,
    reconcile_placed=0,
    steady_ticks=2,
    steady_jobsinfo_calls=240,
)
#: Phase [14]'s scale of ``interactive_storm``: the JAX package's own
#: scale knob at the largest round value that keeps the headline's
#: cluster width (9,600 nodes in 2 partitions, 44,000 jobs over 16 ticks
#: of diurnal arrivals, 24 ticks).
STORM_SCALE = 40
#: The JAX package's simulator on ``interactive_storm`` at
#: :data:`STORM_SCALE` with its policy and admission configs and the
#: auction pinned, on the CPU, from ``JAX_PLATFORMS=cpu python
#: tools/port_reference.py --sim interactive_storm --scale 40`` (47.2 s
#: wall and 1,383 MiB peak RSS on an 8-core host): digests, bound, the
#: admitter's decision counts, the interactive arrivals and fast binds
#: the latency gate reads, and the batch utilization its admission-off
#: twin is held to.
STORM_REFERENCE = dict(
    digest="f6d27152792f11aa1d58c28432e4b06a1987966b3caf7422c3a04824fd64aae9",
    final_state_digest="d69e93035130cec47d1a955de29f81c1f40d731fc088f36e98da5bbb575754a1",
    bound_total=43692,
    admission=dict(attempts=13196, binds=12393, misses={"not_ready": 803}, inventory_rebases=18),
    interactive_arrivals=10959,
    fastpath_binds=10959,
    utilization_mean=0.2367,
)
#: The arms a scenario runs under (:func:`arm_scenario`): as defined, its
#: policy off, its backfill alone off, its streaming admission off, the
#: full (non-incremental) tick, and its bridge and agent crashes stripped.
QUALITY_ARMS = ("on", "policy_off", "backfill_off", "admission_off", "full_tick", "crash_free")
#: Phase [15]'s cells: ``sim/cli.py``'s quality scenarios, with the arms
#: their gates compare, at the headline's cluster width where the run's
#: time allows it. ``hold_from``: the on arm's first solving tick from that
#: tick on has each kernel call held against the plain version
#: (``priority_inversion``'s production gang storm arrives at tick 5).
QUALITY_CELLS = dict(
    priority_inversion=dict(scale=80, arms=("on", "policy_off", "full_tick"), hold_from=5),
    # the next two cut for the run's 1,200 s (PERF.md §4): at 80 and 40 the
    # phase took 638 s with an NVIDIA H100 80GB HBM3 at 700 W, at 80 and 20
    # 436 s, and the whole run 1,303 s; the JAX package's gate verdicts are
    # the same at the cut scales (4,800 and 1,200 nodes)
    multi_tenant_storm=dict(scale=40, arms=("on", "policy_off")),
    diurnal_load=dict(scale=10, arms=("on", "policy_off", "backfill_off"), hold_from=0),
    elastic_resize=dict(scale=33, arms=("on",)),
)
#: The JAX package's simulator on each arm of :data:`QUALITY_CELLS` at its
#: scale, with the engine pinned as :func:`pin_auction` pins it, on the
#: CPU, from ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim NAME
#: --scale S --arm ARM`` (wall time and peak RSS beside each, three runs at
#: a time on an 8-core host): digests, bound, preempted, restarts, the
#: events' and the scorecard's digests (:func:`json_digest`,
#: :func:`virtual_scorecard`), the shape, each tick's solves and the
#: scorecard numbers the gates read (:func:`quality_summary`).
QUALITY_REFERENCE = {
    # --sim priority_inversion --scale 80 --arm on: 57.669 s, 4,120 MiB
    "priority_inversion/on": dict(
        digest="931d4d30dd4b498cf9b12d9876a7ad4004741482d9b9a1c2aa1bf667b7ebc03e",
        final_state_digest="493ccf8255df485e9bc1c1e8697cdec1412cdf576731ccb256da469eae14a328",
        events_sha256="a7d04085306f8ed0dc1cc7f64fabe4c9b5859fd3a197f532f0f569486e961800",
        scorecard_sha256="7051d1baa30bf30a33e5f9d8d07d7ba9ad2a606943e10a5df9f9a659af880066",
        bound_total=37634, preempted_total=41, restarts=0,
        shape=dict(pods=41280, nodes=9600, partitions=4, ticks=14),
        solves=[1, 0, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        quality=dict(utilization_mean=0.864, jain_fairness=1.0, production_wait_p95=9.0,
                     gang_wait_p95_ticks=9.0, preempted_total=41, backfill_binds=0, resizes=0,
                     unbound_final=3663, drained_at_tick=None, recovery_ticks=None)),
    # --sim priority_inversion --scale 80 --arm policy_off: 98.632 s, 4,866 MiB
    "priority_inversion/policy_off": dict(
        digest="d1023354721969237fdfc0754f2c80678a024f412d2b8d87c589609bce8e0955",
        final_state_digest="a1313d76bee5d534d4d4ed55bbc1c437b238e4342ae38b4c15ccc431abf7dcea",
        events_sha256="0f2865d97c5de022de8c8fe7bc6c618364b2ba0f479cb7b939502d5d3f530bd3",
        scorecard_sha256="17ab5850010c6092facfd2cbdb8bcb48ca81c09e69b1d0b3d6bc622d71b4553d",
        bound_total=40307, preempted_total=2594, restarts=0,
        shape=dict(pods=41280, nodes=9600, partitions=4, ticks=14),
        solves=[1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        quality=dict(utilization_mean=0.8698, jain_fairness=1.0, production_wait_p95=9.0,
                     gang_wait_p95_ticks=9.0, preempted_total=2594, backfill_binds=None, resizes=0,
                     unbound_final=2576, drained_at_tick=None, recovery_ticks=None)),
    # --sim priority_inversion --scale 80 --arm full_tick: 66.386 s, 4,138 MiB
    "priority_inversion/full_tick": dict(
        digest="931d4d30dd4b498cf9b12d9876a7ad4004741482d9b9a1c2aa1bf667b7ebc03e",
        final_state_digest="493ccf8255df485e9bc1c1e8697cdec1412cdf576731ccb256da469eae14a328",
        events_sha256="013d31fcc965a18d1e8478a9d5a32710125b9fac7019fde53afeb7bbebcbda55",
        scorecard_sha256="7051d1baa30bf30a33e5f9d8d07d7ba9ad2a606943e10a5df9f9a659af880066",
        bound_total=37634, preempted_total=41, restarts=0,
        shape=dict(pods=41280, nodes=9600, partitions=4, ticks=14),
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        quality=dict(utilization_mean=0.864, jain_fairness=1.0, production_wait_p95=9.0,
                     gang_wait_p95_ticks=9.0, preempted_total=41, backfill_binds=0, resizes=0,
                     unbound_final=3663, drained_at_tick=None, recovery_ticks=None)),
    # --sim multi_tenant_storm --scale 40 --arm on: 24.214 s, 2,788 MiB
    "multi_tenant_storm/on": dict(
        digest="b5c9b712771905cd25dbdc280366a43fad8842029ab47f5090269161a64be0bf",
        final_state_digest="fa2144b9129772dd8384fefca13ed85bb16c4939c40ff2138a3c5bc75bcd1738",
        events_sha256="3dfe85ffad279bb6c7b9cc5de910d8653366b617f5a4dc5b8d4cf8dba89d1c0a",
        scorecard_sha256="0028a7e6d128b41f4c806a4d5c496fba46da8f4486233025d3c310b6e419035e",
        bound_total=10634, preempted_total=0, restarts=0,
        shape=dict(pods=48000, nodes=4800, partitions=4, ticks=10),
        solves=[1, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        quality=dict(utilization_mean=0.8479, jain_fairness=0.9998, production_wait_p95=None,
                     gang_wait_p95_ticks=0.0, preempted_total=0, backfill_binds=0, resizes=0,
                     unbound_final=37366, drained_at_tick=None, recovery_ticks=None)),
    # --sim multi_tenant_storm --scale 40 --arm policy_off: 20.315 s, 2,798 MiB
    "multi_tenant_storm/policy_off": dict(
        digest="3a6bbf063d8343eb50c15a053120aa47d873b99c11efd9f21f3b737d6c090fc3",
        final_state_digest="ca1dae9de9b54c8b7374a67dd5375b866955b898a55908f3d29ba85bcb099553",
        events_sha256="ef70cc1d0802cf19e32b58510d7b096bb5f9dc211e70195ed0bee1d655ed7f7a",
        scorecard_sha256="44c9bca6f99c640466eee97ccb71d985364a011b7dfdfa5eb382a05d408a39ef",
        bound_total=10727, preempted_total=0, restarts=0,
        shape=dict(pods=48000, nodes=4800, partitions=4, ticks=10),
        solves=[1, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        quality=dict(utilization_mean=0.8505, jain_fairness=0.3623, production_wait_p95=None,
                     gang_wait_p95_ticks=0.0, preempted_total=0, backfill_binds=None, resizes=0,
                     unbound_final=37273, drained_at_tick=None, recovery_ticks=None)),
    # --sim diurnal_load --scale 10 --arm on: 21.671 s, 765 MiB
    "diurnal_load/on": dict(
        digest="32dac1976e8f632bdd1d71ac814143258d4d27a7a953ba8f1d41d12ce12d26fe",
        final_state_digest="6b38a4dc7f740d6c0eb58ced9f1e06508a370ca162f02703b4d993128d4e215d",
        events_sha256="c2ff1feb989e1ca5647a6a2864d8f01f766659ec58c5e326952756cefdeab41f",
        scorecard_sha256="eb1abc120ae5ab5a26d432973e98e917e10543865d474de0ca2401343d3cb3c1",
        bound_total=13840, preempted_total=0, restarts=0,
        shape=dict(pods=14880, nodes=1200, partitions=4, ticks=24),
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        quality=dict(utilization_mean=0.4771, jain_fairness=1.0, production_wait_p95=None,
                     gang_wait_p95_ticks=15.0, preempted_total=0, backfill_binds=792, resizes=0,
                     unbound_final=1040, drained_at_tick=None, recovery_ticks=None)),
    # --sim diurnal_load --scale 10 --arm policy_off: 20.342 s, 765 MiB
    "diurnal_load/policy_off": dict(
        digest="99b28aa84a4f87d09e19f9da8c2549348fc77446e8e6f0dfac498036ca1d12ec",
        final_state_digest="505d1ca230ecc4f6e1ef847a31cdee8cdaa7e177a5a6013fd6cb46df9518f84e",
        events_sha256="69aa523f08f426f92589cea1f42b6f44e2d5973319f98b8439dddbecc188cb0a",
        scorecard_sha256="eeea5abf0291f059454e8632cedfad860d15273658f60a214106823d9b2ff10f",
        bound_total=13773, preempted_total=0, restarts=0,
        shape=dict(pods=14880, nodes=1200, partitions=4, ticks=24),
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        quality=dict(utilization_mean=0.477, jain_fairness=1.0, production_wait_p95=None,
                     gang_wait_p95_ticks=15.0, preempted_total=0, backfill_binds=None, resizes=0,
                     unbound_final=1107, drained_at_tick=None, recovery_ticks=None)),
    # --sim diurnal_load --scale 10 --arm backfill_off: 20.934 s, 773 MiB
    "diurnal_load/backfill_off": dict(
        digest="d1a74c2443e9a88cdb2ef15ed7c20ec26fccea427a8c8eb5efd22b3ecf634bde",
        final_state_digest="15104e857000801d97cd4a1f6383359bcd80192aa4d77b4950fb6d175688d540",
        events_sha256="6c75dc073eec89071c8f8e9028696fefb25b9dbb722d0c53b81e35f164bcaa45",
        scorecard_sha256="75f72dbea626d9d01d27220d6dcb4d740f675c7d4b04ac6bd70cb62cbaef0dce",
        bound_total=13755, preempted_total=0, restarts=0,
        shape=dict(pods=14880, nodes=1200, partitions=4, ticks=24),
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        quality=dict(utilization_mean=0.4769, jain_fairness=1.0, production_wait_p95=None,
                     gang_wait_p95_ticks=15.0, preempted_total=0, backfill_binds=0, resizes=0,
                     unbound_final=1125, drained_at_tick=None, recovery_ticks=None)),
    # --sim elastic_resize --scale 33 --arm on: 34.798 s, 1,536 MiB
    "elastic_resize/on": dict(
        digest="e0a32e6e5cd458fa34474cca319a0bd000a06669f4987305282d59829493565e",
        final_state_digest="ba1409d0dbcbc4ce356270b0c0a106509e994e7953cfc3148c7c810524febdb3",
        events_sha256="c0348c0be5a4357c30c0c1565bb76ee09c9ea66ded9c65b6813885f4ee2d3ef0",
        scorecard_sha256="ecf6fa228938c30995fd776b16fd5b04280e585c37028ba2baf6a3170aedd2d6",
        bound_total=29700, preempted_total=0, restarts=0,
        shape=dict(pods=26400, nodes=9900, partitions=4, ticks=18),
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0],
        quality=dict(utilization_mean=0.2311, jain_fairness=1.0, production_wait_p95=None,
                     gang_wait_p95_ticks=1.0, preempted_total=0, backfill_binds=0, resizes=3300,
                     unbound_final=0, drained_at_tick=17, recovery_ticks=3)),
}
#: Phase [16]'s cells: every fault scenario of ``sim/cli.py``'s smoke,
#: chaos and shard gates, at the JAX package's own scale knob. Group A
#: (``hold``): the two faults that change what the kernel sees — a
#: vanished partition (4,800 nodes, 12,800 jobs) and drained nodes under
#: stale inventory and lost status (2,400 nodes, 7,200 jobs); their fault
#: ticks' kernel calls are held against the plain version
#: (:func:`held_fault_ticks`). Group B at scale 1 (150-900 nodes): the
#: RPC flaps, the preemption storm, the bridge and agent crashes, the
#: leader failover and the sharded fan-out. A scenario with a
#: ``lossless_twin`` also runs its crash-free arm.
FAULT_CELLS = dict(
    # group A cut from 32 and 16 (the headline's cluster width): there the
    # phase took 137.8 s and 174.7 s in two runs on an NVIDIA H100 80GB HBM3
    # at 700 W, over its 150 s in the second
    partition_vanish=dict(scale=16, hold=True),
    node_churn=dict(scale=8, hold=True),
    # group B cut from scale 2: there the phase took 173.2 s with an NVIDIA
    # H100 80GB HBM3 at 700 W, over its 150 s (group B 125.9 s, most of each
    # run the snapshot compactions and restarts, not its ticks); and at 2
    # sharded_gang_split's shards (480 // 40 = 12 nodes) hold its 8-node
    # gangs, so nothing reconciles across shards in either package: at 1
    # (240 // 40 = 6) every gang must
    agent_flaky_rpc=dict(scale=1),
    preemption_storm=dict(scale=1),
    crash_restart=dict(scale=1),
    leader_failover=dict(scale=1),
    agent_crash=dict(scale=1),
    chaos_dual_crash=dict(scale=1),
    chaos_crash_rpc_flap=dict(scale=1),
    chaos_crash_into_vanished_partition=dict(scale=1),
    sharded_smoke=dict(scale=1),
    sharded_gang_split=dict(scale=1),
)
#: The JAX package's simulator on each run of :data:`FAULT_CELLS` (arm
#: ``on``, and ``crash_free`` for a ``lossless_twin`` scenario) at its
#: scale, with the engine pinned as :func:`pin_auction` pins it, on the
#: CPU, from ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim NAME
#: --scale S --arm ARM`` (its ``fault`` and ``solves``; wall time and peak
#: RSS beside each, up to four runs at a time on an 8-core host):
#: :func:`fault_record` and each tick's solves.
FAULT_REFERENCE = {
    # --sim partition_vanish --scale 16 --arm on: 14.288 s, 750 MiB
    "partition_vanish/on": dict(
        digest="f890e28c0f2b61c1f99b4f2d8a855c858dab91ac5443b4475d5301ae6b5e124e",
        final_state_digest="303346cbc22b2ad36bbac5f83bcf992d9ec977c385a70893bc6ab4cdaf8dda75",
        final_outcome_digest="f14af531dc53ab52cf78a4ea7d9b29837d2b1dad0028718d9d8b85893748bc26",
        bound_total=12800, violations=0, recovery_ticks=1, restarts=0, agent_restarts=0,
        vnode_deletions=1, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 38, 'NO_READY_VNODE': 8689},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]),
    # --sim node_churn --scale 8 --arm on: 7.62 s, 605 MiB
    "node_churn/on": dict(
        digest="5850891e6a23d72801e8434abe134aa7ce1abe2789f490efd00bcd6a5caba002",
        final_state_digest="5f16bb4d64e1a7d338b245a1e85a1ef95965785bb6ec32c0c91992411b4c5555",
        final_outcome_digest="3e3c9ffbd55eedad37d838ce84a921b6a30738d8d7d1c3d1a612205f1f3ea7a8",
        bound_total=7173, violations=0, recovery_ticks=0, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 5, 'NO_READY_VNODE': 875},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0]),
    # --sim agent_flaky_rpc --scale 1 --arm on: 1.606 s, 488 MiB
    "agent_flaky_rpc/on": dict(
        digest="26e78f9acd07db5911eabf238305f39e5e2920e33dc234b2c108366d92fb9cc3",
        final_state_digest="cd75701440f34666367f1f8997a20e60a864b2bc009f2eec67f9a89bec8cb65a",
        final_outcome_digest="1f055366046db5c056ee7fbd414231f2c150b994203f5213d5fc30604601ff84",
        bound_total=1000, violations=0, recovery_ticks=1, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 5, 'NO_READY_VNODE': 126, 'PARTITION_FULL': 19},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]),
    # --sim preemption_storm --scale 1 --arm on: 1.746 s, 476 MiB
    "preemption_storm/on": dict(
        digest="1a9b86e7a6fc34ecfb2a74b13c5ae429d2389b4efb4201ab0ef506383dc64b8b",
        final_state_digest="87c5ddd68279f1cd15b27cc92a3e3e51386a2c62dd76803ffa831cc1d8fa84e8",
        final_outcome_digest="7df8b0e340d6bec14ec263b823549326d6051413960921dd7e925801ac69962e",
        bound_total=1287, violations=0, recovery_ticks=12, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 1130, 'NO_READY_VNODE': 182},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]),
    # --sim crash_restart --scale 1 --arm on: 3.891 s, 509 MiB
    "crash_restart/on": dict(
        digest="4bc6d8efde963cf68d4552c8e38f9eead92ca77fd5582db413347a5ca5c7ed87",
        final_state_digest="20d58326a3b4e1729c43a90c9cd5715168524996638112a90f189a2ad470d145",
        final_outcome_digest="73c0c4b834be22ef47e55f35e0eae856eb4046ceca54a9940115660b8a12d808",
        bound_total=900, violations=0, recovery_ticks=4, restarts=1, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 22, 'NO_READY_VNODE': 93, 'PARTITION_FULL': 3},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]),
    # --sim crash_restart --scale 1 --arm crash_free: 3.809 s, 519 MiB
    "crash_restart/crash_free": dict(
        digest="67b24b179901742c4f16231bcb6555830796a91cd17e76bb17471db8b1b77769",
        final_state_digest="20d58326a3b4e1729c43a90c9cd5715168524996638112a90f189a2ad470d145",
        final_outcome_digest="73c0c4b834be22ef47e55f35e0eae856eb4046ceca54a9940115660b8a12d808",
        bound_total=900, violations=0, recovery_ticks=None, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 22, 'NO_READY_VNODE': 93, 'PARTITION_FULL': 3},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]),
    # --sim leader_failover --scale 1 --arm on: 5.074 s, 516 MiB
    "leader_failover/on": dict(
        digest="8b8e883e2ea85c8926b63bfb5939613a1d959a0d6b578d1a89e6e2f36b81b400",
        final_state_digest="72a7c8aed347e1052f6e21f01c90ab96518095cf32e055dd49c37f4e9e06f126",
        final_outcome_digest="d608d710f6f385a3d56165d2b623e42fd08149e32e0d36ae557aaff7b0e27e42",
        bound_total=800, violations=0, recovery_ticks=0, restarts=2, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'NO_READY_VNODE': 99},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]),
    # --sim agent_crash --scale 1 --arm on: 1.831 s, 474 MiB
    "agent_crash/on": dict(
        digest="4b7df131220363f77e1661cbb8e60ffd0ea311d045c0e16341b3a869065d5868",
        final_state_digest="76dcfaaa026a1939cef602cfa9f473d4535b066ec16ddc76e605bb86827e00c8",
        final_outcome_digest="ed6b52d1e547bd1de141c5d2686d6ac5fd24441d2ceb906b4990c3d3488eb795",
        bound_total=759, violations=0, recovery_ticks=12, restarts=0, agent_restarts=1,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 21, 'NO_READY_VNODE': 101, 'PARTITION_FULL': 38},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]),
    # --sim agent_crash --scale 1 --arm crash_free: 2.264 s, 492 MiB
    "agent_crash/crash_free": dict(
        digest="ed8ed8c015bb3349a8c757b1ec586689e07f93d5f9a636e2551882c9a0aa6c8c",
        final_state_digest="76dcfaaa026a1939cef602cfa9f473d4535b066ec16ddc76e605bb86827e00c8",
        final_outcome_digest="ed6b52d1e547bd1de141c5d2686d6ac5fd24441d2ceb906b4990c3d3488eb795",
        bound_total=759, violations=0, recovery_ticks=None, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 21, 'NO_READY_VNODE': 101, 'PARTITION_FULL': 38},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]),
    # --sim chaos_dual_crash --scale 1 --arm on: 3.646 s, 488 MiB
    "chaos_dual_crash/on": dict(
        digest="1a67ffa863dbb9187bfc28929097cb76d88167315034ab0c2f100b7b08a1f36a",
        final_state_digest="017a277c783922bf6c859e175a709e7fc88ffbbc77748ce3aa1cff239af6baf2",
        final_outcome_digest="649566933bbf08e956f589cc68a9105c3e6ed0bef47040f4361f35af61774473",
        bound_total=900, violations=0, recovery_ticks=5, restarts=1, agent_restarts=1,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 11, 'NO_READY_VNODE': 115, 'PARTITION_FULL': 11},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0]),
    # --sim chaos_dual_crash --scale 1 --arm crash_free: 3.0 s, 490 MiB
    "chaos_dual_crash/crash_free": dict(
        digest="b5e5675ebd4e16aab84257d0a662933cca36a81308c7c7b6cb455a2b5a62f845",
        final_state_digest="017a277c783922bf6c859e175a709e7fc88ffbbc77748ce3aa1cff239af6baf2",
        final_outcome_digest="649566933bbf08e956f589cc68a9105c3e6ed0bef47040f4361f35af61774473",
        bound_total=900, violations=0, recovery_ticks=None, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 11, 'NO_READY_VNODE': 115, 'PARTITION_FULL': 11},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0]),
    # --sim chaos_crash_rpc_flap --scale 1 --arm on: 4.157 s, 506 MiB
    "chaos_crash_rpc_flap/on": dict(
        digest="5ab49a79ad1dbdc3753e2ca3b3f753a10760e1050887d5f3d11d4a8b05d25e45",
        final_state_digest="9236c74c6999a0e0a97feab756133b5108d7aa34d96c0460cc5c2b5491dc2e3f",
        final_outcome_digest="9818047b63938f226879a0d260ba1273a3020722d462bc79d20c58717467535d",
        bound_total=900, violations=0, recovery_ticks=0, restarts=1, agent_restarts=0,
        vnode_deletions=0, rpc_retries=29,
        wait_reasons={'FRAGMENTED': 5, 'NO_READY_VNODE': 116},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]),
    # --sim chaos_crash_rpc_flap --scale 1 --arm crash_free: 3.489 s, 501 MiB
    "chaos_crash_rpc_flap/crash_free": dict(
        digest="beb6031e8686a33bccaade2959c82c9f887e02d32b83633e2b14dfd0ab3a2a3e",
        final_state_digest="9236c74c6999a0e0a97feab756133b5108d7aa34d96c0460cc5c2b5491dc2e3f",
        final_outcome_digest="9818047b63938f226879a0d260ba1273a3020722d462bc79d20c58717467535d",
        bound_total=900, violations=0, recovery_ticks=0, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=27,
        wait_reasons={'FRAGMENTED': 5, 'NO_READY_VNODE': 116},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]),
    # --sim chaos_crash_into_vanished_partition --scale 1 --arm on: 4.505 s, 537 MiB
    "chaos_crash_into_vanished_partition/on": dict(
        digest="d18682934c4524030cf74a1f184f56a9ba163e355642e3c561556f3cfcf3664b",
        final_state_digest="42a45c1d159eea89658d07688c231d172f31feddba1d0fad940fdfaa6ca8cf12",
        final_outcome_digest="25fabf7e559b5d4825ac65b670e25bae9bdaa850a377291e4957b366fbbd57eb",
        bound_total=789, violations=0, recovery_ticks=0, restarts=1, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 4, 'NO_READY_VNODE': 143},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]),
    # --sim chaos_crash_into_vanished_partition --scale 1 --arm crash_free: 3.466 s, 516 MiB
    "chaos_crash_into_vanished_partition/crash_free": dict(
        digest="72a5d4d24a09eb9fc84ffd004486f6a7be77e20fb6e9d1cc3b51aec4da1611f1",
        final_state_digest="42a45c1d159eea89658d07688c231d172f31feddba1d0fad940fdfaa6ca8cf12",
        final_outcome_digest="25fabf7e559b5d4825ac65b670e25bae9bdaa850a377291e4957b366fbbd57eb",
        bound_total=789, violations=0, recovery_ticks=0, restarts=0, agent_restarts=0,
        vnode_deletions=1, rpc_retries=0,
        wait_reasons={'FRAGMENTED': 4, 'NO_READY_VNODE': 143},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]),
    # --sim sharded_smoke --scale 1 --arm on: 6.119 s, 570 MiB
    "sharded_smoke/on": dict(
        digest="3d43da9ea6208ff850f924e945278fb063b5943433ce696dcb6667e86c34a520",
        final_state_digest="8743b41961ba8220227e89b2998f2bfc24f883a72747b1ae91cbcf54eb4e9e98",
        final_outcome_digest="4b3e1faca52a10d4049a9ab7d7b1a9ded6ddca2404b4f381aa62e99450dc9e7c",
        bound_total=2372, violations=0, recovery_ticks=None, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0, shard_count=11, reconcile_placed=0,
        wait_reasons={'FRAGMENTED': 97, 'NO_READY_VNODE': 286, 'PARTITION_FULL': 87},
        solves=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]),
    # --sim sharded_gang_split --scale 1 --arm on: 3.943 s, 548 MiB
    "sharded_gang_split/on": dict(
        digest="50b2620cf33a3e6d48b9ab22d2b4db39ec89969fc824d98ff5cd15acf436913d",
        final_state_digest="622954796d9e6f46ef1bbc21323d98bf24d8ecc706997876a78eae90e5c2579b",
        final_outcome_digest="2af5f8e336aa13c21c084dd600c23ea4472131991ce530e6205c84090f4aefb2",
        bound_total=400, violations=0, recovery_ticks=None, restarts=0, agent_restarts=0,
        vnode_deletions=0, rpc_retries=0, shard_count=41, reconcile_placed=230,
        wait_reasons={'NO_READY_VNODE': 64},
        solves=[1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]),

}
#: The JAX package's ``interactive_storm`` at :data:`STORM_SCALE` with its
#: streaming admission off (``admission=None``), the auction pinned, on the
#: CPU, from ``JAX_PLATFORMS=cpu python tools/port_reference.py --sim
#: interactive_storm --scale 40 --arm admission_off`` (60.8 s wall and
#: 1,541 MiB peak RSS on an 8-core host, three runs at a time).
STORM_OFF_REFERENCE = dict(
    digest="1d50cf15a4608c5e3ba21bacdb11021c891937e79216acb5e695b9f230a8a2da",
    final_state_digest="d887eea68f554c5bc4987d3db76220905c3bf51549d4dad4d79c69d45f5a3151",
    bound_total=43692,
    scorecard_sha256="272328928a6f1e7fbf7cbb1a5d8380636cee3a83ea96747f9c7838a1a033f73d",
    utilization_mean=0.2367,
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
#: jobs outran the phase's deadline and 250 took ~4 minutes to succeed; 120
#: took 86.4-184.7 s (an NVIDIA H100 80GB HBM3 at 700 W), and 60 (one gang,
#: six asking GPUs) leave room in the run's 1,200 s for phase [15].
BRIDGE = dict(num_nodes=10_000, num_jobs=60)
#: The JAX package's ``Bridge`` first placing tick at :data:`BRIDGE` over the
#: fake Slurm CLI (pods bound, :func:`bridge_digest`), from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --bridge``.
BRIDGE_REFERENCE = dict(
    placed=60,
    bridge_sha256="3412a5f8a431b7141e8bed7f5ee10ce48de7824a7588e61d347337fc6af71a92",
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
#: BASELINE config #4 (``benchmarks/scenarios/__init__.py`` ``scenario_4``):
#: gang MPI jobsets on a fragmented cluster, 54,056 shards (89 % of them in
#: 8-shard gangs) × 10,000 nodes, and its solve — the one BASELINE config
#: with a best-fit affinity, a 16-round auction, 8 salvage rounds and the
#: gang-first boost. Config #2 (``scenario_2``): 5,000 pods on 512 nodes.
BASELINE4 = dict(num_nodes=10_000, num_jobs=12_000, seed=4, load=0.8, gang_fraction=0.5,
                 gang_size=8)
BASELINE4_SOLVE = dict(rounds=16, gang_salvage_rounds=8, gang_first=True, affinity_weight=0.05)
BASELINE2 = dict(num_nodes=512, num_jobs=5_000, seed=2, load=0.7)
BASELINE2_SOLVE = dict(rounds=8)
#: The sampled auction path's candidates per shard in phase [13].
SAMPLED_K = 64
#: The JAX package's dense solves of configs #4 and #2 on the CPU with
#: their own solve configs, from ``JAX_PLATFORMS=cpu python
#: tools/port_reference.py --baseline 4`` (32.3 s wall, 5,121 MiB peak RSS
#: on an 8-core host) and ``--baseline 2``.
BASELINE4_REFERENCE = dict(
    shards=54_056,
    dense=dict(node_of_sha256="63f4661bfa14279007903052a5ef03b3303e396316fdf2154e4ece7a1c4cbca5",
               placed_jobs=11_894, placed_shards=53_950),
)
BASELINE2_REFERENCE = dict(
    node_of_sha256="f5e33a22010e9d186418cbf57a6986d07149101c4f8d87366f4288f887d8eb87",
    placed_jobs=5_000, placed_shards=5_000,
)
#: The JAX package's sampled solves (``candidates=64``) of the headline
#: (``rounds=8``) and of config #4 (its own config) on the CPU, from
#: ``tools/port_reference.py --nodes 10000 --jobs 50000 --candidates 64``
#: and ``--baseline 4 --candidates 64``.
SAMPLED_REFERENCE = dict(
    headline=dict(node_of_sha256="3a4a7d874fc686a971f57edbe92643c29655bd649ddb5e13ae729fbafb1f6a00",
                  placed_jobs=45_531, placed_shards=52_332),
    config4=dict(node_of_sha256="49f5251a8dfd4150277b7911e1516aab0b88eb06a456d82a0c12a64af3f20084",
                 placed_jobs=11_641, placed_shards=53_697),
)
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


def json_digest(obj) -> str:
    """sha256 of ``obj`` as sorted-key JSON."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def virtual_scorecard(quality: dict) -> dict:
    """A run's scorecard without its wall-clock latencies and the fleet's
    transport counters: what two runs of one scenario on either package
    must agree on."""
    return {k: v for k, v in quality.items() if "latency" not in k and k != "fleet_remote"}


def arm_scenario(sc, arm: str, policy_config_cls, crash_kinds=()):
    """``sc`` under one of :data:`QUALITY_ARMS`, as ``sim/cli.py``'s
    quality, admission and smoke gates build their twins
    (``policy_config_cls``: either package's ``PolicyConfig``;
    ``crash_kinds``: for ``crash_free``, either package's
    ``sim.faults.BRIDGE_KINDS + AGENT_KINDS``)."""
    import dataclasses

    if arm == "crash_free":
        require(crash_kinds, "the crash-free arm needs the bridge and agent fault kinds")
        return dataclasses.replace(sc, faults=sc.faults.strip(tuple(crash_kinds)))
    replace = dict(on={}, policy_off=dict(policy=None),
                   backfill_off=dict(policy=policy_config_cls(backfill=False)),
                   admission_off=dict(admission=None), full_tick=dict(incremental=False))[arm]
    return dataclasses.replace(sc, **replace)


def quality_summary(determinism: dict, quality: dict) -> dict:
    """The scorecard numbers the quality and admission gates read."""
    return dict(
        utilization_mean=quality["utilization_mean"],
        jain_fairness=quality["jain_fairness"],
        production_wait_p95=quality["class_wait_p95_ticks"].get("production"),
        gang_wait_p95_ticks=quality["gang_wait_p95_ticks"],
        preempted_total=quality["preempted_total"],
        backfill_binds=quality.get("backfill_binds"),
        resizes=quality["resizes"],
        unbound_final=quality["unbound_final"],
        drained_at_tick=determinism["drained_at_tick"],
        recovery_ticks=determinism["recovery_ticks"],
    )


def arm_record(result) -> dict:
    """What an arm's run (either package's ``ScenarioResult``) is held to:
    digests, bound, preempted, restarts, the events' and the scorecard's
    digests, the shape and :func:`quality_summary`."""
    d, q = result.determinism, result.quality
    return dict(digest=d["digest"], final_state_digest=d["final_state_digest"],
                bound_total=d["bound_total"], preempted_total=d["preempted_total"],
                restarts=d["restarts"], events_sha256=json_digest(d["events"]),
                scorecard_sha256=json_digest(virtual_scorecard(q)), shape=result.shape,
                quality=quality_summary(d, q))


def fault_record(result) -> dict:
    """What a fault scenario's run (either package's ``ScenarioResult``)
    is held to: its digests and bound, the violations, the recovery and
    restart counts, virtual-node deletions, the RPC retries the retry
    layer absorbed, the scorecard's wait reasons, and for a sharded run
    the plan's shard count and what the cross-shard reconcile placed —
    what ``sim/cli.py``'s ``_smoke`` prints and gates on."""
    d = result.determinism
    rec = dict(digest=d["digest"], final_state_digest=d["final_state_digest"],
               final_outcome_digest=d["final_outcome_digest"], bound_total=d["bound_total"],
               violations=len(d["invariant_violations"]), recovery_ticks=d["recovery_ticks"],
               restarts=d["restarts"], agent_restarts=d["agent_restarts"],
               vnode_deletions=d["vnode_deletions"], rpc_retries=sum(d["rpc_retries"].values()),
               wait_reasons=dict(result.quality.get("wait_reasons", {})))
    if "shard" in d:
        rec.update(shard_count=d["shard"]["shard_count"],
                   reconcile_placed=d["shard"]["reconcile_placed"])
    return rec


def fault_gates(name: str, sc, rec: dict, twin: dict | None, bridge_kinds, agent_kinds) -> list:
    """``sim/cli.py``'s ``_smoke`` gates on one run of scenario ``name``
    (``sc``: the scenario it ran; ``rec``: its :func:`fault_record`;
    ``twin``: the crash-free twin's record where ``sc.lossless_twin`` asks
    for one; the kinds: either package's ``sim.faults.BRIDGE_KINDS`` and
    ``AGENT_KINDS``). The CLI also runs each scenario twice and compares
    the runs; a run held to the JAX package's digests is held to more
    than that. Returns (gate, holds, values) for each."""
    kinds = {f.kind for f in sc.faults.faults}
    reasons = rec["wait_reasons"]
    out = [("no invariant violated", rec["violations"] == 0, f"{rec['violations']} violations")]
    if sc.explain:
        out.append(("no UNKNOWN wait reason", not reasons.get("UNKNOWN"),
                    f"{reasons.get('UNKNOWN', 0)} UNKNOWN"))
    if sc.faults and sc.expect_drain:
        rt, bound = rec["recovery_ticks"], sc.max_recovery_ticks
        out.append(("recovered within bound", rt is not None and (bound is None or rt <= bound),
                    f"{rt} <= {bound}"))
    if kinds & set(bridge_kinds):
        out += [("no virtual node deleted", rec["vnode_deletions"] == 0,
                 f"{rec['vnode_deletions']} deletions"),
                ("bridge restarted", rec["restarts"] >= 1, f"{rec['restarts']} restarts")]
    if kinds & set(agent_kinds):
        out.append(("agent restarted", rec["agent_restarts"] >= 1,
                    f"{rec['agent_restarts']} agent restarts"))
    if sc.lossless_twin:
        key = "final_state_digest" if sc.lossless_twin == "state" else "final_outcome_digest"
        out.append((f"crash-free twin's {key} equal", twin is not None and twin[key] == rec[key],
                    f"{rec[key][:16]}… vs {twin[key][:16] if twin else None}…"))
    if sc.sharding is not None:
        out.append(("plan shards", rec["shard_count"] >= 2, f"{rec['shard_count']} shards"))
        if name == "sharded_gang_split":
            out.append(("cross-shard reconcile placed", rec["reconcile_placed"] > 0,
                        f"{rec['reconcile_placed']} placed"))
            if sc.explain:
                out.append(("wait reasons recorded", bool(reasons), f"{len(reasons)} reasons"))
    return out


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
    finite values, which must be 0: values and choices bit-exact at every
    ``affinity_weight`` and ``jitter`` (both round the bid alike, the
    affinity's fused steps included). ``got`` is the kernel's (values,
    choices) from a launch already made on these operands; without it the
    kernel is launched here. ``p_base``/``n_base`` are a sweep block's
    global offsets."""
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
    require(exact, f"{label}: kernel and plain differ at affinity_weight={aw}, jitter={jitter}")
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


def bounds(kern, cells: int, nbytes: int, sm_hz: float, affinity: bool = False):
    """(roofline ms, what bounds it, per-pipe issue ceiling ms) for
    ``cells`` needed cells and ``nbytes`` of operands, at the cell loop's
    instruction counts without the affinity term or (``affinity``) with
    it."""
    c = kern.CELL_OPS_AFF if affinity else kern.CELL_OPS
    ops = (c["int"] + c["f32"] + c["cvt"]) * cells
    roof_s = max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
    bound_by = "operations" if ops / ALU_OPS_PER_S > nbytes / HBM_BYTES_PER_S else "bytes"
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
    ``AuctionConfig(rounds=8, candidates=0)``, or a scenario's own
    auction (``diurnal_load``'s) with only ``candidates=0``; each shard
    of a sharded scenario on the single-device auction."""
    import dataclasses

    from slurm_bridge_tpu_torch.solver import AuctionConfig

    if sc.backend == "auction" and sc.auction_config is not None:
        cfg = dataclasses.replace(sc.auction_config, candidates=0)
    else:
        cfg = AuctionConfig(rounds=ROUNDS, candidates=0)
    sc = dataclasses.replace(sc, backend="auction", auction_config=cfg)
    if sc.sharding is not None:
        sc = dataclasses.replace(sc, sharding=dataclasses.replace(sc.sharding, device_solve=False))
    return sc


def run_sim(kern, smi: str, sc, label: str, keep=(), deadline_s: float | None = None,
            checkpoint: int | None = None) -> dict:
    """One scenario through ``SimHarness`` on the card, counting each
    tick's kernel launches and solves, noting which scheduler ran it (a
    restart builds a new one) and reading the harness's own tick record
    (store commits, ``JobsInfo`` calls, the steady verdict); the kernel
    calls of the ticks in ``keep`` are kept (operands and results,
    untimed). After tick ``checkpoint`` it takes a copy of the running
    trace digest, the final-state digest and the bound count: what a
    run that ended there would report. Prints each tick's phases. With
    ``deadline_s``, a tick that ends more than that many seconds after
    the harness was built fails the run. Returns {result, ticks, kept,
    at (the checkpoint's), wall_s, harness}."""
    from slurm_bridge_tpu_torch.sim.harness import PHASES, SimHarness

    t_built = time.perf_counter()
    h = SimHarness(sc, device="cuda")
    ticks, kept, at = [], {}, {}
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
        meta = h._tick_meta[-1]
        ticks.append(dict(launches=kern.LAUNCHES - before, solves=solves, phases=phases,
                          restarted=restarted, commits=meta["commits"],
                          status_rpcs=meta["jobsinfo_calls"], steady=meta["steady"]))
        if tick == checkpoint:
            at.update(digest=h._digest.copy().hexdigest(),
                      final_state_digest=h._final_state_digest(), bound_total=h._bound_total)
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
            + f" ms), solves {t['solves']}, kernel launches {t['launches']}, store commits "
            f"{t['commits']}, JobsInfo calls {t['status_rpcs']}"
            + (", steady" if t["steady"] else "") + f" [{smi}]")
    return dict(result=result, ticks=ticks, kept=kept, at=at, wall_s=wall_s, harness=h)


def check_steady(label: str, run: dict, sc, want: dict):
    """The steady ticks of a ``*_steady`` run (:func:`run_sim`): as many
    as the JAX package's run has, each with no solve, no kernel launch,
    no store commit and as many ``JobsInfo`` calls as each of the JAX
    package's, and their tick p50 within the scenario's
    ``steady_gate_ms``, as ``sim/cli.py`` requires it. Returns the
    steady ticks' indices and p50."""
    tm, ticks = run["result"].timing, run["ticks"]
    steady = [i for i, t in enumerate(ticks) if t["steady"]]
    p50 = tm["steady_tick_p50_ms"]
    log(f"  {label}: steady ticks {steady}, steady tick p50 "
        f"{p50 if p50 is None else round(p50, 3)} ms (the scenario's gate {sc.steady_gate_ms:.0f} "
        f"ms), JobsInfo calls per steady tick {[ticks[i]['status_rpcs'] for i in steady]}")
    require(tm["steady_ticks"] == len(steady) == want["steady_ticks"],
            f"{label}: {tm['steady_ticks']} steady ticks, the JAX package's run "
            f"{want['steady_ticks']}")
    for i in steady:
        t = ticks[i]
        require(t["solves"] == 0 and t["launches"] == 0 and t["commits"] == 0,
                f"{label}: steady tick {i} solved {t['solves']} times, launched the kernel "
                f"{t['launches']} times, committed {t['commits']} writes")
        require(t["status_rpcs"] == want["steady_jobsinfo_calls"],
                f"{label}: steady tick {i} made {t['status_rpcs']} JobsInfo calls, the JAX "
                f"package's {want['steady_jobsinfo_calls']}")
    require(p50 is not None and p50 <= sc.steady_gate_ms,
            f"{label}: steady_tick_p50_ms {p50} over the {sc.steady_gate_ms} ms gate")
    return dict(ticks=steady, p50_ms=p50, gate_ms=sc.steady_gate_ms)


def check_checkpoint(label: str, run: dict, want: dict, twin: str) -> None:
    """A ``*_steady`` run after :data:`STEADY_CHECKPOINT_TICK` against
    the reference of its 3-tick ``twin``, which ends there."""
    at = run["at"]
    log(f"  after tick {STEADY_CHECKPOINT_TICK}: digest {at['digest'][:16]}…, final state "
        f"{at['final_state_digest'][:16]}…, bound {at['bound_total']}")
    for key in ("digest", "final_state_digest", "bound_total"):
        require(at[key] == want[key],
                f"{label} after tick {STEADY_CHECKPOINT_TICK}: {key} {at[key]} differs from the "
                f"JAX package's {twin} ({want[key]})")


def sim_phase(kern, smi: str) -> dict:
    """Phase 6: the bridge's job lifecycle on the simulated cluster at
    full width and its steady state (module docstring). Returns what the
    kernels line and the summary print."""
    import dataclasses

    import slurm_bridge_tpu_torch.bridge.vnode as vnode
    from slurm_bridge_tpu_torch.sim.scenarios import full_50kx10k, full_50kx10k_steady
    from slurm_bridge_tpu_torch.wire import coldec

    require(coldec.available(), "the column decoder's tables do not match the port's schema")

    counters = (coldec.rows_counter(), coldec.fallback_counter(), vnode._submit_pool_chunks)
    before = [c.total() for c in counters]
    pinned = pin_auction(full_50kx10k_steady(scale=1.0))
    require((pinned.cluster.num_nodes, pinned.workload.jobs, pinned.ticks) == (10_000, 50_000, 6),
            "full_50kx10k_steady is not at full width")
    run = run_sim(kern, smi, pinned, "full_50kx10k_steady", keep=(0,),
                  checkpoint=STEADY_CHECKPOINT_TICK)
    result, ticks = run["result"], run["ticks"]
    tick0 = run["kept"].get(0, [])
    rows, fallbacks, pool_chunks = (c.total() - b for c, b in zip(counters, before))
    d = result.determinism
    log(f"  digest {d['digest'][:16]}…, final state {d['final_state_digest'][:16]}…, "
        f"bound {d['bound_total']}, violations {len(d['invariant_violations'])}; "
        f"coldec rows {rows:.0f}, fallbacks {fallbacks:.0f}, pool submit chunks {pool_chunks:.0f}; "
        f"tick p50 {result.timing['tick_p50_ms']:.1f} ms, phase wall {run['wall_s']:.1f} s [{smi}]")
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    check_checkpoint("full_50kx10k_steady", run, SIM_REFERENCE, "full_50kx10k")
    for key in ("digest", "final_state_digest", "bound_total"):
        require(d[key] == SIM_STEADY_REFERENCE[key],
                f"full_50kx10k_steady {key} {d[key]} differs from the JAX package's "
                f"{SIM_STEADY_REFERENCE[key]}")
    steady = check_steady("full_50kx10k_steady", run, pinned, SIM_STEADY_REFERENCE)
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

    auto = run_sim(kern, smi, dataclasses.replace(full_50kx10k(scale=1.0), ticks=1),
                   "full_50kx10k, backend auto, 1 tick")
    auto_launches = sum(t["launches"] for t in auto["ticks"])
    require(auto_launches > 0, "the auto-routed run never reached the card")
    require(auto["result"].determinism["invariant_violations"] == [],
            "violations in the auto-routed run")
    log(f"  auto route: kernel launches {auto_launches}, bound "
        f"{auto['result'].determinism['bound_total']} after 1 tick (the JAX package's "
        f"native-routed 3-tick run binds {SIM_NATIVE_BOUND}); {auto['wall_s']:.1f} s [{smi}]")
    return dict(result=result, ticks=ticks, errs=errs, wall_s=run["wall_s"], steady=steady,
                auto_launches=auto_launches)


def crash_phase(kern, smi: str) -> dict:
    """Phase 7: recovery at full width (module docstring). Returns what
    the kernels line and the summary print."""
    from slurm_bridge_tpu_torch.sim.scenarios import full_50kx10k_crash

    sc = pin_auction(full_50kx10k_crash(scale=1.0))
    require((sc.cluster.num_nodes, sc.workload.jobs, sc.ticks) == (10_000, 50_000, 4),
            "full_50kx10k_crash is not at full width")
    crash_tick = sc.faults.faults[0].start_tick
    run = run_sim(kern, smi, sc, "full_50kx10k_crash", keep=range(crash_tick, sc.ticks))
    result, ticks, kept, wall_s = run["result"], run["ticks"], run["kept"], run["wall_s"]
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


def shard_phase(kern, smi: str, sm_hz: float, settle=None) -> dict:
    """Phase 8: the sharded tick at the headline's full size and its
    steady state (module docstring); ``sm_hz`` is phase 3's SM clock, for
    the timed solves' issue ceiling; ``settle``, if given, is called
    before those solves are timed (no other process may then use the
    card). Returns what the kernels line and the summary print."""
    import resource

    import slurm_bridge_tpu_torch.solver.session as session
    from slurm_bridge_tpu_torch.sim.scenarios import full_500kx100k, full_500kx100k_steady

    sc = pin_auction(full_500kx100k_steady(scale=1.0))
    require((sc.cluster.num_nodes, sc.cluster.num_partitions, sc.workload.jobs, sc.ticks)
            == (100_000, 16, 500_000, 6), "full_500kx100k_steady is not at full size")
    require((sc.sharding.max_nodes_per_shard, sc.sharding.workers) == (8192, 2), sc.sharding)
    # the 3-tick twin's gates, printed over ticks 0-2 (the twin's ticks)
    twin = full_500kx100k(scale=1.0)
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
        run = run_sim(kern, smi, sc, "full_500kx100k_steady", keep=(0,),
                      deadline_s=SHARD_DEADLINE_S, checkpoint=STEADY_CHECKPOINT_TICK)
    finally:
        session.DeviceSolver.solve = real_solve
    # the main path's launches and memory, read before the checks below
    # launch the kernel again
    launches = kern.LAUNCHES
    device_peak = torch.cuda.max_memory_allocated()
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    result, ticks, kept, wall_s = run["result"], run["ticks"], run["kept"], run["wall_s"]
    d = result.determinism
    shard = d["shard"]
    # tick 0 solves every shard once (every partition holds front-loaded
    # jobs): its solves' node counts are the plan's shard sizes
    sizes = sorted((sv["nodes"] for sv in solves[:ticks[0]["launches"] // ROUNDS]), reverse=True)
    log(f"  plan: {len(sizes)} shards of {sizes} nodes [{smi}]")
    for i, sv in enumerate(solves):
        log(f"  shard solve {i}: {sv['rows']} rows x {sv['nodes']} nodes, kernel launches "
            f"{sv['launches']}, {sv['ms']:.1f} ms [{smi}]")
    first = range(STEADY_CHECKPOINT_TICK + 1)
    p50_3 = statistics.median(ticks[i]["phases"]["tick"] for i in first)
    flight = run["harness"].flight
    span = statistics.median(flight.records[i]["total_ms"] for i in first)
    phase_sum = statistics.median(sum(flight.phases_ms(flight.records[i]).values()) for i in first)
    drift = abs(span - phase_sum) / span * 100.0 if span > 0 else float("nan")
    log(f"  digest {d['digest'][:16]}…, final state {d['final_state_digest'][:16]}…, "
        f"bound {d['bound_total']}, shards {shard['shard_count']}, reconcile placed "
        f"{shard['reconcile_placed']}, violations {len(d['invariant_violations'])}; tick p50 "
        f"over ticks 0-{STEADY_CHECKPOINT_TICK} {p50_3:.1f} ms (full_500kx100k's gate "
        f"{twin.p50_gate_ms:.0f} ms), phase sum {phase_sum:.1f} ms vs tick span {span:.1f} ms "
        f"p50: drift {drift:.2f} % (gate ±{twin.phase_reconcile_pct} %); phase wall {wall_s:.1f} "
        f"s; device memory peak {device_peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated), "
        f"host peak RSS {host_peak / 2**20:.0f} MiB [{smi}]")
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    require(shard["shard_count"] >= 2, f"the plan has {shard['shard_count']} shard(s)")
    check_checkpoint("full_500kx100k_steady", run, SHARD_REFERENCE, "full_500kx100k")
    for key, want in SHARD_STEADY_REFERENCE.items():
        if not key.startswith("steady_"):
            got = shard[key] if key in shard else d[key]
            require(got == want, f"full_500kx100k_steady {key} {got} differs from the JAX "
                                 f"package's {want}")
    require(shard["reconcile_placed"] == SHARD_REFERENCE["reconcile_placed"],
            f"reconcile placed {shard['reconcile_placed']}, full_500kx100k's "
            f"{SHARD_REFERENCE['reconcile_placed']}")
    steady = check_steady("full_500kx100k_steady", run, sc, SHARD_STEADY_REFERENCE)
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
    if settle is not None:
        settle()
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
                kernel=kernel, held=held, launches=launches, sizes=sizes, steady=steady,
                device_peak=device_peak, host_peak=host_peak, drift=drift, p50_3_ms=p50_3,
                p50_gate_ms=twin.p50_gate_ms, drift_gate=twin.phase_reconcile_pct)


def storm_phase(kern, smi: str) -> dict:
    """Phase 14: the streaming-admission fast path at the headline's
    cluster width (module docstring). Returns what the kernels line and
    the summary print."""
    from slurm_bridge_tpu_torch.sim.cli import ADMISSION_GATES
    from slurm_bridge_tpu_torch.sim.scenarios import interactive_storm

    sc = pin_auction(interactive_storm(scale=STORM_SCALE))
    require((sc.cluster.num_nodes, sc.cluster.num_partitions, sc.workload.jobs, sc.ticks)
            == (9_600, 2, 44_000, 24), "interactive_storm is not at scale 40")
    require(sc.policy is not None and sc.admission is not None,
            "interactive_storm runs without its policy or admission config")
    run = run_sim(kern, smi, sc, "interactive_storm", keep=range(sc.ticks))
    result, ticks = run["result"], run["ticks"]
    d, q = result.determinism, result.quality
    adm = d.get("admission") or {}
    fast_ms = sorted(run["harness"].quality._fastpath_ms.values())
    fast_p50, fast_p99 = (float(np.percentile(fast_ms, x)) if fast_ms else float("nan")
                          for x in (50, 99))
    log(f"  digest {d['digest'][:16]}…, final state {d['final_state_digest'][:16]}…, "
        f"bound {d['bound_total']}, violations {len(d['invariant_violations'])}; admission "
        f"attempts {adm.get('attempts')}, fast binds {adm.get('binds')}, misses by reason "
        f"{adm.get('misses')}, window re-bases {adm.get('inventory_rebases')}; interactive "
        f"arrivals {q['interactive_arrivals']}, of them bound on the fast path "
        f"{q['fastpath_binds']}; arrival-to-bind p50 {q['interactive_latency_p50_ms']} / p99 "
        f"{q['interactive_latency_p99_ms']} ms (gate {ADMISSION_GATES['p99_ms']} ms); one fast "
        f"admission's wall p50 {fast_p50:.3f} / p99 {fast_p99:.3f} ms; tick p50 "
        f"{result.timing['tick_p50_ms']:.1f} ms, phase wall {run['wall_s']:.1f} s [{smi}]")
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    for key, want in STORM_REFERENCE.items():
        got = d.get(key, q.get(key))
        require(got == want, f"interactive_storm {key} {got} differs from the JAX package's {want}")
    require(q["fastpath_binds"] >= ADMISSION_GATES["min_fastpath_binds"],
            f"{q['fastpath_binds']} fast-path binds (floor {ADMISSION_GATES['min_fastpath_binds']})")
    require(adm.get("misses"), "FastPathAdmitter.misses is empty")
    require(q["interactive_latency_p99_ms"] <= ADMISSION_GATES["p99_ms"],
            f"interactive p99 {q['interactive_latency_p99_ms']} ms over the "
            f"{ADMISSION_GATES['p99_ms']} ms gate")
    for i, t in enumerate(ticks):
        require(t["launches"] == ROUNDS * t["solves"],
                f"tick {i}: {t['launches']} kernel launches for {t['solves']} solves")
    first = next((i for i, t in enumerate(ticks) if t["solves"]), None)
    require(first is not None, "interactive_storm never solved")
    calls = run["kept"][first]
    require(len(calls) == ROUNDS * ticks[first]["solves"],
            f"{len(calls)} kernel calls kept on tick {first}")
    errs = []
    for j, r in enumerate(calls):
        p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
        errs.append(compare_recorded(kern, r, f"storm tick {first} call {j} ({n},{p})"))

    # the admission-off twin: the same arrivals through the batch tick alone
    twin = storm_twin(kern, smi, sc, q)
    return dict(result=result, ticks=ticks, errs=errs, wall_s=run["wall_s"], first=first,
                admission=adm, fast_p50_ms=fast_p50, fast_p99_ms=fast_p99, twin=twin)


def storm_twin(kern, smi: str, sc, on_quality: dict) -> dict:
    """Phase 14's admission-off twin (``admission=None``), held to the JAX
    package's twin (:data:`STORM_OFF_REFERENCE`) and to ``sim/cli.py``'s
    ``_admission`` comparison with the on arm: batch utilization within
    ``util_margin`` (required where the JAX package's two arms hold it) and
    a half-tick floor over the latency gate."""
    from slurm_bridge_tpu_torch.policy.engine import PolicyConfig
    from slurm_bridge_tpu_torch.sim.cli import ADMISSION_GATES

    off_sc = arm_scenario(sc, "admission_off", PolicyConfig)
    run = run_sim(kern, smi, off_sc, "interactive_storm admission off")
    result, ticks = run["result"], run["ticks"]
    d, q = result.determinism, result.quality
    require(d["invariant_violations"] == [], d["invariant_violations"][:3])
    got = dict(arm_record(result), utilization_mean=q["utilization_mean"])
    for key, want in STORM_OFF_REFERENCE.items():
        require(got[key] == want,
                f"interactive_storm admission off: {key} {got[key]} differs from the JAX "
                f"package's {want}")
    for i, t in enumerate(ticks):
        require(t["launches"] == ROUNDS * t["solves"],
                f"admission-off tick {i}: {t['launches']} kernel launches for {t['solves']} solves")
    margin = ADMISSION_GATES["util_margin"]
    gap = abs(on_quality["utilization_mean"] - q["utilization_mean"])
    ref_gap = abs(STORM_REFERENCE["utilization_mean"] - STORM_OFF_REFERENCE["utilization_mean"])
    half_tick_ms = off_sc.tick_interval_s * 500.0
    log(f"  admission off: bound {d['bound_total']}, utilization {q['utilization_mean']} beside "
        f"the on arm's {on_quality['utilization_mean']} (gap {gap:.4f}, margin {margin}; the JAX "
        f"package's gap {ref_gap:.4f}) and the on arm's interactive p99 "
        f"{on_quality['interactive_latency_p99_ms']} ms; the off arm's p99 "
        f"{q['interactive_latency_p99_ms']} ms, half-tick floor {half_tick_ms:.0f} ms over the "
        f"{ADMISSION_GATES['p99_ms']} ms gate; tick p50 {result.timing['tick_p50_ms']:.1f} ms, "
        f"twin wall {run['wall_s']:.1f} s [{smi}]")
    require(gap <= margin or ref_gap > margin,
            f"utilization gap {gap} to the admission-off twin over the {margin} margin, which "
            f"the JAX package's arms hold ({ref_gap})")
    require(half_tick_ms > ADMISSION_GATES["p99_ms"],
            f"a half tick ({half_tick_ms} ms) is within the {ADMISSION_GATES['p99_ms']} ms gate: "
            "the comparison is vacuous")
    return dict(result=result, ticks=ticks, wall_s=run["wall_s"], gap=gap,
                launches=sum(t["launches"] for t in ticks))


def quality_gates(name: str, arms: dict, gates: dict, max_recovery_ticks) -> list:
    """``sim/cli.py``'s ``_quality`` gates on scenario ``name``, read from
    its arms' :func:`quality_summary` (``arms``: arm -> summary, ``gates``:
    ``QUALITY_GATES``). Returns (gate, holds, values) for each."""
    on, out = arms["on"], []
    if name == "multi_tenant_storm":
        off = arms["policy_off"]["jain_fairness"]
        out += [("Jain on >= floor", on["jain_fairness"] >= gates["jain_on_floor"],
                 f"{on['jain_fairness']} >= {gates['jain_on_floor']}"),
                ("Jain policy-off < ceiling", off < gates["jain_off_ceiling"],
                 f"{off} < {gates['jain_off_ceiling']}")]
    elif name == "priority_inversion":
        wait, off = on["production_wait_p95"], arms["policy_off"]["production_wait_p95"]
        out += [("production wait p95 <= bound",
                 wait is not None and wait <= gates["max_wait_ticks"],
                 f"{wait} <= {gates['max_wait_ticks']}"),
                ("at least one preemption", on["preempted_total"] >= 1,
                 f"{on['preempted_total']} >= 1"),
                ("policy-off wait worse", off is None or wait is None or off > wait,
                 f"{off} > {wait}")]
    elif name == "diurnal_load":
        off, nobf = arms["policy_off"], arms["backfill_off"]
        floor = off["utilization_mean"] + gates["util_margin"]
        out += [("utilization >= policy-off + margin", on["utilization_mean"] >= floor,
                 f"{on['utilization_mean']} >= {off['utilization_mean']} + "
                 f"{gates['util_margin']}"),
                ("backfill fired", bool(on["backfill_binds"]), f"{on['backfill_binds']} binds"),
                ("gang wait p95 < backfill-off's",
                 on["gang_wait_p95_ticks"] < nobf["gang_wait_p95_ticks"],
                 f"{on['gang_wait_p95_ticks']} < {nobf['gang_wait_p95_ticks']}")]
    elif name == "elastic_resize":
        rec = on["recovery_ticks"]
        out += [("resizes applied", bool(on["resizes"]), f"{on['resizes']} resizes"),
                ("drained", on["drained_at_tick"] is not None,
                 f"drained at tick {on['drained_at_tick']}"),
                ("none left unbound", not on["unbound_final"], f"{on['unbound_final']} unbound"),
                ("recovery within bound",
                 rec is not None and (max_recovery_ticks is None or rec <= max_recovery_ticks),
                 f"{rec} <= {max_recovery_ticks}")]
    return out


def quality_phase(kern, smi: str) -> dict:
    """Phase 15: the policy tick with preemption at the headline's cluster
    width (module docstring). Returns what the kernels line and the
    summary print."""
    from slurm_bridge_tpu_torch.policy.engine import PolicyConfig
    from slurm_bridge_tpu_torch.sim.cli import QUALITY_GATES
    from slurm_bridge_tpu_torch.sim.scenarios import SCENARIOS

    out, errs, t_phase = {}, [], time.perf_counter()
    for name, cell in QUALITY_CELLS.items():
        summaries, ref_summaries = {}, {}
        for arm in cell["arms"]:
            label = f"{name}@{cell['scale']} {arm}"
            want = QUALITY_REFERENCE[f"{name}/{arm}"]
            sc = pin_auction(arm_scenario(SCENARIOS[name](scale=cell["scale"]), arm, PolicyConfig))
            rounds = sc.auction_config.rounds
            held_from = cell.get("hold_from")
            keep = range(held_from, sc.ticks) if held_from is not None and arm == "on" else ()
            run = run_sim(kern, smi, sc, label, keep=keep)
            result, ticks = run["result"], run["ticks"]
            d, q = result.determinism, result.quality
            got = dict(arm_record(result), solves=[t["solves"] for t in ticks])
            summaries[arm], ref_summaries[arm] = got["quality"], want["quality"]
            require(d["invariant_violations"] == [],
                    f"{label}: {d['invariant_violations'][:3]}")
            for key, value in want.items():
                require(got[key] == value,
                        f"{label}: {key} {got[key]} differs from the JAX package's {value}")
            for i, t in enumerate(ticks):
                require(t["launches"] == rounds * t["solves"],
                        f"{label} tick {i}: {t['launches']} kernel launches for {t['solves']} "
                        f"solves of {rounds} rounds")
            launches = sum(t["launches"] for t in ticks)
            compared = 0
            if keep:
                first = next((i for i in keep if ticks[i]["solves"]), None)
                require(first is not None, f"{label}: no solving tick from tick {held_from}")
                calls = run["kept"][first]
                require(len(calls) == rounds * ticks[first]["solves"],
                        f"{label}: {len(calls)} kernel calls kept on tick {first}")
                for j, r in enumerate(calls):
                    p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
                    errs.append(compare_recorded(kern, r, f"{label} tick {first} call {j} "
                                                 f"({n},{p})"))
                compared = len(calls)
            s = got["quality"]
            log(f"  {label}: {len(ticks)} ticks, tick p50 {result.timing['tick_p50_ms']:.1f} ms, "
                f"bound {d['bound_total']}, preempted {s['preempted_total']}, backfill binds "
                f"{s['backfill_binds']}, Jain {s['jain_fairness']}, utilization "
                f"{s['utilization_mean']}, class wait p95 {q['class_wait_p95_ticks']}, kernel "
                f"launches {launches}, calls held bit-exact {compared}; digests and scorecard "
                f"equal the JAX package's; arm wall {run['wall_s']:.1f} s [{smi}]")
            out[label] = dict(result=result, ticks=ticks, wall_s=run["wall_s"],
                              launches=launches, compared=compared, summary=s)
        if "full_tick" in cell["arms"]:
            a, b = out[f"{name}@{cell['scale']} on"], out[f"{name}@{cell['scale']} full_tick"]
            for key in ("digest", "final_state_digest"):
                require(a["result"].determinism[key] == b["result"].determinism[key],
                        f"{name}: the full tick's {key} differs from the incremental tick's")
            require(virtual_scorecard(a["result"].quality) == virtual_scorecard(b["result"].quality),
                    f"{name}: the full tick's scorecard differs from the incremental tick's")
        max_rec = SCENARIOS[name](scale=cell["scale"]).max_recovery_ticks
        ref_gates = quality_gates(name, ref_summaries, QUALITY_GATES, max_rec)
        for (gate, holds, values), (_, ref_holds, ref_values) in zip(
                quality_gates(name, summaries, QUALITY_GATES, max_rec), ref_gates):
            log(f"  {name}@{cell['scale']} gate {gate}: {'holds' if holds else 'MISSED'} "
                f"({values}); the JAX package's: {'holds' if ref_holds else 'missed'} "
                f"({ref_values})" + ("" if ref_holds else " - not required"))
            require(holds or not ref_holds,
                    f"{name}@{cell['scale']}: gate {gate} missed ({values}) where the JAX "
                    f"package's run holds it ({ref_values})")
    wall_s = time.perf_counter() - t_phase
    log(f"  placement quality: {len(out)} arms, phase wall {wall_s:.1f} s [{smi}]")
    return dict(runs=out, errs=errs, wall_s=wall_s,
                launches=sum(a["launches"] for a in out.values()),
                compared=sum(a["compared"] for a in out.values()))


def held_fault_ticks(sc, ticks: list, num_nodes: list) -> list:
    """The ticks of a group A run whose kernel calls phase [16] holds
    bit-exact: in each of the scenario's fault windows its first and last
    solving tick, the first solving tick at or after the last window's end
    (none where every job was bound before it: ``node_churn``), and after
    a vanished partition the first solving tick whose inventory is whole
    again (``num_nodes``: each tick's node count in its kernel calls,
    ``None`` where it made none)."""
    solving = [i for i, t in enumerate(ticks) if t["solves"]]
    held = set()
    for f in sc.faults.faults:
        inside = [i for i in solving if f.start_tick <= i < f.end_tick]
        require(inside, f"{sc.name}: no solving tick in its {f.kind} window "
                        f"[{f.start_tick}, {f.end_tick})")
        held.update((inside[0], inside[-1]))
    end = max(f.end_tick for f in sc.faults.faults)
    after = [i for i in solving if i >= end]
    if after:
        held.add(after[0])
    if any(f.kind == "partition_vanish" for f in sc.faults.faults):
        whole = [i for i in after if num_nodes[i] == sc.cluster.num_nodes]
        require(whole, f"{sc.name}: no solving tick with its partition back")
        held.add(whole[0])
    return sorted(held)


def fault_phase(kern, smi: str) -> dict:
    """Phase 16: the fault gates (module docstring). Returns what the
    kernels line and the summary print."""
    import slurm_bridge_tpu_torch.solver.session as session
    from slurm_bridge_tpu_torch.policy.engine import PolicyConfig
    from slurm_bridge_tpu_torch.sim.faults import AGENT_KINDS, BRIDGE_KINDS
    from slurm_bridge_tpu_torch.sim.scenarios import SCENARIOS

    solves = []
    real_solve = session.DeviceSolver.solve

    def counted_solve(self, batch, *a, **kw):
        before = kern.LAUNCHES
        out = real_solve(self, batch, *a, **kw)
        solves.append(kern.LAUNCHES - before)
        return out

    out, errs, t_phase = {}, [], time.perf_counter()
    session.DeviceSolver.solve = counted_solve
    try:
        for name, cell in FAULT_CELLS.items():
            base = SCENARIOS[name](scale=cell["scale"])
            records = {}
            for arm in ("on", "crash_free") if base.lossless_twin else ("on",):
                label = f"{name}@{cell['scale']} {arm}"
                want = FAULT_REFERENCE[f"{name}/{arm}"]
                sc = pin_auction(arm_scenario(base, arm, PolicyConfig,
                                              crash_kinds=BRIDGE_KINDS + AGENT_KINDS))
                rounds = sc.auction_config.rounds
                hold = cell.get("hold", False) and arm == "on"
                keep = range(min(f.start_tick for f in sc.faults.faults), sc.ticks) if hold else ()
                solves.clear()
                run = run_sim(kern, smi, sc, label, keep=keep)
                result, ticks = run["result"], run["ticks"]
                got = dict(fault_record(result), solves=[t["solves"] for t in ticks])
                records[arm] = got
                for key, value in want.items():
                    require(got[key] == value,
                            f"{label}: {key} {got[key]} differs from the JAX package's {value}")
                # each device solve (each shard's, on a sharded run) launches
                # the kernel once per round, and nothing else launches it
                launches = sum(t["launches"] for t in ticks)
                require(solves and all(s == rounds for s in solves),
                        f"{label}: device solves launched {sorted(set(solves))} kernels, not "
                        f"{rounds}")
                require(launches == rounds * len(solves),
                        f"{label}: {launches} launches for {len(solves)} device solves")
                for i, t in enumerate(ticks):
                    ok = (t["launches"] % rounds == 0 and bool(t["launches"]) == bool(t["solves"])
                          if sc.sharding is not None else t["launches"] == rounds * t["solves"])
                    require(ok, f"{label} tick {i}: {t['launches']} kernel launches for "
                                f"{t['solves']} solves of {rounds} rounds")
                compared, held = 0, []
                if hold:
                    kept = run["kept"]
                    num_nodes = [kept[i][0]["kw"]["num_nodes"] if kept.get(i) else None
                                 for i in range(len(ticks))]
                    held = held_fault_ticks(sc, ticks, num_nodes)
                    for i in held:
                        calls = kept[i]
                        require(len(calls) == rounds * ticks[i]["solves"],
                                f"{label}: {len(calls)} kernel calls kept on tick {i}")
                        for j, r in enumerate(calls):
                            p, n = r["args"][4].shape[0], r["kw"]["num_nodes"]
                            node_part, job_part, live = r["args"][1], r["args"][5], r["live"]
                            # the node order's partitions (ops/bid_argmax.py:node_order)
                            k = max(int(node_part.max()) + 1, 0) if node_part.numel() else 0
                            errs.append(compare_recorded(kern, r, f"{label} tick {i} call {j} "
                                                                  f"({n},{p})"))
                            log(f"    live rows {int(live.sum())} of {p}: wildcard (-1) "
                                f"{int((live & (job_part < 0)).sum())}, past the {k} node "
                                f"partitions {int((live & (job_part >= k)).sum())}")
                        compared += len(calls)
                tm = result.timing
                rec_ms = tm.get("recovery_ms") or []
                log(f"  {label}: {len(ticks)} ticks, tick p50 {tm['tick_p50_ms']:.1f} ms, bound "
                    f"{got['bound_total']}, recovery ticks {got['recovery_ticks']}, restarts "
                    f"{got['restarts']} (agent {got['agent_restarts']}), restart ms "
                    f"{[round(x, 1) for x in rec_ms]}, RPC retries {got['rpc_retries']}"
                    + (f", shards {got['shard_count']}, reconcile placed {got['reconcile_placed']}"
                       if "shard_count" in got else "")
                    + f"; kernel launches {launches} over {len(solves)} device solves, calls held "
                    f"bit-exact {compared} (ticks {held}); equal to the JAX package's; run wall "
                    f"{run['wall_s']:.1f} s [{smi}]")
                out[label] = dict(result=result, ticks=ticks, wall_s=run["wall_s"],
                                  launches=launches, compared=compared, record=got,
                                  recovery_ms=rec_ms)
            for gate, holds, values in fault_gates(name, base, records["on"],
                                                   records.get("crash_free"), BRIDGE_KINDS,
                                                   AGENT_KINDS):
                log(f"  {name}@{cell['scale']} gate {gate}: {'holds' if holds else 'MISSED'} "
                    f"({values})")
                require(holds, f"{name}@{cell['scale']}: gate {gate} missed ({values})")
    finally:
        session.DeviceSolver.solve = real_solve
    wall_s = time.perf_counter() - t_phase
    log(f"  fault gates: {len(out)} runs, phase wall {wall_s:.1f} s [{smi}]")
    return dict(runs=out, errs=errs, wall_s=wall_s,
                launches=sum(r["launches"] for r in out.values()),
                compared=sum(r["compared"] for r in out.values()))


#: Phases [15] and [16], which a second process of this script runs
#: (:func:`late_phases`): (key, the phase's first line, the phase).
LATE_PHASES = (
    ("quality", "[15] main path: the simulator's placement-quality scenarios (priority_inversion, "
     "multi_tenant_storm, diurnal_load, elastic_resize) and their policy-off, backfill-off and "
     "full-tick arms at the headline's cluster width through the port's full bridge loop",
     quality_phase),
    ("fault", "[16] main path: the simulator's fault scenarios (a vanished partition and drained "
     "nodes at half and a quarter of the headline's cluster width; RPC flaps, a preemption "
     "storm, bridge and agent crashes, a leader failover and the sharded fan-out at scale 1, with "
     "the crash-free twins) through the port's full bridge loop", fault_phase),
)
#: How long that process may take, from its start (beside phase [6]) to
#: its exit.
LATE_DEADLINE_S = 900


def late_phases(out_path: str) -> int:
    """``chip_smoke.py --late-phases OUT``: phases [15] and [16] in a
    second process, which the run starts beside phases [6]-[8] — host-bound
    simulator runs, which time no kernel while it runs — so the run's wall
    is the longer of the two and not their sum. Each phase is driven with
    this process's launch count set to 0 just before it and read just
    after. Prints the phases' lines and writes what the run's checks,
    kernels line and summary read of them to OUT as JSON."""
    import slurm_bridge_tpu_torch.ops.bid_argmax as kern
    from slurm_bridge_tpu_torch.parallel import colpool

    smi = smi_line()
    out = {}
    for key, header, phase in LATE_PHASES:
        log(header)
        kern.LAUNCHES = 0
        res = phase(kern, smi)
        launches = kern.LAUNCHES
        require(launches > 0 and launches == res["launches"],
                f"{launches} kernel launches in the {key} phase")
        out[key] = dict(launches=launches, compared=res["compared"], wall_s=res["wall_s"],
                        max_err=max(res["errs"], default=0.0), runs={
                            label: dict(ticks=[t["launches"] for t in r["ticks"]],
                                        tick_p50_ms=r["result"].timing["tick_p50_ms"],
                                        phases_p50_ms=r["result"].timing["phases_p50_ms"],
                                        launches=r["launches"], wall_s=r["wall_s"],
                                        summary=r.get("summary"), record=r.get("record"),
                                        recovery_ms=r.get("recovery_ms"))
                            for label, r in res["runs"].items()})
    colpool.reset()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class LatePhases:
    """The second process running :data:`LATE_PHASES`: started beside
    phase [6], waited for (:meth:`join`) before any later phase times a
    kernel, its output printed in its phases' place (:meth:`result`), and
    killed if the run ends first."""

    def __init__(self):
        import atexit
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip-smoke-late-")
        self.out = os.path.join(self.dir, "late.json")
        self._log = open(os.path.join(self.dir, "late.log"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--late-phases", self.out],
            stdout=self._log, stderr=subprocess.STDOUT)
        self.wall_s = None
        atexit.register(self.stop)

    def join(self) -> None:
        if self.wall_s is not None:
            return
        try:
            self.proc.wait(timeout=max(1.0, self.t0 + LATE_DEADLINE_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.wall_s = time.perf_counter() - self.t0

    def result(self) -> dict:
        """Print the process's lines; fail unless it exited 0. Returns
        what it wrote (:func:`late_phases`)."""
        self.join()
        self._log.seek(0)
        sys.stdout.write(self._log.read())
        log(f"  (phases [15]-[16] ran in a second process beside phases [6]-[8]: "
            f"{self.wall_s:.1f} s from its start to its exit)")
        require(self.proc.returncode == 0,
                f"the process of phases [15]-[16] exited {self.proc.returncode} (deadline "
                f"{LATE_DEADLINE_S} s)")
        with open(self.out) as f:
            return json.load(f)

    def stop(self) -> None:
        """Kill the process if it still runs, and remove its files."""
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


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


def native_p50(snap, batch, reps: int = 5) -> tuple[float, object]:
    """The host packer's wall p50 over ``reps`` runs, and its placement."""
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pl = indexed_place_native(snap, batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), pl


def baseline_phase(kern, smi: str, hsnap, hbatch, sm_hz: float) -> dict:
    """Phase [13]: BASELINE configs #4 and #2 on the device solve, and the
    sampled auction path on the headline (``hsnap``, ``hbatch``) and on
    config #4 (module docstring). Returns what the kernels line and the
    summary print."""
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver
    from slurm_bridge_tpu_torch.solver.routing import choose_path, gang_shard_fraction
    from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

    out = {}

    def held(name, snap, batch, cfg, ref, want_launches):
        """Solve ``snap``/``batch`` on a fresh session: 1 + 5 solves, each
        launching the kernel ``want_launches`` times, identical, feasible,
        equal to the JAX package's ``ref``; each kernel call of the first
        (its operands kept and timed) held bit-exact against the plain
        version on its own operands."""
        route = choose_path(batch.num_shards, snap.num_nodes, backend_name="cuda",
                            gang_fraction=gang_shard_fraction(batch.gang_id))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solver = DeviceSolver(snap, cfg)
        with kernel_events(keep_operands=True) as calls:
            before = kern.LAUNCHES
            pl = solver.solve(batch)
        launches, walls = [kern.LAUNCHES - before], []
        for _ in range(5):
            before = kern.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = solver.solve(batch)
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append(kern.LAUNCHES - before)
            np.testing.assert_array_equal(again.node_of, pl.node_of)
        peak = torch.cuda.max_memory_allocated()
        require(launches == [want_launches] * len(launches) and len(calls) == want_launches,
                f"{name}: {launches} kernel launches per solve, {len(calls)} calls kept "
                f"({want_launches} wanted)")
        check_feasible(snap, batch, pl)
        got = dict(node_of_sha256=digest(pl.node_of), placed_jobs=len(pl.by_job(batch)),
                   placed_shards=int(pl.placed.sum()))
        require(got == ref, f"{name}: {got} differs from the JAX package's {ref}")
        errs, cells = [], []
        node_part = snap.partition_of
        for j, r in enumerate(calls):
            live = r["live"].cpu().numpy()
            cells.append(needed_cells(node_part, batch.partition_of, live))
            errs.append(compare_recorded(kern, r, f"{name} round {j}"))
            log(f"    {name} round {j}: live rows {int(live.sum())}, needed cells {cells[-1]}, "
                f"kernel {r['ms']:.4f} ms in the solve [{smi}]")
        p50 = statistics.median(walls)
        log(f"  {name}: {batch.num_shards} shards x {snap.num_nodes} nodes, auto route {route}; "
            f"{1 + len(walls)} solves identical and feasible, {len(calls)} launches each; placed "
            f"jobs {got['placed_jobs']} ({got['placed_shards']} shards); node_of digest equals "
            f"the JAX package's ({got['node_of_sha256'][:16]}…); solve p50 {p50:.1f} ms "
            f"(min {min(walls):.1f}, max {max(walls):.1f}); device memory peak "
            f"{peak / 2**20:.1f} MiB [{smi}]")
        return dict(route=route, walls=walls, p50_ms=p50, calls=calls, errs=errs, cells=cells,
                    peak=peak, launches_per_solve=want_launches, launches=sum(launches), **got)

    # (a) config #4: gang MPI jobsets, 16 rounds, affinity 0.05
    snap4, batch4 = random_scenario(**BASELINE4)
    require(batch4.num_shards == BASELINE4_REFERENCE["shards"], batch4.num_shards)
    cfg4 = AuctionConfig(**BASELINE4_SOLVE, candidates=0)
    log(f"  (a) BASELINE config #4: {cfg4}")
    c4 = held("config #4", snap4, batch4, cfg4, BASELINE4_REFERENCE["dense"],
              BASELINE4_SOLVE["rounds"])
    ms_per_solve = sum(r["ms"] for r in c4["calls"])
    r0 = c4["calls"][0]
    kw0 = dict(r0["kw"], live=None)
    launch_ms = cuda_ms(lambda: kern.bid_argmax(*r0["args"], r0["salt"], **kw0), 20)
    pk = {k: r0["kw"][k] for k in ("jitter", "affinity_weight", "num_nodes")}
    pk.update(bp=4096, bn=2048)
    kern.bid_argmax_plain(*r0["args"], r0["salt"], **pk)
    plain_ms = cuda_ms(lambda: kern.bid_argmax_plain(*r0["args"], r0["salt"], **pk), 1,
                       gate=False)
    p4, n4 = batch4.num_shards, snap4.num_nodes
    nbytes = sum(a.numel() * a.element_size() for a in r0["args"]) + 9 * p4
    launch_cells = needed_cells(snap4.partition_of, batch4.partition_of, np.ones(p4, bool))
    launch_bound, launch_bound_by, launch_ceiling = bounds(kern, launch_cells, nbytes, sm_hz,
                                                           affinity=True)
    solve_bound, _, solve_ceiling = bounds(kern, sum(c4["cells"]), len(c4["calls"]) * nbytes,
                                           sm_hz, affinity=True)
    native_ms, native = native_p50(snap4, batch4)
    native_jobs = len(native.by_job(batch4))
    log(f"  (a) kernel with affinity: all {p4} rows live {launch_ms:.4f} ms/launch, plain "
        f"{plain_ms:.1f} ms; {launch_cells} needed cells, bound {launch_bound:.4f} ms "
        f"({launch_bound_by}), issue ceiling {launch_ceiling:.4f} ms; per solve {ms_per_solve:.4f} "
        f"ms over {len(c4['calls'])} launches, {sum(c4['cells'])} needed cells, bound "
        f"{solve_bound:.4f} ms, issue ceiling {solve_ceiling:.4f} ms; placed jobs "
        f"{c4['placed_jobs']} vs the native packer's {native_jobs} of {BASELINE4['num_jobs']} "
        f"(native p50 {native_ms:.1f} ms) [{smi}]")
    c4.update(ms_per_solve=ms_per_solve, launch_ms=launch_ms, plain_ms=plain_ms,
              launch_cells=launch_cells, launch_bound=launch_bound,
              launch_bound_by=launch_bound_by, launch_ceiling=launch_ceiling,
              solve_bound=solve_bound, solve_ceiling=solve_ceiling, native_ms=native_ms,
              native_jobs=native_jobs)
    out["config4"] = c4

    # (b) config #2: 5,000 pods on 512 nodes, 8 rounds
    snap2, batch2 = random_scenario(**BASELINE2)
    cfg2 = AuctionConfig(**BASELINE2_SOLVE, candidates=0)
    log(f"  (b) BASELINE config #2: {cfg2}")
    c2 = held("config #2", snap2, batch2, cfg2, BASELINE2_REFERENCE, BASELINE2_SOLVE["rounds"])
    c2["ms_per_solve"] = sum(r["ms"] for r in c2["calls"])
    c2["native_ms"], native2 = native_p50(snap2, batch2)
    log(f"  (b) solve p50 {c2['p50_ms']:.1f} ms beside the native packer's "
        f"{c2['native_ms']:.1f} ms ({len(native2.by_job(batch2))} jobs placed); kernel "
        f"{c2['ms_per_solve']:.4f} ms per solve [{smi}]")
    out["config2"] = c2

    # (c) the sampled path (K candidates per shard): no kernel launch
    for key, label, snap, batch, solve in (
        ("headline", "the headline", hsnap, hbatch, dict(rounds=ROUNDS)),
        ("config4", "config #4", snap4, batch4, BASELINE4_SOLVE),
    ):
        cfg = AuctionConfig(**solve, candidates=SAMPLED_K)
        before = kern.LAUNCHES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solver = DeviceSolver(snap, cfg)
        first = solver.solve(batch)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            pl = solver.solve(batch)
            walls.append((time.perf_counter() - t0) * 1e3)
            np.testing.assert_array_equal(pl.node_of, first.node_of)
        peak = torch.cuda.max_memory_allocated()
        launches = kern.LAUNCHES - before
        require(launches == 0, f"sampled {label}: {launches} kernel launches")
        check_feasible(snap, batch, first)
        got = dict(node_of_sha256=digest(first.node_of), placed_jobs=len(first.by_job(batch)),
                   placed_shards=int(first.placed.sum()))
        ref = SAMPLED_REFERENCE[key]
        require(got == ref, f"sampled {label}: {got} differs from the JAX package's {ref}")
        p50 = statistics.median(walls)
        log(f"  (c) sampled K={SAMPLED_K} on {label} ({batch.num_shards} x {snap.num_nodes}, "
            f"{cfg.rounds} rounds): 6 solves identical and feasible, 0 kernel launches; placed "
            f"jobs {got['placed_jobs']} ({got['placed_shards']} shards); node_of digest equals "
            f"the JAX package's ({got['node_of_sha256'][:16]}…); solve p50 {p50:.1f} ms (min "
            f"{min(walls):.1f}, max {max(walls):.1f}); device memory peak {peak / 2**20:.1f} "
            f"MiB [{smi}]")
        out[f"sampled_{key}"] = dict(walls=walls, p50_ms=p50, peak=peak, **got)
    out["errs"] = c4["errs"] + c2["errs"]
    # the path's own launches: the solves', not the timing's or the compares'
    out["launches"] = c4["launches"] + c2["launches"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sweep-rank"]:
        return sweep_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--late-phases"]:
        return late_phases(sys.argv[2])
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
        for aw, jitter in ((0.0, 1.0), (0.3, 1.0), (0.05, 0.7)):
            errs.append(compare(kern, args, 7, aw, n, f"({n},{p}) jitter={jitter}",
                                jitter=jitter))
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
    for aw, jitter in ((0.0, 1.0), (0.3, 1.0), (0.05, 0.7)):
        errs.append(compare(kern, hargs, 3, aw, n_h, f"headline ({n_h},{p_h}) jitter={jitter}",
                            jitter=jitter, bp=4096, bn=2048))

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

    # 15-16 in a second process beside 6-8, which time no kernel; it ends
    # before phase 8 times its shard solves
    late = LatePhases()

    # 6. the bridge's job lifecycle on the simulated cluster at full width
    log("[6] main path: the simulator's full_50kx10k_steady (full_50kx10k and three more ticks) "
        "through the port's full bridge loop")
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
    log("[8] main path: the simulator's full_500kx100k_steady uncut (100,000 nodes, 500,000 "
        "jobs, 6 ticks) with the shard executor's fan-out")
    kern.LAUNCHES = 0
    shard = shard_phase(kern, smi, sm_mhz * 1e6, settle=late.join)
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

    # 13. BASELINE configs #4 and #2, and the sampled path
    log(f"[13] main path: BASELINE config #4 (gang MPI jobsets, {BASELINE4_SOLVE['rounds']} "
        f"rounds, affinity {BASELINE4_SOLVE['affinity_weight']}) and #2 on DeviceSolver, and the "
        f"sampled auction path (K={SAMPLED_K}) on the headline and on config #4")
    kern.LAUNCHES = 0
    base = baseline_phase(kern, smi, snap, batch, sm_mhz * 1e6)
    baseline_launches = base["launches"]
    require(baseline_launches == 6 * (BASELINE4_SOLVE["rounds"] + BASELINE2_SOLVE["rounds"]),
            f"{baseline_launches} kernel launches in the BASELINE phase's solves")
    errs += base["errs"]

    # 14. the streaming-admission fast path beside the batch auction
    log(f"[14] main path: the simulator's interactive_storm at scale {STORM_SCALE} (policy and "
        "streaming admission on) through the port's full bridge loop")
    kern.LAUNCHES = 0
    storm = storm_phase(kern, smi)
    storm_launches = kern.LAUNCHES
    require(storm_launches > 0, "no kernel launch in the admission phase")
    errs += storm["errs"]

    # 15. the policy tick with preemption: the placement-quality arms, and
    # 16. the fault gates: the JAX package's chaos, fault and shard
    # scenarios — from the second process
    late_out = late.result()
    quality, fault = late_out["quality"], late_out["fault"]
    quality_launches, fault_launches = quality["launches"], fault["launches"]
    require(quality_launches > 0 and fault_launches > 0,
            f"{quality_launches} and {fault_launches} kernel launches in phases [15] and [16]")
    errs += [quality["max_err"], fault["max_err"]]

    # 17. the JAX package's result on the reduced scenario
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
    log(f"[17] reduced scenario {REFERENCE['nodes']}x{REFERENCE['jobs']}: placed jobs {ref_jobs} "
        f"vs JAX {REFERENCE['placed_jobs']} (rel {rel:.5f}); node_of digest matches JAX: {match}")
    require(rel <= 0.005, rel)

    # 18. times
    p50 = statistics.median(wall_ms)
    log(f"[18] [{smi}] headline solve p50 {p50:.1f} ms over {len(wall_ms)} "
        f"(min {min(wall_ms):.1f}, max {max(wall_ms):.1f}); kernel {kernel_ms:.4f} ms/launch "
        f"(bound {bound_ms:.4f}, ceiling {ceiling_ms:.4f}), {ms_per_solve:.4f} ms per solve; "
        f"total run {time.perf_counter() - t_start:.0f} s")
    for i, t in enumerate(tick["ticks"]):
        log(f"[18] [{smi}] headline tick {i + 1}: wall {t['wall_ms']:.1f} ms, "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in t["phase_ms"].items())
            + f"; {t['launches']} kernel launches")
    for label, run, launches in (("full_50kx10k_steady", sim, sim_launches),
                                 ("full_50kx10k_crash", crash, crash_launches),
                                 ("full_500kx100k_steady", shard, shard_launches),
                                 ("interactive_storm", storm, storm_launches)):
        tm = run["result"].timing
        log(f"[18] [{smi}] {label}: tick p50 {tm['tick_p50_ms']:.1f} ms, "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in tm["phases_p50_ms"].items())
            + f" (p50 over {len(run['ticks'])} ticks); {launches} kernel launches; "
            f"phase wall {run['wall_s']:.1f} s")
    for label, run in (("full_50kx10k_steady", sim), ("full_500kx100k_steady", shard)):
        st = run["steady"]
        log(f"[18] [{smi}] {label}: steady ticks {st['ticks']}, steady tick p50 {st['p50_ms']:.3f} "
            f"ms (gate {st['gate_ms']:.0f} ms), each: "
            + "; ".join(f"tick {i} " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                run["ticks"][i]["phases"].items()) + " ms"
                        for i in st["ticks"]))
    log(f"[18] [{smi}] interactive_storm: fast binds {storm['admission']['binds']}, misses "
        f"{storm['admission']['misses']}, interactive arrival-to-bind p50 "
        f"{storm['result'].quality['interactive_latency_p50_ms']} / p99 "
        f"{storm['result'].quality['interactive_latency_p99_ms']} ms, one fast admission's wall "
        f"p50 {storm['fast_p50_ms']:.3f} / p99 {storm['fast_p99_ms']:.3f} ms; admission-off "
        f"twin: utilization {storm['twin']['result'].quality['utilization_mean']} (on "
        f"{storm['result'].quality['utilization_mean']}), tick p50 "
        f"{storm['twin']['result'].timing['tick_p50_ms']:.1f} ms, wall {storm['twin']['wall_s']:.1f} s")
    for label, arm in quality["runs"].items():
        sm = arm["summary"]
        log(f"[18] [{smi}] {label}: tick p50 {arm['tick_p50_ms']:.1f} ms, "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in arm["phases_p50_ms"].items())
            + f" (p50 over {len(arm['ticks'])} ticks); preempted {sm['preempted_total']}, "
            f"backfill binds {sm['backfill_binds']}, Jain {sm['jain_fairness']}, utilization "
            f"{sm['utilization_mean']}, production wait p95 {sm['production_wait_p95']}; "
            f"{arm['launches']} kernel launches; arm wall {arm['wall_s']:.1f} s")
    for label, run in fault["runs"].items():
        rec = run["record"]
        log(f"[18] [{smi}] {label}: tick p50 {run['tick_p50_ms']:.1f} ms, "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in run["phases_p50_ms"].items())
            + f" (p50 over {len(run['ticks'])} ticks); recovery ticks {rec['recovery_ticks']}, "
            f"restarts {rec['restarts']} (agent {rec['agent_restarts']}), restart ms "
            f"{[round(x, 1) for x in run['recovery_ms']]}; {run['launches']} kernel launches; "
            f"run wall {run['wall_s']:.1f} s")
    log(f"[18] [{smi}] fault gates: phase wall {fault['wall_s']:.1f} s, {fault_launches} kernel "
        f"launches, {fault['compared']} calls held bit-exact; phases [15]-[16] in their own "
        f"process beside phases [6]-[8], {late.wall_s:.1f} s from its start to its exit")
    log(f"[18] [{smi}] recovery_ms {crash['result'].timing['recovery_ms']}; full_500kx100k: "
        f"{len(shard['sizes'])} shards of {shard['sizes']} nodes, shard solves "
        f"{[round(sv['ms'], 1) for sv in shard['solves']]} ms, kernel per solve of tick 0's shard "
        f"solves {shard['held']}: {[round(k['ms_per_solve'], 4) for k in shard['kernel']]} ms; "
        f"tick p50 over ticks 0-2 {shard['p50_3_ms']:.1f} ms (gate {shard['p50_gate_ms']:.0f}), "
        f"phase-sum drift {shard['drift']:.2f} % (gate ±{shard['drift_gate']} %); device memory "
        f"peak {shard['device_peak'] / 2**20:.1f} MiB, host peak RSS "
        f"{shard['host_peak'] / 2**20:.0f} MiB")
    log(f"[18] [{smi}] streaming reschedule: churn tick p50 {churn['p50_ms']:.1f} ms, "
        f"re-solve ms {[round(t['solve_ms'], 1) for t in churn['ticks']]}, "
        f"{churn_launches} kernel launches, kernel {churn['kernel']['ms_per_solve']:.4f} ms per "
        f"solve on churn tick 1; auto route {churn['auto_route']}")
    log(f"[18] [{smi}] sidecar Place ms {[round(t['wall_ms'], 1) for t in sidecar['places']]} "
        f"(solve {[round(t['solve_ms'], 1) for t in sidecar['places']]}), "
        f"{sidecar_launches} kernel launches, kernel {sidecar['kernel']['ms_per_solve']:.4f} ms "
        f"per solve on Place 0")
    tk = daemons["tick"]
    log(f"[18] [{smi}] bridge daemons: placing tick {tk['wall_ms']:.1f} ms ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in tk["phase_ms"].items())
        + f"), kernel {daemons['kernel']['ms_per_solve']:.4f} ms over {ROUNDS} launches; "
        f"{BRIDGE['num_jobs']} jobs submit to last Succeeded {daemons['wall_s']:.1f} s; "
        f"{daemons_launches} kernel launches")
    log(f"[18] [{smi}] multi-device sweep ({SWEEP['dp']}x{SWEEP['mp']} cuda:0 blocks): solve "
        f"wall {[round(w, 1) for w in sweep['walls']]} ms, kernel {sweep['ms_per_solve']:.4f} ms "
        f"per solve over {sweep['solve_launches'][0]} block launches, combine and gathers "
        f"{sum(sweep['combine_ms']):.4f} ms per solve; forced-sharded tick "
        f"{sweep['tick']['wall_ms']:.1f} ms; gloo ranks' solve wall "
        f"{[[round(sv['wall_ms'], 1) for sv in rk['solves']] for rk in sweep['ranks']]} ms; "
        f"{sweep_launches} kernel launches")
    c4, c2 = base["config4"], base["config2"]
    log(f"[18] [{smi}] BASELINE config #4: solve p50 {c4['p50_ms']:.1f} ms, kernel "
        f"{c4['ms_per_solve']:.4f} ms per solve over {c4['launches_per_solve']} launches "
        f"(bound {c4['solve_bound']:.4f}, ceiling {c4['solve_ceiling']:.4f}), "
        f"{c4['launch_ms']:.4f} ms all-live launch, device memory peak {c4['peak'] / 2**20:.1f} "
        f"MiB; config #2: solve p50 {c2['p50_ms']:.1f} ms (native {c2['native_ms']:.1f} ms); "
        f"sampled K={SAMPLED_K}: headline p50 {base['sampled_headline']['p50_ms']:.1f} ms, "
        f"config #4 p50 {base['sampled_config4']['p50_ms']:.1f} ms; {baseline_launches} kernel "
        f"launches; total run {time.perf_counter() - t_start:.1f} s")

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
        + [t["launches"] for t in shard["ticks"]] + [t["launches"] for t in storm["ticks"]]
        + [t["launches"] for t in storm["twin"]["ticks"]]
        + [n for arm in quality["runs"].values() for n in arm["ticks"]]
        + [n for run in fault["runs"].values() for n in run["ticks"]],
        "launches_per_steady_tick": [sim["ticks"][i]["launches"] for i in sim["steady"]["ticks"]]
        + [shard["ticks"][i]["launches"] for i in shard["steady"]["ticks"]],
        "launches_storm_phase": storm_launches,
        "launches_quality_phase": quality_launches,
        "quality_calls_compared": quality["compared"],
        "launches_fault_phase": fault_launches,
        "fault_calls_compared": fault["compared"],
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
        "launches_baseline_phase": baseline_launches,
        "launches_per_baseline4_solve": c4["launches_per_solve"],
        "launches_per_baseline2_solve": c2["launches_per_solve"],
        "launches_per_sampled_solve": 0,
        "baseline4_ms": c4["launch_ms"],
        "baseline4_plain_ms": c4["plain_ms"],
        "baseline4_bound_ms": c4["launch_bound"],
        "baseline4_ms_per_solve": c4["ms_per_solve"],
        "baseline4_bound_ms_per_solve": c4["solve_bound"],
        "baseline2_ms_per_solve": c2["ms_per_solve"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
