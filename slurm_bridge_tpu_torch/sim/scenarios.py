"""Named simulation scenarios — the catalog the CLI and smoke gate run.

Each factory takes a ``scale`` knob (default 1.0) that multiplies pod and
node counts, so ``make sim-smoke`` runs the same scenarios at toy shapes
and the CLI can run them full-size. The runnable per-scenario entry
points live in ``benchmarks/scenarios/sim_*.py`` (one file per scenario,
ISSUE 2); this module is the single source of truth they import.

``full_50kx10k`` is the slow headline: the previously-unmeasured full
bridge reconcile tick (store → encode → solve → bind → mirror) at 50k
pods × 10k nodes, reported as ``full_tick_p50_ms_50kx10k``.
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.admission import AdmissionConfig
from slurm_bridge_tpu_torch.policy.engine import PolicyConfig
from slurm_bridge_tpu_torch.shard.planner import ShardConfig
from slurm_bridge_tpu_torch.sim.faults import Fault, FaultPlan
from slurm_bridge_tpu_torch.sim.harness import Scenario
from slurm_bridge_tpu_torch.sim.trace import ClusterSpec, WorkloadSpec
from slurm_bridge_tpu_torch.solver.auction import AuctionConfig


def _n(base: int, scale: float, floor: int = 8) -> int:
    return max(floor, int(round(base * scale)))


def steady_poisson(scale: float = 1.0, seed: int = 42) -> Scenario:
    """Steady Poisson arrivals against a heterogeneous 4-partition
    cluster; no faults — the determinism/queue-drain baseline."""
    return Scenario(
        name="steady_poisson",
        description="Poisson arrivals, mixed cpu/mem/gpu demand, no faults",
        cluster=ClusterSpec(
            num_nodes=_n(400, scale), partition_features=("tier0", "tier1")
        ),
        workload=WorkloadSpec(
            jobs=_n(1500, scale, floor=20), arrival="poisson", spread_ticks=10
        ),
        ticks=20,
        seed=seed,
    )


def burst_backlog(scale: float = 1.0, seed: int = 43) -> Scenario:
    """Cold-start: the whole queue arrives at tick 0 (the headline
    shape's arrival pattern, scaled down)."""
    return Scenario(
        name="burst_backlog",
        description="front-loaded backlog, gang-heavy, drains from cold start",
        cluster=ClusterSpec(num_nodes=_n(600, scale)),
        workload=WorkloadSpec(
            jobs=_n(3000, scale, floor=30),
            arrival="front",
            gang_fraction=0.15,
        ),
        ticks=8,
        seed=seed,
    )


def agent_flaky_rpc(scale: float = 1.0, seed: int = 44) -> Scenario:
    """Agent RPC flaps: submissions and status queries fail 30% of the
    time (plus recorded latency) for a window; everything must converge
    after the flap clears — the retry/idempotency story end to end."""
    return Scenario(
        name="agent_flaky_rpc",
        description="30% UNAVAILABLE on SubmitJob/JobInfo/JobsInfo for ticks 4-12",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(1000, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="rpc_error",
                    start_tick=4,
                    end_tick=12,
                    # JobsInfo is the bulk form the mirror dials since PR-3;
                    # keep the single-job form faulted too for the fallback
                    methods=("SubmitJob", "JobInfo", "JobsInfo"),
                    rate=0.3,
                ),
                Fault(
                    kind="rpc_latency",
                    start_tick=4,
                    end_tick=12,
                    methods=("SubmitJob",),
                    latency_ms=50.0,
                ),
            )
        ),
        ticks=18,
        seed=seed,
        max_recovery_ticks=24,
    )


def preemption_storm(scale: float = 1.0, seed: int = 45) -> Scenario:
    """A high-priority burst lands on a loaded cluster with preemption
    enabled: incumbents must be displaced (cancel + requeue + dedupe-safe
    resubmit) without ever double-binding or breaking gang atomicity."""
    return Scenario(
        name="preemption_storm",
        description="priority-1000 burst at tick 6 displaces incumbents",
        # deliberately oversubscribed (~1.4x free capacity in flight with
        # long runtimes): the storm cannot fit without displacing, so the
        # preemption path — cancel, requeue, dedupe-safe resubmit — runs
        # for real; the long grace + tick interval cover the worked-off
        # backlog so the drain invariant still closes the scenario
        cluster=ClusterSpec(num_nodes=_n(150, scale), gpu_fraction=0.0),
        workload=WorkloadSpec(
            jobs=_n(700, scale, floor=30),
            arrival="poisson",
            spread_ticks=4,
            gpu_fraction=0.0,
            cpu_choices=(8, 16, 32),
            duration_range=(60.0, 120.0),
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="preemption_storm",
                    start_tick=6,
                    end_tick=7,
                    jobs=_n(120, scale, floor=10),
                    priority=1000,
                ),
            )
        ),
        ticks=16,
        tick_interval_s=10.0,
        drain_grace_ticks=100,
        preemption=True,
        seed=seed,
        max_recovery_ticks=90,
    )


def node_churn(scale: float = 1.0, seed: int = 46) -> Scenario:
    """Drain/resume churn plus stale inventory snapshots and lost status
    updates — the scheduler must ride out a shrinking, lying inventory
    and drain once nodes return."""
    return Scenario(
        name="node_churn",
        description="20% of nodes drain ticks 4-12; stale snapshots + lost "
        "status ticks 5-10",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(900, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="drain_nodes",
                    start_tick=4,
                    end_tick=12,
                    node_fraction=0.2,
                ),
                Fault(kind="stale_snapshot", start_tick=5, end_tick=10),
                Fault(kind="lost_status", start_tick=5, end_tick=10),
            )
        ),
        ticks=18,
        seed=seed,
        max_recovery_ticks=36,
    )


def partition_vanish(scale: float = 1.0, seed: int = 47) -> Scenario:
    """A whole partition disappears mid-run (agent stops listing it): its
    virtual node is torn down, its pending pods wait, and everything
    converges once the partition returns."""
    return Scenario(
        name="partition_vanish",
        description="partition part1 vanishes for ticks 3-10, then returns",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(800, scale, floor=20), arrival="poisson", spread_ticks=6
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="partition_vanish",
                    start_tick=3,
                    end_tick=10,
                    partition="part1",
                ),
            )
        ),
        ticks=16,
        seed=seed,
        max_recovery_ticks=12,
    )


def crash_restart(scale: float = 1.0, seed: int = 48) -> Scenario:
    """The bridge process dies mid-run — no graceful flush — and a fresh
    stack reloads from snapshot+WAL, re-converging against the sim
    agent's live ground truth. The smoke gate additionally proves the
    final state digest byte-identical to this scenario with the crash
    stripped (lossless recovery at the tick boundary)."""
    return Scenario(
        name="crash_restart",
        description="bridge crashes at tick 6; reloads snapshot+WAL and "
        "re-converges with zero node flap",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(900, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (Fault(kind="crash_restart", start_tick=6, end_tick=7),)
        ),
        ticks=16,
        seed=seed,
        persistence=True,
        max_recovery_ticks=8,
        lossless_twin="state",
    )


def leader_failover(scale: float = 1.0, seed: int = 49) -> Scenario:
    """Two leadership handoffs over one run: a graceful step-down
    (lease released, standby takes over the same tick) and a leader
    crash (standby must wait out lease expiry — a real leaderless
    window, arrivals queue and replay). Both takeovers rebuild the
    stack from snapshot+WAL with ZERO VirtualNode deletions."""
    return Scenario(
        name="leader_failover",
        description="graceful step-down at tick 4, crash + lease-expiry "
        "takeover at tick 10; zero node flap across both",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(800, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="leader_failover",
                    start_tick=4,
                    end_tick=5,
                    graceful=True,
                ),
                Fault(
                    kind="leader_failover",
                    start_tick=10,
                    end_tick=11,
                    graceful=False,
                ),
            )
        ),
        ticks=18,
        seed=seed,
        persistence=True,
        max_recovery_ticks=28,
    )


def agent_crash(scale: float = 1.0, seed: int = 50) -> Scenario:
    """The AGENT process dies mid-run: jobs, submit ledger, queue and
    per-node allocation all drop and rebuild from the job-state journal
    (``agent/journal.py``). The smoke gate proves the reload lossless —
    final state byte-identical to the crash-free run — which is exactly
    the dedupe + in-flight-state durability a real login-node daemon
    restart needs (JIRIAF's operating model)."""
    return Scenario(
        name="agent_crash",
        description="agent process state dies at tick 5; journal replay "
        "rebuilds ledger + in-flight jobs losslessly",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(800, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (Fault(kind="agent_crash", start_tick=5, end_tick=6),)
        ),
        ticks=16,
        seed=seed,
        # the window closes at tick 6 but arrivals keep coming to tick 8
        # and jobs run tens of virtual seconds — the bound covers natural
        # workload drain, not journal replay (which is same-tick)
        max_recovery_ticks=24,
        lossless_twin="state",
    )


def chaos_dual_crash(scale: float = 1.0, seed: int = 51) -> Scenario:
    """The composed-durability headline: bridge AND agent crash at the
    SAME tick. The bridge reloads snapshot+WAL, the agent reloads its
    journal, and the reloaded bridge's resync runs against the reloaded
    agent — in-flight submits dedupe through the journaled ledger, so
    nothing double-submits and nothing is lost. Gated byte-identical to
    the crash-free twin."""
    return Scenario(
        name="chaos_dual_crash",
        description="simultaneous bridge+agent crash at tick 6; both "
        "reload (snapshot+WAL / journal) losslessly",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(900, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (
                Fault(kind="crash_restart", start_tick=6, end_tick=7),
                Fault(kind="agent_crash", start_tick=6, end_tick=7),
            )
        ),
        ticks=16,
        seed=seed,
        persistence=True,
        max_recovery_ticks=8,
        lossless_twin="state",
    )


def chaos_crash_rpc_flap(scale: float = 1.0, seed: int = 52) -> Scenario:
    """Crash DURING a degraded-RPC window: 25% UNAVAILABLE on the
    mirror/submit/inventory RPCs for ticks 4-10 with injected latency,
    and the bridge crashes at tick 6 — recovery has to re-converge
    THROUGH the still-flapping RPC plane. Bounded retries
    (``rpc_retries``) absorb the transient errors, so no control-loop
    round fails outright; the crash-free twin (same flap, no crash) must
    end with identical lifecycle outcomes."""
    return Scenario(
        name="chaos_crash_rpc_flap",
        description="25% UNAVAILABLE + latency on ticks 4-10; bridge "
        "crashes at tick 6 and recovers through the flap (retries on)",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(900, scale, floor=20), arrival="poisson", spread_ticks=8
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="rpc_error",
                    start_tick=4,
                    end_tick=10,
                    # whole-RPC faults on the batched forms + inventory:
                    # every one is retry-healable (per-item "SubmitJob"
                    # faults would surface as ok=false entries instead,
                    # which retries cannot and should not mask)
                    methods=("SubmitJobs", "JobsInfo", "Partitions", "Nodes"),
                    rate=0.25,
                ),
                Fault(
                    kind="rpc_latency",
                    start_tick=4,
                    end_tick=10,
                    methods=("SubmitJobs", "JobsInfo"),
                    latency_ms=25.0,
                ),
                Fault(kind="crash_restart", start_tick=6, end_tick=7),
            )
        ),
        ticks=18,
        seed=seed,
        persistence=True,
        rpc_retries=True,
        max_recovery_ticks=10,
        lossless_twin="outcome",
    )


def chaos_crash_into_vanished_partition(
    scale: float = 1.0, seed: int = 53
) -> Scenario:
    """Crash recovering INTO a shrunken inventory: partition part1
    vanishes at tick 5 and the bridge crashes the same tick. The
    reloaded configurator never knew the partition, so the restored
    VirtualNode stays in the store unmanaged (ZERO deletions — the gate)
    until part1 returns at tick 12 and the fresh provider adopts it
    uid-stably. Everything converges after the window; final state
    byte-identical to the crash-free twin."""
    return Scenario(
        name="chaos_crash_into_vanished_partition",
        description="partition part1 vanishes ticks 5-12 and the bridge "
        "crashes at tick 5: recovery into the vanished partition, zero "
        "node flap, adoption on return",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(800, scale, floor=20), arrival="poisson", spread_ticks=6
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="partition_vanish",
                    start_tick=5,
                    end_tick=12,
                    partition="part1",
                ),
                Fault(kind="crash_restart", start_tick=5, end_tick=6),
            )
        ),
        ticks=18,
        seed=seed,
        persistence=True,
        max_recovery_ticks=14,
        # "outcome", not "state": the CRASH-FREE twin observes the vanish
        # live, deletes the partition's VirtualNode and re-binds its
        # not-yet-submitted pods on return — the crashed arm preserves
        # the original bindings (strictly less churn), so placements
        # legitimately permute among equivalent nodes while every
        # lifecycle outcome must still match byte-for-byte
        lossless_twin="outcome",
    )


def diurnal_load(scale: float = 1.0, seed: int = 54) -> Scenario:
    """Day/night sinusoidal arrivals, gang-heavy, on a deliberately
    APPROXIMATE auction (2 rounds, in-engine repair off): the main
    solve leaves genuine fragmentation holes and stranded gangs at
    every peak, and the policy's backfill pass fills them — the
    quality gate compares utilization + gang wait against this exact
    scenario with policy off (and with backfill alone off, isolating
    the backfill contribution)."""
    return Scenario(
        name="diurnal_load",
        description="sinusoidal load on an approximate auction; backfill "
        "fills the admission holes, gated vs policy-off",
        cluster=ClusterSpec(num_nodes=_n(120, scale), gpu_fraction=0.1),
        workload=WorkloadSpec(
            jobs=_n(1500, scale, floor=80),
            arrival="diurnal",
            spread_ticks=16,
            diurnal_cycles=2,
            gang_fraction=0.45,
            duration_range=(40.0, 80.0),
        ),
        ticks=24,
        expect_drain=False,
        drain_grace_ticks=0,
        backend="auction",
        auction_config=AuctionConfig(
            rounds=2, repair=False, gang_salvage_rounds=1
        ),
        policy=PolicyConfig(),
        seed=seed,
    )


def multi_tenant_storm(scale: float = 1.0, seed: int = 55) -> Scenario:
    """Four tenants with skewed priority ranges slam an oversubscribed
    cluster at tick 0; jobs outlive the window, so whoever admits first
    keeps the capacity. Policy-off priority-FIFO hands everything to
    the loud tenants (Jain ≈ 0.5); weighted dominant-resource fair
    share interleaves them (Jain ≥ 0.9) — the quality-smoke gate."""
    return Scenario(
        name="multi_tenant_storm",
        description="4 skewed tenants, front-loaded oversubscription; "
        "fair-share Jain gated vs priority-FIFO",
        cluster=ClusterSpec(
            num_nodes=_n(120, scale), gpu_fraction=0.0, base_load=0.0
        ),
        workload=WorkloadSpec(
            jobs=_n(1200, scale, floor=80),
            arrival="front",
            gpu_fraction=0.0,
            gang_fraction=0.0,
            cpu_choices=(16, 32, 64),
            duration_range=(500.0, 800.0),
            tenants=4,
            tenant_priorities=((80, 100), (55, 75), (30, 50), (0, 20)),
        ),
        ticks=10,
        expect_drain=False,
        drain_grace_ticks=0,
        policy=PolicyConfig(),
        seed=seed,
    )


def priority_inversion(scale: float = 1.0, seed: int = 56) -> Scenario:
    """The inversion shape: batch incumbents carrying HIGH numeric
    priorities fill the cluster, then node-sized production gangs with
    a LOW numeric priority arrive. Numeric-priority preemption (policy
    off) never displaces anyone — the gang starves behind lower-class
    work. With the class table on, class trumps numeric priority: the
    gang preempts preemptible batch incumbents and binds within its
    wait bound (gated in quality-smoke)."""
    return Scenario(
        name="priority_inversion",
        description="production gang at numeric priority 10 vs batch "
        "incumbents at 60-100; class preemption bounds its wait",
        cluster=ClusterSpec(
            num_nodes=_n(120, scale), gpu_fraction=0.0, base_load=0.0
        ),
        workload=WorkloadSpec(
            jobs=_n(500, scale, floor=40),
            arrival="front",
            gpu_fraction=0.0,
            gang_fraction=0.0,
            cpu_choices=(8, 16, 32),
            duration_range=(500.0, 800.0),
            priority_range=(60, 100),
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="preemption_storm",
                    start_tick=5,
                    end_tick=6,
                    jobs=_n(16, scale, floor=2),
                    priority=10,
                    gang_size=4,
                    storm_class="production",
                    storm_cpus=(96, 128),
                ),
            )
        ),
        ticks=14,
        expect_drain=False,
        drain_grace_ticks=0,
        preemption=True,
        policy=PolicyConfig(),
        seed=seed,
    )


def elastic_resize(scale: float = 1.0, seed: int = 57) -> Scenario:
    """Jobs change shard count mid-flight (VirtualFlow, arxiv
    2009.09523): two resize windows cancel running work, rewrite the
    demand's node count under a fresh submit generation, and the
    scheduler re-places every resized job at its new shape — gang
    atomicity, capacity, and eventual drain all still hold."""
    return Scenario(
        name="elastic_resize",
        description="mid-flight shard-count changes at ticks 6 and 10; "
        "everything re-places and drains",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(800, scale, floor=40),
            arrival="poisson",
            spread_ticks=8,
            gang_fraction=0.15,
            duration_range=(30.0, 80.0),
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="elastic_resize",
                    start_tick=6,
                    end_tick=7,
                    jobs=_n(60, scale, floor=8),
                ),
                Fault(
                    kind="elastic_resize",
                    start_tick=10,
                    end_tick=11,
                    jobs=_n(40, scale, floor=5),
                ),
            )
        ),
        ticks=18,
        policy=PolicyConfig(),
        seed=seed,
        max_recovery_ticks=30,
    )


def interactive_storm(scale: float = 1.0, seed: int = 61) -> Scenario:
    """The streaming-admission gate shape (ISSUE 12): the diurnal_load
    arrival pattern with a production-class interactive stream mixed
    into the batch background. Interactive-eligible arrivals
    (production singles and ≤4-node gangs, ~30% of the trace) must ride
    the fast path — ``make admission-smoke`` gates their arrival→bind
    p99 at ≤100 ms in virtual time (a batch-tick bind costs half a
    tick period minimum, 2.5 s at this interval, so the gate is only
    reachable through the fast path) — while batch utilization stays
    within 1% of the admission-off twin (the fast path must not wreck
    the packing it front-runs)."""
    return Scenario(
        name="interactive_storm",
        description="diurnal batch background + production-class "
        "interactive stream; fast-path p99 ≤ 100 ms, batch utilization "
        "within 1% of the admission-off twin",
        # roomy and CPU-only on purpose: the latency SLO is a
        # STEADY-STATE property — interactive arrivals must find tight
        # fits, not queue behind a saturated peak or a 3-node GPU island
        # (saturation shapes are diurnal_load's job). Two big partitions
        # so 4-node production gangs always have a feasible island even
        # at smoke scale.
        cluster=ClusterSpec(
            num_nodes=_n(240, scale), num_partitions=2, gpu_fraction=0.0
        ),
        workload=WorkloadSpec(
            jobs=_n(1100, scale, floor=110),
            arrival="diurnal",
            spread_ticks=16,
            diurnal_cycles=2,
            gang_fraction=0.15,
            gpu_fraction=0.0,
            duration_range=(30.0, 60.0),
            priority_classes=(("batch", 0.7), ("production", 0.3)),
        ),
        # the cold-start probe (ISSUE 15 satellite): two production
        # arrivals at tick 0, BEFORE any virtual node or admission
        # window exists — deterministic ``not_ready`` entries in
        # ``FastPathAdmitter.misses``, which admission-smoke asserts
        # non-empty (the by-reason ledger must be live in the scenario
        # JSON, not silently zeroed). They land inside the latency
        # warmup, so the p99 gate still measures steady state only.
        faults=FaultPlan(
            (
                Fault(
                    kind="preemption_storm",
                    start_tick=0,
                    end_tick=1,
                    jobs=2,
                    priority=10,
                    storm_class="production",
                    storm_cpus=(2, 4),
                ),
            )
        ),
        ticks=24,
        expect_drain=False,
        drain_grace_ticks=0,
        policy=PolicyConfig(),
        admission=AdmissionConfig(),
        seed=seed,
    )


def steady_state_soak(scale: float = 1.0, seed: int = 60) -> Scenario:
    """The O(changes) acceptance shape (PR-11): a front-loaded standing
    load whose jobs outlive the whole run, deliberately oversubscribed so
    an unschedulable backlog pends forever. Tick 0 is the cold bind,
    tick 1 mirrors the Pending→Running transitions, and every later tick
    is GENUINELY steady — nothing arrives, binds, completes or writes —
    which is what ``steady_tick_p50_ms`` medians over and what the
    bench-smoke zero-work gate (0 store commits, 0 solver invocations,
    ≤1 status RPC per shard) pins hard."""
    return Scenario(
        name="steady_state_soak",
        description="standing load + unschedulable backlog; ticks 2+ are "
        "zero-work steady state",
        cluster=ClusterSpec(num_nodes=_n(300, scale)),
        workload=WorkloadSpec(
            jobs=_n(1200, scale, floor=60),
            arrival="front",
            # far beyond the run horizon: the standing state never drains
            duration_range=(100_000.0, 200_000.0),
        ),
        ticks=10,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
    )


def sharded_smoke(scale: float = 1.0, seed: int = 58) -> Scenario:
    """The fast sharded-tick gate (ISSUE 10): a gang-heavy mixed
    workload on 3 partitions, each split across several shards
    (``max_nodes_per_shard`` ≈ nodes/9), with a 2-wide solve fan-out.
    Double-run determinism proves the fan-out merges id-keyed; the
    shard-smoke gate additionally requires the plan to actually shard
    (≥2 shards) — a silently-monolithic run is a failed gate, not a
    pass."""
    n_nodes = _n(900, scale)
    return Scenario(
        name="sharded_smoke",
        description="partition/island fan-out on split partitions; "
        "double-run deterministic, invariants hold",
        cluster=ClusterSpec(
            num_nodes=n_nodes,
            num_partitions=3,
            partition_features=("tier0", "tier1"),
        ),
        workload=WorkloadSpec(
            jobs=_n(2400, scale, floor=60),
            arrival="poisson",
            spread_ticks=8,
            gang_fraction=0.2,
        ),
        ticks=16,
        seed=seed,
        sharding=ShardConfig(
            max_nodes_per_shard=max(12, n_nodes // 9), workers=2
        ),
    )


def fleet_smoke(scale: float = 1.0, seed: int = 58) -> Scenario:
    """The fleet-of-1 twin gate (ISSUE 17): ``sharded_smoke``'s exact
    shape and seed with a 1-replica fleet attached — every greedy/native
    shard solve round-trips through a real solver sidecar process over
    gRPC, and the ``final_state_digest`` must be byte-identical to the
    single-process run (the fleet-smoke gate strips ``fleet`` for the
    twin arm). The gate also requires ``remote_solves > 0``: a fleet run
    that silently solved inline is a failed gate, not a pass."""
    from slurm_bridge_tpu_torch.fleet.runtime import FleetConfig

    base = sharded_smoke(scale=scale, seed=seed)
    import dataclasses

    return dataclasses.replace(
        base,
        name="fleet_smoke",
        description="1-replica fleet over real gRPC; digest byte-"
        "identical to the single-process twin",
        fleet=FleetConfig(replicas=1),
    )


def fleet_kill_owner(scale: float = 1.0, seed: int = 61) -> Scenario:
    """The fleet chaos gate (ISSUE 17): 3 replicas each owning a
    shard-set; a priority storm lands at tick 6 and the owner of shard 0
    is SIGKILLed at tick 7, mid-storm. Its shard-set must re-key to
    survivors on the same tick's membership heartbeat (remote solves are
    byte-parity with inline, so the re-key is invisible to digests — the
    gate compares ``final_state_digest`` against the kill-stripped twin),
    with zero lost binds, zero VirtualNode deletions, and recovery
    (restart-with-backoff re-adopting the sidecar) within
    ``max_recovery_ticks``."""
    from slurm_bridge_tpu_torch.fleet.runtime import FleetConfig

    n_nodes = _n(600, scale)
    return Scenario(
        name="fleet_kill_owner",
        description="kill the shard-0 owner mid-storm: re-key to "
        "survivors, zero lost binds, bounded recovery",
        cluster=ClusterSpec(
            num_nodes=n_nodes,
            num_partitions=3,
            partition_features=("tier0", "tier1"),
        ),
        workload=WorkloadSpec(
            jobs=_n(1600, scale, floor=60),
            arrival="poisson",
            spread_ticks=8,
            gang_fraction=0.2,
        ),
        faults=FaultPlan(
            (
                Fault(
                    kind="preemption_storm",
                    start_tick=6,
                    end_tick=7,
                    jobs=_n(120, scale, floor=10),
                    priority=1000,
                ),
                Fault(kind="kill_replica", start_tick=7, end_tick=8),
            )
        ),
        ticks=16,
        preemption=True,
        drain_grace_ticks=100,
        seed=seed,
        sharding=ShardConfig(
            max_nodes_per_shard=max(12, n_nodes // 9), workers=2
        ),
        fleet=FleetConfig(replicas=3, restart_backoff_ticks=2),
        max_recovery_ticks=6,
    )


def sharded_gang_split(scale: float = 1.0, seed: int = 59) -> Scenario:
    """The cross-shard reconciliation shape: gangs of 8 on partitions
    deliberately split into shards too small to host them
    (``max_nodes_per_shard`` < gang size at smoke scale) — every gang
    FAILS its home shard and must place through the merged-residual
    reconcile pass, all-or-nothing. The shard-smoke gate requires
    ``reconcile_placed ≥ 1`` so the pass can never silently stop
    running."""
    n_nodes = _n(240, scale)
    return Scenario(
        name="sharded_gang_split",
        description="8-node gangs vs sub-gang-size shards; gangs place "
        "only via cross-shard reconciliation",
        cluster=ClusterSpec(
            num_nodes=n_nodes, num_partitions=2, gpu_fraction=0.0
        ),
        workload=WorkloadSpec(
            jobs=_n(400, scale, floor=40),
            arrival="poisson",
            spread_ticks=6,
            gang_fraction=0.5,
            gang_size=8,
            gpu_fraction=0.0,
        ),
        ticks=14,
        seed=seed,
        sharding=ShardConfig(
            max_nodes_per_shard=max(6, n_nodes // 40), workers=2
        ),
    )


def full_500kx100k(scale: float = 1.0, seed: int = 42) -> Scenario:
    """The 10×-scale headline (ISSUE 10, slow — tens of minutes): 500k
    pods × 100k nodes through the FULL bridge pipeline with the
    partition/island shard fan-out on. 16 partitions of ~6.2k nodes
    each split across ~8k-node shards; gangs straddling split
    partitions place all-or-nothing (reconcile pass), with the
    rank-locality score on the quality scorecard. Records
    ``full_tick_p50_ms_500kx100k`` with the standard phase breakdown,
    gated by ``p50_gate_ms``."""
    return Scenario(
        name="full_500kx100k",
        description="full-bridge sharded reconcile tick at the "
        "500k x 100k product shape (slow)",
        cluster=ClusterSpec(num_nodes=_n(100_000, scale), num_partitions=16),
        workload=WorkloadSpec(
            jobs=_n(500_000, scale, floor=200),
            arrival="front",
            gang_fraction=0.05,
            gpu_fraction=0.15,
            duration_range=(30.0, 120.0),
        ),
        ticks=3,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
        slow=True,
        sharding=ShardConfig(max_nodes_per_shard=8192, workers=2),
        # the ISSUE 14 acceptance bar: the COLD tick — now including the
        # arrive phase the pre-14 number silently excluded — must hold
        # the gate (measured 25.5 s post-coldec; the old gate was 120 s
        # over a 53.7 s phases-only p50). The flight record must also
        # explain the tick: span phase-sum within ±5% of the tick span.
        # Widened 35 s → 60 s in ISSUE 16: back-to-back runs of
        # IDENTICAL code measured 33.5 s and 50.6 s on this shared-host
        # container (±50% steal variance, digests byte-equal) — the
        # gate has to catch the structural 2× regression, not the
        # neighbor's compile job.
        p50_gate_ms=60_000.0,
        phase_reconcile_pct=5.0,
    )


def full_1mx200k(scale: float = 1.0, seed: int = 42) -> Scenario:
    """The 20×-scale headline (ISSUE 16, slow — the biggest shape in
    the suite): 1M pods × 200k nodes through the FULL bridge pipeline
    with the shard fan-out, per-shard mirror grouping and the
    overlapped mirror pipeline all on. 16 partitions of ~12.5k nodes
    across ~8k-node shards. Records ``full_tick_p50_ms_1mx200k`` with
    the standard phase breakdown. The gate is completion-shaped: the
    run must finish with zero invariant violations and the flight
    record must still reconcile (span phase-sum within ±5% of the tick
    span) under the overlapped pipeline; the p50 gate is set at 2× the
    500k gate — the shape doubles both axes but the cold tick is
    dominated by per-job work, which scales ~linearly in jobs — with
    the same shared-host steal-variance headroom (see
    ``full_500kx100k``)."""
    return Scenario(
        name="full_1mx200k",
        description="full-bridge sharded reconcile tick at the "
        "1M x 200k product shape (slow)",
        cluster=ClusterSpec(num_nodes=_n(200_000, scale), num_partitions=16),
        workload=WorkloadSpec(
            jobs=_n(1_000_000, scale, floor=200),
            arrival="front",
            gang_fraction=0.05,
            gpu_fraction=0.15,
            duration_range=(30.0, 120.0),
        ),
        ticks=3,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
        slow=True,
        sharding=ShardConfig(max_nodes_per_shard=8192, workers=2),
        p50_gate_ms=120_000.0,
        phase_reconcile_pct=5.0,
    )


def full_500kx100k_steady(scale: float = 1.0, seed: int = 42) -> Scenario:
    """The 10×-scale STEADY-STATE headline (ISSUE 11, slow): the
    ``full_500kx100k`` shape run three ticks longer, so after the cold
    bind (tick 1), the submit fan-out (tick 1's mirror) and the
    Running-status sweep (tick 2), ticks 3-5 are genuinely steady —
    nothing arrives, binds, completes or writes (job durations outlive
    the horizon by construction at 5 s/tick). Records
    ``steady_tick_p50_ms`` over those ticks, gated at ≤1 s — the
    "heavy traffic from millions of users" acceptance bar, where
    arrivals are a trickle against 500k standing pods. Kept separate
    from ``full_500kx100k`` so that scenario's 3-tick
    ``full_tick_p50_ms`` lineage (PR-2 → PR-10) stays comparable."""
    return Scenario(
        name="full_500kx100k_steady",
        description="steady-state sharded tick at 500k x 100k: ticks 3-5 "
        "must be O(changes) (slow)",
        cluster=ClusterSpec(num_nodes=_n(100_000, scale), num_partitions=16),
        workload=WorkloadSpec(
            jobs=_n(500_000, scale, floor=200),
            arrival="front",
            gang_fraction=0.05,
            gpu_fraction=0.15,
            duration_range=(30.0, 120.0),
        ),
        ticks=6,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
        slow=True,
        sharding=ShardConfig(max_nodes_per_shard=8192, workers=2),
        # the PR-11 acceptance bar: a steady-state tick at 500k×100k —
        # standing state unchanged, arrivals zero — completes within 1 s
        steady_gate_ms=1_000.0,
    )


def full_50kx10k(scale: float = 1.0, seed: int = 42) -> Scenario:
    """The headline: 50k pods × 10k nodes through the FULL bridge
    pipeline. Slow (minutes); records ``full_tick_p50_ms_50kx10k`` with
    the store/encode/solve/bind/mirror phase breakdown — the number the
    round-5 VERDICT called the unmeasured 90%."""
    return Scenario(
        name="full_50kx10k",
        description="full-bridge reconcile tick at the 50k x 10k product shape",
        cluster=ClusterSpec(num_nodes=_n(10_000, scale)),
        workload=WorkloadSpec(
            jobs=_n(50_000, scale, floor=100),
            arrival="front",
            gang_fraction=0.05,
            gpu_fraction=0.15,
            duration_range=(30.0, 120.0),
        ),
        ticks=3,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
        slow=True,
    )


def full_50kx10k_steady(scale: float = 1.0, seed: int = 42) -> Scenario:
    """The STEADY-STATE headline at 50k×10k (ISSUE 11, slow): the
    ``full_50kx10k`` shape plus three post-convergence ticks (see
    ``full_500kx100k_steady`` for the tick anatomy). Records
    ``steady_tick_p50_ms`` over ticks 3-5, gated at ≤50 ms."""
    return Scenario(
        name="full_50kx10k_steady",
        description="steady-state full-bridge tick at 50k x 10k: ticks "
        "3-5 must be O(changes) (slow)",
        cluster=ClusterSpec(num_nodes=_n(10_000, scale)),
        workload=WorkloadSpec(
            jobs=_n(50_000, scale, floor=100),
            arrival="front",
            gang_fraction=0.05,
            gpu_fraction=0.15,
            duration_range=(30.0, 120.0),
        ),
        ticks=6,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
        slow=True,
        # the PR-11 acceptance bar: a steady-state tick at 50k×10k —
        # standing state unchanged, arrivals zero — completes within 50 ms
        steady_gate_ms=50.0,
    )


def full_50kx10k_crash(scale: float = 1.0, seed: int = 42) -> Scenario:
    """Recovery at the HEADLINE shape (slow, minutes): the 50k×10k
    front-loaded scenario with a bridge crash after the cold-start tick.
    Until PR-8 every crash scenario ran at smoke scale only — this one
    proves snapshot+WAL reload and level-triggered re-convergence stay
    bounded when the snapshot carries ~60k objects (``recovery_ms`` in
    the timing section is the number BASELINE.md records)."""
    return Scenario(
        name="full_50kx10k_crash",
        description="bridge crash + snapshot/WAL reload at the 50k x 10k "
        "product shape (slow)",
        cluster=ClusterSpec(num_nodes=_n(10_000, scale)),
        workload=WorkloadSpec(
            jobs=_n(50_000, scale, floor=100),
            arrival="front",
            gang_fraction=0.05,
            gpu_fraction=0.15,
            duration_range=(30.0, 120.0),
        ),
        faults=FaultPlan(
            (Fault(kind="crash_restart", start_tick=2, end_tick=3),)
        ),
        ticks=4,
        expect_drain=False,
        drain_grace_ticks=0,
        seed=seed,
        persistence=True,
        slow=True,
    )


SCENARIOS = {
    f.__name__: f
    for f in (
        steady_poisson,
        burst_backlog,
        agent_flaky_rpc,
        preemption_storm,
        node_churn,
        partition_vanish,
        crash_restart,
        leader_failover,
        agent_crash,
        chaos_dual_crash,
        chaos_crash_rpc_flap,
        chaos_crash_into_vanished_partition,
        diurnal_load,
        multi_tenant_storm,
        priority_inversion,
        elastic_resize,
        interactive_storm,
        steady_state_soak,
        sharded_smoke,
        sharded_gang_split,
        fleet_smoke,
        fleet_kill_owner,
        full_500kx100k,
        full_500kx100k_steady,
        full_1mx200k,
        full_50kx10k,
        full_50kx10k_steady,
        full_50kx10k_crash,
    )
}

#: the composed-fault subset `make chaos-smoke` double-runs: crash
#: windows overlapping degraded-RPC/vanished-partition windows, agent
#: crashes, and the simultaneous bridge+agent crash — all twin-gated
CHAOS_SCENARIOS = (
    "agent_crash",
    "chaos_dual_crash",
    "chaos_crash_rpc_flap",
    "chaos_crash_into_vanished_partition",
)

#: the placement-quality subset `make quality-smoke` runs (ISSUE 9):
#: double-run determinism PLUS policy-on/off arm comparisons gated on
#: the scorecard (fairness, wait bounds, backfill utilization)
QUALITY_SCENARIOS = (
    "diurnal_load",
    "multi_tenant_storm",
    "priority_inversion",
    "elastic_resize",
)

#: the sharded-placement subset `make shard-smoke` double-runs (ISSUE
#: 10): determinism + invariants on the fan-out, plus shard-specific
#: gates (the plan actually shards; sharded_gang_split actually
#: reconciles). ``sharded_smoke`` ALSO rides sim-smoke — the tentpole
#: wants the fast sharded scenario in the default gate, and the extra
#: run is seconds at smoke scale
SHARD_SCENARIOS = (
    "sharded_smoke",
    "sharded_gang_split",
)

#: the streaming-admission subset `make admission-smoke` runs (ISSUE
#: 12): double-run determinism, the fast-path latency gate, engagement
#: (the fast path actually bound things), and the admission-off twin
#: comparison (batch utilization within the margin; the twin's latency
#: must be WORSE than the gate or the comparison is vacuous)
ADMISSION_SCENARIOS = ("interactive_storm",)

#: the fleet subset `make fleet-smoke` runs (ISSUE 17): double-run
#: determinism, the fleet-of-1 single-process twin digest, the
#: remote-solve engagement floor, and the kill-shard-owner chaos gate
#: (re-key to survivors, zero lost binds, bounded recovery). Excluded
#: from sim-smoke: each fleet run spawns real sidecar subprocesses
FLEET_SCENARIOS = (
    "fleet_smoke",
    "fleet_kill_owner",
)

#: the fast set `make sim-smoke` double-runs: everything not slow-marked,
#: MINUS the chaos and quality subsets (and the shard subset except
#: sharded_smoke, see above) — `make check` and CI run sim-smoke,
#: chaos-smoke, quality-smoke and shard-smoke side by side, so overlap
#: would execute each scenario (and its twin arms) twice for zero added
#: coverage
SMOKE_SCENARIOS = tuple(
    n for n, f in SCENARIOS.items()
    if not f().slow
    and n not in CHAOS_SCENARIOS
    and n not in QUALITY_SCENARIOS
    and n not in ADMISSION_SCENARIOS
    and n not in FLEET_SCENARIOS
    and (n not in SHARD_SCENARIOS or n == "sharded_smoke")
)
