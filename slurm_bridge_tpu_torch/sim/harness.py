"""The simulation harness: real bridge components, virtual time.

One :class:`SimHarness` owns the REAL control plane — :class:`ObjectStore`,
:class:`BridgeOperator` (reconciled synchronously, event-driven off the
store watch like its production pump thread), :class:`Configurator` with
its :class:`VirtualNodeProvider` mirrors (tickers disabled), and
:class:`PlacementScheduler` — wired to a :class:`SimWorkloadClient`
(optionally behind a :class:`FaultyClient`). Nothing sleeps; the harness
advances a virtual clock and drives every control loop one synchronous
step per tick, so a scenario is deterministic given its seed.

Tick order (one reconcile round):

1. fault boundaries — drain/resume nodes, hide/show partitions, inject
   preemption-storm arrivals;
2. arrivals — create BridgeJob CRs, reconcile them (sizecar pods appear);
3. scheduler tick — the real ``PlacementScheduler.tick`` (store → encode
   → solve → bind, phase-timed by the scheduler itself);
4. mirror — configurator partition diff, provider sync (node refresh,
   submit to "Slurm", statusmap translation), operator status sync for
   owners of changed pods;
5. sim step — complete jobs whose virtual runtime elapsed, start queued
   work;
6. invariants — see ``sim/invariants.py``;
7. advance virtual time.

After the scripted ticks, drain-grace ticks (no arrivals, faults over)
run until the pending queues empty or the grace budget is spent.
"""

from __future__ import annotations

import gc
import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from slurm_bridge_tpu_torch.bridge.configurator import Configurator
from slurm_bridge_tpu_torch.bridge.leader import LeaderElector
from slurm_bridge_tpu_torch.bridge.freeze import FrozenDict
from slurm_bridge_tpu_torch.bridge.objects import (
    BridgeJob,
    BridgeJobStatus,
    FetchState,
    JobState,
    Meta,
    Pod,
    PodPhase,
    PodRole,
    VirtualNode,
    new_uid,
)
from slurm_bridge_tpu_torch.core.fastpath import fast_new, frozen_new

#: shared empty frozen map for born-frozen arrival CRs
_EMPTY_FROZEN_DICT = FrozenDict()


def _freeze_scalar_spec(spec):
    """Flag a scalar-only BridgeJobSpec frozen without the per-field
    walk ``freeze`` pays (trace specs are one-per-arrival, 500k deep on
    a storm front; every field is a str/int, so the walk finds nothing
    to do anyway). ``freeze`` itself short-circuits on the flag."""
    from slurm_bridge_tpu_torch.core.fastpath import FROZEN_FLAG, enable_guard

    enable_guard(spec.__class__)
    spec.__dict__[FROZEN_FLAG] = True
    return spec
from slurm_bridge_tpu_torch.bridge.operator import BridgeOperator
from slurm_bridge_tpu_torch.bridge.persist import StorePersistence, load_into
from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
from slurm_bridge_tpu_torch.bridge.store import ObjectStore
from slurm_bridge_tpu_torch.core.types import JobStatus
from slurm_bridge_tpu_torch.obs.events import EventRecorder
from slurm_bridge_tpu_torch.obs.flight import FlightRecorder
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.tracing import TRACER, with_current_span
from slurm_bridge_tpu_torch.agent.journal import AgentJournal
from slurm_bridge_tpu_torch.parallel import colpool
from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
from slurm_bridge_tpu_torch.policy.classes import CLASS_LABEL, TENANT_LABEL
from slurm_bridge_tpu_torch.policy.engine import PlacementPolicy
from slurm_bridge_tpu_torch.policy.score import QualityTracker
from slurm_bridge_tpu_torch.sim.agent import SimCluster, SimWorkloadClient
from slurm_bridge_tpu_torch.sim.faults import AGENT_KINDS, FaultPlan, FaultyClient
from slurm_bridge_tpu_torch.wire.errors import RpcError
from slurm_bridge_tpu_torch.wire.rpc import RetryingClient, RetryPolicy
from slurm_bridge_tpu_torch.sim.invariants import (
    Violation,
    check_drain,
    check_tick,
    per_node_demand,
)
from slurm_bridge_tpu_torch.sim.trace import (
    ClusterSpec,
    WorkloadSpec,
    build_cluster,
    generate_trace,
    storm_arrivals,
)

log = logging.getLogger("sbt.sim")

_tick_seconds = REGISTRY.histogram(
    "sbt_sim_tick_seconds", "full simulated reconcile tick wall time"
)

#: the phases the full-tick headline decomposes into. ``other`` is the
#: scheduler-tick time OUTSIDE the four named phases (RPC-fault aborts,
#: remote skips, any new cost a future change adds) — an explicit bucket
#: so the numbers stop lying by silently folding it into "store".
#: ``arrive`` (ISSUE 14) is the arrival-ingest phase — CR creation,
#: operator sweep, admission fast path — which used to sit OUTSIDE the
#: tick sum entirely: at 500k×100k that was ~25 s of real per-tick work
#: the headline number silently excluded and the flight record could
#: not reconcile (phase_sum 36.4 s vs tick span 63.0 s).
PHASES = ("arrive", "store", "encode", "solve", "bind", "mirror", "other")


@dataclass(frozen=True)
class Scenario:
    """A named, fully-seeded simulation run."""

    name: str
    cluster: ClusterSpec
    workload: WorkloadSpec
    faults: FaultPlan = field(default_factory=FaultPlan)
    ticks: int = 30
    #: virtual seconds per tick — 5 keeps the drain horizon (grace ticks ×
    #: interval) comfortably above the worst serialization chain on a
    #: scarce resource (a few max-duration jobs queued on one GPU node)
    tick_interval_s: float = 5.0
    seed: int = 42
    preemption: bool = False
    backend: str = "auto"
    expect_drain: bool = True
    drain_grace_ticks: int = 60
    description: str = ""
    slow: bool = False
    #: the tick flight recorder (span capture + attribution records);
    #: off is the control arm of the bench-smoke overhead gate
    tracing: bool = True
    #: WAL-backed store persistence, flushed synchronously at every tick
    #: boundary (and compacted periodically). Forced on when the fault
    #: plan contains a bridge-level fault (crash_restart /
    #: leader_failover) — recovery needs something to recover FROM; the
    #: WAL-overhead bench gate flips it on a fault-free scenario
    persistence: bool = False
    #: sim-smoke gate: fault scenarios must report recovery_ticks ≤ this
    #: (None = only the existing non-None check applies)
    max_recovery_ticks: int | None = None
    #: stack a bounded-retry wrapper (backoff+jitter, virtual sleeps)
    #: over the client, so transient injected RPC errors heal inside the
    #: tick instead of surfacing as failed control-loop rounds
    rpc_retries: bool = False
    #: simulated per-fsync device latency for the WAL (ms). 0 keeps the
    #: sim's fsync-off mode; >0 turns real fsyncs ON with that much
    #: injected latency — the fsync-realism bench arm
    wal_fsync_ms: float = 0.0
    #: smoke-gate twin comparison for crash scenarios: "" = none,
    #: "state" = final_state_digest must be byte-identical to the twin
    #: with bridge/agent crash faults stripped, "outcome" = the
    #: id/placement-insensitive final_outcome_digest must be (used when
    #: composed RPC faults legitimately reshuffle job ids/placements)
    lossless_twin: str = ""
    #: placement-policy config (policy.PolicyConfig) — priority classes,
    #: fair share, bounded preemption, backfill. None = policy OFF, the
    #: PR-8 tick byte-for-byte (the quality-smoke gate proves it)
    policy: object | None = None
    #: explicit AuctionConfig for backend="auction" scenarios (None =
    #: scheduler defaults). diurnal_load pins an APPROXIMATE config
    #: (repair off, few rounds) so the backfill pass has real
    #: fragmentation holes to fill — the shape the quality gate measures
    auction_config: object | None = None
    #: sharded-placement config (shard.ShardConfig) — partition/island
    #: fan-out + cross-shard gang reconciliation. None = sharding OFF,
    #: the monolithic tick byte-for-byte (fixture-pinned, like policy)
    sharding: object | None = None
    #: CLI-enforced tick p50 ceiling (ms) for slow headline scenarios;
    #: None = record only
    p50_gate_ms: float | None = None
    #: event-driven incremental tick (PR-11): cursor-scoped mirror sync,
    #: dirty-set pending scan, warm-start solve reuse. On by default —
    #: byte-identical determinism digest and final_state_digest to the
    #: full tick is the acceptance bar (the smoke gates run an
    #: incremental=False twin per scenario to prove it); False is the
    #: PR-10 tick byte-for-byte (fixture-pinned)
    incremental: bool = True
    #: CLI-enforced STEADY-STATE tick p50 ceiling (ms): the median over
    #: ticks in which nothing arrived, bound, preempted, faulted or
    #: wrote — the O(changes) acceptance number; None = record only
    steady_gate_ms: float | None = None
    #: streaming-admission config (admission.AdmissionConfig) — the
    #: always-on fast path that binds interactive-class arrivals
    #: against the residual free_after view at ARRIVAL time, before the
    #: batch tick sees them. None = admission OFF, the PR-11 tick
    #: byte-for-byte (fixture-pinned, like policy/sharding/incremental)
    admission: object | None = None
    #: zero-object wire→column decode on the bulk RPCs (ISSUE 14). On by
    #: default — digests must be byte-identical either way; False is the
    #: PR-12 pb2 bulk path byte-for-byte (fixture-pinned,
    #: tests/fixtures/coldec_off_baseline.json)
    coldec: bool = True
    #: CLI-enforced flight-record reconciliation gate (percent): the
    #: span-derived phase_sum_p50 must match the tick span p50 within
    #: this tolerance — the PR-5 ±5% contract, re-enforced at the
    #: headline shape now that the recorder's rollup survives span
    #: drops. None = record only.
    phase_reconcile_pct: float | None = None
    #: placement explainability (ISSUE 15): structured per-job reason
    #: codes + the per-tick pressure ledger (flight record,
    #: ``quality.wait_reasons``, /debug/schedz). On by default —
    #: digest-byte-identical to off BY CONSTRUCTION (attribution only
    #: observes solve artifacts; ``profile_explain_overhead`` gates the
    #: claim); False restores the generic reason strings byte-for-byte.
    explain: bool = True
    #: trace ONE job's decision trail (``--explain <job>`` on the CLI):
    #: the sizecar pod name (or job name — the CLI normalizes) whose
    #: route/solve/backfill/reason decisions are recorded per tick
    explain_target: str = ""
    #: per-shard mirror ownership (ISSUE 16): group the provider syncs
    #: by OWNING shard (executor.mirror_groups), so each shard mirrors
    #: its own contiguous slice of the partition list; the flattened
    #: order equals the sorted global order and the owner sweep stays
    #: global, keeping digests byte-identical. A no-op unless
    #: ``sharding`` is set (one group ≡ the global pass); False keeps the
    #: single global provider pass as the byte-identical oracle
    shard_mirror: bool = True
    #: pipelined mirror (ISSUE 16 phase overlap): run one provider's
    #: chunked status fetch on an overlap thread while the NEXT
    #: provider's classification/converge runs on the main thread — all
    #: store writes stay on the main thread in provider order, so
    #: digests are byte-identical to the sequential mirror (the staged
    #: equivalence suite proves it). Auto-disabled when the fault plan
    #: is non-empty: fault draws must stay on the plain sequenced path.
    #: False is the sequential oracle
    mirror_pipeline: bool = True
    #: partitioned store commit (ISSUE 19): the pool workers that
    #: decode+diff a mirror chunk also pack its commit frame, and the
    #: status write merges per-chunk writer partitions through
    #: ``store.apply_frames`` under one short lock. Engages only when a
    #: colpool is active (``SBT_COLPOOL_WORKERS`` ≥ 1 or multi-core
    #: affinity) — on this repo's 1-core CI the flag is inert and the
    #: serial scatter runs regardless. False is the PR-18 serial
    #: column-scatter oracle byte-for-byte (fixture-pinned,
    #: tests/fixtures/frames_off_baseline.json)
    mirror_frames: bool = True
    #: fleet runtime config (fleet.FleetConfig): replicas + solver
    #: sidecar processes; per-shard solves dispatch to the shard
    #: owner's sidecar over real gRPC (byte-parity with inline — the
    #: fleet twin gate proves it). None = single-process, zero overhead
    fleet: object | None = None
    #: fleet-wide observability (ISSUE 20): PlaceShard trace stitching,
    #: colpool worker self-timing folds, metrics federation and the
    #: lifecycle timeline. Digest-neutral either way; False is the
    #: control arm of the paired profile_fleet_obs_overhead gate
    fleet_obs: bool = True


@dataclass
class ScenarioResult:
    scenario: Scenario
    determinism: dict
    timing: dict
    shape: dict
    #: placement-quality scorecard (policy/score.py) — utilization,
    #: fragmentation, wait percentiles, preemption churn, fairness;
    #: computed for EVERY scenario (virtual-time deterministic) and
    #: gated for the quality subset in `make quality-smoke`
    quality: dict = field(default_factory=dict)
    #: run-level flight record (span tree p50s, top self-time, commit
    #: breakdown); {} when the scenario ran with tracing off
    flight_record: dict = field(default_factory=dict)
    #: per-tick flight records — written to diagnostics/ for the slow
    #: headline run, kept off the one-line scenario JSON otherwise
    flight_ticks: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "scenario": self.scenario.name,
            "seed": self.scenario.seed,
            "shape": self.shape,
            "faults": self.scenario.faults.describe(),
            "determinism": self.determinism,
            "timing": self.timing,
            "quality": self.quality,
            "flight_record": self.flight_record,
        }

    def determinism_json(self) -> str:
        """The byte-comparable section: everything except wall-clock."""
        return json.dumps(
            {
                "scenario": self.scenario.name,
                "seed": self.scenario.seed,
                "shape": self.shape,
                "determinism": self.determinism,
            },
            sort_keys=True,
        )


def _quiet_event_logs() -> None:
    # the recorder logs every event; at 50k binds/tick that is pure drag
    # (and Unschedulable churn would spam stderr through the lastResort
    # handler) — scenario metrics carry the same information
    logging.getLogger("sbt.events").setLevel(logging.CRITICAL)
    logging.getLogger("sbt.scheduler").setLevel(logging.ERROR)
    logging.getLogger("sbt.vnode").setLevel(logging.ERROR)
    logging.getLogger("sbt.configurator").setLevel(logging.ERROR)


def _collect_young() -> None:
    """The between-tick collection over what the tick allocated: the
    survivors join the frozen heap, so the next one does not re-scan the
    store's million live objects (a full collection took ~0.4 s a tick
    at the 80-scale quality scenarios on an 8-core host). Cycles that
    reach into the frozen heap wait for ``run``'s ``gc.unfreeze``."""
    gc.collect()
    gc.freeze()


class SimHarness:
    #: snapshot-compaction cadence (ticks): keeps both recovery inputs —
    #: a recent snapshot AND a WAL tail since it — live in every
    #: crash-window, so a mid-run reload exercises snapshot+replay
    _COMPACT_EVERY = 4

    def __init__(self, scenario: Scenario, device=None):
        _quiet_event_logs()
        self.scenario = scenario
        #: where the scheduler's device auction runs: None is the card
        #: (or SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py)
        self.device = device
        ensure_backend(device)
        self.vt = 0.0
        rng = np.random.default_rng(scenario.seed)
        nodes, partitions = build_cluster(scenario.cluster, rng)
        self.cluster = SimCluster(nodes, partitions, clock=lambda: self.vt)
        by_name = {n.name: n for n in nodes}
        part_names = list(partitions)
        sizes = [len(partitions[p]) for p in part_names]
        gpu_caps = [
            max((by_name[m].gpus for m in partitions[p]), default=0)
            for p in part_names
        ]
        gpu_counts = [
            sum(1 for m in partitions[p] if by_name[m].gpus > 0)
            for p in part_names
        ]
        self.trace = generate_trace(
            scenario.workload,
            scenario.cluster,
            scenario.ticks,
            rng,
            partition_sizes=sizes,
            partition_gpu_caps=gpu_caps,
            partition_gpu_counts=gpu_counts,
        )
        for f in scenario.faults.faults:
            if f.kind == "preemption_storm" and f.start_tick < scenario.ticks:
                # extra kwargs only on the NEW gang/class shape, so plain
                # storms replay the PR-2 byte stream exactly (the
                # defaults are draw-identical either way)
                kw: dict = {}
                if f.gang_size > 1 or f.storm_class or f.storm_cpus:
                    eligible = [
                        k
                        for k, size in enumerate(sizes)
                        if size >= max(1, f.gang_size)
                    ]
                    if f.gang_size > 1 and not eligible:
                        # a storm gang no partition can host would pend
                        # forever and surface as a misleading wait-bound
                        # failure — refuse the config loudly instead
                        raise ValueError(
                            f"preemption_storm gang_size={f.gang_size} "
                            "fits no partition at this scale "
                            f"(sizes={sizes})"
                        )
                    kw = dict(
                        gang_size=f.gang_size,
                        storm_class=f.storm_class,
                        eligible_parts=eligible,
                    )
                    if f.storm_cpus:
                        kw["cpus"] = f.storm_cpus
                self.trace[f.start_tick].extend(
                    storm_arrivals(
                        f.start_tick, f.jobs, scenario.cluster, rng,
                        priority=f.priority, **kw,
                    )
                )
        # ---- placement-quality accounting (ISSUE 9) ----
        tenant_of: dict[str, str] = {}
        is_gang: dict[str, bool] = {}
        class_of: dict[str, str] = {}
        shard_cpus: list[float] = []
        for arrivals in self.trace:
            for a in arrivals:
                tenant_of[a.name] = a.labels.get(TENANT_LABEL, "")
                is_gang[a.name] = (a.spec.nodes or 1) > 1
                class_of[a.name] = a.labels.get(CLASS_LABEL, "")
                shard_cpus.append(
                    max(1, a.spec.cpus_per_task)
                    * max(1, a.spec.ntasks)
                    / max(1, a.spec.nodes or 1)
                )
        self.quality = QualityTracker(
            tenant_of=tenant_of,
            is_gang=is_gang,
            class_of=class_of,
            tenant_weights=(
                dict(scenario.policy.tenant_weights)
                if scenario.policy is not None
                else {}
            ),
            ref_cpu=float(np.median(shard_cpus)) if shard_cpus else 1.0,
            tick_interval_s=scenario.tick_interval_s,
        )
        base_client = SimWorkloadClient(self.cluster)
        #: the unwrapped fake agent — the steady-state gate reads its
        #: per-method call counter (calls that reach the agent, so
        #: injected failures don't count — the gate runs fault-free)
        self.agent_client = base_client
        #: the FaultyClient (tick advance + injection counters) — kept
        #: separate from ``self.client`` because a retry wrapper may
        #: stack on top of it
        self.faulty: FaultyClient | None = (
            FaultyClient(base_client, scenario.faults, seed=scenario.seed + 1)
            if scenario.faults
            else None
        )
        self.client = self.faulty if self.faulty is not None else base_client
        self.retrier: RetryingClient | None = None
        if scenario.rpc_retries:
            # virtual time: retries cost no wall clock (sleep is a no-op)
            # and draw jitter from a seeded RNG so injection sequences —
            # and therefore whole runs — stay deterministic
            self.retrier = RetryingClient(
                self.client,
                policy=RetryPolicy(max_attempts=8),
                sleep=lambda s: None,
                seed=scenario.seed + 2,
            )
            self.client = self.retrier
        # deterministic drain targets resolved up front (plan seed, not
        # call order): node_fraction picks evenly-spaced names
        self._drain_targets: dict[int, tuple[str, ...]] = {}
        names = sorted(self.cluster.nodes)
        for i, f in enumerate(scenario.faults.faults):
            if f.kind != "drain_nodes":
                continue
            picked = list(f.nodes)
            if f.node_fraction > 0:
                k = max(1, int(round(f.node_fraction * len(names))))
                stride = max(1, len(names) // k)
                picked.extend(names[(i % stride) :: stride][:k])
            self._drain_targets[id(f)] = tuple(picked)

        self.store = ObjectStore()
        self.events = EventRecorder()
        self._event_counts: dict[str, int] = {}
        self._preempt_events = 0
        self.events.add_sink(self._count_event)
        #: the pipelined mirror's overlap thread (lazy; stack-scoped)
        self._mirror_pool = None
        #: fleet runtime (ISSUE 17) — built after the state dir below;
        #: None until then so _build_stack's attach guard no-ops
        self.fleet = None
        #: ISSUE 20: parent-side folding of colpool worker timing headers
        #: follows the scenario's obs arm (headers always ride the wire;
        #: _cleanup restores the process default)
        colpool.set_obs(scenario.fleet_obs)
        self._build_stack()
        #: the tick flight recorder — always-on unless the scenario opts
        #: out (the overhead gate's control arm); every run_tick is one
        #: capture window rooted at a "sim.tick" span
        self.flight = FlightRecorder(
            tracer=TRACER, store=self.store, enabled=scenario.tracing
        )
        self.rpc_failures: dict[str, int] = {}
        self.violations: list[Violation] = []
        self._digest = hashlib.sha256()
        self._bound_total = 0
        self._preempted_total = 0
        #: pod names bound by the streaming fast path THIS tick — folded
        #: into the bound accounting + capacity invariants (they are not
        #: in pending_before, so the batch diff cannot see them)
        self._fast_bound_tick: list[str] = []
        self._tick_phases: list[dict[str, float]] = []
        #: per-tick pressure ledgers (ISSUE 15): (tick, ledger) for every
        #: solve tick that attributed reasons — what the flight record
        #: carries per tick and the explain tests pin (per-reason counts
        #: sum to the unplaced count by construction)
        self._explain_ledgers: list[tuple[int, dict]] = []
        #: per-tick steady-state accounting (PR-11): arrivals, binds,
        #: commits, agent RPCs, solver invocations and the derived
        #: ``steady`` verdict — what ``steady_tick_p50_ms`` and the
        #: bench-smoke zero-work gate read
        self._tick_meta: list[dict] = []
        self._arrive_ms: list[float] = []
        self._pending_by_tick: list[int] = []
        self._drained_at: int | None = None
        self._recovered_at: int | None = None

        # ---- durability + leadership (PR-7/PR-8) ----
        plan_kinds = {f.kind for f in scenario.faults.faults}
        self._needs_persistence = scenario.persistence or bool(
            plan_kinds & {"crash_restart", "leader_failover"}
        )
        self._needs_agent_journal = bool(plan_kinds & set(AGENT_KINDS))
        self._state_dir: str | None = None
        self.persistence: StorePersistence | None = None
        self.agent_journal: AgentJournal | None = None
        #: whether the control plane is alive this tick (False only in
        #: the leaderless window between a leader dying and the standby's
        #: lease takeover)
        self._stack_up = True
        #: arrivals landing in a leaderless window queue here (the
        #: client retrying against a dead control plane) and replay on
        #: the first tick the standby is up
        self._arrival_backlog: list = []
        self._restarts = 0
        self._agent_restarts = 0
        self.vnode_deletions = 0
        self._takeover_ticks: list[int] = []
        self._wal_records_prior = 0
        self._snapshots_prior = 0
        self._recovery_ms: list[float] = []
        self._wal_flush_ms: list[float] = []
        self._restored_objects: list[int] = []
        self._agent_restored_jobs: list[int] = []
        self.elector: LeaderElector | None = None
        self._standby: LeaderElector | None = None
        self._active_elector: LeaderElector | None = None
        self._dead_elector: LeaderElector | None = None
        if (
            self._needs_persistence
            or self._needs_agent_journal
            or scenario.fleet is not None
        ):
            self._state_dir = tempfile.mkdtemp(prefix="sbt-sim-state-")
        if self._needs_persistence:
            self.state_file = os.path.join(self._state_dir, "bridge-state.json")
            self.persistence = self._make_persistence()
        if self._needs_agent_journal:
            # fsync off, like the bridge WAL: sim durability is
            # within-process; the journal's every-transition appends are
            # driven purely by virtual events, so replay is deterministic
            self.agent_journal = AgentJournal(
                os.path.join(self._state_dir, "agent-journal.json"),
                fsync=False,
            )
            self.cluster.attach_journal(self.agent_journal)
        if "leader_failover" in plan_kinds:
            lease_path = os.path.join(self._state_dir, "leader.lease")
            # 8 virtual seconds: outlives one 5 s tick gap, expires
            # during the second — expiry takeover exercises a real
            # leaderless window, graceful handover is immediate
            self.elector = LeaderElector(
                lease_path,
                identity="bridge-0",
                lease_duration=8.0,
                clock=lambda: self.vt,
            )
            if not self.elector.try_acquire():  # pragma: no cover - fresh dir
                raise RuntimeError("sim leader could not acquire a fresh lease")
            self._standby = LeaderElector(
                lease_path,
                identity="bridge-1",
                lease_duration=8.0,
                clock=lambda: self.vt,
            )
            self._active_elector = self.elector

        if scenario.fleet is not None:
            from slurm_bridge_tpu_torch.fleet.runtime import FleetRuntime

            # leases run on virtual time (the sim drives heartbeats);
            # sidecar spawn/handshake is wall-time OS work, like any
            # other subprocess the harness owns
            self.fleet = FleetRuntime(
                scenario.fleet, self._state_dir, clock=lambda: self.vt,
                obs=scenario.fleet_obs,
            )
            self.fleet.start()
            self._attach_fleet()

    def _attach_fleet(self) -> None:
        """Point the executor's remote seam at the fleet (re-run after a
        crash reload rebuilds the scheduler)."""
        if self.fleet is not None and self.scheduler.shard is not None:
            self.scheduler.shard.remote = self.fleet

    def _make_persistence(self) -> StorePersistence:
        """StorePersistence in the sim's deterministic posture: manual
        flush (no pump thread, no timers). fsync stays OFF at 0 ms —
        sim "durability" is within-process, and a real fsync per virtual
        tick would dominate the toy-scale overhead measurement the bench
        gate pairs against — and flips ON with injected device latency
        when the scenario carries ``wal_fsync_ms`` (the fsync-realism
        bench arm)."""
        fsync_ms = self.scenario.wal_fsync_ms
        return StorePersistence(
            self.store,
            self.state_file,
            auto_flush=False,
            fsync=fsync_ms > 0,
            fsync_delay_s=(fsync_ms / 1e3) if fsync_ms > 0 else None,
        )

    def _build_stack(self) -> None:
        """(Re)build the real control plane over ``self.store`` — called
        at init and again by the crash/failover reload. Watches are
        re-established on the new store; its synthetic ADDED backlog is
        exactly the level-triggered resync a restarted operator needs."""
        scenario = self.scenario
        self.operator = BridgeOperator(
            self.store, agent_endpoint="sim://agent", events=self.events
        )
        self.configurator = Configurator(
            self.store,
            self.client,
            agent_endpoint="sim://agent",
            events=self.events,
            node_sync_interval=0.0,  # no tickers: the harness drives sync
            pod_sync_workers=1,  # serial converge: deterministic order
            provider_inventory_ttl=0.0,  # no wall-clock cache window
            # heartbeat never forces a node write: the 10 s default is a
            # WALL clock, so a slow box running a long tick would write
            # VirtualNode heartbeats mid-run — nondeterministic commit
            # counts and a false "not steady" verdict on idle ticks.
            # Capacity changes still rewrite the node.
            provider_status_interval=float("inf"),
            incremental=scenario.incremental,
            use_coldec=scenario.coldec,
            mirror_frames=scenario.mirror_frames,
            # admission-window maintenance from the periodic inventory
            # probe (ROADMAP follow-up c) — late-bound: the scheduler is
            # constructed a few lines below, before any provider syncs
            inventory_listener=lambda part, nodes: (
                self.scheduler.note_inventory(part, nodes)
            ),
        )
        # fresh policy engine per stack incarnation: a crash loses the
        # in-memory fair-share accumulator exactly as production would
        self.policy_engine = (
            PlacementPolicy(scenario.policy)
            if scenario.policy is not None
            else None
        )
        self.scheduler = PlacementScheduler(
            self.store,
            self.client,
            backend=scenario.backend,
            auction_config=scenario.auction_config,
            events=self.events,
            preemption=scenario.preemption,
            inventory_ttl=0.0,  # virtual time: always take a fresh snapshot
            policy=self.policy_engine,
            # a fresh executor per stack incarnation: its per-shard caches
            # are in-memory tick state, rebuilt from scratch after a crash
            # exactly like the monolithic encode caches
            shard=scenario.sharding,
            incremental=scenario.incremental,
            # a fresh admitter too: the residual view and in-flight
            # deductions are in-memory tick state — after a crash the
            # fast path stays dormant until the first post-reload solve
            # re-bases its window (arrivals fall through to the batch
            # tick meanwhile, the safe direction)
            admission=scenario.admission,
            explain=scenario.explain,
            explain_target=scenario.explain_target,
            device=self.device,
        )
        if self.scheduler.explain_trail is not None:
            # one trail per RUN: a crash/failover rebuild keeps the
            # lines recorded by the previous incarnation
            prev_lines = getattr(self, "_trail_lines", None)
            if prev_lines is not None:
                self.scheduler.explain_trail.lines = prev_lines
            self._trail_lines = self.scheduler.explain_trail.lines
        self._pod_watch = self.store.watch((Pod.KIND,))
        self._node_watch = self.store.watch((VirtualNode.KIND,))
        # fleet re-attach (no-op at init: the fleet is built after the
        # first _build_stack; crash reloads re-point the fresh executor)
        if getattr(self, "fleet", None) is not None:
            self._attach_fleet()

    # ---- crash / failover machinery ----

    def _drain_node_watch(self) -> None:
        """Count VirtualNode DELETED events — the node-flap detector the
        failover scenarios gate to zero (synthetic ADDED events from a
        fresh watch pass through uncounted)."""
        while True:
            try:
                ev = self._node_watch.get_nowait()
            except Exception:
                break
            if ev.type == "DELETED":
                self.vnode_deletions += 1

    def _teardown_stack(self, *, flush: bool) -> None:
        """Kill the control plane. ``flush=True`` is the graceful path
        (step-down: WAL flushed first); ``False`` is a crash — whatever
        the last tick-boundary flush captured is all recovery gets."""
        if flush and self.persistence is not None:
            self.persistence.flush()
        self._drain_node_watch()
        # pool/ticker teardown only — Configurator.stop() must leave
        # every VirtualNode in the store (the ADVICE #1 contract; the
        # failover scenarios assert zero node deletions)
        self.configurator.stop()
        if self.scheduler.shard is not None:
            self.scheduler.shard.close()
        if self._mirror_pool is not None:
            self._mirror_pool.shutdown(wait=False)
            self._mirror_pool = None
        self.store.unwatch(self._pod_watch)
        self.store.unwatch(self._node_watch)

    def _reload_stack(self, tick: int) -> None:
        """Bring up a fresh bridge over snapshot+WAL: new store, rebased
        persistence incarnation, new operator/configurator/scheduler.
        The sim agent (ground truth "Slurm") is untouched — partitions
        and jobs outlive the controller, the JIRIAF operating model."""
        t0 = time.perf_counter()
        self.store = ObjectStore()
        restored = load_into(self.store, self.state_file)
        if self.persistence is not None:
            self._wal_records_prior += self.persistence.wal_records_total
            self._snapshots_prior += self.persistence.snapshots_written
            # crash semantics: no flush — but the dead incarnation's WAL
            # file handle must not outlive it (one leaked fd per restart,
            # and two live handles on one WAL invite interleaved writes)
            self.persistence.abandon()
        self.persistence = self._make_persistence()
        self.persistence.compact()
        self._build_stack()
        self._recovery_ms.append((time.perf_counter() - t0) * 1e3)
        self._restored_objects.append(restored)
        self.flight.store = self.store
        self._restarts += 1
        self._note(tick, "restart", restored)

    def _agent_faults(self, tick: int) -> None:
        """Apply agent-level faults at the tick boundary. ``agent_crash``
        drops the fake agent's process state and rebuilds it from the
        job-state journal — applied BEFORE the bridge faults so a
        simultaneous bridge+agent crash has the reloaded bridge resync
        against the reloaded agent (the composed-durability shape)."""
        plan = self.scenario.faults
        for _ in plan.starting("agent_crash", tick):
            t0 = time.perf_counter()
            restored = self.cluster.crash_reload()
            self._recovery_ms.append((time.perf_counter() - t0) * 1e3)
            self._agent_restored_jobs.append(restored)
            self._agent_restarts += 1
            self._note(tick, "agent-crash", restored)

    def _bridge_faults(self, tick: int) -> None:
        """Apply bridge-level faults at the tick boundary, then renew or
        chase the lease."""
        plan = self.scenario.faults
        for _ in plan.starting("crash_restart", tick):
            self._note(tick, "crash")
            self._teardown_stack(flush=False)
            self._reload_stack(tick)
        for f in plan.starting("leader_failover", tick):
            self._note(
                tick, "leader-down", "graceful" if f.graceful else "expiry"
            )
            self._teardown_stack(flush=f.graceful)
            dead = self._active_elector
            if dead is not None and f.graceful:
                dead.release()
            # a supervisor restarts the dead process — it rejoins the
            # election as the standby for any later failover window
            self._dead_elector = dead
            self._active_elector = None
            self._stack_up = False
        if not self._stack_up and self._standby is not None:
            if self._standby.try_acquire():
                self._note(tick, "leader-up", self._standby.identity)
                self._reload_stack(tick)
                self._active_elector = self._standby
                self._standby = self._dead_elector
                self._dead_elector = None
                self._stack_up = True
                self._takeover_ticks.append(tick)
        elif self._active_elector is not None:
            self._active_elector.try_acquire()  # periodic renewal

    # ---- bookkeeping ----

    def _count_event(self, ev) -> None:
        self._event_counts[ev.reason] = self._event_counts.get(ev.reason, 0) + 1
        if ev.message.startswith("preempted:"):
            self._preempt_events += 1

    def _note(self, *parts: object) -> None:
        self._digest.update("|".join(str(p) for p in parts).encode())
        self._digest.update(b"\n")

    def _rpc_fail(self, where: str) -> None:
        self.rpc_failures[where] = self.rpc_failures.get(where, 0) + 1

    @staticmethod
    def _pending_names(pods: list[Pod]) -> set[str]:
        """PlacementScheduler.pending_pods()'s filter over an
        already-fetched list (one store copy per tick, not one per use) —
        keep in lockstep with bridge/scheduler.py."""
        return {
            p.name
            for p in pods
            if p.spec.role == PodRole.SIZECAR
            and not p.spec.node_name
            and not p.meta.deleted
            and p.status.phase == PodPhase.PENDING
        }

    # ---- tick machinery ----

    def _apply_fault_boundaries(self, tick: int) -> None:
        plan = self.scenario.faults
        for f in plan.starting("drain_nodes", tick):
            self.cluster.drain(list(self._drain_targets.get(id(f), f.nodes)))
        for f in plan.ending("drain_nodes", tick):
            self.cluster.resume(list(self._drain_targets.get(id(f), f.nodes)))
        for f in plan.starting("partition_vanish", tick):
            self.cluster.hide_partition(f.partition)
        for f in plan.ending("partition_vanish", tick):
            self.cluster.show_partition(f.partition)
        for f in plan.starting("elastic_resize", tick):
            self._apply_resizes(tick, f)

    # ---- elastic resize (VirtualFlow, arxiv 2009.09523) ----

    def _apply_resizes(self, tick: int, fault) -> None:
        """Change ``fault.jobs`` bound jobs' shard counts mid-flight:
        singles grow to 2 nodes, gangs halve (total demand is spread
        across shards, so growing always stays feasible). Targets are
        the first eligible pods in name order — deterministic."""
        part_size = {
            name: len(members)
            for name, members in self.cluster.partitions.items()
        }
        pods = sorted(
            (
                p
                for p in self.store.list(Pod.KIND)
                if p.spec.role == PodRole.SIZECAR
                and p.spec.node_name
                and p.spec.demand is not None
                and not p.meta.deleted
                and p.status.phase in (PodPhase.PENDING, PodPhase.RUNNING)
            ),
            key=lambda p: p.name,
        )
        done = 0
        for pod in pods:
            if done >= fault.jobs:
                break
            nodes = max(1, pod.spec.demand.nodes)
            new_nodes = nodes // 2 if nodes > 1 else 2
            if new_nodes > part_size.get(pod.spec.partition, 0):
                continue
            if self._resize_pod(pod.name, new_nodes, tick):
                done += 1

    def _resize_pod(self, name: str, new_nodes: int, tick: int) -> bool:
        """One mid-flight resize: cancel the running Slurm jobs, rewrite
        the demand's shard count under a fresh submit generation, and
        requeue — the scheduler re-places it at the new shape next tick.
        Mirrors the scheduler's ``_preempt`` reset-before-cancel order so
        the terminal CANCELLED state can never race the requeue."""
        from slurm_bridge_tpu_torch.bridge.store import NotFound
        from slurm_bridge_tpu_torch.wire import pb

        job_ids: list[int] = []

        def record(p):
            job_ids.clear()
            if not p.spec.node_name or p.meta.deleted:
                return False
            job_ids.extend(p.status.job_ids)
            gen = int(p.meta.annotations.get("submit-generation", "0")) + 1
            p.meta.annotations["submit-generation"] = str(gen)
            p.spec.node_name = ""
            p.spec.placement_hint = ()
            p.spec.demand.nodes = new_nodes  # mutate() hands a thawed copy
            p.status.job_ids = ()
            p.status.job_infos = []
            p.status.phase = PodPhase.PENDING
            p.status.reason = "Resizing: shard count changed"

        try:
            self.store.mutate(Pod.KIND, name, record, site="sim.resize")
        except NotFound:
            return False
        pod = self.store.try_get(Pod.KIND, name)
        if pod is None or pod.spec.node_name:
            return False
        for jid in job_ids:
            try:
                self.client.CancelJob(pb.CancelJobRequest(job_id=jid))
            except RpcError:
                self._rpc_fail("sim.resize")
        owner = pod.meta.owner or name

        def stamp_job(j):
            j.spec.nodes = new_nodes

        try:
            self.store.mutate(BridgeJob.KIND, owner, stamp_job, site="sim.resize")
        except NotFound:
            pass
        self._note(tick, "resize", name, new_nodes)
        self.quality.note_rearrival(owner, tick)
        self.quality.note_resize()
        return True

    def _arrive(self, tick: int) -> int:
        arrivals = self._arrival_backlog + (
            self.trace[tick] if tick < len(self.trace) else []
        )
        self._arrival_backlog = []
        if not self._stack_up:
            # leaderless window: the control plane is down — the client
            # queues its submissions and retries once a leader is back
            self._arrival_backlog = arrivals
            return 0
        if not arrivals:
            return 0
        admitter = self.scheduler.admission
        warmup = (
            admitter.config.latency_warmup_ticks
            if admitter is not None
            else 0
        )
        # ---- batched arrival ingest (ISSUE 14) ----
        # The per-arrival trickle (create → reconcile → stamp, ~5 store
        # round-trips + one single-key reconcile per job) was ~25 s of
        # UNATTRIBUTED tick time at the 500k front. Batched: one
        # create_batch for the tick's CRs, one operator sweep for their
        # sizecars (sweep ≡ N reconciles, fuzz-pinned in
        # tests/test_operator_sweep.py; arrival names are zero-padded
        # ascending, so the sweep's sorted order IS arrival order), one
        # row-batch duration stamp. Admission still runs per arrival, in
        # arrival order — identical fast-path decisions and latency
        # capture. Outcome-identical to the trickle: digests are pinned
        # by tests/fixtures/coldec_off_baseline.json and every smoke.
        with TRACER.span("sim.arrive.create") as cspan:
            # born-frozen children (ISSUE 14): commit-time freeze probes
            # meta and stops instead of re-walking every spec field per
            # CR — the same idiom as the operator's sizecar build
            jobs = [
                fast_new(
                    BridgeJob,
                    meta=fast_new(
                        Meta,
                        name=a.name,
                        uid=new_uid(),
                        labels=(
                            FrozenDict(a.labels)
                            if a.labels
                            else _EMPTY_FROZEN_DICT
                        ),
                        annotations=_EMPTY_FROZEN_DICT,
                        owner="",
                        resource_version=0,
                        deleted=False,
                    ),
                    spec=_freeze_scalar_spec(a.spec),
                    status=frozen_new(
                        BridgeJobStatus,
                        state=JobState.PENDING,
                        reason="",
                        subjobs=_EMPTY_FROZEN_DICT,
                        fetch_result=FetchState.NONE,
                        cluster_endpoint="",
                    ),
                )
                for a in arrivals
            ]
            results = self.store.create_batch(jobs, site="sim.arrive")
            created = [
                a
                for a, r in zip(arrivals, results)
                if not isinstance(r, Exception)
            ]
            cspan.count("jobs", len(created))
        for a in created:
            self.quality.note_arrival(a.name, tick)
        names = [a.name for a in created]
        if names:
            # keys the sweep won't settle (validation failures, finished
            # jobs, conflicts) go through the single-key oracle, exactly
            # like the mirror's event pump
            self.operator.sweep(names, settle=True)
        # the trace's virtual duration rides the demand's time limit —
        # the sim agent runs each job for exactly that long. One batched
        # column write; object stores keep the per-pod replacement.
        with TRACER.span("sim.arrive.stamp") as sspan:
            has_sizecar = self._stamp_durations(created)
            sspan.count("pods", len(has_sizecar))
        if admitter is not None:
            for a in created:
                if a.name not in has_sizecar:
                    continue
                pod_name = f"{a.name}-sizecar"
                # the streaming fast path runs AT arrival (event-driven):
                # eligible interactive work binds here, in wall-clock
                # milliseconds, without waiting for the batch tick
                t0 = time.perf_counter()
                res = self.scheduler.admit(pod_name)
                admit_ms = (time.perf_counter() - t0) * 1e3
                if res.eligible and tick >= warmup:
                    # the latency axis starts after the cold-start
                    # warmup: no window exists before the first solve
                    # and no virtual node is ready before the first
                    # mirror — steady-state latency is the SLO
                    self.quality.note_interactive(a.name)
                    if res.bound:
                        self.quality.note_fastpath_bind(a.name, admit_ms)
                if res.bound:
                    self._fast_bound_tick.append(pod_name)
                    self.quality.note_bound(a.name, tick)
                    self._note(
                        tick, "fastbind", pod_name, ",".join(res.hint)
                    )
        return len(arrivals)

    def _stamp_durations(self, created: list) -> set[str]:
        """Write each arrival's virtual duration into its sizecar's
        demand (``time_limit_s``) — the batched form of the per-pod
        ``replace_update`` stamp. Returns the arrival names whose
        sizecar existed (what the admission loop may admit)."""
        from slurm_bridge_tpu_torch.bridge.freeze import fast_replace, frozen_replace

        table = self.store.table(Pod.KIND)
        has_sizecar: set[str] = set()
        if table is None:
            for a in created:
                pod = self.store.try_get(Pod.KIND, f"{a.name}-sizecar")
                if pod is None:
                    continue
                has_sizecar.add(a.name)
                if pod.spec.demand is None:
                    continue

                def stamp(p: Pod, dur=a.duration_s):
                    return fast_replace(
                        p,
                        meta=fast_replace(p.meta),
                        spec=fast_replace(
                            p.spec,
                            demand=fast_replace(
                                p.spec.demand,
                                time_limit_s=max(1, int(round(dur))),
                            ),
                        ),
                    )

                self.store.replace_update(
                    Pod.KIND, pod.name, stamp, site="sim.arrive"
                )
            return has_sizecar
        c = table.cols
        pod_names: list[str] = []
        expected: list[int] = []
        new_demands: list[object] = []
        stamped_arrivals: list[str] = []
        with self.store.locked():
            rows = table.rows_for([f"{a.name}-sizecar" for a in created])
            for a, row in zip(created, rows.tolist()):
                if row < 0:
                    continue
                has_sizecar.add(a.name)
                demand = c.demand[row]
                if demand is None:
                    continue
                pod_names.append(f"{a.name}-sizecar")
                expected.append(int(c.rv[row]))
                new_demands.append(
                    frozen_replace(
                        demand, time_limit_s=max(1, int(round(a.duration_s)))
                    )
                )
                stamped_arrivals.append(a.name)
        if not pod_names:
            return has_sizecar
        demand_col = np.empty(len(new_demands), object)
        demand_col[:] = new_demands

        def writer(rws, sel):
            c.demand[rws] = demand_col[sel]

        results = self.store.update_rows(
            Pod.KIND,
            pod_names,
            np.asarray(expected, np.int64),
            writer,
            site="sim.arrive",
        )
        for name, dem, rc in zip(stamped_arrivals, new_demands, results.tolist()):
            if rc > 0:
                continue
            # conflict/vanished: the per-pod oracle (same thread, so this
            # is belt-and-braces, not a hot path)
            def stamp(p: Pod, d=dem):
                return fast_replace(
                    p,
                    meta=fast_replace(p.meta),
                    spec=fast_replace(p.spec, demand=d),
                )

            try:
                self.store.replace_update(
                    Pod.KIND, f"{name}-sizecar", stamp, site="sim.arrive"
                )
            except Exception:
                pass
        return has_sizecar

    def _mirror(self) -> None:
        """Partition diff + provider sync + event-driven operator sync —
        the production mirror half of the reconcile loop.

        ISSUE 16 shape: the providers run in shard-ownership GROUPS
        (``shard_mirror`` — each group is one shard's contiguous run of
        the sorted partition list, see ``ShardExecutor.mirror_groups``),
        and within a group each provider's status fetch overlaps the
        next provider's classification on an overlap thread
        (``mirror_pipeline``). Store writes all stay on this thread in
        provider order, the flattened group order IS the sorted order,
        and the owner sweep stays global — so both knobs are
        digest-neutral; with sharding off there is exactly one group
        and the flags-off path is the original sequential mirror,
        byte-for-byte."""
        with TRACER.span("sim.mirror"):
            try:
                self.configurator.reconcile()
            except RpcError:
                self._rpc_fail("configurator.reconcile")
            partitions = sorted(self.configurator.providers)
            if (
                self.scenario.shard_mirror
                and self.scheduler.shard is not None
            ):
                groups = self.scheduler.shard.mirror_groups(partitions)
            else:
                groups = [partitions] if partitions else []
            pipelined = (
                self.scenario.mirror_pipeline
                and not self.scenario.faults.faults
            )
            # writer-partition stamping (ISSUE 19): when the mirror runs
            # in shard-ownership groups AND frames are on, each group's
            # providers record their dirty names under the group index —
            # mirror_groups IS the writer-partition map. Frames off
            # leaves the stamp at None so the dirty-set stays exactly
            # the PR-18 global per-kind dict.
            stamp_parts = (
                self.scenario.mirror_frames and len(groups) > 1
            )
            for gidx, group in enumerate(groups):
                for partition in group:
                    self.configurator.providers[partition]._dirty_partition = (
                        gidx if stamp_parts else None
                    )
                if pipelined:
                    self._sync_group_pipelined(group)
                else:
                    for partition in group:
                        provider = self.configurator.providers[partition]
                        try:
                            provider.sync()
                        except RpcError:
                            self._rpc_fail(f"provider.sync:{partition}")
            # drain the pod watch queue and sweep owners of changed
            # pods in batch — exactly what the operator's _pump_events
            # thread does, made synchronous (and therefore
            # deterministic); keys the sweep can't settle go through
            # the single-key oracle, like the pump's controller queue
            # would. ONE global sweep after every group: the sweep's
            # owner iteration (and therefore its uid draw order) must
            # match the global pass byte-for-byte, and a per-group
            # sweep would interleave differently whenever owner names
            # straddle shards
            owners: set[str] = set()
            while True:
                try:
                    ev = self._pod_watch.get_nowait()
                except Exception:
                    break
                self.operator._collect_owner(ev, owners)
            if owners:
                self.operator.sweep(owners, settle=True)

    def _sync_group_pipelined(self, group: list[str]) -> None:
        """One mirror group with the status fetch overlapped: provider
        i's chunked JobsInfo round-trips run on the overlap thread while
        provider i+1's prepare (classification + converge + submits)
        runs here. ``sync_staged``'s contract keeps every store write on
        this thread, applies in provider order — the pipeline moves only
        wire-and-decode wait off the critical path. A provider that
        cannot stage (bulk fallback engaged, no bytes twin) drains the
        in-flight fetch first and takes the plain path."""
        pool = self._mirror_fetch_pool()
        parent = TRACER.current()
        pending: tuple[str, object, object] | None = None

        def drain() -> None:
            nonlocal pending
            if pending is None:
                return
            part, apply_fn, fut = pending
            pending = None
            try:
                with TRACER.span("sim.mirror.fetch_wait"):
                    fetched = fut.result()
                apply_fn(fetched)
            except RpcError:
                self._rpc_fail(f"provider.sync:{part}")

        for partition in group:
            provider = self.configurator.providers[partition]
            try:
                staged = provider.sync_staged()
            except RpcError:
                self._rpc_fail(f"provider.sync:{partition}")
                continue
            if staged is None:
                drain()
                try:
                    provider.sync()
                except RpcError:
                    self._rpc_fail(f"provider.sync:{partition}")
                continue
            fetch, apply_fn = staged
            drain()

            def traced_fetch(f=fetch):
                with with_current_span(parent):
                    return f()

            pending = (partition, apply_fn, pool.submit(traced_fetch))
        drain()

    def _mirror_fetch_pool(self):
        """The single overlap thread for the pipelined mirror (lazy —
        non-pipelined runs never start it; torn down with the stack)."""
        if self._mirror_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._mirror_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sbt-mirror-fetch"
            )
        return self._mirror_pool

    def _free_now(self) -> dict[str, tuple[float, float, float]]:
        out = {}
        for name, node in self.cluster.nodes.items():
            info = node.info()
            free = (
                (float(info.free_cpus), float(info.free_memory_mb), float(info.free_gpus))
                if info.schedulable
                else (0.0, 0.0, 0.0)
            )
            out[name] = free
        return out

    def run_tick(self, tick: int, *, arrivals: bool = True) -> dict[str, float]:
        with self.flight.tick(tick):
            phases = self._run_tick(tick, arrivals=arrivals)
        # pressure ledger (ISSUE 15 sink 2): the solve tick's reason ×
        # partition × class × tenant counts ride the per-tick flight
        # record and the quality scorecard's wait_reasons axis
        ledger = getattr(self.scheduler, "last_explain_ledger", None)
        if ledger is not None:
            self._explain_ledgers.append((tick, ledger))
            self.quality.note_pressure(ledger)
            if self.flight.records:
                self.flight.records[-1]["pressure"] = ledger
        return phases

    def _run_tick(self, tick: int, *, arrivals: bool = True) -> dict[str, float]:
        cpu0 = time.process_time()
        rpc0 = sum(self.agent_client.calls.values())
        ji0 = self.agent_client.calls.get("JobsInfo", 0)
        restarts0 = self._restarts + self._agent_restarts
        fault_boundary = any(
            f.start_tick == tick or f.end_tick == tick
            for f in self.scenario.faults.faults
        )
        if self.faulty is not None:
            self.faulty.set_tick(tick)
        self._agent_faults(tick)
        self._bridge_faults(tick)
        self._apply_fault_boundaries(tick)
        if self.fleet is not None:
            # kill BEFORE the heartbeat so death + re-key land in the
            # same tick deterministically (kill_replica is synchronous)
            for f in self.scenario.faults.starting("kill_replica", tick):
                rid = f.replica or self.fleet.membership.owner_of(0) or ""
                self.fleet.kill_replica(rid)
            self.fleet.heartbeat(tick)
        if self.scheduler.explain_trail is not None:
            self.scheduler.explain_trail.tick = tick
        # store/scheduler may have been replaced by a bridge fault above —
        # snapshot the write/solve baselines on the objects this tick runs
        commits0 = sum(self.store.commit_counts_snapshot().values())
        solves0 = self.scheduler.solves_total

        # the phase clock is the spans' own: arrive's span, and the spans
        # the scheduler tick and the mirror close on this thread, tallied
        self._fast_bound_tick = []
        with TRACER.span("sim.arrive") as arrive_span:
            n_arrived = self._arrive(tick) if arrivals else 0
            arrive_span.count("arrivals", n_arrived)
            arrive_span.count("fastpath_bound", len(self._fast_bound_tick))
        arrive_ms = arrive_span.duration * 1e3
        self._arrive_ms.append(arrive_ms)

        stale = bool(self.scenario.faults.active("stale_snapshot", tick))
        # sim.verify spans: the harness's OWN bookkeeping (ground-truth
        # snapshots, invariant checks, digest notes) — named so the
        # flight record's phase sum reconciles with the tick span at the
        # 500k shape instead of leaving seconds of root self-time blank
        with TRACER.span("sim.verify"):
            free_before = None if stale else self._free_now()
            pods_before = self.store.list(Pod.KIND)
            pre = {
                p.name: (p.spec.placement_hint, p.spec.demand)
                for p in pods_before
                if p.spec.role == PodRole.SIZECAR and p.spec.node_name
            }
            pending_before = self._pending_names(pods_before)

        with TRACER.tally() as sched:
            if self._stack_up:
                try:
                    self.scheduler.tick()
                except RpcError:
                    self._rpc_fail("scheduler.tick")
        sched_ms = sched.get("scheduler.tick", 0.0)
        phases = dict(self.scheduler.last_phase_ms) if self._stack_up else {}
        # arrival ingest is a first-class tick phase since ISSUE 14 — it
        # was real per-tick work the headline silently excluded
        phases["arrive"] = arrive_ms

        with TRACER.tally() as mirror:
            if self._stack_up:
                self._mirror()
        phases["mirror"] = mirror.get("sim.mirror", 0.0)
        # anything tick() spent outside its own phase decomposition
        # (RPC-fault aborts, remote skips, future costs) gets its own
        # explicit bucket instead of silently inflating "store"
        accounted = sum(phases.get(k, 0.0) for k in ("store", "encode", "solve", "bind"))
        phases["other"] = max(0.0, sched_ms - accounted)

        # parts of the phases above, outside PHASES' sum: the store's
        # pending scan and inventory, the first part of "other", the
        # solve's repair and host syncs, and the tick thread's share of
        # the mirror (submits, status reads and fetch waits, the sweep
        # with the reconciles it settles)
        phases["store.pending"] = sched.get("scheduler.store.pending", 0.0)
        phases["store.inventory"] = sched.get("scheduler.store.inventory", 0.0)
        phases["prepare"] = sched.get("scheduler.prepare", 0.0)
        phases["solve.repair"] = sched.get("solve.repair", 0.0)
        phases["solve.host_syncs"] = (
            float(self.scheduler.last_host_syncs) if self._stack_up else 0.0
        )
        phases["mirror.submit"] = mirror.get("vnode.submit_chunk", 0.0)
        phases["mirror.status"] = mirror.get("vnode.status", 0.0) + mirror.get(
            "sim.mirror.fetch_wait", 0.0
        )
        phases["mirror.sweep"] = mirror.get("operator.sweep", 0.0)

        with TRACER.span("sim.verify"):
            self.cluster.step()
            self.quality.sample(self.cluster)

            pods = self.store.list(Pod.KIND)
            by_name = {p.name: p for p in pods}
            newly_bound = [
                p for p in pods if p.name in pending_before and p.spec.node_name
            ]
            preempted = [
                name
                for name in pre
                if (cur := by_name.get(name)) is not None
                and not cur.spec.node_name
                and cur.status.reason.startswith("Preempted")
            ]
            released: dict[str, list[float]] = {}
            for name in preempted:
                hints, demand = pre[name]
                if demand is None:
                    continue
                cpu, mem, gpu = per_node_demand(demand)
                for node in hints:
                    u = released.setdefault(node, [0.0, 0.0, 0.0])
                    u[0] += cpu
                    u[1] += mem
                    u[2] += gpu
            # fast-path binds: bound during the arrive phase, so invisible to
            # the pending_before diff — still bound work this tick (counted,
            # and capacity-checked below alongside the batch binds; their
            # quality/digest notes were taken at admit time)
            fast_pods = [
                p
                for n in self._fast_bound_tick
                if (p := by_name.get(n)) is not None and p.spec.node_name
            ]
            self._bound_total += len(newly_bound) + len(fast_pods)
            self._preempted_total += len(preempted)
            for p in newly_bound:
                self.quality.note_bound(p.meta.owner or p.name, tick)
            self.quality.note_preempts(len(preempted))
            for p in sorted(newly_bound, key=lambda p: p.name):
                self._note(tick, "bind", p.name, p.spec.node_name,
                           ",".join(p.spec.placement_hint))
            for name in sorted(preempted):
                self._note(tick, "preempt", name)

            self.violations.extend(
                check_tick(
                    tick,
                    pods,
                    self.cluster,
                    newly_bound=newly_bound + fast_pods,
                    free_before=free_before,
                    released={k: tuple(v) for k, v in released.items()},
                )
            )
            pending_after = len(self._pending_names(pods))
            self._pending_by_tick.append(pending_after)
            self._note(tick, "pending", pending_after, "arrived", n_arrived)
            fault_end = self.scenario.faults.last_end_tick
            if (
                self._recovered_at is None
                and fault_end
                and tick >= fault_end
                and pending_after == 0
                and not self.cluster.pending_jobs()
            ):
                self._recovered_at = tick
            if (
                self._drained_at is None
                and pending_after == 0
                and not self.cluster.pending_jobs()
                and tick >= self.scenario.ticks - 1
            ):
                self._drained_at = tick

        self._drain_node_watch()
        if self.persistence is not None and self._stack_up:
            # tick-boundary durability: everything the control loops
            # committed this tick is WAL-appended before virtual time
            # moves — the state a crash at the NEXT boundary recovers.
            # Timed separately from the phase clock (``wal_flush_ms``):
            # this is where injected fsync latency lands, and folding it
            # into a phase would break the flight-record reconciliation
            t3 = time.perf_counter()
            self.persistence.flush()
            if (tick + 1) % self._COMPACT_EVERY == 0:
                self.persistence.compact()
            self._wal_flush_ms.append((time.perf_counter() - t3) * 1e3)

        tick_ms = sum(phases.get(k, 0.0) for k in PHASES)
        phases["tick"] = tick_ms
        # ---- steady-state verdict (PR-11) ----
        # A tick is STEADY when nothing arrived, bound or was preempted,
        # no fault window opened or closed, no stack restarted, and —
        # the hard part — the whole control plane performed ZERO store
        # commits. steady_tick_p50_ms over these ticks is the O(changes)
        # acceptance number; the bench-smoke gate additionally pins the
        # RPC and solver-invocation budgets per steady tick.
        commits = sum(self.store.commit_counts_snapshot().values()) - commits0
        self._tick_meta.append({
            "tick": tick,
            "arrived": n_arrived,
            "bound": len(newly_bound),
            "preempted": len(preempted),
            "commits": commits,
            "rpc_calls": sum(self.agent_client.calls.values()) - rpc0,
            "jobsinfo_calls": self.agent_client.calls.get("JobsInfo", 0) - ji0,
            "solves": self.scheduler.solves_total - solves0,
            "steady": (
                tick > 0
                and self._stack_up
                and n_arrived == 0
                and not newly_bound
                and not preempted
                and commits == 0
                and not fault_boundary
                and self._restarts + self._agent_restarts == restarts0
            ),
            "tick_ms": tick_ms,
        })
        # CPU seconds actually burned this tick (whole run_tick, including
        # the arrive/invariant bookkeeping outside the phase clock):
        # divergence between this and wall time is noisy-neighbor steal,
        # which otherwise masquerades as a perf regression in diagnostics
        phases["cpu"] = (time.process_time() - cpu0) * 1e3
        _tick_seconds.observe(tick_ms / 1e3)
        self._tick_phases.append(phases)
        self.vt += self.scenario.tick_interval_s
        return phases

    def _final_state_digest(self) -> str:
        """SHA-256 over the run's FINAL logical state — bindings,
        placements, lifecycle outcomes — on both sides of the wire
        (bridge store AND sim ground truth). This is the recovery
        acceptance digest: a crash-restart run must end byte-identical
        to the fault-free run at the same seed. Volatile fields (rvs,
        heartbeats, run_time ticks, free-text reasons) are excluded —
        they carry process history, not cluster state."""
        pods = [
            (
                p.name,
                p.spec.node_name,
                p.status.phase,
                list(p.status.job_ids),
                list(p.spec.placement_hint),
                p.meta.owner,
                bool(p.meta.deleted),
            )
            for p in self.store.list(Pod.KIND)
        ]
        jobs = [
            (
                j.name,
                j.status.state,
                [
                    (k, int(s.state), s.exit_code)
                    for k, s in sorted(j.status.subjobs.items())
                ],
            )
            for j in self.store.list(BridgeJob.KIND)
        ]
        nodes = sorted(n.name for n in self.store.list(VirtualNode.KIND))
        sim = sorted(
            (int(jid), int(j.state), sorted(j.assigned))
            for jid, j in self.cluster.jobs.items()
        )
        payload = json.dumps(
            {"pods": pods, "jobs": jobs, "nodes": nodes, "sim": sim},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def _final_outcome_digest(self) -> str:
        """SHA-256 over the run's final LIFECYCLE outcomes — the
        id/placement-insensitive sibling of :meth:`_final_state_digest`.

        Composed chaos (a crash inside an ``rpc_error`` window) can
        legitimately delay a submission past the window: the job then
        draws a later Slurm id and possibly different nodes than the
        crash-free twin, so byte-identical *state* is unachievable even
        though nothing was lost. What MUST still hold — and what this
        digest captures — is that every pod reaches the same phase with
        a job behind it, every CR ends in the same state with the same
        subjob-state multiset, every sim-side job (by name) reaches the
        same terminal state, and the node set matches. Numeric job ids,
        node assignments and volatile fields are excluded by design."""
        pods = sorted(
            (
                p.name,
                p.status.phase,
                p.meta.owner,
                bool(p.meta.deleted),
                bool(p.status.job_ids),
            )
            for p in self.store.list(Pod.KIND)
        )
        jobs = sorted(
            (
                j.name,
                j.status.state,
                sorted(int(s.state) for s in j.status.subjobs.values()),
            )
            for j in self.store.list(BridgeJob.KIND)
        )
        nodes = sorted(n.name for n in self.store.list(VirtualNode.KIND))
        sim = sorted(
            (j.name, int(j.state)) for j in self.cluster.jobs.values()
        )
        payload = json.dumps(
            {"pods": pods, "jobs": jobs, "nodes": nodes, "sim": sim},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def _cleanup(self) -> None:
        if self.fleet is not None:
            # before the rmtree below: sidecars hold sockets + the
            # membership WAL inside the state dir
            self.fleet.close()
            self.fleet = None
        if self.agent_journal is not None:
            self.agent_journal.close()
        if self._mirror_pool is not None:
            self._mirror_pool.shutdown(wait=False)
            self._mirror_pool = None
        if self._state_dir is not None:
            shutil.rmtree(self._state_dir, ignore_errors=True)
            self._state_dir = None
        # reap the process-wide colpool workers (ISSUE 18): run() is
        # finally-guarded, so a scenario raising MID-TICK still joins the
        # forked workers and closes their pipe fds instead of leaking
        # them until atexit; the next run lazily re-forks. close() is
        # idempotent/lock-free, so racing atexit or a nested reset is
        # safe. (Deliberately NOT in _teardown_stack — the crash-fault
        # path restarts the bridge stack, not the process, and keeps its
        # warm workers.)
        colpool.reset()
        colpool.set_obs(True)  # restore the process default obs arm

    # ---- the full run ----

    def _progress(self, tick: int, phases: dict[str, float]) -> None:
        if not self.scenario.slow:
            return
        import sys

        print(
            f"# tick {tick}: {phases.get('tick', 0.0):.0f} ms "
            f"(store {phases.get('store', 0.0):.0f} / encode "
            f"{phases.get('encode', 0.0):.0f} / solve "
            f"{phases.get('solve', 0.0):.0f} / bind "
            f"{phases.get('bind', 0.0):.0f} / mirror "
            f"{phases.get('mirror', 0.0):.0f} / other "
            f"{phases.get('other', 0.0):.0f}; cpu "
            f"{phases.get('cpu', 0.0):.0f}), pending "
            f"{self._pending_by_tick[-1] if self._pending_by_tick else 0}",
            file=sys.stderr,
            flush=True,
        )

    def run(self) -> ScenarioResult:
        # finally-guarded so a raising run (invariant failure, store
        # conflict) still reclaims the snapshot+WAL state tempdir
        try:
            return self._run()
        finally:
            self._cleanup()

    def _run(self) -> ScenarioResult:
        sc = self.scenario
        # GC policy (PR-4): a cold-start tick allocates ~100k long-lived
        # store objects while ~600k are already live, and CPython's
        # generational collector re-scans that heap dozens of times per
        # tick — measured at HALF the whole tick at the 50k×10k headline
        # shape. Collection moves BETWEEN ticks: refcounting frees the
        # non-cyclic ~100% in-line (store graphs are trees — ownership is
        # by name, not pointer), and the explicit collect catches any
        # cycle stragglers off the reconcile latency path. gc.freeze()
        # keeps the baseline heap (trace, cluster, JAX) out of scans.
        # Purely a scheduling change for identical work: determinism is
        # untouched, and `make sim-smoke`'s double-run proves it.
        was_enabled = gc.isenabled()
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            tick = 0
            for tick in range(sc.ticks):
                self._progress(tick, self.run_tick(tick))
                _collect_young()
            grace_used = 0
            while (
                grace_used < sc.drain_grace_ticks
                and self._drained_at is None
            ):
                tick += 1
                grace_used += 1
                self._progress(tick, self.run_tick(tick, arrivals=False))
                _collect_young()
        finally:
            gc.unfreeze()
            if was_enabled:
                gc.enable()
        total_ticks = tick + 1
        self._drain_node_watch()

        if sc.expect_drain:
            self.violations.extend(
                check_drain(
                    tick,
                    self._pending_by_tick[-1] if self._pending_by_tick else 0,
                    len(self.cluster.pending_jobs()),
                    expect_drain=True,
                )
            )

        jobs = self.cluster.jobs.values()
        providers = self.configurator.providers.values()
        determinism = {
            "bound_total": self._bound_total,
            # pods submitted through the batched SubmitJobs path vs the
            # per-pod fallback: a silent fallback to the slow path shows
            # up here instead of only as a latency regression
            "submits_batched": sum(p.submits_batched for p in providers),
            "submits_fallback": sum(p.submits_fallback for p in providers),
            "preempted_total": self._preempted_total,
            "preempt_events": self._preempt_events,
            "events": dict(sorted(self._event_counts.items())),
            "sim": self.cluster.stats.as_dict(),
            "pending_final": self._pending_by_tick[-1] if self._pending_by_tick else 0,
            "sim_running_final": sum(
                1 for j in jobs if j.state == JobStatus.RUNNING
            ),
            "sim_pending_final": sum(
                1 for j in jobs if j.state == JobStatus.PENDING
            ),
            "rpc_failures": dict(sorted(self.rpc_failures.items())),
            "injected_errors": dict(
                sorted(self.faulty.injected_errors.items())
            )
            if self.faulty is not None
            else {},
            # bounded-retry healing (PR-8): attempts retried per method —
            # the difference between injected_errors and rpc_failures is
            # exactly what the retry layer absorbed
            "rpc_retries": dict(sorted(self.retrier.retries.items()))
            if self.retrier is not None
            else {},
            "invariant_violations": [v.as_dict() for v in self.violations],
            "recovery_ticks": (
                self._recovered_at - sc.faults.last_end_tick
                if self._recovered_at is not None and sc.faults
                else None
            ),
            "drained_at_tick": self._drained_at,
            "grace_ticks_used": grace_used,
            # crash/failover robustness (PR-7): restart count, node-flap
            # detector, lease history, and the final-state digest the
            # crash scenario compares against its fault-free twin
            "restarts": self._restarts,
            "vnode_deletions": self.vnode_deletions,
            "leader_takeover_ticks": list(self._takeover_ticks),
            "leader_final": (
                self._active_elector.identity
                if self._active_elector is not None
                else ""
            ),
            # composed chaos (PR-8): agent-side crash/reload count, the
            # object/job counts each recovery restored (deterministic —
            # tick-boundary state is), and the outcome digest the
            # composed-fault twin gate compares when id/placement
            # reshuffles make byte-identical state unachievable
            "agent_restarts": self._agent_restarts,
            "restored_objects": list(self._restored_objects),
            "agent_restored_jobs": list(self._agent_restored_jobs),
            "final_state_digest": self._final_state_digest(),
            "final_outcome_digest": self._final_outcome_digest(),
            "digest": self._digest.hexdigest(),
        }
        if self.scheduler.shard is not None:
            # sharded-tick aggregates (plan size, routing, reconcile
            # outcomes, rank-locality) are id-keyed and deterministic —
            # they ride the determinism section so the double-run gate
            # covers the fan-out, and the shard-smoke gate reads them
            determinism["shard"] = self.scheduler.shard.stats()
        if self.scheduler.admission is not None:
            # streaming-admission aggregates (attempts/binds/misses by
            # reason) are decision facts, fully virtual-deterministic —
            # the admission-smoke double-run gate covers the fast path
            determinism["admission"] = self.scheduler.admission.stats()
        if self.fleet is not None:
            # membership facts only (replica count, rekeys, expiries,
            # kills, recovery) — deterministic on virtual time, so they
            # ride the byte-compared section. Transport counters (remote
            # vs inline solves) are OS-scheduling-volatile and ride the
            # quality section instead (policy_extra["fleet_remote"])
            determinism["fleet"] = self.fleet.stats()
        phase_arr = {
            k: np.asarray([p.get(k, 0.0) for p in self._tick_phases])
            for k in (*PHASES, "tick", "cpu")
        }
        timing = {
            "tick_p50_ms": round(float(np.median(phase_arr["tick"])), 3),
            "tick_p95_ms": round(float(np.percentile(phase_arr["tick"], 95)), 3),
            "tick_max_ms": round(float(phase_arr["tick"].max()), 3),
            "tick_cpu_p50_ms": round(float(np.median(phase_arr["cpu"])), 3),
            "phases_p50_ms": {
                k: round(float(np.median(phase_arr[k])), 3) for k in PHASES
            },
            "phases_p95_ms": {
                k: round(float(np.percentile(phase_arr[k], 95)), 3) for k in PHASES
            },
            "arrive_p50_ms": round(float(np.median(self._arrive_ms)), 3),
            # the steady-state headline (PR-11): tick p50 over ticks in
            # which nothing arrived/bound/preempted/faulted and the
            # control plane wrote NOTHING — the cost of observing an
            # unchanged cluster, which the incremental tick drives to
            # O(changes). None = the run never reached a steady tick.
            "steady_tick_p50_ms": (
                round(
                    float(np.median(
                        [m["tick_ms"] for m in self._tick_meta if m["steady"]]
                    )),
                    3,
                )
                if any(m["steady"] for m in self._tick_meta)
                else None
            ),
            "steady_ticks": sum(1 for m in self._tick_meta if m["steady"]),
            # view-materialization pressure (PR-6): frozen views built /
            # commits through the columnar row path over the whole run,
            # so re-anchors can see whether reads are eating the columnar
            # win without re-running the flight recorder
            "decoded_views_total": self.store.view_builds_total(),
            "rows_written_total": self.store.rows_written_total(),
            "injected_latency_ms": round(
                self.faulty.injected_latency_ms, 3
            )
            if self.faulty is not None
            else 0.0,
            # recovery cost (PR-8): wall ms per stack/agent reload —
            # what the slow full_50kx10k_crash scenario proves bounded
            # at the headline shape
            "recovery_ms": [round(v, 3) for v in self._recovery_ms],
            # the tick-boundary WAL flush+compact cost, where injected
            # fsync latency lands (outside the phase clock by design)
            "wal_flush_p50_ms": round(
                float(np.median(self._wal_flush_ms)), 3
            )
            if self._wal_flush_ms
            else 0.0,
            "wal_flush_p95_ms": round(
                float(np.percentile(self._wal_flush_ms, 95)), 3
            )
            if self._wal_flush_ms
            else 0.0,
            # WAL pressure (timing, not determinism: a VirtualNode
            # heartbeat rides wall time, so record counts can wiggle):
            # records appended + snapshots compacted across the run,
            # summed over every bridge incarnation
            "wal_records_total": self._wal_records_prior
            + (
                self.persistence.wal_records_total
                if self.persistence is not None
                else 0
            ),
            "wal_snapshots_total": self._snapshots_prior
            + (
                self.persistence.snapshots_written
                if self.persistence is not None
                else 0
            ),
            # agent journal pressure (PR-8): records appended + fsyncs
            # issued (the group-commit ratio shows up here under the
            # real agent; the sim journal runs fsync-off)
            "agent_journal_records_total": (
                self.agent_journal.records_total
                if self.agent_journal is not None
                else 0
            ),
            "agent_journal_snapshots_total": (
                self.agent_journal.snapshots_written
                if self.agent_journal is not None
                else 0
            ),
        }
        shape = {
            "pods": sum(len(t) for t in self.trace),
            "nodes": sc.cluster.num_nodes,
            "partitions": sc.cluster.num_partitions,
            "ticks": total_ticks,
        }
        policy_extra = {"policy": "off"}
        if self.policy_engine is not None:
            policy_extra = {
                "policy": "on",
                "backfill_binds": self.policy_engine.backfill_binds_total,
                "preempt_pool_last": self.policy_engine.pool_size_last,
                "preempt_pool_excluded_last": (
                    self.policy_engine.pool_excluded_last
                ),
            }
        if self.scheduler.shard is not None:
            # the rank-locality score + reconcile outcomes belong on the
            # quality scorecard: they are placement-quality facts of the
            # sharded tick (ISSUE 10 acceptance)
            policy_extra["shard"] = self.scheduler.shard.stats()
        if self.scheduler.admission is not None:
            # fast-path miss attribution (ISSUE 15 satellite): why
            # eligible arrivals fell through to the batch tick — the
            # admission-side half of the wait_reasons story
            policy_extra["admission_misses"] = dict(
                sorted(self.scheduler.admission.misses.items())
            )
        if self.fleet is not None:
            # volatile transport counters (remote solves vs inline
            # fallbacks depend on OS scheduling of real subprocesses) —
            # quality section only; the fleet smoke asserts
            # remote_solves > 0 here so a silently-inline run fails
            policy_extra["fleet_remote"] = self.fleet.remote_stats()
        flight_record = self.flight.aggregate()
        if self.fleet is not None and self.scenario.fleet_obs:
            # ISSUE 20: lifecycle timeline + federated per-replica
            # counters ride the flight record (volatile, never digested)
            # so scenario JSON and /debug/fleetz read the same story
            flight_record["fleet"] = self.fleet.fleet_section()
        result = ScenarioResult(
            scenario=sc,
            determinism=determinism,
            timing=timing,
            shape=shape,
            quality=self.quality.scorecard(total_ticks, extra=policy_extra),
            flight_record=flight_record,
            flight_ticks=list(self.flight.records),
        )
        return result


def run_scenario(scenario: Scenario, device=None) -> ScenarioResult:
    return SimHarness(scenario, device=device).run()
