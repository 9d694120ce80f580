"""Composable fault injection for the simulator.

A :class:`FaultPlan` is a set of :class:`Fault` windows over the tick
axis. Two delivery mechanisms:

- **RPC-level** faults ride a :class:`FaultyClient` wrapper around the
  :class:`SimWorkloadClient`: injected gRPC errors (raised as
  :class:`SimRpcError`, the port's ``RpcError``, so every production
  error path runs), recorded virtual latency, stale snapshots (inventory
  RPCs frozen at window entry) and lost status updates (JobInfo/JobState
  frozen per job) — all seeded, so identical runs inject identically.
- **Cluster-level** faults (node drain/resume churn, partition
  disappearance, preemption storms) are applied by the harness at tick
  boundaries through the :class:`SimCluster` mutators and the arrival
  trace.

Windows are ``[start_tick, end_tick)``; cluster-level faults revert at
``end_tick`` (drained nodes resume, hidden partitions return).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode


class SimRpcError(RpcError):
    """An injected RPC failure carrying the ``code()``/``details()``
    surface the bridge's handlers read (grpc's own subclasses are not
    constructible outside a live call)."""

    def __init__(self, code: StatusCode, details: str = "injected fault"):
        super().__init__(code, details)
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


#: fault kinds delivered via the client wrapper
RPC_KINDS = ("rpc_error", "rpc_latency", "stale_snapshot", "lost_status")
#: fault kinds applied by the harness at tick boundaries
CLUSTER_KINDS = (
    "drain_nodes",
    "partition_vanish",
    "preemption_storm",
    "elastic_resize",
)
#: fault kinds that kill/replace the bridge process itself (PR-7): the
#: harness tears the control plane down at the start tick and recovery
#: rides snapshot+WAL + level-triggered re-convergence
BRIDGE_KINDS = ("crash_restart", "leader_failover")
#: fault kinds that kill/replace the AGENT process (PR-8): the harness
#: drops the fake agent's process state (jobs, ledger, queue, per-node
#: allocation) and rebuilds it from the agent job-state journal
AGENT_KINDS = ("agent_crash",)
#: fault kinds that kill a FLEET replica's sidecar process (ISSUE 17):
#: the harness SIGKILLs the named replica at the start tick; its
#: shard-set re-keys to survivors on the next membership heartbeat and
#: the restart-with-backoff path re-adopts it
FLEET_KINDS = ("kill_replica",)
#: every kind any delivery mechanism understands — plan validation warns
#: on anything else (a typo'd kind silently tests nothing)
ALL_KINDS = RPC_KINDS + CLUSTER_KINDS + BRIDGE_KINDS + AGENT_KINDS + FLEET_KINDS


@dataclass(frozen=True)
class Fault:
    """One fault window. Fields beyond (kind, start, end) are kind-specific:

    - ``rpc_error``: ``methods`` ("" or empty = all), ``rate``, ``code``
    - ``rpc_latency``: ``methods``, ``latency_ms`` (virtual, recorded — the
      simulator never sleeps)
    - ``stale_snapshot``: inventory RPCs serve window-entry state
    - ``lost_status``: JobInfo/JobState serve each job's window-entry state
    - ``drain_nodes``: ``nodes`` explicit names and/or ``node_fraction``
      drawn deterministically from the plan seed; resumed at ``end_tick``
    - ``partition_vanish``: ``partition`` hidden for the window
    - ``preemption_storm``: ``jobs`` arrivals at ``priority`` injected at
      ``start_tick`` (requires the scheduler's preemption mode to
      displace); ``gang_size`` > 1 makes each storm job a gang and
      ``storm_class`` stamps a priority-class label (the
      ``priority_inversion`` shape)
    - ``elastic_resize``: at ``start_tick``, ``jobs`` currently-bound
      sim jobs change shard count mid-flight (VirtualFlow semantics,
      arxiv 2009.09523): singles grow to 2 nodes, gangs halve; the job
      is cancelled, its demand rewritten, and it re-places at the new
      shape under a fresh submit generation
    - ``crash_restart``: at ``start_tick`` the whole bridge stack (store,
      operator, configurator, scheduler) dies WITHOUT a final flush and a
      fresh stack reloads from snapshot+WAL; ``end_tick`` should be
      ``start_tick + 1`` so ``recovery_ticks`` counts from the restart
    - ``leader_failover``: the lease-holding bridge steps down
      (``graceful=True``: flush + release; ``False``: silent crash, the
      standby waits out lease expiry) and a standby elector takes over,
      rebuilding the stack from snapshot+WAL with zero node flap
    - ``agent_crash``: at ``start_tick`` the fake agent's PROCESS state
      (jobs, submit ledger, queue, per-node allocation) is dropped and
      rebuilt from the agent job-state journal replay; node hardware
      state and hidden partitions are cluster-side truth and survive.
      Composes with ``crash_restart`` at the same tick for the
      simultaneous bridge+agent crash.

    Windows of different kinds may overlap freely (PR-8 composed chaos):
    a ``crash_restart`` inside an ``rpc_error``/``rpc_latency`` window
    recovers THROUGH the degraded RPC plane, and one inside a
    ``partition_vanish`` window recovers INTO the shrunken inventory
    (the restored VirtualNode of a vanished partition stays in the store,
    unmanaged, until the partition returns and the provider adopts it).
    """

    kind: str
    start_tick: int
    end_tick: int
    methods: tuple[str, ...] = ()
    rate: float = 1.0
    code: str = "UNAVAILABLE"
    latency_ms: float = 0.0
    nodes: tuple[str, ...] = ()
    node_fraction: float = 0.0
    partition: str = ""
    jobs: int = 0
    priority: int = 1000
    graceful: bool = True
    #: preemption_storm: shard count per storm job (1 = singles)
    gang_size: int = 1
    #: preemption_storm: priority-class label stamped on storm jobs
    storm_class: str = ""
    #: preemption_storm: cpus_per_task draw for storm jobs (() = the
    #: PR-2 default (4, 8, 16)); node-sized asks force real preemption
    storm_cpus: tuple[int, ...] = ()
    #: kill_replica: fleet replica id whose sidecar dies ("" = the
    #: owner of shard 0 at the start tick)
    replica: str = ""

    def active(self, tick: int) -> bool:
        return self.start_tick <= tick < self.end_tick

    def matches(self, method: str) -> bool:
        return not self.methods or method in self.methods

    @property
    def status_code(self) -> StatusCode:
        return getattr(StatusCode, self.code)


#: (context, name) pairs already warned about — plan validation is
#: rate-limited to once per process per offending name, so a scenario
#: constructed in a loop (the smoke gate's double-run) warns exactly once
_VALIDATION_WARNED: set[tuple[str, str]] = set()


def _known_rpc_methods() -> frozenset[str]:
    """Every RPC method name the WorkloadManager service actually has —
    derived from the proto descriptor, so the validation can never drift
    from the wire surface."""
    global _KNOWN_RPC_METHODS
    if _KNOWN_RPC_METHODS is None:
        from slurm_bridge_tpu_torch.wire.rpc import service_methods

        _, specs = service_methods("WorkloadManager")
        _KNOWN_RPC_METHODS = frozenset(s.name for s in specs)
    return _KNOWN_RPC_METHODS


_KNOWN_RPC_METHODS: frozenset[str] | None = None

log = logging.getLogger("sbt.sim.faults")


@dataclass(frozen=True)
class FaultPlan:
    faults: tuple[Fault, ...] = ()

    def __post_init__(self) -> None:
        """Validate the plan at construction: a typo'd RPC method in
        ``methods`` (or an unknown ``kind``) silently no-ops — the
        scenario then tests LESS than it claims. Warn once per process
        per offending name (rate-limited: smoke gates construct each
        scenario many times)."""
        for f in self.faults:
            if f.kind not in ALL_KINDS:
                key = ("kind", f.kind)
                if key not in _VALIDATION_WARNED:
                    _VALIDATION_WARNED.add(key)
                    log.warning(
                        "FaultPlan: unknown fault kind %r — no delivery "
                        "mechanism will apply it (known: %s)",
                        f.kind, ", ".join(ALL_KINDS),
                    )
                continue
            if f.kind not in ("rpc_error", "rpc_latency"):
                continue
            for m in f.methods:
                if m in _known_rpc_methods():
                    continue
                key = ("method", m)
                if key not in _VALIDATION_WARNED:
                    _VALIDATION_WARNED.add(key)
                    log.warning(
                        "FaultPlan: %s fault names RPC method %r, which "
                        "matches no WorkloadManager method — the window "
                        "injects nothing for it", f.kind, m,
                    )

    def __bool__(self) -> bool:
        return bool(self.faults)

    def strip(self, kinds: tuple[str, ...]) -> "FaultPlan":
        """The plan with every fault of the given kinds removed — how the
        smoke gate builds a crash-free twin that keeps the REST of the
        chaos (rpc flaps, vanished partitions) intact."""
        return FaultPlan(tuple(f for f in self.faults if f.kind not in kinds))

    def active(self, kind: str, tick: int) -> list[Fault]:
        return [f for f in self.faults if f.kind == kind and f.active(tick)]

    def starting(self, kind: str, tick: int) -> list[Fault]:
        return [f for f in self.faults if f.kind == kind and f.start_tick == tick]

    def ending(self, kind: str, tick: int) -> list[Fault]:
        return [f for f in self.faults if f.kind == kind and f.end_tick == tick]

    @property
    def last_end_tick(self) -> int:
        """Tick by which every fault window has closed (0 = no faults)."""
        return max((f.end_tick for f in self.faults), default=0)

    def describe(self) -> list[dict]:
        out = []
        for f in self.faults:
            d = {"kind": f.kind, "window": [f.start_tick, f.end_tick]}
            if f.kind == "rpc_error":
                d.update(methods=list(f.methods) or ["*"], rate=f.rate, code=f.code)
            elif f.kind == "rpc_latency":
                d.update(methods=list(f.methods) or ["*"], latency_ms=f.latency_ms)
            elif f.kind == "drain_nodes":
                d.update(nodes=len(f.nodes), node_fraction=f.node_fraction)
            elif f.kind == "partition_vanish":
                d.update(partition=f.partition)
            elif f.kind == "preemption_storm":
                d.update(jobs=f.jobs, priority=f.priority)
                if f.gang_size > 1:
                    d.update(gang_size=f.gang_size)
                if f.storm_class:
                    d.update(storm_class=f.storm_class)
                if f.storm_cpus:
                    d.update(storm_cpus=list(f.storm_cpus))
            elif f.kind == "elastic_resize":
                d.update(jobs=f.jobs)
            elif f.kind == "leader_failover":
                d.update(graceful=f.graceful)
            elif f.kind == "kill_replica":
                d.update(replica=f.replica or "shard-0-owner")
            out.append(d)
        return out

    @property
    def composed(self) -> bool:
        """True when windows of different kinds overlap in time — the
        PR-8 chaos-composition shape (crash during a degraded window)."""
        for i, a in enumerate(self.faults):
            for b in self.faults[i + 1 :]:
                if a.kind != b.kind and a.start_tick < b.end_tick and b.start_tick < a.end_tick:
                    return True
        return False


#: inventory RPCs a stale_snapshot window freezes
_SNAPSHOT_METHODS = ("Partitions", "Partition", "Nodes")
#: status RPCs a lost_status window freezes
_STATUS_METHODS = ("JobInfo", "JobState")


class FaultyClient:
    """Client wrapper consulting the plan's RPC-level faults per call.

    The harness advances :attr:`tick` at each tick boundary; injection
    draws come from a dedicated seeded RNG, so runs with identical plans,
    seeds and call sequences inject identically (determinism contract).
    """

    def __init__(self, inner, plan: FaultPlan, *, seed: int = 0):
        import numpy as np

        self._inner = inner
        self._plan = plan
        self._rng = np.random.default_rng(seed)
        self.tick = 0
        self.injected_errors: dict[str, int] = {}
        self.injected_latency_ms = 0.0
        self._stale: dict[tuple, object] = {}
        self._stale_window = False

    def set_tick(self, tick: int) -> None:
        self.tick = tick
        stale_now = bool(self._plan.active("stale_snapshot", tick)) or bool(
            self._plan.active("lost_status", tick)
        )
        if stale_now and not self._stale_window:
            self._stale.clear()  # fresh window: freeze state as of entry
        self._stale_window = stale_now

    def close(self) -> None:
        self._inner.close()

    def _submit_jobs(self, inner_fn, request, timeout):
        """Per-item injection for the batched submit (PR-4).

        A whole-RPC failure must name ``SubmitJobs`` explicitly; every
        other matching fault ("SubmitJob" or empty methods = all) draws
        PER ITEM and turns its victims into ok=false entries — a
        flaky-agent plan written for the unary submit path exercises the
        same failure surface against the batched form, and one injected
        fault no longer takes 2,000 batch-mates down with it.
        """
        from slurm_bridge_tpu_torch.wire import pb

        for f in self._plan.active("rpc_error", self.tick):
            if "SubmitJobs" in f.methods and self._rng.random() < f.rate:
                self.injected_errors["SubmitJobs"] = (
                    self.injected_errors.get("SubmitJobs", 0) + 1
                )
                raise SimRpcError(f.status_code, f"injected {f.code} on SubmitJobs")
        for f in self._plan.active("rpc_latency", self.tick):
            # latency faults naming the batched method explicitly charge
            # once per round-trip (symmetric with the rpc_error handling)
            if "SubmitJobs" in f.methods:
                self.injected_latency_ms += f.latency_ms
        item_faults = [
            f
            for f in self._plan.active("rpc_error", self.tick)
            if f.matches("SubmitJob")
        ]
        latency = [
            f
            for f in self._plan.active("rpc_latency", self.tick)
            if f.matches("SubmitJob")
        ]
        entries: list = [None] * len(request.requests)
        forward: list = []
        fwd_idx: list[int] = []
        for i, req in enumerate(request.requests):
            for f in latency:
                self.injected_latency_ms += f.latency_ms
            hit = None
            for f in item_faults:
                if self._rng.random() < f.rate:
                    hit = f
                    break
            if hit is not None:
                self.injected_errors["SubmitJob"] = (
                    self.injected_errors.get("SubmitJob", 0) + 1
                )
                entries[i] = pb.SubmitJobsEntry(
                    ok=False,
                    error_code=hit.code,
                    error=f"injected {hit.code} on SubmitJob",
                )
                continue
            forward.append(req)
            fwd_idx.append(i)
        if forward:
            resp = inner_fn(
                pb.SubmitJobsRequest(requests=forward), timeout=timeout
            )
            for i, entry in zip(fwd_idx, resp.results):
                entries[i] = entry
        return pb.SubmitJobsResponse(results=entries)

    #: the raw-bytes bulk twins (ISSUE 14) are deliberately MASKED: a
    #: fault window must keep manipulating structured responses (per-job
    #: lost_status freezes, per-item submit injection), and the fault
    #: draw sequence must stay byte-identical to the pre-coldec baseline
    #: — so a faulted provider simply falls back to the pb2 path.
    _MASKED_BYTES_RPCS = ("JobsInfoBytes", "NodesBytes", "SubmitJobsBytes")

    def __getattr__(self, method: str):
        if method in self._MASKED_BYTES_RPCS:
            raise AttributeError(
                f"{method} masked under fault injection (pb2 path only)"
            )
        inner_fn = getattr(self._inner, method)
        if not callable(inner_fn) or method.startswith("_"):
            return inner_fn

        def call(request, timeout=None):
            if method == "SubmitJobs":
                return self._submit_jobs(inner_fn, request, timeout)
            for f in self._plan.active("rpc_error", self.tick):
                if f.matches(method) and self._rng.random() < f.rate:
                    self.injected_errors[method] = (
                        self.injected_errors.get(method, 0) + 1
                    )
                    raise SimRpcError(
                        f.status_code, f"injected {f.code} on {method}"
                    )
            for f in self._plan.active("rpc_latency", self.tick):
                if f.matches(method):
                    self.injected_latency_ms += f.latency_ms
            if method == "JobsInfo" and self._plan.active(
                "lost_status", self.tick
            ):
                # the batched status RPC freezes PER JOB, like JobInfo —
                # freezing the whole response would let new jobs entering
                # the batch thaw every other job's state mid-window
                from slurm_bridge_tpu_torch.wire import pb

                missing = [
                    jid
                    for jid in request.job_ids
                    if ("JobsInfo", jid) not in self._stale
                ]
                if missing:
                    resp = inner_fn(
                        pb.JobsInfoRequest(job_ids=missing), timeout=timeout
                    )
                    for entry in resp.jobs:
                        self._stale[("JobsInfo", entry.job_id)] = entry
                return pb.JobsInfoResponse(
                    jobs=[
                        self._stale[("JobsInfo", jid)]
                        for jid in request.job_ids
                        if ("JobsInfo", jid) in self._stale
                    ]
                )
            freeze = (
                method in _SNAPSHOT_METHODS
                and self._plan.active("stale_snapshot", self.tick)
            ) or (
                method in _STATUS_METHODS
                and self._plan.active("lost_status", self.tick)
            )
            if freeze:
                if method == "Nodes":
                    # key on the NAME SET, not the serialized bytes: the
                    # incremental caller restamps `since_version` every
                    # tick, and a bytes key would mint a fresh freeze
                    # slot per tick — the window would serve live state
                    # and the fault would silently stop testing staleness
                    key = (method, tuple(request.names))
                else:
                    key = (
                        method, request.SerializeToString(deterministic=True)
                    )
                if key not in self._stale:
                    self._stale[key] = inner_fn(request, timeout=timeout)
                return self._stale[key]
            return inner_fn(request, timeout=timeout)

        return call
