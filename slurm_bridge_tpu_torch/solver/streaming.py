"""Streaming reschedule — BASELINE config #5 (50k pods + 1k/s churn).

Every tick is a full re-solve of the *entire* modeled workload — running
jobs included — under one rule: a running ("incumbent") shard may only bid
on the node it already holds (Slurm jobs cannot migrate), while all
capacity is notionally released and re-admitted priority-ordered. Three
behaviors fall out of that one solve with no extra control flow:

- **stability**: with enough capacity, every incumbent re-wins its own node
  (deterministic bids, priority-ordered admission) — placements do not flap
  tick to tick;
- **preemption**: when a higher-priority job contends for a full node, the
  admission prefix cuts off the low-priority incumbent — it simply fails to
  re-admit, which the caller reports as preempted (requeue/kill is the
  control plane's move, mirroring Slurm partition preemption);
- **churn**: arrivals are new free-agent rows, departures are dropped rows;
  there is no incremental bookkeeping to drift, because free capacity is
  recomputed statelessly from the surviving assignment every tick.

On the card the incumbent pin is part of the ``bid_argmax`` kernel's
feasibility test (:mod:`..ops.bid_argmax`): a pinned row scores only the
node it holds. Two engines serve the tick, picked by the production routing
rule (:mod:`routing`): the device auction implements the behaviors above
with contention preemption (a higher-priority newcomer can outbid an
incumbent for its node); the indexed native packer implements Slurm's
stricter preempt-only-when-necessary semantics: incumbents' nodes are
reserved up front and a newcomer may evict strictly-lower-priority
reservations only when it fits nowhere else. Both preserve never-migrate
and gang all-or-nothing.

``StreamingSim`` is the tick driver; ``streaming_place`` is the functional
core. Both mirror their namesakes in the JAX package's
``solver/streaming.py`` and take a ``device`` (None is the card, or
``SBT_BACKEND=cpu``; ``"cpu"`` the host — :mod:`..parallel.backend`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from slurm_bridge_tpu_torch.solver.auction import AuctionConfig, auction_place
from slurm_bridge_tpu_torch.solver.snapshot import (
    ClusterSnapshot,
    JobBatch,
    Placement,
    concat_batches,
    pad_batch,
    random_scenario,
)

#: Priority boost that makes incumbents un-preemptable when preemption is off.
_KEEP_BOOST = np.float32(1e6)


@dataclass
class TickResult:
    """One streaming tick's outcome, shard-aligned with the solved batch."""

    placement: Placement
    incumbent: np.ndarray  # [P] bool — was running before this tick
    kept: np.ndarray  # [P] bool — incumbent that re-won its node
    preempted: np.ndarray  # [P] bool — incumbent that lost admission
    started: np.ndarray  # [P] bool — free agent newly placed

    @property
    def stability(self) -> float:
        """Fraction of incumbent shards that kept their node (1.0 = no flap)."""
        n_inc = int(self.incumbent.sum())
        return float(self.kept.sum()) / n_inc if n_inc else 1.0


def _tick_result(placement: Placement, incumbent: np.ndarray) -> TickResult:
    inc_mask = incumbent >= 0
    kept = inc_mask & placement.placed & (placement.node_of == incumbent)
    return TickResult(
        placement=placement,
        incumbent=inc_mask,
        kept=kept,
        preempted=inc_mask & ~kept,
        started=~inc_mask & placement.placed,
    )


def streaming_place(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    incumbent: np.ndarray,
    config: AuctionConfig | None = None,
    *,
    preemption: bool = True,
    sharded: bool = False,
    bucket: int = 4096,
    session=None,
    engine: str = "device",
    device=None,
) -> TickResult:
    """Re-solve one tick with incumbents pinned to their nodes.

    ``snapshot.free`` must be capacity with ALL modeled usage released
    (external/unmodeled allocations already subtracted); incumbents re-admit
    against the pending queue inside the solve. With ``preemption=False``
    incumbents get a priority boost that puts them ahead of any newcomer in
    the admission order, so they can only lose their node to capacity loss
    (e.g. a drained node), never to contention.

    ``bucket`` pads the shard axis to a fixed-size grid, as the JAX package
    does to keep its compiled shapes few; the pad rows belong to no
    partition and never place, so the padding changes no placement.

    ``engine="native"`` runs the tick on the indexed native packer instead
    of the device auction — same pin/release/preemption semantics,
    greedy-parity placement, no padding. ``session`` (a
    :class:`~slurm_bridge_tpu_torch.solver.session.DeviceSolver`) keeps the
    snapshot staged across ticks and solves on its own device and config;
    without one the auction runs on ``device``. ``sharded=True`` solves
    with the multi-device sweep (:mod:`sharded`) over every device the
    process solves on, whatever the engine.
    """
    inc_mask = incumbent >= 0
    solve_batch = batch
    if not preemption and inc_mask.any():
        solve_batch = dataclasses.replace(
            batch,
            priority=np.where(inc_mask, batch.priority + _KEEP_BOOST, batch.priority),
        )
    p_real = solve_batch.num_shards
    if engine == "native" and not sharded:
        from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native
        from slurm_bridge_tpu_torch.solver.routing import native_fit_policy

        placement = indexed_place_native(
            snapshot,
            solve_batch,
            incumbent=incumbent,
            policy=native_fit_policy(bool(inc_mask.any())),
        )
        return _tick_result(placement, incumbent)
    solve_inc = incumbent
    if bucket:
        solve_batch = pad_batch(solve_batch, bucket)
        pad = solve_batch.num_shards - p_real
        if pad:
            solve_inc = np.concatenate([incumbent, np.full(pad, -1, np.int32)])
    if sharded:
        from slurm_bridge_tpu_torch.solver.sharded import sharded_place

        placement = sharded_place(
            snapshot, solve_batch, config, incumbent=solve_inc, device=device
        )
    elif session is not None:
        # the device-resident path (the production scheduler's): the
        # snapshot stays staged across ticks; only changed tiers re-upload.
        # The session's OWN config governs this branch — callers owning a
        # session (StreamingSim) rebuild it when their config changes.
        session.update_snapshot(snapshot)
        placement = session.solve(solve_batch, incumbent=solve_inc)
    else:
        placement = auction_place(
            snapshot, solve_batch, config, incumbent=solve_inc, device=device
        )
    if solve_batch.num_shards != p_real:
        placement = Placement(
            node_of=placement.node_of[:p_real],
            placed=placement.placed[:p_real],
            free_after=placement.free_after,
        )
    return _tick_result(placement, incumbent)


@dataclass
class StreamingSim:
    """Persistent-workload tick driver over dense shard rows.

    Rows (one per placement shard) carry persistent job identity in
    ``job_of``; ``assign`` holds the node each shard currently runs on
    (-1 = pending). ``snapshot.free`` is treated as the *external* free
    capacity — usage by jobs outside the model — and is passed to every
    solve unchanged, since each tick releases and re-admits all modeled
    work.
    """

    snapshot: ClusterSnapshot
    batch: JobBatch
    config: AuctionConfig | None = None
    preemption: bool = True
    sharded: bool = False
    #: "auto" = the production routing rule per tick (:mod:`routing` —
    #: native packer on CPU-only backends / small, gang- or
    #: incumbent-dominated ticks, the device auction otherwise);
    #: "native"/"device" pin an engine.
    engine: str = "auto"
    #: where the device auction runs: None is the card (or
    #: SBT_BACKEND=cpu), "cpu" the host
    device: object = None
    #: which engine the last tick ran ("device", "native" or "sharded")
    last_engine: str = field(init=False, default="")
    assign: np.ndarray = field(init=False)
    _next_job: int = field(init=False)
    #: lazily-created DeviceSolver so the snapshot stays staged across
    #: ticks (the production scheduler's pattern); unused when sharded
    _session: object = field(init=False, default=None)

    def __post_init__(self):
        self.assign = np.full(self.batch.num_shards, -1, np.int32)
        self._next_job = int(self.batch.job_of.max()) + 1 if self.batch.num_shards else 0

    # ---- churn ----

    def depart(self, job_ids: np.ndarray) -> int:
        """Remove all shards of the given jobs (completed/cancelled)."""
        gone = np.isin(self.batch.job_of, job_ids)
        keep = ~gone
        self.batch = self.batch.select(keep)
        self.assign = self.assign[keep]
        return int(gone.sum())

    def arrive(self, new: JobBatch) -> np.ndarray:
        """Append new pending jobs; returns their (re-keyed) job ids."""
        if new.num_shards == 0:
            return np.zeros(0, np.int64)
        # re-key incoming job/gang ids into this sim's persistent id space
        uniq, inverse = np.unique(new.job_of, return_inverse=True)
        fresh = self._next_job + np.arange(uniq.size)
        self._next_job += uniq.size
        job_of = fresh[inverse].astype(np.int32)
        rekeyed = JobBatch(
            demand=new.demand,
            partition_of=new.partition_of,
            req_features=new.req_features,
            priority=new.priority,
            gang_id=job_of,  # re-keyed per job
            job_of=job_of,
        )
        self.batch = concat_batches([self.batch, rekeyed])
        self.assign = np.concatenate(
            [self.assign, np.full(new.num_shards, -1, np.int32)]
        )
        return fresh

    def running_jobs(self) -> np.ndarray:
        return np.unique(self.batch.job_of[self.assign >= 0])

    # ---- solve ----

    def tick(self) -> TickResult:
        engine = self.engine
        if engine == "auto":
            from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
            from slurm_bridge_tpu_torch.solver.routing import (
                choose_path,
                gang_shard_fraction,
                incumbent_fraction,
            )

            route = choose_path(
                self.batch.num_shards,
                self.snapshot.num_nodes,
                backend_name=ensure_backend(self.device),
                gang_fraction=gang_shard_fraction(self.batch.gang_id),
                inc_fraction=incumbent_fraction(self.assign),
            )
            engine = "native" if route == "native" and not self.sharded else "device"
        if engine != "native" and not self.sharded:
            from slurm_bridge_tpu_torch.solver.session import DeviceSolver

            # (re)build the session when absent OR when sim.config changed
            # since it was built — the session path would otherwise solve
            # with a stale config forever (AuctionConfig is frozen, so
            # equality is the right staleness check)
            want = self.config or AuctionConfig()
            if self._session is None or self._session.config != want:
                self._session = DeviceSolver(self.snapshot, want, device=self.device)
        self.last_engine = "sharded" if self.sharded else engine
        result = streaming_place(
            self.snapshot,
            self.batch,
            self.assign,
            self.config,
            preemption=self.preemption,
            sharded=self.sharded,
            session=self._session if engine != "native" else None,
            engine=engine,
            device=self.device,
        )
        self.assign = np.where(
            result.placement.placed, result.placement.node_of, -1
        ).astype(np.int32)
        return result


def churn_scenario(
    num_nodes: int = 10_000,
    num_jobs: int = 50_000,
    *,
    seed: int = 0,
    load: float = 0.7,
    gpu_fraction: float = 0.1,
    gang_fraction: float = 0.05,
    device=None,
) -> StreamingSim:
    """BASELINE config #5 starting state: 50k pods against 10k nodes."""
    snap, batch = random_scenario(
        num_nodes,
        num_jobs,
        seed=seed,
        load=load,
        gpu_fraction=gpu_fraction,
        gang_fraction=gang_fraction,
    )
    return StreamingSim(snapshot=snap, batch=batch, device=device)


def churn_step(
    sim: StreamingSim, rng: np.random.Generator, churn_jobs: int
) -> TickResult:
    """One churn tick: ``churn_jobs`` random running jobs depart, the same
    number of fresh jobs arrive, then the assignment is re-solved."""
    running = sim.running_jobs()
    if running.size:
        departing = rng.choice(
            running, size=min(churn_jobs, running.size), replace=False
        )
        sim.depart(departing)
    _, fresh = random_scenario(
        sim.snapshot.num_nodes,
        churn_jobs,
        seed=int(rng.integers(2**31)),
        num_partitions=len(sim.snapshot.partition_codes),
        gpu_fraction=0.1,
        load=0.02,
    )
    sim.arrive(fresh)
    return sim.tick()
