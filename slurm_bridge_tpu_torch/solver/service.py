"""PlacementSolver gRPC service — the solver as an out-of-process sidecar.

SURVEY.md §7 item 4 calls for the solver "exposed as a gRPC sidecar"
so the greedy in-process path stays intact. This module is that sidecar:
a servicer lowering ``PlaceRequest`` (jobs + node inventory + partitions)
through :func:`encode_cluster` into the device-resident auction solver
(whose score/choose step is the ``bid_argmax`` kernel on the card) — or
the greedy packer, the indexed native packer, or the multi-device sweep
(``solver="sharded"``, :mod:`sharded`) — and answering with per-job node
assignments.

The servicer needs no transport: :func:`serve_solver` hosts it over gRPC
(``wire/rpc.py`` imports ``grpc`` only there), and an in-process caller
passes a :class:`~slurm_bridge_tpu_torch.wire.rpc.LocalContext`, whose
``abort`` raises the port's ``RpcError``. The device auction runs on the
servicer's ``device`` (None is the card, or ``SBT_BACKEND=cpu``; ``"cpu"``
the host).

Semantics mirror the in-process scheduler tick (bridge/scheduler.py):

- ``PlaceJob.cpus/mem_mb/gpus`` are PER-NODE quantities; ``nodes > 1``
  expands into that many gang shards admitted all-or-nothing.
- ``incumbent_node_names`` marks a streaming incumbent (BASELINE config
  #5): its usage is released back to free capacity, each shard is pinned to
  its named node, and equal-priority newcomers cannot displace it (the
  +0.5 half-step boost — CR priorities are integers, so this flips only
  exact ties). An incumbent absent from the response was preempted.
- unknown partition ⇒ any node; unknown required feature ⇒ unplaceable
  (impossible bit 31, snapshot.py semantics).
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from slurm_bridge_tpu_torch.solver.auction import AuctionConfig
from slurm_bridge_tpu_torch.solver.greedy import greedy_place
from slurm_bridge_tpu_torch.solver.session import DeviceSolver
from slurm_bridge_tpu_torch.solver.snapshot import (
    PAD_PARTITION,
    ClusterSnapshot,
    JobBatch,
    encode_cluster,
)
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.wire import StatusCode, pb
from slurm_bridge_tpu_torch.wire.convert import (
    nodes_from_protos,
    partitions_from_protos,
)

log = logging.getLogger("sbt.solver.service")

_solve_seconds = REGISTRY.histogram(
    "sbt_solver_place_seconds", "PlacementSolver.Place solve wall time"
)
_place_total = REGISTRY.counter(
    "sbt_solver_place_requests_total", "Place RPCs served"
)
_placed_total = REGISTRY.counter(
    "sbt_solver_jobs_placed_total", "jobs placed across all Place RPCs"
)
_zero_demand_total = REGISTRY.counter(
    "sbt_solver_zero_demand_jobs_total",
    "Place jobs arriving with cpus==0 and mem_mb==0 — the signature of a "
    "version-skewed peer still writing the old field numbers (ADVICE r5 "
    "#3); such jobs would otherwise place as zero-cost and oversubscribe",
)
_ZERO_DEMAND_LOG_INTERVAL_S = 60.0
_last_zero_demand_log = [0.0]

SOLVERS = ("auction", "greedy", "sharded", "indexed")

class PlacementSolverServicer:
    """Implements the ``PlacementSolver`` service from workload.proto.

    One DeviceSolver is kept across Place calls so the staged snapshot
    survives ticks against a slowly-changing inventory (session.py). Calls
    are serialized — the solver session is single-threaded by design; gRPC
    worker threads queue on the lock. ``device`` is where the device
    auction runs (None: the card, or ``SBT_BACKEND=cpu``).
    """

    def __init__(
        self,
        config: AuctionConfig | None = None,
        *,
        solver: str = "",
        bucket: int = 1024,
        device=None,
    ):
        if solver and solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        # fail fast on a malformed SBT_ROUTE_FLOOR_CELLS (ADVICE r4): the
        # routing floor is read per auto-routed Place, and validating it
        # only there would surface as UNKNOWN on every RPC instead of a
        # refused startup — mirror PlacementScheduler's ingress check
        from slurm_bridge_tpu_torch.solver.routing import floor_cells

        floor_cells()
        self.config = config or AuctionConfig()
        self.device = device
        self.default_solver = solver
        #: shard-axis bucketing (scheduler.py semantics): the queue is
        #: padded to the bucket, as the JAX package pads it, so the two
        #: packages solve the same padded batch
        self.bucket = bucket
        #: one DeviceSolver per distinct effective config — alternating
        #: clients (tuned + untuned bridges sharing a sidecar) each keep
        #: their staged snapshot
        self._sessions: dict[tuple, DeviceSolver] = {}
        self._lock = threading.Lock()

    # ---- RPCs ----

    def Place(self, request: pb.PlaceRequest, context) -> pb.PlaceResponse:
        # request.solver semantics: "auto" = the full routing rule (indexed
        # packer included — what backend="auto" bridges send); "" = the
        # sidecar's launch default, else device-family auto (auction vs
        # sharded only — an explicitly auction-pinned bridge must keep the
        # auction's quality edge); a named solver = exactly that engine.
        requested = request.solver
        solver = "" if requested == "auto" else (requested or self.default_solver)
        if solver and solver not in SOLVERS:
            context.abort(
                StatusCode.INVALID_ARGUMENT,
                f"unknown solver {solver!r} (want one of {SOLVERS} or 'auto')",
            )
        nodes = nodes_from_protos(request.inventory)
        partitions = partitions_from_protos(request.partitions)
        if not partitions:
            # inventory-only callers: one catch-all partition named "" so
            # jobs with an empty partition match every node
            from slurm_bridge_tpu_torch.core.types import PartitionInfo

            partitions = [PartitionInfo(name="", nodes=tuple(n.name for n in nodes))]
        snapshot = encode_cluster(nodes, partitions)
        batch, incumbent = self._encode(request.jobs, snapshot)
        if not solver:
            solver = self._auto_route(
                snapshot, batch, incumbent,
                allow_indexed=requested == "auto",
            )

        # a request-borne config (the bridge's tuned AuctionConfig) beats
        # the launch-time default — without this the sidecar silently
        # solved with different knobs than the operator set (ADVICE r3)
        cfg = self.config
        if request.HasField("config"):
            from slurm_bridge_tpu_torch.wire.convert import auction_config_from_proto

            # overlay: wire knobs win, launch-time tuning of the non-wire
            # knobs (candidates/dtype/use_pallas) survives
            cfg = auction_config_from_proto(request.config, base=self.config)

        t0 = time.perf_counter()
        with self._lock:
            placement = self._solve(solver, snapshot, batch, incumbent, cfg)
        solve_ms = (time.perf_counter() - t0) * 1e3
        _solve_seconds.observe(solve_ms / 1e3)
        _place_total.inc()

        by_job = placement.by_job(batch)
        assignments = []
        placed = 0
        for j, job in enumerate(request.jobs):
            idxs = by_job.get(j, [])
            if idxs:
                placed += 1
            assignments.append(
                pb.Assignment(
                    job_id=job.id or str(j),
                    node_names=[snapshot.node_names[i] for i in idxs],
                )
            )
        _placed_total.inc(placed)
        return pb.PlaceResponse(
            assignments=assignments,
            placed=placed,
            total=len(request.jobs),
            solve_ms=solve_ms,
            solver=solver,
            # the sidecar's own residual arithmetic, row-major over
            # (node, resource) in request node order — lets the bridge
            # seed its streaming-admission window without recomputing
            free_after=np.asarray(
                placement.free_after, np.float64
            ).ravel().tolist(),
        )

    def SolverInfo(self, request, context) -> pb.SolverInfoResponse:
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

        from slurm_bridge_tpu_torch.parallel.mesh import device_count, solver_mesh

        backend = ensure_backend(self.device)
        devices = device_count(backend)
        mesh = ""
        if devices > 1:
            m = solver_mesh(backend=backend)
            mesh = ",".join(f"{k}={v}" for k, v in m.shape.items())
        return pb.SolverInfoResponse(
            backend=backend, devices=devices, mesh=mesh, solvers=list(SOLVERS)
        )

    def PlaceShard(self, request: pb.PlaceShardRequest, context) -> pb.PlaceShardResponse:
        # the fleet sidecar path: pure columnar solve, no device session —
        # byte-parity with the bridge's in-process engines by construction
        from slurm_bridge_tpu_torch.fleet.columnar import solve_place_shard

        return solve_place_shard(request)

    def Healthz(self, request: pb.HealthzRequest, context) -> pb.HealthzResponse:
        import os

        from slurm_bridge_tpu_torch.fleet.columnar import healthz_response

        return healthz_response(
            "solver", os.environ.get("SBT_INCARNATION", str(os.getpid()))
        )

    # ---- lowering ----

    def _encode(
        self, jobs, snapshot: ClusterSnapshot
    ) -> tuple[JobBatch, np.ndarray]:
        rows_dem: list[tuple[float, float, float]] = []
        rows_part: list[int] = []
        rows_feat: list[int] = []
        rows_prio: list[float] = []
        rows_job: list[int] = []
        rows_inc: list[int] = []
        name_idx = {n: i for i, n in enumerate(snapshot.node_names)}
        zero_demand = 0
        for j, job in enumerate(jobs):
            if not job.cpus and not job.mem_mb:
                # wire-skew ingress guard (ADVICE r5 #3): cpus/mem_mb moved
                # to field numbers 10/11 in round 5; a version-skewed peer
                # still writing the old numbers decodes to all-zero demand
                # here and every job would place as zero-cost. Count and
                # warn LOUDLY instead of silently oversubscribing the
                # cluster (the job still solves — an all-zero row is also
                # a legitimate "any node" request from thin clients).
                zero_demand += 1
            nshards = max(1, int(job.nodes))
            part = snapshot.partition_codes.get(job.partition, -1)
            feat = 0
            for f in job.req_features:
                bit = snapshot.feature_codes.get(f)
                feat |= 1 << (bit if bit is not None else 31)
            pinned = list(job.incumbent_node_names)
            for k in range(nshards):
                dem = (float(job.cpus), float(job.mem_mb), float(job.gpus))
                inc = -1
                this_part = part
                if pinned:
                    node = name_idx.get(pinned[k]) if k < len(pinned) else None
                    if node is not None:
                        inc = node
                        # release the incumbent's usage so everyone re-admits
                        # against total capacity (scheduler.py tick semantics)
                        snapshot.free[node] += np.asarray(dem, np.float32)
                    else:
                        # pinned node vanished from the inventory: drop the
                        # shard from the solve — unpinned it would shadow
                        # healthy nodes' capacity without being bindable
                        this_part = int(PAD_PARTITION)
                        dem = (0.0, 0.0, 0.0)
                rows_dem.append(dem)
                rows_part.append(this_part)
                rows_feat.append(feat)
                # policy effective priorities ride the wire (PR-10): an
                # override replaces the raw CR priority so the bridge's
                # class/fair-share admission order is enforced INSIDE the
                # sidecar solve; the +0.5 incumbent tie-break stacks on
                # top exactly like the in-process path
                base = (
                    float(job.priority_override)
                    if job.has_priority_override
                    else float(job.priority)
                )
                rows_prio.append(base + (0.5 if pinned else 0.0))
                rows_job.append(j)
                rows_inc.append(inc)
        if zero_demand:
            _zero_demand_total.inc(zero_demand)
            now = time.monotonic()
            if now - _last_zero_demand_log[0] >= _ZERO_DEMAND_LOG_INTERVAL_S:
                _last_zero_demand_log[0] = now
                log.warning(
                    "%d/%d Place jobs carry zero cpu AND zero mem demand — "
                    "likely wire version skew (cpus/mem_mb renumbered to "
                    "fields 10/11); upgrade the peer or these jobs place as "
                    "zero-cost (sbt_solver_zero_demand_jobs_total counts)",
                    zero_demand, len(jobs),
                )
        batch = JobBatch(
            demand=np.asarray(rows_dem, dtype=np.float32).reshape(-1, 3),
            partition_of=np.asarray(rows_part, dtype=np.int32),
            req_features=np.asarray(rows_feat, dtype=np.uint32),
            priority=np.asarray(rows_prio, dtype=np.float32),
            gang_id=np.asarray(rows_job, dtype=np.int32),
            job_of=np.asarray(rows_job, dtype=np.int32),
        )
        return batch, np.asarray(rows_inc, dtype=np.int32)

    def _auto_route(
        self, snapshot, batch, incumbent, *, allow_indexed: bool
    ) -> str:
        """The same routing rules the in-process scheduler applies
        (solver/routing.py — one shared module, so the two deployment
        modes cannot drift): with ``allow_indexed`` (the caller sent
        "auto"), small, gang-dominated, or incumbent-dominated batches run
        the native packer (which honours incumbent pins since round 5);
        otherwise the device family, sharded only when the mesh AND the
        solve size warrant it."""
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
        from slurm_bridge_tpu_torch.parallel.mesh import device_count
        from slurm_bridge_tpu_torch.solver.routing import (
            choose_path,
            gang_shard_fraction,
            incumbent_fraction,
            use_sharded,
        )

        backend = ensure_backend(self.device)
        if allow_indexed and choose_path(
            batch.num_shards,
            snapshot.num_nodes,
            backend_name=backend,
            gang_fraction=gang_shard_fraction(batch.gang_id),
            inc_fraction=incumbent_fraction(incumbent),
        ) == "native":
            return "indexed"
        return (
            "sharded"
            if use_sharded(batch.num_shards, snapshot.num_nodes,
                           device_count(backend))
            else "auction"
        )

    def _solve(self, solver, snapshot, batch, incumbent, cfg=None):
        cfg = cfg or self.config
        if batch.num_shards == 0:
            from slurm_bridge_tpu_torch.solver.snapshot import Placement

            return Placement(
                node_of=np.zeros(0, np.int32),
                placed=np.zeros(0, bool),
                free_after=snapshot.free.copy(),
            )
        if solver == "greedy":
            return greedy_place(snapshot, batch, incumbent=incumbent)
        if solver == "indexed":
            from slurm_bridge_tpu_torch.solver.indexed_native import (
                indexed_place_native,
            )
            from slurm_bridge_tpu_torch.solver.routing import native_fit_policy

            return indexed_place_native(
                snapshot,
                batch,
                incumbent=incumbent,
                policy=native_fit_policy(bool((incumbent >= 0).any())),
            )
        p_real = batch.num_shards
        if self.bucket:
            from slurm_bridge_tpu_torch.solver.snapshot import pad_batch

            batch = pad_batch(batch, self.bucket)
            if batch.num_shards != p_real:
                incumbent = np.concatenate(
                    [incumbent, np.full(batch.num_shards - p_real, -1, np.int32)]
                )
        if solver == "sharded":
            from slurm_bridge_tpu_torch.solver.sharded import sharded_place

            placement = sharded_place(
                snapshot, batch, cfg, incumbent=incumbent, device=self.device
            )
        else:
            import dataclasses

            key = dataclasses.astuple(cfg)
            session = self._sessions.get(key)
            if session is None:
                if len(self._sessions) >= 8:  # distinct configs are few;
                    self._sessions.clear()  # a churning client can't leak
                session = self._sessions[key] = DeviceSolver(
                    snapshot, cfg, device=self.device
                )
            else:
                session.update_snapshot(snapshot)
            placement = session.solve(batch, incumbent=incumbent)
        if placement.node_of.shape[0] != p_real:
            from slurm_bridge_tpu_torch.solver.snapshot import Placement

            placement = Placement(
                node_of=placement.node_of[:p_real],
                placed=placement.placed[:p_real],
                free_after=placement.free_after,
            )
        return placement


def serve_solver(
    endpoint: str,
    config: AuctionConfig | None = None,
    *,
    solver: str = "",
    device=None,
):
    """Start a gRPC server hosting the PlacementSolver at ``endpoint``.

    Wraps RPCs in the tracing interceptor (a span per Place, visible at
    /debug/tracez when --metrics-port is set) — same wiring as the agent
    (agent/main.py)."""
    from slurm_bridge_tpu_torch.obs.tracing import tracing_interceptor
    from slurm_bridge_tpu_torch.wire.rpc import serve

    return serve(
        {"PlacementSolver": PlacementSolverServicer(config, solver=solver, device=device)},
        endpoint,
        interceptors=(tracing_interceptor(),),
    )


def main(argv: list[str] | None = None) -> int:
    """``sbt-solver`` — run the placement solver as a standalone sidecar."""
    import argparse
    import signal

    from slurm_bridge_tpu_torch.obs.bootstrap import (
        add_observability_flags,
        start_observability,
    )
    from slurm_bridge_tpu_torch.obs.logging import setup_logging

    parser = argparse.ArgumentParser(description="slurm-bridge placement solver sidecar (PyTorch)")
    parser.add_argument("--listen", default="0.0.0.0:9998",
                        help="bind endpoint (host:port or *.sock)")
    add_observability_flags(parser)
    parser.add_argument("--solver", default="", choices=["", *SOLVERS],
                        help="default solver when requests don't name one "
                             "(empty = auto: the device auction — sharded "
                             "when the mesh and solve size warrant it — or "
                             "the indexed native packer for small or gang-"
                             "dominated pin-free batches when the request "
                             "opted into full routing with solver='auto')")
    parser.add_argument("--rounds", type=int, default=0,
                        help="auction rounds override (0 = config default)")
    parser.add_argument("--distributed", action="store_true",
                        help="join a multi-process group before serving "
                             "(rendezvous from MASTER_ADDR/MASTER_PORT or the "
                             "Slurm env — parallel/distributed.py); the "
                             "sharded solver then spans every rank's devices")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    setup_logging(verbose=args.verbose)

    if args.distributed:
        from slurm_bridge_tpu_torch.parallel.distributed import init_distributed

        if init_distributed():
            import torch.distributed as dist

            log.info(
                "joined process group: rank %d/%d", dist.get_rank(), dist.get_world_size()
            )
        else:
            log.info("single-process (no rendezvous in env); serving local devices")

    cfg = AuctionConfig()
    if args.rounds:
        cfg = AuctionConfig(rounds=args.rounds)
    server = serve_solver(args.listen, cfg, solver=args.solver)
    httpd = start_observability("sbt-solver", args)
    log.info("placement solver serving on %s (port %s)", args.listen, server.bound_port)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop(grace=2).wait()
    if httpd is not None:
        httpd.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
