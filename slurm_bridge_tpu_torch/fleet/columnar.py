"""Columnar PlaceShard framing + the pure per-shard solve a sidecar runs.

The request ships the *solver-visible* subset of a shard snapshot as raw
little-endian columns (``wire/coldec.py`` discipline: bytes -> ndarray,
never per-object messages). The engines (``greedy_place``,
``indexed_place_native``) read only ``free`` / ``partition_of`` /
``features`` / ``num_nodes`` from the snapshot and the five dense columns
from the batch, so a worker that rebuilds both from the columns — names
blanked, capacity zeroed, code dicts empty — produces placements
byte-identical to the in-process solve by construction. ``free_after``
rides back whole so the replica's streaming-admission window stays live
per shard.

``schema_digest`` is the version-handshake token: a truncated sha256 of
the serialized file descriptor, so ANY schema drift (field renumber, new
message) changes it and the supervisor refuses to adopt the skewed peer
instead of failing opaquely mid-solve.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from slurm_bridge_tpu_torch.solver.snapshot import (
    NUM_RES,
    ClusterSnapshot,
    JobBatch,
    Placement,
)
from slurm_bridge_tpu_torch.wire import messages as pb


def schema_digest() -> str:
    """Truncated sha256 of the wire schema; both sides of the handshake."""
    return hashlib.sha256(pb.DESCRIPTOR.serialized_pb).hexdigest()[:16]


def healthz_response(
    service: str,
    incarnation: str,
    shard_set: tuple[int, ...] = (),
    metrics: dict[str, float] | None = None,
) -> pb.HealthzResponse:
    resp = pb.HealthzResponse(
        service=service,
        incarnation=incarnation,
        schema_version=schema_digest(),
        shard_set=list(shard_set),
        pid=os.getpid(),
    )
    if metrics:
        # parallel arrays, sorted for a stable wire shape
        for name in sorted(metrics):
            resp.metric_name.append(name)
            resp.metric_total.append(float(metrics[name]))
    return resp


def _col(a: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(a, dtype=dtype).tobytes()


def encode_place_shard(
    sid: int,
    engine: str,
    policy: str,
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    incumbent: np.ndarray | None,
) -> pb.PlaceShardRequest:
    return pb.PlaceShardRequest(
        engine=engine,
        policy=policy,
        num_nodes=snapshot.num_nodes,
        num_rows=batch.num_shards,
        free=_col(snapshot.free, np.float32),
        node_partition=_col(snapshot.partition_of, np.int32),
        node_features=_col(snapshot.features, np.uint32),
        demand=_col(batch.demand, np.float32),
        job_partition=_col(batch.partition_of, np.int32),
        req_features=_col(batch.req_features, np.uint32),
        priority=_col(batch.priority, np.float32),
        gang_id=_col(batch.gang_id, np.int32),
        job_of=_col(batch.job_of, np.int32),
        incumbent=b"" if incumbent is None else _col(incumbent, np.int32),
        shard_id=sid,
    )


def _arr(raw: bytes, dtype, shape) -> np.ndarray:
    # .copy(): frombuffer views are read-only and the engines mutate free
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def decode_place_shard(
    request: pb.PlaceShardRequest,
) -> tuple[ClusterSnapshot, JobBatch, np.ndarray | None]:
    n, p = int(request.num_nodes), int(request.num_rows)
    snapshot = ClusterSnapshot(
        node_names=[""] * n,
        capacity=np.zeros((n, NUM_RES), np.float32),
        free=_arr(request.free, np.float32, (n, NUM_RES)),
        partition_of=_arr(request.node_partition, np.int32, (n,)),
        features=_arr(request.node_features, np.uint32, (n,)),
        partition_codes={},
        feature_codes={},
    )
    batch = JobBatch(
        demand=_arr(request.demand, np.float32, (p, NUM_RES)),
        partition_of=_arr(request.job_partition, np.int32, (p,)),
        req_features=_arr(request.req_features, np.uint32, (p,)),
        priority=_arr(request.priority, np.float32, (p,)),
        gang_id=_arr(request.gang_id, np.int32, (p,)),
        job_of=_arr(request.job_of, np.int32, (p,)),
    )
    incumbent = (
        _arr(request.incumbent, np.int32, (p,)) if request.incumbent else None
    )
    return snapshot, batch, incumbent


def solve_place_shard(request: pb.PlaceShardRequest) -> pb.PlaceShardResponse:
    """Run the requested engine over the decoded columns. Pure: same
    request bytes -> same response bytes, which is what the fleet twin and
    remote-parity fuzz gates pin."""
    import time

    from slurm_bridge_tpu_torch.solver.greedy import greedy_place

    t_in = time.monotonic_ns()
    snapshot, batch, incumbent = decode_place_shard(request)
    t0 = time.monotonic_ns()
    if request.engine == "native":
        from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

        placement = indexed_place_native(
            snapshot, batch, incumbent=incumbent,
            policy=(request.policy or None),
        )
    else:
        placement = greedy_place(snapshot, batch, incumbent=incumbent)
    t1 = time.monotonic_ns()
    resp = pb.PlaceShardResponse(
        node_of=_col(placement.node_of, np.int32),
        placed=_col(np.asarray(placement.placed), np.uint8),
        free_after=_col(placement.free_after, np.float32),
        engine=request.engine,
        solve_ms=(t1 - t0) / 1e6,
    )
    # worker-side timing summary (ISSUE 20): the bridge stitches these
    # into synthetic child spans under its rpc.PlaceShard client span
    resp.decode_ns = t0 - t_in
    resp.solve_ns = t1 - t0
    resp.encode_ns = time.monotonic_ns() - t1
    resp.rows = int(request.num_rows)
    return resp


def placement_from_response(
    resp: pb.PlaceShardResponse, num_rows: int, num_nodes: int
) -> Placement:
    return Placement(
        node_of=_arr(resp.node_of, np.int32, (num_rows,)),
        placed=_arr(resp.placed, np.uint8, (num_rows,)).astype(bool),
        free_after=_arr(resp.free_after, np.float32, (num_nodes, NUM_RES)),
    )
