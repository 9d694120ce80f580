"""Fleet runtime: solver sidecar processes + bridge replica shard-sets.

The single process stops pretending to be a cluster-scale service here:

- ``columnar``   — PlaceShard request/response framing (bytes -> columns,
  same discipline as ``wire/coldec.py``) plus the pure solve function a
  sidecar runs; byte-parity with the in-process engines by construction.
- ``worker``     — the solver sidecar entrypoint (``python -m
  slurm_bridge_tpu_torch.fleet.worker``): a PlacementSolver servicer speaking
  PlaceShard + Healthz over a unix socket.
- ``sidecar``    — per-replica process supervisor: spawn, ready handshake,
  Healthz schema check, restart-with-backoff, remembered inline fallback.
- ``membership`` — lease-stamped, WAL-persisted replica membership table;
  the live set deterministically keys shard -> owning replica.
- ``runtime``    — ``FleetRuntime`` ties it together and plugs into
  ``ShardExecutor.remote``; the leader (existing ``LeaderElector``) keeps
  cross-shard reconcile, replicas gossip residuals via ``free_after``.

See docs/fleet.md for topology, the lease format, and the re-key
algorithm.
"""

from slurm_bridge_tpu_torch.fleet.columnar import (
    decode_place_shard,
    encode_place_shard,
    healthz_response,
    placement_from_response,
    schema_digest,
    solve_place_shard,
)
from slurm_bridge_tpu_torch.fleet.membership import MembershipTable
from slurm_bridge_tpu_torch.fleet.runtime import FleetConfig, FleetRuntime
from slurm_bridge_tpu_torch.fleet.sidecar import SidecarSupervisor

__all__ = [
    "FleetConfig",
    "FleetRuntime",
    "MembershipTable",
    "SidecarSupervisor",
    "decode_place_shard",
    "encode_place_shard",
    "healthz_response",
    "placement_from_response",
    "schema_digest",
    "solve_place_shard",
]
