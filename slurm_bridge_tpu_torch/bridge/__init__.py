"""The bridge control plane: API objects, object store, reconcilers.

This layer reproduces the reference's Kubernetes-side machinery (SURVEY.md
§2.2-§2.6) as a standalone in-process control plane: the `BridgeJob` object
mirrors the `SlurmBridgeJob` CRD, `ObjectStore` stands in for the API
server (optimistic concurrency + watches), and the operator / virtual-node
/ scheduler / configurator / fetcher components reproduce the five call
stacks of SURVEY.md §3 — with the per-pod `scontrol` hot loop replaced by
one batched snapshot per scheduler tick fed to the port's placement
solver, whose device auction runs on the card unless the caller asks for
the CPU (``Bridge(device="cpu")`` or ``SBT_BACKEND=cpu``).
"""

from slurm_bridge_tpu_torch.bridge.objects import (
    BridgeJob,
    FetchState,
    JobState,
    BridgeJobSpec,
    BridgeJobStatus,
    FetchJob,
    Meta,
    Pod,
    PodPhase,
    PodRole,
    SubjobStatus,
    ValidationError,
    VirtualNode,
    validate_bridge_job,
)
from slurm_bridge_tpu_torch.bridge.store import (
    Conflict,
    FrozenInstanceError,
    NotFound,
    ObjectStore,
    StoreEvent,
)
from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler

from slurm_bridge_tpu_torch.bridge.runtime import Bridge

__all__ = [
    "Bridge",
    "BridgeJob",
    "FetchState",
    "JobState",
    "BridgeJobSpec",
    "BridgeJobStatus",
    "Conflict",
    "FetchJob",
    "FrozenInstanceError",
    "Meta",
    "NotFound",
    "ObjectStore",
    "PlacementScheduler",
    "Pod",
    "PodPhase",
    "PodRole",
    "StoreEvent",
    "SubjobStatus",
    "ValidationError",
    "VirtualNode",
    "validate_bridge_job",
]
