"""The bridge control plane's placement tick: API objects, the object
store, and the scheduler that binds pending sizecar pods to virtual nodes.

``ObjectStore`` stands in for the API server (optimistic concurrency,
watches, columnar hot state); ``PlacementScheduler`` takes one batched
inventory snapshot per tick and solves the whole pending queue with the
port's solver. The operator, virtual-node providers, configurator and the
``Bridge`` runtime that drive it are not ported yet.
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

__all__ = [
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
