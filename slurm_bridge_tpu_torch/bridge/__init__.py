"""The bridge control plane's placement tick: API objects, the object
store, and the scheduler that binds pending sizecar pods to virtual nodes.

``ObjectStore`` stands in for the API server (optimistic concurrency,
watches, columnar hot state); ``PlacementScheduler`` takes one batched
inventory snapshot per tick and solves the whole pending queue with the
port's solver. The operator, virtual-node providers and configurator
(``bridge.operator``, ``bridge.vnode``, ``bridge.configurator``), the
store's snapshot and WAL (``bridge.persist``) and leader election
(``bridge.leader``) are their own modules; the ``Bridge`` runtime that
wires them to a live agent needs the gRPC transport and is not ported
yet (ROADMAP Queue 1 item 4).
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
