"""Bridge API objects — the CRD surface re-expressed as dataclasses.

Reference parity: apis/kubecluster.org/v1alpha1/.
- ``BridgeJobSpec``  ↔ SlurmBridgeJobSpec   (slurmbridgejob_types.go:39-61)
- ``SubjobStatus``   ↔ SlurmSubjobStatus    (slurmbridgejob_types.go:65-85)
- ``BridgeJobStatus``↔ SlurmBridgeJobStatus (slurmbridgejob_types.go:87-94)
- ``validate_bridge_job`` ↔ ValidateV1alphaSlurmBridgeJob
  (slurmbridgejob_validation.go:8-26)
- pod roles sizecar/worker ↔ types.go:12-17

One deliberate redesign (SURVEY.md §7 "hard parts"): the reference smuggles
the agent's ``JobInfoResponse`` between virtual kubelet and operator as a
JSON string in ``pod.Status.Message`` (status.go:78-83 ↔
slurmbridgejob_controller.go:263). Here ``PodStatus.job_infos`` is a typed
field — same information flow, no stringly-typed bus.
"""

from __future__ import annotations

import itertools
import re
import uuid
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.core.fastpath import frozen_new
from slurm_bridge_tpu_torch.core.types import JobDemand, JobInfo, JobStatus

# RFC 1035 label: what K8s requires of resource names
# (slurmbridgejob_validation.go:12-18 uses apimachinery's IsDNS1035Label).
_DNS1035 = re.compile(r"^[a-z]([-a-z0-9]*[a-z0-9])?$")

_uid_counter = itertools.count(1)
#: one random prefix per process, a counter per object: same uniqueness
#: story as a per-object uuid4 (the prefix separates restarted bridges,
#: the counter separates objects) without paying an os.urandom syscall on
#: every Pod creation — 80 µs × 50k worker pods was real money (PR-3)
_uid_prefix = uuid.uuid4().hex[:12]


def new_uid() -> str:
    return f"{_uid_prefix}-{next(_uid_counter)}"


class ValidationError(ValueError):
    pass


@dataclass
class Meta:
    """Object metadata: identity, labels, ownership, optimistic-concurrency
    token. The ``owner`` field stands in for K8s owner references (cascade
    delete + watch routing, slurmbridgejob_controller.go:204)."""

    name: str = ""
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner: str = ""  # owning BridgeJob name, "" if unowned
    resource_version: int = 0
    deleted: bool = False  # deletion marker (graceful teardown)


# ---------------------------------------------------------------- BridgeJob


@dataclass
class BridgeJobSpec:
    """What the user asks for — field-for-field the CR spec
    (slurmbridgejob_types.go:39-61), with ``result_to`` standing in for the
    result volume (types.go:6-10)."""

    partition: str = ""
    sbatch_script: str = ""
    run_as_user: int | None = None
    run_as_group: int | None = None
    array: str = ""
    cpus_per_task: int = 0
    ntasks: int = 0
    ntasks_per_node: int = 0
    nodes: int = 0
    working_dir: str = ""
    mem_per_cpu_mb: int = 0
    gres: str = ""
    licenses: str = ""
    priority: int = 0
    result_to: str = ""  # local directory to fetch job output into


@dataclass
class SubjobStatus:
    """Status of one Slurm (sub-)job — SlurmSubjobStatus
    (slurmbridgejob_types.go:65-85)."""

    id: int = 0
    array_id: str = ""
    state: JobStatus = JobStatus.UNKNOWN
    exit_code: str = ""
    submit_time: str = ""
    start_time: str = ""
    run_time_s: int = 0
    std_out: str = ""
    std_err: str = ""
    reason: str = ""

    @classmethod
    def from_job_info(cls, info: JobInfo) -> "SubjobStatus":
        # frozen_new (every field explicit): rebuilt for every sub-job on
        # every CR status sync — 45k instances per sweep pass at the
        # headline shape — born frozen, so the commit walk skips them
        return frozen_new(
            cls,
            id=info.id,
            array_id=info.array_id,
            state=info.state,
            exit_code=info.exit_code,
            submit_time=info.submit_time.isoformat() if info.submit_time else "",
            start_time=info.start_time.isoformat() if info.start_time else "",
            run_time_s=info.run_time_s,
            std_out=info.std_out,
            std_err=info.std_err,
            reason=info.reason,
        )


class JobState:
    """CR-level lifecycle states (pkg/common/status.go:7-13)."""

    PENDING = "Pending"
    SUBMITTED = "Submitted"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"

    TERMINAL = (SUCCEEDED, FAILED)


class FetchState:
    """Result-fetch sub-state (SlurmBridgeJobStatus.FetchResult,
    slurmbridgejob_types.go:92 + controller :349-361)."""

    NONE = ""
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class BridgeJobStatus:
    state: str = JobState.PENDING
    reason: str = ""
    subjobs: dict[str, SubjobStatus] = field(default_factory=dict)
    fetch_result: str = FetchState.NONE
    cluster_endpoint: str = ""


@dataclass
class BridgeJob:
    meta: Meta
    spec: BridgeJobSpec
    status: BridgeJobStatus = field(default_factory=BridgeJobStatus)

    KIND = "BridgeJob"

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def finished(self) -> bool:
        return self.status.state in JobState.TERMINAL


def validate_bridge_job(job: BridgeJob) -> None:
    """Name must be DNS1035, partition and script required
    (slurmbridgejob_validation.go:8-26)."""
    validate_job_fields(job.meta.name, job.spec)


def validate_job_fields(name: str, spec: BridgeJobSpec) -> None:
    """The validation body over (name, spec) — validation is a pure
    function of exactly these two, which is what lets the columnar sweep
    validate from columns without materializing a view."""
    if not _DNS1035.match(name or ""):
        raise ValidationError(
            f"invalid job name {name!r}: must be a DNS-1035 label"
        )
    if len(name) > 63:
        raise ValidationError(f"job name {name!r} longer than 63 chars")
    if not spec.partition:
        raise ValidationError("spec.partition is required")
    if not spec.sbatch_script.strip():
        raise ValidationError("spec.sbatchScript is required")
    if spec.array:
        # reject malformed/oversized specs at ingress: raised deeper (the
        # sizing path) the ValueError would spin the reconcile-retry loop
        # forever instead of failing the job with a reason
        from slurm_bridge_tpu_torch.core.arrays import array_len

        try:
            array_len(spec.array)
        except ValueError as exc:
            raise ValidationError(f"invalid spec.array: {exc}") from None


# ---------------------------------------------------------------- Pod


class PodRole:
    """Pod roles (types.go:12-17): the sizecar carries the placement
    request; workers are per-sub-job display pods; fetcher pods run the
    result collection."""

    SIZECAR = "sizecar"
    WORKER = "worker"
    FETCHER = "fetcher"


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"

    TERMINAL = (SUCCEEDED, FAILED)


@dataclass
class ContainerStatus:
    """Display status of one sub-job "container" on a worker pod
    (status.go:105-186)."""

    name: str = ""
    state: str = "waiting"  # waiting | running | terminated
    exit_code: int = 0
    reason: str = ""


@dataclass
class PodSpec:
    role: str = PodRole.SIZECAR
    partition: str = ""
    demand: JobDemand | None = None  # resolved resource request (sizecar)
    node_name: str = ""  # bound virtual node ("" = unscheduled)
    placement_hint: tuple[str, ...] = ()  # solver-chosen Slurm nodes


@dataclass
class PodStatus:
    phase: str = PodPhase.PENDING
    reason: str = ""
    job_ids: tuple[int, ...] = ()  # Slurm job ids owned by this pod
    job_infos: list[JobInfo] = field(default_factory=list)  # typed side-channel
    containers: list[ContainerStatus] = field(default_factory=list)


@dataclass
class Pod:
    meta: Meta
    spec: PodSpec
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"

    @property
    def name(self) -> str:
        return self.meta.name


# ---------------------------------------------------------------- VirtualNode


@dataclass
class NodeCondition:
    type: str = "Ready"
    status: bool = True
    reason: str = ""


@dataclass
class VirtualNode:
    """One partition mirrored as a schedulable node (node.go:18-52): its
    capacity is the live partition inventory summed over member nodes
    (GetPartitionCapacity node.go:169-199 — with the reference's
    ``allogpu += AlloCpus`` bug fixed: alloc_gpus sums alloc_gpus)."""

    meta: Meta
    partition: str = ""
    capacity: dict[str, float] = field(default_factory=dict)
    allocatable: dict[str, float] = field(default_factory=dict)
    conditions: list[NodeCondition] = field(default_factory=list)
    heartbeat: float = 0.0
    agent_endpoint: str = ""

    KIND = "VirtualNode"

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def ready(self) -> bool:
        return any(c.type == "Ready" and c.status for c in self.conditions)


def partition_node_name(partition: str) -> str:
    """``slurm-partition-<p>`` (configurator.go:336)."""
    return f"slurm-partition-{partition}"


# ---------------------------------------------------------------- FetchJob


@dataclass
class FetchFile:
    remote_path: str = ""
    local_path: str = ""
    done: bool = False
    error: str = ""


@dataclass
class FetchJob:
    """The result-collection batch job (result.go:11-43): one file transfer
    per sub-job, backoff_limit 0 semantics — any failure fails the job."""

    meta: Meta
    files: list[FetchFile] = field(default_factory=list)
    agent_endpoint: str = ""
    state: str = FetchState.PENDING
    reason: str = ""

    KIND = "FetchJob"

    @property
    def name(self) -> str:
        return self.meta.name


# -------------------------------------------------------------- PolicyState


@dataclass
class PolicyState:
    """Durable scheduler-policy state — the fair-share service ledger.

    The policy engine's per-tenant accumulated dominant-share usage is
    the only scheduler state that is neither derivable from the cluster
    nor carried by a pod: losing it on restart resets every tenant's
    service to zero, so whichever tenant floods the queue first after a
    crash monopolizes the cluster until balance re-accumulates. One
    singleton object (``FAIRSHARE_NAME``) holds the ledger in the store,
    where the ordinary WAL persistence picks it up like any other kind
    (ROADMAP policy follow-up; regression: the crash_restart twin keeps
    Jain within tolerance — tests/test_policy.py).
    """

    meta: Meta
    #: tenant → accumulated dominant-share service (policy/fairshare.py)
    usage: dict[str, float] = field(default_factory=dict)
    #: bumped on every save — observability, not concurrency (the store
    #: rv is the concurrency token)
    generation: int = 0

    KIND = "PolicyState"
    FAIRSHARE_NAME = "fair-share"

    @property
    def name(self) -> str:
        return self.meta.name
