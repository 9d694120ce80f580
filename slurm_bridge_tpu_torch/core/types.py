"""Core typed model shared by every layer.

The message set mirrors the capability surface of the reference's CRD spec
(apis/kubecluster.org/v1alpha1/slurmbridgejob_types.go:39-94) and gRPC contract
(pkg/workload/workload.proto:64-308), re-expressed as plain dataclasses so the
solver can lower them into dense arrays without an ORM in the way.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from datetime import datetime


#: Sentinel for Slurm's UNLIMITED/INFINITE values (parse.go:45-52 semantics):
#: we normalise them to this instead of raising, so matrix encoders can clamp.
UNLIMITED = -1


class JobStatus(enum.IntEnum):
    """Slurm job state, mirroring the reference's JobStatus enum
    (pkg/workload/workload.proto:241-250)."""

    COMPLETED = 0
    CANCELLED = 1
    FAILED = 2
    TIMEOUT = 3
    PENDING = 4
    RUNNING = 5
    UNKNOWN = 6

    @classmethod
    def from_slurm(cls, s: str) -> "JobStatus":
        """Map a Slurm state string (e.g. 'RUNNING', 'COMPLETED',
        'CANCELLED by 1000', 'NODE_FAIL') to a JobStatus."""
        head = s.strip().upper().split()[0] if s.strip() else ""
        head = head.rstrip("+")  # sacct suffixes e.g. CANCELLED+
        direct = {
            "COMPLETED": cls.COMPLETED,
            "CANCELLED": cls.CANCELLED,
            "FAILED": cls.FAILED,
            "TIMEOUT": cls.TIMEOUT,
            "PENDING": cls.PENDING,
            "RUNNING": cls.RUNNING,
            "COMPLETING": cls.RUNNING,
            "CONFIGURING": cls.PENDING,
            "SUSPENDED": cls.PENDING,
            "PREEMPTED": cls.CANCELLED,
            "NODE_FAIL": cls.FAILED,
            "BOOT_FAIL": cls.FAILED,
            "DEADLINE": cls.TIMEOUT,
            "OUT_OF_MEMORY": cls.FAILED,
        }
        return direct.get(head, cls.UNKNOWN)

    @property
    def is_terminal(self) -> bool:
        return self in (
            JobStatus.COMPLETED,
            JobStatus.CANCELLED,
            JobStatus.FAILED,
            JobStatus.TIMEOUT,
        )


@dataclass
class JobDemand:
    """What a job asks for — the union of the CR spec fields
    (slurmbridgejob_types.go:39-61) and SubmitJobRequest
    (workload.proto:64-82).

    ``mem_per_cpu_mb`` is in MiB, matching sbatch --mem-per-cpu default units.
    ``time_limit_s`` of ``UNLIMITED`` means no limit.
    """

    partition: str = ""
    script: str = ""
    job_name: str = ""
    run_as_user: int | None = None
    run_as_group: int | None = None
    array: str = ""
    cpus_per_task: int = 1
    ntasks: int = 1
    ntasks_per_node: int = 0
    nodes: int = 1
    working_dir: str = ""
    mem_per_cpu_mb: int = 0
    gres: str = ""
    licenses: str = ""
    time_limit_s: int = 0
    priority: int = 0
    #: solver-chosen hosts, forwarded as ``sbatch --nodelist`` (Slurm stays
    #: the final arbiter; an infeasible hint falls back to Slurm's choice)
    nodelist: tuple[str, ...] = ()

    def total_cpus(self, array_count: int = 1) -> int:
        """cpu = cpus_per_task × ntasks × array-len — the sizecar sizing rule
        (pkg/slurm-bridge-operator/pod.go:143-162, array multiply :153-156)."""
        return max(1, self.cpus_per_task) * max(1, self.ntasks) * max(1, array_count)

    def total_mem_mb(self, array_count: int = 1) -> int:
        return self.mem_per_cpu_mb * self.total_cpus(array_count)


@dataclass
class JobInfo:
    """Live job state — the 18-field JobInfo message
    (pkg/workload/workload.proto:253-292)."""

    id: int = 0
    user_id: str = ""
    name: str = ""
    exit_code: str = ""
    state: JobStatus = JobStatus.UNKNOWN
    submit_time: datetime | None = None
    start_time: datetime | None = None
    run_time_s: int = 0
    time_limit_s: int = 0
    working_dir: str = ""
    std_out: str = ""
    std_err: str = ""
    partition: str = ""
    node_list: str = ""
    batch_host: str = ""
    num_nodes: int = 0
    array_id: str = ""
    reason: str = ""

    def key(self) -> str:
        return f"{self.id}" if not self.array_id else self.array_id


@dataclass
class JobStepInfo:
    """One sacct step row (pkg/workload/workload.proto:295-308)."""

    id: str = ""
    name: str = ""
    start_time: datetime | None = None
    finish_time: datetime | None = None
    exit_code: int = 0
    state: JobStatus = JobStatus.UNKNOWN


@dataclass
class NodeInfo:
    """One Slurm node — capacity plus current allocation
    (pkg/workload/workload.proto:165-174; parse fields CPUTot/CPUAlloc/
    RealMemory/AllocMem per pkg/slurm-agent/parse.go:291-308)."""

    name: str = ""
    cpus: int = 0
    alloc_cpus: int = 0
    memory_mb: int = 0
    alloc_memory_mb: int = 0
    gpus: int = 0
    alloc_gpus: int = 0
    gpu_type: str = ""
    features: tuple[str, ...] = ()
    state: str = "IDLE"

    @property
    def free_cpus(self) -> int:
        return max(0, self.cpus - self.alloc_cpus)

    @property
    def free_memory_mb(self) -> int:
        return max(0, self.memory_mb - self.alloc_memory_mb)

    @property
    def free_gpus(self) -> int:
        return max(0, self.gpus - self.alloc_gpus)

    @property
    def schedulable(self) -> bool:
        # composite states join flags with '+' (IDLE+CLOUD, MIXED+CLOUD+POWERED_UP);
        # single-char suffix flags (*~#!%$@^-) decorate the base state
        state = self.state.upper().split("+")[0].rstrip("*~#!%$@^-")
        if any(
            bad in self.state.upper()
            for bad in ("DRAIN", "DOWN", "FAIL", "MAINT", "POWERED_DOWN", "POWERING_DOWN")
        ):
            return False
        return state in ("IDLE", "MIXED", "ALLOCATED", "ALLOC", "COMPLETING")


@dataclass
class PartitionInfo:
    """One Slurm partition — limits + member nodes
    (ResourcesResponse workload.proto:137-148; parseResources semantics with
    UNLIMITED→total fallbacks, pkg/slurm-agent/parse.go:113-190)."""

    name: str = ""
    nodes: tuple[str, ...] = ()
    max_time_s: int = UNLIMITED
    max_nodes: int = UNLIMITED
    max_cpus_per_node: int = UNLIMITED
    max_mem_per_node_mb: int = UNLIMITED
    total_cpus: int = 0
    total_nodes: int = 0
    state: str = "UP"
    features: tuple[str, ...] = ()


@dataclass
class PartitionResources:
    """Per-partition resource override config — the agent's YAML knobs
    (pkg/slurm-agent/api/slurm.go:54-78: auto_* flags, fixed values,
    additional_features)."""

    auto_nodes: bool = False
    auto_cpu_per_node: bool = False
    auto_mem_per_node: bool = False
    auto_wall_time: bool = False
    nodes: int = 0
    cpu_per_node: int = 0
    mem_per_node_mb: int = 0
    wall_time_s: int = 0
    additional_features: tuple[str, ...] = ()


@dataclass
class JobResult:
    """Where to put fetched job artifacts (types.go:6-10 JobResult{Volume})."""

    mount_path: str = ""


def asdict_shallow(obj) -> dict:
    """dataclasses.asdict without deep-copying nested values."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
