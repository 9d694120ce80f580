"""The typed node, partition and job-demand model the solver lowers.

A copy of the three dataclasses of the JAX package's ``core/types.py``
that :mod:`slurm_bridge_tpu_torch.solver.snapshot` consumes, field for
field, so both packages encode the same inventory into the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Sentinel for Slurm's UNLIMITED/INFINITE values.
UNLIMITED = -1


@dataclass
class JobDemand:
    """What a job asks for (sbatch options as the bridge sees them).

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
    #: solver-chosen hosts, forwarded as ``sbatch --nodelist``
    nodelist: tuple[str, ...] = ()

    def total_cpus(self, array_count: int = 1) -> int:
        """cpu = cpus_per_task × ntasks × array-len (the sizecar sizing rule)."""
        return max(1, self.cpus_per_task) * max(1, self.ntasks) * max(1, array_count)


@dataclass
class NodeInfo:
    """One Slurm node — capacity plus current allocation."""

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
    """One Slurm partition — limits + member nodes."""

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
