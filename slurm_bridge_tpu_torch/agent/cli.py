"""Slurm CLI driver — the only layer that talks to the workload manager.

Reference parity (pkg/slurm-agent/slurm.go):
- NewClient verifies all five binaries on PATH (:129-147);
- SBatch builds the flag list, pipes the script on stdin, and parses the
  ``--parsable`` job id (:167-229) — we fix the reference's duplicated
  ntasks-per-node flag (:216-221) by emitting each flag once;
- SJobInfo/SJobSteps/Resources/Partitions/Nodes/Version shell out to
  scontrol/sacct/sinfo and parse with the core parsers (:232-380).

Swapping this driver retargets the whole bridge at another WLM — the
``WorkloadDriver`` protocol is the seam.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import IO, Iterable, Protocol

from slurm_bridge_tpu_torch.core.sacct import parse_sacct_steps
from slurm_bridge_tpu_torch.core.scontrol import (
    parse_job_info,
    parse_node_info,
    parse_partition_info,
)
from slurm_bridge_tpu_torch.core.types import (
    JobDemand,
    JobInfo,
    JobStepInfo,
    NodeInfo,
    PartitionInfo,
)

REQUIRED_BINARIES = ("sbatch", "scancel", "scontrol", "sacct", "sinfo")


class SlurmError(RuntimeError):
    """A Slurm CLI invocation failed; carries the command and stderr."""

    def __init__(self, cmd: list[str], returncode: int, stderr: str):
        super().__init__(f"{' '.join(cmd)} failed (rc={returncode}): {stderr.strip()}")
        self.cmd = cmd
        self.returncode = returncode
        self.stderr = stderr


class WorkloadDriver(Protocol):
    """The pluggable WLM seam: what the gRPC server needs from a backend."""

    def submit(self, demand: JobDemand) -> int: ...
    def cancel(self, job_id: int) -> None: ...
    def job_info(self, job_id: int) -> list[JobInfo]: ...
    def job_steps(self, job_id: int) -> list[JobStepInfo]: ...
    def partitions(self) -> list[str]: ...
    def partition(self, name: str) -> PartitionInfo: ...
    def nodes(self, names: Iterable[str]) -> list[NodeInfo]: ...
    def version(self) -> str: ...


class SlurmClient:
    """CLI-backed driver (implements :class:`WorkloadDriver`)."""

    def __init__(self, *, check_binaries: bool = True):
        if check_binaries:
            missing = [b for b in REQUIRED_BINARIES if shutil.which(b) is None]
            if missing:
                raise SlurmError(
                    ["which", *missing], 127, f"missing slurm binaries: {missing}"
                )

    # ---- process plumbing ----

    def _run(self, cmd: list[str], *, stdin: str | None = None) -> str:
        proc = subprocess.run(
            cmd,
            input=stdin,
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise SlurmError(cmd, proc.returncode, proc.stderr)
        return proc.stdout

    # ---- submission ----

    @staticmethod
    def sbatch_args(demand: JobDemand) -> list[str]:
        """Flag list for sbatch; each option emitted at most once."""
        args = ["sbatch", "--parsable"]
        if demand.partition:
            args += ["--partition", demand.partition]
        if demand.run_as_user is not None:
            args += ["--uid", str(demand.run_as_user)]
        if demand.run_as_group is not None:
            args += ["--gid", str(demand.run_as_group)]
        if demand.array:
            args += ["--array", demand.array]
        if demand.cpus_per_task > 1:
            args += ["--cpus-per-task", str(demand.cpus_per_task)]
        if demand.ntasks > 1:
            args += ["--ntasks", str(demand.ntasks)]
        if demand.ntasks_per_node > 0:
            args += ["--ntasks-per-node", str(demand.ntasks_per_node)]
        if demand.nodes > 1:
            args += ["--nodes", str(demand.nodes)]
        if demand.mem_per_cpu_mb > 0:
            args += ["--mem-per-cpu", str(demand.mem_per_cpu_mb)]
        if demand.gres:
            args += ["--gres", demand.gres]
        if demand.licenses:
            args += ["--licenses", demand.licenses]
        if demand.job_name:
            args += ["--job-name", demand.job_name]
        if demand.working_dir:
            args += ["--chdir", demand.working_dir]
        if demand.time_limit_s > 0:
            mins = max(1, demand.time_limit_s // 60)
            args += ["--time", str(mins)]
        if demand.priority > 0:
            args += ["--priority", str(demand.priority)]
        if demand.nodelist:
            args += ["--nodelist", ",".join(demand.nodelist)]
        return args

    def submit(self, demand: JobDemand) -> int:
        if not demand.script.strip():
            raise SlurmError(["sbatch"], 1, "empty batch script")
        out = self._run(self.sbatch_args(demand), stdin=demand.script)
        # --parsable prints "jobid[;cluster]"
        head = out.strip().splitlines()[-1].split(";")[0]
        try:
            return int(head)
        except ValueError as e:
            raise SlurmError(["sbatch"], 0, f"unparsable sbatch output: {out!r}") from e

    def cancel(self, job_id: int) -> None:
        self._run(["scancel", str(job_id)])

    # ---- queries ----

    def job_info(self, job_id: int) -> list[JobInfo]:
        out = self._run(["scontrol", "show", "jobid", "-dd", str(job_id)])
        return parse_job_info(out)

    def job_steps(self, job_id: int) -> list[JobStepInfo]:
        out = self._run(
            [
                "sacct",
                "-p",
                "-n",
                "-j",
                str(job_id),
                "-o",
                "start,end,exitcode,state,jobid,jobname",
            ]
        )
        return parse_sacct_steps(out)

    def partitions(self) -> list[str]:
        out = self._run(["scontrol", "show", "partition"])
        return [p.name for p in parse_partition_info(out)]

    def partition(self, name: str) -> PartitionInfo:
        out = self._run(["scontrol", "show", "partition", name])
        parts = parse_partition_info(out)
        if not parts:
            raise SlurmError(["scontrol"], 0, f"no such partition: {name}")
        return parts[0]

    def all_partitions(self) -> list[PartitionInfo]:
        out = self._run(["scontrol", "show", "partition"])
        return parse_partition_info(out)

    def nodes(self, names: Iterable[str]) -> list[NodeInfo]:
        names = list(names)
        if not names:
            return []
        out = self._run(["scontrol", "show", "nodes", ",".join(names)])
        return parse_node_info(out)

    def version(self) -> str:
        return self._run(["sinfo", "-V"]).strip()
