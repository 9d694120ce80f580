"""Typed job/partition/node model and Slurm dialect parsers.

Parity surface (reference citations):
- job spec fields      apis/kubecluster.org/v1alpha1/slurmbridgejob_types.go:39-61
- job/sub-job status   apis/kubecluster.org/v1alpha1/slurmbridgejob_types.go:65-94
- duration grammar     pkg/slurm-agent/parse.go:38-109
- #SBATCH header scan  pkg/slurm-bridge-operator/parse.go:30-135
- scontrol/sacct/sinfo pkg/slurm-agent/slurm.go:263-447, parse.go:113-308
"""

from slurm_bridge_tpu_torch.core.types import (
    JobStatus,
    JobDemand,
    JobInfo,
    JobStepInfo,
    NodeInfo,
    PartitionInfo,
    PartitionResources,
    JobResult,
    UNLIMITED,
)
from slurm_bridge_tpu_torch.core.durations import parse_duration, format_duration, UnlimitedError
from slurm_bridge_tpu_torch.core.arrays import parse_array_spec, array_len
from slurm_bridge_tpu_torch.core.sbatch import extract_batch_resources, SbatchDirectives
from slurm_bridge_tpu_torch.core.scontrol import (
    parse_scontrol_records,
    parse_job_info,
    parse_partition_info,
    parse_node_info,
)
from slurm_bridge_tpu_torch.core.sacct import parse_sacct_steps

__all__ = [
    "JobStatus",
    "JobDemand",
    "JobInfo",
    "JobStepInfo",
    "NodeInfo",
    "PartitionInfo",
    "PartitionResources",
    "JobResult",
    "UNLIMITED",
    "parse_duration",
    "format_duration",
    "UnlimitedError",
    "parse_array_spec",
    "array_len",
    "extract_batch_resources",
    "SbatchDirectives",
    "parse_scontrol_records",
    "parse_job_info",
    "parse_partition_info",
    "parse_node_info",
    "parse_sacct_steps",
]
