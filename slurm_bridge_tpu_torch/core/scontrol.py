"""Parsers for `scontrol show {jobid,partition,nodes}` text output.

The reference fills structs by reflection over `slurm-agent:"Field"` tags
(pkg/slurm-agent/slurm.go:382-447) and parses partitions/nodes in
pkg/slurm-agent/parse.go:113-308. We parse the same key=value record grammar
into the core dataclasses, including the UNLIMITED→total fallbacks
(parse.go:113-190) and node CPUTot/CPUAlloc/RealMemory/AllocMem fields
(parse.go:291-308).
"""

from __future__ import annotations

import re
from datetime import datetime

from slurm_bridge_tpu_torch.core.durations import parse_duration
from slurm_bridge_tpu_torch.core.timeparse import NULL_SENTINELS, parse_slurm_time
from slurm_bridge_tpu_torch.core.hostlist import expand_hostlist
from slurm_bridge_tpu_torch.core.types import (
    UNLIMITED,
    JobInfo,
    JobStatus,
    NodeInfo,
    PartitionInfo,
)

_KEY_RE = re.compile(r"(?:^|\s)([A-Za-z][A-Za-z0-9_:/]*)=")
_NULLS = NULL_SENTINELS


def parse_scontrol_records(text: str) -> list[dict[str, str]]:
    """Split `scontrol show` output into records of key→value.

    Records are separated by blank lines. Within a record, values run from
    their `=` to the start of the next `key=` token, so values containing
    spaces (e.g. Reason) survive.
    """
    records: list[dict[str, str]] = []
    for block in re.split(r"\n\s*\n", text.strip()):
        block = block.strip()
        if not block or block.startswith("No jobs") or block.startswith("slurm_load"):
            continue
        flat = " ".join(line.strip() for line in block.splitlines())
        matches = list(_KEY_RE.finditer(flat))
        if not matches:
            continue
        rec: dict[str, str] = {}
        for i, m in enumerate(matches):
            key = m.group(1)
            end = matches[i + 1].start() if i + 1 < len(matches) else len(flat)
            rec[key] = flat[m.end() : end].strip()
        records.append(rec)
    return records


def _get(rec: dict[str, str], key: str, default: str = "") -> str:
    v = rec.get(key, default)
    return "" if v in _NULLS else v


_INT_RANGE_RE = re.compile(r"^(\d+)-(\d+)$")


def _int(rec: dict[str, str], key: str, default: int = 0) -> int:
    v = _get(rec, key)
    if not v:
        return default
    if v.upper() in ("UNLIMITED", "INFINITE"):
        return UNLIMITED
    # pending jobs render ranged counts, e.g. NumNodes=1-4: take the lower bound
    m = _INT_RANGE_RE.match(v)
    if m:
        return int(m.group(1))
    try:
        return int(float(v))
    except ValueError:
        return default


def _time(rec: dict[str, str], key: str) -> datetime | None:
    return parse_slurm_time(_get(rec, key))


def _dur(rec: dict[str, str], key: str) -> int:
    v = _get(rec, key)
    if not v:
        return 0
    try:
        return parse_duration(v)
    except ValueError:
        return 0


def parse_job_info(text: str) -> list[JobInfo]:
    """Parse `scontrol show jobid -dd <id>` output (one record per sub-job
    for arrays), mirroring jobInfoFromScontrolResponse slurm.go:382-447."""
    jobs: list[JobInfo] = []
    for rec in parse_scontrol_records(text):
        if "JobId" not in rec:
            continue
        array_job = _get(rec, "ArrayJobId")
        array_task = _get(rec, "ArrayTaskId")
        array_id = f"{array_job}_{array_task}" if array_job and array_task else ""
        # UserId renders as "name(uid)"
        user = _get(rec, "UserId")
        m = re.match(r"^([^()]+)\(", user)
        jobs.append(
            JobInfo(
                id=_int(rec, "JobId"),
                user_id=m.group(1) if m else user,
                name=_get(rec, "JobName") or _get(rec, "Name"),
                exit_code=_get(rec, "ExitCode"),
                state=JobStatus.from_slurm(_get(rec, "JobState")),
                submit_time=_time(rec, "SubmitTime"),
                start_time=_time(rec, "StartTime"),
                run_time_s=_dur(rec, "RunTime"),
                time_limit_s=(
                    UNLIMITED
                    if _get(rec, "TimeLimit").upper() == "UNLIMITED"
                    else _dur(rec, "TimeLimit")
                ),
                working_dir=_get(rec, "WorkDir"),
                std_out=_get(rec, "StdOut"),
                std_err=_get(rec, "StdErr"),
                partition=_get(rec, "Partition"),
                node_list=_get(rec, "NodeList"),
                batch_host=_get(rec, "BatchHost"),
                num_nodes=_int(rec, "NumNodes"),
                array_id=array_id,
                reason=_get(rec, "Reason"),
            )
        )
    return jobs


def parse_partition_info(text: str) -> list[PartitionInfo]:
    """Parse `scontrol show partition` output with the reference's
    UNLIMITED→total fallbacks (parse.go:113-190): an UNLIMITED MaxNodes
    falls back to TotalNodes, MaxCPUsPerNode to TotalCPUs/TotalNodes."""
    parts: list[PartitionInfo] = []
    for rec in parse_scontrol_records(text):
        if "PartitionName" not in rec:
            continue
        total_cpus = _int(rec, "TotalCPUs")
        total_nodes = _int(rec, "TotalNodes")
        max_nodes = _int(rec, "MaxNodes", UNLIMITED)
        if max_nodes == UNLIMITED and total_nodes > 0:
            max_nodes = total_nodes
        max_cpus = _int(rec, "MaxCPUsPerNode", UNLIMITED)
        if max_cpus == UNLIMITED and total_nodes > 0:
            max_cpus = total_cpus // total_nodes
        max_time_raw = _get(rec, "MaxTime")
        max_time = (
            UNLIMITED
            if max_time_raw.upper() in ("UNLIMITED", "INFINITE", "")
            else _dur(rec, "MaxTime")
        )
        nodes_expr = _get(rec, "Nodes")
        parts.append(
            PartitionInfo(
                name=_get(rec, "PartitionName"),
                nodes=tuple(expand_hostlist(nodes_expr)) if nodes_expr else (),
                max_time_s=max_time,
                max_nodes=max_nodes,
                max_cpus_per_node=max_cpus,
                max_mem_per_node_mb=_int(rec, "MaxMemPerNode", UNLIMITED),
                total_cpus=total_cpus,
                total_nodes=total_nodes,
                state=_get(rec, "State") or "UP",
            )
        )
    return parts


# Two GPU-count grammars coexist: Gres/GresUsed use colon form
# (`gpu:v100:4(S:0-1)`), AllocTRES/CfgTRES use equals form (`gres/gpu=4`,
# `gres/gpu:v100=4`).
_GRES_RE = re.compile(r"\bgpu(?::(?P<type>[^:,(=]+))?:(?P<count>\d+)")
_TRES_RE = re.compile(r"gres/gpu(?::(?P<type>[^:,=]+))?=(?P<count>\d+)")


def parse_gres_gpus(gres: str) -> tuple[int, str]:
    """Parse GPU counts from either Gres (`gpu:v100:4(S:0-1),lustre:1`) or
    TRES (`cpu=8,mem=32G,gres/gpu=4`) syntax → (4, 'v100')."""
    total, gpu_type = 0, ""
    pattern = _TRES_RE if "gres/gpu" in gres else _GRES_RE
    for m in pattern.finditer(gres):
        total += int(m.group("count"))
        if m.group("type"):
            gpu_type = m.group("type")
    return total, gpu_type


def parse_node_info(text: str) -> list[NodeInfo]:
    """Parse `scontrol show nodes` output (CPUTot/CPUAlloc/RealMemory/
    AllocMem per parse.go:291-308, plus Gres → gpus)."""
    nodes: list[NodeInfo] = []
    for rec in parse_scontrol_records(text):
        if "NodeName" not in rec:
            continue
        gpus, gpu_type = parse_gres_gpus(_get(rec, "Gres"))
        alloc_gpus, _ = parse_gres_gpus(_get(rec, "GresUsed") or _get(rec, "AllocTRES"))
        feats = _get(rec, "AvailableFeatures") or _get(rec, "Features")
        nodes.append(
            NodeInfo(
                name=_get(rec, "NodeName"),
                cpus=_int(rec, "CPUTot"),
                alloc_cpus=_int(rec, "CPUAlloc"),
                memory_mb=_int(rec, "RealMemory"),
                alloc_memory_mb=_int(rec, "AllocMem"),
                gpus=gpus,
                alloc_gpus=alloc_gpus,
                gpu_type=gpu_type,
                features=tuple(f for f in feats.split(",") if f) if feats else (),
                state=_get(rec, "State") or "IDLE",
            )
        )
    return nodes
