"""Agent-side YAML partition overrides.

Reference parity: the agent's per-partition resource config
(pkg/slurm-agent/api/slurm.go:54-78, loaded in cmd/slurm-agent/
slurm-agent.go:113-130): each partition can pin nodes/cpu/mem/walltime or
mark them ``auto_*`` to fall back to live queries, plus advertise
additional feature strings.

Schema::

    partition_name:
      auto_nodes: true            # or nodes: 4
      auto_cpu_per_node: false
      cpu_per_node: 32
      auto_mem_per_node: true
      auto_wall_time: true
      wall_time: "1-00:00:00"     # slurm duration grammar
      additional_features: [a100, ib]
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.core.durations import parse_duration
from slurm_bridge_tpu_torch.core.types import PartitionResources


def parse_partition_config(text: str) -> dict[str, PartitionResources]:
    import yaml

    raw = yaml.safe_load(text) or {}
    if not isinstance(raw, dict):
        raise ValueError("partition config must be a mapping")
    out: dict[str, PartitionResources] = {}
    for name, body in raw.items():
        body = body or {}
        if not isinstance(body, dict):
            raise ValueError(f"partition {name!r} config must be a mapping")
        wall = body.get("wall_time", 0)
        wall_s = parse_duration(str(wall)) if isinstance(wall, str) else int(wall)
        out[str(name)] = PartitionResources(
            auto_nodes=bool(body.get("auto_nodes", False)),
            auto_cpu_per_node=bool(body.get("auto_cpu_per_node", False)),
            auto_mem_per_node=bool(body.get("auto_mem_per_node", False)),
            auto_wall_time=bool(body.get("auto_wall_time", False)),
            nodes=int(body.get("nodes", 0)),
            cpu_per_node=int(body.get("cpu_per_node", 0)),
            mem_per_node_mb=int(body.get("mem_per_node", body.get("mem_per_node_mb", 0))),
            wall_time_s=wall_s,
            additional_features=tuple(body.get("additional_features", ()) or ()),
        )
    return out


def load_partition_config(path: str) -> dict[str, PartitionResources]:
    with open(path) as f:
        return parse_partition_config(f.read())
