"""Sharded placement — partition/island fan-out for the 10×-scale tick.

Public surface:

- :class:`ShardConfig` — declarative knobs a Scenario (or the bridge
  CLI) carries; attach to :class:`~slurm_bridge_tpu_torch.bridge.scheduler.
  PlacementScheduler` via ``shard=``. ``shard=None`` (the default) is
  the monolithic tick byte-for-byte.
- :class:`ShardExecutor` — per-shard encode+solve fan-out + merge.
- :func:`build_plan` / :class:`ShardPlan` — the partition/island shard
  layout (planner.py).
- :func:`reconcile_gangs` — the cross-shard all-or-nothing second
  chance for gangs no single shard could place (reconcile.py).

See docs/sharding.md for the full design walkthrough.
"""

from slurm_bridge_tpu_torch.shard.executor import ShardExecutor
from slurm_bridge_tpu_torch.shard.planner import (
    Island,
    Shard,
    ShardConfig,
    ShardPlan,
    build_plan,
    route_jobs,
)
from slurm_bridge_tpu_torch.shard.reconcile import reconcile_gangs

__all__ = [
    "Island",
    "Shard",
    "ShardConfig",
    "ShardExecutor",
    "ShardPlan",
    "build_plan",
    "reconcile_gangs",
    "route_jobs",
]
