"""Sharded placement — the partition/island shard layout.

The port carries the planner (:mod:`~slurm_bridge_tpu_torch.shard.planner`):
:class:`ShardConfig`, which a simulator :class:`Scenario` may hold, and
the layout it builds. The executor that fans a tick out over shards and
the cross-shard gang reconciliation are not ported yet (ROADMAP Queue 1
item 5): ``PlacementScheduler(shard=...)`` and a sharded scenario raise
``NotImplementedError``.
"""

from slurm_bridge_tpu_torch.shard.planner import (
    Island,
    Shard,
    ShardConfig,
    ShardPlan,
    build_plan,
    route_jobs,
)

__all__ = [
    "Island",
    "Shard",
    "ShardConfig",
    "ShardPlan",
    "build_plan",
    "route_jobs",
]
