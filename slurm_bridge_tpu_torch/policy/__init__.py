"""Placement-quality policy subsystem.

Priority classes, weighted dominant-resource fair share, a bounded
preemption pool and post-solve backfill. Attached to the scheduler via
``PlacementScheduler(policy=PlacementPolicy(PolicyConfig(...)))``;
``policy=None`` (the default) leaves the tick untouched. The quality
scorecard (``policy/score.py`` in the JAX package) comes with the
simulator.
"""

from slurm_bridge_tpu_torch.policy.classes import (
    CLASS_LABEL,
    DEFAULT_CLASSES,
    TENANT_LABEL,
    ClassTable,
    PriorityClass,
)
from slurm_bridge_tpu_torch.policy.engine import PlacementPolicy, PolicyConfig
from slurm_bridge_tpu_torch.policy.fairshare import (
    FairShare,
    dominant_share,
    jain_index,
)

__all__ = [
    "CLASS_LABEL",
    "TENANT_LABEL",
    "DEFAULT_CLASSES",
    "ClassTable",
    "PriorityClass",
    "PlacementPolicy",
    "PolicyConfig",
    "FairShare",
    "dominant_share",
    "jain_index",
]
