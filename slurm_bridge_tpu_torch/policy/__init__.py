"""Placement-quality policy subsystem (ISSUE 9).

Priority classes, weighted dominant-resource fair share, a bounded
preemption pool, post-solve backfill, and the quality scorecard the sim
scenarios are gated on. Attached to the scheduler via
``PlacementScheduler(policy=PlacementPolicy(PolicyConfig(...)))``;
``policy=None`` (the default) is byte-identical PR-8 behavior.
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
from slurm_bridge_tpu_torch.policy.score import QualityTracker

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
    "QualityTracker",
]
