"""Carry solver state across from the JAX package (or any duck-typed
source) into this package's types.

The JAX package's ``ClusterSnapshot``/``JobBatch`` hold numpy arrays and
its ``AuctionConfig`` plain fields, so the carry is a field-by-field copy:
each function takes an object with the named attributes, or a dict with
the same keys, and never imports the JAX package. Tests use it to feed
both packages the very same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slurm_bridge_tpu_torch.solver.auction import AuctionConfig
from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, JobBatch

_SNAPSHOT_ARRAYS = {
    "capacity": np.float32,
    "free": np.float32,
    "partition_of": np.int32,
    "features": np.uint32,
}
_BATCH_ARRAYS = {
    "demand": np.float32,
    "partition_of": np.int32,
    "req_features": np.uint32,
    "priority": np.float32,
    "gang_id": np.int32,
    "job_of": np.int32,
}


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def snapshot_from(src) -> ClusterSnapshot:
    """A :class:`ClusterSnapshot` with copies of ``src``'s fields."""
    arrays = {k: np.array(_get(src, k), dtype=dt) for k, dt in _SNAPSHOT_ARRAYS.items()}
    return ClusterSnapshot(
        node_names=list(_get(src, "node_names")),
        partition_codes=dict(_get(src, "partition_codes")),
        feature_codes=dict(_get(src, "feature_codes")),
        **arrays,
    )


def batch_from(src) -> JobBatch:
    """A :class:`JobBatch` with copies of ``src``'s arrays."""
    return JobBatch(
        **{k: np.array(_get(src, k), dtype=dt) for k, dt in _BATCH_ARRAYS.items()}
    )


def config_from(src) -> AuctionConfig:
    """An :class:`AuctionConfig` with ``src``'s values for every field
    (the field names and meanings are the JAX package's, one for one;
    ``use_pallas`` selects the hand kernel here)."""
    return AuctionConfig(
        **{f.name: _get(src, f.name) for f in dataclasses.fields(AuctionConfig)}
    )
