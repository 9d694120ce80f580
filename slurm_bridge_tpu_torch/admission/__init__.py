"""Streaming admission — the always-on fast path next to the batch tick.

ISSUE 12 tentpole. The periodic solve batches everything, so a single
interactive pod waits a full tick period (seconds at the 500k×100k
shape) before placement even *looks* at it. This package is the
architectural split every planet-scale scheduler makes: a low-latency
admission path for interactive singles and small gangs, with the batch
tick demoted to the repair/repack pass behind it.

- :mod:`admission.residual` — the per-node **residual free_after view**:
  the capacity picture left by the last batch solve, maintained
  incrementally off bind commits (never rebuilt per admission);
- :mod:`admission.fastpath` — the event-driven binder: eligibility via
  the PR-9 priority-class table (production/system singles and small
  gangs), shard routing via the PR-10 plan, tight-fit node choice under
  backfill's no-delay guard — a fast-path bind may never shrink an
  unplaced equal-or-higher-class gang's feasible node set below its
  size, so the fast path can never starve the batch backlog.

``PlacementScheduler(admission=None)`` — the default — is the PR-11
tick byte-for-byte (fixture-pinned); everything here runs only when an
:class:`AdmissionConfig` is attached.
"""

from slurm_bridge_tpu_torch.admission.fastpath import (
    AdmissionConfig,
    AdmitResult,
    FastPathAdmitter,
)
from slurm_bridge_tpu_torch.admission.residual import ResidualView

__all__ = [
    "AdmissionConfig",
    "AdmitResult",
    "FastPathAdmitter",
    "ResidualView",
]
