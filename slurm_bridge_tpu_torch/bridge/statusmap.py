"""Slurm job state → pod phase → CR state translation.

Reference parity: pkg/slurm-virtual-kubelet/status.go:21-53 (job statuses →
PodPhase) and the operator's pod-phase → CR-state mapping
(slurmbridgejob_controller.go:246-294). Rules kept exactly:

- if every job ended: Succeeded, unless any FAILED/CANCELLED/TIMEOUT ⇒ Failed;
- else any RUNNING ⇒ Running; any PENDING ⇒ Pending; otherwise Unknown.
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.bridge.objects import (
    ContainerStatus,
    JobState,
    PodPhase,
)
from slurm_bridge_tpu_torch.core.fastpath import frozen_new
from slurm_bridge_tpu_torch.core.types import JobInfo, JobStatus

_BAD_END = (JobStatus.FAILED, JobStatus.CANCELLED, JobStatus.TIMEOUT)


def pod_phase_for(statuses: list[JobStatus]) -> str:
    """status.go:21-53 semantics over the (sub-)job status list."""
    if not statuses:
        return PodPhase.PENDING
    if all(s.is_terminal for s in statuses):
        if any(s in _BAD_END for s in statuses):
            return PodPhase.FAILED
        return PodPhase.SUCCEEDED
    if any(s == JobStatus.RUNNING for s in statuses):
        return PodPhase.RUNNING
    if any(s in _BAD_END for s in statuses):
        # some ended badly, rest still queued — surface the failure early
        return PodPhase.FAILED
    if any(s == JobStatus.PENDING for s in statuses):
        return PodPhase.PENDING
    return PodPhase.UNKNOWN


_STATE_FOR_PHASE = {
    PodPhase.PENDING: JobState.SUBMITTED,
    PodPhase.RUNNING: JobState.RUNNING,
    PodPhase.SUCCEEDED: JobState.SUCCEEDED,
    PodPhase.FAILED: JobState.FAILED,
}


def job_state_for_pod_phase(phase: str) -> str:
    """Pod phase → CR state (UpdateSBJStatus,
    slurmbridgejob_controller.go:246-294)."""
    return _STATE_FOR_PHASE.get(phase, JobState.PENDING)


def container_status_for(info: JobInfo) -> ContainerStatus:
    """One display "container" per sub-job (status.go:105-186): waiting
    while PENDING, running while RUNNING, terminated with the parsed exit
    code once ended.

    Built via ``frozen_new`` (every field explicit, born frozen): one
    instance per sub-job per worker-pod sync — 45k per sweep pass at the
    headline shape — and these rows land inside born-frozen PodStatus
    objects, so they MUST be frozen themselves (an unfrozen child inside
    a frozen parent would be silently mutable in stored snapshots)."""
    name = f"job-{info.key()}"
    if info.state.is_terminal:
        code = 0
        if info.exit_code:
            try:
                code = int(info.exit_code.split(":")[0])
            except ValueError:
                code = 0
        if code == 0 and info.state in _BAD_END:
            code = 1
        return frozen_new(
            ContainerStatus,
            name=name, state="terminated", exit_code=code, reason=info.state.name,
        )
    if info.state == JobStatus.RUNNING:
        return frozen_new(
            ContainerStatus, name=name, state="running", exit_code=0, reason=""
        )
    return frozen_new(
        ContainerStatus,
        name=name, state="waiting", exit_code=0, reason=info.state.name,
    )
