"""The port's retried preemption cancel (``tests/test_preemption.py``'s
``test_failed_preempt_cancel_is_retried``), raising the port's own
``RpcError``; the preemption twin runs the reference's version and
``tests/test_torch_twin_policy.py`` the policy tests.
"""

from __future__ import annotations


def test_failed_preempt_cancel_is_retried():
    """A cancel that fails while the agent is unreachable must not be
    dropped after one attempt (it would orphan the Slurm job while the
    requeued pod resubmits — double execution). It is annotated on the
    pod and retried at the top of every tick until it lands."""
    from slurm_bridge_tpu_torch.bridge.objects import Meta, Pod, PodPhase, PodSpec, PodStatus
    from slurm_bridge_tpu_torch.bridge.scheduler import (
        PENDING_CANCEL_ANNOTATION,
        PlacementScheduler,
    )
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore
    from slurm_bridge_tpu_torch.wire import RpcError, StatusCode

    class _Client:
        def __init__(self):
            self.down = True
            self.cancelled = []

        def CancelJob(self, req, timeout=None):
            if self.down:
                raise RpcError(StatusCode.UNAVAILABLE, "agent unreachable")
            self.cancelled.append(req.job_id)

    store = ObjectStore()
    client = _Client()
    sched = PlacementScheduler(store, client, backend="greedy")
    store.create(
        Pod(
            meta=Meta(name="victim"),
            spec=PodSpec(
                partition="tiny",
                node_name="slurm-partition-tiny",
                placement_hint=("t1",),
            ),
            status=PodStatus(phase=PodPhase.RUNNING, job_ids=(7, 8)),
        )
    )
    assert sched._preempt(store.get(Pod.KIND, "victim"))
    pod = store.get(Pod.KIND, "victim")
    assert pod.meta.annotations[PENDING_CANCEL_ANNOTATION] == "7,8"
    assert not pod.status.job_ids  # requeued regardless

    sched._retry_pending_cancels()  # agent still down: backlog intact
    pod = store.get(Pod.KIND, "victim")
    assert pod.meta.annotations[PENDING_CANCEL_ANNOTATION] == "7,8"

    client.down = False
    sched._retry_pending_cancels()  # agent back: backlog drains
    assert client.cancelled == [7, 8]
    pod = store.get(Pod.KIND, "victim")
    assert PENDING_CANCEL_ANNOTATION not in pod.meta.annotations
