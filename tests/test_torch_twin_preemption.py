"""Preemption in the placement scheduler (``tests/test_preemption.py``):
the cancel retry after a failed preemption, across an agent crash with
the agent journal, run against the port; RPC failures are the port's
``RpcError``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_preemption",
    rewrites=[
        GRPC_AS_PORT_ERRORS,
        ("from slurm_bridge_tpu_torch.agent import SlurmClient, WorkloadServicer\n", ""),
        ("from slurm_bridge_tpu_torch.bridge import Bridge, BridgeJobSpec, JobState\n",
         "from slurm_bridge_tpu_torch.bridge import BridgeJobSpec, JobState\n"),
        ("from slurm_bridge_tpu_torch.wire import serve\n", ""),
    ],
    drop=[
        # the bridge fixture: a real agent server and Bridge over the
        # fake Slurm CLI, which come with the transport slice
        "test_placement_hint_reaches_sbatch",
        "test_high_priority_preempts_low",
        "test_no_preemption_among_equal_priority",
    ],
))
