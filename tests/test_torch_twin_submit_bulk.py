"""The provider's batched submit (``tests/test_submit_bulk.py``), run
against the port's provider, simulated agent and fault client. The
agent server's tests wait for the gRPC transport (the real
``WorkloadServicer`` and its Slurm CLI are not ported)."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_submit_bulk",
    rewrites=[
        GRPC_AS_PORT_ERRORS,
        ("from slurm_bridge_tpu_torch.agent.cli import SlurmError\n", ""),
        ("from slurm_bridge_tpu_torch.agent.server import WorkloadServicer\n", ""),
    ],
    drop=[
        # the agent server (agent/server.py) comes with the transport
        "test_agent_submitjobs_per_item_results",
        "test_agent_submitjobs_matches_unary_semantics",
        "test_agent_submitjobs_isolates_non_slurm_errors",
    ],
))
