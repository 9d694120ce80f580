"""The simulator's tests (``tests/test_sim.py``): the simulated agent's
ground truth, the fault client, invariants, the harness and the CLI, run
against the port; RPC failures are the port's ``RpcError``. The
reference's slow-lane scenario runs are covered, held against the JAX
package's digests, by ``tests/test_torch_sim.py``, which also carries the
port's form of the RpcError identity test."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_sim",
    rewrites=[GRPC_AS_PORT_ERRORS],
    drop=[
        # SimRpcError is the port's RpcError, not grpc's: see
        # test_torch_sim.py::test_sim_rpc_error_is_the_ports_rpc_error
        "test_sim_rpc_error_is_grpc_rpc_error",
        # slow-lane scenario runs: preemption_storm, partition_vanish,
        # node_churn and full_50kx10k are digest twins in test_torch_sim.py
        "test_harness_preemption_storm_displaces",
        "test_harness_partition_vanish_recovers",
        "test_harness_node_churn_with_stale_snapshots",
        "test_full_50kx10k_headline",
    ],
))
