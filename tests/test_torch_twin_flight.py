"""The flight recorder's tests (``tests/test_flight.py``): span trees,
trace propagation over the gRPC wire, sampling, the roll-up and its
reconciliation with the simulator's tick phases, run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_flight",
    rewrites=[
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import pb\n"),
    ],
))
