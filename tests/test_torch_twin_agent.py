"""The agent's tests (``tests/test_agent.py``): the Slurm CLI driver over
the fake Slurm shim, the container script, the tailer, the partition
config, the submit ledger, and the WorkloadManager servicer served over
gRPC, run against the port's ``agent`` package."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin("test_agent", rewrites=[GRPC_AS_PORT_ERRORS]))
