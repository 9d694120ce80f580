"""The provider's batched submit (``tests/test_submit_bulk.py``), run
against the port's provider, simulated agent, fault client and the
agent's ``WorkloadServicer.SubmitJobs``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin("test_submit_bulk", rewrites=[GRPC_AS_PORT_ERRORS]))
