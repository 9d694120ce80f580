"""The provider's bulk status mirror (``tests/test_mirror_bulk.py``), run
against the port's provider and simulated agent; RPC failures are the
port's ``RpcError``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin("test_mirror_bulk", rewrites=[GRPC_AS_PORT_ERRORS]))
