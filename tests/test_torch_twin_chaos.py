"""Composed chaos (``tests/test_chaos.py``): agent crashes, dual crashes,
a crash into a vanished partition and during an RPC flap, the retry
policy and the fault plan, run against the port; RPC failures are the
port's ``RpcError``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin("test_chaos", rewrites=[GRPC_AS_PORT_ERRORS]))
