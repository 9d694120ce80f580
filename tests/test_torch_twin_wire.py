"""The wire contract (``tests/test_wire.py``): the method tables, the
domain ↔ message mapping and a gRPC server over a unix socket exercising
every streaming kind — run against the port's schema and transport."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin("test_wire", rewrites=[GRPC_AS_PORT_ERRORS]))
