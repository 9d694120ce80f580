"""The placement-solver sidecar (``tests/test_solver_service.py``): Place
over a unix socket with each engine (the multi-device sweep on eight CPU
blocks included), gangs, features, priorities, incumbents, config
overrides and auto-routing, SolverInfo, and a ``Bridge`` ticking through
the sidecar — run against the port's servicer, transport and ``Bridge``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_solver_service", rewrites=[GRPC_AS_PORT_ERRORS], eight_devices=True,
))
